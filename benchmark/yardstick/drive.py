"""What every flow gets: `Env`, the run's configuration, traffic,
seed, window, tracer and directory, and `collect`, which drains a run's
events. A flow is `flows/<name>.py`, named by the traffic file's
`flow`; it exposes `drive(env)`, which runs the set-up and the window
and returns what the run produced, and `judge(out, reference, cfg,
device)`, which compares that with the configuration's plain reference
(`judge.Checks`)."""

from __future__ import annotations

import os
import queue
import time

from yardstick import board as bd

LATE_S = 60.0  # how long past the window's close an answer may come


class Env:
    """What a flow needs: the configuration and traffic, the device
    (None: the card, as users run it), the seed's generator, the
    window's length, the tracer, the run's own directory, the checkout's
    root, the configuration's reference module (which makes the input
    boards) and `on_warm`, called once the set-up is over (the planted
    faults use it; a benchmark run passes nothing)."""

    def __init__(self, cfg, traffic, device, rng, seconds, tracer, workdir,
                 root, reference, on_warm=None):
        self.cfg, self.traffic, self.device = cfg, traffic, device
        self.rng, self.tracer = rng, tracer
        # A traced run traces a window of at most `trace_seconds`: the
        # trace's size and its reading grow with the window.
        self.seconds = (min(seconds, traffic["trace_seconds"])
                        if tracer.enabled else seconds)
        self.workdir, self.root, self.reference = workdir, root, reference
        self.on_warm = on_warm or (lambda: None)
        self.height, self.width = int(cfg["height"]), int(cfg["width"])

    def make_input(self, tag: str) -> tuple:
        """(images directory, {0, 1} board) of a fresh seeded input,
        written as the seed PGM the program reads."""
        board = self.reference.make_board(self.cfg, self.rng, self.root)
        d = os.path.join(self.workdir, "images-" + tag)
        bd.write_pgm(os.path.join(d, f"{self.width}x{self.height}.pgm"),
                     board * 255)
        return d, board


def collect(q, until: float) -> tuple:
    """(events up to CLOSE, whether CLOSE came before `until`)."""
    from gol_tpu_torch import events as ev

    got = []
    while True:
        try:
            e = q.get(timeout=max(0.0, until - time.monotonic()))
        except queue.Empty:
            return got, False
        if e is ev.CLOSE:
            return got, True
        got.append(e)
