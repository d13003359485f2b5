"""The `ticker` flow: one controller runs the board unbounded through
`run()` with an engine of its own and the 2 s ticker (the coursework's
TestAlive flow).

It polls `alive_count()` every `poll_ms` and waits until the last
`converge_pops` chunks were of one size (the chunk adapter has settled).
A traced run then starts the profiler and lets `converge_pops` more
chunks pass, because the first launches under a new profiler stall
while it sets up and the pipeline drains. The window opens at the new
published pair that ended the wait and closes at the first new pair at
least `seconds` later; the flow then quits with "q".

Judged: every published pair sighted and every AliveCellsCount against
the reference's count at its turn, except a tick of turn 0 and 0
cells, sent before the engine holds the board; FinalTurnComplete's turn (not before
the window's last), its count and, up to `MAX_EVENT_CELLS` cells, its
alive list cell by cell; every pixel of the final PGM. The reference
steps the run's whole input board (`reference.oracle`).
"""

from __future__ import annotations

import os
import queue
import time

from yardstick import judge as jd
from yardstick.drive import LATE_S, collect

# FinalTurnComplete carries the alive list up to this many cells
# (GOL_MAX_EVENT_CELLS's default); beyond it the PGM is the board.
MAX_EVENT_CELLS = 1 << 24


def drive(env) -> dict:
    from gol_tpu_torch import Params, run
    from gol_tpu_torch import events as ev
    from gol_tpu_torch.engine import Engine

    tf, tr = env.traffic, env.tracer
    stamps = [("program_imported", time.monotonic())]
    images, board = env.make_input("0")
    out_dir = os.path.join(env.workdir, "out")
    stamps.append(("input_written", time.monotonic()))
    eng = Engine(device=env.device)
    events_q, keys = queue.Queue(), queue.Queue()
    th = run(Params(image_width=env.width, image_height=env.height,
                    turns=int(tf["turns"])), events_q, keys, engine=eng,
             images_dir=images, out_dir=out_dir)
    poll_s = tf["poll_ms"] / 1000.0
    firsts: list = []  # (time, turn, alive) of each new published pair

    def sight() -> bool:
        alive, turn = eng.alive_count()
        now = time.monotonic()
        if turn > 0 and (not firsts or firsts[-1][1] != turn):
            firsts.append((now, turn, alive))
            return True
        return False

    def wait(pred, deadline: float, what: str) -> None:
        while True:
            if sight() and pred():
                return
            if not th.is_alive():
                raise RuntimeError(f"the run ended while {what}: "
                                   f"{th.exception!r}")
            if time.monotonic() > deadline:
                raise RuntimeError(f"timed out {what}")
            time.sleep(poll_s)

    n = int(tf["converge_pops"])

    def settled() -> bool:
        if len(firsts) < n + 1:
            return False
        d = [b[1] - a[1] for a, b in zip(firsts[-n - 1:], firsts[-n:])]
        return len(set(d)) == 1

    try:
        wait(lambda: True, time.monotonic() + tf["warmup_timeout_s"],
             "waiting for the first pair")
        stamps.append(("first_pair", firsts[0][0]))
        wait(settled, time.monotonic() + tf["warmup_timeout_s"],
             "warming up")
        stamps.append(("settled", firsts[-1][0]))
        env.on_warm()
        if tr.enabled:
            tr.start()
            m = len(firsts) + n
            wait(lambda: len(firsts) >= m, time.monotonic() + LATE_S,
                 "refilling the pipeline under the profiler")
        # The last wait returned as it sighted a new pair: open there.
        tr.begin("window")
        i0 = len(firsts) - 1
        w0 = firsts[i0]
        wait(lambda: firsts[-1][0] >= w0[0] + env.seconds,
             w0[0] + env.seconds + LATE_S, "measuring")
        tr.end("window")
        i1 = len(firsts) - 1
    finally:
        tr.stop()
        keys.put("q")
        events, closed = collect(events_q, time.monotonic() + LATE_S)
        th.join(LATE_S)
    final = [e for e in events if isinstance(e, ev.FinalTurnComplete)]
    images_out = [e for e in events if isinstance(e, ev.ImageOutputComplete)]
    return {
        "board": board, "firsts": firsts,
        "window": (firsts[i0], firsts[i1]), "chunks": i1 - i0,
        "t_open": w0[0], "stamps": stamps,
        "ticks": [(e.completed_turns, e.cells_count) for e in events
                  if isinstance(e, ev.AliveCellsCount)],
        "final": final[0] if final else None,
        "pgm": (os.path.join(out_dir, images_out[0].filename)
                if images_out else None),
        "error": (None if closed and th.exception is None
                  else repr(th.exception) if th.exception is not None
                  else "no CLOSE within a minute of the quit"),
    }


def judge(out: dict, reference, cfg: dict, device) -> jd.Checks:
    c = jd.Checks()
    hist = reference.oracle(out["board"], cfg, device)
    # The ticker starts before the board is read; a tick before the
    # engine holds the board reads (turn 0, 0 cells), which the program's
    # own TestAlive treats as no answer yet (tests/test_torch_gol.py).
    ticks = [t for t in out["ticks"] if t != (0, 0)]
    pairs = [(t, a) for _, t, a in out["firsts"]] + ticks
    c.answers = c.attempted = len(pairs) + 1
    c.add("pairs_wrong", sum(a != hist.count_at(t) for t, a in pairs))
    c.add("run_errors", int(out["error"] is not None))
    c.failed = int(out["error"] is not None)
    final = out["final"]
    if final is None or out["pgm"] is None:
        c.add("final_missing", 1)
        c.failed = 1
        return c
    turn = final.completed_turns
    want = hist.state_at(turn)
    c.answers += 1
    c.add("final_before_window_end", int(turn < out["window"][1][1]))
    c.add("final_count_wrong", abs(final.count() - hist.count_at(turn)))
    if want.size <= MAX_EVENT_CELLS:
        c.add("final_cells_wrong", jd.cells_wrong_alive(final.alive, want))
    c.add("pgm_cells_wrong", jd.cells_wrong_pgm(out["pgm"], want))
    return c
