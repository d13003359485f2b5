"""The `methuselah` flow: one controller runs jobs back to back in a
closed loop, each one call of `run(..., sparse=True)` to the
configuration's final turn on one `SparseEngine` the flow holds across
them, with the 2 s ticker, FinalTurnComplete in torus coordinates and
the window PGM.

All jobs of a run start from one seed board (`seed.pgm`), which the
engine stamps centred on the torus: the configuration's pattern under
one of its 8 rotations and reflections at an offset in the seed board,
both drawn from the seed (the reference's `make_board`). The flow polls
`alive_count()` every `poll_ms` and runs `warmup_jobs` whole jobs
before it measures. A traced run starts the profiler after them. The
window opens at the first new pair of the first job after the warm-up
and closes at the end (the final pair's sighting) of the first job at
which the in-job time since the open reaches `seconds`, and at least
`min_jobs` jobs.

A job's in-job time runs from its first sighted pair to its final one.
The gap from a job's final pair through its final window readback, its
PGM write and the next job's start to that job's first sighted pair is
left out, and goes to standard error: it holds the write of a window of
about 1.5 GB and its fsync. `out["window"]` is the pair of cumulative
(in-job seconds, in-job turns) sightings, so `cell_updates_per_s`
reads in-job turns a second times the torus's cells: the torus's cell
updates a second, not the window's, which the window's own per-layer
metric reads. `out["in_job"]` is the window's jobs' (first sighting,
final sighting) on the monotonic clock, for the per-layer readers.

Judged, against the configuration's plain reference, which steps the
seed board once a run: every sighted pair and every AliveCellsCount of
every job against the count at its turn (but a tick of turn 0 and 0
cells, sent before the engine holds a board); each job's
FinalTurnComplete (its turn the configuration's, its count and its torus
cells); the last job's PGM (its dims those the engine published, every
pixel 0 or 255, and its live pixels the reference's final cells under
one translation); the earlier jobs' PGMs by name and size, each deleted
once checked, so the run holds one such file at a time; and the run's
errors.
"""

from __future__ import annotations

import os
import queue
import re
import sys
import time

import numpy as np

from yardstick import board as bd
from yardstick import judge as jd
from yardstick.drive import LATE_S, collect

PGM_NAME = re.compile(r"^(\d+)x(\d+)x(\d+)\.pgm$")
# The program's always-on spans of a job's finish, which split the gap.
FINISH_SPANS = ("sparse.final_window", "controller.sparse_finish")


def pgm_header(path: str) -> tuple:
    """(width, height, payload offset) of a P5 file of maxval 255 as the
    program writes it (no comments)."""
    with open(path, "rb") as f:
        head = f.read(64)
    tokens = head.split(maxsplit=4)
    if len(tokens) < 4 or tokens[0] != b"P5" or tokens[3] != b"255":
        raise ValueError(f"{path}: not a P5 file of maxval 255")
    w, h = int(tokens[1]), int(tokens[2])
    return w, h, len(b"P5\n%d %d\n255\n" % (w, h))


def pgm_misnamed(path, turn: int) -> int:
    """1 when a job's PGM is missing, misnamed, or not the size its name
    gives, else 0."""
    if path is None or not os.path.exists(path):
        return 1
    m = PGM_NAME.match(os.path.basename(path))
    if m is None or int(m.group(3)) != turn:
        return 1
    w, h = int(m.group(1)), int(m.group(2))
    try:
        hw, hh, off = pgm_header(path)
    except (OSError, ValueError):
        return 1
    return int((hw, hh) != (w, h) or os.path.getsize(path) != off + w * h)


def drive(env) -> dict:
    from gol_tpu_torch import Params, run
    from gol_tpu_torch import events as ev
    from gol_tpu_torch.sparse_engine import SparseEngine

    cfg, tf, tr = env.cfg, env.traffic, env.tracer
    size, turns = env.width, int(cfg["turns"])
    stamps = [("program_imported", time.monotonic())]
    board = env.reference.make_board(cfg, env.rng, env.root)
    images = os.path.join(env.workdir, "images")
    bd.write_pgm(os.path.join(images, "seed.pgm"), board * 255)
    eng = SparseEngine(size, device=env.device)
    poll_s = tf["poll_ms"] / 1000.0
    jobs: list = []

    def job(i: int, on_first=None) -> dict:
        """Run job i to its end; its sightings, events and PGM."""
        events_q, keys = queue.Queue(), queue.Queue()
        out_dir = os.path.join(env.workdir, "out")
        th = run(Params(image_width=size, image_height=size, turns=turns),
                 events_q, keys, engine=eng, images_dir=images,
                 out_dir=out_dir, sparse=True)
        sights: list = []  # (time, turn, alive) of each new pair
        # Until this job publishes, the engine shows the last job's
        # final pair (or no board at all): a job has begun at its first
        # pair below the final turn.
        begun = False
        deadline = time.monotonic() + tf["job_timeout_s"]
        while True:
            alive, turn = eng.alive_count()
            now = time.monotonic()
            begun = begun or turn < turns
            if begun and turn > 0 and (not sights or sights[-1][1] != turn):
                sights.append((now, turn, alive))
                if len(sights) == 1 and on_first is not None:
                    on_first(now)
                if turn >= turns:
                    break
            if not th.is_alive():
                raise RuntimeError(f"job {i} ended before its final pair: "
                                   f"{th.exception!r}")
            if now > deadline:
                raise RuntimeError(f"job {i} timed out at turn {turn}")
            time.sleep(poll_s)
        window = eng.stats()["window"]
        events, closed = collect(events_q, time.monotonic() + LATE_S)
        th.join(LATE_S)
        t_closed = time.monotonic()
        final = [e for e in events if isinstance(e, ev.FinalTurnComplete)]
        images_out = [e for e in events
                      if isinstance(e, ev.ImageOutputComplete)]
        return {
            "first": sights[0], "last": sights[-1],
            "t_closed": t_closed, "sights": sights, "window": window,
            "ticks": [(e.completed_turns, e.cells_count) for e in events
                      if isinstance(e, ev.AliveCellsCount)],
            "final": ((final[0].completed_turns, final[0].count(),
                       tuple(final[0].alive)) if final else None),
            "pgm": (os.path.join(out_dir, images_out[0].filename)
                    if images_out else None),
            "error": (None if closed and th.exception is None
                      else repr(th.exception) if th.exception is not None
                      else "no CLOSE within a minute of the final pair"),
        }

    def next_job(on_first=None) -> dict:
        """Check the last job's PGM by name and size and delete it, then
        run the next job."""
        if jobs:
            last = jobs[-1]
            last["pgm_bad"] = pgm_misnamed(last["pgm"], turns)
            if last["pgm"] is not None and os.path.exists(last["pgm"]):
                os.unlink(last["pgm"])
        jobs.append(job(len(jobs), on_first))
        return jobs[-1]

    opened: list = []

    def open_window(now: float) -> None:
        tr.begin("window")
        opened.append(now)

    in_job_s = 0.0
    in_job_turns = 0
    n_warm = int(tf["warmup_jobs"])
    try:
        for _ in range(n_warm):
            next_job()
        stamps.append(("warm", time.monotonic()))
        env.on_warm()
        tr.start()
        while True:
            j = next_job(None if opened else open_window)
            in_job_s += j["last"][0] - j["first"][0]
            in_job_turns += j["last"][1] - j["first"][1]
            if (in_job_s >= env.seconds
                    and len(jobs) - n_warm >= int(tf["min_jobs"])):
                break
        tr.end("window")
    finally:
        tr.stop()
    window_jobs = jobs[n_warm:]
    from gol_tpu_torch.obs import trace as obs_trace

    finishes = [s for s in obs_trace.TRACER.finished_spans()
                if s["name"] in FINISH_SPANS]
    for i, j in enumerate(jobs):
        gap = (jobs[i + 1]["first"][0] - j["last"][0]
               if i + 1 < len(jobs) else None)
        parts = ", ".join(
            f"{s['name']} {s['end'] - s['start']:.6f} s" for s in finishes
            if j["first"][0] <= s["start"] <= j["t_closed"])
        print(f"job {i}: in-job {j['last'][0] - j['first'][0]:.6f} s "
              f"(turns {j['first'][1]}..{j['last'][1]}), gap to the next "
              f"job's first pair "
              + ("none" if gap is None else f"{gap:.6f} s")
              + f" ({parts or 'no finish spans'}), window {j['window']}",
              file=sys.stderr)
    print(f"spans kept {len(obs_trace.TRACER.finished_spans())}, dropped "
          f"{obs_trace.TRACER.dropped()}", file=sys.stderr)
    return {
        "board": board, "jobs": jobs,
        "window": ((0.0, 0), (in_job_s, in_job_turns)),
        "in_job": [(j["first"][0], j["last"][0]) for j in window_jobs],
        "gaps": [b["first"][0] - a["last"][0]
                 for a, b in zip(jobs, jobs[1:])],
        "t_open": opened[0], "stamps": stamps,
    }


def pgm_cells_wrong(path, want: set, window, size: int) -> int:
    """Cells where the PGM's live pixels and the reference's final cells
    differ under the one translation that maps the first live pixel in
    row order onto the first reference cell in row order; every
    reference cell when the file is missing or malformed, its dims are
    not the published window's, or a pixel is neither 0 nor 255."""
    try:
        w, h, off = pgm_header(path)
        if window is not None and [h, w] != list(window):
            return len(want) or 1
        pix = np.memmap(path, dtype=np.uint8, mode="r", offset=off,
                        shape=(h * w,))
        nz = np.flatnonzero(pix)
        bad = int((pix[nz] != 255).sum())
    except (OSError, ValueError, TypeError):
        return len(want) or 1
    if bad:
        return len(want) or 1
    got = [(int(k) % w, int(k) // w) for k in nz]
    if not got or not want:
        return len(got) + len(want)
    gx, gy = got[0]  # row order: nz is sorted
    wx, wy = min(want, key=lambda c: (c[1], c[0]))
    dx, dy = wx - gx, wy - gy
    moved = {((x + dx) % size, (y + dy) % size) for x, y in got}
    return len(moved ^ want)


def judge(out: dict, reference, cfg: dict, device) -> jd.Checks:
    c = jd.Checks()
    t0 = time.monotonic()
    hist = reference.oracle(out["board"], cfg, device)
    print(f"reference {time.monotonic() - t0:.3f} s for {hist.turns} turns "
          f"on the host", file=sys.stderr)
    turns, size = int(cfg["turns"]), int(cfg["width"])
    want = hist.cells()
    pairs_wrong = final_wrong = final_cells_wrong = errors = 0
    pgms_bad = 0
    jobs = out["jobs"]
    c.answers = c.attempted = 0
    for j in jobs:
        # A tick before the engine holds a board reads (turn 0, 0 cells),
        # which the program's own TestAlive treats as no answer yet.
        ticks = [t for t in j["ticks"] if t != (0, 0)]
        pairs = [(t, a) for _, t, a in j["sights"]] + ticks
        c.answers += len(pairs) + 1
        c.attempted += len(pairs) + 1
        pairs_wrong += sum(a != hist.count_at(t) for t, a in pairs)
        errors += int(j["error"] is not None)
        if j["final"] is None:
            final_wrong += 1
            continue
        f_turn, f_count, f_cells = j["final"]
        final_wrong += int(f_turn != turns or f_count != hist.count_at(turns))
        got = set(f_cells)
        final_cells_wrong += len(got ^ want) + len(f_cells) - len(got)
        pgms_bad += j.get("pgm_bad", 0)
    c.add("pairs_wrong", pairs_wrong)
    c.add("final_wrong", final_wrong)
    c.add("final_cells_wrong", final_cells_wrong)
    c.add("pgms_misnamed", pgms_bad)
    last = jobs[-1]
    c.add("pgm_cells_wrong", pgm_cells_wrong(last["pgm"], want,
                                             last["window"], size))
    c.add("run_errors", errors)
    c.failed = errors
    return c
