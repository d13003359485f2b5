"""The controller: orchestrates one run against an in-process engine —
the counterpart of `gol_tpu/distributor.py` without its remote engine
(`SER`), sparse mode, 'c' checkpoint key and loss recovery.

Contract (reference `Local/gol/distributor.go:55-226`): load
`images/WxH.pgm`, drive the engine, emit the event stream, honour s/p/q/k
keypresses, tick alive counts every 2 s, write `out/WxHxT.pgm`, and
support detach (`q`) / reattach (`CONT=yes`).
Generations boards travel as the rule's gray levels, and their alive
counts and cells are the firing ones (state 1, pixel 255).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np

from gol_tpu_torch import events as ev
from gol_tpu_torch.engine import (
    FLAG_KILL,
    FLAG_PAUSE,
    FLAG_QUIT,
    Engine,
    EngineKilled,
    resolve_device,
)
from gol_tpu_torch.io.pgm import input_path, output_path, read_pgm, write_pgm
from gol_tpu_torch.models.generations import GenerationsRule, gray_levels
from gol_tpu_torch.params import Params
from gol_tpu_torch.utils.cell import alive_cells_from_board
from gol_tpu_torch.utils.envcfg import env_int

ALIVE_POLL_SECONDS = 2.0  # reference ticker (`Local/gol/distributor.go:58`)

# GOL_LIVE_MAX_CELLS: the largest frame (in cells) the live view moves per
# poll. Larger boards stream a downsampled view (`Engine.get_view`), with
# coordinates in view space; 0 always moves full frames.
LIVE_MAX_CELLS_ENV = "GOL_LIVE_MAX_CELLS"
LIVE_MAX_CELLS_DEFAULT = 1 << 21

# The process-local default engine outlives `run` calls on purpose: that
# is what makes in-process detach/reattach (`q`, then `CONT=yes`) work,
# as the reference broker process holds `world`/`turn` between
# controllers.
_default_engine: Optional[Engine] = None
_default_engine_lock = threading.Lock()


def _resolve_rule(rule=None):
    """An explicit rule wins, else GOL_RULE, else Conway. A malformed
    rulestring raises."""
    from gol_tpu_torch.models import CONWAY, parse_rule

    if rule is not None:
        return rule
    s = os.environ.get("GOL_RULE", "")
    return parse_rule(s) if s else CONWAY


def _resolve_engine(rule=None, device=None) -> Engine:
    """The default engine (on `device`, CUDA when None), rebuilt when it
    was killed or, holding no board, has another rule or device. One that
    holds a detached board keeps its own rule and device (CONT=yes)."""
    rule = _resolve_rule(rule)
    dev = resolve_device(device)
    global _default_engine
    with _default_engine_lock:
        eng = _default_engine
        other = eng is not None and (eng._rule != rule or eng.device != dev)
        if eng is None or eng._killed or (other and eng._cells is None):
            eng = Engine(device=dev, rule=rule)
        elif other:
            import warnings

            warnings.warn(
                f"engine holds a detached board under rule "
                f"{eng._rule.rulestring} on {eng.device}; ignoring the "
                f"requested rule {rule.rulestring} on {dev}")
        _default_engine = eng
        return eng


def distributor(
    p: Params,
    events_q: "queue.Queue",
    key_presses: Optional["queue.Queue"] = None,
    engine: Optional[Engine] = None,
    images_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    live_view: bool = False,
    rule=None,
    device=None,
) -> None:
    """Run `p` to completion (or quit/kill), pushing events and, last of
    all, `events.CLOSE` onto `events_q`. `live_view` adds the
    CellsFlipped/TurnComplete feed of a viewer."""
    images_dir = images_dir or os.environ.get("GOL_IMAGES", "images")
    out_dir = out_dir or os.environ.get("GOL_OUT", "out")
    width, height = p.image_width, p.image_height
    done = threading.Event()
    helper_threads: list = []
    killed_by_key = threading.Event()

    # Engine resolution can fail (no CUDA device, a bad GOL_RULE): it
    # happens under the try that delivers CLOSE, or every consumer of
    # the events queue would wait forever.
    try:
        if engine is None:
            engine = _resolve_engine(rule, device)
        # The rule family's io: PGM value levels (the Generations gray
        # encoding, else the strict {0,255}); the firing cells are the
        # 255 pixels for every family. The engine's own rule decides, so
        # a detached board resumed under CONT=yes keeps its encoding.
        pgm_levels = None
        if isinstance(engine._rule, GenerationsRule):
            pgm_levels = tuple(gray_levels(engine._rule).tolist())
    except BaseException:
        done.set()
        events_q.put(ev.CLOSE)
        raise

    # -- keypress loop (`Local/gol/distributor.go:107-152`) ---------------
    def keypress_loop() -> None:
        paused = False
        while not done.is_set():
            try:
                key = key_presses.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                if key == "s":
                    world, turn = engine.get_world()
                    fname = output_path(width, height, turn, out_dir)
                    write_pgm(fname, world, levels=pgm_levels)
                    events_q.put(ev.ImageOutputComplete(
                        turn, os.path.basename(fname)))
                elif key == "p":
                    engine.cf_put(FLAG_PAUSE)
                    paused = not paused
                    _, turn = engine.alive_count()
                    if paused:
                        events_q.put(ev.StateChange(turn, ev.State.PAUSED))
                    else:
                        print("Continuing")
                        events_q.put(
                            ev.StateChange(turn, ev.State.EXECUTING))
                elif key == "q":
                    engine.cf_put(FLAG_QUIT)
                elif key == "k":
                    killed_by_key.set()
                    engine.cf_put(FLAG_KILL)
            except EngineKilled:
                return
            except RuntimeError:
                # A snapshot asked for before the board is loaded: drop
                # this keypress, keep serving.
                continue

    # -- 2 s alive ticker (`Local/gol/distributor.go:154-167`) ------------
    def ticker_loop() -> None:
        while not done.wait(ALIVE_POLL_SECONDS):
            try:
                alive, turn = engine.alive_count()
            except EngineKilled:
                return
            events_q.put(ev.AliveCellsCount(turn, alive))

    # -- live view feed: CellsFlipped diffs + TurnComplete ----------------
    # (`Local/gol/event.go:92-110`): every 0.1 s, the cells that changed
    # since the last frame seen, then the frame's turn.
    def live_loop() -> None:
        prev, prev_turn = None, -1
        cap = env_int(LIVE_MAX_CELLS_ENV, LIVE_MAX_CELLS_DEFAULT, minimum=0)
        while not done.wait(0.1):
            try:
                world, turn, _ = engine.get_view(cap)
            except EngineKilled:
                return
            except RuntimeError:
                continue  # no board loaded yet
            if turn == prev_turn:
                continue
            cur = world != 0
            ys, xs = np.nonzero(cur if prev is None else cur != prev)
            if len(xs):
                events_q.put(ev.CellsFlipped(
                    turn, tuple(zip(xs.tolist(), ys.tolist()))))
            events_q.put(ev.TurnComplete(turn))
            prev, prev_turn = cur, turn

    try:
        # Discard control flags a previous controller left on the engine
        # before this run's keypresses start.
        engine.drain_flags()
        if key_presses is not None:
            helper_threads.append(threading.Thread(
                target=keypress_loop, daemon=True))
        helper_threads.append(threading.Thread(
            target=ticker_loop, daemon=True))
        if live_view:
            helper_threads.append(threading.Thread(
                target=live_loop, daemon=True))
        for t in helper_threads:
            t.start()

        # -- board source: fresh from PGM, or reattach (`:171-178`) -------
        start_turn = 0
        if os.environ.get("CONT", "") == "yes":
            world, start_turn = engine.get_world()
            turns_left = max(p.turns - start_turn, 0)
        else:
            src = input_path(width, height, images_dir)
            world = read_pgm(src, levels=pgm_levels)
            if world.shape != (height, width):
                raise ValueError(
                    f"{src}: image is {world.shape[1]}x{world.shape[0]} "
                    f"but Params say {width}x{height}")
            turns_left = p.turns

        events_q.put(ev.StateChange(start_turn, ev.State.EXECUTING))
        run_params = Params(threads=p.threads, image_width=width,
                            image_height=height, turns=turns_left)
        try:
            final_world, final_turn = engine.server_distributor(
                run_params, world, start_turn=start_turn)
        except EngineKilled:
            final_world, final_turn = world, start_turn

        # -- finalize (`:187-226`) ----------------------------------------
        # The final event carries the alive (firing) cell set; beyond
        # GOL_MAX_EVENT_CELLS cells only the count travels (a 65536²
        # board's ~10^9 coordinate tuples would exhaust memory).
        max_event_cells = env_int("GOL_MAX_EVENT_CELLS", 1 << 24, minimum=0)
        if final_world.size <= max_event_cells:
            alive = tuple((c.x, c.y) for c in
                          alive_cells_from_board(final_world == 255))
            count = len(alive)
        else:
            alive = ()
            count = int((final_world == 255).sum())
        events_q.put(ev.FinalTurnComplete(final_turn, alive, count))
        fname = output_path(width, height, final_turn, out_dir)
        write_pgm(fname, final_world, levels=pgm_levels)
        events_q.put(
            ev.ImageOutputComplete(final_turn, os.path.basename(fname)))
        if killed_by_key.is_set():
            engine.kill_prog()
        events_q.put(ev.StateChange(final_turn, ev.State.QUITTING))
    finally:
        done.set()
        events_q.put(ev.CLOSE)
        for t in helper_threads:
            t.join(timeout=5.0)
