"""The controller: orchestrates one run — the counterpart of
`gol_tpu/distributor.py`.

Contract (reference `Local/gol/distributor.go:55-226`): load
`images/WxH.pgm`, drive the engine, emit the event stream, honour s/p/q/k
keypresses (and 'c': a durable manifest checkpoint, into GOL_CKPT for
an in-process engine, through the Checkpoint method into the server's
configured directory for a remote one), tick alive counts every 2 s,
write `out/WxHxT.pgm`, and support detach (`q`) / reattach
(`CONT=yes`). The engine is the process's in-process `Engine` by
default, or, when `SER=host:port` is set, an engine server reached over
the TCP control plane (`client.RemoteEngine`; the server may be this
package's or the JAX package's), mirroring the reference env config
(`Local/gol/distributor.go:90-105`). With `SER` set, `device=` and
`rule=` do not apply: the server's engine decides both, and the
controller reads and writes PGM levels for the rule it reports. A lost
remote engine is reattached within `GOL_RECONNECT` seconds.
Generations boards travel as the rule's gray levels, and their alive
counts and cells are the firing ones (state 1, pixel 255).
Larger-than-Life boards use the strict {0,255} levels. So do Lenia runs,
as in the JAX controller: a Lenia board's pixels are its quantized
float state, so the run reaches FinalTurnComplete and then fails at the
final PGM's {0,255} check (Lenia's working surfaces are the engine and
the server).

Sparse mode (`sparse=True`): the engine is the process's `SparseEngine`
(or the remote one behind `SER`, whose `--sparse SIZE` must equal the
Params' width and height, the TORUS size); the board source is the small
seed pattern `<images_dir>/seed.pgm`, its live cells stamped centred;
snapshots and the final PGM are the live WINDOW (named by its dims), and
FinalTurnComplete carries torus-coordinate cells. CONT=yes and a
reattach after loss resume the engine-held window.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import List, Optional

import numpy as np

from gol_tpu_torch import events as ev
from gol_tpu_torch.engine import (
    FLAG_KILL,
    FLAG_PAUSE,
    FLAG_QUIT,
    Engine,
    EngineBusy,
    EngineKilled,
    resolve_device,
    view_factor,
)
from gol_tpu_torch.io.pgm import input_path, output_path, read_pgm, write_pgm
from gol_tpu_torch.models.generations import GenerationsRule, gray_levels
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.params import Params
from gol_tpu_torch.utils.cell import alive_cells_from_board
from gol_tpu_torch.utils.envcfg import env_float, env_int

ALIVE_POLL_SECONDS = 2.0  # reference ticker (`Local/gol/distributor.go:58`)

# GOL_LIVE_MAX_CELLS: the largest frame (in cells) the live view moves per
# poll. Larger boards stream a downsampled view (`Engine.get_view`), with
# coordinates in view space; 0 always moves full frames.
LIVE_MAX_CELLS_ENV = "GOL_LIVE_MAX_CELLS"
LIVE_MAX_CELLS_DEFAULT = 1 << 21

# GOL_RECONNECT=<seconds>: how long a controller keeps trying to reattach
# to a lost REMOTE engine before giving up (0 disables). Beyond the
# reference (its controller does `log.Fatal` on dial errors,
# `Local/gol/distributor.go:96-98`): on connection loss mid-run the
# controller emits EngineLost, polls ping until the engine answers, then
# resumes from the engine's authoritative (world, turn), or resubmits its
# own last-known board when the engine came back empty.
def live_view_shape(width: int, height: int) -> tuple:
    """(rows, columns) of the frames the live feed sends for a board:
    the board's own within GOL_LIVE_MAX_CELLS (or when it is 0), else
    `Engine.get_view`'s downsampled view."""
    cap = env_int(LIVE_MAX_CELLS_ENV, LIVE_MAX_CELLS_DEFAULT, minimum=0)
    if cap <= 0 or width * height <= cap:
        return height, width
    f = view_factor(height, width, cap)
    return -(-height // f), -(-width // f)


RECONNECT_ENV = "GOL_RECONNECT"
RECONNECT_DEFAULT = 10.0

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


# The process-local sparse engine (one, keyed by (size, rulestring)): the
# sparse analog of `_default_engine`, held across `run` calls so that `q`
# then CONT=yes holds for sparse runs too.
_default_sparse: dict = {}


def _resolve_sparse_engine(size: int, rule=None, device=None):
    """`SER` set: a `RemoteEngine` on that address. Otherwise the
    process's sparse engine for (size, rule), on `device` (CUDA when
    None); one held sparse state at a time."""
    from gol_tpu_torch.sparse_engine import SparseEngine

    ser = os.environ.get("SER", "")
    if ser:
        from gol_tpu_torch.client import RemoteEngine

        return RemoteEngine(ser)
    rule = _resolve_rule(rule)
    dev = resolve_device(device)
    key = (size, rule.rulestring)
    with _default_engine_lock:
        eng = _default_sparse.get(key)
        if eng is None or eng._killed or eng.device != dev:
            _default_sparse.clear()
            eng = SparseEngine(size, rule=rule, device=dev)
            _default_sparse[key] = eng
        return eng


def _resolve_engine(rule=None, device=None):
    """`SER` set: a `RemoteEngine` on that address. Otherwise the default
    engine (on `device`, CUDA when None), rebuilt when it was killed or,
    holding no board, has another rule or device. One that holds a
    detached board keeps its own rule and device (CONT=yes)."""
    ser = os.environ.get("SER", "")
    if ser:
        from gol_tpu_torch.client import RemoteEngine

        return RemoteEngine(ser)
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


def _engine_rule(engine, rule=None):
    """The rule whose PGM levels the controller reads and writes: the
    engine's own. A remote engine reports it in `stats()`; one that
    cannot be reached yet leaves `rule`, GOL_RULE or Conway (the JAX
    controller's choice), and the run's recovery loop takes over."""
    if hasattr(engine, "_rule"):
        return engine._rule
    from gol_tpu_torch.models import parse_rule

    try:
        return parse_rule(str(engine.stats()["rule"]))
    except (ConnectionError, OSError, RuntimeError, KeyError):
        return _resolve_rule(rule)


def _sub_workers() -> List[str]:
    """Worker list from SUB (comma separated); its *length* is the shard
    count request (`Local/gol/distributor.go:100-105`). A server on one
    device takes the list for API parity."""
    sub = os.environ.get("SUB", "")
    return [a for a in sub.split(",") if a]


def _await_engine(engine, budget_s: float) -> None:
    """Poll `engine.ping()` with a short backoff until it answers or the
    budget runs out (re-raising the last connection error). An
    EngineKilled answer propagates: a killed engine is not 'lost'."""
    deadline = time.monotonic() + budget_s
    while True:
        try:
            engine.ping()
            return
        except (ConnectionError, OSError):
            if time.monotonic() >= deadline:
                raise
            time.sleep(min(0.5, budget_s / 10))


def _finish_sparse(engine, final_world, final_turn: int, width: int,
                   height: int, max_event_cells: int, out_dir: str,
                   events_q: "queue.Queue"):
    """A sparse run's FinalTurnComplete and window PGM; returns the PGM's
    path, or None when there is no state to write. Cells are in TORUS
    coordinates: the window's nonzeros offset by its torus origin, read
    from the parked engine. When the engine is unreachable (killed or
    lost) the origin is lost with it, so only the count of the run's
    last-known window travels, never wrongly wrapped coordinates."""
    origin = None
    try:
        win, origin, _ = engine.get_window()
    except (EngineKilled, ConnectionError, OSError, RuntimeError):
        win = final_world
    if win is None:
        # Killed before any state on a resume-only run.
        events_q.put(ev.FinalTurnComplete(final_turn, (), 0))
        return None
    ys, xs = np.nonzero(win)
    if origin is not None and len(xs) <= max_event_cells:
        ox, oy = origin
        alive = tuple((int((x + ox) % width), int((y + oy) % height))
                      for x, y in zip(xs, ys))
        count = len(alive)
    else:
        alive = ()
        count = int(len(xs))
    events_q.put(ev.FinalTurnComplete(final_turn, alive, count))
    fname = output_path(win.shape[1], win.shape[0], final_turn, out_dir)
    write_pgm(fname, win)
    return fname


def distributor(
    p: Params,
    events_q: "queue.Queue",
    key_presses: Optional["queue.Queue"] = None,
    engine=None,
    images_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    live_view: bool = False,
    rule=None,
    device=None,
    sparse: bool = False,
) -> None:
    """Run `p` to completion (or quit/kill), pushing events and, last of
    all, `events.CLOSE` onto `events_q`. `live_view` adds the
    CellsFlipped/TurnComplete feed of a viewer. `sparse` runs on the
    sparse-torus engine (module note)."""
    images_dir = images_dir or os.environ.get("GOL_IMAGES", "images")
    out_dir = out_dir or os.environ.get("GOL_OUT", "out")
    if sparse and live_view:
        # The live view renders a Params-sized display (a 2^20 torus would
        # be a 1 TiB buffer) in window-local coordinates; snapshots ('s')
        # are the sparse visualisation path.
        import warnings

        warnings.warn("live view is not supported for sparse runs; "
                      "disabled (use 's' snapshots instead)")
        live_view = False
    width, height = p.image_width, p.image_height
    # The run's trace root: on this thread's context stack, so the
    # submit below (an in-process engine.run, or a remote engine's
    # rpc.ServerDistributor) parents under it; the helper threads, whose
    # stacks are empty, parent their tick and keypress spans under its
    # context.
    run_span = obs_trace.start(
        "controller.run",
        attrs={"w": width, "h": height, "turns": p.turns,
               "sparse": bool(sparse)})
    obs_trace.TRACER.push(run_span)
    root_ctx = run_span.context()
    done = threading.Event()
    helper_threads: list = []
    killed_by_key = threading.Event()
    # Shared pause state (the keypress thread toggles it, the recovery
    # loop reads and resets it): a controller-local bool could silently
    # invert against the engine across a loss/reattach cycle.
    pause_requested = threading.Event()
    # Set for the span of a loss episode: 'p' presses inside it are
    # dropped, since a pause posted to an engine whose run is being torn
    # down and resubmitted pairs with nothing.
    in_recovery = threading.Event()

    # Engine resolution can fail (no CUDA device, a bad GOL_RULE): it
    # happens under the try that delivers CLOSE, or every consumer of
    # the events queue would wait forever.
    try:
        if engine is None:
            engine = (_resolve_sparse_engine(width, rule, device) if sparse
                      else _resolve_engine(rule, device))
        # The rule family's io: PGM value levels (the Generations gray
        # encoding, else the strict {0,255}); the firing cells are the
        # 255 pixels for every family. The engine's own rule decides, so
        # a detached board resumed under CONT=yes keeps its encoding.
        io_rule = _engine_rule(engine, rule)
        pgm_levels = None
        if isinstance(io_rule, GenerationsRule):
            pgm_levels = tuple(gray_levels(io_rule).tolist())
    except BaseException as e:
        done.set()
        obs_trace.TRACER.pop(run_span)
        obs_trace.finish(run_span,
                         error=e if isinstance(e, Exception) else None)
        events_q.put(ev.CLOSE)
        raise

    # -- keypress loop (`Local/gol/distributor.go:107-152`) ---------------
    def keypress_loop() -> None:
        while not done.is_set():
            try:
                key = key_presses.get(timeout=0.1)
            except queue.Empty:
                continue
            # One span a handled key, under the run's root; names clamp
            # to the known keys, so they stay a bounded set.
            kname = key if key in ("s", "p", "q", "k", "c") else "other"
            try:
                with obs_trace.span(f"controller.key.{kname}",
                                    parent=root_ctx):
                    if key == "s":
                        if sparse:  # the live window, named by its dims
                            world, _, turn = engine.get_window()
                            fname = output_path(world.shape[1],
                                                world.shape[0], turn,
                                                out_dir)
                        else:
                            world, turn = engine.get_world()
                            fname = output_path(width, height, turn, out_dir)
                        with obs_trace.span("controller.write_pgm"):
                            write_pgm(fname, world, levels=pgm_levels)
                        events_q.put(ev.ImageOutputComplete(
                            turn, os.path.basename(fname)))
                    elif key == "p":
                        if in_recovery.is_set():
                            continue  # see in_recovery above
                        engine.cf_put(FLAG_PAUSE)
                        # The flag is committed: toggle the shared state
                        # BEFORE the (fallible) turn poll.
                        paused = not pause_requested.is_set()
                        if paused:
                            pause_requested.set()
                        else:
                            pause_requested.clear()
                        try:
                            _, turn = engine.alive_count()
                        except (ConnectionError, OSError, RuntimeError):
                            turn = 0
                        if paused:
                            events_q.put(ev.StateChange(turn, ev.State.PAUSED))
                        else:
                            print("Continuing")
                            events_q.put(
                                ev.StateChange(turn, ev.State.EXECUTING))
                    elif key == "c":
                        name, turn = engine.checkpoint_now(trigger="manual")
                        print(f"checkpointed turn {turn} "
                              f"({os.path.basename(name)})")
                    elif key == "q":
                        engine.cf_put(FLAG_QUIT)
                    elif key == "k":
                        killed_by_key.set()
                        engine.cf_put(FLAG_KILL)
            except EngineKilled:
                return
            except (ConnectionError, OSError):
                # Engine outage: drop this keypress but keep serving; the
                # run loop may reattach (GOL_RECONNECT) and later keys
                # must still work.
                continue
            except (RuntimeError, ValueError):
                # A snapshot or checkpoint asked for before the board is
                # loaded or with no GOL_CKPT, or a PGM write that refuses
                # the pixels: drop this keypress, keep serving.
                continue

    # -- 2 s alive ticker (`Local/gol/distributor.go:154-167`) ------------
    def ticker_loop() -> None:
        while not done.wait(ALIVE_POLL_SECONDS):
            try:
                with obs_trace.span("controller.tick", parent=root_ctx):
                    alive, turn = engine.alive_count()
            except EngineKilled:
                return
            except (ConnectionError, OSError, RuntimeError):
                continue  # an outage: keep the ticker alive
            events_q.put(ev.AliveCellsCount(turn, alive))

    # -- live view feed: CellsFlipped diffs + TurnComplete ----------------
    # (`Local/gol/event.go:92-110`): every 0.1 s, the cells that changed
    # since the last frame seen, then the frame's turn. A poll waits for
    # the chunk that made its board, the newest issued, so on a card
    # frames come about once per chunks-in-flight x chunk wall.
    def live_loop() -> None:
        prev, prev_turn = None, -1
        cap = env_int(LIVE_MAX_CELLS_ENV, LIVE_MAX_CELLS_DEFAULT, minimum=0)
        if 0 < cap < width * height:
            import warnings

            warnings.warn(
                f"live view: board {width}x{height} exceeds "
                f"GOL_LIVE_MAX_CELLS={cap}; streaming a downsampled view "
                f"(O(viewport) bytes/frame, coordinates in view space)")
        while not done.wait(0.1):
            try:
                world, turn, _ = engine.get_view(cap)
            except EngineKilled:
                return
            except (ConnectionError, OSError, RuntimeError):
                continue  # no board loaded yet, or an outage
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
        # before this run's keypresses start. A failure here is no
        # verdict: the run's own submit meets it.
        try:
            engine.drain_flags()
        except (EngineKilled, ConnectionError, OSError, RuntimeError):
            pass
        if sparse:
            # A remote sparse engine's torus size is server state
            # (`--sparse SIZE`); a mismatched controller would wrap final
            # torus coordinates by the wrong modulus. Fail fast on a
            # definite mismatch; a transport error here is no verdict.
            try:
                board = (engine.stats() or {}).get("board")
            except (EngineKilled, ConnectionError, OSError, RuntimeError):
                board = None
            if board is not None and tuple(board) != (height, width):
                raise ValueError(
                    f"engine torus is {board[1]}x{board[0]} but Params "
                    f"say {width}x{height} — match the server's "
                    f"--sparse SIZE")
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
        if sparse and os.environ.get("CONT", "") == "yes":
            # The engine's held window IS the state; only the resume
            # arithmetic travels.
            world = None
            start_turn = engine.ping()
            turns_left = max(p.turns - start_turn, 0)
        elif sparse:
            world = read_pgm(os.path.join(images_dir, "seed.pgm"))
            turns_left = p.turns
        elif os.environ.get("CONT", "") == "yes":
            world, start_turn = engine.get_world()
            turns_left = max(p.turns - start_turn, 0)
        else:
            src = input_path(width, height, images_dir)
            with obs_trace.span("controller.read_pgm"):
                world = read_pgm(src, levels=pgm_levels)
            if world.shape != (height, width):
                raise ValueError(
                    f"{src}: image is {world.shape[1]}x{world.shape[0]} "
                    f"but Params say {width}x{height}")
            turns_left = p.turns

        recoverable = getattr(engine, "recoverable", False)
        if recoverable:
            # Attach probe: one ping teaches the client the server's wire
            # caps BEFORE the seed board is uploaded, so the first upload
            # rides the negotiated codec. Failures fall through to the
            # submit loop's own recovery.
            try:
                engine.ping()
                obs_log("wire.caps", caps=sorted(engine.peer_caps))
            except (ConnectionError, OSError, EngineKilled, RuntimeError):
                pass

        events_q.put(ev.StateChange(start_turn, ev.State.EXECUTING))

        # -- blocking run (`:182`), with reattach-on-loss -----------------
        # Recovery only for engines whose ConnectionError/OSError means
        # the network or the peer (RemoteEngine sets `recoverable`): an
        # in-process engine's OSError must propagate.
        reconnect_budget = env_float(RECONNECT_ENV, RECONNECT_DEFAULT)
        recoverable = recoverable and reconnect_budget > 0
        lost_pending = False       # a loss episode awaits its Reattached
        recovery_deadline = None   # bound on one recovery episode
        recovering = False         # a loss has happened on this run

        def _close_recovery(turn: int) -> None:
            """A pause cannot survive engine loss: reset the shared pause
            state and tell consumers the run executes again."""
            if pause_requested.is_set():
                pause_requested.clear()
                events_q.put(ev.StateChange(turn, ev.State.EXECUTING))

        while True:
            run_params = Params(threads=p.threads, image_width=width,
                                image_height=height, turns=turns_left)
            submit_t = time.monotonic()
            try:
                final_world, final_turn = engine.server_distributor(
                    run_params, world, _sub_workers(),
                    start_turn=start_turn)
                if lost_pending:
                    # The resubmit itself proved contact: close the Lost
                    # episode so consumers see paired events.
                    events_q.put(ev.EngineReattached(final_turn))
                    lost_pending = False
                    _close_recovery(final_turn)
                in_recovery.clear()
                break
            except EngineKilled:
                final_world, final_turn = world, start_turn
                break
            except (ConnectionError, OSError):
                if not recoverable:
                    raise
                recovering = True
                now = time.monotonic()
                if now - submit_t > reconnect_budget:
                    # The failed submission outlived a whole budget before
                    # dying: a NEW outage, which gets a fresh budget.
                    recovery_deadline = None
                if recovery_deadline is None:
                    recovery_deadline = now + reconnect_budget
                elif now >= recovery_deadline:
                    raise  # episode budget exhausted: stop flapping
                else:
                    time.sleep(0.1)  # damp a flapping link's retry spin
                in_recovery.set()
                if not lost_pending:
                    events_q.put(ev.EngineLost(start_turn))
                    lost_pending = True
                try:
                    _await_engine(
                        engine, max(recovery_deadline - now, 0.0))
                except EngineKilled:
                    final_world, final_turn = world, start_turn
                    break
            except EngineBusy:
                # After a transient partition the server never saw the
                # dead socket, so this run's orphan still occupies the
                # engine. abort_run is token-scoped: it stops OUR orphan
                # and is a no-op on a foreign controller's run. EngineBusy
                # on a FIRST submission is a foreign-run conflict.
                if not (recovering and hasattr(engine, "abort_run")):
                    raise
                in_recovery.set()
                if time.monotonic() >= recovery_deadline:
                    raise
                try:
                    engine.abort_run()
                except EngineKilled:
                    final_world, final_turn = world, start_turn
                    break
                except (ConnectionError, OSError, RuntimeError):
                    pass
                time.sleep(0.3)

            # -- reattach: refresh state, then resubmit ------------------
            contacted = True
            try:
                # An engine back with authoritative state (it survived, or
                # was restarted from a checkpoint): resume from it. Sparse
                # runs resume the ENGINE-HELD window (world stays None: a
                # window re-stamped as a seed would lose its torus
                # origin); an engine that came back empty fails the
                # resubmit with "no sparse state to resume".
                if sparse:
                    start_turn = engine.ping()
                    world = None
                else:
                    world, start_turn = engine.get_world()
            except EngineKilled:
                final_world, final_turn = world, start_turn
                break
            except RuntimeError:
                # Engine answered but restarted empty: resubmit the
                # last-known board from the last-known turn.
                pass
            except (ConnectionError, OSError):
                # Flapped again between ping and snapshot: contact is not
                # restored; the resubmit fails back into recovery.
                contacted = False
            turns_left = max(p.turns - start_turn, 0)
            if lost_pending and contacted:
                events_q.put(ev.EngineReattached(start_turn))
                lost_pending = False
                _close_recovery(start_turn)
            if contacted:
                try:
                    # Wipe PAUSE flags stranded before the loss so
                    # the resubmitted run starts unpaused; a stranded
                    # quit/kill is an order the resubmitted run honours.
                    # A no-op while our orphan still occupies the engine.
                    engine.drain_flags(pause_only=True)
                except EngineKilled:
                    final_world, final_turn = world, start_turn
                    break
                except (ConnectionError, OSError, RuntimeError):
                    pass
            in_recovery.clear()

        # -- finalize (`:187-226`) ----------------------------------------
        # The final event carries the alive (firing) cell set; beyond
        # GOL_MAX_EVENT_CELLS cells only the count travels (a 65536²
        # board's ~10^9 coordinate tuples would exhaust memory).
        max_event_cells = env_int("GOL_MAX_EVENT_CELLS", 1 << 24, minimum=0)
        if sparse:
            # Once a job: the window's second readback and unpack, the
            # alive list, FinalTurnComplete and the PGM write.
            with obs_trace.span("controller.sparse_finish",
                                attrs={"turn": final_turn}):
                fname = _finish_sparse(engine, final_world, final_turn,
                                       width, height, max_event_cells,
                                       out_dir, events_q)
        else:
            if final_world.size <= max_event_cells:
                alive = tuple((c.x, c.y) for c in
                              alive_cells_from_board(final_world == 255))
                count = len(alive)
            else:
                alive = ()
                count = int((final_world == 255).sum())
            events_q.put(ev.FinalTurnComplete(final_turn, alive, count))
            fname = output_path(width, height, final_turn, out_dir)
            with obs_trace.span("controller.write_pgm"):
                write_pgm(fname, final_world, levels=pgm_levels)
        if fname is not None:
            events_q.put(ev.ImageOutputComplete(
                final_turn, os.path.basename(fname)))
        if killed_by_key.is_set():
            try:
                engine.kill_prog()
            except (EngineKilled, ConnectionError, OSError):
                pass
        events_q.put(ev.StateChange(final_turn, ev.State.QUITTING))
    finally:
        done.set()
        obs_trace.TRACER.pop(run_span)
        obs_trace.finish(run_span)
        events_q.put(ev.CLOSE)
        for t in helper_threads:
            t.join(timeout=5.0)
