"""SparseEngine: the sparse torus behind the full control protocol — the
counterpart of `gol_tpu/sparse_engine.py`.

`models/sparse.SparseTorus` steps the live window of a 2^40-cell torus in
episodes of queued macro-steps; this wraps it in the dense `Engine`'s
control surface (duck-typed: `server.EngineServer`, `client.RemoteEngine`
and the distributor drive either without caring which):

    server_distributor — blocking run; `world` is a SMALL seed board
                         whose live cells are stamped centred on the
                         torus, or None to resume the engine-held state
                         (the CONT=yes detach/reattach contract)
    alive_count        — (alive, turn), published per chunk with no
                         device work on the poll path
    get_world          — live-window snapshot ({0,255} pixels)
    get_window         — (pixels, (ox, oy) torus origin, turn)
    cf_put/drain_flags — reference flag protocol (pause 0/quit 2/kill 5)
    abort_run/ping/stats/kill_prog, checkpoints (repr "sparse")

Chunking: the host wakes between adaptively-sized turn chunks (wall
target ~CHUNK_TARGET_SECONDS) to honour flags and publish (window,
origin, turn, alive) as one coherent snapshot; inside a chunk
`SparseTorus.run` batches macro-steps into episodes that wait for the
device once each.

Measurements: `stats()` carries the cumulative `window_cell_updates`,
`macros`, `margin_fetches` and `grows` of every torus the engine held
(`models/sparse.py`). While the span gate is open (`obs/trace.py`
`hot_spans_enabled`: its configured half read once a run, the profiler's
once a chunk) each chunk records a `sparse.chunk` span (k, turn) holding
the torus's `sparse.margins`, `sparse.grow` and `sparse.macro` spans, a
`sparse.count` span (the chunk's synchronising alive fetch) and a
`sparse.publish` span; every run records `sparse.final_window`, the
final window's readback and unpack.

The device is explicit: `SparseEngine(device=None)` means CUDA and raises
without one; `device="cpu"` runs the kernels' plain versions. `shards`
(GOL_SPARSE_SHARDS) row-shards the window over that many of the engine's
`devices` (`models/sparse.py`); readers and checkpoints see the window
gathered in shard order, so every surface reads as on one device.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gol_tpu_torch import ckpt as ckpt_mod
from gol_tpu_torch import wire
from gol_tpu_torch.ckpt.writer import device_to_host
from gol_tpu_torch.engine import (
    CHUNK_TARGET_ENV,
    CHUNK_TARGET_SECONDS,
    CKPT_EVERY_DEFAULT,
    CKPT_EVERY_ENV,
    MAX_CHUNK_ENV,
    ControlFlagProtocol,
    EngineBusy,
    _block_max,
    _or_rows,
    resolve_device,
    view_factor,
)
from gol_tpu_torch.fleet.handles import SingleRunSurface
from gol_tpu_torch.models.lifelike import CONWAY, LifeLikeRule
from gol_tpu_torch.models.sparse import (
    SparseTorus,
    check_sparse_mesh,
    window_words,
)
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.ops.bitpack import (
    WORD_BITS,
    unpack,
    unpack_np,
    words_to_numpy,
)
from gol_tpu_torch.parallel.mesh import default_devices, make_mesh
from gol_tpu_torch.utils.envcfg import env_float, env_int

SPARSE_CHUNK_MIN = 64
SPARSE_CHUNK_MAX = 1 << 16
SHARDS_ENV = "GOL_SPARSE_SHARDS"
# A torus's cumulative counters, as `stats()` names them.
TORUS_COUNTERS = ("window_cell_updates", "macros", "margin_fetches",
                  "grows")


class SparseEngine(SingleRunSurface, ControlFlagProtocol):
    def __init__(self, size: int, rule=CONWAY,
                 shards: Optional[int] = None, device=None,
                 devices=None) -> None:
        """`shards`: devices to row-shard the window over
        (GOL_SPARSE_SHARDS when None; default 1), clamped to `devices`:
        as `Engine(devices=)`, by default the distinct visible CUDA
        devices, or `[device]` when `device` is given; a device may
        repeat (`["cpu"] * 4` in the tests, `cuda:0` N times on one
        card). The count must divide 256 and the torus size
        (`check_sparse_mesh`)."""
        if not isinstance(rule, LifeLikeRule):
            # The live-window argument is a 2-state property; another
            # family's rule would evolve wrongly.
            raise ValueError(
                f"sparse engine supports life-like rules only, "
                f"got {rule.rulestring!r}")
        if 0 in rule.born:
            # Fail at construction (server startup), not at the first
            # submit, and never let a restore bypass the seed-time check.
            raise ValueError(
                f"rule {rule.rulestring} births on 0 neighbours; "
                "use the dense engine")
        if size % WORD_BITS != 0:
            raise ValueError(f"torus size {size} not a multiple of 32")
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
        elif device is not None:
            devices = [resolve_device(device)]
        else:
            devices = default_devices()
        self.size = size
        self._rule = rule
        if shards is None:
            shards = env_int(SHARDS_ENV, 1)
        shards = max(1, min(shards, len(devices)))
        if shards > 1:
            # A bad shard count fails at construction (server start), not
            # as a per-submission error.
            check_sparse_mesh(shards, size)
            self._mesh = make_mesh(shards, devices=devices)
        else:
            self._mesh = None
        self._devices = devices[:shards]
        self._device = self._devices[0]
        self._state_lock = threading.Lock()
        self._torus: Optional[SparseTorus] = None
        # The counters of the tori this engine held before `_torus`.
        self._retired = dict.fromkeys(TORUS_COUNTERS, 0)
        self._turn = 0
        # Published-per-chunk coherent snapshot: (window words, ox, oy,
        # turn, alive). Poll paths (ticker, get_window, checkpoint) read
        # this, never the mutating torus internals.
        self._pub: Optional[tuple] = None
        self._flags: "queue.Queue[int]" = queue.Queue()
        self._killed = False
        self._running = False
        self._run_token: Optional[str] = None
        self._abort = threading.Event()
        self._last_chunk = 0
        self._turns_per_s = 0.0
        self._chunk_overhead_us = 0.0

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------ RPC

    def server_distributor(
        self,
        params,
        world: Optional[np.ndarray],
        sub_workers: Sequence[str] = (),
        start_turn: int = 0,
        token: Optional[str] = None,
    ) -> Tuple[np.ndarray, int]:
        """Blocking sparse run. `world`: small seed board (its live cells
        are stamped centred on the torus) or None to resume the held
        state. Returns ({0,255} live-window pixels, completed turn)."""
        self._check_alive()
        if self._running:
            raise EngineBusy("engine already running a board")
        if world is not None:
            h0, w0 = world.shape
            ys, xs = np.nonzero(world)
            if len(xs) == 0:
                raise ValueError("seed board has no live cells")
            offx = (self.size - w0) // 2
            offy = (self.size - h0) // 2
            cells = [(int(x) + offx, int(y) + offy)
                     for x, y in zip(xs, ys)]
            torus = SparseTorus(self.size, cells, self._rule,
                                device=self._device, mesh=self._mesh)
        else:
            torus = None
        with self._on_device():
            with self._state_lock:
                if self._running:
                    raise EngineBusy("engine already running a board")
                if torus is not None:
                    self._install_locked(torus)
                    self._turn = start_turn
                elif self._torus is None:
                    raise RuntimeError("no sparse state to resume")
                self._running = True
                self._run_token = token
                self._abort.clear()
                self._publish_locked()
            return self._run_loop(params, start_turn)

    def _run_loop(self, params, start_turn: int) -> Tuple[np.ndarray, int]:
        target = start_turn + params.turns
        chunk_target = (env_float(CHUNK_TARGET_ENV, CHUNK_TARGET_SECONDS)
                        or CHUNK_TARGET_SECONDS)
        # GOL_MAX_CHUNK bounds flag/pause latency exactly as on the dense
        # engine (and is the tests' throttle).
        max_chunk = min(env_int(MAX_CHUNK_ENV, SPARSE_CHUNK_MAX),
                        SPARSE_CHUNK_MAX)
        chunk = min(SPARSE_CHUNK_MIN, max_chunk)
        quit_run = False
        ckpt_dir = os.environ.get(ckpt_mod.CKPT_DIR_ENV, "")
        ckpt_every = env_float(CKPT_EVERY_ENV, CKPT_EVERY_DEFAULT)
        ckpt_path = ""
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            ckpt_path = os.path.join(
                ckpt_dir, f"sparse{self.size}x{self.size}.npz")
        last_ckpt = time.monotonic()
        # Turn-based manifest checkpointing, same contract as the dense
        # engine: chunk boundaries clamped onto checkpoint turns so the
        # cadence is timing-independent and resume-comparable.
        ckpt_writer = None
        next_ckpt_turn = None
        ckpt_every_turns = 0
        if ckpt_dir:
            ckpt_every_turns = env_int(
                ckpt_mod.CKPT_EVERY_TURNS_ENV, 0, minimum=0)
            if ckpt_every_turns > 0:
                ckpt_writer = self._ckpt_writer(ckpt_dir)
                next_ckpt_turn = (
                    start_turn // ckpt_every_turns + 1) * ckpt_every_turns

        # Host-overhead accounting, as in the JAX engine: per-iteration
        # wall time minus the device span (`elapsed` brackets run + the
        # syncing alive_count) minus excluded stalls (sync checkpoint
        # saves, slow flag service).
        host_overhead = 0.0
        overhead_iters = 0
        hot_env = obs_trace.hot_spans_from_env()
        try:
            while self._turn < target and not quit_run:
                if self._killed or self._abort.is_set():
                    break
                t_iter = time.monotonic()
                stall_excl = 0.0
                k = min(chunk, target - self._turn)
                if next_ckpt_turn is not None:
                    k = min(k, next_ckpt_turn - self._turn)
                t0 = time.monotonic()
                chunk_span = None
                if hot_env or obs_trace.profiler_running():
                    chunk_span = obs_trace.start(
                        "sparse.chunk", attrs={"k": k, "turn": self._turn + k},
                        start=t0)
                self._torus.chunk_span = chunk_span
                self._torus.run(k)
                # One poll-free (alive, turn) pair per chunk; fetching the
                # count also waits for the episode chain, making `elapsed`
                # a real wall measurement for the chunk adapter.
                t_count = time.monotonic()
                alive = self._torus.alive_count()
                t_counted = time.monotonic()
                elapsed = t_counted - t0
                with self._state_lock:
                    self._turn += k
                    self._last_chunk = k
                    if elapsed > 0:
                        self._turns_per_s = k / elapsed
                    self._publish_locked(alive)
                if chunk_span is not None:
                    attrs = {"turn": self._turn}
                    obs_trace.TRACER.record("sparse.count", t_count,
                                            t_counted, chunk_span, attrs)
                    end = time.monotonic()
                    obs_trace.TRACER.record("sparse.publish", t_counted, end,
                                            chunk_span, dict(attrs,
                                                             alive=alive))
                    obs_trace.finish(chunk_span, end=end)
                if elapsed < chunk_target and chunk * 2 <= max_chunk:
                    chunk *= 2
                elif elapsed > chunk_target * 2 and chunk > 1:
                    chunk //= 2
                if (next_ckpt_turn is not None
                        and self._turn >= next_ckpt_turn):
                    ckpt_writer.submit(self._ckpt_snapshot("periodic"))
                    next_ckpt_turn = (
                        self._turn // ckpt_every_turns + 1
                    ) * ckpt_every_turns
                if ckpt_path and \
                        time.monotonic() - last_ckpt >= ckpt_every:
                    t_sync = time.monotonic()
                    self.save_checkpoint(ckpt_path)
                    last_ckpt = time.monotonic()
                    stall_excl += last_ckpt - t_sync
                if self._turn < target and (
                        self._flags.queue or self._killed
                        or self._abort.is_set()):
                    t_flags = time.monotonic()
                    quit_run = self._handle_flags()
                    flag_cost = time.monotonic() - t_flags
                    if flag_cost > 0.01:
                        stall_excl += flag_cost
                host_overhead += max(
                    0.0, time.monotonic() - t_iter - elapsed - stall_excl)
                overhead_iters += 1
            if ckpt_writer is not None and self._turn > start_turn:
                ckpt_writer.submit(self._ckpt_snapshot("final"))
        except Exception:
            if ckpt_writer is not None:
                try:
                    ckpt_writer.write_sync(self._ckpt_snapshot("emergency"))
                except Exception:
                    pass
            raise
        finally:
            if ckpt_writer is not None:
                ckpt_writer.close(timeout=60.0)
            if overhead_iters:
                self._chunk_overhead_us = (
                    host_overhead / overhead_iters * 1e6)
            with self._state_lock:
                final_pub = self._pub
                final_turn = self._turn
                self._running = False
                self._run_token = None
                self._abort.clear()
        t_final = time.monotonic()
        pixels = self._window_pixels(final_pub)
        obs_trace.TRACER.record(
            "sparse.final_window", t_final, time.monotonic(),
            attrs={"turn": final_turn, "h": pixels.shape[0],
                   "w": pixels.shape[1]})
        return pixels, final_turn

    def alive_count(self) -> Tuple[int, int]:
        """(alive, turn) from the last published chunk boundary —
        exact-at-turn, no device work on the poll path."""
        self._check_alive()
        with self._state_lock:
            if self._pub is None:
                return 0, self._turn
            _, _, _, turn, alive = self._pub
            return alive, turn

    def get_world(self) -> Tuple[np.ndarray, int]:
        """Live-window snapshot pixels (the sparse analog of the full
        board — the torus itself is up to 2^40 cells)."""
        pixels, _, turn = self.get_window()
        return pixels, turn

    def get_window(self) -> Tuple[np.ndarray, Tuple[int, int], int]:
        """(window pixels, (ox, oy) torus origin of window cell (0,0),
        completed turn)."""
        pub = self._published()
        return self._window_pixels(pub), (pub[1], pub[2]), pub[3]

    # Sparse frames are WINDOW-anchored and the origin moves as the
    # pattern grows: the wire must never delta-encode them (see
    # get_view); snapshots are always strict {0,255}.
    frames_diffable = False
    binary_pixels = True

    def get_world_frame(self, caps) -> Tuple[object, int]:
        """(wire.Frame, turn) for the live-window snapshot: a peer that
        negotiated CAP_PACKED gets the window's words straight off the
        device, never unpacked; everyone else the usual pixel encode."""
        pub = self._published()
        caps = frozenset(caps)
        words, _, _, turn, _ = pub
        h, w = words.shape[0], words.shape[1] * WORD_BITS
        if wire.CAP_PACKED in caps:
            with self._on_device():
                host = device_to_host(words)
            return wire.packed_words_frame(h, w, iter([host]), caps), turn
        return wire.encode_board(self._window_pixels(pub), caps,
                                 binary=True), turn

    def get_view(
        self, max_cells: int
    ) -> Tuple[np.ndarray, int, Tuple[int, int]]:
        """(window view, turn, (f, f)): the live window when it fits
        `max_cells`, else the dense engine's block-any-alive reduction
        made on the device (a grown window can be GBs).

        Frames are WINDOW-anchored and the window's torus origin moves as
        the pattern grows, so consecutive frames of one shape are NOT
        diffable; incremental consumers anchor on `get_window()`'s
        origin, and the controller's live view stays off for sparse
        runs."""
        pub = self._published()
        words, _, _, turn, _ = pub
        h, w = words.shape[0], words.shape[1] * WORD_BITS
        if max_cells <= 0 or h * w <= max_cells:
            return self._window_pixels(pub), turn, (1, 1)
        f = view_factor(h, w, max_cells)
        with self._on_device():
            view = _block_max(unpack(_or_rows(words, f)), 1, f) * 255
            return view.cpu().numpy(), turn, (f, f)

    def stats(self) -> dict:
        self._check_alive()
        with self._state_lock:
            window = origin = None
            alive = alive_turn = None
            if self._pub is not None:
                words, ox, oy, alive_turn, alive = self._pub
                h, wp = words.shape
                window, origin = [h, wp * WORD_BITS], [ox, oy]
            return {
                "turn": self._turn,
                "running": self._running,
                "board": [self.size, self.size],
                "window": window,
                "origin": origin,
                "alive": alive,
                "alive_turn": alive_turn,
                "packed": True,
                "sparse": True,
                "chunk": self._last_chunk,
                "turns_per_s": round(self._turns_per_s, 1),
                "chunk_overhead_us": round(self._chunk_overhead_us, 2),
                "rule": self._rule.rulestring,
                "devices": len(self._devices),
                "device": str(self._device),
                **self._counters_locked(),
            }

    # -------------------------------------------------------- checkpointing

    def _ckpt_snapshot(self, trigger: str = "manual"):
        """The published (window, origin, turn) as a ckpt.Snapshot (repr
        "sparse": the writer stores the window words and the origin and
        size scalars in the sparse npz format)."""
        words, ox, oy, turn, _ = self._published()
        return ckpt_mod.Snapshot(
            words, "sparse", turn, (self.size, self.size),
            self._rule.rulestring, trigger=trigger,
            mesh={"devices": len(self._devices)},
            extra={"size": self.size, "ox": ox, "oy": oy},
            stream=self._current_stream())

    def checkpoint_now(self, directory: Optional[str] = None,
                       trigger: str = "manual") -> Tuple[str, int]:
        """Synchronous durable manifest checkpoint — same contract as
        `Engine.checkpoint_now` (Checkpoint wire method, SIGTERM)."""
        d = directory or os.environ.get(ckpt_mod.CKPT_DIR_ENV, "")
        if not d:
            raise RuntimeError(
                "checkpointing not configured: set GOL_CKPT or pass "
                "--checkpoint DIR")
        self._check_alive()
        snap = self._ckpt_snapshot(trigger)
        return self._ckpt_writer(d).write_sync(snap), snap.turn

    def geometry(self) -> dict:
        """Placement geometry for the reshard-at-restore contract
        (`ckpt/reshard.py`): the torus size is fixed at construction, so
        a mismatched checkpoint is refused unless resharded (and then it
        must decode to exactly this torus)."""
        return {"kind": "sparse", "devices": len(self._devices),
                "size": int(self.size)}

    def restore_run(self, path: str, reshard: bool = False) -> int:
        """Verified manifest/legacy restore; returns the restored turn.
        `reshard=True` routes a geometry-mismatched checkpoint through
        the host-side canonical repack."""
        return ckpt_mod.restore_engine(self, path, reshard=reshard)

    def save_checkpoint(self, path: str) -> None:
        """Atomic .npz of (window words as uint32, origin, torus size,
        turn, rule) — the whole sparse state, 8 cells a byte, in the JAX
        engine's format."""
        words, ox, oy, turn, _ = self._published()
        with self._on_device():
            host = words_to_numpy(words)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                np.savez_compressed(
                    f, sparse_words=host, ox=ox, oy=oy, size=self.size,
                    turn=turn, rulestring=self._rule.rulestring)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load_checkpoint(self, path: str) -> int:
        """Restore (window, origin, turn) from a sparse checkpoint of
        either package; returns the turn. Refused: another rule or torus
        size, words that are not 2-D uint32, a window larger than the
        torus, an origin that is not word-aligned, and any restore while
        a run is in flight."""
        self._check_alive()
        with np.load(path) as z:
            if "sparse_words" not in z.files:
                raise ValueError(f"{path}: not a sparse checkpoint")
            if str(z["rulestring"]) != self._rule.rulestring:
                raise ValueError(
                    f"checkpoint rule {z['rulestring']!r} != engine rule "
                    f"{self._rule.rulestring!r}")
            if int(z["size"]) != self.size:
                raise ValueError(
                    f"checkpoint torus {int(z['size'])} != engine torus "
                    f"{self.size}")
            words = z["sparse_words"]
            if words.dtype != np.uint32 or words.ndim != 2:
                raise ValueError(f"{path}: bad words {words.dtype} "
                                 f"{words.shape}")
            # Window-geometry invariants: SparseTorus establishes window
            # <= torus and a word-aligned origin, and the repositioning
            # machinery assumes both.
            ox, oy = int(z["ox"]), int(z["oy"])
            if (words.shape[0] > self.size
                    or words.shape[1] * WORD_BITS > self.size):
                raise ValueError(
                    f"{path}: window {words.shape[1] * WORD_BITS}x"
                    f"{words.shape[0]} exceeds torus {self.size}")
            if ox % WORD_BITS != 0:
                raise ValueError(
                    f"{path}: window origin x={ox} is not word-aligned")
            turn = int(z["turn"])
            with self._on_device():
                torus = SparseTorus._from_state(
                    self.size, words, ox, oy, self._rule,
                    device=self._device, mesh=self._mesh)
        with self._state_lock:
            if self._running:
                raise RuntimeError("cannot restore while running")
            self._install_locked(torus)
            self._turn = turn
            with self._on_device():
                self._publish_locked()
        return turn

    # ------------------------------------------------------------- internals

    def _published(self) -> tuple:
        """The published (window words, ox, oy, turn, alive), a sharded
        window gathered in shard order on the first device."""
        self._check_alive()
        with self._state_lock:
            pub = self._pub
        if pub is None:
            raise RuntimeError("no board loaded")
        with self._on_device():
            return (window_words(pub[0]),) + pub[1:]

    def _install_locked(self, torus: SparseTorus) -> None:
        """Hold `torus`, keeping the counters of the one it replaces;
        caller holds the lock."""
        self._retired = self._counters_locked()
        self._torus = torus

    def _counters_locked(self) -> dict:
        """The cumulative torus counters (`TORUS_COUNTERS`) of every
        torus held; caller holds the lock."""
        t = self._torus
        return {name: self._retired[name] + (getattr(t, name) if t else 0)
                for name in TORUS_COUNTERS}

    def _publish_locked(self, alive: Optional[int] = None) -> None:
        """Refresh the coherent poll snapshot; caller holds the lock."""
        t = self._torus
        if t is None:
            self._pub = None
            return
        if alive is None:
            alive = t.alive_count()
        # The window as stepped (sharded or not): a macro-step makes new
        # tensors, so the published one never changes under a reader.
        self._pub = (t._packed, t._ox, t._oy, self._turn, alive)

    def _window_pixels(self, pub) -> np.ndarray:
        if pub is None:
            raise RuntimeError("no board loaded")
        with self._on_device():
            host = words_to_numpy(window_words(pub[0]))
        return unpack_np(host) * np.uint8(255)
