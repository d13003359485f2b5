"""The single-device engine: holds (board, turn) on one device and steps
it in chunks — the counterpart of `gol_tpu/engine.py`'s `Engine` for the
life-like `packed` and `u8` representations, the Generations `gen3`
(stacked packed planes) and `gen8` (uint8 states) representations, and
the conv/FFT families: Larger-than-Life on `u8` cells and Lenia on `f32`
float32 state in [0, 1] (`ops/conv.py`; one device, as the JAX engine
runs them single-shard).

Control protocol (reference `Server/gol/distributor.go:54-83`):

    server_distributor  — blocking run
    alive_count         — (alive, turn) poll, no device work
    get_world           — board snapshot + turn
    cf_put              — control flag: 0 pause-toggle, 2 quit, 5 kill
    kill_prog           — die

`get_world_frame(caps)` is the snapshot the engine server sends
(`server.py`): packed words go to the wire as they lie on the device, in
row bands whose device-to-host copies overlap the socket sends.

Chunks are powers of two, sized so one chunk takes about
CHUNK_TARGET_SECONDS, and up to PIPELINE_DEPTH chunks are in flight on
the device's stream. Each chunk ends with its completion token, the alive
count (for Generations, the firing count: cells in state 1; for Lenia,
cells above `ALIVE_THRESHOLD`) as one int64 on the device, copied
without blocking into pinned host memory, with a CUDA event recorded
after the copy. For `packed` boards and `gen3` planes the chunk's last
stepping launch counts it (`count=` of the run functions: no launch of
its own); the other reprs sum per-row int32 counts in int64 with torch.
Popping the oldest chunk waits on its event alone and publishes its
exact (alive, turn) pair, which `alive_count` then returns without
touching the device.

`GOL_FUSE_K`, read at each submit, pins the temporal-fusion depth of
packed and gen3 boards (`ops/fused.py`); chunk sizes stay powers of two,
and a chunk the depth does not divide ends with one shallower sweep.

Checkpoints and the run journal (`ckpt/`, `journal.py`; the JAX
engine's contract, interchangeable with it): with `GOL_CKPT` set a run
autosaves `WxH.npz` every `GOL_CKPT_EVERY` seconds, and with
`GOL_CKPT_EVERY_TURNS` also publishes `gol-ckpt/1` manifests at exact
turn multiples from a background writer, plus a `final` one at every
exit from the loop (an `emergency` one on an exception). With
`GOL_JOURNAL` set it journals `create`, board digests every
`GOL_JOURNAL_DIGEST_EVERY` turns (taken at pop time, on the completed
chunk) and `end`. Chunk boundaries land exactly on checkpoint and digest
turns, so those turns depend on the cadence alone. `checkpoint_now`,
`restore_run`, `save_checkpoint` and `load_checkpoint` are the
synchronous surface.

Telemetry, as in the JAX engine: each issued chunk pokes
`_bcast_notify` (the broadcast hub's publish hook, once a server has a
subscriber); a Profile request (`obs/prof.py`: the Profile RPC, POST
/profile, `GOL_PROFILE_DIR`) drains the in-flight chunks and steps the
requested turns one chunk at a time under `torch.profiler`, each chunk
still counted by its last stepping launch, so every published pair stays
exact; `GOL_TRACE` traces one chunk the same way; `GOL_RUN_REPORT`
writes the run's timeline; the chunk-loop metric families move at most
every METRICS_FLUSH_SECONDS, and the device-memory gauges every
DEVPOLL_SECONDS.

The devices are explicit: `Engine()` means the distinct visible CUDA
devices and raises where there are none; `Engine(device="cpu")` runs the
plain versions of the kernels on the CPU, as the tests do;
`Engine(devices=[...])` names them, one device possibly more than once
(`[torch.device("cpu")] * 8` in the tests, `[cuda:0] * S` in
`chip_smoke.py`). A run's shard count is the length of `sub_workers`
(the reference's `SUB`), else `params.threads`, clamped to the device
count (`gol_tpu/engine.py:646-652`); one CUDA card runs one shard. More
shards hold the board as a `parallel.mesh.ShardedBoard`: life-like
boards on a 2-D mesh (`mesh_shape=` or GOL_MESH="RxC") when asked and
the board tiles it, else row shards — the exact-N wrap extension when
the count does not divide the height, else equal shards with deep-halo
macro-steps; Generations on row shards (gen3 and gen8, exact-N
included); the conv families on one shard. Each shard's last stepping
launch counts its own rows (pad rows excluded) into an int64 of its
own, and the host adds them. GetWorld, GetView, captures, digests and
checkpoints read the shards in mesh order (`ShardedBoard.gather`).
"""

from __future__ import annotations

import contextlib
import functools
import os
import warnings
import queue
import threading
import time
from collections import deque
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from gol_tpu_torch import ckpt as ckpt_mod
from gol_tpu_torch import journal as journal_mod
from gol_tpu_torch import wire
from gol_tpu_torch.ckpt.writer import device_to_host, payload_arrays
from gol_tpu_torch.fleet.handles import SingleRunSurface
from gol_tpu_torch.models.generations import (
    GenerationsRule,
    from_pixels_gen,
    gray_levels,
    pack_state3,
    to_pixels_gen,
)
from gol_tpu_torch.models.largerthanlife import LargerThanLifeRule
from gol_tpu_torch.models.lenia import ALIVE_THRESHOLD, LeniaRule
from gol_tpu_torch.models.lifelike import CONWAY
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import devstats as obs_devstats
from gol_tpu_torch.obs import flight as obs_flight
from gol_tpu_torch.obs import halostats as obs_halostats
from gol_tpu_torch.obs import prof as obs_prof
from gol_tpu_torch.obs import timeline as obs_timeline
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.ops import _build
from gol_tpu_torch.ops import conv as conv_ops
from gol_tpu_torch.ops.bitpack import (
    WORD_BITS,
    pack_np,
    unpack,
    unpack_np,
    words_from_numpy,
    words_to_numpy,
)
from gol_tpu_torch.ops.cuda_stencil import row_popcounts
from gol_tpu_torch.ops.fused import configured_fuse_k
from gol_tpu_torch.ops.stencil import row_alive_counts
from gol_tpu_torch.params import Params
from gol_tpu_torch.parallel.halo import (
    exact_shard_ext,
    extend_rows,
    fused_run_fn,
    halo_traffic,
    mesh_run_fn,
    select_generations_representation,
    select_representation,
)
from gol_tpu_torch.parallel.mesh import (
    ShardedBoard,
    default_devices,
    make_mesh,
    mesh_geometry,
    shard,
)
from gol_tpu_torch.utils.devicemem import half_device_memory
from gol_tpu_torch.utils.envcfg import env_float, env_int

# Control-flag wire values (reference Cf.Flag).
FLAG_PAUSE = 0
FLAG_QUIT = 2
FLAG_KILL = 5

# The adapter holds a chunk's wall time in [target, 2*target], so the
# worst-case control latency is about pipeline depth x 2*target (3 x 0.5 s
# by default), inside the 2 s ticker cadence and the reference's 5 s
# first-event bound. GOL_CHUNK_TARGET (seconds) and GOL_MAX_CHUNK (turns)
# override them.
CHUNK_TARGET_SECONDS = 0.25
CHUNK_TARGET_ENV = "GOL_CHUNK_TARGET"
MAX_CHUNK = 1 << 21
MAX_CHUNK_ENV = "GOL_MAX_CHUNK"
# Chunks in flight; depth + 1 boards must fit half the device's memory
# (or PIPELINE_BOARD_BUDGET where it reports none); GOL_PIPELINE_BUDGET
# (bytes, > 0) replaces that half. GOL_PIPELINE_DEPTH=1 synchronises
# every chunk.
PIPELINE_DEPTH = 3
PIPELINE_DEPTH_ENV = "GOL_PIPELINE_DEPTH"
PIPELINE_BUDGET_ENV = "GOL_PIPELINE_BUDGET"
PIPELINE_BOARD_BUDGET = 8 << 30

# Legacy single-file autosave under GOL_CKPT, every GOL_CKPT_EVERY
# seconds (the manifest cadence is GOL_CKPT_EVERY_TURNS, `ckpt/`).
CKPT_EVERY_ENV = "GOL_CKPT_EVERY"
CKPT_EVERY_DEFAULT = 30.0

# GOL_TRACE=<dir>: one torch.profiler Chrome trace of a representative
# chunk per run (the second; the first when it is the whole run) — the
# counterpart of the reference's runtime/trace artifact.
TRACE_ENV = "GOL_TRACE"

# The chunk loop's metric families move at most this often (batched, as
# in the JAX engine), and the gol_dev_* memory gauges every
# DEVPOLL_SECONDS.
METRICS_FLUSH_SECONDS = 0.5
DEVPOLL_SECONDS = 2.0

# The JAX package's storage dtype of the packed reprs, for step
# signatures that read the same in both packages.
_SIGNATURE_DTYPE = {"packed": "uint32", "gen3": "uint32"}


class EngineKilled(RuntimeError):
    """Raised on any call after kill_prog."""


class EngineBusy(RuntimeError):
    """A run was submitted while the engine is already running a board."""


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another. A CUDA
    request without a CUDA device raises; nothing falls back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            from gol_tpu_torch.ops.cuda_stencil import cuda_probe

            raise RuntimeError(
                f"gol_tpu_torch runs on a CUDA device and found none "
                f"({cuda_probe()}); pass device='cpu' (Engine(device="
                f"'cpu'), or --device cpu on the CLI) to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def view_factor(h: int, w: int, max_cells: int) -> int:
    """Smallest integer downsample factor f with
    ceil(h/f) * ceil(w/f) <= max_cells."""
    f = max(1, int(np.ceil(np.sqrt(h * w / max_cells))))
    while -(-h // f) * -(-w // f) > max_cells:
        f += 1
    return f


def _block_max(px: torch.Tensor, fy: int, fx: int) -> torch.Tensor:
    """(H, W) -> (ceil(H/fy), ceil(W/fx)): the largest value of each
    fy x fx block (the board is zero-padded up to whole blocks)."""
    h, w = px.shape
    hp, wp = -(-h // fy) * fy, -(-w // fx) * fx
    px = torch.nn.functional.pad(px, (0, wp - w, 0, hp - h))
    return px.reshape(hp // fy, fy, wp // fx, fx).amax(dim=(1, 3))


def _or_rows(words: torch.Tensor, f: int) -> torch.Tensor:
    """(H, Wp) words -> (ceil(H/f), Wp): bitwise OR over each f-row band
    (a max would lose bits)."""
    h, wp = words.shape
    hp = -(-h // f) * f
    rows = torch.nn.functional.pad(words, (0, 0, 0, hp - h))
    rows = rows.reshape(hp // f, f, wp)
    band = rows[:, 0]
    for i in range(1, f):
        band = band | rows[:, i]
    return band


# Reprs whose run functions count the chunk's result in its last
# stepping launch (`count=`).
COUNTED_REPRS = ("packed", "gen3")

# The chunk loop's cumulative host accounting, in `stats()` order
# (issue_s, token_wait_s, host_s, chunks), flushed with the batched
# telemetry.
_HOST_FAMILIES = (obs.ENGINE_ISSUE_SECONDS_TOTAL,
                  obs.ENGINE_TOKEN_WAIT_SECONDS_TOTAL,
                  obs.ENGINE_HOST_SECONDS_TOTAL,
                  obs.ENGINE_COUNTED_CHUNKS_TOTAL)


def _firing_row_counts(cells: torch.Tensor, repr_: str) -> torch.Tensor:
    """(H,) int32 per-row counts of the firing population, per repr:
    K3 popcounts for `packed` and for `gen3`'s alive plane (a board no
    chunk just counted: a restore), state == 1 for `gen8`, cells above
    `ALIVE_THRESHOLD` for `f32`, sums for {0,1} `u8`."""
    if repr_ == "packed":
        return row_popcounts(cells)
    if repr_ == "gen3":
        return row_popcounts(cells[0])
    if repr_ == "gen8":
        return (cells == 1).sum(dim=-1, dtype=torch.int32)
    if repr_ == "f32":
        return (cells > ALIVE_THRESHOLD).sum(dim=-1, dtype=torch.int32)
    return row_alive_counts(cells)


def _board_width(cells: torch.Tensor, repr_: str) -> int:
    """Width in cells (the packed reprs hold 32 cells per word)."""
    w = cells.shape[-1]
    return w * WORD_BITS if repr_ in ("packed", "gen3") else w


def _next_chunk(chunk: int, remaining: int) -> int:
    """Largest power of two <= min(chunk, remaining)."""
    k = chunk
    while k > remaining:
        k //= 2
    return max(k, 1)


class ControlFlagProtocol:
    """The reference control-flag protocol and liveness surface, and the
    device helpers both engines share. Subclasses provide `_flags`
    (queue.Queue), `_killed`, `_abort` (threading.Event), `_state_lock`,
    `_running`, `_run_token`, `_turn` and `_device`."""

    def _on_device(self):
        """The engine's device as the current one: handler threads of the
        server are not the thread that made the engine."""
        if self._device.type == "cuda":
            return torch.cuda.device(self._device)
        return contextlib.nullcontext()

    def _current_stream(self):
        """The engine device's current stream on the calling thread, the
        one a snapshot's board is copied on (None on the CPU)."""
        if self._device.type != "cuda":
            return None
        return torch.cuda.current_stream(self._device)

    def _ckpt_writer(self, directory: str):
        return ckpt_mod.CheckpointWriter(
            directory, run_id=obs_flight.RUN_ID,
            keep_last=env_int(ckpt_mod.CKPT_KEEP_ENV,
                              ckpt_mod.CKPT_KEEP_DEFAULT),
            keep_every=env_int(ckpt_mod.CKPT_KEEP_EVERY_ENV, 0, minimum=0))

    def cf_put(self, flag: int) -> None:
        """Post a control flag (ref `Server:54-60`)."""
        self._check_alive()
        if flag not in (FLAG_PAUSE, FLAG_QUIT, FLAG_KILL):
            raise ValueError(f"unknown control flag {flag}")
        self._flags.put(flag)

    def drain_flags(self, pause_only: bool = False) -> None:
        """Discard stale control flags left by a previous controller on a
        parked engine; a no-op while a run is in flight. `pause_only`
        drops only FLAG_PAUSE entries and keeps the rest in order."""
        self._check_alive()
        with self._state_lock:
            if self._running:
                return
            kept = []
            try:
                while True:
                    flag = self._flags.get_nowait()
                    if pause_only and flag != FLAG_PAUSE:
                        kept.append(flag)
            except queue.Empty:
                pass
            for flag in kept:
                self._flags.put(flag)

    def kill_prog(self) -> None:
        """Mark the engine dead (ref `Server:77-80`)."""
        self._killed = True

    def abort_run(self, token: Optional[str] = None) -> bool:
        """Stop the current run iff `token` matches its owner's; a
        tokenless run cannot be aborted. The state is kept at the stop
        point, as on FLAG_QUIT."""
        self._check_alive()
        with self._state_lock:
            if (token is not None and self._running
                    and self._run_token == token):
                self._abort.set()
                return True
            return False

    def ping(self) -> int:
        """Liveness probe: the completed turn, with no device work."""
        self._check_alive()
        with self._state_lock:
            return self._turn

    def _check_alive(self) -> None:
        if self._killed:
            raise EngineKilled("engine has been killed")

    def _handle_flags(self) -> bool:
        """Drain flags; block while paused. Returns True to quit the run
        (reference handshake `Server/gol/distributor.go:136-164`)."""
        paused = False
        while True:
            if self._killed or self._abort.is_set():
                return True
            try:
                flag = self._flags.get_nowait() if not paused \
                    else self._flags.get(timeout=0.05)
            except queue.Empty:
                if not paused:
                    return False
                continue
            if flag == FLAG_PAUSE:
                paused = not paused
                if not paused:
                    return False
            elif flag in (FLAG_QUIT, FLAG_KILL):
                # Both end the run and hand the board back; the engine
                # dies only when the controller calls kill_prog.
                return True


class Engine(SingleRunSurface, ControlFlagProtocol):
    """Holds (board, turn) across runs — the detach/resume contract
    (reference broker globals `world`/`turn`, and `CONT=yes`)."""

    def __init__(self, device=None, rule=CONWAY, devices=None,
                 mesh_shape: Optional[Tuple[int, int]] = None) -> None:
        """`devices`: the devices runs shard over (by default the distinct
        visible CUDA devices, or `[device]` when `device` is given).
        `mesh_shape=(rows, cols)` asks for the 2-D mesh instead of row
        sharding, as GOL_MESH="RxC" does; a request the board or the
        devices cannot serve falls back to 1-D with a warning."""
        if devices is not None:
            self._devices = [resolve_device(d) for d in devices]
        elif device is not None:
            self._devices = [resolve_device(device)]
        else:
            self._devices = default_devices()
        self._device = self._devices[0]
        # A LifeLikeRule, GenerationsRule, LargerThanLifeRule or LeniaRule.
        self._rule = rule
        if mesh_shape is None:
            spec = os.environ.get("GOL_MESH", "").lower()
            if "x" in spec:
                try:
                    r, c = spec.split("x", 1)
                    mesh_shape = (int(r), int(c))
                    if mesh_shape[0] <= 0 or mesh_shape[1] <= 0:
                        raise ValueError("non-positive mesh dims")
                except ValueError:
                    warnings.warn(
                        f"GOL_MESH={spec!r} is not 'RxC'; "
                        "falling back to 1-D row sharding")
                    mesh_shape = None
        self._mesh_shape = mesh_shape
        # The last submitted run's mesh, its geometry (Stats, /healthz,
        # the run report) and the wrap-extension rows its board carries
        # below row H (the exact-N path; 0 otherwise).
        self._mesh = make_mesh(1, self._devices)
        self._mesh_geom: Optional[dict] = None
        self._pad_rows = 0
        self._state_lock = threading.Lock()
        # "packed": int32 words (H, W/32); "u8": {0,1} uint8 (H, W);
        # "gen3": stacked int32 (alive, dying) planes (2, H, W/32);
        # "gen8": uint8 states (H, W); "f32": float32 Lenia state (H, W).
        self._cells: Optional[torch.Tensor] = None
        self._repr = "u8"
        self._turn = 0
        # (alive, turn) published at submit and at every chunk pop.
        self._alive_pub: Optional[Tuple[int, int]] = None
        self._flags: "queue.Queue[int]" = queue.Queue()
        self._killed = False
        self._running = False
        self._run_token: Optional[str] = None
        self._abort = threading.Event()
        # Chunk adapter state: the smallest elapsed ever seen for a full
        # chunk (the fixed cost of a dispatch), and a sliding window of
        # (pop time, turns) for the pipelined regime.
        self._fixed_cost_est = float("inf")
        self._pace_window: deque = deque(maxlen=8)
        self._pace_skip = 0
        self._max_chunk = MAX_CHUNK
        self._chunk_target = CHUNK_TARGET_SECONDS
        self._last_chunk = 0
        self._turns_per_s = 0.0
        # Cumulative host accounting of the chunk loop (`_run_loop`); a
        # run's chunk_overhead_us is its share of host_s over chunks.
        self._issue_s = self._token_wait_s = self._host_s = 0.0
        self._counted_chunks = 0
        self._chunk_overhead_us = 0.0
        # (shape, repr, mesh shape, fuse, k) of every chunk this engine
        # has issued: the first issue of one builds and sets up its
        # kernels (the JAX engine's compile), a stall kept out of
        # chunk_overhead_us.
        self._issued: set = set()
        # Converged chunk per (board shape, repr, target): later runs of
        # the same configuration start there.
        self._chunk_hints: dict = {}
        # Temporal-fusion depth of the last submitted run: checkpoint
        # manifests stamp it (`fuse`) when above 1.
        self._fuse_eff = 1
        # Broadcast publish hook (`broadcast.py`): called once per issued
        # chunk, no arguments, cheap and never raising (the hub installs
        # threading.Event.set). None = no broadcast tier attached.
        self._bcast_notify = None

    @property
    def device(self) -> torch.device:
        return self._device

    # ------------------------------------------------------------------ RPC

    def server_distributor(
        self,
        params: Params,
        world: np.ndarray,
        sub_workers: Sequence[str] = (),
        start_turn: int = 0,
        token: Optional[str] = None,
    ) -> Tuple[np.ndarray, int]:
        """Blocking run: evolve the (H, W) pixel board `world` for
        `params.turns` turns, honouring control flags between chunks.
        Life-like and Larger-than-Life: any nonzero pixel is alive;
        returns ({0,255} board, completed turn). Generations: pixels are
        the rule's gray levels (`gray_levels`); returns the gray board.
        Lenia: a float32 world is the state (clipped to [0, 1]), a uint8
        one is pixels / 255; returns the quantized pixels. `gol_tpu`'s
        `Engine.get_world()` result carries over as is for all.
        `sub_workers` mirrors the reference's worker-address list: its
        length is the requested shard count (else `params.threads`),
        clamped to the engine's devices."""
        self._check_alive()
        if self._running:
            raise EngineBusy("engine already running a board")
        height, width = world.shape
        # Temporal fusion (GOL_FUSE_K): the pinned depth is resolved once
        # per submit: packed boards take the run function of that depth,
        # gen3 planes keep their native dispatcher (their fused run, as on
        # the TPU). fuse_eff is the depth the run applies: 1 for u8 and
        # gen8 boards, which have no fused tier.
        fuse = configured_fuse_k()
        fuse_eff = 1
        # The shard count: the worker list's length (SUB), else the
        # threads hint, clamped to the devices.
        requested = len(sub_workers) if sub_workers else params.threads
        requested = max(1, min(requested, len(self._devices)))
        pad_rows = 0
        mesh = make_mesh(1, self._devices)
        if isinstance(self._rule, (LargerThanLifeRule, LeniaRule)):
            # Conv/FFT families: one device, no halo; the tier policy
            # picks direct-space conv (K7 for a Moore box) or the FFT.
            # LtL stays u8 at every width: this branch comes before the
            # packing choice.
            if self._mesh_shape is not None:
                warnings.warn(
                    f"2-D mesh request {self._mesh_shape} ignored (the "
                    f"conv/FFT kernel tier runs single-shard)")
            if requested > 1:
                warnings.warn(
                    f"{requested} shards requested for rule "
                    f"{self._rule.rulestring}; the conv/FFT kernel tier "
                    f"has no halo machinery — running single-shard")
            lenia = isinstance(self._rule, LeniaRule)
            if lenia:
                repr_ = "f32"
                if world.dtype == np.float32:
                    state = np.clip(np.ascontiguousarray(world), 0.0, 1.0)
                else:
                    # u8 pixel ingest (the wire's universal codec).
                    state = (np.asarray(world, dtype=np.float32)
                             / np.float32(255.0))
                alive0 = int((state > ALIVE_THRESHOLD).sum())
            else:
                repr_ = "u8"
                alive0 = int(np.count_nonzero(np.asarray(world)))
                state = (np.asarray(world) != 0).astype(np.uint8)
            cells = torch.from_numpy(state).to(self._device)
            tier = conv_ops.select_tier(
                height, width, self._rule.radius,
                "float32" if lenia else "uint8", allowed=("conv", "fft"),
                kind=getattr(self._rule, "kind", "shell"))
            run = (conv_ops.lenia_run_fn if lenia
                   else conv_ops.ltl_run_fn)(tier)
            conv_ops.note_dispatch(tier)
        elif isinstance(self._rule, GenerationsRule):
            # Row shards only: the 2-D path is life-like and packed.
            self._resolve_mesh2d(height, width, False, generations=True)
            state = from_pixels_gen(world, self._rule)
            alive0 = int(np.count_nonzero(state == 1))
            repr_, run = select_generations_representation(
                width, self._rule)
            pad_rows = exact_shard_ext(height, requested)
            mesh = make_mesh(requested, self._devices)
            if repr_ == "gen3":
                if requested == 1:
                    cells = pack_state3(state, self._device)
                    fuse_eff = max(fuse, 1)
                else:
                    planes = np.stack([pack_np(state == 1),
                                       pack_np(state == 2)])
                    if pad_rows:
                        planes = extend_rows(planes, pad_rows, axis=1)
                    cells = shard(words_from_numpy(planes), mesh)
            elif requested == 1:
                cells = torch.from_numpy(state).to(self._device)
            else:
                if pad_rows:
                    state = extend_rows(state, pad_rows)
                cells = shard(torch.from_numpy(state), mesh)
            if requested > 1:
                # Multi-shard gen3 keeps the per-turn alive-plane
                # exchange, as in the JAX package: fuse_eff stays 1.
                run = mesh_run_fn(repr_, height=height, ext=pad_rows)
        else:
            packed, run = select_representation(width)
            repr_ = "packed" if packed else "u8"
            alive0 = int(np.count_nonzero(world))
            base = (pack_np(world) if packed
                    else (np.asarray(world) != 0).astype(np.uint8))
            host = words_from_numpy if packed else torch.from_numpy
            mesh2d = self._resolve_mesh2d(height, width, packed)
            if mesh2d is not None:
                from gol_tpu_torch.parallel.mesh2d import mesh2d_run_fn

                mesh = mesh2d
                cells = shard(host(base), mesh)
                run = mesh2d_run_fn(fuse)
                fuse_eff = max(fuse, 1)
            else:
                pad_rows = exact_shard_ext(height, requested)
                mesh = make_mesh(requested, self._devices)
                if requested == 1:
                    cells = host(base).to(self._device)
                    if packed and fuse > 1:
                        run, fuse_eff = fused_run_fn(fuse), fuse
                elif pad_rows:
                    # The exact shard count on a height it does not
                    # divide: the wrap extension (fuse_eff stays 1).
                    cells = shard(host(extend_rows(base, pad_rows)), mesh)
                    run = mesh_run_fn(repr_, height=height, ext=pad_rows)
                else:
                    cells = shard(host(base), mesh)
                    run = mesh_run_fn(repr_, fuse=fuse)
                    if packed and fuse > 1:
                        fuse_eff = fuse
        with self._state_lock:
            if self._running:
                raise EngineBusy("engine already running a board")
            self._cells = cells
            self._repr = repr_
            self._pad_rows = pad_rows
            self._mesh = mesh
            self._mesh_geom = mesh_geometry(mesh)
            self._turn = start_turn
            self._alive_pub = (alive0, start_turn)
            self._running = True
            self._run_token = token
            self._abort.clear()
            self._fuse_eff = fuse_eff
        obs_devstats.note_signature(
            (repr_, tuple(cells.shape),
             _SIGNATURE_DTYPE.get(repr_,
                                  str(cells.dtype).replace("torch.", "")),
             tuple(mesh.devices.shape), self._rule.rulestring, fuse_eff))
        obs_devstats.note_mesh(self._mesh_geom)
        obs_devstats.note_fuse(fuse_eff)
        with self._on_device():
            return self._run_loop(params, cells, run, start_turn, fuse_eff)

    def _chunk(self, run, cells, k: int):
        """Issue one chunk and its alive token; returns (cells, host
        count, events): the count is one int64, or one a shard, which the
        pop adds. On the CPU the count is ready and there are no events."""
        if isinstance(cells, ShardedBoard):
            return self._sharded_chunk(run, cells, k)
        if self._repr in COUNTED_REPRS:
            total = torch.empty(1, dtype=torch.int64, device=cells.device)
            out = run(cells, k, self._rule, count=total)
        else:
            out = run(cells, k, self._rule)
            total = _firing_row_counts(out, self._repr).sum(
                dtype=torch.int64)
        if self._device.type != "cuda":
            return out, total, ()
        host = torch.empty(total.shape, dtype=torch.int64, pin_memory=True)
        host.copy_(total, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return out, host, (event,)

    def _sharded_chunk(self, run, cells: ShardedBoard, k: int):
        """`_chunk` of a sharded board: each shard's last stepping launch
        counts its own rows into an int64 on its device (packed, gen3);
        the other reprs count their shards' rows with torch, the pad
        rows of the exact-N path left out. Each count is copied without
        blocking into one pinned host buffer, an event a device after."""
        if self._repr in COUNTED_REPRS:
            counts = [None if s is None else
                      torch.empty(1, dtype=torch.int64, device=s.device)
                      for s in cells.shards]
            out = run(cells, k, self._rule, count=counts)
        else:
            out = run(cells, k, self._rule)
            height = out.shape[-2] - self._pad_rows
            counts = []
            for pos, s in enumerate(out.shards):
                rows = s.shape[-2]
                keep = max(0, min(rows, height - pos * rows))
                counts.append(_firing_row_counts(s, self._repr)[:keep].sum(
                    dtype=torch.int64).reshape(1))
        if self._device.type != "cuda":
            return out, torch.cat(counts), ()
        host = torch.empty(len(counts), dtype=torch.int64, pin_memory=True)
        events = {}
        for i, c in enumerate(counts):
            with torch.cuda.device(c.device):
                host[i:i + 1].copy_(c, non_blocking=True)
                events[c.device] = torch.cuda.Event()
                events[c.device].record()
        return out, host, tuple(events.values())

    def _pipeline_depth(self, cells) -> int:
        budget = (env_int(PIPELINE_BUDGET_ENV, 0, minimum=0)
                  or half_device_memory(PIPELINE_BOARD_BUDGET, self._device))
        # The budget is per device: a sharded board's busiest device.
        nbytes = (cells.device_bytes() if isinstance(cells, ShardedBoard)
                  else cells.numel() * cells.element_size())
        return max(1, min(env_int(PIPELINE_DEPTH_ENV, PIPELINE_DEPTH), 8,
                          budget // max(nbytes, 1) - 1))

    def _run_loop(self, params: Params, cells: torch.Tensor, run,
                  start_turn: int,
                  fuse_eff: int) -> Tuple[np.ndarray, int]:
        t_entry = time.monotonic()
        target = start_turn + params.turns
        self._max_chunk = env_int(MAX_CHUNK_ENV, MAX_CHUNK)
        # `or`: a zero target would pin the chunk at one turn.
        self._chunk_target = (
            env_float(CHUNK_TARGET_ENV, CHUNK_TARGET_SECONDS)
            or CHUNK_TARGET_SECONDS)
        mesh = self._mesh
        hint_key = (tuple(cells.shape), self._repr,
                    tuple(mesh.devices.shape), self._chunk_target, fuse_eff)
        chunk = 1
        hinted = min(self._chunk_hints.get(hint_key, 1), self._max_chunk)
        while chunk * 2 <= hinted:
            chunk *= 2
        depth = self._pipeline_depth(cells)
        # The pipeline stays at depth 1 while the chunk size ramps, so
        # the adapter sees each measurement at once; it opens to full
        # depth when the adapter stops growing the chunk.
        ramping = True
        self._pace_window = deque(maxlen=depth + 5)
        self._pace_skip = 0
        inflight: deque = deque()
        last_pop = time.monotonic()
        quit_run = False
        stepped = False
        repr_ = self._repr
        pad_rows = self._pad_rows
        height = cells.shape[-2] - pad_rows
        width = _board_width(cells, repr_)

        # Telemetry, all at chunk boundaries on this host thread: the run
        # report (GOL_RUN_REPORT / --run-report), the chunk-loop metric
        # families (batched, flushed every METRICS_FLUSH_SECONDS), the
        # gol_dev_* memory gauges, and profiler captures: a Profile
        # request (RPC, POST /profile, GOL_PROFILE_DIR) or the GOL_TRACE
        # chunk. A captured chunk runs alone and synchronously, and its
        # profiler-skewed timing stays out of the adapter, the pace and
        # the CUPS aggregates (a traced chunk, as in the JAX engine).
        reporter = obs_timeline.from_env()
        run_t0 = time.monotonic()
        board_cells = height * width
        if reporter is not None:
            geom = self._mesh_geom
            reporter.emit(
                "run_start", w=width, h=height,
                model=self._rule.rulestring, repr=repr_,
                devices=int(mesh.size), shards=geom["shards"],
                mesh_shape=geom["shape"], mesh_axes=geom["axes"],
                turns_requested=params.turns,
                start_turn=start_turn, fuse_k=fuse_eff)
        obs.ENGINE_CHUNK_SIZE.set(chunk)
        obs_prof.arm_from_env()
        obs_devstats.poll_device_memory()
        last_devpoll = time.monotonic()
        trace_dir = os.environ.get(TRACE_ENV, "")
        capture = None  # the running profiler capture, if any
        capture_to = 0  # ... and the turn it ends at
        chunks_done = traced_chunks = 0
        pend_chunks = pend_turns = 0
        pend_elapsed: list = []
        flag_pending = 0.0
        last_rate = 0.0
        last_done_turn = start_turn
        last_flush = time.monotonic()
        # Host overhead (the JAX engine's accounting), summed over the
        # counted iterations (a capture's are not) into the engine's
        # cumulative `stats()` counters: `host_s`, each iteration's wall
        # less the wait for the counted token and the excluded stalls
        # (first issue of a shape, pause, synchronous checkpoint);
        # `token_wait_s`, that wait; `issue_s`, the issue of chunks other
        # than a shape's first; `chunks`. On the CPU the chunk's steps run
        # inside its issue, which therefore stands for the token wait and
        # adds to `token_wait_s`, not `issue_s`. `chunk_overhead_us` is
        # this run's host_s over its chunks.
        wait_accum = 0.0
        host0, chunks0 = self._host_s, self._counted_chunks
        flushed = [self._issue_s, self._token_wait_s, self._host_s,
                   self._counted_chunks]
        # Spans: `engine.setup` (entry to the first issue) and
        # `engine.ramp` (first issue to the pop that ends the ramp)
        # always, once a run; per-chunk spans (`engine.chunk`, `.issue`,
        # `.wait`, `.publish`, `.advance`, `.flags`) only while the gate
        # is open: its
        # configured half read here, the profiler's once a chunk. They
        # reuse the loop's stamps; an open gate adds one, the pop's end.
        hot_env = obs_trace.hot_spans_from_env()
        hot = False
        first_issue = None  # (stamp, seconds) of the run's first issue
        pop_end = advance_from = None
        ramp_chunks = 0
        ramp_recorded = False
        capture_span = None
        # Halo accounting of a sharded run: (turns, wall) a popped chunk,
        # drained at the flush through the analytic traffic model. The
        # wrap-extension path is not modelled (`halo_traffic`).
        pend_halo: list = []
        halo_traffic_fn = None
        if pad_rows == 0 and mesh.size > 1:
            halo_traffic_fn = functools.partial(
                halo_traffic, repr_, tuple(cells.shape), mesh,
                fuse=fuse_eff)

        def _flush_metrics(now: float) -> None:
            """Drain the batched chunk-loop telemetry into the registry."""
            nonlocal pend_chunks, pend_turns, last_flush
            if pend_chunks:
                if fuse_eff > 1:
                    obs.FUSED_DISPATCHES.labels(tier="engine").inc(
                        pend_chunks)
                obs.ENGINE_CHUNKS_TOTAL.inc(pend_chunks)
                obs.ENGINE_TURNS_TOTAL.inc(pend_turns)
                obs.ENGINE_CHUNK_SECONDS.observe_batch(pend_elapsed)
                pend_elapsed.clear()
                pend_chunks = pend_turns = 0
            if pend_halo:
                obs_halostats.flush_chunk_walls(pend_halo, halo_traffic_fn)
                pend_halo.clear()
            obs.ENGINE_TURN.set(last_done_turn)
            obs.ENGINE_CHUNK_SIZE.set(chunk)
            if last_rate > 0:
                obs.ENGINE_CUPS.set(last_rate * board_cells)
                obs.ENGINE_TURNS_PER_S.set(last_rate)
            counted = (self._issue_s, self._token_wait_s, self._host_s,
                       self._counted_chunks)
            for family, value, done in zip(_HOST_FAMILIES, counted,
                                           flushed):
                if value > done:
                    family.inc(value - done)
            flushed[:] = counted
            if self._counted_chunks > chunks0:
                self._chunk_overhead_us = (
                    (self._host_s - host0)
                    / (self._counted_chunks - chunks0) * 1e6)
                obs.ENGINE_CHUNK_OVERHEAD_US.set(self._chunk_overhead_us)
            last_flush = now

        # GOL_CKPT: the legacy WxH.npz autosave every GOL_CKPT_EVERY
        # seconds, and with GOL_CKPT_EVERY_TURNS manifest checkpoints at
        # exact turn multiples, written by a background writer.
        ckpt_dir = os.environ.get(ckpt_mod.CKPT_DIR_ENV, "")
        ckpt_every = env_float(CKPT_EVERY_ENV, CKPT_EVERY_DEFAULT)
        ckpt_path = ""
        ckpt_writer = None
        next_ckpt_turn = None
        ckpt_every_turns = 0
        if ckpt_dir:
            os.makedirs(ckpt_dir, exist_ok=True)
            ckpt_path = os.path.join(ckpt_dir, f"{width}x{height}.npz")
            ckpt_every_turns = env_int(ckpt_mod.CKPT_EVERY_TURNS_ENV, 0,
                                       minimum=0)
            if ckpt_every_turns > 0:
                ckpt_writer = self._ckpt_writer(ckpt_dir)
                next_ckpt_turn = (
                    start_turn // ckpt_every_turns + 1) * ckpt_every_turns
        last_ckpt = time.monotonic()
        # GOL_JOURNAL: the run's hash-chained black box — create now,
        # digests at exact cadence turns (at pop time), end after the
        # checkpoint writer drains.
        journal_writer = None
        next_digest_turn = None
        digest_every_turns = 0
        if journal_mod.enabled():
            journal_writer = journal_mod.for_run(obs_flight.RUN_ID)
        if journal_writer is not None:
            digest_every_turns = journal_mod.digest_every()
            if digest_every_turns > 0:
                next_digest_turn = (
                    start_turn // digest_every_turns + 1
                ) * digest_every_turns
            try:
                self._journal_create(journal_writer,
                                     self._whole(cells, pad_rows),
                                     start_turn, fuse_eff)
            except Exception:  # journaling must never sink a run
                journal_writer = None
                next_digest_turn = None
        # Digests copy a completed chunk's board on a stream of their
        # own, so the copy does not queue behind the chunks in flight.
        digest_stream = (torch.cuda.Stream(self._device)
                         if journal_writer is not None
                         and self._device.type == "cuda" else None)

        def _ckpt_submit(snap_cells: torch.Tensor, trigger: str) -> None:
            """Queue a checkpoint of `snap_cells` at self._turn on the
            background writer: a pointer hand-off; the writer copies the
            board on this stream, behind the chunk that produced it."""
            ckpt_writer.submit(ckpt_mod.Snapshot(
                self._whole(snap_cells, pad_rows), repr_, self._turn,
                (height, width), self._rule.rulestring, trigger=trigger,
                mesh={"devices": len(self._devices)}, fuse=fuse_eff,
                stream=self._current_stream()))

        def _reset_pace(at: float) -> None:
            """Keep a host stall (a pause, a legacy autosave, a capture)
            out of pace measurements; the chunks that completed during it
            drain as a burst, so skip the next `depth` pops."""
            nonlocal last_pop
            last_pop = at
            self._pace_window.clear()
            self._pace_skip = depth

        def _pop_oldest() -> None:
            """Wait for the oldest chunk's token, publish its exact
            (alive, turn) pair and feed the chunk adapter and the
            telemetry; journal its board's digest when its turn is a
            digest turn."""
            nonlocal chunk, last_pop, ramping, traced_chunks, pend_chunks
            nonlocal pend_turns, flag_pending, last_rate, last_done_turn
            nonlocal last_devpoll, wait_accum, ramp_chunks, pop_end
            (done_cells, host, events, done_k, done_turn, issue_s,
             traced, done_span) = inflight.popleft()
            t_wait = time.monotonic()
            for event in events:
                event.synchronize()
            done_alive = int(host.sum())
            now = time.monotonic()
            wait_accum += now - t_wait
            elapsed = now - last_pop
            last_pop = now
            rate = 0.0
            if traced:
                traced_chunks += 1
                obs.ENGINE_TRACED_CHUNKS_TOTAL.inc()
                obs.ENGINE_TURNS_TOTAL.inc(done_k)
                if reporter is not None:
                    reporter.emit("traced_chunk", turn=done_turn,
                                  turns=done_k)
            elif ramping or depth == 1:
                new_chunk = self._adapt_chunk(chunk, done_k, elapsed)
                if ramping:
                    ramp_chunks += 1
                    if done_k == chunk and new_chunk == chunk:
                        ramping = False
                        _record_ramp(now, done_turn, new_chunk, True)
                chunk = new_chunk
                rate = done_k / elapsed if elapsed > 0 else 0.0
            else:
                chunk = self._adapt_chunk_windowed(chunk, now, done_k)
                rate = self._pace_rate() or 0.0
            with self._state_lock:
                self._last_chunk = done_k
                if rate > 0:
                    self._turns_per_s = rate
                self._alive_pub = (done_alive, done_turn)
            last_done_turn = done_turn
            if not traced:
                pend_chunks += 1
                pend_turns += done_k
                pend_elapsed.append(elapsed)
                if halo_traffic_fn is not None:
                    pend_halo.append((done_k, elapsed))
                if rate > 0:
                    last_rate = rate
                if reporter is not None:
                    reporter.emit(
                        "chunk", turn=done_turn, turns=done_k,
                        chunk_size=chunk, wall_s=round(elapsed, 6),
                        cups=rate * board_cells, turns_per_s=rate,
                        token_wait_s=round(now - t_wait, 6),
                        dispatch_s=round(issue_s, 6),
                        flag_s=round(flag_pending, 6), alive=done_alive)
                    flag_pending = 0.0
            if (journal_writer is not None and digest_every_turns > 0
                    and done_turn > start_turn
                    and done_turn % digest_every_turns == 0):
                # Every digest turn is a chunk boundary (k_cap below).
                # The chunk is complete, so its copy drains nothing.
                try:
                    journal_writer.digest(
                        done_turn, journal_mod.board_digest(
                            device_to_host(self._whole(done_cells, pad_rows),
                                           digest_stream),
                            repr_), repr_=repr_)
                except Exception:
                    # A failed digest must never sink the run; the
                    # journal sink latches itself dead on OSError.
                    pass
            if now - last_devpoll >= DEVPOLL_SECONDS:
                obs_devstats.poll_device_memory()
                last_devpoll = now
            if now - last_flush >= METRICS_FLUSH_SECONDS:
                _flush_metrics(now)
            # The wait: the token's synchronize and the count's sum; the
            # publish: the adapter, the state lock, the telemetry, the
            # digest and the memory poll. The chunk's span, open since
            # its issue, closes with them.
            end = now
            if hot:
                end = pop_end = time.monotonic()
                parent = done_span if done_span is not None else run_span
                obs_trace.TRACER.record("engine.wait", t_wait, now, parent,
                                        {"turn": done_turn})
                obs_trace.TRACER.record("engine.publish", now, end, parent,
                                        {"turn": done_turn, "chunk": chunk})
            if done_span is not None:
                done_span.attrs["alive"] = done_alive
                obs_trace.finish(done_span, end=end)

        def _record_ramp(end: float, done_turn: int, size: int,
                         settled: bool) -> None:
            """`engine.ramp`: from the first issue to the pop that ended
            the ramp (`settled`), or to the run's end."""
            nonlocal ramp_recorded
            ramp_recorded = True
            t0, first_s = first_issue
            attrs = {"chunks": ramp_chunks, "turns": done_turn - start_turn,
                     "chunk": size, "first_issue_s": round(first_s, 6),
                     "settled": settled}
            record = (_build.built_record()
                      if self._device.type == "cuda" else None)
            if record is not None:
                attrs["library_cached"] = record["cached"]
                attrs["library_build_s"] = round(record["seconds"], 6)
            obs_trace.TRACER.record("engine.ramp", t0, end, run_span, attrs)

        def _end_capture(error: Optional[BaseException] = None) -> None:
            """Close the capture's span, then stop its profiler: the
            trace file it writes holds the span."""
            nonlocal capture, capture_span
            obs_trace.finish(capture_span, error=error)
            capture.finish(error)
            capture = capture_span = None

        # The run span parents under whatever is on this thread's context
        # stack: the server's ServerDistributor handler span for remote
        # runs, the controller's run span for in-process ones.
        run_span = obs_trace.start(
            "engine.run", attrs={"w": width, "h": height,
                                 "turns": params.turns,
                                 "start_turn": start_turn, "repr": repr_},
            start=t_entry)
        obs_trace.TRACER.push(run_span)
        try:
            while self._turn < target and not quit_run:
                if self._killed or self._abort.is_set():
                    break
                t_iter = time.monotonic()
                wait_accum = 0.0
                stall_excl = 0.0
                hot = hot_env or obs_trace.profiler_running()
                if capture is None:
                    preq = obs_prof.PROFILER.take()
                    if preq is not None:
                        # Drain, so the trace holds the requested turns
                        # alone; they run one chunk at a time.
                        while inflight:
                            _pop_oldest()
                        capture_to = min(self._turn + preq.turns, target)
                        capture_span = obs_trace.start(
                            "engine.profile",
                            attrs={"turns": capture_to - self._turn,
                                   "source": preq.source})
                        capture = obs_prof.PROFILER.begin(preq)
                        hot = True
                k_cap = target - self._turn
                if capture is not None:
                    k_cap = min(k_cap, capture_to - self._turn)
                # Land chunk boundaries exactly on checkpoint and digest
                # turns: those turns are a function of (start_turn,
                # cadence) alone, never of the adapter's chunk sizes, so
                # an interrupted and resumed run checkpoints the turns
                # of one that never stopped.
                if next_ckpt_turn is not None:
                    k_cap = min(k_cap, next_ckpt_turn - self._turn)
                if next_digest_turn is not None:
                    k_cap = min(k_cap, next_digest_turn - self._turn)
                k = _next_chunk(chunk, k_cap)
                if capture is None and trace_dir and (
                        chunks_done == 1
                        or (chunks_done == 0 and k == target - self._turn)):
                    # GOL_TRACE: the second chunk (the first is warm-up),
                    # or the first when it is the whole run.
                    while inflight:
                        _pop_oldest()
                    capture_span = obs_trace.start("engine.traced_chunk",
                                                   attrs={"k": k})
                    capture = obs_prof.Capture(trace_dir)
                    capture_to = self._turn + k
                    trace_dir = ""
                    hot = True
                # A captured chunk's profiler-skewed wall stays out of
                # the overhead, as a traced chunk's in the JAX engine.
                count_overhead = capture is None
                t_issue = time.monotonic()
                cells, host, events = self._chunk(run, cells, k)
                t_issued = time.monotonic()
                issue_s = t_issued - t_issue
                issued = (tuple(cells.shape), repr_,
                          tuple(mesh.devices.shape), fuse_eff, k)
                first = issued not in self._issued
                self._issued.add(issued)
                counted_issue = 0.0
                if self._device.type != "cuda":
                    wait_accum += issue_s
                elif first:
                    stall_excl += issue_s
                else:
                    counted_issue = issue_s
                if first_issue is None:
                    first_issue = (t_issue, issue_s)
                    obs_trace.TRACER.record("engine.setup", t_entry, t_issue,
                                            run_span)
                chunk_span = None
                if hot:
                    if advance_from is not None:
                        # The loop between the last chunk's pops and this
                        # issue: the turn's advance, the broadcast hook,
                        # the checkpoint, digest and flag checks, the
                        # overhead accounting, the spans' records and
                        # this chunk's size.
                        obs_trace.TRACER.record(
                            "engine.advance", advance_from, t_issue,
                            run_span, {"turn": self._turn})
                    attrs = {"k": k, "turn": self._turn + k}
                    chunk_span = obs_trace.start("engine.chunk", run_span,
                                                 attrs, t_issue)
                    obs_trace.TRACER.record("engine.issue", t_issue, t_issued,
                                            chunk_span, dict(attrs))
                inflight.append((cells, host, events, k, self._turn + k,
                                 issue_s, capture is not None, chunk_span))
                pop_end = None
                while len(inflight) >= (
                        1 if ramping or capture is not None else depth):
                    _pop_oldest()
                advance_from = None
                if hot:
                    advance_from = t_issued if pop_end is None else pop_end
                chunks_done += 1
                stepped = True
                with self._state_lock:
                    self._cells = cells
                    self._turn += k
                cb = self._bcast_notify
                if cb is not None:
                    cb()
                if capture is not None and self._turn >= capture_to:
                    _end_capture()
                    _reset_pace(time.monotonic())
                if (next_ckpt_turn is not None
                        and self._turn >= next_ckpt_turn):
                    _ckpt_submit(cells, "periodic")
                    next_ckpt_turn = (
                        self._turn // ckpt_every_turns + 1
                    ) * ckpt_every_turns
                if (next_digest_turn is not None
                        and self._turn >= next_digest_turn):
                    # Only the pointer advances here; the digest itself
                    # is taken when the chunk pops (_pop_oldest).
                    next_digest_turn = (
                        self._turn // digest_every_turns + 1
                    ) * digest_every_turns
                if ckpt_path and \
                        time.monotonic() - last_ckpt >= ckpt_every:
                    t_sync = time.monotonic()
                    self.save_checkpoint(ckpt_path)
                    last_ckpt = time.monotonic()
                    _reset_pace(last_ckpt)
                    stall_excl += last_ckpt - t_sync
                # Flags are honoured only while turns remain: a pause
                # landing with the final chunk must not park a finished
                # run. An empty queue with no kill/abort needs no call.
                if self._turn < target and (
                        self._flags.queue or self._killed
                        or self._abort.is_set()):
                    t_flags = time.monotonic()
                    quit_run = self._handle_flags()
                    t_served = time.monotonic()
                    flag_s = t_served - t_flags
                    if hot:
                        obs_trace.TRACER.record("engine.flags", t_flags,
                                                t_served, run_span)
                    flag_pending += flag_s
                    obs.ENGINE_FLAG_SERVICE_SECONDS.observe(flag_s)
                    if flag_s > 0.01:
                        # A pause (or a slow flag drain) stalled the host.
                        _reset_pace(time.monotonic())
                        stall_excl += flag_s
                if count_overhead:
                    self._host_s += max(
                        0.0, time.monotonic() - t_iter - wait_accum
                        - stall_excl)
                    self._token_wait_s += wait_accum
                    self._issue_s += counted_issue
                    self._counted_chunks += 1
            if ckpt_writer is not None and stepped:
                # Every loop exit — completion, quit, kill, abort —
                # leaves durable state at the final turn.
                _ckpt_submit(cells, "final")
        except Exception as e:
            if capture is not None:
                _end_capture(e)
            # The black box: an unhandled chunk-loop error dumps the
            # flight ring (recent spans and events, and the spans still
            # open: the run's, a capture's, and, while the per-chunk
            # spans are on, those of the chunks in flight) before the
            # error propagates.
            obs_flight.crash("engine.run_loop", e, turn=self._turn)
            if ckpt_writer is not None:
                # Emergency best-effort checkpoint: synchronous (there is
                # no later boundary to wait for) and never allowed to
                # mask the original error.
                try:
                    ckpt_writer.write_sync(
                        self._ckpt_snapshot("emergency"))
                except Exception:
                    pass
            raise
        finally:
            # Drain, so the last publication is the final state's exact
            # pair (the turn only advances once a chunk is issued).
            try:
                while inflight:
                    _pop_oldest()
            finally:
                # A pop that raised leaves its chunks' spans open.
                for item in inflight:
                    if item[-1] is not None:
                        obs_trace.finish(item[-1])
            if first_issue is not None and not ramp_recorded:
                # The run ended while the chunk still ramped.
                _record_ramp(time.monotonic(), last_done_turn, chunk, False)
            if capture is not None:
                # The run ended (quit, kill, abort) before the capture's
                # last turn: what was stepped is in the trace.
                _end_capture()
            with self._state_lock:
                final_cells, final_turn = self._cells, self._turn
                final_repr, final_pad = self._repr, self._pad_rows
                self._chunk_hints[hint_key] = chunk
                self._running = False
                self._run_token = None
                self._abort.clear()
            if ckpt_writer is not None:
                # Bounded drain: a wedged disk must not park the engine
                # forever (the daemon thread finishes or dies with the
                # process).
                ckpt_writer.close(timeout=60.0)
            if journal_writer is not None:
                # After the writer drains, so the final checkpoint's
                # digest precedes the end bookend in the chain.
                try:
                    journal_writer.append("end", turn=final_turn)
                except Exception:
                    pass
            # Run-end flush: the batched families land before anyone can
            # observe the run as finished, so post-run totals are exact.
            _flush_metrics(time.monotonic())
            obs.ENGINE_TURN.set(final_turn)
            if reporter is not None:
                devmem = obs_devstats.poll_device_memory()
                reporter.emit(
                    "run_end", turn=final_turn,
                    turns_total=final_turn - start_turn,
                    chunks=chunks_done - traced_chunks,
                    traced_chunks=traced_chunks,
                    wall_s=round(time.monotonic() - run_t0, 6),
                    chunk_overhead_us=round(self._chunk_overhead_us, 2),
                    device_kind=devmem["device_kind"],
                    dev_live_bytes=devmem["live_bytes"],
                    dev_peak_bytes=devmem["peak_bytes"])
                reporter.close()
            run_span.attrs["final_turn"] = final_turn
            obs_trace.TRACER.pop(run_span)
            obs_trace.finish(run_span)
        return (self._materialize(self._whole(final_cells, final_pad),
                                  final_repr), final_turn)

    def _journal_create(self, journal_writer, cells: torch.Tensor,
                        start_turn: int, fuse_eff: int) -> None:
        """The journal's create event: the seed's digest, and the seed
        itself inline (packbits + zlib) for packed and u8 boards of up to
        2^22 cells — the JAX engine's record, field for field."""
        repr_ = self._repr
        host = device_to_host(cells)
        h, w = cells.shape[-2], _board_width(cells, repr_)
        fields = dict(turn=start_turn, h=h, w=w,
                      rule=self._rule.rulestring, repr=repr_,
                      fuse_k=fuse_eff,
                      board_sha256=journal_mod.board_digest(host, repr_))
        seed = None
        if h * w <= (1 << 22):
            if repr_ == "u8":
                seed = journal_mod.encode_board(host)
            elif repr_ == "packed":
                seed = journal_mod.encode_board(
                    wire.unpack_bits(wire.words_bytes(host), h, w))
        if seed is not None:
            fields["seed"] = seed
        journal_writer.append("create", **fields)

    def alive_count(self) -> Tuple[int, int]:
        """(alive, completed turn), a coherent pair: the pair published at
        the last chunk boundary, read without device work. While a run is
        in flight it may trail the newest issued chunk."""
        self._check_alive()
        with self._state_lock:
            pub = self._alive_pub
            turn = self._turn
        if pub is None:
            return 0, turn
        return pub

    def get_world(self) -> Tuple[np.ndarray, int]:
        """(pixel board snapshot, completed turn) (ref `Server:62-67`):
        {0,255} for life-like rules, gray levels for Generations."""
        self._check_alive()
        cells, turn, repr_ = self._board()
        return self._materialize(cells, repr_), turn

    def _whole(self, cells, pad: int):
        """A board as one tensor: a sharded board's shards read in mesh
        order onto the first device, its `pad` wrap-extension rows
        dropped; a whole board as it is."""
        if not isinstance(cells, ShardedBoard):
            return cells
        with self._on_device():
            board = cells.gather()
        return board[..., :board.shape[-2] - pad, :] if pad else board

    def _board(self):
        """(whole board or None, turn, repr), read coherently."""
        with self._state_lock:
            cells, turn, repr_ = self._cells, self._turn, self._repr
            pad = self._pad_rows
        return (None if cells is None else self._whole(cells, pad), turn,
                repr_)

    def get_view(
        self, max_cells: int
    ) -> Tuple[np.ndarray, int, Tuple[int, int]]:
        """(pixel view, completed turn, (f, f) downsample factors): the
        full board when it fits `max_cells` (or `max_cells` <= 0), else a
        block-brightest reduction made on the device, so only the view
        crosses to the host. View pixel (vy, vx) covers board rows
        [vy*f, (vy+1)*f) x columns [vx*f, (vx+1)*f) and holds the
        brightest pixel there: lit iff any cell is alive for life-like
        boards, the firing state over the dying grays for Generations.
        Packed words are OR-reduced over each f-row band before
        unpacking, so no unpacked board is ever made."""
        self._check_alive()
        cells, turn, repr_ = self._board()
        if cells is None:
            raise RuntimeError("no board loaded")
        h, w = cells.shape[-2], _board_width(cells, repr_)
        if max_cells <= 0 or h * w <= max_cells:
            return self._materialize(cells, repr_), turn, (1, 1)
        f = view_factor(h, w, max_cells)
        with self._on_device():
            if repr_ == "packed":
                view = _block_max(unpack(_or_rows(cells, f)), 1, f) * 255
            elif repr_ == "u8":
                view = _block_max(cells, f, f) * 255
            elif repr_ == "f32":
                # The brightest mass of each block, quantized: the view is
                # presentation (snapshots stay float).
                view = torch.clamp(torch.round(
                    _block_max(cells, f, f) * 255.0), 0.0, 255.0).to(
                        torch.uint8)
            elif repr_ == "gen8":
                levels = torch.from_numpy(gray_levels(self._rule)).to(
                    cells.device)
                view = _block_max(levels[cells.long()], f, f)
            else:  # gen3: firing blocks at 255, else dying at its gray
                a = _block_max(unpack(_or_rows(cells[0], f)), 1, f)
                d = _block_max(unpack(_or_rows(cells[1], f)), 1, f)
                dying = int(gray_levels(self._rule)[2])
                view = torch.maximum(a * 255, d * dying)
            return view.cpu().numpy(), turn, (f, f)

    def _materialize(self, cells: Optional[torch.Tensor],
                     repr_: str) -> np.ndarray:
        """Device board -> host pixels (waits for the board): {0,255}
        for life-like reprs, the rule's gray levels for Generations,
        rint(state * 255) for Lenia's float state (lossy: the float frame
        and checkpoint paths read the state itself)."""
        if cells is None:
            raise RuntimeError("no board loaded")
        with self._on_device():
            if repr_ == "f32":
                state = device_to_host(cells)
                return np.clip(np.rint(state * 255.0), 0, 255).astype(
                    np.uint8)
            if repr_ == "gen3":
                a, d = (unpack_np(words_to_numpy(p)) for p in cells)
                a += 2 * d
                return to_pixels_gen(a, self._rule)
            if repr_ == "gen8":
                return to_pixels_gen(cells.cpu().numpy(), self._rule)
            if repr_ == "packed":
                px = unpack_np(words_to_numpy(cells))
            else:
                px = cells.cpu().numpy().astype(np.uint8)
        px *= 255
        return px

    # Frames are board-anchored: two frames of one shape from one run are
    # comparable, so the wire may delta-encode (xrle) them. Float boards
    # (Lenia) are the exception: their u8 frames are lossy quantizations
    # of the float32 state, and deltas against them would compound the
    # quantization error.
    @property
    def frames_diffable(self) -> bool:
        return self._repr != "f32"

    @property
    def binary_pixels(self) -> bool:
        """True iff snapshots materialize as strict {0,255} pixels — the
        precondition for the wire's bit-packed codec. Generations and
        Lenia boards carry gray levels and are never packed."""
        return not isinstance(self._rule, (GenerationsRule, LeniaRule))

    def get_world_frame(self, caps) -> Tuple["object", int]:
        """(wire.Frame, completed turn) under the peer's negotiated
        `caps`. A `packed` board ships its device words as they are, no
        unpack on the device; a `u8` board ships its {0,1} cells, packed
        or scaled to pixels per band on the host. Both stream as row
        bands (`_host_bands`). Lenia's float32 state goes as a lossless
        f32 frame to a peer that negotiated `CAP_F32`, else as quantized
        u8 pixels. Generations boards are materialized as gray pixels and
        never packed. Caps-less peers get raw u8."""
        self._check_alive()
        cells, turn, repr_ = self._board()
        if cells is None:
            raise RuntimeError("no board loaded")
        caps = frozenset(caps)
        h, w = cells.shape[-2], _board_width(cells, repr_)
        if repr_ == "packed":
            bands = self._host_bands(cells, cells.shape[-1] * 4)
            return wire.packed_words_frame(h, w, bands, caps), turn
        if repr_ == "u8":
            return wire.u8_band_frame(h, w, self._host_bands(cells, w),
                                      caps, binary=True,
                                      values01=True), turn
        if repr_ == "f32" and wire.CAP_F32 in caps:
            with self._on_device():
                state = device_to_host(cells)
            return wire.encode_board_f32(state, caps), turn
        return wire.encode_board(self._materialize(cells, repr_), caps,
                                 binary=False), turn

    def _host_bands(self, cells: torch.Tensor, row_nbytes: int):
        """Yield the rows of a 2-D device board as host numpy bands of
        about GOL_WIRE_BAND_BYTES each. On CUDA each band is copied into
        pinned memory without blocking, on the engine's device and its
        current stream, so after the chunk that produced the board; band
        i+1's copy is issued before band i is yielded, so it overlaps the
        caller's socket send of band i, and each band waits on its own
        event before it is yielded. No full-board host copy is made."""
        h = cells.shape[0]
        rows = max(1, wire.band_bytes() // max(1, row_nbytes))
        slices = [cells[r0:r0 + rows] for r0 in range(0, h, rows)]
        if self._device.type != "cuda":
            for band in slices:
                obs.ENGINE_BAND_COPIES.inc()
                yield band.numpy()
            return

        def stage(band: torch.Tensor):
            obs.ENGINE_BAND_COPIES.inc()
            with self._on_device():
                host = torch.empty(band.shape, dtype=band.dtype,
                                   pin_memory=True)
                host.copy_(band, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record()
            return host, copied

        staged = stage(slices[0])
        for i in range(len(slices)):
            host, copied = staged
            if i + 1 < len(slices):
                staged = stage(slices[i + 1])
            copied.synchronize()
            yield host.numpy()

    def stats(self) -> dict:
        """Engine telemetry (no device work)."""
        self._check_alive()
        with self._state_lock:
            shape = None
            if self._cells is not None:
                shape = [self._cells.shape[-2] - self._pad_rows,
                         _board_width(self._cells, self._repr)]
            pub = self._alive_pub
            return {
                "turn": self._turn,
                "running": self._running,
                "board": shape,
                "alive": pub[0] if pub is not None else None,
                "alive_turn": pub[1] if pub is not None else None,
                "packed": self._repr == "packed",
                "chunk": self._last_chunk,
                "turns_per_s": round(self._turns_per_s, 1),
                # Mean host µs a chunk outside the token wait (the last
                # run's), and the cumulative counters it comes from.
                "chunk_overhead_us": round(self._chunk_overhead_us, 2),
                "issue_s": round(self._issue_s, 6),
                "token_wait_s": round(self._token_wait_s, 6),
                "host_s": round(self._host_s, 6),
                "chunks": self._counted_chunks,
                "rule": self._rule.rulestring,
                "device": str(self._device),
                "devices": len(self._devices),
                # The last submitted run's mesh geometry (None before
                # the first run): axis sizes, shard count, grid shape.
                "mesh": self._mesh_geom,
            }

    # -------------------------------------------------------- checkpointing

    # Checkpoints at or below this payload size are zlib-compressed;
    # larger ones are written raw — compressing a 512 MiB packed board
    # would dominate the checkpoint interval for little gain.
    CKPT_COMPRESS_LIMIT = 64 * 1024 * 1024

    def geometry(self) -> dict:
        """Placement geometry for the reshard-at-restore contract
        (`ckpt/reshard.py`): the engine's device count; a manifest
        recording another mesh (or a sparse window) is refused at restore
        unless a reshard is requested."""
        with self._state_lock:
            cells, repr_, pad = self._cells, self._repr, self._pad_rows
        geo = {"kind": "dense", "devices": len(self._devices)}
        if cells is not None:
            geo["h"] = int(cells.shape[-2] - pad)
            geo["w"] = int(_board_width(cells, repr_))
            geo["repr"] = repr_
            # The logical CELL dtype, not the storage dtype (packed
            # boards hold int32 words of uint8 cells).
            geo["dtype"] = "float32" if repr_ == "f32" else "uint8"
        return geo

    def _ckpt_snapshot(self, trigger: str = "manual"):
        """Capture the current state as a ckpt.Snapshot (a lock-held
        pointer copy — the expensive work happens in the writer)."""
        cells, turn, repr_ = self._board()
        if cells is None:
            raise RuntimeError("no board loaded")
        return ckpt_mod.Snapshot(
            cells, repr_, turn, (cells.shape[-2], _board_width(cells, repr_)),
            self._rule.rulestring, trigger=trigger,
            mesh={"devices": len(self._devices)}, fuse=self._fuse_eff,
            stream=self._current_stream())

    def checkpoint_now(self, directory: Optional[str] = None,
                       trigger: str = "manual") -> Tuple[str, int]:
        """Write one durable manifest checkpoint SYNCHRONOUSLY to
        `directory` (default: the configured GOL_CKPT dir); returns
        (manifest_path, turn). The Checkpoint wire method, the `c` key
        and the SIGTERM handler land here."""
        d = directory or os.environ.get(ckpt_mod.CKPT_DIR_ENV, "")
        if not d:
            raise RuntimeError(
                "checkpointing not configured: set GOL_CKPT or pass "
                "--checkpoint DIR")
        self._check_alive()
        snap = self._ckpt_snapshot(trigger)
        return self._ckpt_writer(d).write_sync(snap), snap.turn

    def restore_run(self, path: str, reshard: bool = False) -> int:
        """Verified manifest/legacy restore (`ckpt.restore_engine` over
        this engine); returns the restored turn. `reshard=True` accepts a
        checkpoint whose recorded geometry disagrees with this engine by
        routing it through the host-side canonical repack."""
        return ckpt_mod.restore_engine(self, path, reshard=reshard)

    def save_checkpoint(self, path: str) -> None:
        """Atomically write the board state + turn + rulestring as .npz
        (the legacy single-file format): packed boards as `words` +
        `width` (uint32, the JAX package's), gen3 as `gen_planes`, gen8
        as `gen_state`, f32 as `float_state`, u8 as {0,255} `world`
        pixels. The temp name is per writer: the SIGTERM handler can race
        the run thread's autosave on the same target."""
        cells, turn, repr_ = self._board()
        if cells is None:
            raise RuntimeError("no board loaded")
        arrays = payload_arrays(device_to_host(cells), repr_)
        payload = next(v for k, v in arrays.items() if k != "width")
        save = (np.savez_compressed
                if payload.nbytes <= self.CKPT_COMPRESS_LIMIT
                else np.savez)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        try:
            with open(tmp, "wb") as f:
                save(f, turn=turn, rulestring=self._rule.rulestring,
                     **arrays)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def load_checkpoint(self, path: str) -> int:
        """Restore (board, turn) from a checkpoint payload of either
        package; returns the turn. The restored state serves `get_world`
        and `alive_count` at once, so a controller can reattach with
        CONT=yes. Refused: another rule than this engine's, two-plane
        words on anything but a 3-state Generations engine, a bad
        Generations state, packed words that are not uint32, a float
        state on anything but a Lenia engine (or one that is not 2-D
        float32, or not finite), pixels on a Lenia engine, and any
        restore while a run is in flight."""
        self._check_alive()
        rule = self._rule
        gen = isinstance(rule, GenerationsRule)
        with np.load(path) as z:
            turn = int(z["turn"])
            if "rulestring" in z.files:
                ckpt_rule = str(z["rulestring"])
                if ckpt_rule != rule.rulestring:
                    raise ValueError(
                        f"checkpoint rule {ckpt_rule!r} != engine rule "
                        f"{rule.rulestring!r}")
            if "gen_planes" in z.files:
                planes = z["gen_planes"]
                width = int(z["width"])
                if not gen or rule.states != 3:
                    raise ValueError(
                        f"{path}: two-plane checkpoint needs a 3-state "
                        f"Generations engine, not {rule.rulestring}")
                if (planes.dtype != np.uint32 or planes.ndim != 3
                        or planes.shape[0] != 2
                        or planes.shape[-1] * 32 != width):
                    raise ValueError(
                        f"{path}: inconsistent planes checkpoint "
                        f"({planes.dtype} {planes.shape} for width "
                        f"{width})")
                cells = words_from_numpy(planes, self._device)
                repr_ = "gen3"
            elif "gen_state" in z.files:
                state = z["gen_state"]
                if not gen:
                    raise ValueError(
                        f"{path}: Generations checkpoint needs a "
                        f"Generations engine, not {rule.rulestring}")
                if (state.dtype != np.uint8 or state.ndim != 2
                        or int(state.max(initial=0)) >= rule.states):
                    raise ValueError(
                        f"{path}: bad Generations state checkpoint "
                        f"({state.dtype} {state.shape})")
                cells = torch.from_numpy(state).to(self._device)
                repr_ = "gen8"
            elif "float_state" in z.files:
                state = z["float_state"]
                if not isinstance(rule, LeniaRule):
                    raise ValueError(
                        f"{path}: float-state checkpoint needs a "
                        f"continuous-family engine, not {rule.rulestring}")
                if state.dtype != np.float32 or state.ndim != 2:
                    raise ValueError(
                        f"{path}: bad float-state checkpoint "
                        f"({state.dtype} {state.shape}); continuous "
                        f"boards are stored as 2-D float32")
                if not np.all(np.isfinite(state)):
                    raise ValueError(
                        f"{path}: float-state checkpoint carries "
                        f"non-finite values")
                cells = torch.from_numpy(np.clip(state, 0.0, 1.0)).to(
                    self._device)
                repr_ = "f32"
            elif "words" in z.files:
                words = z["words"]
                width = int(z["width"])
                packed, _ = select_representation(width)
                if not packed or words.shape[-1] * 32 != width:
                    raise ValueError(
                        f"{path}: inconsistent packed checkpoint "
                        f"({words.shape} words for width {width})")
                if words.dtype != np.uint32:
                    # An int32 payload would load bit-reinterpreted here
                    # but hash and load differently in the JAX package.
                    raise ValueError(
                        f"{path}: packed words must be uint32, "
                        f"got {words.dtype}")
                cells = words_from_numpy(words, self._device)
                repr_ = "packed"
            else:
                world = z["world"]  # legacy / unpacked pixel format
                if gen:
                    cells = torch.from_numpy(
                        from_pixels_gen(world, rule)).to(self._device)
                    repr_ = "gen8"
                elif isinstance(rule, LeniaRule):
                    # The /255 pixel decode is lossy; a float board's
                    # checkpoint always carries float_state.
                    raise ValueError(
                        f"{path}: pixel checkpoint cannot restore a "
                        f"continuous float board losslessly (want a "
                        f"float_state checkpoint)")
                elif isinstance(rule, LargerThanLifeRule):
                    # The conv families have no packed form.
                    cells = torch.from_numpy(
                        (world != 0).astype(np.uint8)).to(self._device)
                    repr_ = "u8"
                else:
                    packed, _ = select_representation(world.shape[1])
                    if packed:
                        cells = words_from_numpy(pack_np(world),
                                                 self._device)
                    else:
                        cells = torch.from_numpy(
                            (world != 0).astype(np.uint8)).to(self._device)
                    repr_ = "packed" if packed else "u8"
        with self._state_lock:
            if self._running:
                # Fail BEFORE the count dispatch below: it would queue
                # behind the in-flight chunks only to be discarded.
                raise RuntimeError("cannot restore while running")
        # One count dispatch at restore, so the poll path serves the
        # restored state's exact pair from the first tick.
        with self._on_device():
            alive = int(_firing_row_counts(cells, repr_).sum(
                dtype=torch.int64))
        with self._state_lock:
            if self._running:
                raise RuntimeError("cannot restore while running")
            self._cells = cells
            self._repr = repr_
            self._pad_rows = 0  # checkpoints hold whole, cropped boards
            self._turn = turn
            self._alive_pub = (alive, turn)
        return turn

    def _resolve_mesh2d(self, height: int, width: int, packed: bool,
                        generations: bool = False):
        """The requested 2-D mesh, or None for row sharding (no request,
        an unpacked board, a Generations rule, or a request the board or
        the devices cannot serve — each explicit one warned about, as in
        `gol_tpu`)."""
        if self._mesh_shape is None:
            return None

        def _fallback(reason: str):
            warnings.warn(
                f"2-D mesh request {self._mesh_shape} ignored ({reason}); "
                f"falling back to 1-D row sharding")
            return None

        if generations:
            return _fallback(
                f"the 2-D perimeter-halo path serves life-like packed "
                f"boards only; Generations rule {self._rule.rulestring} "
                f"uses 1-D row sharding")
        if not packed:
            return _fallback(
                f"width {width} is not a whole number of 32-bit words — "
                f"the 2-D perimeter-halo path is packed-only")
        from gol_tpu_torch.parallel.mesh2d import make_mesh2d

        r, c = self._mesh_shape
        wp = width // WORD_BITS
        if r <= 0 or c <= 0:
            return _fallback("non-positive mesh dims")
        if r * c > len(self._devices):
            return _fallback(
                f"{r}x{c} needs {r * c} devices, have "
                f"{len(self._devices)}")
        if height % r or wp % c:
            return _fallback(
                f"board {height} rows x {wp} words does not tile "
                f"{r}x{c} evenly")
        return make_mesh2d((r, c), self._devices)

    # ------------------------------------------------------- chunk adapter

    def _adapt_chunk(self, chunk: int, k: int, elapsed: float) -> int:
        """Ramp-regime adapter (one chunk in flight): grow the
        power-of-two chunk while its compute above the dispatch floor
        (`_fixed_cost_est`, the smallest elapsed seen) is under target —
        x16 while far under it, then x4, x2 — and halve it above twice
        the target."""
        if k != chunk:
            return chunk  # a remainder chunk's timing is unrepresentative
        self._fixed_cost_est = min(self._fixed_cost_est, elapsed)
        marginal = elapsed - self._fixed_cost_est
        if marginal < self._chunk_target:
            if (marginal * 16 <= self._chunk_target
                    and chunk * 16 <= self._max_chunk):
                return chunk * 16
            if chunk * 4 <= self._max_chunk:
                return chunk * 4
            if chunk * 2 <= self._max_chunk:
                return chunk * 2
        if marginal > self._chunk_target * 2 and chunk > 1:
            return chunk // 2
        return chunk

    def _adapt_chunk_windowed(self, chunk: int, now: float, k: int) -> int:
        """Pipelined-regime adapter: the per-turn pace over a sliding
        window of pops sizes the chunk into [target, 2 x target].
        Single pop-to-pop times are unusable once chunks overlap (queued
        completions drain microseconds apart)."""
        if self._pace_skip > 0:
            self._pace_skip -= 1
            return chunk
        self._pace_window.append((now, k))
        rate = self._pace_rate()
        if rate is None:
            return chunk
        est = chunk / rate
        if est < self._chunk_target and chunk * 2 <= self._max_chunk:
            return chunk * 2
        if est > self._chunk_target * 2 and chunk > 1:
            return chunk // 2
        return chunk

    def _pace_rate(self) -> Optional[float]:
        """Turns/second across the pop window; None until it holds four
        pops."""
        win = self._pace_window
        if len(win) < 4:
            return None
        span = win[-1][0] - win[0][0]
        turns = sum(kk for _, kk in list(win)[1:])
        if span <= 0 or turns <= 0:
            return None
        return turns / span
