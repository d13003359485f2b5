"""Dispatch of the packed board and of the Generations planes, on one
device and sharded over a mesh — the counterpart of
`gol_tpu/parallel/halo.py`.

One device: the kind of a board depends on its shape only
(`packed_run_kind`, `planes_run_kind`); whether a kernel or its plain
version runs is decided by the tensor's device inside the kernel
wrappers, so the CPU tests walk the decomposition the card runs. The
one-shard packed run pinned at a fuse depth is `fused_packed_run_turns`.

Row sharding (`parallel/mesh.py`): each shard of a `ShardedBoard` is a
band of rows. A macro-step trades T-row halos with the ring neighbours
(`exchange_halos`: the low halo is shard j-1's trailing rows, the high
halo shard j+1's leading rows, mod n — the JAX package's `ppermute`
pair, here slices on one device, event-ordered copies across devices of
one process, `torch.distributed` point-to-point across processes) and
steps the (R + 2T)-row window T turns as a torus of its own through the
single-device dispatch of the window's shape (`run_window`: K1, or one
K2 sweep, or one K6 sweep when GOL_FUSE_K pins T past 32; K4 or K5 for
gen3 windows). The window's wrong edges advance a row a turn, so after
T turns its middle R rows are exact. T = 1 is the per-turn path (odd
turn counts, every gen3, u8 and gen8 turn); `_deep_halo_T`,
`fused_halo_T` and `halo_traffic` are the JAX package's, so the analytic
gol_halo_* counts are equal. Each window's result is a fresh tensor:
halos always read the previous macro-step's output.

A counted dispatch's last launch on each shard counts that shard's own
words (`count` and its box: rows T..T+R of the window), one int64 a
shard; the caller adds them. Heights the shard count does not divide
take the exact-N wrap extension (`extended_run_turns`), whose pad rows
are never counted.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from gol_tpu_torch.models.lifelike import CONWAY
from gol_tpu_torch.ops.bitpack import WORD_BITS
from gol_tpu_torch.ops.cuda_stencil import (
    banded_run_turns,
    banded_run_turns2p,
    fits_resident,
    fits_resident2p,
    fused_banded_run_turns,
    resident_run_turns,
    resident_run_turns2p,
)
from gol_tpu_torch.ops.fused import MAX_FUSE_K
from gol_tpu_torch.ops.stencil import run_turns
from gol_tpu_torch.parallel.mesh import ROWS_AXIS, ShardedBoard


def packed_run_kind(shape) -> str:
    """'resident' (K1, the whole board in one block's shared memory) when
    the packed board fits `RESIDENT_BOARD_BYTES`, else 'tiled' (K2
    sweeps). Hopper needs neither of the TPU's 128-lane or wp >= 2 gates:
    K2 takes any height and width, K1 any board that fits."""
    return "resident" if fits_resident(shape) else "tiled"


def packed_run_by_kind(kind: str):
    """The `(words, num_turns, rule) -> words` stepper for a kind."""
    return {"resident": resident_run_turns, "tiled": banded_run_turns}[kind]


def _counting(count, box=None) -> dict:
    """A stepper's keyword arguments for `count` and its `box` (none
    without a count, so a stepper of the plain `(words, num_turns, rule)`
    form still fits)."""
    if count is None:
        return {}
    return {"count": count} if box is None else {"count": count, "box": box}


def packed_run_turns(words, num_turns: int, rule, *, count=None, box=None):
    """Advance a packed board by the stepper its shape selects; with
    `count` (one int64 on the board's device) its last launch also
    counts the result's live cells into it (those in `box` = (r0, r1,
    c0, c1) when given)."""
    return packed_run_by_kind(packed_run_kind(words.shape))(
        words, num_turns, rule, **_counting(count, box))


def fused_packed_run_turns(words, num_turns: int, rule=CONWAY,
                           fuse: int = 0, *, count=None, box=None):
    """Advance a packed board `num_turns` turns at fuse depth `fuse` (the
    counterpart of `gol_tpu/ops/fused.py`'s), bit-identical to
    `packed_run_turns`. `fuse <= 1` and a board K1 holds take the native
    stepper; any other board sweeps at depth min(fuse, MAX_FUSE_K).
    `count` and `box` as `packed_run_turns`'s."""
    if fuse <= 1 or packed_run_kind(words.shape) == "resident":
        return packed_run_turns(words, num_turns, rule, count=count, box=box)
    return fused_banded_run_turns(words, num_turns, min(fuse, MAX_FUSE_K),
                                  rule, **_counting(count, box))


def fused_run_fn(fuse: int):
    """The engine's `(cells, num_turns, rule)` packed run pinned at fuse
    depth `fuse`."""
    return functools.partial(fused_packed_run_turns, fuse=fuse)


def select_representation(width: int):
    """(packed, run_fn): bit-packed whenever the width is a whole number
    of 32-cell words, else the uint8 roll-sum path."""
    if width % WORD_BITS == 0:
        return True, packed_run_turns
    return False, run_turns


# ------------------------------------------------- Generations planes


def planes_run_kind(shape) -> str:
    """'resident' (K4, both planes in one block's shared memory) when
    each plane of the (2, H, Wp) pair fits `RESIDENT2P_PLANE_BYTES`, else
    'tiled' (K5 sweeps) — the counterpart of `_dispatch_two_planes`'s
    VMEM gate, from the shape alone."""
    return "resident" if fits_resident2p(shape) else "tiled"


def planes_run_by_kind(kind: str):
    """The `(planes, num_turns, rule, family) -> planes` stepper."""
    return {"resident": resident_run_turns2p,
            "tiled": banded_run_turns2p}[kind]


def planes_run_turns(planes, num_turns: int, rule, family: str, *,
                     count=None, box=None):
    """Advance stacked (2, H, Wp) planes of `family` ('gen3' or 'gen4')
    by the stepper their shape selects; `count` and `box` (gen3) as
    `packed_run_turns`'s, of the alive plane."""
    return planes_run_by_kind(planes_run_kind(planes.shape))(
        planes, num_turns, rule, family, **_counting(count, box))


def gen3_run_turns(stacked, num_turns: int, rule, *, count=None):
    """The engine's gen3 run: stacked (alive, dying) planes — one shard
    of `sharded_gen3_run_turns`; `count` as `planes_run_turns`'s."""
    return planes_run_turns(stacked, num_turns, rule, "gen3", count=count)


def generations_run_turns(state, num_turns: int, rule):
    """The engine's gen8 run: a uint8 state board — one shard of
    `sharded_generations_run_turns`, plain torch as in the JAX package."""
    from gol_tpu_torch.models.generations import run_turns as gen8_run

    return gen8_run(state, num_turns, rule)


def select_generations_representation(width: int, rule):
    """(repr, run_fn): 'gen3' planes for three-state rules on widths that
    are a whole number of words, else 'gen8' uint8 states (four-state
    rules included, as the JAX engine runs them)."""
    if rule.states == 3 and width % WORD_BITS == 0:
        return "gen3", gen3_run_turns
    return "gen8", generations_run_turns


# ------------------------------------------------------------- sharding


def _to_device(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """`t` on `dev`: itself on its own device; on another CUDA device of
    this process a copy issued after the source stream's work (an event
    recorded there, waited on by the destination's stream)."""
    if t.device == dev:
        return t
    if t.is_cuda and dev.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(t.device))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(done)
            # The source's memory is not reused before this copy reads it.
            t.record_stream(stream)
            return t.to(dev, non_blocking=True)
    return t.to(dev)


def move(mesh, items: list) -> list:
    """Carry slices between mesh positions. Each item is (dst, src,
    tensor, shape, dtype): `tensor` the slice at position `src` (None
    where another process owns it), `shape` and `dtype` what `dst`
    receives. Returns, per item, the tensor on dst's device where this
    process owns dst, else None. Within a process: the slice itself on
    one device, `_to_device` across devices; across processes
    point-to-point through the process group (`multihost.exchange`)."""
    out = [None] * len(items)
    p2p = []
    for tag, (dst, src, t, shape, dtype) in enumerate(items):
        here, there = mesh.local(dst), mesh.local(src)
        if here and there:
            out[tag] = _to_device(t, mesh.devices.flat[dst])
        elif there:
            p2p.append(("send", t, int(mesh.procs.flat[dst]), tag))
        elif here:
            buf = torch.empty(shape, dtype=dtype,
                              device=mesh.devices.flat[dst])
            p2p.append(("recv", buf, int(mesh.procs.flat[src]), tag))
            out[tag] = buf
    if p2p:
        from gol_tpu_torch.parallel import multihost

        multihost.exchange(p2p, mesh)
    return out


def _neighbour(mesh, pos: int, axis: int, step: int) -> int:
    """Flat position one `step` along mesh axis `axis` from `pos`, on a
    ring."""
    shape = mesh.devices.shape
    c = shape[1] if len(shape) > 1 else 1
    i, j = divmod(pos, c)
    if axis == 0:
        i = (i + step) % shape[0]
    else:
        j = (j + step) % c
    return i * c + j


def exchange_halos(parts: list, mesh, axis_name: str = ROWS_AXIS,
                   depth: int = 1, axis: int = -2):
    """(lows, highs), one entry a mesh position: `depth` slices of tensor
    `axis` from each ring neighbour along mesh axis `axis_name`. The low
    halo is the previous neighbour's trailing slice (it goes before this
    shard), the high halo the next neighbour's leading slice. `parts`
    holds one tensor a position (None where another process owns it)."""
    ax = mesh.axis_names.index(axis_name)
    ref = next(p for p in parts if p is not None)
    shape = list(ref.shape)
    shape[axis] = depth
    items = []
    for pos in range(mesh.size):
        for src, lead in ((_neighbour(mesh, pos, ax, -1), False),
                          (_neighbour(mesh, pos, ax, 1), True)):
            t = parts[src]
            if t is not None:
                t = t.narrow(axis, 0 if lead else t.shape[axis] - depth,
                             depth)
            items.append((pos, src, t, tuple(shape), ref.dtype))
    got = move(mesh, items)
    return got[0::2], got[1::2]


def run_window(window: torch.Tensor, T: int, rule=CONWAY, *, count=None,
               box=None) -> torch.Tensor:
    """Advance a haloed packed window T turns as a torus of its own by
    the single-device dispatch of its shape: K1 when the window fits a
    cluster, else one K2 sweep (T <= 32) or one K6 sweep (T > 32, under
    GOL_FUSE_K). `count` takes the live cells of `box` of the result."""
    return fused_packed_run_turns(window, T, rule, fuse=T, count=count,
                                  box=box)


def window_kind(window_shape, T: int) -> str:
    """The kernel `run_window` launches for a window: 'resident' (K1),
    'tiled' (K2) or 'deep' (K6) — the port's `inner_kind`."""
    if packed_run_kind(window_shape) == "resident":
        return "resident"
    return "tiled" if T <= 32 else "deep"


def _halo_source(repr_: str, part):
    """What a shard sends its neighbours: its rows, or for gen3 the rows
    of its alive plane (the dying plane transitions from its own cell)."""
    return part[0] if repr_ == "gen3" and part is not None else part


def _window(repr_: str, low, local, high) -> torch.Tensor:
    """[low, local, high] along the rows. A gen3 window's dying-plane
    halo rows are zeros: they feed only rows the crop drops."""
    if repr_ == "gen3":
        z = torch.zeros_like(low)
        low, high = torch.stack([low, z]), torch.stack([high, z])
    return torch.cat([low, local, high], dim=-2)


def _step_window(repr_: str, window, T: int, rule, count, box):
    """T torus turns of a window by its repr's stepper: K1/K2/K6 for
    packed words, K4/K5 for gen3 planes, plain torch for u8 cells and
    gen8 states (as on one device)."""
    if repr_ == "packed":
        return run_window(window, T, rule, count=count, box=box)
    if repr_ == "gen3":
        return planes_run_turns(window, T, rule, "gen3", count=count,
                                box=box)
    if repr_ == "u8":
        return run_turns(window, T, rule)
    from gol_tpu_torch.models.generations import run_turns as gen8_run

    return gen8_run(window, T, rule)


def _ring_macro(board: ShardedBoard, repr_: str, T: int, rule,
                counts=None, boxes=None) -> ShardedBoard:
    """One T-turn macro-step of every shard this process holds: T-row
    halos from the ring neighbours, the (R + 2T)-row window stepped T
    turns, its exact middle kept. With `counts` (one int64 a position),
    the step's launch counts the shard's live cells: rows T..T+R of the
    window, or `boxes[pos]` when given."""
    mesh = board.mesh
    lows, highs = exchange_halos(
        [_halo_source(repr_, p) for p in board.shards], mesh, ROWS_AXIS, T)
    out = []
    for pos, local in enumerate(board.shards):
        if local is None:
            out.append(None)
            continue
        rows = local.shape[-2]
        count = None if counts is None else counts[pos]
        box = None
        if count is not None:
            box = (boxes[pos] if boxes is not None
                   else (T, T + rows, 0, local.shape[-1]))
        res = _step_window(repr_, _window(repr_, lows[pos], local,
                                          highs[pos]), T, rule, count, box)
        out.append(res[..., T:T + rows, :])
    return ShardedBoard(out, mesh)


def _run_macros(board: ShardedBoard, repr_: str, num_turns: int, T: int,
                rule, count=None) -> ShardedBoard:
    """num_turns / T macro-steps of depth T; the last one counts."""
    macros = num_turns // T
    for m in range(macros):
        board = _ring_macro(board, repr_, T, rule,
                            count if m == macros - 1 else None)
    return board


# Deep-halo macro-stepping: a T-row halo is traded once and the window
# then advances T turns with no communication; the corruption from the
# window's own torus wrap advances one row a turn from each edge, so
# after T turns it has consumed exactly the 2T halo rows. The depth is
# the JAX package's, so the exchange rounds and bytes are too.
DEEP_HALO_T = 16


def _deep_halo_T(num_turns: int, shard_rows: int,
                 cap: int = DEEP_HALO_T) -> int:
    """Largest power of two that divides num_turns, capped by `cap`
    (DEEP_HALO_T natively, the pinned fuse depth on the fused fallback
    path) and by the shard height (a halo can only come from the
    adjacent shard)."""
    t = 1
    while t * 2 <= min(cap, shard_rows) and num_turns % (t * 2) == 0:
        t *= 2
    return t


def fused_halo_T(fuse: int, num_turns: int, shard_rows: int) -> int:
    """The deep-halo depth a fuse-k dispatch uses: k itself when it
    divides the dispatch and fits the shard height (one exchange per k
    turns), else the largest power-of-two fallback capped by k. fuse <= 1
    is the native selection. `halo_traffic` mirrors this exactly."""
    if fuse <= 1:
        return _deep_halo_T(num_turns, shard_rows)
    if fuse <= shard_rows and num_turns % fuse == 0:
        return fuse
    return _deep_halo_T(num_turns, shard_rows, cap=fuse)


@functools.lru_cache(maxsize=1024)
def halo_traffic(repr_, shape, mesh, num_turns, fuse=0) -> dict:
    """Analytic halo traffic of ONE dispatch of `num_turns` turns:
    {axis: (exchange_rounds, total_bytes)} — `gol_tpu`'s model, number
    for number. A round is one paired exchange (both ring directions);
    bytes sum every shard's sends. {} when the dispatch moves no halo: a
    single shard along every axis, zero turns, or the wrap-extension
    path, whose per-turn rebuild is not modelled (engine callers gate on
    pad_rows == 0). gen3 exchanges its alive plane only. `shape` must be
    a plain tuple (an lru_cache key)."""
    if num_turns <= 0:
        return {}
    axes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_rows = int(axes.get(ROWS_AXIS, 1))
    if "cols" in axes:
        n_cols = int(axes["cols"])
        from gol_tpu_torch.parallel.mesh2d import macro_T_2d

        h, wp = shape
        shard_rows, shard_cols = h // n_rows, wp // n_cols
        T = macro_T_2d(shard_rows, fuse)
        full, rem = divmod(num_turns, T)
        depths = [T] * full + ([rem] if rem else [])
        out = {}
        if n_rows > 1:
            out[ROWS_AXIS] = (
                len(depths),
                sum(2 * t * shard_cols * 4 * n_rows * n_cols
                    for t in depths))
        if n_cols > 1:
            out["cols"] = (
                len(depths),
                sum(2 * (shard_rows + 2 * t) * 4 * n_rows * n_cols
                    for t in depths))
        return out
    if n_rows <= 1:
        return {}
    if repr_ == "gen3":
        rows_len = shape[1]
        row_bytes = shape[-1] * 4
    elif repr_ == "packed":
        rows_len = shape[0]
        row_bytes = shape[-1] * 4
    else:
        rows_len = shape[0]
        row_bytes = shape[-1]
    if repr_ == "packed":
        T = fused_halo_T(fuse, num_turns, rows_len // n_rows)
        if T > 1:
            rounds = num_turns // T
            return {ROWS_AXIS: (rounds, rounds * 2 * T * row_bytes * n_rows)}
    rounds = num_turns
    return {ROWS_AXIS: (rounds, rounds * 2 * row_bytes * n_rows)}


def dispatch_obs(repr_, cells, num_turns, mesh, fuse=0):
    """Observability of one direct sharded dispatch: the analytic traffic
    into the gol_halo_* counters, the fused-dispatch counter at k > 1,
    and a 'halo.dispatch' span when hot spans are armed. The engine calls
    the run functions' inner halves and accounts per chunk instead
    (`obs/halostats.flush_chunk_walls`). Never raises."""
    try:
        traffic = halo_traffic(repr_, tuple(cells.shape), mesh, num_turns,
                               fuse)
        if not traffic:
            return contextlib.nullcontext()
        from gol_tpu_torch.obs import catalog, halostats, trace

        halostats.note_traffic(traffic, num_turns)
        if fuse > 1:
            catalog.FUSED_DISPATCHES.labels(tier="mesh").inc()
        if not trace.hot_spans_enabled():
            return contextlib.nullcontext()
        return trace.TRACER.span("halo.dispatch", attrs={
            "repr": repr_, "turns": num_turns, "shards": int(mesh.size),
            "exchange_rounds": halostats.total_rounds(traffic),
            "halo_bytes": halostats.total_bytes(traffic)})
    except Exception:
        return contextlib.nullcontext()


def _one_shard(board: ShardedBoard, run, count, **kw) -> ShardedBoard:
    """A one-shard mesh: its shard through the single-device run."""
    (local,) = board.shards
    c = None if count is None else count[0]
    return ShardedBoard([run(local, **kw, **_counting(c))], board.mesh)


def _sharded_packed(board: ShardedBoard, num_turns: int, rule=CONWAY,
                    fuse: int = 0, count=None) -> ShardedBoard:
    """`sharded_packed_run_turns` without its telemetry (the engine's)."""
    if num_turns == 0:
        return board
    if board.mesh.shape[ROWS_AXIS] == 1:
        return _one_shard(board, fused_packed_run_turns, count,
                          num_turns=num_turns, rule=rule, fuse=fuse)
    T = fused_halo_T(fuse, num_turns, board.shape[-2] // board.mesh.size)
    return _run_macros(board, "packed", num_turns, T, rule, count)


def sharded_packed_run_turns(board: ShardedBoard, num_turns: int, mesh,
                             rule=CONWAY, fuse: int = 0, *,
                             count=None) -> ShardedBoard:
    """Advance a row-sharded packed board `num_turns` turns. One shard
    runs the single-device (fused) dispatch; more exchange T-row halos
    and step their windows T turns at a time, T = `fused_halo_T(fuse,
    ...)`. `count`: one int64 a mesh position, each set by its shard's
    last launch to the shard's live cells."""
    with dispatch_obs("packed", board, num_turns, mesh, fuse):
        return _sharded_packed(board, num_turns, rule, fuse, count)


def _sharded_turns(board: ShardedBoard, repr_: str, num_turns: int, rule,
                   count=None) -> ShardedBoard:
    """Per-turn steps (1-row halos) of a u8, gen8 or gen3 board."""
    if num_turns == 0:
        return board
    return _run_macros(board, repr_, num_turns, 1, rule, count)


def sharded_run_turns(board: ShardedBoard, num_turns: int, mesh,
                      rule=CONWAY) -> ShardedBoard:
    """Advance a row-sharded {0,1} uint8 board (any width) `num_turns`
    turns, a 1-row halo exchange a turn."""
    with dispatch_obs("u8", board, num_turns, mesh):
        return _sharded_turns(board, "u8", num_turns, rule)


def sharded_generations_run_turns(board: ShardedBoard, num_turns: int,
                                  mesh, rule) -> ShardedBoard:
    """Advance a row-sharded uint8 Generations state board."""
    with dispatch_obs("gen8", board, num_turns, mesh):
        return _sharded_turns(board, "gen8", num_turns, rule)


def _sharded_gen3(board: ShardedBoard, num_turns: int, rule,
                  count=None) -> ShardedBoard:
    if num_turns and board.mesh.shape[ROWS_AXIS] == 1:
        return _one_shard(board, gen3_run_turns, count,
                          num_turns=num_turns, rule=rule)
    return _sharded_turns(board, "gen3", num_turns, rule, count)


def sharded_gen3_run_turns(board: ShardedBoard, num_turns: int, mesh,
                           rule, fuse: int = 0, *,
                           count=None) -> ShardedBoard:
    """Advance row-sharded stacked (alive, dying) planes of a 3-state
    rule. One shard runs the single-device planes dispatch (K4/K5, the
    port's fused gen3 at every depth); more keep the JAX package's
    per-turn alive-plane exchange, each turn K4 or K5 on the
    (2, R + 2, Wp) window. `count` as `sharded_packed_run_turns`'s."""
    with dispatch_obs("gen3", board, num_turns, mesh):
        return _sharded_gen3(board, num_turns, rule, count)


# ----------------------------------------------- exact-N odd heights
#
# The reference serves exactly the requested worker count on any height
# by spreading H mod N rows over the first strips
# (`Server/gol/distributor.go:106-116`). Equal shards need H + ext rows:
# the board is extended with its first `ext` rows (cyclically when ext >
# H), the (H + ext)-row torus is stepped a turn, and the invariant is
# rebuilt: with P2 the stepped extension, B' = [P2[H], P2[1:H]] (P2[H]
# is the true new row 0; it needs ext >= 2 so that P[H+1] = B[1]), then
# B'[(0:ext) mod H] again. The rebuild moves rows across shards every
# turn; the count of the last turn takes P2's rows 1..H, B'[0:H].


def exact_shard_ext(height: int, n_shards: int) -> int:
    """Smallest extension >= 2 making height + ext divisible; 0 when the
    height already divides (no extension needed)."""
    if n_shards <= 1 or height % n_shards == 0:
        return 0
    ext = 2
    while (height + ext) % n_shards:
        ext += 1
    return ext


def extend_rows(board: np.ndarray, ext: int, axis: int = 0) -> np.ndarray:
    """[B; B[(0:ext) mod H]] along `axis` (host-side, at submit); `axis=1`
    serves stacked gen3 planes."""
    idx = np.arange(ext) % board.shape[axis]
    return np.concatenate([board, np.take(board, idx, axis=axis)],
                          axis=axis)


def _ext_repr(repr_) -> str:
    """The representation tag: a bool (life-like packed/u8) or one of
    'packed', 'u8', 'gen8', 'gen3'."""
    if repr_ is True:
        return "packed"
    if repr_ is False:
        return "u8"
    if repr_ not in ("packed", "u8", "gen8", "gen3"):
        raise ValueError(f"unknown extended-run repr {repr_!r}")
    return repr_


def _rebuild_source(r: int, height: int) -> int:
    """The row of the stepped extension that row r of the rebuilt one
    copies."""
    if r == 0:
        return height
    if r < height:
        return r
    i = (r - height) % height
    return height if i == 0 else i


def _rebuild(board: ShardedBoard, height: int) -> ShardedBoard:
    """The exact-N invariant rebuilt across shards: each shard's rows
    copied from their `_rebuild_source` rows, in runs; a run of a
    shard's own rows stays in place."""
    mesh = board.mesh
    ref = next(p for p in board.shards if p is not None)
    R = ref.shape[-2]
    items, plans = [], []
    for pos in range(mesh.size):
        plan, r, end = [], pos * R, (pos + 1) * R
        while r < end:
            g = _rebuild_source(r, height)
            e = r + 1
            while (e < end and _rebuild_source(e, height)
                   == _rebuild_source(e - 1, height) + 1
                   and _rebuild_source(e, height) // R == g // R):
                e += 1
            src = g // R
            if src == pos and g == r:
                plan.append(("own", r - pos * R, e - pos * R))
            else:
                t = board.shards[src]
                if t is not None:
                    t = t[..., g - src * R:g - src * R + (e - r), :]
                items.append((pos, src, t,
                              tuple(ref.shape[:-2]) + (e - r,
                                                       ref.shape[-1]),
                              ref.dtype))
                plan.append(("moved", len(items) - 1))
            r = e
        plans.append(plan)
    got = move(mesh, items)
    out = []
    for pos, plan in enumerate(plans):
        local = board.shards[pos]
        if local is None:
            out.append(None)
            continue
        parts = [local[..., p[1]:p[2], :] if p[0] == "own" else got[p[1]]
                 for p in plan]
        out.append(parts[0] if len(parts) == 1
                   else torch.cat(parts, dim=-2))
    return ShardedBoard(out, mesh)


def _count_boxes(board: ShardedBoard, height: int) -> list:
    """Per shard, the window box of its rows among rows 1..H of the
    stepped extension (the rebuilt board's rows 0..H-1)."""
    ref = next(p for p in board.shards if p is not None)
    R, wp = ref.shape[-2], ref.shape[-1]
    boxes = []
    for pos in range(board.mesh.size):
        lo = max(1, pos * R) - pos * R + 1
        hi = min(height + 1, (pos + 1) * R) - pos * R + 1
        boxes.append((lo, max(lo, hi), 0, wp))
    return boxes


def _extended(board: ShardedBoard, num_turns: int, rule, height: int,
              repr_: str, count=None) -> ShardedBoard:
    for turn in range(num_turns):
        last = turn == num_turns - 1
        counting = count is not None and last
        stepped = _ring_macro(
            board, repr_, 1, rule, count if counting else None,
            _count_boxes(board, height) if counting else None)
        board = _rebuild(stepped, height)
    return board


def extended_run_turns(board: ShardedBoard, num_turns: int, mesh,
                       rule=CONWAY, *, height: int, ext: int, packed,
                       count=None) -> ShardedBoard:
    """Advance a wrap-extended board (module note above): the exact
    shard count for heights the mesh does not divide, a turn at a time.
    `packed`: a repr tag per `_ext_repr`. `count` (packed, gen3) takes
    each shard's live cells of the true rows only."""
    if ext < 2:
        raise ValueError(f"wrap extension needs ext >= 2, got {ext}")
    return _extended(board, num_turns, rule, height, _ext_repr(packed),
                     count)


def mesh_run_fn(repr_: str, fuse: int = 0, height: int = 0,
                ext: int = 0):
    """The engine's `(board, num_turns, rule, *, count=None)` run of a
    `ShardedBoard` of `repr_` — the sharded runs' inner halves, with no
    telemetry of their own: the engine accounts halo traffic per chunk.
    `ext` > 0 selects the exact-N path for a board of `height` rows."""
    if ext:
        return functools.partial(_extended, height=height, repr_=repr_)
    if repr_ == "packed":
        return functools.partial(_sharded_packed, fuse=fuse)
    if repr_ == "gen3":
        return _sharded_gen3

    def run(board, num_turns, rule, *, count=None):
        return _sharded_turns(board, repr_, num_turns, rule, count)

    return run
