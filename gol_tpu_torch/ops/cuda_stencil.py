"""Hopper kernels for multi-turn packed stepping — the counterpart of
`gol_tpu/ops/pallas_stencil.py` — with their plain torch versions.

Each wrapper launches its CUDA kernel (`csrc/stencil.cu`) for a tensor on
a CUDA device, or raises; for a tensor on the CPU it runs the kernel's
plain version, which follows the kernel's decomposition. Each counts its
launches in a `launches` attribute. Words are the int32 carrier of
`ops/bitpack.py`; the kernels read them as uint32.

K1 `resident_run_turns` replaces `pallas_packed_run_turns`
(pallas_stencil.py:508). The TPU keeps the whole board in VMEM and runs
K turns in one call; here one thread-block cluster of N CTAs (up to 16,
H100's largest) keeps it in shared memory, each CTA a slab of
floor(h/N) or ceil(h/N) rows in two buffers, and runs K turns. The rows
above and below a slab are read from the neighbouring CTAs' shared
memory (DSMEM), ranks modulo N, with one split cluster barrier a turn
(`csrc/stencil.cu` says why that is safe). Bound: 30 shift/logic ops
per word per turn (`OPS_PER_WORD_TURN`) against the 32-bit logic issue
rate; a cluster uses at most 16 of the card's 132 SMs. It takes every
board up to `RESIDENT_BOARD_BYTES` packed (512² is 32 KiB), Wp = 1
(a word's west and east neighbours are itself) and heights N does not
divide. `resident_cluster_ctas` and `resident_rows_per_thread` choose N
and the rows each thread walks from the shape; a cluster the card
cannot place raises (no retry at N = 1).

K2 `tiled_sweep` replaces `_banded_pass` (pallas_stencil.py:388). A
full-width band does not fit Hopper's 227 KB of shared memory (one
65536-wide row is 8 KB), so each block takes a 2-D tile: R rows x
C = 62 words of output, from a window of (R + 2T) x (C + 2) words loaded
with indices modulo the board, stepped T <= 32 turns in shared memory.
R is one of `TILE_ROW_CHOICES`, picked by `tile_rows` from the shape so
that small boards still fill the card's 132 SMs. Each turn computes only
the rows still exact, so the work done is (R + T - 1)(C + 2) / (R C)
times the useful work: 1.12 at R = 384, T = 32, 1.28 at R = 128. Bound: a
sweep reads and writes each word once (8 bytes) and spends 32 x 30 ops
on it, so the ops, not the 3.35 TB/s of memory, bound it.
`banded_run_turns` runs floor(K/32) sweeps at T = 32 and one at
T = K mod 32; every depth 1..32 is legal, so the TPU's 8-aligned
remainder and jnp-scan fallbacks have no counterpart.

K6 `tiled_sweep_deep`, driven by `fused_banded_run_turns`, replaces
`fused_banded_run_turns` (pallas_stencil.py:474): `_banded_pass` at the
pinned fuse depth k (`ops/fused.py`, k <= 64) instead of 32. A sweep of
depth T needs T cells of horizontal halo, so K2's one halo word stops at
T = 32; K6 is the same CUDA template with two halo words: R = 320 x C =
60-word output tiles from (R + 2T) x 64-word windows, T <= 64 (two
buffers at T = 64 use 229,376 of 232,448 bytes). Its work is
(R + T - 1)(C + 4) / (R C) = 1.28 times the useful work at T = 64, against
K2's 1.12 at T = 32, so one 64-deep sweep spends more ops than two K2
sweeps; what it saves is a read and a write of the board (8 bytes per
word). Bound: the ops, as for K2. `fused_banded_run_turns` runs
floor(n/k) sweeps at depth k and one at n mod k, each on K2 when its
depth is at most 32 and on K6 beyond; every depth 1..64 is legal, so the
TPU's remainder fallbacks (the VMEM kernel, the jnp trim scan) have no
counterpart.

The engine's alive token rides the stepping launch: K1, K2, K6, K4 and
K5 take `count=`, one int64 on the board's device, which the launch sets
to the live cells of the words it stores (plane 0, gen3's alive plane):
a 32-bit `__popc` sum in each block's shared memory, then one 64-bit
atomic a block (a 65536² board holds 2^32 cells). The run functions
(`banded_run_turns`, `fused_banded_run_turns`, `banded_run_turns2p`)
count in their last sweep. Their plain versions fill it with
`row_popcounts_plain(out).sum()`. On the CPU the count is ready when
the call returns; gen4 takes none (its plane 0 is not alive).

K3 `row_popcounts` counts live cells per row with `__popc` (one warp per
row); the JAX package leaves that reduction to XLA
(`engine.py:158-160`). The engine's chunks no longer call it: a
standalone launch is floored at ~1-2 µs on the card and ~20 µs of host
(ctypes, the stream, its output) against a bound of nanoseconds below
5120², so the count moved into the stepping launch. K3 serves the counts
of boards no chunk just stepped (a restore, `GenerationsTorus`). Bound:
one read of the board at 3.35 TB/s.

K4 `resident_run_turns2p` and K5 `tiled_sweep2p` (driven by
`banded_run_turns2p`) replace `pallas_packed_run_turns3`
(pallas_stencil.py:274) and `pallas_packed_run_turns4` (:296), the one
TPU design `_make_kernel2p` run with two plane transitions. Each takes
stacked (2, H, Wp) planes and a `family`: "gen3" (alive, dying planes)
or "gen4" (binary-encoded states), a template argument of the CUDA
kernel. Per word and turn the two-plane network spends
`OPS_PER_WORD_TURN_2P` ops: the 11-op count, 18 muxes of two trees (born
from the unshifted leaves, survive from the leaves shifted by one for
the self-inclusive count) and the transition, 3 ops for gen3 and 3 + 3
for gen4 (alive = b0 & ~b1 of each of the three words a row load reads).
Bound: the ops, at 16.7e12 ops/s, beside 16 bytes per word per sweep
(both planes read and written) at 3.35 TB/s. Both run K1's and K2's
CUDA templates with a two-plane family, so they share the lean loop
(`step_rows`). K4 is K1 with two planes: one cluster of N CTAs, each a
slab of both planes in two buffers, the neighbours' edge rows of both
planes read through DSMEM, one split cluster barrier a turn. Its planes
are routed to it up to `RESIDENT2P_PLANE_BYTES` = 58,112 bytes each
(four board-sized buffers in one CTA; 512² is 32 KiB), and Wp = 1 is
taken (the TPU's wp >= 2 gate has no counterpart). A one-CTA turn costs
K1's 30 ops plus a second tree and plane, but a cluster turn has a floor
near 1 µs, so `resident2p_cluster_ctas` keeps N = 1 below
`RESIDENT2P_CLUSTER_MIN_WORDS` words. K5 is K2 with two planes: two
planes x two buffers of an (R + 2T) x 64-word window must fit 232,448
bytes, so R + 2T <= 227, R in `TILE2P_ROW_CHOICES` at T <= 32, picked by
`tile2p_rows` as `tile_rows` picks K2's: at 4096² 96-row tiles give 129
blocks in one wave (160-row tiles gave 78 on 132 SMs), at 16384² 161-row
tiles 918 blocks in 7 waves (160: 927 in 8). The work done is
(R + T - 1)(C + 2) / (R C) times the useful work: 1.23 at R = 161, 1.36
at R = 96, T = 32. Families run as separate instantiations, so the
launch count is kept per family too (`by_family`).

K9 `fleet_run_turns` steps the fleet's buckets: what
`step_program(rule, turns)` of `gol_tpu/fleet/buckets.py` (:149-170)
computes, `turns` life-like torus turns of every slot of a (cap, hb, wpb)
packed batch, each slot its own torus, and each slot's popcount as int32
(cap,) — which the JAX package leaves to XLA as a jnp scan. One wrapper
call steps every slot, so a serving quantum costs one wrapper's host time
whatever the bucket's capacity (a loop of K1 calls over 512 slots would
pay it 512 times). Two routes, chosen from the shape alone
(`fleet_run_kind`): route 1 is K1 with a slot axis in the grid, for
every slot whose two buffers fit a cluster of at most 16 CTAs
(`fleet_slot_ctas`: the 512², 1024² and 2048² classes). Each slot is
read and written once a quantum, its slabs' edge rows go through DSMEM,
and no column is computed twice; route 2 at 1024² and 2048² computed
64-word windows for 32- and 64-word slots, about twice the useful work.
`fleet_resident_ctas` gives a slot K1's cluster for its shape, halved
while the batch's CTAs would outnumber the card's SMs, but never below
the fewest that hold the slot (1 at 512², 2 at 1024², 8 at 2048²); slots
need not run at once, so a larger batch runs in waves (the card places 7
clusters of 16 whole-SM CTAs at once: 8 slots of 2048² take two).
Route 2, for slots beyond a cluster (4096² up; `kind="tiled"` pins it),
is K2's sweep with the slot in the grid's z axis, one sweep per 32
turns, at `fleet_tile_rows` (K2's rule counted over the batch's blocks).
Each counts the live cells it writes after its last turn and adds them
to the slot's int32 with integer atomics, exact in any order; route 1's
groups zero their own count before their first barrier, route 2's is
zeroed on the stream. A quantum's launch repeats no set-up once its
geometry was seen: `cudaFuncSetAttribute` and the cluster placement
check are kept per kernel and geometry in the library, and the Python
geometry per batch shape (`_fleet_geometry`). The fleet quarantines a slot whose count lies
outside [0, hb x wb]. Bound: the ops, 30 per word and turn, against 8
bytes a word per launch. Its plain version, `fleet_run_turns_plain`,
follows each route's decomposition on the batch axis.

No single PyTorch call computes a packed life-like or Generations step,
so no library call stands beside K1, K2, K4, K5, K6 or K9.

K7 runs Larger-than-Life turns of a Moore-box rule (`R<r>,...,NM`) on a
uint8 {0,1} torus: what `_ltl_step(cells, rule, "conv")` of
`gol_tpu/ops/conv.py` computes, the box path of `_conv_sum` (:218) and
the interval tests, which the JAX package leaves to XLA as 4r + 2 rolled
float32 passes (no Pallas kernel). `ltl_box_run_turns` is its entry, with
two routes chosen from (h, w, r) alone, as K1 and K2 split B1/B2. Both
count the box as vertical running sums of 2r + 1 cells, four columns to
a 32-bit word of byte lanes (16-bit lanes at r = 128, whose 257 cells
pass a byte), then horizontal running sums of those (32-bit), rows and
columns by true modulo (a board narrower or shorter than 2r + 1 counts
each offset as often as the rolls do), and read the next state from one
table indexed by the cell and its box count (`ltl_table`: the rule's
`luts()` with M0's "minus the cell" folded in; bytes up to r = 64, bits
beyond).
Route 1, `ltl_resident_run_turns`: a board whose slab of cells (two
buffers), vertical sums and table fit a CTA of a 16-CTA cluster
(`ltl_resident_ctas`: 512² at every r, 1024² below r = 128; one CTA up to
64²) runs a whole chunk in one launch. Each CTA holds whole rows; a turn
takes the vertical sums of its rows from the cells of whichever CTAs own
the 2r + 1 rows around them (DSMEM), then the horizontal sums and the
rule into its other buffer, and one cluster barrier. Its plain version
(`ltl_resident_run_turns_plain`) follows the slabs and the owners' rows.
Bound: one read and write of the board a chunk; the ops
(`LTL_OPS_PER_CELL` a cell and turn) set it, on at most 16 SMs.
Route 2, `ltl_box_run_turns` on any other board: one launch a turn, all
issued by one C call that ping-pongs two buffers the wrapper allocates,
a block a `tile`² tile (`ltl_tile`): the window in 16-byte loads away
from the torus seam, the vertical then horizontal sums and the rule in
shared memory, the outputs staged and stored 16 bytes a lane. Bound: one
read and one write of the board, 2 bytes a cell at 3.35 TB/s. Its plain
version is `_ltl_step` of `ops/conv.py` on the conv tier
(`ltl_box_run_turns_plain`). The library call that computes the same
counts is `F.conv2d` of the wrap-padded float32 board with a ones kernel
(timed in `chip_smoke.py`, never called by the port). The engine's gate
is the rule's kind alone (`ops/conv.ltl_run_fn`).

K8 `window_occupancy` is the sparse torus's occupancy (`models/sparse.py`):
`_occupancy` of `gol_tpu/models/sparse.py` (:106-112), which the JAX
package leaves to XLA (PyTorch has no popcount op). One launch on the
engine's stream counts an (H, Wp) window into one (H + Wp,) int32 buffer,
the live cells of each row and then of each word column, so a single
copy brings both to the host. Blocks of
32 rows x 128 words add each word's popcount, read as uint32, into its
column and, summed over a warp, into its row; integer atomics merge the
blocks, exact in any order, and are skipped where a count is 0. Bound:
one read of the window and one write of the counts, (H Wp + H + Wp) x 4
bytes at 3.35 TB/s. No PyTorch call computes a popcount, so no library
call stands beside it.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from gol_tpu_torch.models.lifelike import CONWAY, LifeLikeRule
from gol_tpu_torch.ops import _build
from gol_tpu_torch.ops.bitpack import (
    WORD_BITS,
    _full_add,
    _rule_from_count_bits,
    _shr,
    combine_count_columns,
    gen3_transition,
    gen4_transition,
    row_popcounts_plain,
    rule_masks,
)

# Shared memory a block can use on Hopper (232,448 bytes); K1 holds two
# copies of the board (spread over its cluster).
SMEM_BYTES = 232_448
RESIDENT_BOARD_BYTES = SMEM_BYTES // 2
# SMs of the H100 the geometry policies below fill.
CARD_SMS = 132
# K1: CTAs in its cluster (H100 places at most 16), threads per CTA
# (csrc/stencil.cu checks both).
RESIDENT_MAX_CTAS = 16
RESIDENT_THREADS = 1024
# K1 policy (measured on the card, PERF.md): a cluster pays once a CTA's
# turn outweighs the cluster barrier (~1 µs a turn), from 2048 words
# (256²) up; a thread walks the most rows, up to RESIDENT_MAX_PER, that
# still leave a CTA RESIDENT_MIN_THREADS threads (a warp for each of the
# SM's four schedulers); odd walks keep the slots that share a warp on
# distinct shared-memory banks.
RESIDENT_CLUSTER_MIN_WORDS = 2048
RESIDENT_MIN_THREADS = 128
RESIDENT_MAX_PER = 9
# K8: rows a block counts (csrc/stencil.cu kOccRows; the grid's y extent
# caps a window at 65535 of them).
OCC_ROWS = 32
# K2 geometry, mirrored from csrc/stencil.cu (checked at load).
TILE_MAX_T = 32
TILE_ROW_CHOICES = (384, 128)
TILE_WORDS = 62
# K6 geometry: two halo words a side (checked at load).
DEEP_MAX_T = 64
DEEP_ROWS = 320
DEEP_WORDS = 60
# Shift/logic operations per word per turn of the kernels' network: 11
# for the self-inclusive count, 19 for the rule (csrc/stencil.cu).
OPS_PER_WORD_TURN = 30
# K4: the planes it is routed (four board-sized planes, two planes
# ping-pong, fit one CTA), and threads per CTA (csrc/stencil.cu checks
# it: two planes need more registers than 1024 threads leave).
RESIDENT2P_PLANE_BYTES = SMEM_BYTES // 4
RESIDENT2P_THREADS = 512
# K4 policy (measured on the card, PERF.md): a cluster pays from 2048
# words a plane (256²: 16 CTAs beat one), not at 512 (128²: one CTA
# beats every cluster); rows per thread by K1's rule, which K4's timings
# at 512² bear out.
RESIDENT2P_CLUSTER_MIN_WORDS = 2048
# K5 output rows per tile, mirrored from csrc/stencil.cu (checked at load).
TILE2P_ROW_CHOICES = (161, 96)
# The two-plane families and their codes in the C interface.
FAMILIES = {"gen3": 3, "gen4": 4}
# Ops per word per turn of the two-plane network (module note).
OPS_PER_WORD_TURN_2P = {"gen3": 11 + 18 + 3, "gen4": 11 + 18 + 3 + 3}


def _self_inclusive_count_bits(p: torch.Tensor, word_axis: int,
                               row_axis: int):
    """4 bit-planes of the self-inclusive 9-cell count n9 = n8 + self:
    hs = west + self + east per cell (bit pair hs0/hs1), then the vertical
    full adder over (row-1, row, row+1) of hs — the network of
    `gol_tpu.ops.pallas_stencil._self_inclusive_count_bits` and of the
    CUDA kernels."""
    shift = WORD_BITS - 1
    west = (p << 1) | _shr(torch.roll(p, 1, dims=word_axis), shift)
    east = _shr(p, 1) | (torch.roll(p, -1, dims=word_axis) << shift)
    hs0, hs1 = _full_add(west, p, east)
    u0, u1 = _full_add(torch.roll(hs0, 1, dims=row_axis), hs0,
                       torch.roll(hs0, -1, dims=row_axis))
    v0, v1 = _full_add(torch.roll(hs1, 1, dims=row_axis), hs1,
                       torch.roll(hs1, -1, dims=row_axis))
    return combine_count_columns(u0, u1, v0, v1)


def _step_shared_sums(p: torch.Tensor, rule: LifeLikeRule) -> torch.Tensor:
    """One life-like torus turn on (..., rows, words) with the shared
    horizontal-sum network."""
    n0, n1, n2, n3 = _self_inclusive_count_bits(p, -1, -2)
    return _rule_from_count_bits(p, n0, n1, n2, n3, rule, count_offset=1)


def fits_resident(shape) -> bool:
    h, wp = shape[-2], shape[-1]
    return h * wp * 4 <= RESIDENT_BOARD_BYTES


def fits_resident2p(shape) -> bool:
    """Whether each plane of a (2, H, Wp) pair fits K4."""
    h, wp = shape[-2], shape[-1]
    return h * wp * 4 <= RESIDENT2P_PLANE_BYTES


def cuda_probe() -> str:
    """What this host offers the kernels: CUDA, the device and its
    compute capability, the driver, and nvcc. For error messages."""
    parts = [f"torch {torch.__version__} (CUDA {torch.version.cuda})"]
    if torch.cuda.is_available():
        cap = torch.cuda.get_device_capability(0)
        parts.append(f"device {torch.cuda.get_device_name(0)} "
                     f"sm_{cap[0]}{cap[1]}")
    else:
        parts.append("no CUDA device")
    try:
        version = ctypes.c_int()
        ctypes.CDLL("libcuda.so.1").cuDriverGetVersion(
            ctypes.byref(version))
        parts.append(f"driver API {version.value}")
    except OSError:
        parts.append("no CUDA driver")
    try:
        parts.append(f"nvcc {_build.find_nvcc()}")
    except RuntimeError:
        parts.append("no nvcc")
    return ", ".join(parts)


@functools.lru_cache(maxsize=None)
def _library():
    """The kernel library (built on first use), once its tile geometry
    is checked against the Python mirror above."""
    lib = _build.library()
    max_t, words = ctypes.c_int(), ctypes.c_int()
    rows = (ctypes.c_int * 8)()
    n = lib.gol_tile_geometry(ctypes.byref(max_t), ctypes.byref(words), rows,
                              len(rows))
    got = (max_t.value, words.value, tuple(rows[:n]))
    deep = [ctypes.c_int() for _ in range(3)]
    lib.gol_deep_geometry(*[ctypes.byref(v) for v in deep])
    got += tuple(v.value for v in deep)
    n = lib.gol_tile2p_rows(rows, len(rows))
    got += (tuple(rows[:n]),)
    ltl = [(1, 5, 64, 65, 128), ((128, 5), (64, 128), (32, 65)),
           ((512, 512, 5, 16), (512, 512, 128, 16), (1000, 777, 64, 16),
            (16, 16, 10, 1))]
    got += (tuple(lib.gol_ltl_table_bytes(r) for r in ltl[0]),
            tuple(lib.gol_ltl_tile_smem_bytes(*a) for a in ltl[1]),
            tuple(lib.gol_ltl_resident_smem_bytes(*a) for a in ltl[2]))
    want = (TILE_MAX_T, TILE_WORDS, TILE_ROW_CHOICES, DEEP_MAX_T, DEEP_ROWS,
            DEEP_WORDS, TILE2P_ROW_CHOICES,
            tuple(ltl_table_bytes(r) for r in ltl[0]),
            tuple(ltl_tile_smem_bytes(*a) for a in ltl[1]),
            tuple(ltl_resident_smem_bytes(*a) for a in ltl[2]))
    if got != want:
        raise RuntimeError(f"kernel tile geometry {got} != the Python "
                           f"mirror {want}")
    return lib


@functools.lru_cache(maxsize=64)
def _masks(rule) -> tuple:
    """The rule's (born, survive) masks, once per rule."""
    return rule.masks()


def _check_count(count, words: torch.Tensor, num_turns: int,
                 what: str) -> None:
    """Raise unless `count` is None or a one-element int64 tensor on the
    board's device, given with at least one turn to ride on."""
    if count is None:
        return
    if (count.dtype != torch.int64 or count.numel() != 1
            or count.device != words.device or not count.is_contiguous()):
        raise ValueError(f"{what}: count= wants a one-element int64 tensor "
                         f"on {words.device}, got {count.dtype} "
                         f"{tuple(count.shape)} on {count.device}")
    if num_turns < 1:
        raise ValueError(f"{what}: count= rides a launch; {num_turns} "
                         "turns launch none")


def _box_args(box, words: torch.Tensor) -> tuple:
    """The counted box (rows r0:r1, words c0:c1 of the result) as the
    entry points take it; the whole board when None. A sharded board's
    window counts only its shard (`parallel/halo.py`)."""
    h, wp = words.shape[-2:]
    if box is None:
        return (0, h, 0, wp)
    r0, r1, c0, c1 = (int(v) for v in box)
    if not (0 <= r0 <= r1 <= h and 0 <= c0 <= c1 <= wp):
        raise ValueError(f"count box {box} outside a {h}x{wp} board")
    return (r0, r1, c0, c1)


def _count_plain(count, words: torch.Tensor, box=None) -> None:
    """The counted launch's plain version: the live cells of an (H, Wp)
    board, or of plane 0 of stacked planes, within `box`, into `count`."""
    if count is not None:
        plane = words[0] if words.dim() == 3 else words
        r0, r1, c0, c1 = _box_args(box, plane)
        count.copy_(row_popcounts_plain(
            plane[r0:r1, c0:c1].contiguous()).sum(
                dtype=torch.int64).reshape(count.shape))


def _ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def _kernel_args(words: torch.Tensor, what: str, planes: bool = False):
    """Validate a CUDA words tensor, (H, Wp) or with `planes` a stacked
    (2, H, Wp) pair; return (lib, h, wp, device, stream)."""
    want = "(2, H, Wp)" if planes else "2-D"
    if (words.dtype != torch.int32 or words.dim() != (3 if planes else 2)
            or (planes and words.shape[0] != 2)):
        raise ValueError(f"{what}: want {want} int32 words, got "
                         f"{words.dtype} {tuple(words.shape)}")
    if not words.is_contiguous():
        raise ValueError(f"{what}: words must be contiguous")
    h, wp = words.shape[-2:]
    stream = torch.cuda.current_stream(words.device).cuda_stream
    return _library(), h, wp, words.device.index, stream


# ------------------------------------------------------------------- K1

def _cluster_ctas(h: int, wp: int, min_words: int) -> int:
    """One CTA below `min_words` words, else the largest cluster the
    board's rows allow, min(16, h)."""
    if h * wp < min_words:
        return 1
    return min(RESIDENT_MAX_CTAS, h)


def resident_cluster_ctas(h: int, wp: int) -> int:
    """K1's cluster size N for an (h, wp) board: one CTA below
    `RESIDENT_CLUSTER_MIN_WORDS` words, else min(16, h)."""
    return _cluster_ctas(h, wp, RESIDENT_CLUSTER_MIN_WORDS)


def _resident_slots(h: int, ctas: int, per: int) -> int:
    """Thread slots of a K1 or K4 CTA: the slab's first and last rows,
    then its interior rows `per` to a slot (as `run_resident` in
    csrc/stencil.cu)."""
    inner = -(-h // ctas) - 2
    return 2 + (-(-inner // per) if inner > 0 else 0)


def _resident_threads(h: int, wp: int, ctas: int, per: int,
                      max_threads: int = RESIDENT_THREADS) -> int:
    """Threads of a K1 or K4 CTA: a lane per column, up to `max_threads`
    in all."""
    slots = _resident_slots(h, ctas, per)
    return min(wp, max_threads // slots) * slots


def _rows_per_thread(h: int, wp: int, ctas: int, min_threads: int,
                     max_per: int, max_threads: int) -> int:
    """The most interior rows a thread walks (odd), up to `max_per`, that
    leave a CTA `min_threads` threads, or more where `max_threads` threads
    could not hold the slab otherwise."""
    per = 1
    while (per + 2 <= max_per and _resident_threads(
            h, wp, ctas, per + 2, max_threads) >= min_threads):
        per += 2
    while _resident_slots(h, ctas, per) > max_threads:
        per += 2
    return per


def resident_rows_per_thread(h: int, wp: int, ctas: int) -> int:
    """Interior rows each K1 thread walks (odd): the most, up to
    `RESIDENT_MAX_PER`, that leave a CTA `RESIDENT_MIN_THREADS` threads,
    or more where 1024 threads could not hold the slab otherwise."""
    return _rows_per_thread(h, wp, ctas, RESIDENT_MIN_THREADS,
                            RESIDENT_MAX_PER, RESIDENT_THREADS)


def _check_resident_geometry(h: int, ctas: int, per: int | None,
                             what: str = "resident_run_turns",
                             max_threads: int = RESIDENT_THREADS) -> None:
    """Raise on a cluster size, or (unless None) rows per thread, that K1
    (or K4, with its `max_threads`) does not take."""
    if not 1 <= ctas <= min(RESIDENT_MAX_CTAS, h):
        raise ValueError(f"{what}: {ctas} CTAs not in "
                         f"1..{min(RESIDENT_MAX_CTAS, h)} for {h} rows")
    if per is not None and (per < 1 or _resident_slots(h, ctas, per)
                            > max_threads):
        raise ValueError(f"{what}: {per} rows per thread needs more than "
                         f"{max_threads} threads a CTA")


def _slab_starts(h: int, ctas: int) -> list:
    """First row of each CTA's slab, and h (csrc/stencil.cu:slab_start)."""
    return [i * h // ctas for i in range(ctas + 1)]


def _slab_plain(words: torch.Tensor, num_turns: int, step,
                ctas: int) -> torch.Tensor:
    """K1's and K4's plain version on the kernel's slabs: each turn
    `step`s every CTA's window, rows a_i - 1 .. a_{i+1} modulo h of every
    plane, as a torus of its own (one batch) and keeps each slab."""
    h = words.shape[-2]
    starts = _slab_starts(h, ctas)
    dev = words.device
    span = -(-h // ctas) + 2
    first = torch.tensor(starts[:-1], device=dev)
    window = (first[:, None] - 1 + torch.arange(span, device=dev)) % h
    lengths = torch.tensor([b - a for a, b in zip(starts, starts[1:])],
                           device=dev)
    slab = torch.repeat_interleave(torch.arange(ctas, device=dev), lengths)
    row = 1 + torch.arange(h, device=dev) - first[slab]
    for _ in range(num_turns):
        stepped = step(words[..., window, :])
        words = stepped[..., slab, row, :]
    return words


def resident_run_turns_plain(words: torch.Tensor, num_turns: int,
                             rule: LifeLikeRule = CONWAY,
                             ctas: int | None = None) -> torch.Tensor:
    """K1's plain version on the kernel's slabs (`_slab_plain`). N is
    `resident_cluster_ctas`'s unless `ctas` is given."""
    h, wp = words.shape[-2:]
    if ctas is None:
        ctas = resident_cluster_ctas(h, wp)
    _check_resident_geometry(h, ctas, None)
    return _slab_plain(words, num_turns,
                       lambda w: _step_shared_sums(w, rule), ctas)


def _cluster_failed(what: str, lib, rc: int, ctas: int, h: int,
                    wp: int) -> RuntimeError:
    return RuntimeError(
        f"{what}: a cluster of {ctas} CTAs for {h}x{wp} words failed: CUDA "
        f"error {rc} ({lib.gol_error_string(rc).decode()}); {cuda_probe()}")


def resident_run_turns(words: torch.Tensor, num_turns: int,
                       rule: LifeLikeRule = CONWAY, *,
                       ctas: int | None = None,
                       per: int | None = None,
                       count: torch.Tensor | None = None,
                       box=None) -> torch.Tensor:
    """Advance an (H, Wp) packed board that fits `RESIDENT_BOARD_BYTES`
    `num_turns` turns in one launch of K1, on a cluster of `ctas` CTAs
    whose threads walk `per` rows (by default the shape's policy). With
    `count` (one int64 on the board's device) the launch also sets it to
    the result's live cells, those of rows r0:r1 and words c0:c1 when
    `box` = (r0, r1, c0, c1) is given."""
    _check_count(count, words, num_turns, "resident_run_turns")
    if num_turns == 0:
        return words
    h, wp = words.shape[-2:]
    if ctas is None:
        ctas = resident_cluster_ctas(h, wp)
    if per is None:
        per = resident_rows_per_thread(h, wp, ctas)
    _check_resident_geometry(h, ctas, per)
    if words.device.type == "cpu":
        out = resident_run_turns_plain(words, num_turns, rule, ctas)
        _count_plain(count, out, box)
        return out
    lib, h, wp, dev, stream = _kernel_args(words, "resident_run_turns")
    if not fits_resident(words.shape):
        raise ValueError(f"resident_run_turns: board {h}x{wp} words "
                         f"exceeds {RESIDENT_BOARD_BYTES} bytes")
    out = torch.empty_like(words)
    born, survive = _masks(rule)
    rc = lib.gol_resident_run_turns(
        words.data_ptr(), out.data_ptr(), _ptr(count), h, wp, num_turns,
        born, survive, ctas, per, dev, stream, *_box_args(box, words))
    if rc:
        raise _cluster_failed("resident_run_turns", lib, rc, ctas, h, wp)
    resident_run_turns.launches += 1
    return out


resident_run_turns.launches = 0


# ------------------------------------------------------------ K2 and K6

def _fewest_window_rows(h: int, wp: int, choices, slots: int = 1) -> int:
    """The tile height whose busiest SM computes the fewest window rows
    at T = 32: ceil(blocks / 132) blocks of R + 31 rows each (the rows
    [turn, R + 2T - turn) over T turns; two blocks sharing an SM take as
    long as two in turn; the larger R on a tie), over `slots` boards."""
    cols = -(-wp // TILE_WORDS)
    return min(choices, key=lambda rows: -(
        -slots * cols * -(-h // rows) // CARD_SMS) * (rows + TILE_MAX_T - 1))


def tile_rows(h: int, wp: int) -> int:
    """K2's output rows per tile for an (h, wp) board, one of
    `TILE_ROW_CHOICES` (`_fewest_window_rows`)."""
    return _fewest_window_rows(h, wp, TILE_ROW_CHOICES)


def _window_indices(n: int, tiles: int, step: int, halo: int, span: int,
                    device) -> torch.Tensor:
    """(tiles, span) indices modulo n of each tile's window."""
    starts = torch.arange(tiles, device=device) * step - halo
    return (starts[:, None] + torch.arange(span, device=device)) % n


def _tiled_plain(words: torch.Tensor, t: int, step, rows: int,
                 out_words: int, halo: int) -> torch.Tensor:
    """The tiled kernels' plain version on (..., H, Wp) words (K5: the
    stacked planes): gather every tile's (R + 2t) x (C + 2 halo) window
    with modular indices (one batch, no loop over tiles), `step` the
    windows t turns as tori of their own (their edges go wrong, as the
    kernel's do), keep each exact R x C interior and reassemble the
    board."""
    h, wp = words.shape[-2:]
    tr, tc = -(-h // rows), -(-wp // out_words)
    r = _window_indices(h, tr, rows, t, rows + 2 * t, words.device)
    c = _window_indices(wp, tc, out_words, halo, out_words + 2 * halo,
                        words.device)
    win = words[..., r[:, None, :, None], c[None, :, None, :]]
    for _ in range(t):
        win = step(win)
    core = win[..., t:t + rows, halo:halo + out_words].transpose(-3, -2)
    return core.reshape(*words.shape[:-2], tr * rows, tc * out_words)[
        ..., :h, :wp].contiguous()


def tiled_sweep_plain(words: torch.Tensor, t: int,
                      rule: LifeLikeRule = CONWAY,
                      rows: int | None = None) -> torch.Tensor:
    """K2's plain version: R x 62-word tiles (R = `tile_rows`'s unless
    given), one halo word a side."""
    if rows is None:
        rows = tile_rows(*words.shape)
    return _tiled_plain(words, t, lambda w: _step_shared_sums(w, rule),
                        rows, TILE_WORDS, 1)


def tiled_sweep_deep_plain(words: torch.Tensor, t: int,
                           rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """K6's plain version: 320 x 60-word tiles, two halo words a side."""
    return _tiled_plain(words, t, lambda w: _step_shared_sums(w, rule),
                        DEEP_ROWS, DEEP_WORDS, 2)


def _check_sweep(what: str, words_in: torch.Tensor,
                 words_out: torch.Tensor, t: int, max_t: int) -> None:
    if not 1 <= t <= max_t:
        raise ValueError(f"{what} depth {t} not in 1..{max_t}")
    if words_out.shape != words_in.shape or words_out is words_in:
        raise ValueError(f"{what} needs a distinct output board of the "
                         "input's shape")


def _sweep_launch_args(what: str, words_in: torch.Tensor,
                       words_out: torch.Tensor, rows: int,
                       planes: bool = False):
    """`_kernel_args` for a sweep, with its output and grid checked."""
    lib, h, wp, dev, stream = _kernel_args(words_in, what, planes)
    if (words_out.dtype != torch.int32 or not words_out.is_contiguous()
            or words_out.device != words_in.device):
        raise ValueError(f"{what}: output must be contiguous int32 on the "
                         "input's device")
    if -(-h // rows) > 65535:
        raise ValueError(f"{what}: {h} rows exceed the launch grid")
    return lib, h, wp, dev, stream


def tiled_sweep(words_in: torch.Tensor, words_out: torch.Tensor, t: int,
                rule: LifeLikeRule = CONWAY, *,
                rows: int | None = None,
                count: torch.Tensor | None = None, box=None) -> None:
    """Advance `words_in` t (1..32) turns into `words_out` in one K2
    sweep of R-row tiles (R = `tile_rows`'s unless `rows` is given); with
    `count`, also its live cells (within `box`, as
    `resident_run_turns`)."""
    _check_sweep("tiled_sweep", words_in, words_out, t, TILE_MAX_T)
    _check_count(count, words_in, t, "tiled_sweep")
    if rows is not None and rows not in TILE_ROW_CHOICES:
        raise ValueError(f"tiled_sweep: {rows} rows per tile not in "
                         f"{TILE_ROW_CHOICES}")
    if words_in.device.type == "cpu":
        words_out.copy_(tiled_sweep_plain(words_in, t, rule, rows))
        _count_plain(count, words_out, box)
        return
    if rows is None:
        rows = tile_rows(*words_in.shape)
    lib, h, wp, dev, stream = _sweep_launch_args(
        "tiled_sweep", words_in, words_out, rows)
    born, survive = _masks(rule)
    _build.check(lib.gol_tiled_sweep(
        words_in.data_ptr(), words_out.data_ptr(), _ptr(count), h, wp, t,
        rows, born, survive, dev, stream, *_box_args(box, words_in)),
        "tiled_sweep")
    tiled_sweep.launches += 1


tiled_sweep.launches = 0


def tiled_sweep_deep(words_in: torch.Tensor, words_out: torch.Tensor,
                     t: int, rule: LifeLikeRule = CONWAY, *,
                     count: torch.Tensor | None = None, box=None) -> None:
    """Advance `words_in` t (1..64) turns into `words_out` in one K6
    sweep; with `count`, also its live cells (within `box`)."""
    _check_sweep("tiled_sweep_deep", words_in, words_out, t, DEEP_MAX_T)
    _check_count(count, words_in, t, "tiled_sweep_deep")
    if words_in.device.type == "cpu":
        words_out.copy_(tiled_sweep_deep_plain(words_in, t, rule))
        _count_plain(count, words_out, box)
        return
    lib, h, wp, dev, stream = _sweep_launch_args(
        "tiled_sweep_deep", words_in, words_out, DEEP_ROWS)
    born, survive = _masks(rule)
    _build.check(lib.gol_tiled_sweep_deep(
        words_in.data_ptr(), words_out.data_ptr(), _ptr(count), h, wp, t,
        born, survive, dev, stream, *_box_args(box, words_in)),
        "tiled_sweep_deep")
    tiled_sweep_deep.launches += 1


tiled_sweep_deep.launches = 0


def sweep_depths(num_turns: int, depth: int) -> list:
    """floor(n/depth) sweeps at `depth`, then one at n mod depth."""
    full, rem = divmod(num_turns, depth)
    return [depth] * full + ([rem] if rem else [])


def _run_sweeps(words: torch.Tensor, depths, sweep, count, *args,
                box=None) -> torch.Tensor:
    """One `sweep(src, dst, depth, *args)` per depth, alternating between
    two fresh buffers, the last one counting into `count` (within `box`);
    the input is never written."""
    bufs = []
    src = words
    for i, depth in enumerate(depths):
        if len(bufs) < 2:
            bufs.append(torch.empty_like(words))
        dst = bufs[i % 2]
        last = i == len(depths) - 1
        sweep(src, dst, depth, *args, count=count if last else None,
              box=box if last else None)
        src = dst
    return src


def _sweep_k2_k6(words_in, words_out, depth, rule, *, count=None,
                 box=None) -> None:
    """One sweep on K2 up to depth 32, on K6 beyond."""
    sweep = tiled_sweep if depth <= TILE_MAX_T else tiled_sweep_deep
    sweep(words_in, words_out, depth, rule, count=count, box=box)


def banded_run_turns(words: torch.Tensor, num_turns: int,
                     rule: LifeLikeRule = CONWAY, *,
                     count: torch.Tensor | None = None,
                     box=None) -> torch.Tensor:
    """Advance a packed board `num_turns` turns by K2 sweeps:
    floor(K/32) at depth 32, then one at depth K mod 32; with `count`,
    the last sweep also counts the result's live cells (within `box`)
    into it."""
    _check_count(count, words, num_turns, "banded_run_turns")
    return _run_sweeps(words, sweep_depths(num_turns, TILE_MAX_T),
                       _sweep_k2_k6, count, rule, box=box)


def fused_banded_run_turns(words: torch.Tensor, num_turns: int, fuse: int,
                           rule: LifeLikeRule = CONWAY, *,
                           count: torch.Tensor | None = None,
                           box=None) -> torch.Tensor:
    """Advance a packed board `num_turns` turns by `fuse`-deep sweeps:
    floor(n/k) at depth k, then one at depth n mod k; depths up to 32 run
    on K2, deeper ones on K6, and the last one counts into `count` when
    given. Every depth 1..64 (`MAX_FUSE_K` of ops/fused.py) is legal on
    every shape: the TPU's 8-row alignment of the depth and 128-lane
    alignment of the words have no counterpart."""
    if not 1 <= fuse <= DEEP_MAX_T:
        raise ValueError(f"fuse depth {fuse} not in 1..{DEEP_MAX_T}")
    _check_count(count, words, num_turns, "fused_banded_run_turns")
    return _run_sweeps(words, sweep_depths(num_turns, fuse), _sweep_k2_k6,
                       count, rule, box=box)


# ------------------------------------------------------------------- K3

def row_popcounts(words: torch.Tensor) -> torch.Tensor:
    """(H,) int32 live cells per row of an (H, Wp) packed board."""
    if words.device.type == "cpu":
        return row_popcounts_plain(words)
    lib, h, wp, dev, stream = _kernel_args(words, "row_popcounts")
    out = torch.empty(h, dtype=torch.int32, device=words.device)
    _build.check(lib.gol_row_popcounts(
        words.data_ptr(), out.data_ptr(), h, wp, dev, stream),
        "row_popcounts")
    row_popcounts.launches += 1
    return out


row_popcounts.launches = 0


# ------------------------------------------------------------ K4 and K5

def _family_code(family: str) -> int:
    if family not in FAMILIES:
        raise ValueError(f"two-plane family {family!r} not in "
                         f"{sorted(FAMILIES)}")
    return FAMILIES[family]


def _step2p_shared_sums(planes: torch.Tensor, rule,
                        family: str) -> torch.Tensor:
    """One torus turn of stacked planes (2, ..., rows, words): the
    self-inclusive count of the alive word, born from it unshifted and
    survive shifted by one (`count_offset=1`), then the family's
    transition."""
    p0, p1 = planes[0], planes[1]
    alive = p0 if family == "gen3" else p0 & ~p1
    n0, n1, n2, n3 = _self_inclusive_count_bits(alive, -1, -2)
    born, surv = rule_masks(n0, n1, n2, n3, rule.born, rule.survive,
                            count_offset=1)
    transition = gen3_transition if family == "gen3" else gen4_transition
    return torch.stack(transition(p0, p1, born, surv))


def resident2p_cluster_ctas(h: int, wp: int) -> int:
    """K4's cluster size N for (2, h, wp) planes: one CTA below
    `RESIDENT2P_CLUSTER_MIN_WORDS` words a plane, else min(16, h)."""
    return _cluster_ctas(h, wp, RESIDENT2P_CLUSTER_MIN_WORDS)


def resident2p_rows_per_thread(h: int, wp: int, ctas: int) -> int:
    """Interior rows each K4 thread walks: K1's rule
    (`resident_rows_per_thread`) within `RESIDENT2P_THREADS` threads."""
    return _rows_per_thread(h, wp, ctas, RESIDENT_MIN_THREADS,
                            RESIDENT_MAX_PER, RESIDENT2P_THREADS)


def resident_run_turns2p_plain(planes: torch.Tensor, num_turns: int, rule,
                               family: str,
                               ctas: int | None = None) -> torch.Tensor:
    """K4's plain version on the kernel's slabs of both planes
    (`_slab_plain`). N is `resident2p_cluster_ctas`'s unless `ctas` is
    given."""
    _family_code(family)
    h, wp = planes.shape[-2:]
    if ctas is None:
        ctas = resident2p_cluster_ctas(h, wp)
    _check_resident_geometry(h, ctas, None, "resident_run_turns2p")
    return _slab_plain(planes, num_turns,
                       lambda p: _step2p_shared_sums(p, rule, family), ctas)


def _check_count2p(count, planes, num_turns: int, family: str,
                   what: str) -> None:
    """`_check_count`, and gen3 only: plane 0 is its alive plane, not
    gen4's."""
    _check_count(count, planes, num_turns, what)
    if count is not None and family != "gen3":
        raise ValueError(f"{what}: count= counts gen3's alive plane; "
                         f"{family}'s plane 0 is not alive")


def resident_run_turns2p(planes: torch.Tensor, num_turns: int, rule,
                         family: str, *, ctas: int | None = None,
                         per: int | None = None,
                         count: torch.Tensor | None = None,
                         box=None) -> torch.Tensor:
    """Advance stacked (2, H, Wp) planes whose planes fit
    `RESIDENT2P_PLANE_BYTES` `num_turns` turns in one launch of K4, on a
    cluster of `ctas` CTAs whose threads walk `per` rows (by default the
    shape's policy); with `count` (gen3), also the result's live cells."""
    code = _family_code(family)
    _check_count2p(count, planes, num_turns, family, "resident_run_turns2p")
    if num_turns == 0:
        return planes
    h, wp = planes.shape[-2:]
    if ctas is None:
        ctas = resident2p_cluster_ctas(h, wp)
    if per is None:
        per = resident2p_rows_per_thread(h, wp, ctas)
    _check_resident_geometry(h, ctas, per, "resident_run_turns2p",
                             RESIDENT2P_THREADS)
    if planes.device.type == "cpu":
        out = resident_run_turns2p_plain(planes, num_turns, rule, family,
                                         ctas)
        _count_plain(count, out, box)
        return out
    lib, h, wp, dev, stream = _kernel_args(planes, "resident_run_turns2p",
                                           planes=True)
    if not fits_resident2p(planes.shape):
        raise ValueError(f"resident_run_turns2p: planes {h}x{wp} words "
                         f"exceed {RESIDENT2P_PLANE_BYTES} bytes each")
    out = torch.empty_like(planes)
    born, survive = _masks(rule)
    rc = lib.gol_resident_run_turns2p(
        planes.data_ptr(), out.data_ptr(), _ptr(count), h, wp, num_turns,
        born, survive, code, ctas, per, dev, stream,
        *_box_args(box, planes))
    if rc:
        raise _cluster_failed("resident_run_turns2p", lib, rc, ctas, h, wp)
    resident_run_turns2p.launches += 1
    resident_run_turns2p.by_family[family] += 1
    return out


def tile2p_rows(h: int, wp: int) -> int:
    """K5's output rows per tile for (2, h, wp) planes, one of
    `TILE2P_ROW_CHOICES` (`_fewest_window_rows`)."""
    return _fewest_window_rows(h, wp, TILE2P_ROW_CHOICES)


def tiled_sweep2p_plain(planes: torch.Tensor, t: int, rule, family: str,
                        rows: int | None = None) -> torch.Tensor:
    """K5's plain version: R x 62-word tiles of both planes (R =
    `tile2p_rows`'s unless given), one halo word a side."""
    _family_code(family)
    if rows is None:
        rows = tile2p_rows(*planes.shape[-2:])
    return _tiled_plain(planes, t,
                        lambda p: _step2p_shared_sums(p, rule, family),
                        rows, TILE_WORDS, 1)


def tiled_sweep2p(planes_in: torch.Tensor, planes_out: torch.Tensor,
                  t: int, rule, family: str, *,
                  rows: int | None = None,
                  count: torch.Tensor | None = None, box=None) -> None:
    """Advance stacked planes `planes_in` t (1..32) turns into
    `planes_out` in one K5 sweep of R-row tiles (R = `tile2p_rows`'s
    unless `rows` is given); with `count` (gen3), also its live cells."""
    code = _family_code(family)
    _check_sweep("tiled_sweep2p", planes_in, planes_out, t, TILE_MAX_T)
    _check_count2p(count, planes_in, t, family, "tiled_sweep2p")
    if rows is not None and rows not in TILE2P_ROW_CHOICES:
        raise ValueError(f"tiled_sweep2p: {rows} rows per tile not in "
                         f"{TILE2P_ROW_CHOICES}")
    if planes_in.device.type == "cpu":
        planes_out.copy_(tiled_sweep2p_plain(planes_in, t, rule, family,
                                             rows))
        _count_plain(count, planes_out, box)
        return
    if rows is None:
        rows = tile2p_rows(*planes_in.shape[-2:])
    lib, h, wp, dev, stream = _sweep_launch_args(
        "tiled_sweep2p", planes_in, planes_out, rows, planes=True)
    born, survive = _masks(rule)
    _build.check(lib.gol_tiled_sweep2p(
        planes_in.data_ptr(), planes_out.data_ptr(), _ptr(count), h, wp, t,
        rows, born, survive, code, dev, stream,
        *_box_args(box, planes_in)), "tiled_sweep2p")
    tiled_sweep2p.launches += 1
    tiled_sweep2p.by_family[family] += 1


def banded_run_turns2p(planes: torch.Tensor, num_turns: int, rule,
                       family: str, *,
                       count: torch.Tensor | None = None,
                       box=None) -> torch.Tensor:
    """Advance stacked planes `num_turns` turns by K5 sweeps:
    floor(K/32) at depth 32, then one at depth K mod 32, the last one
    counting into `count` (within `box`) when given (gen3). Sweeps
    alternate between two fresh buffers; the input is never written."""
    _check_count2p(count, planes, num_turns, family, "banded_run_turns2p")
    return _run_sweeps(planes, sweep_depths(num_turns, TILE_MAX_T),
                       tiled_sweep2p, count, rule, family, box=box)


# ------------------------------------------------------------------- K7

# Route 2's tile sides (outputs a block computes per side), as
# csrc/stencil.cu's entry point takes them.
LTL_TILE_CHOICES = (128, 64, 32)
# Least arithmetic for a separable box count: an add and a subtract for
# each of the two running sums a cell (the bound's operation count).
LTL_OPS_PER_CELL = 4
# Radii up to which the rule table is held as bytes (csrc/stencil.cu
# kLtlByteTableMaxRadius), beyond as bits.
LTL_BYTE_TABLE_MAX_RADIUS = 64
# Vertical sums take two bytes from this radius on ((2r+1) > 255).
LTL_WIDE_RADIUS = 128
# Route 2's tile policy: tile 128 only from this radius (`ltl_tile`).
LTL_TILE128_MIN_RADIUS = 16
# Route 1: boards of at most this many cells run on one CTA (a cluster
# barrier costs more than the turn of a 64² board), larger ones on
# min(16, h).
LTL_RESIDENT_SOLO_CELLS = 4096


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _odd_word_pitch(n: int) -> int:
    """A byte pitch >= n that is an odd number of 32-bit words."""
    return (n + 7) // 8 * 8 + 4


def ltl_stride(r: int) -> int:
    """Entries of one half of K7's rule table: box counts 0..(2r+1)²."""
    return (2 * r + 1) ** 2 + 1


def ltl_table_bytes(r: int) -> int:
    """Bytes of K7's rule table (csrc/stencil.cu:ltl_table_bytes): bytes
    up to `LTL_BYTE_TABLE_MAX_RADIUS`, bits beyond, 16-byte multiples."""
    n = 2 * ltl_stride(r)
    return _round16(n if r <= LTL_BYTE_TABLE_MAX_RADIUS
                    else 4 * -(-n // 32))


def ltl_sum_bytes(r: int) -> int:
    """Bytes of one of K7's vertical sums: 1 while 2r + 1 fits a byte
    (r < 128), else 2."""
    return 1 if r < LTL_WIDE_RADIUS else 2


def ltl_tile_smem_bytes(tile: int, r: int) -> int:
    """Route 2's dynamic shared memory (csrc/stencil.cu:
    ltl_tile_smem_bytes): the table, the window (room for a 16-byte
    aligned start and reads past its end), the vertical sums of `tile`
    rows and 16 bytes of slack, and the staged outputs."""
    span = tile + 2 * r
    return (ltl_table_bytes(r) + _round16(span * _odd_word_pitch(span + 30))
            + _round16(tile * _odd_word_pitch((span + 30)
                                              * ltl_sum_bytes(r)))
            + 16 + tile * _odd_word_pitch(tile))


def ltl_resident_smem_bytes(h: int, w: int, r: int, ctas: int) -> int:
    """Route 1's dynamic shared memory a CTA (csrc/stencil.cu:
    ltl_resident_smem_bytes): the table, 16 cell bases and slab lengths,
    two buffers of ceil(h/N) rows of cells, one of their vertical sums
    and 16 bytes of slack."""
    rows = -(-h // ctas)
    return (ltl_table_bytes(r) + RESIDENT_MAX_CTAS * 12
            + 2 * rows * _odd_word_pitch(w)
            + _round16(rows * _odd_word_pitch(w * ltl_sum_bytes(r))) + 16)


def ltl_resident_ctas(h: int, w: int, r: int) -> int:
    """Route 1's gate and cluster size, from the shape alone: one CTA up
    to `LTL_RESIDENT_SOLO_CELLS` cells, else min(16, h), when the slab's
    two buffers of cells, its vertical sums and the table fit a CTA's
    shared memory; 0 (route 2) when they do not."""
    ctas = (1 if h * w <= LTL_RESIDENT_SOLO_CELLS
            else min(RESIDENT_MAX_CTAS, h))
    return ctas if ltl_resident_smem_bytes(h, w, r, ctas) <= SMEM_BYTES \
        else 0


def ltl_tile(h: int, w: int, r: int) -> int:
    """Route 2's tile side for an (h, w) board at radius r: of the tiles
    of `LTL_TILE_CHOICES` whose block fits shared memory and whose grid
    gives every SM a block, the largest, but 64 over 128 below
    `LTL_TILE128_MIN_RADIUS`; the smallest that fits where none gives
    every SM a block; and where that block leaves no room for a second
    on its SM (1 KB reserved a block, 228 KB an SM), the largest tile
    that fits, whose block does less halo work a cell in the same slot.

    Measured (chip_smoke.py phase 5; NVIDIA H100 80GB HBM3, 700 W;
    PERF.md §6): at 4096² tiles 64 and 128 are within 6% for r <= 8 (64
    ahead at r <= 4), 128 leads by 5-26% for r = 16-64, and at r = 128
    only 64 and 32 fit (64 leads 3.3x); at 1024² 64 leads at every r; at
    512² 32 leads up to r = 64 and 64 by 40% at r = 128, where a tile-32
    block holds an SM alone."""
    fits = [t for t in LTL_TILE_CHOICES
            if ltl_tile_smem_bytes(t, r) <= SMEM_BYTES]
    full = [t for t in fits if -(-h // t) * -(-w // t) >= CARD_SMS]
    if r < LTL_TILE128_MIN_RADIUS and len(full) > 1:
        full = [t for t in full if t != 128]
    tile = full[0] if full else fits[-1]
    if 2 * (ltl_tile_smem_bytes(tile, r) + 1024) > SMEM_BYTES + 1024:
        return fits[0]
    return tile


@functools.lru_cache(maxsize=64)
def ltl_count_table(rule) -> np.ndarray:
    """(2, (2r+1)² + 1) uint8: [me][n] is the next state of a cell `me`
    whose box, the cell included, counts n — the rule's `luts()` with
    M0's "minus the cell" folded into the survive half."""
    survive, born = rule.luts()
    stride = ltl_stride(rule.radius)
    table = np.zeros((2, stride), dtype=np.uint8)
    table[0, :min(len(born), stride)] = born[:stride]
    n = np.arange(stride) - (0 if rule.middle else 1)
    ok = (n >= 0) & (n < len(survive))
    table[1, ok] = survive[n[ok]]
    return table


@functools.lru_cache(maxsize=64)
def ltl_table(rule, device: torch.device) -> torch.Tensor:
    """K7's rule table as the kernels read it, `ltl_table_bytes` uint8 on
    `device` (once per rule and device): `ltl_count_table` flattened, as
    bytes up to `LTL_BYTE_TABLE_MAX_RADIUS` and packed little-endian to
    bits beyond."""
    r = rule.radius
    flat = ltl_count_table(rule).reshape(-1)
    if r > LTL_BYTE_TABLE_MAX_RADIUS:
        flat = np.packbits(flat, bitorder="little")
    out = np.zeros(ltl_table_bytes(r), dtype=np.uint8)
    out[:len(flat)] = flat
    return torch.from_numpy(out).to(device)


def _check_box_rule(rule, what: str) -> None:
    if rule.kind != "M":
        raise ValueError(f"{what}: {rule.rulestring} is not a Moore-box "
                         "rule")


def _ltl_cells_args(cells: torch.Tensor, what: str):
    """Validate CUDA cells; return (lib, stream)."""
    if cells.dtype != torch.uint8 or cells.dim() != 2:
        raise ValueError(f"{what}: want 2-D uint8 cells, got {cells.dtype} "
                         f"{tuple(cells.shape)}")
    if not cells.is_contiguous():
        raise ValueError(f"{what}: cells must be contiguous")
    return _library(), torch.cuda.current_stream(cells.device).cuda_stream


def _running_sums(win: torch.Tensor, r: int, n: int, dim: int):
    """Running sums of 2r + 1 along `dim` of a window of n + 2r entries,
    as the kernels take them: the first sum in full, then each next one
    the last plus the entry that enters minus the one that leaves."""
    k = 2 * r + 1
    first = win.narrow(dim, 0, k).sum(dim, keepdim=True)
    steps = win.narrow(dim, k, n - 1) - win.narrow(dim, 0, n - 1)
    return torch.cumsum(torch.cat([first, steps], dim), dim)


def ltl_resident_run_turns_plain(cells: torch.Tensor, num_turns: int, rule,
                                 ctas: int | None = None) -> torch.Tensor:
    """Route 1's plain version on the kernel's slabs: each turn takes, for
    every CTA, the vertical running sums of the cells of rows a_i - r ..
    a_{i+1} + r - 1 modulo h, each row read from the slab of its owner
    ((g + 1)·N - 1) // h at its row there, as the kernel's walker reads
    them through DSMEM; then the horizontal running sums of those along
    the CTA's own rows (columns modulo w) and the rule table. N is
    `ltl_resident_ctas`'s unless `ctas` is given."""
    h, w = cells.shape
    r = rule.radius
    if ctas is None:
        ctas = ltl_resident_ctas(h, w, r)
    _check_resident_geometry(h, ctas, None, "ltl_resident_run_turns")
    dev = cells.device
    starts = torch.tensor(_slab_starts(h, ctas), device=dev)
    rows = -(-h // ctas)
    lengths = starts[1:] - starts[:-1]
    y = torch.arange(rows, device=dev)
    # Each CTA's rows (a short slab's last row repeated to the
    # allocation) and, for every board row, its slab and row there.
    slab_rows = starts[:-1, None] + torch.minimum(y, lengths[:, None] - 1)
    g = torch.arange(h, device=dev)
    owner = ((g + 1) * ctas - 1) // h
    local = g - starts[owner]
    halo = (starts[:-1, None] - r + torch.arange(rows + 2 * r, device=dev)
            ) % h
    cols = torch.arange(-r, w + r, device=dev) % w
    table = torch.from_numpy(ltl_count_table(rule)).to(dev)
    for _ in range(num_turns):
        slabs = cells[slab_rows]                       # (N, rows, w)
        win = slabs[owner[halo], local[halo]]          # (N, rows + 2r, w)
        vsum = _running_sums(win.to(torch.int32), r, rows, 1)
        counts = _running_sums(vsum[..., cols], r, w, 2)
        nxt = table[slabs.long(), counts.long()]
        cells = nxt[owner, local]
    return cells


def ltl_resident_run_turns(cells: torch.Tensor, num_turns: int, rule, *,
                           ctas: int | None = None) -> torch.Tensor:
    """K7 route 1: advance an (H, W) uint8 {0,1} board that
    `ltl_resident_ctas` admits `num_turns` turns of a Moore-box rule in
    one launch, on a cluster of `ctas` CTAs (the gate's unless given).
    The input is never written."""
    _check_box_rule(rule, "ltl_resident_run_turns")
    if num_turns == 0:
        return cells
    h, w = cells.shape
    r = rule.radius
    if ctas is None:
        ctas = ltl_resident_ctas(h, w, r)
        if not ctas:
            raise ValueError(f"ltl_resident_run_turns: {h}x{w} at radius "
                             f"{r} does not fit a cluster")
    _check_resident_geometry(h, ctas, None, "ltl_resident_run_turns")
    if cells.device.type == "cpu":
        return ltl_resident_run_turns_plain(cells, num_turns, rule, ctas)
    lib, stream = _ltl_cells_args(cells, "ltl_resident_run_turns")
    if ltl_resident_smem_bytes(h, w, r, ctas) > SMEM_BYTES:
        raise ValueError(f"ltl_resident_run_turns: {h}x{w} at radius {r} "
                         f"does not fit {ctas} CTAs")
    out = torch.empty_like(cells)
    rc = lib.gol_ltl_resident_run_turns(
        cells.data_ptr(), out.data_ptr(), h, w, num_turns, r, ctas,
        ltl_table(rule, cells.device).data_ptr(), cells.device.index,
        stream)
    if rc:
        raise _cluster_failed("ltl_resident_run_turns", lib, rc, ctas, h, w)
    ltl_resident_run_turns.launches += 1
    return out


ltl_resident_run_turns.launches = 0


def ltl_box_run_turns_plain(cells: torch.Tensor, num_turns: int,
                            rule) -> torch.Tensor:
    """Route 2's plain version: `num_turns` turns of `_ltl_step(cells,
    rule, "conv")` (ops/conv.py), the separable shift-add sum and interval
    tests of the JAX tier, in torch ops."""
    from gol_tpu_torch.ops import conv

    for _ in range(num_turns):
        cells = conv._ltl_step(cells, rule, "conv")
    return cells


def ltl_box_run_turns(cells: torch.Tensor, num_turns: int, rule, *,
                      tile: int | None = None) -> torch.Tensor:
    """Advance an (H, W) uint8 {0,1} board `num_turns` turns of a
    Moore-box Larger-than-Life rule on K7: a board that
    `ltl_resident_ctas` admits in one route-1 launch
    (`ltl_resident_run_turns`, unless `tile` pins route 2), any other on
    route 2, one launch a turn, all issued by one C call, on `tile`-sided
    tiles (`ltl_tile`'s unless given). The input is never written."""
    _check_box_rule(rule, "ltl_box_run_turns")
    if num_turns == 0:
        return cells
    h, w = cells.shape
    r = rule.radius
    if tile is None and ltl_resident_ctas(h, w, r):
        return ltl_resident_run_turns(cells, num_turns, rule)
    if cells.device.type == "cpu":
        return ltl_box_run_turns_plain(cells, num_turns, rule)
    lib, stream = _ltl_cells_args(cells, "ltl_box_run_turns")
    if tile is None:
        tile = ltl_tile(h, w, r)
    if tile not in LTL_TILE_CHOICES or ltl_tile_smem_bytes(
            tile, r) > SMEM_BYTES:
        raise ValueError(f"ltl_box_run_turns: tile {tile} does not fit "
                         f"radius {r}")
    a = torch.empty_like(cells)
    b = torch.empty_like(cells) if num_turns > 1 else a
    _build.check(lib.gol_ltl_box_run_turns(
        cells.data_ptr(), a.data_ptr(), b.data_ptr(), h, w, num_turns, r,
        tile, ltl_table(rule, cells.device).data_ptr(), cells.device.index,
        stream), "ltl_box_run_turns")
    ltl_box_run_turns.launches += num_turns
    return a if num_turns % 2 else b


ltl_box_run_turns.launches = 0


# ------------------------------------------------------------------- K8

def _byte_popcounts(words: torch.Tensor) -> torch.Tensor:
    """(..., Wp) int32 popcount of each word read as uint32 (the sign bit
    counts as one): a 256-entry table over the word's four bytes."""
    lut = torch.tensor([bin(i).count("1") for i in range(256)],
                       dtype=torch.int32, device=words.device)
    raw = words.contiguous().view(torch.uint8).to(torch.int32)
    return lut[raw].reshape(*words.shape, 4).sum(dim=-1, dtype=torch.int32)


def window_occupancy_plain(words: torch.Tensor) -> torch.Tensor:
    """K8's plain version: the (H + Wp,) int32 occupancy of an (H, Wp)
    window, row counts then word-column counts."""
    pop = _byte_popcounts(words)
    return torch.cat([pop.sum(dim=1, dtype=torch.int32),
                      pop.sum(dim=0, dtype=torch.int32)])


def window_occupancy(words: torch.Tensor) -> torch.Tensor:
    """The (H + Wp,) int32 occupancy of an (H, Wp) packed window in one K8
    launch: the live cells of each row, then of each word column (what
    `_occupancy` of the JAX sparse torus returns as a pair)."""
    if words.device.type == "cpu":
        return window_occupancy_plain(words)
    lib, h, wp, dev, stream = _kernel_args(words, "window_occupancy")
    if -(-h // OCC_ROWS) > 65535:
        raise ValueError(f"window_occupancy: {h} rows exceed the launch "
                         "grid")
    out = torch.empty(h + wp, dtype=torch.int32, device=words.device)
    _build.check(lib.gol_window_occupancy(
        words.data_ptr(), out.data_ptr(), h, wp, dev, stream),
        "window_occupancy")
    window_occupancy.launches += 1
    return out


window_occupancy.launches = 0


# ------------------------------------------------------------------- K9

# Most slots route 2's grid takes (its z extent).
FLEET_MAX_SLOTS = 65535
FLEET_ROUTES = ("resident", "tiled")


def _slab_buffers_bytes(h: int, wp: int, ctas: int) -> int:
    """A K1 CTA's two buffers of ceil(h/N) rows (csrc/stencil.cu:
    resident_geometry)."""
    return 2 * 4 * -(-h // ctas) * wp


def fleet_slot_ctas(h: int, wp: int) -> int:
    """The fewest CTAs a route-1 slot takes: the smallest power of two
    (or min(16, h)) whose slabs' two buffers fit a CTA's shared memory;
    0 when not even min(16, h) CTAs hold the slot (route 2's slots)."""
    top = min(RESIDENT_MAX_CTAS, h)
    if _slab_buffers_bytes(h, wp, top) > SMEM_BYTES:
        return 0
    n = 1
    while n < top and _slab_buffers_bytes(h, wp, n) > SMEM_BYTES:
        n *= 2
    return min(n, top)


def fleet_run_kind(shape) -> str:
    """K9's route for a (cap, hb, wpb) batch: 'resident' (route 1) when a
    cluster of at most 16 CTAs holds a slot (512², 1024², 2048²), else
    'tiled' (route 2)."""
    return "resident" if fleet_slot_ctas(*shape[-2:]) else "tiled"


def fleet_resident_ctas(cap: int, h: int, wp: int) -> int:
    """Route 1's CTAs a slot: K1's cluster for the slot's shape, halved
    while cap x N would exceed the card's SMs, but never below the
    fewest that hold the slot (`fleet_slot_ctas`): one CTA a 512² slot
    from 132 slots up, 2 a 1024² slot, 8 a 2048² slot. Slots need not run
    at once, so a batch above 132 SMs runs in waves."""
    floor = fleet_slot_ctas(h, wp)
    n = max(resident_cluster_ctas(h, wp), floor)
    while n > floor and cap * n > CARD_SMS:
        n //= 2
    return n


def fleet_tile_rows(cap: int, h: int, wp: int) -> int:
    """Route 2's output rows per tile: K2's rule (`_fewest_window_rows`)
    over the blocks of all `cap` slots."""
    return _fewest_window_rows(h, wp, TILE_ROW_CHOICES, cap)


def slot_popcounts(words: torch.Tensor, box=None) -> torch.Tensor:
    """(cap,) int32 live cells of each slot of a (cap, h, wp) batch, within
    `box` = (r0, r1, c0, c1) of every slot when given."""
    r0, r1, c0, c1 = _box_args(box, words)
    return _byte_popcounts(words[:, r0:r1, c0:c1]).sum(
        dim=(-1, -2), dtype=torch.int32)


@functools.lru_cache(maxsize=256)
def _fleet_geometry(shape: tuple, ctas, rows, kind):
    """(kind, ctas, per, rows) for a (cap, H, Wp) batch, the policy's
    where not given, once per argument set (a quantum repeats them);
    raises on a geometry the route does not take."""
    if len(shape) != 3:
        raise ValueError(f"fleet_run_turns: want (cap, H, Wp) words, got "
                         f"{shape}")
    cap, h, wp = shape
    if kind is None:
        kind = fleet_run_kind(shape)
    if kind not in FLEET_ROUTES:
        raise ValueError(f"fleet_run_turns: route {kind!r} not in "
                         f"{FLEET_ROUTES}")
    if kind == "resident":
        if not fleet_slot_ctas(h, wp):
            raise ValueError(
                f"fleet_run_turns: a {h}x{wp}-word slot fits no cluster of "
                f"route 1 ({RESIDENT_MAX_CTAS} CTAs of {SMEM_BYTES} bytes)")
        if rows is not None:
            raise ValueError("fleet_run_turns: rows= is route 2's")
        if ctas is None:
            ctas = fleet_resident_ctas(cap, h, wp)
        _check_resident_geometry(h, ctas, None, "fleet_run_turns")
        if _slab_buffers_bytes(h, wp, ctas) > SMEM_BYTES:
            raise ValueError(f"fleet_run_turns: {ctas} CTAs do not hold a "
                             f"{h}x{wp}-word slot in route 1")
        return kind, ctas, resident_rows_per_thread(h, wp, ctas), None
    if ctas is not None:
        raise ValueError("fleet_run_turns: ctas= is route 1's")
    if rows is None:
        rows = fleet_tile_rows(cap, h, wp)
    if rows not in TILE_ROW_CHOICES:
        raise ValueError(f"fleet_run_turns: {rows} rows per tile not "
                         f"in {TILE_ROW_CHOICES}")
    return kind, None, None, rows


def fleet_run_turns_plain(words: torch.Tensor, num_turns: int,
                          rule: LifeLikeRule = CONWAY, *,
                          ctas: int | None = None,
                          rows: int | None = None, kind: str | None = None,
                          box=None):
    """K9's plain version: route 1's slabs (`_slab_plain`) or route 2's
    tiles (`_tiled_plain`, one sweep per 32 turns) on the batch axis,
    then each slot's popcount (of `box` when given). Returns (words',
    alive)."""
    kind, ctas, _, rows = _fleet_geometry(tuple(words.shape), ctas, rows,
                                          kind)

    def step(w):
        return _step_shared_sums(w, rule)

    if kind == "resident":
        out = _slab_plain(words, num_turns, step, ctas)
    else:
        out = words
        for t in sweep_depths(num_turns, TILE_MAX_T):
            out = _tiled_plain(out, t, step, rows, TILE_WORDS, 1)
    return out, slot_popcounts(out, box)


def fleet_run_turns(words: torch.Tensor, num_turns: int,
                    rule: LifeLikeRule = CONWAY, *,
                    ctas: int | None = None, rows: int | None = None,
                    kind: str | None = None, box=None):
    """Advance every slot of a (cap, H, Wp) packed batch `num_turns`
    turns, each slot its own torus, and count each slot's live cells:
    (words', alive int32 (cap,)). Route 1 is one launch; route 2 one
    launch a sweep of up to 32 turns, the last one counting. `box` =
    (r0, r1, c0, c1), the same for every slot, counts only those rows and
    words of each (a spatial bucket's window counts its shard's own rows,
    `fleet/buckets.py`); None counts the whole slot. `kind`, `ctas`
    (route 1) and `rows` (route 2) pin a route and a geometry for tests
    and measurements. The input is never written."""
    kind, ctas, per, rows = _fleet_geometry(tuple(words.shape), ctas, rows,
                                            kind)
    r0, r1, c0, c1 = _box_args(box, words)
    if words.device.type == "cpu":
        return fleet_run_turns_plain(words, num_turns, rule, ctas=ctas,
                                     rows=rows, kind=kind, box=box)
    if num_turns < 1:
        raise ValueError(f"fleet_run_turns: {num_turns} turns; want >= 1")
    if (words.dtype != torch.int32 or not words.is_contiguous()):
        raise ValueError(f"fleet_run_turns: want contiguous int32 words, "
                         f"got {words.dtype}")
    cap, h, wp = words.shape
    if cap > FLEET_MAX_SLOTS:
        raise ValueError(f"fleet_run_turns: {cap} slots exceed "
                         f"{FLEET_MAX_SLOTS}")
    lib = _library()
    dev = words.device.index
    stream = torch.cuda.current_stream(words.device).cuda_stream
    born, survive = _masks(rule)
    alive = torch.empty(cap, dtype=torch.int32, device=words.device)
    if kind == "resident":
        out = torch.empty_like(words)
        rc = lib.gol_fleet_resident(
            words.data_ptr(), out.data_ptr(), alive.data_ptr(), cap, h, wp,
            num_turns, born, survive, ctas, per, dev, stream, r0, r1, c0,
            c1)
        if rc:
            raise _cluster_failed("fleet_run_turns", lib, rc, ctas, h, wp)
        fleet_run_turns.launches += 1
        fleet_run_turns.by_route["resident"] += 1
        return out, alive
    if -(-h // rows) > 65535:
        raise ValueError(f"fleet_run_turns: {h} rows exceed the launch "
                         "grid")
    depths = sweep_depths(num_turns, TILE_MAX_T)
    bufs: list = []
    src = words
    for i, t in enumerate(depths):
        if len(bufs) < 2:
            bufs.append(torch.empty_like(words))
        dst = bufs[i % 2]
        last = i == len(depths) - 1
        _build.check(lib.gol_fleet_tiled_sweep(
            src.data_ptr(), dst.data_ptr(),
            alive.data_ptr() if last else None, cap, h, wp, t, rows, born,
            survive, dev, stream, r0, r1, c0, c1), "fleet_run_turns")
        fleet_run_turns.launches += 1
        fleet_run_turns.by_route["tiled"] += 1
        src = dst
    return src, alive


fleet_run_turns.launches = 0


KERNELS = (resident_run_turns, tiled_sweep, row_popcounts,
           resident_run_turns2p, tiled_sweep2p, tiled_sweep_deep,
           ltl_box_run_turns, ltl_resident_run_turns, window_occupancy,
           fleet_run_turns)
# The two-plane kernels count launches per family as well.
KERNELS_2P = (resident_run_turns2p, tiled_sweep2p)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in KERNELS_2P:
        fn.by_family = dict.fromkeys(FAMILIES, 0)
    fleet_run_turns.by_route = dict.fromkeys(FLEET_ROUTES, 0)


reset_launch_counts()
