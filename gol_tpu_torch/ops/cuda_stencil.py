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

K3 `row_popcounts` counts live cells per row with `__popc` (one warp per
row) for the engine's alive token; the JAX package leaves that reduction
to XLA (`engine.py:158-160`). Bound: one read of the board at 3.35 TB/s.

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

No single PyTorch call computes a packed life-like or Generations step,
so no library call stands beside K1, K2, K4, K5 or K6.

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
                       per: int | None = None) -> torch.Tensor:
    """Advance an (H, Wp) packed board that fits `RESIDENT_BOARD_BYTES`
    `num_turns` turns in one launch of K1, on a cluster of `ctas` CTAs
    whose threads walk `per` rows (by default the shape's policy)."""
    if num_turns == 0:
        return words
    h, wp = words.shape[-2:]
    if ctas is None:
        ctas = resident_cluster_ctas(h, wp)
    if per is None:
        per = resident_rows_per_thread(h, wp, ctas)
    _check_resident_geometry(h, ctas, per)
    if words.device.type == "cpu":
        return resident_run_turns_plain(words, num_turns, rule, ctas)
    lib, h, wp, dev, stream = _kernel_args(words, "resident_run_turns")
    if not fits_resident(words.shape):
        raise ValueError(f"resident_run_turns: board {h}x{wp} words "
                         f"exceeds {RESIDENT_BOARD_BYTES} bytes")
    out = torch.empty_like(words)
    born, survive = rule.masks()
    rc = lib.gol_resident_run_turns(
        words.data_ptr(), out.data_ptr(), h, wp, num_turns, born, survive,
        ctas, per, dev, stream)
    if rc:
        raise _cluster_failed("resident_run_turns", lib, rc, ctas, h, wp)
    resident_run_turns.launches += 1
    return out


resident_run_turns.launches = 0


# ------------------------------------------------------------ K2 and K6

def _fewest_window_rows(h: int, wp: int, choices) -> int:
    """The tile height whose busiest SM computes the fewest window rows
    at T = 32: ceil(blocks / 132) blocks of R + 31 rows each (the rows
    [turn, R + 2T - turn) over T turns; two blocks sharing an SM take as
    long as two in turn; the larger R on a tie)."""
    cols = -(-wp // TILE_WORDS)
    return min(choices, key=lambda rows: -(
        -cols * -(-h // rows) // CARD_SMS) * (rows + TILE_MAX_T - 1))


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
                rows: int | None = None) -> None:
    """Advance `words_in` t (1..32) turns into `words_out` in one K2
    sweep of R-row tiles (R = `tile_rows`'s unless `rows` is given)."""
    _check_sweep("tiled_sweep", words_in, words_out, t, TILE_MAX_T)
    if rows is not None and rows not in TILE_ROW_CHOICES:
        raise ValueError(f"tiled_sweep: {rows} rows per tile not in "
                         f"{TILE_ROW_CHOICES}")
    if words_in.device.type == "cpu":
        words_out.copy_(tiled_sweep_plain(words_in, t, rule, rows))
        return
    if rows is None:
        rows = tile_rows(*words_in.shape)
    lib, h, wp, dev, stream = _sweep_launch_args(
        "tiled_sweep", words_in, words_out, rows)
    born, survive = rule.masks()
    _build.check(lib.gol_tiled_sweep(
        words_in.data_ptr(), words_out.data_ptr(), h, wp, t, rows, born,
        survive, dev, stream), "tiled_sweep")
    tiled_sweep.launches += 1


tiled_sweep.launches = 0


def tiled_sweep_deep(words_in: torch.Tensor, words_out: torch.Tensor,
                     t: int, rule: LifeLikeRule = CONWAY) -> None:
    """Advance `words_in` t (1..64) turns into `words_out` in one K6
    sweep."""
    _check_sweep("tiled_sweep_deep", words_in, words_out, t, DEEP_MAX_T)
    if words_in.device.type == "cpu":
        words_out.copy_(tiled_sweep_deep_plain(words_in, t, rule))
        return
    lib, h, wp, dev, stream = _sweep_launch_args(
        "tiled_sweep_deep", words_in, words_out, DEEP_ROWS)
    born, survive = rule.masks()
    _build.check(lib.gol_tiled_sweep_deep(
        words_in.data_ptr(), words_out.data_ptr(), h, wp, t, born, survive,
        dev, stream), "tiled_sweep_deep")
    tiled_sweep_deep.launches += 1


tiled_sweep_deep.launches = 0


def sweep_depths(num_turns: int, depth: int) -> list:
    """floor(n/depth) sweeps at `depth`, then one at n mod depth."""
    full, rem = divmod(num_turns, depth)
    return [depth] * full + ([rem] if rem else [])


def _run_sweeps(words: torch.Tensor, depths, rule) -> torch.Tensor:
    """One sweep per depth, on K2 up to 32 and on K6 beyond, alternating
    between two fresh buffers; the input is never written."""
    bufs = []
    src = words
    for i, depth in enumerate(depths):
        if len(bufs) < 2:
            bufs.append(torch.empty_like(words))
        dst = bufs[i % 2]
        sweep = tiled_sweep if depth <= TILE_MAX_T else tiled_sweep_deep
        sweep(src, dst, depth, rule)
        src = dst
    return src


def banded_run_turns(words: torch.Tensor, num_turns: int,
                     rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """Advance a packed board `num_turns` turns by K2 sweeps:
    floor(K/32) at depth 32, then one at depth K mod 32."""
    return _run_sweeps(words, sweep_depths(num_turns, TILE_MAX_T), rule)


def fused_banded_run_turns(words: torch.Tensor, num_turns: int, fuse: int,
                           rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """Advance a packed board `num_turns` turns by `fuse`-deep sweeps:
    floor(n/k) at depth k, then one at depth n mod k; depths up to 32 run
    on K2, deeper ones on K6. Every depth 1..64 (`MAX_FUSE_K` of
    ops/fused.py) is legal on every shape: the TPU's 8-row alignment of
    the depth and 128-lane alignment of the words have no counterpart."""
    if not 1 <= fuse <= DEEP_MAX_T:
        raise ValueError(f"fuse depth {fuse} not in 1..{DEEP_MAX_T}")
    return _run_sweeps(words, sweep_depths(num_turns, fuse), rule)


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


def resident_run_turns2p(planes: torch.Tensor, num_turns: int, rule,
                         family: str, *, ctas: int | None = None,
                         per: int | None = None) -> torch.Tensor:
    """Advance stacked (2, H, Wp) planes whose planes fit
    `RESIDENT2P_PLANE_BYTES` `num_turns` turns in one launch of K4, on a
    cluster of `ctas` CTAs whose threads walk `per` rows (by default the
    shape's policy)."""
    code = _family_code(family)
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
        return resident_run_turns2p_plain(planes, num_turns, rule, family,
                                          ctas)
    lib, h, wp, dev, stream = _kernel_args(planes, "resident_run_turns2p",
                                           planes=True)
    if not fits_resident2p(planes.shape):
        raise ValueError(f"resident_run_turns2p: planes {h}x{wp} words "
                         f"exceed {RESIDENT2P_PLANE_BYTES} bytes each")
    out = torch.empty_like(planes)
    born, survive = rule.masks()
    rc = lib.gol_resident_run_turns2p(
        planes.data_ptr(), out.data_ptr(), h, wp, num_turns, born, survive,
        code, ctas, per, dev, stream)
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
                  rows: int | None = None) -> None:
    """Advance stacked planes `planes_in` t (1..32) turns into
    `planes_out` in one K5 sweep of R-row tiles (R = `tile2p_rows`'s
    unless `rows` is given)."""
    code = _family_code(family)
    _check_sweep("tiled_sweep2p", planes_in, planes_out, t, TILE_MAX_T)
    if rows is not None and rows not in TILE2P_ROW_CHOICES:
        raise ValueError(f"tiled_sweep2p: {rows} rows per tile not in "
                         f"{TILE2P_ROW_CHOICES}")
    if planes_in.device.type == "cpu":
        planes_out.copy_(tiled_sweep2p_plain(planes_in, t, rule, family,
                                             rows))
        return
    if rows is None:
        rows = tile2p_rows(*planes_in.shape[-2:])
    lib, h, wp, dev, stream = _sweep_launch_args(
        "tiled_sweep2p", planes_in, planes_out, rows, planes=True)
    born, survive = rule.masks()
    _build.check(lib.gol_tiled_sweep2p(
        planes_in.data_ptr(), planes_out.data_ptr(), h, wp, t, rows, born,
        survive, code, dev, stream), "tiled_sweep2p")
    tiled_sweep2p.launches += 1
    tiled_sweep2p.by_family[family] += 1


def banded_run_turns2p(planes: torch.Tensor, num_turns: int, rule,
                       family: str) -> torch.Tensor:
    """Advance stacked planes `num_turns` turns by K5 sweeps:
    floor(K/32) at depth 32, then one at depth K mod 32. Sweeps alternate
    between two fresh buffers; the input is never written."""
    bufs = []
    src = planes
    for i, depth in enumerate(sweep_depths(num_turns, TILE_MAX_T)):
        if len(bufs) < 2:
            bufs.append(torch.empty_like(planes))
        dst = bufs[i % 2]
        tiled_sweep2p(src, dst, depth, rule, family)
        src = dst
    return src


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


KERNELS = (resident_run_turns, tiled_sweep, row_popcounts,
           resident_run_turns2p, tiled_sweep2p, tiled_sweep_deep,
           ltl_box_run_turns, ltl_resident_run_turns, window_occupancy)
# The two-plane kernels count launches per family as well.
KERNELS_2P = (resident_run_turns2p, tiled_sweep2p)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
    for fn in KERNELS_2P:
        fn.by_family = dict.fromkeys(FAMILIES, 0)


reset_launch_counts()
