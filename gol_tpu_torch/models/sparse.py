"""Sparse torus: evolve a small pattern on an enormous torus — the
counterpart of `gol_tpu/models/sparse.py`.

BASELINE config 5 is "R-pentomino on a 2^20 sparse torus": a board of
2^40 cells (137 GB packed), absurd to hold when fewer than a few thousand
cells are ever alive. `SparseTorus` keeps only the live bounding window,
as int32 words in `pack`'s layout on one device, and advances it with the
dense engine's packed kernels (`parallel/halo.py:packed_run_kind`: K1 for
a window that fits one cluster's shared memory, K2 sweeps beyond), each
macro-step followed by K8's occupancy of the result
(`ops/cuda_stencil.window_occupancy`) on the same stream.

Correctness argument (as in the JAX package): the window is stepped with
ordinary torus stepping. As long as every live cell stays at least one
row or column inside the window's margin, the window's wrap-around feeds
only dead cells to dead cells, which is what the same region embedded in
the huge torus sees. A pattern expands at most one cell a turn, so a
macro-step of K turns is exact iff the margin before it is at least
K + 1; `run()` measures the live bounding box between episodes and grows
the window (aligned, zero-padded, on the device) ahead of need. Once the
window spans the whole torus on an axis, its wrap is the torus's own.

Host syncs: `_margins` copies the occupancy to the host once an episode;
`_issue_macro` and `_grow` queue work on the device's stream and never
wait for it. Window shapes, origins and margins follow the JAX object's
turn for turn.

The device is explicit: `device=None` means CUDA and raises without one;
`device="cpu"` runs the kernels' plain versions, as the tests do.
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch

from gol_tpu_torch.models.lifelike import CONWAY, LifeLikeRule
from gol_tpu_torch.ops.bitpack import (
    WORD_BITS,
    pack_np,
    unpack_np,
    words_from_numpy,
    words_to_numpy,
)
from gol_tpu_torch.ops.cuda_stencil import window_occupancy

# R-pentomino in (col, row) offsets — the reference-era standard pattern.
R_PENTOMINO = ((1, 0), (2, 0), (0, 1), (1, 1), (1, 2))

# Coarse alignment ladder, as in the JAX package (where each distinct
# window shape costs a compile): shapes are quantized and growth
# overshoots (1.5x the needed margin) to keep regrowth rare.
_ROW_ALIGN = 256         # window heights: multiples of 256 rows
_COL_ALIGN = 2048        # window widths: multiples of 2048 cells
_WIDE_COL_ALIGN = 4096   # past one wide unit: multiples of 4096 cells
_GROW_NUM, _GROW_DEN = 3, 2   # headroom = need * 3/2 + 64

# Macro-step sizing: one margins fetch buys `margin - 1` turns of provably
# safe stepping (a pattern expands <= 1 cell a turn), issued as a chain of
# macros with no host sync between them. Depths are powers of two in
# [_MACRO_MIN, cap].
_MACRO_CAP = 2048
_MACRO_MIN = 256


def _ladder_floor(v: int) -> int:
    """Largest power-of-two macro depth >= _MACRO_MIN that is <= v;
    0 if v < _MACRO_MIN."""
    if v < _MACRO_MIN:
        return 0
    k = _MACRO_MIN
    while k * 2 <= v:
        k *= 2
    return k


def _round_up(v: int, align: int) -> int:
    return -(-v // align) * align


# The live window's hard ceiling is the device's memory. Enforce it with a
# clear error instead of an allocator OOM deep inside a kernel.
# GOL_SPARSE_MAX_BYTES overrides the budget (0 disables the check); the
# default is half the device's memory (kernel temporaries need the rest),
# 8 GiB for a device that reports none (the CPU).
_MAX_BYTES_ENV = "GOL_SPARSE_MAX_BYTES"
_DEFAULT_BUDGET = 8 << 30
# A packed window costs H*W/8 bytes; stepping it needs a handful of
# same-size temporaries (the sweeps' two buffers, the grow's new window).
_WINDOW_COST_FACTOR = 4


def _window_budget(device=None) -> int:
    v = os.environ.get(_MAX_BYTES_ENV, "")
    if v:
        try:
            n = int(v)
        except ValueError:
            n = None  # garbage degrades to the probed default
        if n is not None:
            if n > 0:
                return n
            if n == 0:
                return 1 << 62  # exactly 0 disables the guard
            # Negative values degrade to the default: only an explicit 0
            # may disable the OOM guard this budget exists to enforce.
    from gol_tpu_torch.utils.devicemem import half_device_memory

    return half_device_memory(_DEFAULT_BUDGET, device)


def check_sparse_mesh(n: int, size: int) -> None:
    """Validate a sparse-window shard count as the JAX package does: every
    window height is a multiple of _ROW_ALIGN or the full torus, so `n`
    must divide both."""
    if n > 1 and (_ROW_ALIGN % n or size % n):
        raise ValueError(
            f"sparse mesh of {n} devices must divide "
            f"{_ROW_ALIGN} and the torus size {size}")


def _check_window_fits(win_h: int, win_w: int, device=None) -> None:
    """Raise a diagnosable error when a window this size cannot run on the
    device — BEFORE the allocation that would fail."""
    need = win_h * (win_w // 8) * _WINDOW_COST_FACTOR
    budget = _window_budget(device)
    if need > budget:
        raise RuntimeError(
            f"sparse window {win_w}x{win_h} needs ~{need / 2**30:.1f} "
            f"GiB (> budget {budget / 2**30:.1f} GiB) on one device: the "
            f"pattern has outgrown this sparse engine — run the dense "
            f"engine, or raise {_MAX_BYTES_ENV} (a window sharded over "
            f"devices is ROADMAP A5).")


def _cyclic_extent(coords, size: int):
    """(origin, extent) of the tightest arc covering `coords` on a
    `size`-cycle: anchor just past the largest gap between consecutive
    occupied positions, wrapping included."""
    uniq = sorted(set(coords))
    if len(uniq) == 1:
        return uniq[0], 1
    gaps = [(uniq[i + 1] - uniq[i], uniq[i + 1])
            for i in range(len(uniq) - 1)]
    gaps.append((uniq[0] + size - uniq[-1], uniq[0]))
    biggest, origin = max(gaps)
    return origin, size - biggest + 1


def _check_rule(rule: LifeLikeRule) -> None:
    if 0 in rule.born:
        # A B0 rule births cells in empty space: the whole torus is
        # active and a live-bounding window is meaningless.
        raise ValueError(
            f"rule {rule.rulestring} births on 0 neighbours; "
            "use the dense engine")


class SparseTorus:
    """A sparse pattern on a `size` x `size` torus (size % 32 == 0)."""

    def __init__(
        self,
        size: int,
        cells: Iterable[Tuple[int, int]],
        rule: LifeLikeRule = CONWAY,
        device=None,
    ) -> None:
        from gol_tpu_torch.engine import resolve_device

        if size % WORD_BITS != 0:
            raise ValueError(f"torus size {size} not a multiple of 32")
        _check_rule(rule)
        self.device = resolve_device(device)
        self.size = size
        self.rule = rule
        self.turn = 0
        cells = list(cells)
        if not cells:
            raise ValueError("need at least one live cell")
        xs = [c[0] % size for c in cells]
        ys = [c[1] % size for c in cells]
        # Cyclic bounding box: a pattern straddling the torus seam is
        # small, not torus-spanning.
        x0, w = _cyclic_extent(xs, size)
        y0, h = _cyclic_extent(ys, size)
        if w > size // 2 or h > size // 2:
            raise ValueError(
                "pattern spans most of the torus — use the dense engine")
        # Initial window with a generous margin, aligned.
        margin = 64
        win_w = min(_round_up(w + 2 * margin, _COL_ALIGN), size)
        win_h = min(_round_up(h + 2 * margin, _ROW_ALIGN), size)
        _check_window_fits(win_h, win_w, self.device)
        # Torus origin of window cell (0, 0); word-aligned columns.
        self._ox = ((x0 - (win_w - w) // 2) // WORD_BITS * WORD_BITS) % size
        self._oy = (y0 - (win_h - h) // 2) % size
        board = np.zeros((win_h, win_w), dtype=np.uint8)
        for x, y in zip(xs, ys):
            board[(y - self._oy) % size, (x - self._ox) % size] = 1
        self._packed = words_from_numpy(pack_np(board), self.device)
        self._reset_occupancy()

    def _reset_occupancy(self) -> None:
        # The (rows, word columns) occupancy of `_packed` as one device
        # buffer (K8's), refreshed by every macro-step; None until then.
        self._occ: Optional[torch.Tensor] = None
        # Host-side margins cache: `_margins()` memoizes its fetch until
        # the board changes, and `_grow()` — which repositions a known
        # live box — fills it without touching the device.
        self._margins_host: Optional[Tuple[int, int, int, int]] = None
        self._margins_valid = False
        # Occupancy copies to the host (one an episode) and window grows,
        # for measurements.
        self.margin_fetches = 0
        self.grows = 0

    @classmethod
    def _from_state(
        cls,
        size: int,
        words: np.ndarray,
        ox: int,
        oy: int,
        rule: LifeLikeRule = CONWAY,
        device=None,
    ) -> "SparseTorus":
        """Rebuild a torus from checkpointed window state (np.uint32
        packed words + torus origin) — the restore half of
        `SparseEngine.save_checkpoint`."""
        from gol_tpu_torch.engine import resolve_device

        _check_rule(rule)
        self = cls.__new__(cls)
        self.device = resolve_device(device)
        self.size = size
        self.rule = rule
        self.turn = 0
        self._ox = ox % size
        self._oy = oy % size
        words = np.asarray(words, dtype=np.uint32)
        _check_window_fits(words.shape[0], words.shape[1] * WORD_BITS,
                           self.device)
        self._packed = words_from_numpy(words, self.device)
        self._reset_occupancy()
        return self

    # ------------------------------------------------------------- queries

    def _occupancy(self) -> torch.Tensor:
        if self._occ is None:
            self._occ = window_occupancy(self._packed)
        return self._occ

    def alive_count(self) -> int:
        rows = self._occupancy()[:self._packed.shape[0]]
        return int(rows.sum(dtype=torch.int64))

    def window_shape(self) -> Tuple[int, int]:
        h, wp = self._packed.shape
        return h, wp * WORD_BITS

    def alive_cells(self) -> List[Tuple[int, int]]:
        """Live cells in torus coordinates (col, row), unordered."""
        dense = unpack_np(words_to_numpy(self._packed))
        ys, xs = np.nonzero(dense)
        return [
            (int((x + self._ox) % self.size),
             int((y + self._oy) % self.size))
            for x, y in zip(xs, ys)
        ]

    # ------------------------------------------------------------- bbox

    def _margins(self) -> Optional[Tuple[int, int, int, int]]:
        """(top, bottom, left, right) dead margins of the window, with
        column granularity of one 32-bit word; None when no cell lives.

        Memoized on the host until the board changes: one device-to-host
        copy of the occupancy an episode."""
        if self._margins_valid:
            return self._margins_host
        h, wp = self._packed.shape
        occ = self._occupancy().cpu().numpy()
        self.margin_fetches += 1
        live_rows = np.nonzero(occ[:h])[0]
        live_cols = np.nonzero(occ[h:])[0]
        if live_rows.size == 0:
            result = None
        else:
            top = int(live_rows[0])
            bottom = int(h - 1 - live_rows[-1])
            left = int(live_cols[0]) * WORD_BITS
            right = int(wp - 1 - live_cols[-1]) * WORD_BITS
            result = (top, bottom, left, right)
        self._margins_host = result
        self._margins_valid = True
        return result

    def _grow(self, need: int) -> None:
        """Re-center the live region in a window with >= `need` margin on
        every side (or the full torus if that is reached). Caller ensures
        the board is non-empty."""
        top, bottom, left, right = self._margins()
        h, wp = self._packed.shape
        w = wp * WORD_BITS
        live_h = h - top - bottom
        live_w = w - left - right
        headroom = need * _GROW_NUM // _GROW_DEN + 64
        # Once the window outgrows one wide-align unit, snap widths to
        # 4096 cells, as the JAX package does for its banded kernel.
        col_align = (
            _WIDE_COL_ALIGN
            if live_w + 2 * headroom > _WIDE_COL_ALIGN
            else _COL_ALIGN
        )
        new_h = min(_round_up(live_h + 2 * headroom, _ROW_ALIGN),
                    self.size)
        new_w = min(_round_up(live_w + 2 * headroom, col_align),
                    self.size)
        _check_window_fits(new_h, new_w, self.device)
        pad_top = (new_h - live_h) // 2
        pad_left_words = ((new_w - live_w) // 2) // WORD_BITS
        new = torch.zeros((new_h, new_w // WORD_BITS),
                          dtype=self._packed.dtype, device=self.device)
        # The counterpart of lax.dynamic_update_slice: the live box,
        # copied on the device's stream.
        new[pad_top:pad_top + live_h,
            pad_left_words:pad_left_words + live_w // WORD_BITS] = \
            self._packed[top:h - bottom,
                         left // WORD_BITS:wp - right // WORD_BITS]
        self._ox = (self._ox + left - pad_left_words * WORD_BITS) \
            % self.size
        self._oy = (self._oy + top - pad_top) % self.size
        self._packed = new
        self._occ = None
        self.grows += 1
        # The grow only repositioned a live box whose bounds are known, so
        # the new margins are known exactly without a device fetch — this
        # is what lets a grow chain into the episode's macro-steps.
        pad_left = pad_left_words * WORD_BITS
        self._margins_host = (
            pad_top, new_h - pad_top - live_h,
            pad_left, new_w - pad_left - live_w,
        )
        self._margins_valid = True

    # ------------------------------------------------------------- stepping

    def _safe_budget(self, remaining: int) -> Optional[int]:
        """Turns provably safe to run WITHOUT re-measuring occupancy:
        min(relevant margins) - 1. None when the pattern died out;
        `remaining` when every axis is saturated at the full torus (the
        window's wrap is the torus's; checked before the margins fetch,
        so a saturated window never syncs)."""
        h, wp = self._packed.shape
        relevant_axes = []
        if h < self.size:
            relevant_axes += [0, 1]
        if wp * WORD_BITS < self.size:
            relevant_axes += [2, 3]
        if not relevant_axes:
            return remaining
        m = self._margins()
        if m is None:
            return None
        return min(m[a] for a in relevant_axes) - 1

    def _issue_macro(self, k: int) -> None:
        """Queue one k-turn macro-step and the occupancy of its result on
        the device's stream; nothing waits for them."""
        from gol_tpu_torch.parallel.halo import (
            packed_run_by_kind,
            packed_run_kind,
        )

        step = packed_run_by_kind(packed_run_kind(self._packed.shape))
        self._packed = step(self._packed, k, self.rule)
        self._occ = window_occupancy(self._packed)
        self._margins_valid = False
        self.turn += k

    def run(self, turns: int, macro: Optional[int] = None) -> None:
        """Advance `turns` turns in adaptively-sized macro-steps of
        <= `macro` (default `_MACRO_CAP`) turns each.

        Macro-steps are issued in synchronization-free EPISODES: one
        margins measurement establishes a safe turn budget, which is
        spent as a chain of queued launches — a window grow (whose
        post-grow margins are known analytically) followed by
        ladder-quantized macros. The host waits again only at the next
        episode's measurement."""
        cap = macro if macro else _MACRO_CAP
        done = 0
        while done < turns:
            remaining = turns - done
            budget = self._safe_budget(remaining)
            if budget is None:
                # Pattern died out: with no B0 birth an empty board stays
                # empty forever.
                self.turn += remaining
                return
            target = min(remaining, cap)
            if budget < min(target, _MACRO_MIN):
                # Margin can't cover a worthwhile macro: grow for the
                # deepest quantized depth (margins then known).
                k = target if target < _MACRO_MIN else _ladder_floor(
                    target)
                self._grow(k + 1)
                budget = self._safe_budget(remaining)
                assert budget is not None
            # Spend the whole measured budget without further syncs.
            while done < turns and budget > 0:
                k = min(turns - done, cap)
                if k > budget:
                    k = _ladder_floor(budget)
                    if k == 0:
                        break  # leftover < _MACRO_MIN: re-measure
                self._issue_macro(k)
                done += k
                budget -= k
