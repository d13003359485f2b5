"""Convolution/FFT stencil tier — large-radius neighborhood sums; the
counterpart of `gol_tpu/ops/conv.py`.

Every other kernel of the port is radius-1 bitplane arithmetic
(`ops/cuda_stencil.py`, K1-K6); a radius-r neighborhood sum needs two
more tiers:

* **conv** — direct-space circular sums. The Moore box of a
  Larger-than-Life rule on a uint8 board runs kernel K7
  (`ops/cuda_stencil.ltl_box_run_turns`): a whole turn, count and rule,
  in one launch on the card. `_conv_sum` is the JAX tier's sum in torch:
  box kernels as the separable shift-add over rolls (K7's plain
  version), general kernels (`N`, `C`, Lenia's shell) through
  `torch.nn.functional.conv2d` on a wrap-padded board — the counterpart
  of `lax.conv_general_dilated`, with cuDNN's TF32 off (TF32 keeps ~10
  bits of a smooth Lenia tap, past the 1e-4 tolerance).
* **fft** — circular convolution by the convolution theorem:
  `irfft2(rfft2(board - mean) * Kspec) + mean * sum(K)` with the kernel
  spectrum computed once per (shape, kernel) in float64 numpy and held
  as complex64 on the board's device (cached per (h, w, kernel, device)).
  The mean split removes the DC term that dominates float32 round-off,
  so `rint` recovers exact integer counts (`chip_smoke.py` checks that
  cuFFT keeps them exact at 4096² up to r = 32).

Where each tier wins is the card's own: K7 beats the FFT tier on boxes
up to r = 64 at 4096² and up to r = 128 on smaller boards
(`CROSSOVER_FFT_RADIUS`); F.conv2d loses to it from a few cells of
radius (`CROSSOVER_FFT_RADIUS_GENERAL`).

Tier selection (`GOL_KERNEL_TIER=auto|bitplane|fused|conv|fft`) is
policy: `select_tier` picks per (board, radius, dtype, neighbourhood
kind) from those tables; callers that implement a subset of the tiers
(the engine's conv families) pass `allowed=`. The run functions never
write their input: each turn's board is a new tensor (K7 ping-pongs two
buffers its wrapper allocates), so the engine's snapshots may hold a
chunk's input while the next chunk runs.
"""

from __future__ import annotations

import functools
import os
from typing import Optional, Sequence

import numpy as np
import torch

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.ops import cuda_stencil

TIER_ENV = "GOL_KERNEL_TIER"
TIERS = ("bitplane", "fused", "conv", "fft")

# Crossover tables: the radius at or above which the FFT tier beats the
# direct-space conv tier, keyed by board area ceiling, one for each form
# of the direct tier. The JAX package's table (a CPU host, crossover ~12)
# does not carry over. GOL_CONV_CROSSOVER=<radius> overrides both.
CROSSOVER_ENV = "GOL_CONV_CROSSOVER"
# The Moore box, which K7 runs. Measured on the card (chip_smoke.py phase
# 5, `timing_ltl`: ms a turn of K7 at its tile policy beside the FFT
# tier's turn, one NVIDIA H100 80GB HBM3 at 700 W; PERF.md §6): at 512²
# and 1024² K7 wins at every radius up to LargerThanLifeRule's limit of
# 128 (1024² r=128: 0.1053 against 0.6588 ms), so no radius selects the
# FFT there; at 4096² K7 wins up to r=64 (0.2995 against 1.0658 ms) and
# the FFT at r=128 (1.0609 against 1.5805 ms).
CROSSOVER_FFT_RADIUS = (
    # (max board area, fft wins at radius >=)
    (1 << 20, 129),  # <= 1024²: never (r <= 128)
    (1 << 63, 128),  # 4096² and beyond
)
# Every other kind ('N', 'C'), whose direct tier is F.conv2d with (2r+1)²
# dense taps: its cost grows with r² where the FFT's stays flat. Measured
# the same way (a circular neighbourhood's F.conv2d turn beside the FFT
# tier's; both host-bound near 0.4-0.8 ms on the small boards), the FFT
# wins at every radius from: r=12 at 512² (0.4717 against 0.7732 ms;
# F.conv2d at r=8, 0.4833 against 0.5633), r=5 at 1024² (0.7159 against
# 0.7779), r=3 at 4096² (1.1974 against 1.2006; at r=8 1.0624 against
# 18.1029).
CROSSOVER_FFT_RADIUS_GENERAL = (
    (1 << 18, 12),  # <= 512²
    (1 << 20, 5),   # <= 1024²
    (1 << 63, 3),   # 4096² and beyond
)


def _crossover_radius(area: int, kind: str = "M") -> int:
    raw = os.environ.get(CROSSOVER_ENV, "").strip()
    if raw:
        try:
            return max(2, int(raw))
        except ValueError:
            pass  # fall through to the measured table
    table = (CROSSOVER_FFT_RADIUS if kind == "M"
             else CROSSOVER_FFT_RADIUS_GENERAL)
    for max_area, r in table:
        if area <= max_area:
            return r
    return table[-1][1]


def select_tier(h: int, w: int, radius: int, dtype: str = "uint8",
                allowed: Sequence[str] = TIERS, kind: str = "M") -> str:
    """The kernel tier for one (board, radius, dtype, kind) — the one
    policy point every conv-family dispatch resolves through.

    `dtype` is the CELL dtype ("uint8" for binary boards, "float32" for
    continuous state); float boards have no bitplane form, so the
    binary-only tiers are never selected for them. `allowed` clamps to
    the tiers the caller implements (the engine's conv families run
    conv/fft only). `kind` is the neighbourhood's: 'M' (the Moore box,
    K7's) takes `CROSSOVER_FFT_RADIUS`; 'N', 'C' and Lenia's 'shell'
    (F.conv2d's) take `CROSSOVER_FFT_RADIUS_GENERAL`."""
    allowed = tuple(t for t in TIERS if t in allowed)
    if not allowed:
        raise ValueError("no kernel tiers allowed")
    forced = os.environ.get(TIER_ENV, "auto").strip().lower() or "auto"
    if forced != "auto":
        if forced not in TIERS:
            raise ValueError(
                f"bad {TIER_ENV}={forced!r}: want auto|" + "|".join(TIERS))
        if forced in allowed:
            return forced
        # A forced tier the caller can't run falls through to auto,
        # loudly, as in the JAX package.
        import warnings

        warnings.warn(
            f"{TIER_ENV}={forced} unavailable here (allowed: "
            f"{allowed}); auto-selecting instead")
    binary = str(dtype) in ("uint8", "uint32", "bool")
    if binary and radius <= 1:
        from gol_tpu_torch.ops.fused import configured_fuse_k

        if "fused" in allowed and configured_fuse_k() > 1:
            return "fused"
        if "bitplane" in allowed:
            return "bitplane"
    if "fft" not in allowed:
        return "conv"
    if "conv" not in allowed:
        return "fft"
    if not binary:
        # Dense smooth kernels (Lenia) have no separable form: the JAX
        # package's policy sends float boards to the FFT at every radius;
        # conv stays reachable through GOL_KERNEL_TIER=conv.
        return "fft"
    return "fft" if radius >= _crossover_radius(h * w, kind) else "conv"


def note_dispatch(tier: str) -> None:
    """Meter one conv-family dispatch: the `gol_conv_dispatches_total`
    counter plus the one-hot `gol_kernel_tier` gauge."""
    obs.CONV_DISPATCHES.labels(tier=tier).inc()
    for t in TIERS:
        obs.KERNEL_TIER.labels(tier=t).set(1.0 if t == tier else 0.0)


# ------------------------------------------------------------- kernels


def neighborhood_kernel(radius: int, kind: str = "M",
                        middle: bool = False) -> np.ndarray:
    """(2r+1, 2r+1) float32 {0,1} mask of the neighborhood:
    'M' Moore box, 'N' von Neumann diamond (|dy|+|dx| <= r),
    'C' circular (dy² + dx² <= r²). `middle` includes the center cell
    (the LtL M1 convention: a cell counts itself for survival)."""
    r = int(radius)
    if r < 1:
        raise ValueError(f"radius must be >= 1, got {radius}")
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    if kind == "M":
        mask = np.ones((2 * r + 1, 2 * r + 1), dtype=bool)
    elif kind == "N":
        mask = (np.abs(dy) + np.abs(dx)) <= r
    elif kind == "C":
        mask = (dy * dy + dx * dx) <= r * r
    else:
        raise ValueError(f"unknown neighborhood kind {kind!r}")
    mask[r, r] = bool(middle)
    return mask.astype(np.float32)


def _embed_kernel(kernel: np.ndarray, h: int, w: int) -> np.ndarray:
    """Center a (2r+1, 2r+1) kernel into an (h, w) circular-convolution
    field: tap (dy, dx) lands at index (dy mod h, dx mod w), so
    out[y, x] = sum_k kernel[k] * board[y - dy_k, x - dx_k] on the
    torus matches the direct wrap-padded convolution exactly."""
    kh, kw = kernel.shape
    r = kh // 2
    if kh > h or kw > w:
        raise ValueError(
            f"kernel {kernel.shape} exceeds board {(h, w)} — a "
            f"neighborhood wider than the torus would self-overlap")
    field = np.zeros((h, w), dtype=np.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            v = kernel[dy + r, dx + r]
            if v:
                field[dy % h, dx % w] += v
    return field


# ------------------------------------------------------- conv tier


def _box_center_delta(kern: np.ndarray) -> Optional[float]:
    """If `kern` is an all-ones box apart from its center tap, return
    (center − 1) — the separable decomposition box + delta·δ₀. None
    when the kernel is not a box (disc/diamond/smooth kernels)."""
    k = np.asarray(kern, dtype=np.float32).copy()
    r = k.shape[0] // 2
    center = float(k[r, r])
    k[r, r] = 1.0
    if k.shape[0] == k.shape[1] and np.all(k == 1.0):
        return center - 1.0
    return None


@functools.lru_cache(maxsize=64)
def _kernel_np(kernel_key) -> np.ndarray:
    return kernel_from_key(kernel_key)


@functools.lru_cache(maxsize=64)
def _kernel_tensor(kernel_key, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_kernel_np(kernel_key)).to(device)


@functools.lru_cache(maxsize=64)
def _wrap_index(n: int, r: int, device: torch.device) -> torch.Tensor:
    """Indices of a row (or column) of the board wrap-padded by r cells
    a side, by true modulo: r may exceed n, as numpy's wrap pad allows."""
    return (torch.arange(-r, n + r, device=device) % n)


def _conv_sum(board: torch.Tensor, kernel_key) -> torch.Tensor:
    """(H, W) float32 board -> float32 circular neighborhood sums.

    Box kernels (the LtL Moore case) take the separable shift-add path:
    (2r+1)-wide sums along each axis via torus rolls, in the JAX order
    (4r+2 full-board adds, exact for integer boards: float32 holds every
    partial below 2^24). General kernels go through conv2d on a
    wrap-padded board (the dense O(r²)-taps form) with TF32 off."""
    kern = _kernel_np(kernel_key)
    r = kern.shape[0] // 2
    delta = _box_center_delta(kern)
    if delta is not None:
        acc = board
        for d in range(1, r + 1):
            acc = acc + torch.roll(board, d, 0) + torch.roll(board, -d, 0)
        out = acc
        for d in range(1, r + 1):
            out = out + torch.roll(acc, d, 1) + torch.roll(acc, -d, 1)
        if delta:
            out = out + float(delta) * board
        return out
    h, w = board.shape
    rows = _wrap_index(h, r, board.device)
    cols = _wrap_index(w, r, board.device)
    padded = board.index_select(0, rows).index_select(1, cols)
    # NCHW activations / OIHW taps: a single-feature 2-D correlation.
    with torch.backends.cudnn.flags(
            enabled=torch.backends.cudnn.enabled,
            benchmark=torch.backends.cudnn.benchmark,
            deterministic=torch.backends.cudnn.deterministic,
            allow_tf32=False):
        out = torch.nn.functional.conv2d(
            padded[None, None].to(torch.float32),
            _kernel_tensor(kernel_key, board.device)[None, None])
    return out[0, 0]


def conv_neighbor_sum(board, kernel_key) -> torch.Tensor:
    """Neighborhood sums through the direct-space conv tier. Exact for
    integer-valued boards (float32 holds every sum below 2^24)."""
    return _conv_sum(torch.as_tensor(board).to(torch.float32), kernel_key)


# -------------------------------------------------------- fft tier


@functools.lru_cache(maxsize=64)
def _fft_spectrum_np(h: int, w: int, kernel_key) -> np.ndarray:
    """The kernel spectrum: rfft2 of the kernel embedded in the (h, w)
    circular field, computed once per (shape, kernel) in float64 and held
    as complex64 (the board transform is float32)."""
    field = _embed_kernel(_kernel_np(kernel_key), h, w)
    return np.fft.rfft2(field.astype(np.float64)).astype(np.complex64)


@functools.lru_cache(maxsize=64)
def _fft_spectrum(h: int, w: int, kernel_key,
                  device: torch.device) -> torch.Tensor:
    """`_fft_spectrum_np` on `device`, copied there once."""
    return torch.from_numpy(_fft_spectrum_np(h, w, kernel_key)).to(device)


@functools.lru_cache(maxsize=64)
def _kernel_sum(kernel_key) -> float:
    return float(_kernel_np(kernel_key).sum())


def _fft_sum(board: torch.Tensor, kernel_key) -> torch.Tensor:
    """(H, W) float32 board -> float32 circular neighborhood sums via
    rfft2/irfft2 with the cached kernel spectrum, mean-split for integer
    exactness (module docstring). The mean stays on the device."""
    h, w = board.shape
    spec = _fft_spectrum(h, w, kernel_key, board.device)
    mean = torch.mean(board)
    ac = torch.fft.irfft2(torch.fft.rfft2(board - mean) * spec, s=(h, w))
    return ac + mean * _kernel_sum(kernel_key)


def fft_neighbor_sum(board, kernel_key) -> torch.Tensor:
    """Neighborhood sums through the FFT tier (float32 result; callers
    needing exact integer counts `rint` it — see `_ltl_counts`)."""
    return _fft_sum(torch.as_tensor(board).to(torch.float32), kernel_key)


# ------------------------------------------------- kernel-key registry


def kernel_from_key(kernel_key) -> np.ndarray:
    """Decode a hashable kernel description into its float32 taps.

    Keys:
      ("ltl", radius, kind, middle)  — {0,1} neighborhood mask
      ("lenia", radius)              — see models/lenia.py
    """
    head = kernel_key[0]
    if head == "ltl":
        _, radius, kind, middle = kernel_key
        return neighborhood_kernel(radius, kind, middle)
    if head == "lenia":
        from gol_tpu_torch.models.lenia import lenia_kernel_from_key

        return lenia_kernel_from_key(kernel_key)
    raise ValueError(f"unknown kernel key {kernel_key!r}")


def neighbor_sum(board: torch.Tensor, kernel_key,
                 tier: str) -> torch.Tensor:
    """Dispatch one neighborhood sum through the named tier."""
    if tier == "conv":
        return conv_neighbor_sum(board, kernel_key)
    if tier == "fft":
        return fft_neighbor_sum(board, kernel_key)
    raise ValueError(
        f"tier {tier!r} has no general-radius neighbor_sum (the "
        f"bitplane/fused tiers are radius-1 life-like only)")


# --------------------------------------------- engine-facing run fns
#
# The engine calls `run(cells, k, rule)` once a chunk; these functions
# return such callables with the tier fixed, cached per tier as the JAX
# package's are.


def _ltl_counts(cells_f32: torch.Tensor, rule, tier: str) -> torch.Tensor:
    """Exact int32 neighborhood counts for a {0,1} board."""
    s = neighbor_sum(cells_f32, rule.kernel_key, tier)
    # conv sums are exact already; fft sums carry <0.5 round-off.
    return torch.round(s).to(torch.int32)


def _ltl_step(cells: torch.Tensor, rule, tier: str) -> torch.Tensor:
    """One Larger-than-Life turn on {0,1} uint8 cells in torch ops:
    neighborhood count (center included iff the rule says so) ->
    interval tests against the rule's survive/born count ranges (the
    numpy oracle keeps the LUT gather). On the conv tier with a box
    kernel this is K7's plain version."""
    counts = _ltl_counts(cells.to(torch.float32), rule, tier)

    def in_ranges(spans):
        ok = torch.zeros(counts.shape, dtype=torch.bool,
                         device=counts.device)
        for lo, hi in spans:
            ok = ok | ((counts >= lo) & (counts <= min(hi, 1 << 30)))
        return ok

    alive = torch.where(cells == 1, in_ranges(rule.survive_ranges),
                        in_ranges(rule.born_ranges))
    return alive.to(torch.uint8)


@functools.lru_cache(maxsize=8)
def ltl_run_fn(tier: str):
    """Engine run fn for the Larger-than-Life family on the given tier
    (uint8 {0,1} cells, one device). A Moore-box rule on the conv tier
    runs K7, a whole chunk in one call (`ltl_box_run_turns`: the gate is
    the rule's kind alone; on a CPU tensor the wrapper runs the plain
    version); other neighborhoods, and the FFT tier, step in torch ops."""

    def run(cells: torch.Tensor, k: int, rule) -> torch.Tensor:
        if k == 0:
            return cells
        if tier == "conv" and rule.kind == "M":
            return cuda_stencil.ltl_box_run_turns(cells, k, rule)
        for _ in range(k):
            cells = _ltl_step(cells, rule, tier)
        return cells

    return run


@functools.lru_cache(maxsize=8)
def lenia_run_fn(tier: str):
    """Engine run fn for the Lenia family: float32 state in [0, 1],
    smooth-kernel neighborhood sum -> growth -> clipped Euler step
    (models/lenia.py owns the math; this wires it to the tier). No host
    sync inside a chunk."""
    from gol_tpu_torch.models.lenia import lenia_step

    def run(cells: torch.Tensor, k: int, rule) -> torch.Tensor:
        for _ in range(k):
            cells = lenia_step(cells, rule, tier)
        return cells

    return run


def run_turns(cells, num_turns: int, rule, tier: Optional[str] = None):
    """Standalone conv-tier turn loop (tests, `chip_smoke.py`): advance
    `num_turns` turns of an LtL or Lenia rule on the given tier
    (auto-selected from the board when None). The JAX package's
    step-signature counter (`obs/devstats.note_signature`) waits for
    ROADMAP A13."""
    cells = torch.as_tensor(cells)
    h, w = cells.shape[-2], cells.shape[-1]
    if tier is None:
        tier = select_tier(h, w, rule.radius,
                           str(cells.dtype).replace("torch.", ""),
                           allowed=("conv", "fft"),
                           kind=getattr(rule, "kind", "shell"))
    from gol_tpu_torch.models.lenia import LeniaRule

    fn = (lenia_run_fn(tier) if isinstance(rule, LeniaRule)
          else ltl_run_fn(tier))
    note_dispatch(tier)
    return fn(cells, num_turns, rule)


# ---------------------------------------------------- numpy oracle


def box_counts_np(board: np.ndarray, radius: int,
                  middle: bool = False) -> np.ndarray:
    """Independent O(H·W) oracle for Moore-box neighborhood counts on
    the torus: wrap-pad + summed-area table, no convolution and no FFT
    anywhere near it."""
    r = int(radius)
    b = np.pad(np.asarray(board, dtype=np.int64), r, mode="wrap")
    s = np.zeros((b.shape[0] + 1, b.shape[1] + 1), dtype=np.int64)
    s[1:, 1:] = b.cumsum(axis=0).cumsum(axis=1)
    k = 2 * r + 1
    h, w = board.shape
    counts = (s[k:k + h, k:k + w] - s[0:h, k:k + w]
              - s[k:k + h, 0:w] + s[0:h, 0:w])
    if not middle:
        counts = counts - np.asarray(board, dtype=np.int64)
    return counts


def counts_np(board: np.ndarray, kernel: np.ndarray) -> np.ndarray:
    """General-kernel oracle: direct tap accumulation over np.roll
    shifts. O(H·W·r²) — small boards/radii only (tests)."""
    kh, kw = kernel.shape
    r = kh // 2
    out = np.zeros(board.shape, dtype=np.float64)
    b = np.asarray(board, dtype=np.float64)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            v = float(kernel[dy + r, dx + r])
            if v:
                out += v * np.roll(np.roll(b, dy, axis=0), dx, axis=1)
    return out
