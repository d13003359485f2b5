"""Lenia — continuous cellular automaton, the repo's first non-binary
board (float32 state in [0, 1]); the counterpart of
`gol_tpu/models/lenia.py`. The rule, the kernel, the float64 oracle, the
seed and the digest are copies; `growth` and `lenia_step` are torch
functions on a float32 tensor.

One turn is a clipped Euler step of a smooth local update:

    u  = (K * A)(x)                       # smooth-ring neighborhood sum
    A' = clip(A + dt * G(u), 0, 1)        # growth, bell-shaped

with K the classic Lenia shell kernel — K_c(q) = exp(4 - 1/(q(1-q)))
for q = d/R in (0, 1), zero elsewhere, normalized to sum 1 — and the
growth function G(u) = 2*exp(-(u - mu)^2 / (2 sigma^2)) - 1. R is the
kernel radius in cells; dt = 1/T the Euler step. (Lenia, Chan 2019 —
PAPERS.md; the Orbium glider lives at R=13, mu=0.15, sigma=0.015,
dt=0.1.)

The kernel is dense and smooth — there is no bitplane form, and at the
standard R >= 13 the FFT tier is the only sane dispatch; the kernel
tier policy (`ops/conv.select_tier`) makes that call per board.

Rulestrings (the fleet keys buckets and the wire keys runs by
rulestring, so Lenia needs one) are the repo-local form

    lenia:r=13,mu=0.15,sigma=0.015,dt=0.1

canonicalised via repr(float) so equal parameters always produce the
identical string (hashable frozen dataclass, same contract as every
other rule family).

`lenia_step` reads nothing back from the device: a chunk of turns is
issued without a host sync, as the JAX package's jitted scan is.
"""

from __future__ import annotations

import dataclasses
import hashlib
import re

import numpy as np
import torch

# "Alive" for telemetry on a continuous board: cells above this mass.
# The alive-count plumbing (chunk tokens, tickers, fleet popcount
# guards) wants an integer population; thresholding at 0.1 counts the
# cells that visibly carry pattern mass while ignoring numerically
# tiny residue.
ALIVE_THRESHOLD = 0.1

_RULE_RE = re.compile(
    r"^lenia:r=(?P<r>\d+),mu=(?P<mu>[0-9.eE+-]+),"
    r"sigma=(?P<sigma>[0-9.eE+-]+),dt=(?P<dt>[0-9.eE+-]+)$")


@dataclasses.dataclass(frozen=True)
class LeniaRule:
    """Canonicalised, hashable Lenia parameter set."""

    rulestring: str = "lenia:r=13,mu=0.15,sigma=0.015,dt=0.1"

    def __post_init__(self) -> None:
        m = _RULE_RE.match(self.rulestring.strip())
        if m is None:
            raise ValueError(
                f"bad Lenia rulestring {self.rulestring!r}; want "
                "'lenia:r=<R>,mu=<f>,sigma=<f>,dt=<f>', e.g. "
                "'lenia:r=13,mu=0.15,sigma=0.015,dt=0.1'")
        r = int(m.group("r"))
        if not 2 <= r <= 128:
            raise ValueError(f"Lenia radius {r} out of range 2..128")
        mu = float(m.group("mu"))
        sigma = float(m.group("sigma"))
        dt = float(m.group("dt"))
        if not 0.0 < mu < 1.0:
            raise ValueError(f"mu {mu} must be in (0, 1)")
        if not 0.0 < sigma < 1.0:
            raise ValueError(f"sigma {sigma} must be in (0, 1)")
        if not 0.0 < dt <= 1.0:
            raise ValueError(f"dt {dt} must be in (0, 1]")
        canon = (f"lenia:r={r},mu={repr(mu)},sigma={repr(sigma)},"
                 f"dt={repr(dt)}")
        object.__setattr__(self, "rulestring", canon)

    @property
    def _groups(self):
        return _RULE_RE.match(self.rulestring).groupdict()

    @property
    def radius(self) -> int:
        return int(self._groups["r"])

    @property
    def mu(self) -> float:
        return float(self._groups["mu"])

    @property
    def sigma(self) -> float:
        return float(self._groups["sigma"])

    @property
    def dt(self) -> float:
        return float(self._groups["dt"])

    @property
    def kernel_key(self):
        """Hashable kernel description for `ops/conv.kernel_from_key`."""
        return ("lenia", self.radius)


ORBIUM = LeniaRule()


def lenia_kernel_from_key(kernel_key) -> np.ndarray:
    """("lenia", radius) -> normalized float32 shell kernel taps."""
    _, radius = kernel_key
    r = int(radius)
    dy, dx = np.mgrid[-r:r + 1, -r:r + 1]
    q = np.sqrt(dy.astype(np.float64) ** 2 + dx ** 2) / r
    with np.errstate(divide="ignore", over="ignore"):
        core = np.where((q > 0) & (q < 1),
                        np.exp(4.0 - 1.0 / np.maximum(q * (1 - q),
                                                      1e-12)), 0.0)
    total = core.sum()
    if total <= 0:
        raise ValueError(f"degenerate Lenia kernel at radius {r}")
    return (core / total).astype(np.float32)


def growth(u: torch.Tensor, rule: LeniaRule) -> torch.Tensor:
    """G(u) = 2*exp(-(u-mu)^2 / (2 sigma^2)) - 1, in u's dtype."""
    d = (u - rule.mu) / rule.sigma
    return 2.0 * torch.exp(-0.5 * d * d) - 1.0


def lenia_step(state: torch.Tensor, rule: LeniaRule,
               tier: str = "fft") -> torch.Tensor:
    """One clipped Euler turn on (H, W) float32 state via the named
    kernel tier (the normalized kernel sums to 1, so u is already the
    weighted neighborhood mean). The JAX order of operations, in float32;
    no host sync."""
    from gol_tpu_torch.ops.conv import neighbor_sum

    u = neighbor_sum(state, rule.kernel_key, tier)
    return torch.clamp(state + rule.dt * growth(u, rule),
                       0.0, 1.0).to(torch.float32)


def step_np(state: np.ndarray, rule: LeniaRule) -> np.ndarray:
    """Independent numpy reference step (np.fft, float64) — the
    tolerance oracle for tests and the bench's Lenia leg."""
    s = np.asarray(state, dtype=np.float64)
    h, w = s.shape
    kern = lenia_kernel_from_key(rule.kernel_key).astype(np.float64)
    kh = kern.shape[0]
    r = kh // 2
    field = np.zeros((h, w))
    for ddy in range(-r, r + 1):
        for ddx in range(-r, r + 1):
            v = kern[ddy + r, ddx + r]
            if v:
                field[ddy % h, ddx % w] += v
    u = np.fft.irfft2(np.fft.rfft2(s) * np.fft.rfft2(field), s=(h, w))
    g = 2.0 * np.exp(-0.5 * ((u - rule.mu) / rule.sigma) ** 2) - 1.0
    return np.clip(s + rule.dt * g, 0.0, 1.0).astype(np.float32)


def seed_board(h: int, w: int, seed: int = 0,
               rule: LeniaRule = ORBIUM) -> np.ndarray:
    """Deterministic pinned-seed float32 board: smooth random blobs
    (uniform noise low-pass filtered by the rule's own kernel) —
    enough structure for nontrivial dynamics, fully reproducible from
    (h, w, seed, radius)."""
    rng = np.random.default_rng(seed)
    noise = rng.random((h, w))
    kern = lenia_kernel_from_key(rule.kernel_key).astype(np.float64)
    kh = kern.shape[0]
    r = kh // 2
    field = np.zeros((h, w))
    for ddy in range(-r, r + 1):
        for ddx in range(-r, r + 1):
            v = kern[ddy + r, ddx + r]
            if v:
                field[ddy % h, ddx % w] += v
    smooth = np.fft.irfft2(np.fft.rfft2(noise) * np.fft.rfft2(field),
                           s=(h, w))
    # Center the mass so neighborhood means land INSIDE the growth
    # bell (u ~ mu). Kernel smoothing leaves the noise at mean 0.5
    # with tiny variance; scaled naively the board saturates, G(u)
    # pins at -1 everywhere, and the "dynamics" degenerate to a
    # global decay no parity gate could tell from a broken kernel.
    z = (smooth - smooth.mean()) / max(float(smooth.std()), 1e-9)
    return np.clip(0.35 * z + 2.0 * rule.mu, 0.0, 1.0).astype(np.float32)


def board_digest(state: np.ndarray, decimals: int = 3) -> str:
    """Platform-tolerant digest of a float board: sha256 over the
    state rounded to `decimals` — FFT round-off differs across
    hosts/backends in the last ulps, so the digest quantizes well
    above that while still pinning every visible cell."""
    q = np.round(np.asarray(state, dtype=np.float64), decimals)
    q = q + 0.0  # fold -0.0 into +0.0 before hashing raw bytes
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(q).tobytes())
    return h.hexdigest()


def alive_count_np(state: np.ndarray) -> int:
    """Host-side telemetry population: cells above ALIVE_THRESHOLD."""
    return int((np.asarray(state) > ALIVE_THRESHOLD).sum())
