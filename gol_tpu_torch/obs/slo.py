"""RPC latency quantiles with bounded memory — the counterpart of
`gol_tpu/obs/slo.py` for the control plane (its fleet-health cache waits
for ROADMAP A11).

A **log-bucket quantile estimator**: a fixed array of log-spaced buckets
covering [lo, hi] seconds. One observation is one `log()` plus one
integer increment; memory is O(buckets) forever; the reported quantile is
within one geometric bucket width of the exact sample quantile
(`true <= reported <= true * ratio` for values inside [lo, hi]).

Estimators are updated per RPC (`observe_rpc`); the derived
`gol_rpc_latency_ms{kind,method,q}` gauges move only every
`FLUSH_SECONDS`. `GOL_SLO_P99_MS` (default 0 = disabled) sets a p99
objective in ms: a flush that finds a method's p99 above it increments
`gol_slo_breaches_total{kind,method}` and records a flight-recorder
event.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import flight as obs_flight

# 50 µs (well under one loopback RPC) to 60 s; 96 buckets over that span
# is a ratio of ~1.158 per bucket — the ~16% one-bucket-width bound.
DEFAULT_LO = 50e-6
DEFAULT_HI = 60.0
DEFAULT_BUCKET_COUNT = 96

FLUSH_SECONDS = 0.5

SLO_P99_ENV = "GOL_SLO_P99_MS"


class LogBucketEstimator:
    """Fixed log-spaced-bucket quantile estimator (no sample retention).
    `percentiles(qs)` returns, for each q, the upper edge of the bucket
    holding the rank-q sample; samples below `lo` or above `hi` clamp to
    the edge buckets."""

    __slots__ = ("lo", "hi", "ratio", "_log_lo", "_inv_log_step",
                 "_n", "_counts", "_lock", "count", "sum")

    def __init__(self, lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 buckets: int = DEFAULT_BUCKET_COUNT) -> None:
        if not (0.0 < lo < hi) or buckets < 1:
            raise ValueError(f"need 0 < lo < hi and buckets >= 1, got "
                             f"lo={lo} hi={hi} buckets={buckets}")
        self.lo = float(lo)
        self.hi = float(hi)
        self._n = int(buckets)
        span = math.log(self.hi / self.lo)
        self.ratio = math.exp(span / self._n)
        self._log_lo = math.log(self.lo)
        self._inv_log_step = self._n / span
        self._counts = [0] * self._n
        self._lock = threading.Lock()
        self.count = 0
        self.sum = 0.0

    def bucket_index(self, value: float) -> int:
        if not value > self.lo:  # also catches NaN / <=0 -> bucket 0
            return 0
        if value >= self.hi:
            return self._n - 1
        i = int((math.log(value) - self._log_lo) * self._inv_log_step)
        # float rounding at an exact edge can land one off either way
        return 0 if i < 0 else (self._n - 1 if i >= self._n else i)

    def bucket_upper(self, i: int) -> float:
        """Upper edge of bucket i (== hi for the last bucket)."""
        return self.hi if i >= self._n - 1 else \
            self.lo * self.ratio ** (i + 1)

    def observe(self, value: float) -> None:
        v = float(value)
        i = self.bucket_index(v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v

    def percentiles(self, qs: Sequence[float]) -> Tuple[Optional[float],
                                                        ...]:
        """Quantile values for qs in [0, 1]; None while empty."""
        with self._lock:
            total = self.count
            counts = list(self._counts)
        if total <= 0:
            return tuple(None for _ in qs)
        out: List[Optional[float]] = []
        for q in qs:
            rank = min(total, max(1, math.ceil(float(q) * total)))
            cum = 0
            hit = self._n - 1
            for i, c in enumerate(counts):
                cum += c
                if cum >= rank:
                    hit = i
                    break
            out.append(self.bucket_upper(hit))
        return tuple(out)


# ------------------------------------------------------- RPC instrumentation

_rpc_lock = threading.Lock()
_rpc: Dict[Tuple[str, str], LogBucketEstimator] = {}
# count already published per estimator, so a flush only re-derives and
# breach-checks methods that actually saw traffic in the window.
_published: Dict[Tuple[str, str], int] = {}
_flush_lock = threading.Lock()
_last_flush = 0.0


def _estimator(kind: str, method: str) -> LogBucketEstimator:
    key = (kind, method)
    est = _rpc.get(key)
    if est is None:
        with _rpc_lock:
            est = _rpc.setdefault(key, LogBucketEstimator())
    return est


def slo_p99_ms() -> float:
    """The configured p99 objective in ms (0 = disabled), read per flush."""
    try:
        return float(os.environ.get(SLO_P99_ENV, "0") or 0.0)
    except ValueError:
        return 0.0


def observe_rpc(kind: str, method: str, seconds: float,
                now: Optional[float] = None) -> None:
    """One RPC latency sample. `kind` is one of catalog.RPC_KINDS;
    `method` is clamped to the declared wire-method set so hostile
    headers can't mint label values."""
    m = obs.method_label(method)
    _estimator(kind, m).observe(seconds)
    maybe_flush(time.monotonic() if now is None else now)


def maybe_flush(now: float) -> None:
    if now - _last_flush < FLUSH_SECONDS:
        return
    flush(now)


def flush(now: Optional[float] = None) -> None:
    """Publish every active estimator's p50/p95/p99 to the
    gol_rpc_latency_ms gauges and run the breach check."""
    global _last_flush
    if now is None:
        now = time.monotonic()
    with _flush_lock:
        _last_flush = now
        with _rpc_lock:
            items = list(_rpc.items())
        objective = slo_p99_ms()
        for (kind, method), est in items:
            seen = est.count
            if seen == _published.get((kind, method)):
                continue
            _published[(kind, method)] = seen
            p50, p95, p99 = est.percentiles((0.50, 0.95, 0.99))
            if p50 is None:
                continue
            for q, v in (("p50", p50), ("p95", p95), ("p99", p99)):
                obs.RPC_LATENCY_MS.labels(
                    kind=kind, method=method, q=q).set(round(v * 1e3, 3))
            if objective > 0.0 and p99 * 1e3 > objective:
                obs.RPC_SLO_BREACHES.labels(kind=kind,
                                            method=method).inc()
                obs_flight.FLIGHT.record_event({
                    "ts": round(time.time(), 3), "level": "warning",
                    "event": "slo.breach", "kind": kind,
                    "method": method,
                    "p99_ms": round(p99 * 1e3, 3),
                    "objective_ms": objective,
                    "samples": seen})
