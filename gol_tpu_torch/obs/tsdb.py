"""Bounded in-memory multi-resolution time-series rings — the counterpart
of `gol_tpu/obs/tsdb.py`.

The registry tier keeps a short history of every fleet signal it
aggregates (the sensing half of a fleet autoscaler's control loop) —
but a router is a long-lived control-plane process and MUST NOT grow
without bound, so retention is rings all the way down:

    tier   resolution   capacity (default)   span
    raw    10 s         90 points            ~15 min
    1m     60 s         120 points           ~2 h
    10m    600 s        144 points           ~24 h

Every append lands in ALL tiers at once: each tier keeps one open
bucket at its ring tail and merges samples whose timestamp falls in
that bucket (count/sum/min/max/last), pushing a new slot — and
evicting the oldest when full — only when the bucket rolls over.
That makes downsampling EXACT (a 1m bucket's min/max/mean/last are
computed from the raw samples themselves, not re-aggregated from the
raw tier's buckets) and append O(1) with no background compaction
thread.

Cardinality is hard-capped: at most GOL_TSDB_MAX_SERIES distinct
(name, labels) series; inserting past the cap evicts the least-
recently-appended series and meters it (gol_tsdb_evictions_total).
A runaway label source degrades retention, never memory.

Stdlib-only, same discipline as obs/metrics.py.
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict, deque
from typing import Optional, Tuple

from gol_tpu_torch.obs import catalog as obs

__all__ = ["TSDB", "Tier", "tier_table"]

# Env knobs (read at TSDB construction, so tests can monkeypatch).
ENV_RAW_RES = "GOL_TSDB_RAW_RES"        # raw tier bucket width, seconds
ENV_RAW_CAP = "GOL_TSDB_RAW_CAP"        # raw tier ring capacity, points
ENV_1M_CAP = "GOL_TSDB_1M_CAP"
ENV_10M_CAP = "GOL_TSDB_10M_CAP"
ENV_MAX_SERIES = "GOL_TSDB_MAX_SERIES"  # hard cardinality cap

DEFAULT_RAW_RES = 10.0
DEFAULT_RAW_CAP = 90
DEFAULT_1M_CAP = 120
DEFAULT_10M_CAP = 144
DEFAULT_MAX_SERIES = 512


def _env_float(name: str, default: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return v if v > 0 else default


def _env_int(name: str, default: int) -> int:
    try:
        v = int(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return v if v > 0 else default


class Tier:
    """One resolution ring: fixed-capacity deque of merged buckets.

    Each slot is a mutable list [bucket_start_s, count, min, max, sum,
    last] — the open bucket is always the tail; samples older than the
    open bucket merge into it rather than resurrecting closed buckets
    (out-of-order arrivals are rare and sub-resolution here)."""

    __slots__ = ("name", "res_s", "cap", "ring")

    def __init__(self, name: str, res_s: float, cap: int) -> None:
        self.name = name
        self.res_s = float(res_s)
        self.cap = max(int(cap), 1)
        self.ring: deque = deque(maxlen=self.cap)

    def append(self, ts: float, value: float) -> None:
        bucket = ts - (ts % self.res_s)
        ring = self.ring
        if ring and bucket <= ring[-1][0]:
            slot = ring[-1]
            slot[1] += 1
            if value < slot[2]:
                slot[2] = value
            if value > slot[3]:
                slot[3] = value
            slot[4] += value
            slot[5] = value
        else:
            # deque(maxlen) drops the head for us: eviction is the ring
            # overwriting its oldest bucket, by construction.
            ring.append([bucket, 1, value, value, value, value])

    def points(self, since: float = 0.0) -> list:
        out = []
        for slot in self.ring:
            if slot[0] < since:
                continue
            out.append({"t": slot[0], "count": slot[1], "min": slot[2],
                        "max": slot[3], "mean": slot[4] / slot[1],
                        "last": slot[5]})
        return out


def _tier_specs() -> Tuple[Tuple[str, float, int], ...]:
    raw_res = _env_float(ENV_RAW_RES, DEFAULT_RAW_RES)
    return (
        ("raw", raw_res, _env_int(ENV_RAW_CAP, DEFAULT_RAW_CAP)),
        ("1m", 60.0, _env_int(ENV_1M_CAP, DEFAULT_1M_CAP)),
        ("10m", 600.0, _env_int(ENV_10M_CAP, DEFAULT_10M_CAP)),
    )


def tier_table() -> list:
    """The retention table (resolution × capacity ⇒ span) as data —
    rendered on /healthz and in fleet_top, documented in
    docs/OBSERVABILITY.md."""
    return [{"tier": n, "res_s": r, "cap": c, "span_s": r * c}
            for n, r, c in _tier_specs()]


class _Series:
    __slots__ = ("name", "labels", "tiers")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 specs) -> None:
        self.name = name
        self.labels = labels
        self.tiers = {n: Tier(n, r, c) for n, r, c in specs}


class TSDB:
    """The bounded store: `append` is O(1) (one lock, one dict move,
    three ring merges); `query` returns merged buckets for one tier.

    Memory ceiling = max_series × Σ tier capacities × one 6-field
    slot — fixed at construction, independent of uptime."""

    def __init__(self, max_series: Optional[int] = None,
                 now=time.time) -> None:
        self._specs = _tier_specs()
        self.max_series = (_env_int(ENV_MAX_SERIES, DEFAULT_MAX_SERIES)
                           if max_series is None else max(int(max_series), 1))
        self._now = now
        self._lock = threading.Lock()
        # OrderedDict in least-recently-appended order: eviction pops
        # from the front, append moves the series to the back.
        self._series: "OrderedDict[tuple, _Series]" = OrderedDict()
        self._points_total = 0
        self._evictions_total = 0

    @staticmethod
    def _key(name: str, labels) -> tuple:
        if not labels:
            return (name,)
        if isinstance(labels, dict):
            labels = labels.items()
        return (name,) + tuple(sorted(
            (str(k), str(v)) for k, v in labels))

    def append(self, name: str, value: float, labels=(),
               ts: Optional[float] = None) -> None:
        try:
            value = float(value)
        except (TypeError, ValueError):
            return
        if ts is None:
            ts = self._now()
        key = self._key(name, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                while len(self._series) >= self.max_series:
                    self._series.popitem(last=False)
                    self._evictions_total += 1
                series = _Series(name, key[1:], self._specs)
                self._series[key] = series
            else:
                self._series.move_to_end(key)
            for tier in series.tiers.values():
                tier.append(ts, value)
            self._points_total += 1
        self._publish()

    def _publish(self) -> None:
        obs.TSDB_SERIES.set(len(self._series))
        obs.TSDB_POINTS.set(self._points_total)
        obs.TSDB_EVICTIONS.set(self._evictions_total)

    def query(self, name: str, labels=(), tier: str = "raw",
              since: float = 0.0) -> list:
        key = self._key(name, labels)
        with self._lock:
            series = self._series.get(key)
            if series is None:
                return []
            t = series.tiers.get(tier)
            return t.points(since) if t is not None else []

    def series_names(self) -> list:
        with self._lock:
            rows = [{"name": s.name, "labels": dict(s.labels)}
                    for s in self._series.values()]
        rows.sort(key=lambda d: (d["name"], sorted(d["labels"].items())))
        return rows

    def doc(self) -> dict:
        """Summary for /healthz and GetTelemetry — counts only, never
        the point data (that's what `query` is for)."""
        with self._lock:
            return {"series": len(self._series),
                    "points_total": self._points_total,
                    "evictions_total": self._evictions_total,
                    "max_series": self.max_series,
                    "tiers": tier_table()}
