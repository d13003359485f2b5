"""In-process metrics registry: counters, gauges, windowed histograms — a
copy of `gol_tpu/obs/metrics.py`.

Dependency-free (stdlib only, so the control plane can meter itself in
processes that never touch a device) and deliberately tiny: metrics move
only at chunk and RPC boundaries, never inside a kernel, so a lock per
metric child is plenty.

Two export surfaces, same data:

    snapshot()           JSON-serializable dict (the `GetMetrics` wire
                         method)
    render_prometheus()  Prometheus text exposition v0.0.4

Histograms are cumulative-bucket Prometheus histograms that ALSO keep a
sliding window of recent observations (min/mean/max over the last W),
because a long-lived engine's interesting latencies are the recent
ones, not the since-boot aggregate.
"""

from __future__ import annotations

import json
import math
import threading
from collections import deque
from typing import Dict, Optional, Sequence, Tuple

# Latency-shaped default buckets (seconds): spans a sub-ms RPC through a
# multi-second chunk wall; +Inf is implicit.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)
HISTOGRAM_WINDOW = 64  # sliding-window observations kept per child


class Counter:
    """Monotonically non-decreasing count."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Point-in-time value (set/inc/dec).

    `set` and `value` are lock-free: a Python float attribute store/load
    is atomic under the GIL, and a gauge set is a plain overwrite — no
    read-modify-write to protect. Only `inc`/`dec` (RMW) take the lock.
    This matters because the engine publishes a handful of gauges at
    every chunk boundary; at µs chunk walls the per-set lock was
    measurable hot-loop overhead."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Cumulative-bucket histogram plus a sliding observation window."""

    def __init__(self, buckets: Sequence[float] = DEFAULT_BUCKETS,
                 window: int = HISTOGRAM_WINDOW) -> None:
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds or any(math.isnan(b) for b in bounds):
            raise ValueError(f"bad histogram buckets {buckets!r}")
        self._lock = threading.Lock()
        self._bounds = bounds
        self._bucket_counts = [0] * (len(bounds) + 1)  # last = +Inf
        self._count = 0
        self._sum = 0.0
        self._window: deque = deque(maxlen=max(int(window), 1))

    def observe(self, value: float) -> None:
        value = float(value)
        with self._lock:
            i = 0
            while i < len(self._bounds) and value > self._bounds[i]:
                i += 1
            self._bucket_counts[i] += 1
            self._count += 1
            self._sum += value
            self._window.append(value)

    def observe_batch(self, values: Sequence[float]) -> None:
        """Record many observations under ONE lock acquisition — the
        engine's chunk loop accumulates per-chunk latencies locally and
        flushes them here on a coarse interval, so the hot path pays a
        list append instead of a lock per chunk."""
        if not values:
            return
        with self._lock:
            for value in values:
                value = float(value)
                i = 0
                while i < len(self._bounds) and value > self._bounds[i]:
                    i += 1
                self._bucket_counts[i] += 1
                self._count += 1
                self._sum += value
                self._window.append(value)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def snapshot(self) -> dict:
        with self._lock:
            cumulative = []
            running = 0
            for bound, n in zip(self._bounds, self._bucket_counts):
                running += n
                cumulative.append([bound, running])
            win = list(self._window)
        out = {
            "count": self._count,
            "sum": self._sum,
            "buckets": cumulative,  # [upper_bound, cumulative_count]
        }
        if win:
            out["window"] = {
                "n": len(win),
                "min": min(win),
                "max": max(win),
                "mean": sum(win) / len(win),
                "last": win[-1],
            }
        return out


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricFamily:
    """One named metric plus its labelled children. With no label names
    the family IS its single child (inc/set/observe delegate), so
    unlabelled call sites read naturally."""

    def __init__(self, name: str, help_: str, kind: str,
                 label_names: Tuple[str, ...] = (), **child_kw) -> None:
        self.name = name
        self.help = help_
        self.kind = kind
        self.label_names = tuple(label_names)
        self._child_kw = child_kw
        self._lock = threading.Lock()
        self._children: Dict[Tuple[str, ...], object] = {}
        if not self.label_names:
            self._children[()] = _KINDS[kind](**child_kw)

    def labels(self, **labels: str):
        if set(labels) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(labels)} != declared "
                f"{sorted(self.label_names)}")
        key = tuple(str(labels[n]) for n in self.label_names)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = _KINDS[self.kind](**self._child_kw)
                self._children[key] = child
            return child

    def _solo(self):
        if self.label_names:
            raise ValueError(
                f"{self.name} is labelled {self.label_names}; "
                f"use .labels(...)")
        return self._children[()]

    # unlabelled delegation -------------------------------------------------
    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def observe_batch(self, values: Sequence[float]) -> None:
        self._solo().observe_batch(values)

    @property
    def value(self):
        return self._solo().value

    def children(self) -> Dict[Tuple[str, ...], object]:
        with self._lock:
            return dict(self._children)


class Registry:
    """Named metric families; snapshot-to-dict and Prometheus text."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: Dict[str, MetricFamily] = {}

    def _register(self, name: str, help_: str, kind: str,
                  label_names: Sequence[str], **child_kw) -> MetricFamily:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                # Idempotent re-registration (re-imports, test reloads) —
                # but a KIND/label clash is a programming error, not a
                # cache hit.
                if fam.kind != kind or fam.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} re-registered as {kind}"
                        f"{tuple(label_names)}; existing is {fam.kind}"
                        f"{fam.label_names}")
                return fam
            fam = MetricFamily(name, help_, kind, tuple(label_names),
                               **child_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_: str = "",
                label_names: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help_, "counter", label_names)

    def gauge(self, name: str, help_: str = "",
              label_names: Sequence[str] = ()) -> MetricFamily:
        return self._register(name, help_, "gauge", label_names)

    def histogram(self, name: str, help_: str = "",
                  label_names: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS,
                  window: int = HISTOGRAM_WINDOW) -> MetricFamily:
        return self._register(name, help_, "histogram", label_names,
                              buckets=buckets, window=window)

    def get(self, name: str) -> Optional[MetricFamily]:
        with self._lock:
            return self._families.get(name)

    def families(self) -> Dict[str, MetricFamily]:
        with self._lock:
            return dict(self._families)

    # ------------------------------------------------------------- exports

    def snapshot(self) -> dict:
        """JSON-serializable view of every family: the `GetMetrics` wire
        payload. Label values ride as dicts (JSON has no tuple keys)."""
        out = {}
        for name, fam in sorted(self.families().items()):
            values = []
            for key, child in sorted(fam.children().items()):
                labels = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    values.append({"labels": labels,
                                   "value": child.snapshot()})
                else:
                    values.append({"labels": labels, "value": child.value})
            out[name] = {"type": fam.kind, "help": fam.help,
                         "values": values}
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition format v0.0.4."""
        lines = []
        for name, fam in sorted(self.families().items()):
            if fam.help:
                lines.append(f"# HELP {name} {_escape_help(fam.help)}")
            lines.append(f"# TYPE {name} {fam.kind}")
            for key, child in sorted(fam.children().items()):
                labels = dict(zip(fam.label_names, key))
                if fam.kind == "histogram":
                    snap = child.snapshot()
                    for bound, cum in snap["buckets"]:
                        lines.append(
                            f"{name}_bucket"
                            f"{_fmt_labels({**labels, 'le': _fmt(bound)})}"
                            f" {cum}")
                    lines.append(
                        f"{name}_bucket"
                        f"{_fmt_labels({**labels, 'le': '+Inf'})}"
                        f" {snap['count']}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(labels)}"
                        f" {_fmt(snap['sum'])}")
                    lines.append(
                        f"{name}_count{_fmt_labels(labels)}"
                        f" {snap['count']}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)} "
                        f"{_fmt(child.value)}")
        return "\n".join(lines) + "\n"


def _fmt(v: float) -> str:
    """Shortest faithful number: integral floats print without the
    trailing .0 Prometheus parsers don't need."""
    f = float(v)
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape_help(s: str) -> str:
    return s.replace("\\", "\\\\").replace("\n", "\\n")


def _escape_label(s: str) -> str:
    return (s.replace("\\", "\\\\").replace("\n", "\\n")
            .replace('"', '\\"'))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape_label(str(v))}"'
                     for k, v in labels.items())
    return "{" + inner + "}"


# The process-wide default registry — what the engine, wire layer,
# `/metrics` endpoint, and `GetMetrics` wire method all share.
REGISTRY = Registry()


def get_registry() -> Registry:
    return REGISTRY


def snapshot_json() -> str:
    """Convenience: the default registry's snapshot as one JSON string."""
    return json.dumps(REGISTRY.snapshot(), sort_keys=True)
