"""Device memory, step-signature and fusion telemetry (gol_dev_* and the
signature and fusion families) — the counterpart of
`gol_tpu/obs/devstats.py` on `torch.cuda`.

* `poll_device_memory()` — reads `torch.cuda.memory_stats` for each
  visible CUDA device and publishes the live/peak/limit bytes gauges.
  Without CUDA (the CPU, as in the tests) the poll degrades to
  `gol_dev_mem_supported 0` and returns `None` fields rather than
  raising — the JAX package's graceful-None contract on its CPU backend.
  Live bytes are the caching allocator's allocated bytes (what tensors
  hold), peak its high-water mark, limit the device's total memory.
* `note_signature()` / `signature_count()` — step-signature tracking.
  In the JAX package each new signature is a fresh trace and compile;
  the port compiles nothing per shape (its kernels are built once), but
  it keeps the same keys, so "admitting a run into existing capacity
  adds no signature" is witnessed the same way in both packages.
* `note_fuse()` / `fuse_field()` — the temporal-fusion depth of the
  most recent engine, behind the `gol_fuse_k` gauge.
* `healthz_fields()` — the device fields a health document carries,
  read from the last poll's cache (never a device sync). The JAX
  compile hooks have no counterpart, so `compile_count` stays 0; mesh
  geometry waits for ROADMAP A5.
"""

from __future__ import annotations

import threading
from typing import Optional

from gol_tpu_torch.obs import catalog as _cat

_lock = threading.Lock()
_signatures: set = set()
_fuse_k: int = 1

# Cache of the last poll, read by healthz_fields() so the HTTP layer
# never touches the device.
_last_poll: dict = {
    "device_kind": None,
    "devices": None,
    "supported": None,
    "live_bytes": None,
    "peak_bytes": None,
    "per_device": None,
}


def memory_snapshot(index: int) -> Optional[dict]:
    """Memory stats of CUDA device `index`, or None where there are none:
    `{"live_bytes", "peak_bytes", "limit_bytes", "raw"}`, with `raw` the
    allocator's full flat stats dict."""
    import torch

    try:
        stats = torch.cuda.memory_stats(index)
        limit = int(torch.cuda.get_device_properties(index).total_memory)
    except (RuntimeError, AssertionError):
        return None
    return {
        "live_bytes": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0)),
        "limit_bytes": limit,
        "raw": {k: int(v) for k, v in stats.items()
                if isinstance(v, (int, float))},
    }


def _kind_summary(kinds) -> Optional[str]:
    """The plain kind when homogeneous, '+'-joined sorted distinct kinds
    when mixed, None for none."""
    distinct = sorted({str(k) for k in kinds if k})
    if not distinct:
        return None
    return distinct[0] if len(distinct) == 1 else "+".join(distinct)


def poll_device_memory() -> dict:
    """Poll every visible CUDA device, update the gauges, cache the
    result for healthz. Returns a summary dict; without CUDA it names
    the CPU, and its live/peak fields are None (the graceful-None
    contract)."""
    import torch

    if not torch.cuda.is_available():
        summary = {"device_kind": "cpu", "devices": 1, "supported": False,
                   "supported_devices": 0, "device_kinds": {"cpu": 1},
                   "live_bytes": None, "peak_bytes": None,
                   "per_device": {}}
        _cat.DEV_MEM_SUPPORTED.set(0.0)
        _cat.DEV_DEVICES.set(1.0)
        _cat.DEV_KIND_DEVICES.labels(kind=_cat.dev_kind_label("cpu")).set(
            1.0)
        with _lock:
            _last_poll.update(summary)
        return summary
    n = torch.cuda.device_count()
    per_device = {}
    kind_counts: dict = {}
    live_total = peak_total = 0
    for i in range(n):
        dev_id = str(i)
        kind = torch.cuda.get_device_name(i)
        kind_counts[kind] = kind_counts.get(kind, 0) + 1
        snap = memory_snapshot(i)
        _cat.DEV_MEM_STATS_SUPPORTED.labels(device=dev_id).set(
            0.0 if snap is None else 1.0)
        if snap is None:
            continue
        per_device[dev_id] = {k: snap[k] for k in
                              ("live_bytes", "peak_bytes", "limit_bytes")}
        live_total += snap["live_bytes"]
        peak_total += snap["peak_bytes"]
        _cat.DEV_LIVE_BYTES.labels(device=dev_id).set(snap["live_bytes"])
        _cat.DEV_PEAK_BYTES.labels(device=dev_id).set(snap["peak_bytes"])
        _cat.DEV_LIMIT_BYTES.labels(device=dev_id).set(snap["limit_bytes"])
    supported = bool(per_device)
    _cat.DEV_MEM_SUPPORTED.set(1.0 if supported else 0.0)
    _cat.DEV_DEVICES.set(float(n))
    for kind, count in kind_counts.items():
        _cat.DEV_KIND_DEVICES.labels(
            kind=_cat.dev_kind_label(kind)).set(float(count))
    summary = {
        "device_kind": _kind_summary(kind_counts),
        "devices": n,
        "supported": supported,
        "supported_devices": len(per_device),
        "device_kinds": kind_counts,
        "live_bytes": live_total if supported else None,
        "peak_bytes": peak_total if supported else None,
        "per_device": per_device,
    }
    with _lock:
        _last_poll.update(summary)
    return summary


def note_signature(key: tuple) -> bool:
    """Record a step signature; True if it is new this process."""
    with _lock:
        if key in _signatures:
            return False
        _signatures.add(key)
    _cat.COMPILE_STEP_SIGNATURES.inc()
    return True


def signature_count() -> int:
    with _lock:
        return len(_signatures)


def note_fuse(fuse_k: int) -> None:
    """Record the most recent engine's temporal-fusion depth (1 =
    unfused) and publish the gol_fuse_k gauge."""
    global _fuse_k
    fuse_k = max(1, int(fuse_k))
    with _lock:
        _fuse_k = fuse_k
    _cat.FUSE_K.set(float(fuse_k))


def fuse_field() -> int:
    """The fuse depth of the most recent engine (1 before any note)."""
    with _lock:
        return _fuse_k


def healthz_fields() -> dict:
    """Cached device fields for a health document — no device sync."""
    with _lock:
        cached = dict(_last_poll)
    return {"device_kind": cached["device_kind"],
            "live_bytes": cached["live_bytes"],
            "compile_count": 0, "mesh": {}}
