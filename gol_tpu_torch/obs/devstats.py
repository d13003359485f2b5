"""Step-signature and fusion telemetry — the part of
`gol_tpu/obs/devstats.py` that the fleet uses.

* `note_signature()` / `signature_count()` — step-signature tracking.
  In the JAX package each new signature is a fresh trace and compile;
  the port compiles nothing per shape (its kernels are built once), but
  it keeps the same keys, so "admitting a run into existing capacity
  adds no signature" is witnessed the same way in both packages.
* `note_fuse()` / `fuse_field()` — the temporal-fusion depth of the
  most recent engine, behind the `gol_fuse_k` gauge.
* `healthz_fields()` — the cached device fields a health document
  carries. The JAX compile hooks have no counterpart; device-memory
  polling waits for ROADMAP A13(b), so `live_bytes` is None.
"""

from __future__ import annotations

import threading

from gol_tpu_torch.obs import catalog as _cat

_lock = threading.Lock()
_signatures: set = set()
_fuse_k: int = 1


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
    """Device fields for a health document, without a device sync."""
    import torch

    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else None)
    return {"device_kind": kind, "live_bytes": None,
            "compile_count": 0, "mesh": {}}
