"""Resume: resolve a checkpoint reference, verify it, install it — a copy
of `gol_tpu/ckpt/restore.py` over the port's engine.

`--resume` accepts three spellings and `resolve()` normalizes them:

    a directory      -> the newest durable manifest inside it
    a *.json file    -> that manifest
    anything else    -> a legacy single-file .npz (the pre-manifest
                        autosave format), loaded without manifest
                        verification but with the engine's own
                        structural checks

Manifest restores are verified end-to-end (schema + payload size +
recomputed SHA-256) BEFORE any bytes reach the engine — a corrupted
checkpoint is refused with CheckpointIntegrityError, never half-loaded.
The payload itself is the legacy npz format, so the engine's existing
`load_checkpoint` does the actual install and the saved turn re-enters
the chunked run loop exactly where it left off.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt import reshard as _reshard
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.log import log as obs_log


def resolve(path: str) -> Tuple[str, Optional[str]]:
    """Normalize a --resume reference to ("manifest", manifest_path) or
    ("legacy", npz_path). Raises FileNotFoundError when there is nothing
    to resume from."""
    if os.path.isdir(path):
        latest = mf.latest_checkpoint(path)
        if latest is None:
            raise FileNotFoundError(
                f"{path}: no durable checkpoint (no readable "
                f"{mf.CKPT_PREFIX}*{mf.MANIFEST_SUFFIX} manifest)")
        return "manifest", latest[1]
    if not os.path.exists(path):
        raise FileNotFoundError(f"{path}: no such checkpoint")
    if path.endswith(mf.MANIFEST_SUFFIX):
        return "manifest", path
    return "legacy", path


def restore_engine(engine, path: str, verify: bool = True,
                   reshard: bool = False) -> int:
    """Verify + install a checkpoint into `engine`; returns the restored
    turn. `engine` has the `load_checkpoint(npz_path)` and `geometry()`
    surface of the dense Engine.

    When the manifest records a geometry the engine disagrees with
    (mesh device count, the sparse-window representation — see
    ckpt/reshard.py), the restore is refused with `GeometryMismatch`
    (tagged rpc_error_kind="geometry") unless `reshard=True`, which
    routes the payload through the host-side canonical repack instead
    of the direct load — bit-identical, only the placement changes."""
    kind, target = resolve(path)
    with obs_trace.span("ckpt.restore",
                        attrs={"kind": kind,
                               "path": os.path.basename(target)}) as span:
        try:
            if kind == "manifest":
                m = (mf.verify_manifest(target) if verify
                     else mf.read_manifest(target))
                payload = mf.payload_path(target, m)
                delta = _reshard.restore_delta(m, engine)
                if delta and not reshard:
                    raise _reshard.GeometryMismatch(
                        f"{target}: checkpoint geometry does not match "
                        f"this engine ({'; '.join(delta)}); request a "
                        f"reshard (--reshard / reshard=True) to repack "
                        f"it")
                if delta:
                    span.attrs["reshard"] = "; ".join(delta)
                    turn = _reshard.reshard_into(engine, m, payload)
                else:
                    turn = engine.load_checkpoint(payload)
                if turn != m["turn"]:
                    # The payload decoded but disagrees with its own
                    # manifest — treat as corruption, refuse the state.
                    raise mf.CheckpointIntegrityError(
                        f"{target}: payload turn {turn} != manifest "
                        f"turn {m['turn']}")
            elif reshard:
                # Legacy npz has no manifest geometry to compare, but an
                # explicit reshard request still routes through the
                # canonical repack (e.g. a JAX sparse autosave).
                turn = _reshard.reshard_into(engine, None, target)
            else:
                turn = engine.load_checkpoint(target)
        except mf.CheckpointIntegrityError:
            obs.CKPT_RESTORES.labels(status="rejected").inc()
            raise
        except Exception:
            obs.CKPT_RESTORES.labels(status="error").inc()
            raise
        span.attrs["turn"] = turn
    obs.CKPT_RESTORES.labels(status="ok").inc()
    obs_log("ckpt.restored", kind=kind, turn=turn,
            path=os.path.basename(target))
    return turn
