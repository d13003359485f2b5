"""`gol-ckpt/1` manifests: the durability + integrity contract — a copy of
`gol_tpu/ckpt/manifest.py`, so either package reads and verifies the
other's checkpoints.

A checkpoint is DURABLE iff its manifest exists — the payload `.npz` is
published first (tmp+fsync+rename), the manifest second (same dance),
so readers ordering on manifests can never observe a manifest whose
payload is missing or torn, and a crash between the two publishes
leaves only an orphan payload that retention GC sweeps. Each manifest
records the SHA-256 of the payload FILE (integrity: a flipped bit or a
truncation is refused at restore) and a canonical SHA-256 of the BOARD
bytes (determinism marker: two runs that agree on a turn agree on this
hash regardless of compression or container layout — the bit-identical
resume contract's checkable form). No RNG state is recorded because the
system has none: evolution is a pure function of (board, rule, turns),
which is exactly what makes kill→resume→compare testable.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from typing import Iterator, Optional

MANIFEST_SCHEMA = "gol-ckpt/1"
MANIFEST_SUFFIX = ".json"
PAYLOAD_SUFFIX = ".npz"
CKPT_PREFIX = "ckpt-"
# Zero-padded turn in names: lexicographic order == turn order, so a
# directory listing is already the checkpoint timeline.
_TURN_DIGITS = 12

# Representations a manifest may declare: the dense engine's four (see
# engine.py `_repr`) plus the sparse engine's window state.
KNOWN_REPRS = ("packed", "u8", "gen8", "gen3", "sparse", "f32")


class CheckpointIntegrityError(ValueError):
    """A manifest or payload failed validation (hash mismatch, missing
    payload, malformed schema). Typed so restore paths can refuse loudly
    while callers distinguish 'corrupt' from 'absent'."""


def ckpt_basename(turn: int) -> str:
    return f"{CKPT_PREFIX}{turn:0{_TURN_DIGITS}d}"


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                break
            h.update(b)
    return h.hexdigest()


def board_sha256(arrays: dict) -> str:
    """Canonical board hash: the payload arrays' raw bytes in sorted key
    order, shape-prefixed. Container-independent (compression level,
    npz member order, scalar metadata do not affect it) — the manifest's
    determinism marker."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        v = arrays[key]
        if not hasattr(v, "tobytes"):
            continue  # scalars (width) ride the payload, not the hash
        h.update(key.encode())
        h.update(repr((v.dtype.str, v.shape)).encode())
        h.update(v.tobytes(order="C"))
    return h.hexdigest()


def atomic_write_bytes(path: str, data: bytes) -> None:
    """tmp + fsync + rename publish in `path`'s directory: after this
    returns, `path` is either the complete new content or (on a crash
    mid-call) untouched — never a prefix."""
    d = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                               suffix=".tmp", dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def write_manifest(path: str, manifest: dict) -> None:
    if manifest.get("schema") != MANIFEST_SCHEMA:
        raise ValueError(f"manifest schema must be {MANIFEST_SCHEMA!r}")
    atomic_write_bytes(
        path, (json.dumps(manifest, sort_keys=True, indent=1) + "\n")
        .encode())


_REQUIRED = {
    "schema": str, "run_id": str, "turn": int, "rule": str,
    "repr": str, "payload": str, "payload_sha256": str,
    "payload_bytes": int, "board_sha256": str,
}


def read_manifest(path: str) -> dict:
    """Parse + structurally validate one manifest. Raises
    CheckpointIntegrityError on anything malformed — a resume must
    never half-trust a manifest."""
    try:
        with open(path, encoding="utf-8") as f:
            m = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointIntegrityError(f"{path}: unreadable manifest: "
                                       f"{e}") from e
    if not isinstance(m, dict):
        raise CheckpointIntegrityError(f"{path}: manifest is not an object")
    if m.get("schema") != MANIFEST_SCHEMA:
        raise CheckpointIntegrityError(
            f"{path}: schema {m.get('schema')!r} != {MANIFEST_SCHEMA!r}")
    for key, typ in _REQUIRED.items():
        v = m.get(key)
        if not isinstance(v, typ) or (typ is int and isinstance(v, bool)):
            raise CheckpointIntegrityError(
                f"{path}: field {key!r} missing or not {typ.__name__}")
    if m["repr"] not in KNOWN_REPRS:
        raise CheckpointIntegrityError(
            f"{path}: unknown repr {m['repr']!r} "
            f"(known: {', '.join(KNOWN_REPRS)})")
    if m["turn"] < 0:
        raise CheckpointIntegrityError(f"{path}: negative turn")
    if os.path.basename(m["payload"]) != m["payload"]:
        # The payload reference is a sibling basename by construction; a
        # path component would let a tampered manifest point a verifying
        # reader at an arbitrary file.
        raise CheckpointIntegrityError(
            f"{path}: payload {m['payload']!r} is not a bare filename")
    board = m.get("board")
    if board is not None and (
            not isinstance(board, dict)
            or not isinstance(board.get("h"), int)
            or not isinstance(board.get("w"), int)):
        raise CheckpointIntegrityError(f"{path}: malformed board dims")
    return m


def payload_path(manifest_path: str, manifest: dict) -> str:
    return os.path.join(os.path.dirname(os.path.abspath(manifest_path)),
                        manifest["payload"])


def verify_manifest(manifest_path: str,
                    manifest: Optional[dict] = None) -> dict:
    """Full integrity check: parse/validate the manifest, then recompute
    the payload file's SHA-256 and compare. Returns the manifest dict.
    Raises CheckpointIntegrityError on any mismatch — the refusal the
    kill→resume contract requires for corrupted checkpoints."""
    m = manifest if manifest is not None else read_manifest(manifest_path)
    p = payload_path(manifest_path, m)
    if not os.path.exists(p):
        raise CheckpointIntegrityError(
            f"{manifest_path}: payload {m['payload']!r} is missing")
    size = os.path.getsize(p)
    if size != m["payload_bytes"]:
        raise CheckpointIntegrityError(
            f"{manifest_path}: payload is {size} bytes, manifest says "
            f"{m['payload_bytes']}")
    digest = sha256_file(p)
    if digest != m["payload_sha256"]:
        raise CheckpointIntegrityError(
            f"{manifest_path}: payload SHA-256 mismatch "
            f"({digest[:12]}… != {m['payload_sha256'][:12]}…) — "
            f"refusing a corrupted checkpoint")
    return m


def list_checkpoints(directory: str,
                     strict: bool = False) -> Iterator[tuple]:
    """Yield (turn, manifest_path, manifest) for every DURABLE checkpoint
    in `directory`, turn-ascending. Malformed manifests are skipped
    (strict=False: a directory shared with a crashed writer must still
    resume from its good checkpoints) or raised (strict=True: the
    inspect tool's audit mode)."""
    try:
        names = sorted(os.listdir(directory))
    except FileNotFoundError:
        return
    for name in names:
        if not (name.startswith(CKPT_PREFIX)
                and name.endswith(MANIFEST_SUFFIX)):
            continue
        path = os.path.join(directory, name)
        try:
            m = read_manifest(path)
        except CheckpointIntegrityError:
            if strict:
                raise
            continue
        yield m["turn"], path, m


def latest_checkpoint(directory: str) -> Optional[tuple]:
    """(turn, manifest_path, manifest) of the newest durable checkpoint,
    or None. Newest by TURN (names sort the same way by construction)."""
    best = None
    for item in list_checkpoints(directory):
        if best is None or item[0] >= best[0]:
            best = item
    return best
