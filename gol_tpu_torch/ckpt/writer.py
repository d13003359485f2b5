"""Background double-buffered checkpoint writer — the counterpart of
`gol_tpu/ckpt/writer.py` (without its fleet `CheckpointWriterPool`,
ROADMAP A11).

The turn loop never blocks on disk: at a chunk boundary the engine
captures a Snapshot (the board tensor, the stream that produced it, and
metadata: a lock-held pointer copy) and `submit()`s it. The writer
thread then does everything expensive off the hot loop: the
device-to-host copy, payload serialization, SHA-256, the
payload-first/manifest-last atomic publish, and retention GC.

The copy (`device_to_host`) runs on the engine's device and stream, in
row bands copied without blocking into one pinned buffer, each band with
its own CUDA event; the writer waits on the events, never the chunk
loop. Chunks never write their input, so the snapshot's tensor is the
board of its turn for as long as the Snapshot holds it — which it does
until the events have fired, so the caching allocator cannot hand that
memory to a later chunk while the copy still reads it.

Packed words travel as the JAX package's np.uint32 (`<u4`): the port's
int32 carrier is reinterpreted, never converted by value, so
`board_sha256` (which hashes dtype and shape with the bytes) agrees with
`gol_tpu`'s, and `gol_tpu` loads the payload (it refuses non-uint32
words).

Double buffering: one snapshot in write + at most one pending. A third
submit before the disk catches up REPLACES the pending snapshot (newest
state wins) and the superseded one is counted as
`gol_ckpt_writes_total{status="dropped"}` rather than queued.

`write_sync()` is the same pipeline on the CALLING thread — the
emergency paths (SIGTERM, engine-loop exception, the Checkpoint wire
method) where there may be no later boundary to wait for.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
from typing import Optional, Tuple

import numpy as np
import torch

from gol_tpu_torch import wire
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt.retention import RetentionPolicy, dir_lock
from gol_tpu_torch.models.lenia import ALIVE_THRESHOLD
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import trace as obs_trace
from gol_tpu_torch.obs.log import log as obs_log

# Same compression policy as the legacy engine autosave
# (engine.Engine.CKPT_COMPRESS_LIMIT): small payloads are
# zlib-compressed, huge ones written raw.
COMPRESS_LIMIT = 64 * 1024 * 1024

# Manifest trigger values (clamped — manifests are machine-read).
TRIGGERS = ("periodic", "final", "emergency", "sigterm", "manual",
            "remote")

# 8-bit popcount LUT for the packed-word alive marker.
_POP8 = np.array([bin(i).count("1") for i in range(256)], dtype=np.uint8)


class Snapshot:
    """One checkpointable engine state, captured at a chunk boundary.

    `cells` is a board tensor (the writer copies it to the host on
    `stream`, the stream that produced it; None = the device's current
    stream) or an already-host numpy array. `mesh` is the writing
    engine's placement geometry (`{"devices": 1}` for the port's
    engine), `fuse` its temporal-fusion depth."""

    __slots__ = ("cells", "repr", "turn", "board", "rule", "trigger",
                 "mesh", "fuse", "stream")

    def __init__(self, cells, repr_: str, turn: int,
                 board: Tuple[int, int], rule: str,
                 trigger: str = "periodic", mesh: Optional[dict] = None,
                 fuse: int = 1, stream=None):
        self.cells = cells
        self.repr = repr_
        self.turn = turn
        self.board = board
        self.rule = rule
        self.trigger = trigger if trigger in TRIGGERS else "manual"
        self.mesh = dict(mesh) if mesh else None
        self.fuse = int(fuse)
        self.stream = stream


def device_to_host(cells: torch.Tensor, stream=None) -> np.ndarray:
    """A board tensor's host copy as numpy. On CUDA: row bands of about
    GOL_WIRE_BAND_BYTES copied without blocking into one pinned buffer on
    `stream` (None = the device's current stream), then a wait on each
    band's own event. The caller names the stream, so a thread that did
    not make the tensor still copies it in order behind the work that
    produced it. CPU tensors are returned as their numpy view."""
    if cells.device.type != "cuda":
        return cells.numpy()
    rows2d = cells.reshape(-1, cells.shape[-1])
    band = max(1, wire.band_bytes()
               // max(1, rows2d.shape[1] * rows2d.element_size()))
    with torch.cuda.device(cells.device):
        if stream is None:
            stream = torch.cuda.current_stream(cells.device)
        with torch.cuda.stream(stream):
            host = torch.empty(cells.shape, dtype=cells.dtype,
                               pin_memory=True)
            host2d = host.view(-1, cells.shape[-1])
            events = []
            for r0 in range(0, rows2d.shape[0], band):
                host2d[r0:r0 + band].copy_(rows2d[r0:r0 + band],
                                           non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
                events.append(done)
            for done in events:
                done.synchronize()
    return host.numpy()


def _materialize(snap: Snapshot) -> np.ndarray:
    """Snapshot -> host array. Blocks until the copy is real — on the
    WRITER thread, where that wait overlaps the engine's next chunks."""
    if isinstance(snap.cells, np.ndarray):
        return snap.cells
    return device_to_host(snap.cells, snap.stream)


def _words(host: np.ndarray) -> np.ndarray:
    """4-byte integer words (the port's int32 carrier, or uint32) as the
    JAX package's np.uint32, by reinterpretation."""
    a = np.ascontiguousarray(host)
    if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
        raise ValueError(f"packed words must be 4-byte integers, "
                         f"got {a.dtype}")
    return a.view(np.uint32)


def payload_arrays(host: np.ndarray, repr_: str) -> dict:
    """The payload .npz members for one representation — EXACTLY the
    format `Engine.load_checkpoint` (of either package) accepts, so every
    manifest payload doubles as a legacy checkpoint file."""
    if repr_ == "packed":
        words = _words(host)
        return {"words": words, "width": words.shape[-1] * 32}
    if repr_ == "gen3":
        planes = _words(host)
        return {"gen_planes": planes, "width": planes.shape[-1] * 32}
    if repr_ == "gen8":
        return {"gen_state": host}
    if repr_ == "f32":
        # Continuous boards (Lenia) checkpoint their exact float32 state;
        # a pixel quantization would corrupt the dynamics.
        return {"float_state": host.astype(np.float32, copy=False)}
    if repr_ == "u8":
        # {0,1} cells -> the legacy {0,255} pixel format.
        return {"world": (host * np.uint8(255)).astype(np.uint8)}
    raise ValueError(f"no checkpoint payload for repr {repr_!r}")


def _alive_count(host: np.ndarray, repr_: str) -> int:
    """Firing population of the host payload — the manifest's second
    determinism marker, exact and representation-aware."""
    if repr_ == "packed":
        return int(_POP8[host.view(np.uint8)].sum(dtype=np.int64))
    if repr_ == "gen3":
        return int(_POP8[np.ascontiguousarray(host[0]).view(np.uint8)]
                   .sum(dtype=np.int64))
    if repr_ == "gen8":
        return int((host == 1).sum(dtype=np.int64))
    if repr_ == "f32":
        return int((host > ALIVE_THRESHOLD).sum(dtype=np.int64))
    return int(host.sum(dtype=np.int64))


class CheckpointWriter:
    def __init__(self, directory: str, run_id: str,
                 keep_last: int = 3, keep_every: int = 0) -> None:
        self.directory = directory
        self.run_id = run_id
        self.retention = RetentionPolicy(keep_last=keep_last,
                                         keep_every=keep_every)
        self._cv = threading.Condition()
        self._pending: Optional[Snapshot] = None
        self._busy = False
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------ submit

    def submit(self, snap: Snapshot) -> bool:
        """Hand a snapshot to the background thread; returns False when
        it REPLACED an unwritten pending snapshot (counted as dropped).
        Never blocks beyond the condition lock."""
        with self._cv:
            if self._closed:
                raise RuntimeError("checkpoint writer is closed")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, daemon=True, name="gol-ckpt-writer")
                self._thread.start()
            replaced = self._pending is not None
            self._pending = snap
            self._cv.notify_all()
        if replaced:
            obs.CKPT_WRITES.labels(status="dropped").inc()
        return not replaced

    def flush(self, timeout: Optional[float] = None) -> bool:
        """Wait until the pending snapshot (if any) is durably written.
        True on drained, False on timeout."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cv:
            while self._pending is not None or self._busy:
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return False
                self._cv.wait(remaining)
        return True

    def close(self, timeout: Optional[float] = None) -> bool:
        """Flush then stop accepting snapshots. The daemon thread exits
        on its own once drained."""
        drained = self.flush(timeout)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        return drained

    # ----------------------------------------------------------- writing

    def write_sync(self, snap: Snapshot) -> str:
        """Write one checkpoint ON THIS THREAD (emergency/manual path);
        returns the manifest path. Raises on failure — synchronous
        callers (the Checkpoint wire method) need the error."""
        return self._write(snap)

    def _loop(self) -> None:
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None and self._closed:
                    return
                snap = self._pending
                self._pending = None
                self._busy = True
            try:
                self._write(snap)
            except Exception as e:
                # Periodic checkpointing must never kill the run it
                # exists to protect; the failure is counted, logged,
                # and kept for flush()-side inspection.
                self.last_error = e
                obs_log("ckpt.write_failed", level="error",
                        turn=snap.turn, error=f"{type(e).__name__}: {e}")
            finally:
                del snap  # the board tensor goes once its copy is done
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _write(self, snap: Snapshot) -> str:
        t0 = time.monotonic()
        with obs_trace.span("ckpt.save",
                            attrs={"turn": snap.turn, "repr": snap.repr,
                                   "trigger": snap.trigger}) as span:
            try:
                path = self._write_inner(snap)
            except Exception:
                obs.CKPT_WRITES.labels(status="error").inc()
                raise
            finally:
                obs.CKPT_WRITE_SECONDS.observe(time.monotonic() - t0)
            span.attrs["path"] = os.path.basename(path)
        obs.CKPT_WRITES.labels(status="ok").inc()
        obs.CKPT_LAST_TURN.set(snap.turn)
        return path

    def _write_inner(self, snap: Snapshot) -> str:
        host = _materialize(snap)
        arrays = payload_arrays(host, snap.repr)
        payload_member = next(v for v in arrays.values()
                              if hasattr(v, "nbytes"))
        save = (np.savez_compressed
                if payload_member.nbytes <= COMPRESS_LIMIT else np.savez)
        base = mf.ckpt_basename(snap.turn)
        payload_name = base + mf.PAYLOAD_SUFFIX
        payload = os.path.join(self.directory, payload_name)
        man_path = os.path.join(self.directory, base + mf.MANIFEST_SUFFIX)
        # One writer mutates a directory at a time (the run's background
        # writer vs a SIGTERM-handler write_sync on another thread):
        # publishes stay ordered and retention never sweeps mid-publish.
        with dir_lock(self.directory):
            fd, tmp = tempfile.mkstemp(prefix=payload_name + ".",
                                       suffix=".tmp", dir=self.directory)
            try:
                with os.fdopen(fd, "wb") as f:
                    save(f, turn=snap.turn, rulestring=snap.rule,
                         **arrays)
                    f.flush()
                    os.fsync(f.fileno())
                os.replace(tmp, payload)  # payload published FIRST
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
            payload_bytes = os.path.getsize(payload)
            manifest = {
                "schema": mf.MANIFEST_SCHEMA,
                "run_id": self.run_id,
                "turn": int(snap.turn),
                "rule": snap.rule,
                "repr": snap.repr,
                "board": {"h": int(snap.board[0]),
                          "w": int(snap.board[1])},
                "dtype": str(payload_member.dtype),
                "shape": [int(s) for s in payload_member.shape],
                "payload": payload_name,
                "payload_sha256": mf.sha256_file(payload),
                "payload_bytes": int(payload_bytes),
                "board_sha256": mf.board_sha256(arrays),
                "alive": _alive_count(host, snap.repr),
                "trigger": snap.trigger,
                "created_unix": int(time.time()),
                "writer": _writer_ident(),
            }
            device = _device_ident(snap.cells)
            if device is not None:
                manifest["device"] = device
            if snap.mesh:
                manifest["mesh"] = snap.mesh
            if snap.fuse > 1:
                manifest["fuse"] = snap.fuse
            jinfo = self._journal_digest(snap, manifest)
            if jinfo is not None:
                # The chain head rides the manifest: a restore knows the
                # newest journal state the checkpoint covers, and a
                # verifier can prove the file wasn't truncated.
                manifest["journal"] = jinfo
            mf.write_manifest(man_path, manifest)  # durability bit LAST
            obs.CKPT_BYTES.inc(payload_bytes)
            self.retention.apply(self.directory, locked=True)
        return man_path

    def _journal_digest(self, snap: Snapshot,
                        manifest: dict) -> Optional[dict]:
        """Journal one board-digest event for this checkpoint and return
        the chain head to stamp into the manifest, or None while the run
        isn't journaling. The board hash was already computed for the
        manifest, so the journal rides the checkpoint for free."""
        try:
            from gol_tpu_torch import journal as journal_mod

            jw = journal_mod.get(self.run_id)
            if jw is None:
                return None
            jw.digest(snap.turn, manifest["board_sha256"],
                      repr_=snap.repr, trigger=snap.trigger,
                      alive=manifest["alive"])
            return jw.head_info()
        except Exception:  # journaling must never sink a checkpoint
            return None


def _writer_ident() -> dict:
    return {"pid": os.getpid(), "torch": torch.__version__,
            "numpy": np.__version__}


def _device_ident(cells) -> Optional[dict]:
    """Device kind and, on CUDA, the caching allocator's live and peak
    bytes, for the manifest; None for a host snapshot. read_manifest
    tolerates extra keys, so old readers skip this block."""
    if not isinstance(cells, torch.Tensor):
        return None
    dev = cells.device
    if dev.type != "cuda":
        return {"kind": dev.type, "devices": 1}
    stats = torch.cuda.memory_stats(dev)
    return {"kind": torch.cuda.get_device_name(dev), "devices": 1,
            "live_bytes": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes": int(stats.get("allocated_bytes.all.peak", 0))}
