"""ctypes binding of the port's native host layer (`csrc/golnative.cpp`):
the PGM codec, bit packing, popcount, the half-block frame renderer and
the u64 CPU oracle `step_torus`, with `gol_tpu/native.py`'s names and
return contract.

`g++ -O3 -fPIC -shared -std=c++17` builds the source at first use, never
at import, into `build/gol_tpu_torch/` at the repository root, named by a
hash of the source and flags. The build runs under a lock and writes a
temporary file that is renamed into place, so processes building at once
never load a torn library.

Every wrapper returns None (False for `write_pgm`) when the library is
unavailable, and its callers take the numpy path, which gives the same
bytes: this layer is host code and hides no device work. The fallback is
never silent: a failed build is logged once with the compiler's message,
and `io/pgm.py` counts which codec served each read (its writes are
numpy's, the same bytes as `write_pgm` here).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_PKG = Path(__file__).resolve().parent
SOURCE = _PKG / "csrc" / "golnative.cpp"
BUILD_DIR = _PKG.parent / "build" / "gol_tpu_torch"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_path: Optional[Path] = None
_load_attempted = False

_i64 = ctypes.c_int64
_u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(dtype=np.uint64, flags="C_CONTIGUOUS")


def target_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libgolnative_{digest}.so"


def _compile(target: Path) -> Optional[str]:
    """Build `target`; returns None on success, else the failure's
    message (the compiler's output when it ran)."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return "no C++ compiler (g++ or c++) on PATH"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)}: {type(e).__name__}: {e}"
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return (f"{' '.join(cmd)} exited {proc.returncode}\n"
                f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return None


def _build_locked() -> Optional[Path]:
    """The built library's path, building it if missing; None (logged)
    when it cannot be built. Caller holds `_lock`."""
    target = target_path()
    if target.exists():
        return target
    err = _compile(target)
    if err is None:
        return target
    from gol_tpu_torch.obs.log import log as obs_log

    obs_log("native.build_failed", level="warning", source=str(SOURCE),
            error=err.strip())
    return None


def ensure_built() -> bool:
    """Build the library if it is missing; True when it exists
    afterwards. A library already loaded is not reloaded."""
    with _lock:
        return _build_locked() is not None


def _bind(cdll: ctypes.CDLL) -> ctypes.CDLL:
    cdll.gol_pgm_read_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(_i64), ctypes.POINTER(_i64),
        ctypes.POINTER(_i64)]
    cdll.gol_pgm_read_header.restype = ctypes.c_int
    cdll.gol_pgm_read_payload.argtypes = [
        ctypes.c_char_p, _i64, _u8p, _i64]
    cdll.gol_pgm_read_payload.restype = ctypes.c_int
    cdll.gol_pgm_write.argtypes = [ctypes.c_char_p, _u8p, _i64, _i64]
    cdll.gol_pgm_write.restype = ctypes.c_int
    cdll.gol_pack_bits.argtypes = [_u8p, _u32p, _i64, _i64]
    cdll.gol_pack_bits.restype = None
    cdll.gol_unpack_bits.argtypes = [_u32p, _u8p, _i64, _i64]
    cdll.gol_unpack_bits.restype = None
    cdll.gol_popcount_words.argtypes = [_u32p, _i64]
    cdll.gol_popcount_words.restype = _i64
    cdll.gol_render_halfblocks.argtypes = [
        _u8p, _i64, _i64, ctypes.c_char_p, _i64]
    cdll.gol_render_halfblocks.restype = _i64
    cdll.gol_step_torus_u64.argtypes = [_u64p, _u64p, _i64, _i64]
    cdll.gol_step_torus_u64.restype = None
    return cdll


def lib(build: bool = False) -> Optional[ctypes.CDLL]:
    """The loaded library, built on first call; None when it cannot be
    built or loaded. After a failure later calls return None at once,
    unless `build` asks for another attempt."""
    global _lib, _path, _load_attempted
    with _lock:
        if _lib is not None:
            return _lib
        if _load_attempted and not build:
            return None
        _load_attempted = True
        path = _build_locked()
        if path is None:
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except OSError as e:
            from gol_tpu_torch.obs.log import log as obs_log

            obs_log("native.load_failed", level="warning", path=str(path),
                    error=str(e))
            return None
        _path = path
        return _lib


def library_path() -> Optional[Path]:
    """Path of the loaded library (after `lib()`), else None."""
    lib()
    return _path


def available() -> bool:
    return lib() is not None


# ------------------------------------------------------------- wrappers

class HeaderParseError(ValueError):
    """The native header tokenizer rejected the file. It may be stricter
    than the format (it reads a 64 KB prefix), so callers re-parse the
    header in Python; payload failures raise plain ValueError and are
    final."""


def read_pgm(path: str) -> Optional[np.ndarray]:
    """Native PGM read; None if the library is unavailable. Raises
    HeaderParseError when the header is rejected and plain ValueError on
    bad payload bytes (io.pgm.read_pgm's contract)."""
    l = lib()
    if l is None:
        return None
    w, h, off = _i64(), _i64(), _i64()
    rc = l.gol_pgm_read_header(os.fsencode(path), ctypes.byref(w),
                               ctypes.byref(h), ctypes.byref(off))
    if rc == -1:
        # fopen failed without saying why: Python's open raises the
        # accurate OSError subclass (FileNotFoundError, ...).
        open(path, "rb").close()
        raise HeaderParseError(f"{path}: unreadable by the native codec")
    if rc != 0:
        raise HeaderParseError(f"{path}: bad PGM header (native rc {rc})")
    # Bound the allocation by the file before trusting the header's dims.
    cells = w.value * h.value
    if cells > os.path.getsize(path):
        raise ValueError(
            f"{path}: header claims {cells} payload bytes but the file "
            f"is only {os.path.getsize(path)} bytes")
    board = np.empty((h.value, w.value), dtype=np.uint8)
    rc = l.gol_pgm_read_payload(os.fsencode(path), off.value, board, cells)
    if rc == -21:
        raise ValueError(f"{path}: payload cells not in {{0, 255}}")
    if rc != 0:
        raise ValueError(f"{path}: bad PGM payload (native rc {rc})")
    return board


def write_pgm(path: str, board: np.ndarray) -> bool:
    """Native PGM write (no fsync); False if the library is
    unavailable."""
    l = lib()
    if l is None:
        return False
    board = np.ascontiguousarray(board, dtype=np.uint8)
    h, w = board.shape
    rc = l.gol_pgm_write(os.fsencode(path), board, w, h)
    if rc != 0:
        raise OSError(f"{path}: native PGM write failed (rc {rc})")
    return True


def pack_bits(pixels: np.ndarray) -> Optional[np.ndarray]:
    """(H, W) {0, nonzero} pixels to (H, W/32) uint32 words, bit b of
    word c the cell at column 32c + b (`ops.bitpack.pack`'s layout)."""
    l = lib()
    if l is None:
        return None
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w = pixels.shape
    if w % 32 != 0:
        raise ValueError(f"width {w} not a multiple of 32")
    words = np.empty((h, w // 32), dtype=np.uint32)
    l.gol_pack_bits(pixels, words, h, w)
    return words


def unpack_bits(words: np.ndarray) -> Optional[np.ndarray]:
    """(H, Wp) uint32 words to (H, 32 Wp) {0, 255} pixels."""
    l = lib()
    if l is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    h, wp = words.shape
    pixels = np.empty((h, wp * 32), dtype=np.uint8)
    l.gol_unpack_bits(words, pixels, h, wp * 32)
    return pixels


def popcount(words: np.ndarray) -> Optional[int]:
    l = lib()
    if l is None:
        return None
    words = np.ascontiguousarray(words, dtype=np.uint32)
    return int(l.gol_popcount_words(words, words.size))


def render_halfblocks(pixels: np.ndarray) -> Optional[str]:
    """UTF-8 half-block frame of a {0,255} board; None if unavailable."""
    l = lib()
    if l is None:
        return None
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    h, w = pixels.shape
    cap = (3 * w + 1) * ((h + 1) // 2) + 1
    buf = ctypes.create_string_buffer(cap)
    n = l.gol_render_halfblocks(pixels, h, w, buf, cap)
    if n < 0:
        raise RuntimeError("render buffer too small")
    return buf.raw[:n].decode("utf-8")


def step_torus(cells01: np.ndarray,
               num_turns: int = 1) -> Optional[np.ndarray]:
    """Conway turns on a {0,1} board with the uint64 bit-parallel host
    stepper; None if unavailable. Width must be a multiple of 64."""
    l = lib()
    if l is None:
        return None
    h, w = cells01.shape
    if w % 64 != 0:
        raise ValueError(f"width {w} not a multiple of 64")
    packed = np.packbits(
        np.ascontiguousarray(cells01, dtype=np.uint8),
        axis=1, bitorder="little",
    ).view(np.uint64).reshape(h, w // 64)
    cur = np.ascontiguousarray(packed)
    nxt = np.empty_like(cur)
    for _ in range(num_turns):
        l.gol_step_torus_u64(cur, nxt, h, w // 64)
        cur, nxt = nxt, cur
    return np.unpackbits(
        cur.reshape(h, -1).view(np.uint8), axis=1, bitorder="little"
    )[:, :w]
