"""Build and load the port's CUDA kernels (`csrc/stencil.cu`: K1-K8).

`nvcc` compiles the source into a shared library with a plain C interface
under `build/gol_tpu_torch/` at the repository root, named by a hash of
the source and flags, and `ctypes` loads it. The build runs at first use,
takes seconds, and is reused while the source is unchanged. A missing
`nvcc` or a failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "stencil.cu"
BUILD_DIR = _PKG.parent / "build" / "gol_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict = {}  # the one loaded library and its build record


def find_nvcc() -> str:
    """Path of `nvcc` on PATH or under CUDA_HOME / /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.access(cand, os.X_OK):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME (/usr/local/cuda): the "
        "gol_tpu_torch kernels build from source at first use")


def _declare(lib: ctypes.CDLL) -> None:
    vp, i, u, ll = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                    ctypes.c_longlong)
    ip = ctypes.POINTER(ctypes.c_int)
    lib.gol_error_string.argtypes = [i]
    lib.gol_error_string.restype = ctypes.c_char_p
    lib.gol_tile_geometry.argtypes = [ip, ip, ip, i]
    lib.gol_tile_geometry.restype = i
    lib.gol_resident_run_turns.argtypes = [vp, vp, i, i, ll, u, u, i, i, i,
                                           vp]
    lib.gol_resident_run_turns.restype = i
    lib.gol_tiled_sweep.argtypes = [vp, vp, i, i, i, i, u, u, i, vp]
    lib.gol_tiled_sweep.restype = i
    lib.gol_deep_geometry.argtypes = [ip, ip, ip]
    lib.gol_deep_geometry.restype = i
    lib.gol_tiled_sweep_deep.argtypes = [vp, vp, i, i, i, u, u, i, vp]
    lib.gol_tiled_sweep_deep.restype = i
    lib.gol_row_popcounts.argtypes = [vp, vp, i, i, i, vp]
    lib.gol_row_popcounts.restype = i
    lib.gol_tile2p_rows.argtypes = [ip, i]
    lib.gol_tile2p_rows.restype = i
    lib.gol_resident_run_turns2p.argtypes = [vp, vp, i, i, ll, u, u, i, i,
                                             i, i, vp]
    lib.gol_resident_run_turns2p.restype = i
    lib.gol_tiled_sweep2p.argtypes = [vp, vp, i, i, i, i, u, u, i, i, vp]
    lib.gol_tiled_sweep2p.restype = i
    lib.gol_window_occupancy.argtypes = [vp, vp, i, i, i, vp]
    lib.gol_window_occupancy.restype = i
    lib.gol_ltl_table_bytes.argtypes = [i]
    lib.gol_ltl_table_bytes.restype = i
    lib.gol_ltl_tile_smem_bytes.argtypes = [i, i]
    lib.gol_ltl_tile_smem_bytes.restype = i
    lib.gol_ltl_resident_smem_bytes.argtypes = [i, i, i, i]
    lib.gol_ltl_resident_smem_bytes.restype = i
    lib.gol_ltl_resident_run_turns.argtypes = [vp, vp, i, i, ll, i, i,
                                               vp, i, vp]
    lib.gol_ltl_resident_run_turns.restype = i
    lib.gol_ltl_box_run_turns.argtypes = [vp, vp, vp, i, i, ll, i, i, vp,
                                          i, vp]
    lib.gol_ltl_box_run_turns.restype = i


def _compile(nvcc: str, target: Path) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.monotonic()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.monotonic() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return {"seconds": seconds, "log": proc.stdout + proc.stderr,
            "cached": False}


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    with _lock:
        if "lib" not in _loaded:
            digest = hashlib.sha256(
                SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
            ).hexdigest()[:16]
            target = BUILD_DIR / f"libgol_stencil_{digest}.so"
            if target.exists():
                record = {"seconds": 0.0, "log": "", "cached": True}
            else:
                record = _compile(find_nvcc(), target)
            lib = ctypes.CDLL(str(target))
            _declare(lib)
            record["path"] = str(target)
            _loaded["record"] = record
            _loaded["lib"] = lib
        return _loaded["lib"]


def build_record() -> dict:
    """{"seconds", "log", "cached", "path"} of the library's build (after
    `library()` has run)."""
    library()
    return dict(_loaded["record"])


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if rc != 0:
        msg = library().gol_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
