"""An installed port can build its kernels: a wheel built from the tree
(offline, with the setuptools already installed) ships the sources that
`gol_tpu_torch/ops/_build.py` and `gol_tpu_torch/native.py` read at first
use, and the operator tools' subpackage."""

import os
import pathlib
import shutil
import subprocess
import sys
import zipfile

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_wheel_ships_the_kernel_sources(tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy(REPO / name, src / name)
    for pkg in ("gol_tpu", "gol_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg,
                        ignore=shutil.ignore_patterns("__pycache__"))
    env = dict(os.environ, PIP_NO_INDEX="1",
               PIP_DISABLE_PIP_VERSION_CHECK="1")
    out = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", ".", "--no-deps",
         "--no-build-isolation", "-w", str(tmp_path / "dist"), "-q"],
        cwd=str(src), capture_output=True, text=True, timeout=150, env=env)
    assert out.returncode == 0, out.stderr[-4000:]
    (wheel,) = (tmp_path / "dist").glob("*.whl")
    names = set(zipfile.ZipFile(wheel).namelist())
    for want in ("gol_tpu_torch/csrc/stencil.cu",
                 "gol_tpu_torch/csrc/golnative.cpp",
                 "gol_tpu_torch/tools/replay_audit.py",
                 "gol_tpu_torch/tools/ckpt_inspect.py",
                 "gol_tpu_torch/tools/fleet_top.py"):
        assert want in names, want
    for rel in ("gol_tpu_torch/csrc/stencil.cu",
                "gol_tpu_torch/csrc/golnative.cpp"):
        assert zipfile.ZipFile(wheel).read(rel) == (REPO / rel).read_bytes()
