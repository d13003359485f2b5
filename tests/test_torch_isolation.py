"""The torch port stands alone: neither `gol_tpu_torch` nor
`chip_smoke.py` imports jax or the JAX package, and nothing in the port
quietly runs on the CPU when CUDA was asked for."""

import ast
import os
import pathlib
import queue
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "gol_tpu")


def _port_sources():
    return sorted((REPO / "gol_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_gol_tpu_import(path):
    for name in _imported_modules(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def _subprocess_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import sys, pkgutil, importlib, gol_tpu_torch\n"
        "for m in pkgutil.walk_packages(gol_tpu_torch.__path__,\n"
        "                               'gol_tpu_torch.'):\n"
        "    if not m.name.endswith('__main__'):\n"
        "        importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'gol_tpu')]\n"
        "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=_subprocess_env(),
                         cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_fused_module_stands_alone():
    """The temporal-fusion module is among the checked sources, and
    importing it first (it reads GOL_FUSE_K through the port's own env
    helper, not the JAX package's) pulls in no jax."""
    assert REPO / "gol_tpu_torch" / "ops" / "fused.py" in _port_sources()
    code = (
        "import sys\n"
        "from gol_tpu_torch.ops import fused\n"
        "from gol_tpu_torch.parallel.halo import fused_run_fn\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'gol_tpu')]\n"
        "print(bad, fused.configured_fuse_k(),\n"
        "      fused_run_fn(8).keywords['fuse'])\n")
    env = _subprocess_env()
    env["GOL_FUSE_K"] = "8"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[] 8 8"


def test_engine_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from gol_tpu_torch.engine import Engine

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(device="cuda")
    assert Engine(device="cpu").device.type == "cpu"


def test_run_without_cuda_closes_events_and_reports(images_dir, out_dir,
                                                    monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import gol_tpu_torch
    from gol_tpu_torch import distributor, events as ev

    monkeypatch.setattr(distributor, "_default_engine", None)
    events_q = queue.Queue()
    t = gol_tpu_torch.run(gol_tpu_torch.Params(image_width=16,
                                               image_height=16, turns=1),
                          events_q, images_dir=images_dir, out_dir=out_dir)
    assert ev.drain(events_q) == []
    t.join(30)
    assert isinstance(t.exception, RuntimeError)


def test_cli_help_and_device_flag():
    env = _subprocess_env()
    out = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "--help"],
        capture_output=True, text=True, timeout=120, env=env, cwd=str(REPO))
    assert out.returncode == 0 and "--device" in out.stdout


def test_cli_on_cpu(images_dir, tmp_path):
    env = _subprocess_env()
    env["GOL_IMAGES"] = images_dir
    env["GOL_OUT"] = str(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch", "-w", "64", "-h", "64",
         "--turns", "100", "--headless", "--device", "cpu"],
        capture_output=True, text=True, timeout=120, env=env,
        cwd=str(tmp_path), stdin=subprocess.DEVNULL)
    assert out.returncode == 0, out.stderr
    assert "File 64x64x100.pgm output complete" in out.stdout
    assert (REPO / "check" / "images" / "64x64x100.pgm").read_bytes() == \
        (tmp_path / "64x64x100.pgm").read_bytes()


def test_server_without_cuda_exits_nonzero(tmp_path):
    """`python -m gol_tpu_torch.server` defaults to CUDA: without a card
    and without `--device cpu` it exits non-zero with the engine's own
    error and never prints its serving banner."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "gol_tpu_torch.server", "--port", "0",
         "--host", "127.0.0.1"], capture_output=True, text=True,
        timeout=120, env=_subprocess_env(), cwd=str(tmp_path))
    assert out.returncode != 0
    assert "serving on" not in out.stdout
    assert "device='cpu'" in out.stderr


def test_chip_smoke_refuses_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(REPO / "chip_smoke.py")], capture_output=True,
        text=True, timeout=120, env=_subprocess_env(), cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo,
    the script exits non-zero and prints no result."""
    (tmp_path / "chip_smoke.py").write_bytes(
        (REPO / "chip_smoke.py").read_bytes())
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True,
        timeout=120, env=env, cwd=str(tmp_path))
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
