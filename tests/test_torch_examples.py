"""The port's examples (`examples/torch_*.py`) run with `--device cpu` in
a subprocess whose `jax`, `jaxlib` and `gol_tpu` imports fail, print the
lines their JAX counterparts promise (`tests/test_examples.py`), and give
the same counts and boards as the JAX examples run on the same arguments:
the final alive count and output PGM of `basic_run`, the firing count of
`brians_brain`, the alive count and live window of `sparse_gun`. The
detach/resume turns follow the wall clock, so `detach_resume`'s final
count is held against the numpy oracle at its final turn. Tolerance:
none."""

import os
import re
import subprocess
import sys

import numpy as np

from gol_tpu.ops.reference import run_turns_np
from gol_tpu.utils import read_alive_cells
from test_examples import run_example as run_jax_example

BLOCK = (
    "import runpy, sys\n"
    "for name in ('jax', 'jaxlib', 'gol_tpu'):\n"
    "    sys.modules[name] = None\n"
)


def run_torch_example(repo_root, out_dir, name, args=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(repo_root) + os.pathsep + env.get(
        "PYTHONPATH", "")
    env["GOL_IMAGES"] = str(repo_root / "images")
    env["GOL_OUT"] = str(out_dir)
    for k in ("SER", "CONT", "GOL_RULE"):
        env.pop(k, None)
    script = repo_root / "examples" / name
    argv = [str(script), *args, "--device", "cpu"]
    code = (BLOCK + f"sys.argv = {argv!r}\n"
            + f"runpy.run_path({str(script)!r}, run_name='__main__')\n"
            + "print('loaded', sorted(m for m in sys.modules if "
              "m.split('.')[0] in ('jax', 'jaxlib', 'gol_tpu') and "
              "sys.modules[m] is not None))\n")
    out = subprocess.run(
        [sys.executable, "-u", "-c", code], capture_output=True,
        text=True, timeout=300, env=env, cwd=str(repo_root))
    assert out.returncode == 0, out.stdout + out.stderr
    lines = out.stdout.splitlines()
    assert lines[-1] == "loaded []"
    return "\n".join(lines[:-1])


def _final(out):
    return re.search(r"turn +(\d+): final \((\d+) alive\)", out).groups()


def test_torch_basic_run(repo_root, tmp_path):
    out = run_torch_example(repo_root, tmp_path / "t", "torch_basic_run.py")
    assert "final" in out
    jout = run_jax_example(repo_root, tmp_path / "j", "basic_run.py")
    assert _final(out) == _final(jout) == ("100", "419")
    name = "64x64x100.pgm"
    assert (tmp_path / "t" / name).read_bytes() == \
        (tmp_path / "j" / name).read_bytes()
    assert f"File {name} output complete" in out


def test_torch_basic_run_with_a_rule(repo_root, tmp_path):
    out = run_torch_example(repo_root, tmp_path / "t", "torch_basic_run.py",
                            ["B36/S23"])
    jout = run_jax_example(repo_root, tmp_path / "j", "basic_run.py",
                           ["B36/S23"])
    assert _final(out) == _final(jout)


def test_torch_sparse_gun(repo_root, tmp_path):
    out = run_torch_example(repo_root, tmp_path, "torch_sparse_gun.py",
                            ["300"])
    assert "gliders in flight" in out
    assert "live window" in out
    jout = run_jax_example(repo_root, tmp_path, "sparse_gun.py", ["300"])
    assert out.split("; ", 1)[1] == jout.strip().split("; ", 1)[1]


def test_torch_detach_resume(repo_root, tmp_path):
    out = run_torch_example(repo_root, tmp_path, "torch_detach_resume.py")
    assert "detached at turn" in out
    assert "resumed and finished" in out
    t1 = int(re.search(r"detached at turn (\d+)", out).group(1))
    t2, alive = map(int, re.search(
        r"finished at turn (\d+) \((\d+) alive\)", out).groups())
    assert t1 > 0 and t2 == t1 + 1000
    seed = np.zeros((64, 64), np.uint8)
    for x, y in read_alive_cells(str(repo_root / "images" / "64x64.pgm"),
                                 64, 64):
        seed[y, x] = 1
    assert int(run_turns_np(seed, t2).sum()) == alive


def test_torch_brians_brain(repo_root, tmp_path):
    out = run_torch_example(repo_root, tmp_path, "torch_brians_brain.py",
                            ["200"])
    assert "cells firing" in out and "packed bit-plane" in out
    jout = run_jax_example(repo_root, tmp_path, "brians_brain.py", ["200"])
    firing = re.compile(r"(\d+) cells firing")
    assert firing.search(out).group(1) == firing.search(jout).group(1)
