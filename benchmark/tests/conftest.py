"""Shared set-up of the benchmark's own tests: imports from the
benchmark's folder and the checkout, the `card` marker, and a small
copy of the benchmark that runs on the CPU."""

from __future__ import annotations

import copy
import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (BENCH_DIR, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    """Skips the test where no CUDA card is visible."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture(scope="session")
def small_image(tmp_path_factory):
    """A 64 x 64 board made as life-512's is: the coursework's 64 x 64
    board settled (period 2 from turn 771), as a PGM."""
    import numpy as np

    from yardstick import board as bd
    from yardstick import registry

    ref = registry.reference("life")
    start = bd.read_pgm(os.path.join(ROOT, "images", "64x64.pgm")) != 0
    ash = ref.History(start, "B3/S23").state_at(772)
    path = str(tmp_path_factory.mktemp("small") / "64x64x772.pgm")
    bd.write_pgm(path, (ash * 255).astype(np.uint8))
    return path


@pytest.fixture
def small_bench(tmp_path, small_image):
    """(root, bench_dir) of a copy of the benchmark whose one cell,
    `small.ticker`, runs a 64 x 64 board with life-512's pulsar on the
    CPU, with the real cells' metrics."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = json.loads((bench_dir / "configs" / "life-512.json").read_text())
    cfg.update(name="small", width=64, height=64, image=small_image)
    cfg["plant"] = dict(cfg["plant"], at=[2, 7])
    (bench_dir / "configs" / "small.json").write_text(json.dumps(cfg))
    small = copy.deepcopy(bench)
    small["configs"] = [{"name": "small", "source": "test",
                         "file": "benchmark/configs/small.json",
                         "reduced": [], "why": "test"}]
    small["workloads"] = [
        {"name": "small.ticker", "config": "small", "traffic": "ticker",
         "chips": 1, "why": "test"}]
    for m in small["end_to_end"] + small["per_layer"]:
        if "workloads" in m:
            m["workloads"] = ["small.ticker"]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(small))
    return str(tmp_path), str(bench_dir)
