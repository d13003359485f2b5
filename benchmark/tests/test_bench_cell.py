"""Whole runs of small cells on the CPU: the result line, the numbers
compared, and `correct` coming out false for the control and for each
fault planted under the timed path."""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import pytest

from yardstick import faults, guard, registry
from yardstick.cell import run_cell

BENCH_DIR = registry.BENCH_DIR
ROOT = registry.ROOT
ref = registry.reference("life")


def _run(small_bench, cell="small.ticker", seconds=1.0, trace=False,
         fault=None):
    root, bench_dir = small_bench
    plant = (faults.planted(fault, ref, "B3/S23") if fault
             else contextlib.nullcontext())
    with plant as handle:
        return run_cell(cell, 2**33 + 17, seconds, trace,
                        t_start=time.monotonic(), device="cpu", root=root,
                        bench_dir=bench_dir,
                        on_warm=handle and handle.trip)


def test_sound_run_is_correct_with_its_result_line(small_bench):
    result, checks = _run(small_bench)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "checks"]
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"cell_updates_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(result["device"]) >= {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert all(v == {"value": 0, "limit": 0}
               for v in result["checks"].values())
    json.dumps(result)


def test_traced_run_reports_per_layer_metrics(small_bench):
    result, _ = _run(small_bench, trace=True)
    assert result["correct"] is True
    # no card: the device-trace metrics have nothing to read
    assert result["metrics"] == {}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_control_and_faults_are_not_correct(small_bench, fault):
    result, checks = _run(small_bench, fault=fault)
    assert result["correct"] is False
    assert any(v["value"] > v["limit"] for v in checks.items.values())


@pytest.mark.parametrize("ticks,wrong", [
    ([(0, 0), (2, 3)], 0),  # a tick before the board loaded, then one
    ([(0, 5), (2, 3)], 1),
    ([(2, 0)], 1)])
def test_a_tick_before_the_board_loaded_is_no_answer(ticks, wrong):
    import numpy as np

    board = np.zeros((8, 8), np.uint8)
    board[4, 3:6] = 1  # a blinker: 3 cells at every turn
    out = {"board": board, "firsts": [(0.0, 1, 3)], "ticks": ticks,
           "error": None, "final": None, "pgm": None}
    checks = registry.flow("ticker").judge(
        out, ref, {"rule": "B3/S23", "cycle_limit": 10}, "cpu")
    assert checks.items["pairs_wrong"]["value"] == wrong


def test_fault_names_are_checked():
    with pytest.raises(ValueError):
        with faults.planted("nothing", ref, "B3/S23"):
            pass


def test_run_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload",
         "life-512.ticker", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=env,
        timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    import shutil

    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    p = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "life-512.ticker",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gol_tpu_torch_x", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert guard.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gol_tpu.engine", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert guard.forbidden_modules() == ["gol_tpu", "jaxlib"]


def test_a_cell_process_loads_neither_jax_nor_the_jax_package(small_bench):
    root, bench_dir = small_bench
    code = (
        "import sys, time; sys.path[:0] = [%r, %r]\n"
        "from yardstick.cell import run_cell\n"
        "from yardstick import guard\n"
        "r, _ = run_cell('small.ticker', 5, 1.0, False,"
        " t_start=time.monotonic(), device='cpu', root=%r, bench_dir=%r)\n"
        "assert r['correct'], r\n"
        "print(guard.forbidden_modules())\n"
        % (BENCH_DIR, ROOT, root, bench_dir))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
