"""The harness finds a configuration, a traffic mix and a metric by
name from files alone, and `BENCHMARK.json` keeps to its format."""

from __future__ import annotations

import json
import os
import re

import pytest

from yardstick import registry

ROOT = registry.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def bench():
    return registry.load_benchmark(ROOT)


def test_new_parts_are_found_from_new_files(tmp_path):
    """A later change adds a configuration, a mix and a metric as files
    and entries, and edits none that is there."""
    bench_dir = tmp_path / "benchmark"
    for d in ("configs", "traffic", "flows", "layer_metrics", "end_to_end",
              "reference"):
        (bench_dir / d).mkdir(parents=True)
    (bench_dir / "configs" / "new.json").write_text(json.dumps(
        {"rule": "B36/S23", "reference": "plain", "tile": [1, 1]}))
    (bench_dir / "traffic" / "burst.json").write_text(
        json.dumps({"flow": "bursts", "turns": 7}))
    (bench_dir / "flows" / "bursts.py").write_text(
        "def drive(env):\n    return {'t_open': 1.0}\n")
    (bench_dir / "layer_metrics" / "new_share.x.py").write_text(
        "def read(ctx):\n    return ctx.value * 2\n")
    (bench_dir / "end_to_end" / "new_rate.py").write_text(
        "def read(ctx):\n    return 1.5\n")
    (bench_dir / "reference" / "plain.py").write_text("ANSWER = 42\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "new", "file": "benchmark/configs/new.json"}],
        "workloads": [{"name": "new.burst", "config": "new",
                       "traffic": "burst", "chips": 1}],
        "end_to_end": [{"name": "new_rate"}, {"name": "setup_s"}],
        "per_layer": [{"name": "new_share.x", "moves": "new_rate"}]}))

    b = registry.load_benchmark(str(tmp_path))
    cell = registry.workload(b, "new.burst")
    cfg = registry.config(b, cell["config"], str(tmp_path))
    assert cfg["rule"] == "B36/S23"
    assert registry.traffic("burst", str(bench_dir))["turns"] == 7
    assert registry.flow("bursts", str(bench_dir)).drive(None) == \
        {"t_open": 1.0}
    assert registry.reference("plain", str(bench_dir)).ANSWER == 42

    class Ctx:
        value = 4

    assert [m["name"] for m in registry.per_layer(b, "new.burst")] == \
        ["new_share.x"]
    assert registry.metric_reader("new_share.x", str(bench_dir))(Ctx) == 8
    assert registry.end_to_end_reader("new_rate", str(bench_dir))(Ctx) == 1.5
    with pytest.raises(KeyError):
        registry.traffic("absent", str(bench_dir))
    with pytest.raises(KeyError):
        registry.workload(b, "absent")


def test_metrics_per_cell(bench):
    def names(f, cell):
        return sorted(m["name"] for m in f(bench, cell))

    for cell in ("life-512.ticker", "life-5120.ticker"):
        assert names(registry.end_to_end, cell) == [
            "cell_updates_per_s", "setup_s"]
        assert names(registry.per_layer, cell) == [
            "chunk_overhead_us", "device_idle_pct", "step_roofline_pct"]


def test_every_part_has_its_file(bench):
    for w in bench["workloads"]:
        cfg = registry.config(bench, w["config"])
        registry.reference(cfg["reference"])
        flow = registry.flow(registry.traffic(w["traffic"])["flow"])
        assert callable(flow.drive) and callable(flow.judge)
        for m in registry.end_to_end(bench, w["name"]):
            assert callable(registry.end_to_end_reader(m["name"]))
        for m in registry.per_layer(bench, w["name"]):
            assert callable(registry.metric_reader(m["name"]))


def test_benchmark_json_keeps_its_format(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in bench["workloads"]}
    configs = {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("benchmark/")
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200 and NAME.match(w["name"])
    assert {w["config"] for w in bench["workloads"]} == configs
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m["workloads"]:
            assert cell in cells
            assert m["moves"] in {x["name"] for x in
                                  registry.end_to_end(bench, cell)}
    for m in metrics:
        assert NAME.match(m["name"]) and m["better"] in ("lower", "higher")
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
    for cell in cells:
        assert "setup_s" in {m["name"]
                             for m in registry.end_to_end(bench, cell)}
        assert len(registry.end_to_end(bench, cell)) >= 2
        assert registry.per_layer(bench, cell)


NEW_FLOW = """
from yardstick import judge as jd


def drive(env):
    import time

    images, board = env.make_input("0")
    return {"t_open": time.monotonic(), "board": board,
            "turns": env.traffic["turns"]}


def judge(out, reference, cfg, device):
    c = jd.Checks()
    hist = reference.oracle(out["board"], cfg, device)
    c.answers = c.attempted = 1
    c.add("count_wrong", abs(hist.count_at(out["turns"]) - 3))
    return c
"""


def test_a_cell_of_new_files_runs_end_to_end(tmp_path):
    """A cell whose configuration, reference, mix, flow and metrics are
    all new files runs through `run_cell` with no file edited."""
    import time

    from yardstick.cell import run_cell

    bench_dir = tmp_path / "benchmark"
    for d in ("configs", "traffic", "flows", "layer_metrics", "end_to_end",
              "reference"):
        (bench_dir / d).mkdir(parents=True)
    (bench_dir / "configs" / "blink.json").write_text(json.dumps(
        {"rule": "B3/S23", "reference": "blinker", "cycle_limit": 10,
         "height": 8, "width": 8}))
    (bench_dir / "reference" / "blinker.py").write_text(
        "import numpy as np\n"
        "from yardstick import registry\n"
        "life = registry.reference('life')\n"
        "def make_board(cfg, rng, root):\n"
        "    b = np.zeros((8, 8), np.uint8)\n"
        "    b[4, 3:6] = 1\n"
        "    return b\n"
        "oracle = life.oracle\n")
    (bench_dir / "traffic" / "once.json").write_text(json.dumps(
        {"flow": "count", "turns": 101, "trace_seconds": 1}))
    (bench_dir / "flows" / "count.py").write_text(NEW_FLOW)
    (bench_dir / "end_to_end" / "turns_done.py").write_text(
        "def read(ctx):\n    return float(ctx.out['turns'])\n")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "configs": [{"name": "blink",
                     "file": "benchmark/configs/blink.json"}],
        "workloads": [{"name": "blink.once", "config": "blink",
                       "traffic": "once", "chips": 1}],
        "end_to_end": [{"name": "turns_done", "unit": "turns"}],
        "per_layer": []}))
    result, checks = run_cell("blink.once", 3, 1.0, False,
                              t_start=time.monotonic(), device="cpu",
                              root=str(tmp_path), bench_dir=str(bench_dir))
    assert result["correct"] is True
    assert result["metrics"] == {"turns_done": {"value": 101.0,
                                                "unit": "turns"}}
    assert checks.items == {"count_wrong": {"value": 0, "limit": 0}}
