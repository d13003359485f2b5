"""The `methuselah` flow and the sparse cell's readers, on the CPU: a
small copy of `sparse-2p20` (a 4,096 torus, 1,024-turn jobs) run
through `run_cell` reads `correct` true, and false under a step frozen
after the warm-up and under a window that never grows (the gliders wrap
around it); `window_roofline_pct`, `job_idle_pct` and `episodes_per_job`
on a synthetic trace read what they should (the roofline at most 100),
and nothing for a program without the sparse spans or on a CPU trace."""

from __future__ import annotations

import copy
import json
import os
import shutil
import time

import pytest

from yardstick import peaks, registry
from yardstick.cell import Ctx, run_cell
from yardstick.trace import SPAN_PREFIX, Trace

from gol_tpu_torch.obs import trace as obs_trace

BENCH_DIR = registry.BENCH_DIR
ROOT = registry.ROOT
CELL = "small.methuselah"
SEED = 2**33 + 41


@pytest.fixture
def sparse_bench(tmp_path):
    """(root, bench_dir) of a copy of the benchmark whose one cell runs
    sparse-2p20 on a 4,096 torus in 1,024-turn jobs, one job in the
    window, with the real cell's metrics."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    # the reference's stepping, which the benchmark loads from the checkout
    (tmp_path / "tools").mkdir()
    shutil.copy(os.path.join(ROOT, "tools", "sparse_reference.py"),
                tmp_path / "tools")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cfg = json.loads(
        (bench_dir / "configs" / "sparse-2p20.json").read_text())
    cfg.update(name="small", width=4096, height=4096, turns=1024)
    (bench_dir / "configs" / "small.json").write_text(json.dumps(cfg))
    tf = json.loads(
        (bench_dir / "traffic" / "methuselah.json").read_text())
    tf.update(min_jobs=1)
    (bench_dir / "traffic" / "small.json").write_text(json.dumps(tf))
    small = copy.deepcopy(bench)
    small["configs"] = [{"name": "small", "source": "test",
                         "file": "benchmark/configs/small.json",
                         "reduced": [], "why": "test"}]
    small["workloads"] = [{"name": CELL, "config": "small",
                           "traffic": "small", "chips": 1, "why": "test"}]
    for m in small["end_to_end"] + small["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [CELL]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(small))
    return str(tmp_path), str(bench_dir)


def _run(sparse_bench, on_warm=None, trace=False):
    root, bench_dir = sparse_bench
    return run_cell(CELL, SEED, 0.5, trace, t_start=time.monotonic(),
                    device="cpu", root=root, bench_dir=bench_dir,
                    on_warm=on_warm)


def test_sound_run_is_correct(sparse_bench):
    result, checks = _run(sparse_bench)
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"cell_updates_per_s", "setup_s"}
    assert result["metrics"]["cell_updates_per_s"]["value"] > 0
    assert set(checks.items) == {"pairs_wrong", "final_wrong",
                                 "final_cells_wrong", "pgms_misnamed",
                                 "pgm_cells_wrong", "run_errors"}
    assert all(v == {"value": 0, "limit": 0}
               for v in checks.items.values())
    # one warm-up job and one in the window, each judged
    assert checks.answers >= 4


def test_traced_run_is_correct(sparse_bench):
    result, _ = _run(sparse_bench, trace=True)
    assert result["correct"] is True
    assert result["metrics"] == {}  # no card: nothing on a device trace
    assert result["device"]["window_s"] > 0


def test_a_step_frozen_after_the_warm_up_is_not_correct(sparse_bench,
                                                        monkeypatch):
    from gol_tpu_torch.parallel import halo

    real = halo.packed_run_by_kind
    tripped = []

    def by_kind(kind):
        step = real(kind)

        def frozen(words, k, rule, **kw):
            out = step(words, k, rule, **kw)
            return words.clone() if tripped else out

        return frozen

    monkeypatch.setattr(halo, "packed_run_by_kind", by_kind)
    result, checks = _run(sparse_bench, on_warm=lambda: tripped.append(1))
    assert tripped and result["correct"] is False
    assert checks.items["pairs_wrong"]["value"] > 0
    assert checks.items["final_cells_wrong"]["value"] > 0


def test_a_window_that_never_grows_is_not_correct(sparse_bench,
                                                  monkeypatch):
    from gol_tpu_torch.models import sparse

    # Every margin taken as safe: the window keeps its first shape and
    # the gliders wrap around it.
    monkeypatch.setattr(sparse.SparseTorus, "_safe_budget",
                        lambda self, remaining: remaining)
    result, checks = _run(sparse_bench)
    assert result["correct"] is False
    assert checks.items["final_cells_wrong"]["value"] > 0


# ----------------------------------------------------------- the readers

SHIFT = 5000.25  # trace clock = monotonic + SHIFT
T0 = 200.0
SPEC = {"boost_hz": 1.98e9, "hbm_bytes_per_s": 3.35e12}
SMS = 132
# Two jobs in the window: in-job [T0 + 1, T0 + 3] and [T0 + 5, T0 + 7];
# the gap between holds the PGM.
IN_JOB = [(T0 + 1.0, T0 + 3.0), (T0 + 5.0, T0 + 7.0)]
# (start, k, h, wp) of each macro; the first before the window's jobs
MACROS = [(T0 + 0.5, 256, 256, 64), (T0 + 1.1, 512, 256, 64),
          (T0 + 2.0, 2048, 1024, 128), (T0 + 5.5, 2048, 4096, 512)]
MARGINS = [T0 + 0.95, T0 + 1.5, T0 + 2.5, T0 + 4.0, T0 + 5.2, T0 + 6.0]


@pytest.fixture(autouse=True)
def _fresh_tracer():
    obs_trace.TRACER.reset()
    yield
    obs_trace.TRACER.reset()


def _plant_spans():
    rec = obs_trace.TRACER.record
    for t, k, h, wp in MACROS:
        rec("sparse.macro", t, t + 1e-4, None,
            {"k": k, "h": h, "wp": wp, "kernel": "K2", "turn": 0})
    for t in MARGINS:
        rec("sparse.margins", t, t + 1e-3, None, {"turn": 0})


def _trace_file(tmp_path, device=True):
    """The window's span from the first job's first sighting to the
    last's final one, and (with `device`) kernels busy over half of each
    in-job second, and busy through the gap between the jobs."""
    us = lambda t: (t + SHIFT) * 1e6  # noqa: E731
    events = [{"ph": "X", "cat": "user_annotation",
               "name": SPAN_PREFIX + "window", "ts": us(IN_JOB[0][0]),
               "dur": (IN_JOB[-1][1] - IN_JOB[0][0]) * 1e6}]
    if device:
        t = T0
        while t < T0 + 8.0:
            events.append({"ph": "X", "cat": "kernel", "name": "k",
                           "ts": us(t), "dur": 0.25e6})
            t += 0.5
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": us(T0 + 3.25), "dur": 1.5e6})
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return path


def _ctx(path, spec=SPEC):
    ctx = Ctx(out={"in_job": IN_JOB,
                   "t_open": IN_JOB[0][0],
                   "window": ((0.0, 0), (4.0, 100000))},
              height=1 << 20, width=1 << 20, cells=1 << 40, setup_s=1.0)
    ctx.trace = Trace(path)
    ctx.window = ctx.trace.window("window")
    ctx.spec, ctx.sms = spec, SMS
    return ctx


def _read(name, ctx):
    return registry.metric_reader(name)(ctx)


def test_readers_on_a_synthetic_trace(tmp_path):
    _plant_spans()
    ctx = _ctx(_trace_file(tmp_path))
    # Half of each in-job second is busy; the gap's kernel is left out.
    assert _read("job_idle_pct", ctx) == pytest.approx(50.0, abs=1e-6)
    # Margins spans in the in-job intervals: 2 a job (those before the
    # first sighting and in the gap are left out).
    assert _read("episodes_per_job", ctx) == pytest.approx(2.0)
    ceiling = peaks.cell_updates_ceiling(SPEC, SMS)
    least = sum(max(h * wp * 32 * k / ceiling,
                    12 * h * wp / SPEC["hbm_bytes_per_s"])
                for t, k, h, wp in MACROS[1:])
    roof = _read("window_roofline_pct", ctx)
    assert roof == pytest.approx(100.0 * least / 2.0)
    assert 0 < roof <= 100


def test_roofline_at_most_100_when_the_device_is_as_fast_as_can_be(
        tmp_path):
    """Device time equal to the floors themselves reads 100."""
    ceiling = peaks.cell_updates_ceiling(SPEC, SMS)
    us = lambda t: (t + SHIFT) * 1e6  # noqa: E731
    events = [{"ph": "X", "cat": "user_annotation",
               "name": SPAN_PREFIX + "window", "ts": us(IN_JOB[0][0]),
               "dur": (IN_JOB[-1][1] - IN_JOB[0][0]) * 1e6}]
    for t, k, h, wp in MACROS[1:]:
        least = max(h * wp * 32 * k / ceiling,
                    12 * h * wp / SPEC["hbm_bytes_per_s"])
        events.append({"ph": "X", "cat": "kernel", "name": "k",
                       "ts": us(t + 0.01), "dur": least * 1e6})
    path = str(tmp_path / "floor.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    _plant_spans()
    assert _read("window_roofline_pct", _ctx(path)) == \
        pytest.approx(100.0, rel=1e-6)


def test_readers_read_nothing_without_the_spans(tmp_path):
    """A program without the sparse spans: the span readers find nothing
    and raise nothing; the device's idle share still reads."""
    ctx = _ctx(_trace_file(tmp_path))
    assert _read("window_roofline_pct", ctx) is None
    assert _read("episodes_per_job", ctx) is None
    assert _read("job_idle_pct", ctx) == pytest.approx(50.0, abs=1e-6)


def test_readers_read_nothing_on_a_cpu_trace_or_another_cell(tmp_path):
    _plant_spans()
    ctx = _ctx(_trace_file(tmp_path, device=False))
    for name in ("window_roofline_pct", "job_idle_pct", "episodes_per_job"):
        assert _read(name, ctx) is None, name
    other = _ctx(_trace_file(tmp_path))
    other.out = {"window": ((0.0, 1, 1), (1.0, 2, 1)), "t_open": 0.0}
    for name in ("window_roofline_pct", "job_idle_pct", "episodes_per_job"):
        assert _read(name, other) is None, name
