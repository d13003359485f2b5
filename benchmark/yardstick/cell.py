"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line. Everything that belongs to a
configuration, a traffic mix or a metric is found by name
(`registry.py`): nothing here knows a flow, a rule or a metric."""

from __future__ import annotations

import gc
import shutil
import subprocess
import sys
import tempfile
import traceback

import numpy as np

from yardstick import drive, judge, peaks, registry, stats
from yardstick.trace import Trace, Tracer


class Ctx:
    """What a metric's reader gets: the flow's output `out`, the board's
    `height`, `width` and `cells`, `setup_s`;
    in a traced run the `trace` with its `window` (trace clock), and the
    card's published `spec` (None for a card not in the table) and
    `sms`."""

    def __init__(self, **kw) -> None:
        self.trace = self.window = self.spec = None
        self.sms = 0
        self.__dict__.update(kw)

    def device_union(self, lo: float, hi: float) -> list:
        return stats.union((s, e) for s, e, _ in self.trace.device_in(lo, hi))


def _card_sample() -> dict:
    """The card's SM clock, power draw and power limit, from nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.splitlines()[0]
        clk, draw, limit = (float(x) for x in out.split(","))
        return {"sm_clock_mhz": clk, "power_draw_w": draw,
                "power_limit_w": limit}
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return {}


def _device(cuda: bool) -> dict:
    """The result's `device`: the cards the run used (the engine takes
    every visible one) and the peak memory of the fullest."""
    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    import torch

    n = torch.cuda.device_count()
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n, "memory_peak_bytes": max(
                torch.cuda.max_memory_allocated(i) for i in range(n))}


def breakdown(ctx: Ctx) -> dict:
    """The window's 10 device operations that took most time, and its 10
    longest device-idle gaps by the innermost host event open at their
    start."""
    lo, hi = ctx.window
    by_name: dict = {}
    for s, e, n in ctx.trace.device_in(lo, hi):
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(stats.gaps(ctx.device_union(lo, hi), lo, hi),
                  key=lambda g: g[0] - g[1])[:10]
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[ctx.trace.host_at(s) or "untraced", e - s]
                          for s, e in gaps]}


def _failed(checks_name: str, cuda: bool, error: str) -> tuple:
    checks = judge.Checks()
    checks.add(checks_name, 1)
    checks.attempted = checks.failed = 1
    return {"correct": False, "attempted": 1, "failed": 1, "metrics": {},
            "device": _device(cuda), "checks": checks.items,
            "error": error}, checks


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t_start: float, device=None, root: str = registry.ROOT,
             bench_dir: str = registry.BENCH_DIR, on_warm=None) -> tuple:
    """(result, checks) of one run. `device=None` runs on the card, as
    users do; tests pass "cpu". `t_start` is the process's start on the
    monotonic clock. `on_warm` is called when the set-up is over (the
    planted faults' trigger)."""
    import torch

    bench = registry.load_benchmark(root)
    wl = registry.workload(bench, name)
    cfg = registry.config(bench, wl["config"], root)
    tf = registry.traffic(wl["traffic"], bench_dir)
    flow = registry.flow(tf["flow"], bench_dir)
    ref = registry.reference(cfg["reference"], bench_dir)
    cuda = device is None
    workdir = tempfile.mkdtemp(prefix="bench-")
    try:
        tracer = Tracer(trace, workdir + "/trace.json", cuda)
        env = drive.Env(cfg, tf, device, np.random.default_rng(seed),
                        seconds, tracer, workdir, root, ref, on_warm)
        try:
            out = flow.drive(env)
        except RuntimeError as e:
            # The program failed the traffic (it ended early, answered
            # nothing, or never settled): a run that is not correct.
            traceback.print_exc()
            return _failed("run_errors", cuda, str(e))
        setup_s = out["t_open"] - t_start
        for stamp, t in out.get("stamps", ()):
            print(f"setup {stamp} {t - t_start:.3f} s", file=sys.stderr)
        dev = _device(cuda)
        ctx = Ctx(out=out, height=env.height, width=env.width,
                  cells=env.height * env.width, setup_s=setup_s)
        if trace and tracer.exported:
            ctx.trace = Trace(tracer.path)
            ctx.window = ctx.trace.window("window")
            lo, hi = ctx.window
            dev["busy_s"] = stats.covered(ctx.device_union(lo, hi), lo, hi)
            dev["window_s"] = hi - lo
        if cuda:
            ctx.spec = peaks.card(dev["kind"])
            ctx.sms = torch.cuda.get_device_properties(0).multi_processor_count
            dev.update(_card_sample())
        # The reference runs once the peak is read and the program's
        # state is freed.
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        try:
            checks = flow.judge(out, ref, cfg, "cuda" if cuda else device)
        except RuntimeError:
            traceback.print_exc()
            checks = judge.Checks()
            checks.add("reference_failed", 1)
        entries = (registry.per_layer(bench, name) if trace
                   else registry.end_to_end(bench, name))
        metrics = {}
        for m in entries:
            read = (registry.metric_reader(m["name"], bench_dir) if trace
                    else registry.end_to_end_reader(m["name"], bench_dir))
            v = read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {"correct": checks.correct, "attempted": checks.attempted,
                  "failed": checks.failed, "metrics": metrics,
                  "device": dev}
        if ctx.trace is not None:
            result["breakdown"] = breakdown(ctx)
        result["checks"] = checks.items
        return result, checks
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
