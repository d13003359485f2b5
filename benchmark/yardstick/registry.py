"""Finds a cell's parts by name, so that a configuration, a traffic mix
or a per-layer metric is added as files and an entry in
`BENCHMARK.json`, never by editing a file that is there.

- a configuration: the JSON file its entry names (`file`), which names
  its plain reference in `reference/<name>.py` (`make_board`,
  `oracle`);
- a traffic mix: `traffic/<mix>.json`, parameters of the flow it
  names, `flows/<flow>.py` (`drive`, `judge`; `drive.py`);
- a per-layer metric: `layer_metrics/<metric>.py`, and an end-to-end
  one `end_to_end/<metric>.py`, whose `read(ctx)` returns the number or
  None (`cell.Ctx`).
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_benchmark(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as f:
        return json.load(f)


def traffic(name: str, bench_dir: str = BENCH_DIR) -> dict:
    path = os.path.join(bench_dir, "traffic", name + ".json")
    if not os.path.exists(path):
        raise KeyError(f"no traffic file {path}")
    with open(path) as f:
        return json.load(f)


def _module(path: str, tag: str):
    if not os.path.exists(path):
        raise KeyError(f"no file {path}")
    spec = importlib.util.spec_from_file_location(
        "bench_" + tag + "_" + re.sub(r"\W", "_", os.path.basename(path)),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference(name: str, bench_dir: str = BENCH_DIR):
    return _module(os.path.join(bench_dir, "reference", name + ".py"),
                   "reference")


def flow(name: str, bench_dir: str = BENCH_DIR):
    return _module(os.path.join(bench_dir, "flows", name + ".py"), "flow")


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    return _module(os.path.join(bench_dir, "layer_metrics", name + ".py"),
                   "metric").read


def end_to_end_reader(name: str, bench_dir: str = BENCH_DIR):
    return _module(os.path.join(bench_dir, "end_to_end", name + ".py"),
                   "e2e").read


def end_to_end(bench: dict, cell: str) -> list:
    """The cell's end-to-end metrics: those that list it, or list no
    cells."""
    return [m for m in bench["end_to_end"]
            if cell in m.get("workloads", [cell])]


def per_layer(bench: dict, cell: str) -> list:
    """The cell's per-layer metrics: those that list it, or, listing no
    cells, move an end-to-end metric the cell reports."""
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in reported)]
