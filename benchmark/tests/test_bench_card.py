"""Each cell once on the card through the benchmark's command, at a
short window: the result line and `correct`. Skips without a card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from yardstick import registry


@pytest.mark.card
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", [w["name"] for w in registry.load_benchmark()
                                  ["workloads"]])
def test_cell_runs_correct_on_the_card(card, cell, trace):
    p = subprocess.run(
        [sys.executable, os.path.join(registry.BENCH_DIR, "run.py"),
         "--workload", cell, "--seed", str(2**31 + 11), "--seconds", "2",
         "--trace", str(trace)], capture_output=True, text=True,
        cwd=registry.ROOT, timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True, p.stderr[-4000:]
    assert result["device"]["platform"] == "gpu"
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
