"""The port engine's chunk-loop guards (`Engine(device="cpu")`), the
counterparts of `tests/test_overhead.py`'s engine cases: a run with no
viewer does zero wire-encode and band-copy work, `chunk_overhead_us` (host
µs a chunk outside the counted token's wait and the excluded stalls) is
measured, positive, under 20 ms and equal to its gauge, and a repeat run
adds no step signature. Beyond the mirror: the port's `stats()` keys and
`run_end` fields equal `gol_tpu`'s for the same run (the port's stats add
`device`, which names the torch device of its single-device path, and the
cumulative host counters `issue_s`, `token_wait_s`, `host_s` and `chunks`
that `chunk_overhead_us` comes from).

Every engine assertion is a counter delta (the registry is process-wide);
the one timing bound is the reference test's 20 ms ceiling."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from gol_tpu.engine import Engine as JEngine
from gol_tpu.params import Params as JParams

from gol_tpu_torch.engine import Engine
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.params import Params

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _small_chunks(monkeypatch):
    monkeypatch.setenv("GOL_MAX_CHUNK", "64")
    for k in ("GOL_CKPT", "GOL_JOURNAL", "GOL_RUN_REPORT", "GOL_TRACE",
              "GOL_PROFILE_DIR", "GOL_FUSE_K"):
        monkeypatch.delenv(k, raising=False)


def _world(n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(0)
    return ((rng.random((n, n)) < 0.25).astype(np.uint8)) * 255


def _run(eng, n: int = 64, turns: int = 2048, params=Params):
    p = params(threads=1, image_width=n, image_height=n, turns=turns)
    return eng.server_distributor(p, _world(n))


def test_no_viewer_run_does_zero_encode_or_band_work():
    eng = Engine(device="cpu")
    chunks0 = obs.ENGINE_CHUNKS_TOTAL.value
    enc0 = obs.WIRE_ENCODE_CALLS.value
    band0 = obs.ENGINE_BAND_COPIES.value
    _run(eng)
    assert obs.ENGINE_CHUNKS_TOTAL.value - chunks0 >= 8
    assert obs.WIRE_ENCODE_CALLS.value == enc0
    assert obs.ENGINE_BAND_COPIES.value == band0


def test_chunk_overhead_measured_and_under_ceiling():
    eng = Engine(device="cpu")
    _run(eng)
    stats = eng.stats()
    assert 0 < stats["chunk_overhead_us"] < 20_000
    # stats() rounds to 2 decimals; the gauge keeps full precision.
    assert obs.ENGINE_CHUNK_OVERHEAD_US.value == pytest.approx(
        stats["chunk_overhead_us"], abs=0.011)


def test_repeat_run_adds_no_step_signatures():
    eng = Engine(device="cpu")
    _run(eng, turns=512)
    sig0 = obs.COMPILE_STEP_SIGNATURES.value
    _run(eng, turns=512)
    assert obs.COMPILE_STEP_SIGNATURES.value == sig0


def _run_end(path) -> dict:
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    ends = [r for r in recs if r.get("event") == "run_end"]
    assert len(ends) == 1
    return ends[0]


def test_stats_keys_and_run_end_fields_equal_gol_tpu(monkeypatch,
                                                     tmp_path):
    port, ref = Engine(device="cpu"), JEngine()
    monkeypatch.setenv("GOL_RUN_REPORT", str(tmp_path / "port.jsonl"))
    _, turn = _run(port, turns=256)
    monkeypatch.setenv("GOL_RUN_REPORT", str(tmp_path / "ref.jsonl"))
    _, jturn = _run(ref, turns=256, params=JParams)
    assert turn == jturn == 256
    stats, jstats = port.stats(), ref.stats()
    assert set(stats) == set(jstats) | {"device", "issue_s", "token_wait_s",
                                        "host_s", "chunks"}
    assert stats["chunk_overhead_us"] > 0
    end, jend = _run_end(tmp_path / "port.jsonl"), _run_end(
        tmp_path / "ref.jsonl")
    assert set(end) == set(jend)
    assert end["chunk_overhead_us"] == stats["chunk_overhead_us"]
    for key in ("turn", "turns_total"):
        assert end[key] == jend[key]
