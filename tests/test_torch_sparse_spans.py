"""The sparse path's spans and counters (`SparseEngine(device="cpu")`
through `run(..., sparse=True)`): with the span gate open every chunk
records one `sparse.chunk` holding its `sparse.margins`, `sparse.grow`,
`sparse.macro`, `sparse.count` and `sparse.publish` spans, one
`sparse.margins` for each margin fetch and one `sparse.grow` for each
grow; the macros' turns add up to the job's and their h x wp x 32 x k
to `window_cell_updates`; `sparse.final_window` and
`controller.sparse_finish` come once a job; with the gate closed no
gated span is recorded and the counters still count; `stats()` carries
the counters across jobs and the registry's `gol_sparse_*_total`
families move with them."""

from __future__ import annotations

import queue
import threading
import time
from collections import Counter

import numpy as np
import pytest
import torch

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch.io.pgm import write_pgm
from gol_tpu_torch.models.sparse import R_PENTOMINO, SparseTorus
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import trace
from gol_tpu_torch.obs.metrics import REGISTRY
from gol_tpu_torch.sparse_engine import TORUS_COUNTERS, SparseEngine

torch.set_num_threads(2)

SIZE = 4096
TURNS = 640
GATED = {"sparse.chunk", "sparse.count", "sparse.publish", "sparse.margins",
         "sparse.grow", "sparse.macro"}
PER_JOB = {"sparse.final_window", "controller.sparse_finish"}
FAMILIES = {
    "window_cell_updates": obs.SPARSE_WINDOW_CELL_UPDATES_TOTAL,
    "macros": obs.SPARSE_MACROS_TOTAL,
    "margin_fetches": obs.SPARSE_MARGIN_FETCHES_TOTAL,
    "grows": obs.SPARSE_GROWS_TOTAL,
}


@pytest.fixture(autouse=True)
def _quiet(monkeypatch):
    for k in ("SER", "CONT", "SUB", "GOL_RULE", "GOL_SPARSE_SHARDS",
              "GOL_TRACE_SPANS", "GOL_FLIGHT", "GOL_CKPT", "GOL_MAX_CHUNK"):
        monkeypatch.delenv(k, raising=False)
    trace.TRACER.reset()
    yield
    trace.TRACER.reset()


@pytest.fixture
def images(tmp_path):
    board = np.zeros((16, 16), np.uint8)
    for x, y in R_PENTOMINO:
        board[6 + y, 7 + x] = 255
    d = tmp_path / "images"
    write_pgm(str(d / "seed.pgm"), board)
    return str(d)


def _job(eng, images, out_dir, turns: int = TURNS) -> None:
    q = queue.Queue()
    th = gol_tpu_torch.run(Params(image_width=SIZE, image_height=SIZE,
                                  turns=turns), q, None, engine=eng,
                           images_dir=images, out_dir=out_dir, sparse=True)
    th.join(170)
    assert not th.is_alive() and th.exception is None
    finals = [e for e in ev.drain(q) if isinstance(e, ev.FinalTurnComplete)]
    assert finals and finals[0].completed_turns == turns


def _by_name(spans) -> dict:
    out: dict = {}
    for s in spans:
        out.setdefault(s["name"], []).append(s)
    return out


def _family_values() -> dict:
    return {k: f.value for k, f in FAMILIES.items()}


def test_gate_open_spans_match_the_counters(images, tmp_path, monkeypatch):
    monkeypatch.setenv("GOL_TRACE_SPANS", str(tmp_path / "spans.json"))
    assert trace.hot_spans_enabled()
    eng = SparseEngine(SIZE, device="cpu")
    before = _family_values()
    for _ in range(2):
        _job(eng, images, str(tmp_path / "out"))
    st = eng.stats()
    spans = _by_name(trace.TRACER.finished_spans())
    assert set(spans) >= GATED | PER_JOB
    assert len(spans["sparse.margins"]) == st["margin_fetches"] > 0
    assert len(spans["sparse.grow"]) == st["grows"] > 0
    macros = spans["sparse.macro"]
    assert len(macros) == st["macros"]
    assert sum(s["attrs"]["k"] for s in macros) == 2 * TURNS
    assert st["window_cell_updates"] == sum(
        s["attrs"]["h"] * s["attrs"]["wp"] * 32 * s["attrs"]["k"]
        for s in macros)
    assert {s["attrs"]["kernel"] for s in macros} <= {"K1", "K2"}
    after = _family_values()
    assert {k: after[k] - before[k] for k in FAMILIES} == \
        {k: st[k] for k in FAMILIES}
    for name in PER_JOB:
        assert len(spans[name]) == 2, name
    # Every chunk holds its own spans, and its turns are the job's.
    chunks = {s["span"]: s for s in spans["sparse.chunk"]}
    assert sum(s["attrs"]["k"] for s in chunks.values()) == 2 * TURNS
    for name in ("sparse.count", "sparse.publish"):
        assert len(spans[name]) == len(chunks)
        assert {s["parent"] for s in spans[name]} == set(chunks)
    for name in ("sparse.margins", "sparse.grow", "sparse.macro"):
        for s in spans[name]:
            c = chunks[s["parent"]]
            assert c["start"] <= s["start"] <= s["end"] <= c["end"], name
    for s in spans["sparse.grow"]:
        a = s["attrs"]
        assert a["new_h"] >= a["h"] and a["new_w"] >= a["w"]
    (run1, run2) = spans["controller.run"]
    for s in spans["controller.sparse_finish"]:
        assert s["parent"] in (run1["span"], run2["span"])


def test_gate_closed_records_no_gated_span(images, tmp_path):
    assert not trace.hot_spans_enabled()
    eng = SparseEngine(SIZE, device="cpu")
    _job(eng, images, str(tmp_path / "out"))
    names = Counter(s["name"] for s in trace.TRACER.finished_spans())
    assert not set(names) & GATED
    for name in PER_JOB:
        assert names[name] == 1, name
    st = eng.stats()
    assert st["macros"] > 0 and st["margin_fetches"] > 0
    assert st["window_cell_updates"] >= 32 * TURNS


def test_a_profiler_elsewhere_opens_the_gate(images, tmp_path):
    stop, started = threading.Event(), threading.Event()

    def hold():
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            started.set()
            stop.wait(120)

    th = threading.Thread(target=hold, daemon=True)
    th.start()
    try:
        assert started.wait(120)
        deadline = time.monotonic() + 60
        while not trace.profiler_running():
            assert time.monotonic() < deadline
            time.sleep(0.01)
        eng = SparseEngine(SIZE, device="cpu")
        _job(eng, images, str(tmp_path / "out"), turns=300)
    finally:
        stop.set()
        th.join(60)
    names = Counter(s["name"] for s in trace.TRACER.finished_spans())
    assert names["sparse.margins"] == eng.stats()["margin_fetches"]
    assert names["sparse.chunk"] == names["sparse.count"] > 0


def test_stats_keys_and_catalog_names():
    eng = SparseEngine(SIZE, device="cpu")
    st = eng.stats()
    assert set(TORUS_COUNTERS) <= set(st)
    assert all(st[k] == 0 for k in TORUS_COUNTERS)
    fams = REGISTRY.families()
    for key, fam in FAMILIES.items():
        name = f"gol_sparse_{key}_total"
        assert fam.name == name and fams[name].kind == "counter"
        assert not fams[name].label_names


def test_counters_survive_a_restore(images, tmp_path):
    eng = SparseEngine(SIZE, device="cpu")
    _job(eng, images, str(tmp_path / "out"), turns=300)
    first = {k: eng.stats()[k] for k in TORUS_COUNTERS}
    path = str(tmp_path / "ck.npz")
    eng.save_checkpoint(path)
    eng.load_checkpoint(path)
    assert {k: eng.stats()[k] for k in TORUS_COUNTERS} == first


def test_a_bare_torus_records_no_span():
    t = SparseTorus(SIZE, [(x + 100, y + 100) for x, y in R_PENTOMINO],
                    device="cpu")
    t.run(600)
    assert t.macros > 0 and t.grows > 0
    assert t.window_cell_updates > 0
    assert not {s["name"] for s in trace.TRACER.finished_spans()} & GATED
