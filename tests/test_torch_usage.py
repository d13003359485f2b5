"""The port's usage meter (`gol_tpu_torch.obs.usage`), mirroring the
single-device tests of `tests/test_usage.py` — the meter's contracts:
every dispatch quantum's wall apportions across the runs active in it
with the conservation invariant (sum of shares == measured wall within
1%) under BOTH batch and spatial placement; accumulator cardinality
stays bounded by the resident set under run churn and unknown-id
stragglers; the heartbeat snapshot degrades by dropping the "use"
family FIRST under a tight byte budget; and the live fleet engine
attributes real dispatches, publishes capacity headroom rows, and
writes a final "usage" journal record on destroy.

Everything here is CPU-cheap: the meter tests are pure bookkeeping;
the fleet coverage test drives tiny 64² runs on `FleetEngine(device=
"cpu")`. The snapshot-degradation test waits for the exporter (ROADMAP
A13(b)); in its place, the port's meter is held against `gol_tpu`'s on
the same dispatch stream. Tolerance: none beyond the meter's own 1%
conservation ceiling.
"""

import json
import time

import numpy as np
import pytest

from gol_tpu.obs.usage import UsageMeter as JUsageMeter

from gol_tpu_torch import journal
from gol_tpu_torch.obs.usage import METER, UsageMeter

TOPK_ENV = "GOL_USAGE_TOPK"
FLUSH_ENV = "GOL_USAGE_FLUSH_S"


@pytest.fixture(autouse=True)
def _meter_isolation(monkeypatch):
    """Every test gets a clean module meter, fresh-doc rebuilds and no
    ambient knob overrides."""
    monkeypatch.delenv(TOPK_ENV, raising=False)
    monkeypatch.setenv(FLUSH_ENV, "0")
    METER.reset()
    yield
    METER.reset()


# ------------------------------------------------- attribution math

def test_conservation_across_batch_and_spatial():
    """Batch splits the quantum, spatial charges it whole — and the
    per-run shares still sum to the measured wall exactly (the 1%
    acceptance ceiling covers float rounding only)."""
    m = UsageMeter()
    for rid in ("r1", "r2", "r3"):
        m.track(rid)
    m.ingest_dispatches([
        # One batched quantum shared by three slots: 0.1 s each.
        ("batch", 0.3, 8, [("r1", 64 * 64), ("r2", 64 * 64),
                           ("r3", 64 * 64)]),
        # A single-placement quantum: the lone run gets all 0.2 s.
        ("single", 0.2, 8, [("r1", 64 * 64)]),
        # Spatial serializes boards across the whole mesh: each run is
        # charged the FULL 0.4 s and the wall denominator grows by
        # 0.4 s per active run.
        ("spatial", 0.4, 8, [("r2", 64 * 64), ("r3", 64 * 64)]),
    ])
    doc = m.usage_doc()
    att = doc["attribution"]
    assert att["wall_s"] == pytest.approx(0.3 + 0.2 + 2 * 0.4)
    assert att["attributed_s"] == pytest.approx(att["wall_s"])
    assert att["error_pct"] <= 1.0

    by_id = {r["run_id"]: r for r in doc["top"]}
    assert by_id["r1"]["device_s"] == pytest.approx(0.1 + 0.2)
    assert by_id["r2"]["device_s"] == pytest.approx(0.1 + 0.4)
    assert by_id["r3"]["device_s"] == pytest.approx(0.1 + 0.4)
    # 8 turns per dispatch, 2 dispatches each for r2/r3.
    assert by_id["r2"]["turns"] == 16
    assert by_id["r2"]["cells"] == 16 * 64 * 64
    # Ranked by device-time share, descending, shares summing to 100.
    assert doc["top"][0]["device_s"] >= doc["top"][-1]["device_s"]
    assert sum(r["share_pct"] for r in doc["top"]) == pytest.approx(
        100.0, abs=0.1)


def test_conservation_survives_retire():
    """Destroying a run must not unbalance the lifetime ledger: the
    attributed total keeps the retired run's shares."""
    m = UsageMeter()
    m.track("a")
    m.track("b")
    m.ingest_dispatches([("batch", 1.0, 4, [("a", 16), ("b", 16)])])
    rec = m.retire("a")
    assert rec["device_s"] == pytest.approx(0.5)
    assert rec["turns"] == 4
    assert m.retire("a") is None  # idempotent (migrate-out path)
    att = m.usage_doc()["attribution"]
    assert att["error_pct"] <= 1.0
    assert att["attributed_s"] == pytest.approx(1.0)


# ------------------------------------------------ bounded cardinality

def test_cardinality_bounded_under_churn():
    """500 run lifetimes leave ZERO accumulators behind; stragglers
    charging destroyed ids fold into the single untracked aggregate
    instead of re-growing the map."""
    m = UsageMeter()
    for i in range(500):
        rid = f"churn{i}"
        m.track(rid)
        m.ingest_dispatches([("single", 0.001, 2, [(rid, 16)])])
        assert m.retire(rid) is not None
        # Late broadcast/checkpoint stragglers after the destroy:
        m.charge_wire(rid, 100, 200)
        m.charge_ckpt(rid, 1 << 20)
    doc = m.usage_doc()
    assert doc["runs_tracked"] == 0
    assert doc["retired_runs"] == 500
    assert len(m._runs) == 0
    assert doc["untracked"]["events"] == 1000
    assert doc["untracked"]["wire_in"] == 500 * 100
    assert doc["attribution"]["error_pct"] <= 1.0


def test_topk_caps_the_doc(monkeypatch):
    """GOL_USAGE_TOPK bounds the published table no matter how many
    runs are resident — the doc never grows with tenancy."""
    monkeypatch.setenv(TOPK_ENV, "3")
    m = UsageMeter()
    for i in range(20):
        rid = f"t{i}"
        m.track(rid)
        m.ingest_dispatches([("single", 0.001 * (i + 1), 2,
                              [(rid, 16)])])
    doc = m.usage_doc()
    assert doc["runs_tracked"] == 20
    assert doc["k"] == 3
    assert len(doc["top"]) == 3
    # The top 3 by device time are the 3 largest charges.
    assert [r["run_id"] for r in doc["top"]] == ["t19", "t18", "t17"]


def test_run_doc_unknown_raises_keyerror():
    m = UsageMeter()
    with pytest.raises(KeyError, match="unknown run"):
        m.run_doc("nope")


# ----------------------------------------------- parity with gol_tpu

def test_meter_docs_equal_gol_tpu_on_the_same_stream():
    """The same tracks, dispatches, charges and retires give the same
    usage document (times aside) and summary in both packages."""
    stream = [
        ("batch", 0.3, 8, [("a", 64 * 64), ("b", 32 * 32)]),
        ("single", 0.2, 8, [("a", 64 * 64)]),
        ("spatial", 0.4, 2, [("b", 32 * 32), ("c", 16)]),
    ]
    docs = []
    for cls in (UsageMeter, JUsageMeter):
        m = cls()
        for rid in ("a", "b", "c"):
            m.track(rid)
        m.ingest_dispatches(stream)
        m.charge_turns("a", 3, 3 * 64 * 64)
        m.charge_ckpt("b", 1 << 20)
        m.charge_journal("c", 321)
        m.charge_wire("gone", 1, 2)
        retired = m.retire("c")
        doc = m.usage_doc(now=1000.0)
        for row in doc["top"]:
            row.pop("dur_s", None)
        retired.pop("dur_s", None)
        docs.append((doc, retired, m.export_summary()))
    assert docs[0] == docs[1]


def test_export_summary_idle_is_free():
    """A member with nothing metered ships no "use" family at all —
    the lowest-priority family costs zero snapshot bytes at idle."""
    m = UsageMeter()
    assert m.export_summary() is None
    m.track("x")
    s = m.export_summary()
    assert s["tracked"] == 1 and s["top"] == [["x", 0.0]]
    # The compact summary must stay JSON-wire-safe.
    json.dumps(s)


# --------------------------------------------------- fleet integration

@pytest.mark.filterwarnings("ignore::DeprecationWarning")
def test_fleet_attributes_and_journals_usage(tmp_path, monkeypatch):
    """Real dispatches: the engine's batched flush attributes device
    time to each resident run with conservation holding, publishes
    capacity headroom rows for its bucket class, and DestroyRun lands
    the final "usage" record in the run's hash-chained journal."""
    from gol_tpu_torch.fleet.engine import FleetEngine

    def _wait(pred, timeout=60.0, what="condition"):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if pred():
                return
            time.sleep(0.02)
        raise AssertionError(f"timed out waiting for {what}")

    monkeypatch.setenv(journal.JOURNAL_ENV, str(tmp_path / "j"))
    journal.reset()
    rng = np.random.default_rng(23)
    seed = (rng.random((64, 64)) < 0.3).astype(np.uint8)
    eng = FleetEngine(device="cpu", bucket_sizes=(64,), chunk_turns=2,
                      slot_base=2)
    try:
        eng.create_run(64, 64, board=seed, run_id="ua")
        eng.create_run(64, 64, run_id="ub")

        def _attributed():
            top = {r["run_id"]: r
                   for r in METER.usage_doc().get("top", [])}
            return ("ua" in top and "ub" in top
                    and top["ua"]["device_s"] > 0
                    and top["ub"]["device_s"] > 0)

        _wait(_attributed, what="both runs attributed")
        doc = METER.usage_doc()
        assert doc["attribution"]["wall_s"] > 0
        assert doc["attribution"]["error_pct"] <= 1.0
        rows = {r["bucket"]: r for r in doc["capacity"]}
        assert "64x64" in rows
        assert rows["64x64"]["run_cost_bytes"] > 0
        assert rows["64x64"]["quantum_mean_ms"] > 0
        assert rows["64x64"]["cups_headroom"] > 0
        turns_before = {r["run_id"]: r["turns"] for r in doc["top"]}
        eng.destroy_run("ua")
    finally:
        eng.kill_prog()
        journal.reset()  # close ub's writer (ua's closed at destroy)

    with pytest.raises(KeyError):
        METER.run_doc("ua")
    records, torn = journal.load_records(journal.journal_path("ua"))
    assert torn is None
    kinds = [r["kind"] for r in records]
    assert "usage" in kinds
    assert kinds.index("usage") < kinds.index("end")
    urec = records[kinds.index("usage")]
    assert urec["device_s"] > 0
    assert urec["turns"] >= turns_before["ua"]
    assert urec["journal_bytes"] > 0  # the journal meters itself
    assert journal.verify_chain(records)["ok"]
