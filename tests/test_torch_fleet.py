"""The port's fleet engine (`gol_tpu_torch.fleet`, `FleetEngine(device=
"cpu")`), mirroring `tests/test_fleet.py` and held against `gol_tpu`'s
fleet fed the same numpy seeds: bucket tiling is exact, targets are hit
exactly, admission is a memory budget with diagnosable rejects and a
draining wait queue, destroy frees the slot, the rotation is fair,
admission within capacity adds no step signature, pause freezes the
board, per-run checkpoints land in contained run-<id> directories,
/healthz's run summary and the fleet-health cache track the runs, and a
capability-less legacy peer on a --fleet server gets the dense engine's
board. Beyond the mirror: the batch words and popcounts equal
`gol_tpu`'s `Bucket` at every quantum, run records and rule migration
equal `gol_tpu`'s, and the legacy drive counts only turns stepped from
its seed (the reference's race, pinned). Tolerance: none."""

import contextlib
import io
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest
import torch

from gol_tpu.engine import Engine as JEngine
from gol_tpu.fleet import FleetEngine as JFleet
from gol_tpu.fleet.buckets import Bucket as JBucket
from gol_tpu.fleet.handles import RunHandle as JHandle
from gol_tpu.models import CONWAY as J_CONWAY
from gol_tpu.ops.bitpack import (
    pack_np,
    packed_run_turns,
    unpack_np,
    words_bytes_np,
)
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.params import Params as JParams

from gol_tpu_torch import chaos, wire
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.engine import FLAG_KILL, FLAG_PAUSE, Engine
from gol_tpu_torch.fleet import (
    AdmissionController,
    FleetEngine,
    FleetUnsupported,
    run_cost,
)
from gol_tpu_torch.fleet.buckets import Bucket, bucket_to_jax
from gol_tpu_torch.fleet.handles import RunHandle
from gol_tpu_torch.models.lifelike import CONWAY
from gol_tpu_torch.obs import audit as obs_audit
from gol_tpu_torch.obs import catalog as obs_cat
from gol_tpu_torch.obs import devstats
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.params import Params
from gol_tpu_torch.server import EngineServer
from gol_tpu_torch.server import main as server_main

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("GOL_FLEET_BUCKETS", "GOL_FLEET_CHUNK", "GOL_FLEET_SLOT_BASE",
              "GOL_FLEET_MEM_BUDGET", "GOL_FUSE_K", "GOL_CKPT",
              "GOL_CHAOS", "GOL_JOURNAL", "GOL_RUN_REPORT", "GOL_WIRE_CAPS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")


def _soup(h, w, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def _replay(seed01, turns):
    """`gol_tpu`'s single-board packed torus replay — the parity oracle.
    Width must be word-aligned so the packed torus IS the board's."""
    h, w = seed01.shape
    assert w % 32 == 0
    words = packed_run_turns(pack_np(seed01).view("<u4"), turns, J_CONWAY)
    return unpack_np(words_bytes_np(np.asarray(words)), h, w)


def _wait(pred, timeout=30.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _small(**kw):
    return FleetEngine(device="cpu", bucket_sizes=(64,), chunk_turns=2,
                       slot_base=2, **kw)


@pytest.fixture
def fleet():
    """Small, fast fleet: one 64² bucket, 2-turn quantum."""
    eng = _small()
    yield eng
    eng.kill_prog()


@pytest.fixture
def jfleet():
    """`gol_tpu`'s fleet at the same geometry, for parity."""
    eng = JFleet(bucket_sizes=(64,), chunk_turns=2, slot_base=2)
    yield eng
    eng.kill_prog()


def _park(eng, run_id):
    rv = eng.resolve_run(run_id)
    _wait(lambda: rv.stats()["state"] == "parked",
          what=f"run {run_id} to park")
    return rv


# ------------------------------------------------- bucket tiling parity


@pytest.mark.parametrize("shape", [(64, 64), (32, 32), (32, 64)])
def test_bucket_tiling_parity(fleet, jfleet, shape):
    """A board tiled into a shared 64² bucket slot reaches its target
    bit-identical to its own torus, and to `gol_tpu`'s fleet: board,
    turn, alive and the run record."""
    h, w = shape
    seed = _soup(h, w, seed=h * 100 + w)
    for eng in (fleet, jfleet):
        eng.create_run(h, w, board=seed, run_id=f"p{h}x{w}",
                       target_turn=12)
    rv, jrv = _park(fleet, f"p{h}x{w}"), _park(jfleet, f"p{h}x{w}")
    got, turn = rv.get_world()
    assert turn == 12
    expect = _replay(seed, 12)
    np.testing.assert_array_equal((got != 0).astype(np.uint8), expect)
    jgot, jturn = jrv.get_world()
    np.testing.assert_array_equal(got, jgot)
    assert rv.alive_count() == jrv.alive_count() == (int(expect.sum()), 12)
    assert rv.describe_run() == jrv.describe_run()


def test_target_not_multiple_of_quantum_is_exact(fleet):
    """Targets are hit EXACTLY even when they don't divide the serving
    quantum (the trim steps the slot's bucket torus the remainder)."""
    seed = _soup(64, 64, seed=9)
    fleet.create_run(64, 64, board=seed, run_id="trim", target_turn=7)
    rv = _park(fleet, "trim")
    got, turn = rv.get_world()
    assert turn == 7
    np.testing.assert_array_equal((got != 0).astype(np.uint8),
                                  _replay(seed, 7))


@pytest.mark.parametrize("fuse", (3, 5))
def test_fused_quantum_keeps_the_turn_ledger_exact(monkeypatch, fuse):
    """GOL_FUSE_K multiplies the quantum (chunk x k turns a launch); a
    target it does not divide still lands exactly."""
    monkeypatch.setenv("GOL_FUSE_K", str(fuse))
    eng = _small()
    try:
        assert eng.turns_per_dispatch == 2 * fuse
        seed = _soup(32, 64, seed=fuse)
        eng.create_run(32, 64, board=seed, run_id="fz", target_turn=17)
        rv = _park(eng, "fz")
        got, turn = rv.get_world()
        assert turn == 17
        np.testing.assert_array_equal((got != 0).astype(np.uint8),
                                      _replay(seed, 17))
        assert eng.stats()["fleet"]["fuse_k"] == fuse
    finally:
        eng.kill_prog()


# ------------------------------------------------------------ admission


def test_admission_rejects_and_queue_drains():
    """Beyond the byte budget CreateRun rejects with a diagnosable
    reason (metered), queue=True parks in the wait queue, and removing
    a resident run promotes the queued one."""
    cost = run_cost(64, 2)
    eng = _small(admission=AdmissionController(budget_bytes=2 * cost))
    try:
        admitted0 = obs_cat.RUNS_ADMITTED.value
        eng.create_run(64, 64, run_id="a")
        eng.create_run(32, 32, run_id="b")  # small board, same slot cost
        assert obs_cat.RUNS_ADMITTED.value == admitted0 + 2
        rejected0 = sum(c.value for c in
                        obs_cat.RUNS_REJECTED.children().values())
        with pytest.raises(RuntimeError, match="memory"):
            eng.create_run(64, 64, run_id="c")
        assert sum(c.value for c in
                   obs_cat.RUNS_REJECTED.children().values()) \
            == rejected0 + 1
        rec = eng.create_run(64, 64, run_id="d", queue=True)
        assert rec["state"] == "queued"
        eng.resolve_run("a").cf_put(FLAG_KILL)
        _wait(lambda: eng.runs_summary()["resident"] == 2 and
              eng.runs_summary()["queued"] == 0,
              what="queued run to promote after a kill")
        with pytest.raises(KeyError, match="unknown run"):
            eng.resolve_run("a")
        assert eng.resolve_run("d").stats()["state"] == "resident"
    finally:
        eng.kill_prog()


def test_destroy_run_frees_slot_and_promotes_queued():
    """DestroyRun: the final record with state="removed", the destroy
    counter, the admission charge released, and the freed budget
    promotes a queued waiter without a control-flag round trip."""
    cost = run_cost(64, 2)
    eng = _small(admission=AdmissionController(budget_bytes=2 * cost))
    try:
        eng.create_run(64, 64, run_id="a")
        eng.create_run(64, 64, run_id="b")
        rec = eng.create_run(64, 64, run_id="q", queue=True)
        assert rec["state"] == "queued"
        destroyed0 = obs_cat.RUNS_DESTROYED.value
        final = eng.destroy_run("a")
        assert final["run_id"] == "a" and final["state"] == "removed"
        assert obs_cat.RUNS_DESTROYED.value == destroyed0 + 1
        with pytest.raises(KeyError, match="unknown run"):
            eng.resolve_run("a")
        _wait(lambda: eng.runs_summary()["resident"] == 2 and
              eng.runs_summary()["queued"] == 0,
              what="queued run to promote after destroy")
        assert eng.resolve_run("q").stats()["state"] == "resident"
        _wait(lambda: obs_cat.FLEET_QUEUE_WAIT_MS.labels(q="p50").value
              > 0, what="queue-wait percentile gauge to publish")
    finally:
        eng.kill_prog()


def test_destroy_run_refuses_legacy_and_unknown(fleet):
    for legacy in ("run0", ""):
        with pytest.raises(PermissionError, match="legacy"):
            fleet.destroy_run(legacy)
    with pytest.raises(KeyError, match="unknown run"):
        fleet.destroy_run("nope")


def test_single_run_surface_refuses_destroy():
    with pytest.raises(FleetUnsupported, match="--fleet"):
        Engine(device="cpu").destroy_run("anything")
    with pytest.raises(FleetUnsupported, match="--fleet"):
        Engine(device="cpu").create_run(64, 64)


def test_admission_rejects_misfit_shape_and_hostile_run_id(fleet):
    with pytest.raises(RuntimeError, match="shape"):
        fleet.create_run(48, 48)  # 48 divides no 64² bucket
    for bad in ("../evil", "a/b", "run0", "x" * 65, ""):
        with pytest.raises(RuntimeError, match="run_id"):
            fleet.create_run(64, 64, run_id=bad)
    with pytest.raises(RuntimeError, match="rule"):
        fleet.create_run(64, 64, rule="/2/3")  # Generations: not life-like


def test_run_id_never_reaches_checkpoint_paths(fleet, tmp_path):
    with pytest.raises(PermissionError):
        fleet._ckpt_dir("../escape", str(tmp_path))


def test_records_and_summaries_match_gol_tpu(fleet, jfleet):
    """The same admissions give the same ListRuns records (queued,
    resident and parked runs) and summaries in both packages."""
    seeds = {f"r{i}": _soup(32, 32, seed=40 + i) for i in range(3)}
    for eng in (fleet, jfleet):
        for rid, seed in seeds.items():
            eng.create_run(32, 32, board=seed, run_id=rid, target_turn=6,
                           ckpt_every=4)
        for rid in seeds:
            _park(eng, rid)
    assert fleet.list_runs() == jfleet.list_runs()
    assert fleet.runs_summary() == jfleet.runs_summary()
    assert fleet.describe_run() == jfleet.describe_run()


def test_set_rule_migrates_board_intact_as_gol_tpu_does(fleet, jfleet):
    """SetRule re-homes a run under the new rule's bucket with its board;
    both packages continue to the same board under the new rule."""
    seed = _soup(64, 64, seed=77)
    for eng in (fleet, jfleet):
        eng.create_run(64, 64, board=seed, run_id="sr", target_turn=4)
        _park(eng, "sr")
        rec = eng.set_rule("sr", "B36/S23")
        assert rec["rule"] == "B36/S23"
        with pytest.raises(PermissionError, match="legacy"):
            eng.set_rule("run0", "B36/S23")
        eng.resolve_run("sr").server_distributor(
            JParams(turns=6), None)
    got, turn = fleet.resolve_run("sr").get_world()
    jgot, jturn = jfleet.resolve_run("sr").get_world()
    assert turn == jturn == 10
    np.testing.assert_array_equal(got, jgot)
    assert fleet.resolve_run("sr").describe_run() == \
        jfleet.resolve_run("sr").describe_run()


# ------------------------------------------------------ fair scheduling


def test_round_robin_is_fair_across_buckets():
    """Each non-empty bucket gets one quantum per rotation: a bucket
    with 3 resident runs cannot starve the 1-run bucket."""
    eng = FleetEngine(device="cpu", bucket_sizes=(32, 64), chunk_turns=2,
                      slot_base=2)
    try:
        eng.create_run(32, 32, run_id="small")
        for i in range(3):
            eng.create_run(64, 64, run_id=f"big{i}")
        _wait(lambda: eng.runs_summary()["resident"] == 4,
              what="all runs resident")

        def counts():
            return {row["shape"]: row["dispatches"]
                    for row in eng.stats()["fleet"]["buckets"]}

        base = counts()
        _wait(lambda: all(counts().get(k, 0) - v >= 8
                          for k, v in base.items()),
              what="both buckets to accumulate dispatches")
        delta = {k: counts()[k] - base[k] for k in base}
        small, big = delta["32x32"], delta["64x64"]
        assert small > 0 and big > 0
        assert abs(small - big) <= max(small, big) // 2 + 2
    finally:
        eng.kill_prog()


# -------------------------------------------- batch-shape stability


def test_adding_run_within_capacity_adds_no_signature(fleet):
    """Admitting into existing slot capacity adds no step signature (the
    JAX package's recompile witness, with its key)."""
    fleet.create_run(64, 64, run_id="first")
    rv = fleet.resolve_run("first")
    _wait(lambda: rv.stats()["turn"] >= 2, what="first run stepping")
    sig0 = devstats.signature_count()
    fleet.create_run(64, 64, run_id="second")  # slot_base=2: capacity
    rv2 = fleet.resolve_run("second")
    t0 = rv2.stats()["turn"]
    _wait(lambda: rv2.stats()["turn"] >= t0 + 4,
          what="second run stepping")
    assert devstats.signature_count() == sig0


@pytest.mark.parametrize("hb,wb,boards", [
    (64, 64, ((64, 64), (32, 32), (32, 64), (16, 32), (64, 64))),
    (24, 96, ((24, 24), (24, 24), (24, 32))),
])
def test_bucket_words_and_popcounts_equal_gol_tpu_every_quantum(
        hb, wb, boards):
    """A port Bucket and a `gol_tpu` Bucket fed the same boards (placed
    past the initial capacity, so the batch grows) hold the same words
    and return the same popcounts at every quantum, fused or not."""
    tb = Bucket(hb, wb, CONWAY, slot_base=2)
    jb = JBucket(hb, wb, J_CONWAY, slot_base=2)
    for i, (h, w) in enumerate(boards):
        seed = _soup(h, w, seed=500 + i)
        assert tb.place(RunHandle(f"r{i}", CONWAY, h, w), seed) == \
            jb.place(JHandle(f"r{i}", J_CONWAY, h, w), seed)
    assert tb.cap == jb.cap > 2
    for q, (turns, fuse) in enumerate(((2, 1), (2, 1), (3, 2), (8, 1))):
        got = tb.dispatch(turns, fuse=fuse)
        want = jb.dispatch(turns, fuse=fuse)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"popcounts, quantum {q}")
        np.testing.assert_array_equal(bucket_to_jax(tb.words),
                                      np.asarray(jb.words),
                                      err_msg=f"words, quantum {q}")
        assert tb.signature_key(turns, fuse) == jb.signature_key(turns,
                                                                 fuse)
    for slot in range(tb.cap):
        np.testing.assert_array_equal(tb.read_board(slot, hb, wb),
                                      jb.read_board(slot, hb, wb))


def test_pause_freezes_board_and_resume_continues(fleet):
    seed = _soup(64, 64, seed=4)
    fleet.create_run(64, 64, board=seed, run_id="pz")
    rv = fleet.resolve_run("pz")
    _wait(lambda: rv.stats()["turn"] >= 4, what="run stepping")
    rv.cf_put(FLAG_PAUSE)
    _wait(lambda: not rv.stats()["running"], what="pause to land")
    _wait(lambda: rv.describe_run()["paused"], what="pause flag serviced")
    board1, turn1 = rv.get_world()
    time.sleep(0.2)
    board2, turn2 = rv.get_world()
    assert turn1 == turn2
    np.testing.assert_array_equal(board1, board2)
    np.testing.assert_array_equal((board1 != 0).astype(np.uint8),
                                  _replay(seed, turn1))
    rv.cf_put(FLAG_PAUSE)  # toggle: resume
    _wait(lambda: rv.stats()["turn"] > turn1, what="resume to step")


# --------------------------------------------------- per-run checkpoints


def test_per_run_checkpoint_dirs_and_inspect(fleet, tmp_path):
    """Fleet runs checkpoint into contained run-<id>/ subdirectories;
    ckpt_inspect tabulates them with a RUN column."""
    from gol_tpu_torch.ckpt import manifest as mf
    from tools import ckpt_inspect

    seed = _soup(64, 64, seed=11)
    fleet.create_run(64, 64, board=seed, run_id="ck1", target_turn=4)
    rv = _park(fleet, "ck1")
    path, turn = rv.checkpoint_now(directory=str(tmp_path))
    assert turn == 4
    rundir = tmp_path / "run-ck1"
    assert rundir.is_dir() and path.startswith(str(rundir))
    latest = mf.latest_checkpoint(str(rundir))
    assert latest is not None and latest[0] == 4
    m = mf.verify_manifest(latest[1])
    assert m["board"] == {"h": 64, "w": 64}
    assert m["alive"] == int(_replay(seed, 4).sum())

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ckpt_inspect.main(["list", str(tmp_path)])
    assert rc == 0
    rows = buf.getvalue().splitlines()
    assert rows[0].split()[0] == "RUN"
    assert any(line.split()[0] == "ck1" for line in rows[1:])


def test_cadence_checkpoints_go_through_the_writer_pool(monkeypatch,
                                                        tmp_path):
    """A run's ckpt_every cadence writes through the shared pool into its
    run-<id> directory, each manifest the replay's board at its turn."""
    from gol_tpu_torch.ckpt import manifest as mf
    from gol_tpu_torch.ckpt import reshard

    monkeypatch.setenv("GOL_CKPT", str(tmp_path))
    eng = _small()
    try:
        seed = _soup(64, 64, seed=13)
        eng.create_run(64, 64, board=seed, run_id="cad", ckpt_every=4,
                       target_turn=12)
        _park(eng, "cad")
        assert eng._ckpt_pool is not None
        assert eng._ckpt_pool.flush(timeout=30)
        assert obs_cat.CKPT_POOL_WRITERS.value >= 1
        listed = list(mf.list_checkpoints(str(tmp_path / "run-cad")))
        turns = sorted(t for t, _, _ in listed)
        assert turns and set(turns) <= {4, 8, 12}
        for t, man, _ in listed:
            can = reshard.load_canonical(
                mf.payload_path(man, mf.verify_manifest(man)))
            np.testing.assert_array_equal(reshard.board01_of(can),
                                          _replay(seed, t))
        assert eng.checkpoint_fleet() == 1
    finally:
        eng.kill_prog()


def test_popcount_poison_quarantines_and_auto_restores(monkeypatch,
                                                       tmp_path):
    """An implausible slot popcount (the chaos poison) quarantines the
    run: evicted without readback, audited, then re-seeded from its
    newest checkpoint and placed again; a driven target still lands."""
    monkeypatch.setenv("GOL_CKPT", str(tmp_path))
    monkeypatch.setenv("GOL_QUARANTINE_BACKOFF", "0.05")
    eng = _small()
    try:
        seed = _soup(64, 64, seed=17)
        eng.create_run(64, 64, board=seed, run_id="qz", target_turn=4)
        rv = _park(eng, "qz")
        rv.checkpoint_now()
        q0 = obs_cat.RUNS_QUARANTINED.labels(reason="popcount").value
        monkeypatch.setenv("GOL_CHAOS", "poison=qz@6")
        assert chaos.injector() is not None
        got, turn = rv.server_distributor(JParams(turns=10), None)
        assert obs_cat.RUNS_QUARANTINED.labels(reason="popcount").value \
            == q0 + 1
        assert rv.describe_run()["quarantine_reason"] == "popcount"
        assert any(r.get("kind") == "quarantine" and r.get("run_id") ==
                   "qz" for r in obs_audit.recent(0, 512))
        # Restored from the turn-4 checkpoint, then driven on to 14.
        assert turn == 14
        np.testing.assert_array_equal((got != 0).astype(np.uint8),
                                      _replay(seed, 14))
    finally:
        monkeypatch.delenv("GOL_CHAOS", raising=False)
        eng.kill_prog()


# ----------------------------------------------------------- obs/healthz


def test_healthz_runs_summary_tracks_admissions():
    doc0 = obs_cat.runs_doc()
    assert set(doc0) >= {"resident", "admitted_total", "rejected_total"}
    eng = _small()
    try:
        eng.create_run(64, 64, run_id="hz")
        with pytest.raises(RuntimeError):
            eng.create_run(48, 48)
        doc = obs_cat.runs_doc()
        assert doc["admitted_total"] == doc0["admitted_total"] + 1
        assert doc["rejected_total"] == doc0["rejected_total"] + 1
        assert devstats.healthz_fields()["compile_count"] == 0
    finally:
        eng.kill_prog()


def test_fleet_health_doc_tracks_staleness_and_worst_runs(fleet):
    fleet.create_run(64, 64, run_id="hdoc")
    _wait(lambda: [r["run_id"] for r in
                   (obs_slo.fleet_health() or {}).get("worst_runs", [])]
          == ["hdoc"], what="fleet health doc to flush this run")
    doc = obs_slo.fleet_health()
    assert doc["resident_active"] == 1
    assert doc["queue_depth"] == 0
    assert set(doc["staleness_ms"]) == set(obs_cat.SLO_QUANTILES)
    assert [r["run_id"] for r in doc["worst_runs"]] == ["hdoc"]
    assert doc["worst_runs"][0]["staleness_ms"] >= 0
    assert obs_cat.FLEET_STALENESS_MS.labels(q="p99").value >= 0


def test_fleet_needs_cuda_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device: FleetEngine() runs")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FleetEngine()


# ------------------------------------------------- the legacy drive


def _dense(world, turns):
    """The dense engines' board for a legacy drive: the port's and
    `gol_tpu`'s, which must agree."""
    p = Params(threads=1, image_width=world.shape[1],
               image_height=world.shape[0], turns=turns)
    want, turn = Engine(device="cpu").server_distributor(p, world)
    jwant, jturn = JEngine().server_distributor(p, world)
    np.testing.assert_array_equal(want, jwant)
    assert turn == jturn == turns
    return want


class _SlowSync:
    """A bucket's popcount tensor whose host copy (the fleet loop's sync,
    taken outside the scheduling lock) takes `delay` seconds longer."""

    def __init__(self, alive, delay):
        self._alive, self._delay = alive, delay

    def cpu(self):
        time.sleep(self._delay)
        return self._alive.cpu()


def _slow_dispatch(monkeypatch, delay):
    orig = Bucket.dispatch

    def dispatch(self, turns, fuse=1):
        return _SlowSync(orig(self, turns, fuse=fuse), delay)

    monkeypatch.setattr(Bucket, "dispatch", dispatch)


def test_legacy_drive_counts_only_turns_from_its_seed(monkeypatch):
    """The reference's race (ROADMAP C), made deterministic: run0
    free-runs with a 0.5 s sync, then a drive of 6 turns reseeds it while
    a quantum is in flight. `gol_tpu` can credit that quantum against the
    new target and return turn 0 or a board of the old stepping; the
    port must return turn 6 and the dense engine's board (24 x 24, seed
    3, quantum 2, bucket 64)."""
    _slow_dispatch(monkeypatch, 0.5)
    eng = _small()
    try:
        world = _soup(24, 24, seed=3) * np.uint8(255)
        h = eng._legacy_handle(world, 0)
        _wait(lambda: h.turn > 0, what="run0 to free-run")
        time.sleep(1.0)
        got, turn = eng._drive(h, world, 0, 6)
        assert turn == 6
        np.testing.assert_array_equal(got, _dense(world, 6))
        assert eng.alive_count() == (int((got != 0).sum()), 6)
    finally:
        eng.kill_prog()


def test_legacy_drive_loops_beside_a_busy_fleet(monkeypatch):
    """50 legacy drives in a row, each to its target turn and the
    dense board, while runs are created and destroyed in another bucket
    and every sync is slowed a little (widening the window the race
    needs)."""
    _slow_dispatch(monkeypatch, 0.005)
    eng = _small()
    stop = threading.Event()
    errors = []

    def churn():
        i = 0
        try:
            while not stop.is_set():
                rid = f"busy{i % 3}"
                eng.create_run(64, 64, run_id=rid, wait=False)
                time.sleep(0.01)
                eng.destroy_run(rid)
                i += 1
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    try:
        for i in range(50):
            world = _soup(24, 24, seed=1000 + i) * np.uint8(255)
            p = Params(threads=1, image_width=24, image_height=24,
                       turns=6)
            got, turn = eng.server_distributor(p, world)
            assert turn == 6, f"drive {i} returned turn {turn}"
            want = (run_turns_np((world != 0).astype(np.uint8), 6)
                    * np.uint8(255))
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"drive {i}")
    finally:
        stop.set()
        t.join(timeout=10)
        eng.kill_prog()
    assert not t.is_alive()
    assert not errors, errors


# ------------------------------------------------- wire interop (legacy)


@pytest.fixture
def fleet_server():
    srv = EngineServer(port=0, host="127.0.0.1", engine=_small())
    t = srv.start_background()
    yield srv
    srv.engine.kill_prog()
    srv.shutdown()
    t.join(timeout=10)


def test_legacy_no_caps_peer_bit_identical_on_fleet_server(
        fleet_server, monkeypatch):
    """A pre-fleet, pre-codec client (no run_id, no caps) on a --fleet
    server gets the same raw-u8 world the dense engine produces —
    24×24, word-unaligned, so through a private bucket."""
    world = _soup(24, 24, seed=3) * np.uint8(255)
    p = Params(threads=1, image_width=24, image_height=24, turns=6)
    expect = _dense(world, 6)

    monkeypatch.setenv("GOL_WIRE_CAPS", "")  # client sends no caps
    boot = RemoteEngine(f"127.0.0.1:{fleet_server.port}")
    got, turn = boot.server_distributor(p, world)
    assert turn == 6
    np.testing.assert_array_equal(got, expect)

    s = socket.create_connection(("127.0.0.1", fleet_server.port),
                                 timeout=10)
    try:
        hdr = json.dumps({"method": "GetWorld"}).encode()
        s.sendall(struct.pack(">I", len(hdr)) + hdr)
        resp, raw = wire.recv_msg(s)
        assert resp["ok"] is True
        assert resp["world"].get("codec", "u8") == "u8"
        np.testing.assert_array_equal(raw, expect)
    finally:
        s.close()


def test_wire_create_list_attach_and_run_scoped_fetch(fleet_server):
    cli = RemoteEngine(f"127.0.0.1:{fleet_server.port}")
    seed = _soup(64, 64, seed=21)
    rec = cli.create_run(64, 64, board=seed * np.uint8(255),
                         run_id="w1", target_turn=10)
    assert rec["run_id"] == "w1"
    runs, summary = cli.list_runs()
    assert summary["engine"] == "FleetEngine"
    assert any(r["run_id"] == "w1" for r in runs)

    rv = cli.attach_run("w1")
    _wait(lambda: rv.stats()["state"] == "parked", what="w1 to park")
    got, turn = rv.get_world()
    assert turn == 10
    np.testing.assert_array_equal((got != 0).astype(np.uint8),
                                  _replay(seed, 10))
    assert rv.stats()["run_id"] == "w1"
    assert rv.alive_count() == (int(_replay(seed, 10).sum()), 10)

    with pytest.raises(RuntimeError, match="unknown run"):
        cli.attach_run("nope")


def test_wire_destroy_run_roundtrip_and_errors(fleet_server):
    cli = RemoteEngine(f"127.0.0.1:{fleet_server.port}")
    cli.create_run(64, 64, board=_soup(64, 64, seed=31) * np.uint8(255),
                   run_id="d1", target_turn=4)
    final = cli.destroy_run("d1")
    assert final["run_id"] == "d1" and final["state"] == "removed"
    runs, _ = cli.list_runs()
    assert not any(r["run_id"] == "d1" for r in runs)
    with pytest.raises(RuntimeError, match="unknown run"):
        cli.destroy_run("d1")
    with pytest.raises(RuntimeError, match="denied"):
        cli.destroy_run("run0")


def test_run_scoped_view_and_set_rule_over_the_wire(fleet_server):
    """GetView by run_id records the viewer; SetRule re-homes the run;
    DestroyRun drops every viewer basis of the run."""
    cli = RemoteEngine(f"127.0.0.1:{fleet_server.port}")
    cli.create_run(64, 64, board=_soup(64, 64, seed=5) * np.uint8(255),
                   run_id="v1", target_turn=4)
    rv = cli.attach_run("v1")
    _wait(lambda: rv.stats()["state"] == "parked", what="v1 to park")
    view, turn, (fy, fx) = rv.get_view(16 * 16)
    assert view.shape == (16, 16) and (fy, fx) == (4, 4) and turn == 4
    assert cli.list_runs()[0][-1]["viewers"] == 1
    assert any(k.startswith("v1|") for k in fleet_server._view_cache)
    rec = cli.set_rule("v1", "B36/S23")
    assert rec["rule"] == "B36/S23" and rec["bucket"] == "64x64"
    cli.destroy_run("v1")
    assert not any(k.startswith("v1|") for k in fleet_server._view_cache)


def test_single_run_server_answers_fleet_rpcs_with_fleet_unsupported():
    """CreateRun and DestroyRun name --fleet; SetRule finds no set_rule,
    as on `gol_tpu`'s server; ListRuns and AttachRun answer for run0."""
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=Engine(device="cpu"))
    t = srv.start_background()
    try:
        cli = RemoteEngine(f"127.0.0.1:{srv.port}")
        for call in (lambda: cli.create_run(64, 64),
                     lambda: cli.destroy_run("x")):
            with pytest.raises(RuntimeError, match="--fleet"):
                call()
        with pytest.raises(RuntimeError, match="set_rule"):
            cli.set_rule("x", "B3/S23")
        runs, summary = cli.list_runs()
        assert [r["run_id"] for r in runs] == ["run0"]
        assert summary == {"resident": 1, "queued": 0, "engine": "Engine"}
        assert cli.attach_run("run0").run_id == "run0"
    finally:
        srv.shutdown()
        t.join(timeout=10)


def test_fleet_rpcs_are_ported_and_fleet_excludes_sparse():
    import inspect

    import gol_tpu_torch.server as server_mod

    # No method waits for a later slice: each has its dispatch branch.
    assert not hasattr(server_mod, "NOT_YET_PORTED")
    dispatch = inspect.getsource(EngineServer._dispatch_inner)
    for method in ("CreateRun", "ListRuns", "AttachRun", "DestroyRun",
                   "SetRule", "AdoptRun", "Rescale", "ReceiveRun",
                   "CommitRun"):
        assert f'method == "{method}"' in dispatch, method
    with pytest.raises(SystemExit):
        server_main(["--fleet", "--sparse", "1024", "--device", "cpu"])
