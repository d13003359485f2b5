"""The port's mesh-placed fleet (`FleetEngine(devices=["cpu"] * 4)`), the
counterpart of `tests/test_fleet_mesh.py`, held against the one-device
port fleet, the numpy/`gol_tpu` torus replay and `gol_tpu`'s fleet on
the forced host devices (`tests/conftest.py`), fed the same seeds:

  * batch placement: every run parks bit-identical at each target in all
    three fleets, with equal counts; a port `Bucket` and a `gol_tpu`
    `Bucket` on 4-device meshes hold equal words and return equal
    popcounts after every quantum, batch and spatial, grown and fused;
  * admission scales with the placement devices; admitting into existing
    sharded capacity adds no step signature;
  * a quarantined run of a batch bucket restores bit-identical;
  * the placement policy and GOL_FLEET_MIN_SLOTS_PER_DEV; the spatial
    fallback parks bit-identical, exact targets included (its trim runs
    the sharded path);
  * SetRule re-homes a run between sharded buckets with its board;
  * the shared checkpoint-writer pool keeps newest-wins and drains, and a
    mesh fleet's cadence checkpoints equal the replay;
  * per-device residency (`gol_fleet_device_resident_runs`, `runs_doc`);
  * a migration readback and import between mesh fleets;
  * K9's counted box: each slot's count equals the popcount of its box.

Tolerance: none."""

from __future__ import annotations

import time

import jax
import numpy as np
import pytest
import torch

from gol_tpu.fleet import FleetEngine as JFleet
from gol_tpu.fleet.buckets import Bucket as JBucket
from gol_tpu.fleet.handles import RunHandle as JHandle
from gol_tpu.models import CONWAY as J_CONWAY
from gol_tpu.models import parse_rule as jparse_rule
from gol_tpu.ops.bitpack import (
    pack_np,
    packed_run_turns,
    unpack_np,
    words_bytes_np,
)
from gol_tpu.parallel.mesh import make_batch_mesh as jbatch_mesh
from gol_tpu.parallel.mesh import make_mesh as jmake_mesh

from gol_tpu_torch import chaos
from gol_tpu_torch.fleet import AdmissionController, FleetEngine, run_cost
from gol_tpu_torch.fleet.buckets import Bucket, bucket_to_jax, choose_placement
from gol_tpu_torch.fleet.handles import RunHandle
from gol_tpu_torch.models.lifelike import CONWAY
from gol_tpu_torch.obs import catalog as obs_cat
from gol_tpu_torch.obs import devstats
from gol_tpu_torch.ops import cuda_stencil as cs
from gol_tpu_torch.ops.bitpack import words_from_numpy
from gol_tpu_torch.params import Params
from gol_tpu_torch.parallel.mesh import make_batch_mesh, make_mesh

torch.set_num_threads(2)

CPU4 = [torch.device("cpu")] * 4
JDEVS = jax.devices()


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("GOL_FLEET_BUCKETS", "GOL_FLEET_CHUNK", "GOL_FLEET_SLOT_BASE",
              "GOL_FLEET_MEM_BUDGET", "GOL_FLEET_MESH_DEVICES",
              "GOL_FLEET_MIN_SLOTS_PER_DEV", "GOL_FUSE_K", "GOL_CKPT",
              "GOL_CHAOS", "GOL_JOURNAL", "GOL_RUN_REPORT"):
        monkeypatch.delenv(k, raising=False)


def _soup(h, w, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def _replay(seed01, turns, rule=J_CONWAY):
    """`gol_tpu`'s single-board packed torus replay — the parity oracle."""
    h, w = seed01.shape
    words = packed_run_turns(pack_np(seed01).view("<u4"), turns, rule)
    return unpack_np(words_bytes_np(np.asarray(words)), h, w)


def _wait(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _mk(devices, cls=FleetEngine, **kw):
    kw.setdefault("bucket_sizes", (64,))
    kw.setdefault("chunk_turns", 4)
    kw.setdefault("slot_base", 8)
    return cls(devices=devices, **kw)


def _park(eng, run_id):
    rv = eng.resolve_run(run_id)
    _wait(lambda: rv.describe_run()["state"] == "parked",
          what=f"run {run_id} to park")
    return rv


def _teardown(eng, *run_ids):
    for rid in run_ids:
        try:
            eng.destroy_run(rid)
        except Exception:
            pass
    eng.kill_prog()


# ------------------------------------------------- batch-sharded parity


def test_batch_parity_vs_one_device_fleet_and_gol_tpu():
    """Every run of a 4-way batch bucket parks at each target (after one,
    two and three quanta; the 18 runs grow the bucket twice) bit-identical
    and with the same count as in a one-device port fleet, in `gol_tpu`'s
    4-device fleet, and as the board's own torus."""
    seeds = [_soup(64, 64, seed=100 + i) for i in range(6)]
    targets = (4, 8, 12)
    got = {}
    fleets = (("one", FleetEngine, CPU4[:1]), ("four", FleetEngine, CPU4),
              ("gol_tpu", JFleet, JDEVS[:4]))
    for tag, cls, devs in fleets:
        eng = _mk(devs, cls=cls)
        ids = [f"r{i}t{t}" for i in range(len(seeds)) for t in targets]
        try:
            assert eng.stats()["fleet"]["mesh"]["devices"] == len(devs)
            for i, seed in enumerate(seeds):
                for t in targets:
                    eng.create_run(64, 64, board=seed.copy(),
                                   run_id=f"r{i}t{t}", target_turn=t)
            for rid in ids:
                rv = _park(eng, rid)
                board, turn = rv.get_world()
                got[(tag, rid)] = ((board != 0).astype(np.uint8), turn,
                                   rv.describe_run()["alive"])
            rows = eng.stats()["fleet"]["buckets"]
            assert rows[0]["placement"] == ("single" if len(devs) == 1
                                            else "batch")
            assert rows[0]["devices"] == len(devs)
            assert rows[0]["cap"] == 32
        finally:
            _teardown(eng, *ids)
    for i, seed in enumerate(seeds):
        for t in targets:
            want = _replay(seed, t)
            rid = f"r{i}t{t}"
            for tag, _, _ in fleets:
                board, turn, alive = got[(tag, rid)]
                assert turn == t
                np.testing.assert_array_equal(board, want,
                                              err_msg=f"{tag} {rid}")
                assert alive == int(want.sum()), (tag, rid)


def test_mesh_stamp_equals_gol_tpu():
    eng, jeng = _mk(CPU4), _mk(JDEVS[:4], cls=JFleet)
    try:
        assert eng.stats()["fleet"]["mesh"] == \
            jeng.stats()["fleet"]["mesh"]
        assert eng.stats()["devices"] == jeng.stats()["devices"] == 4
        assert obs_cat.FLEET_MESH_DEVICES.value == 4
    finally:
        eng.kill_prog()
        jeng.kill_prog()


@pytest.mark.parametrize("placement,n,hb,slot_base", [
    ("batch", 4, 64, 2), ("batch", 8, 64, 8), ("spatial", 4, 64, 2),
    ("spatial", 2, 96, 2)])
def test_bucket_words_and_counts_equal_gol_tpu_every_quantum(
        placement, n, hb, slot_base):
    """A port Bucket on a mesh of n CPU devices and a `gol_tpu` Bucket on
    n host devices, fed the same boards past the initial capacity, hold
    the same words and return the same popcounts after every quantum
    (odd, even and fused quanta: per-turn and deep-halo spatial steps)."""
    if placement == "batch":
        tmesh = make_batch_mesh([torch.device("cpu")] * n)
        jmesh = jbatch_mesh(devices=JDEVS[:n])
    else:
        tmesh = make_mesh(n, devices=[torch.device("cpu")] * n)
        jmesh = jmake_mesh(n, devices=JDEVS[:n])
    tb = Bucket(hb, 64, CONWAY, slot_base=slot_base, placement=placement,
                mesh=tmesh)
    jb = JBucket(hb, 64, J_CONWAY, slot_base=slot_base, mesh=jmesh,
                 placement=placement)
    for i in range(tb.cap + 1):
        seed = _soup(hb, 64, seed=900 + i)
        assert tb.place(RunHandle(f"r{i}", CONWAY, hb, 64), seed) == \
            jb.place(JHandle(f"r{i}", J_CONWAY, hb, 64), seed)
    assert tb.cap == jb.cap and tb.devices == jb.devices == n
    for q, (turns, fuse) in enumerate(((2, 1), (3, 1), (8, 2), (5, 1))):
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
        np.testing.assert_array_equal(tb.read_board(slot, hb, 64),
                                      jb.read_board(slot, hb, 64))


def test_one_device_mesh_collapses_to_single():
    b = Bucket(64, 64, CONWAY, slot_base=2, placement="batch",
               mesh=make_batch_mesh(CPU4[:1]))
    assert (b.placement, b.devices, len(b.parts)) == ("single", 1, 1)


# -------------------------------------------- per-device admission math


def test_admission_budget_scales_with_placement_devices(monkeypatch):
    base = AdmissionController(devices=1).budget_bytes()
    assert AdmissionController(devices=4).budget_bytes() == 4 * base
    # Explicit budgets are absolute, whatever the placement width.
    assert AdmissionController(budget_bytes=12345,
                               devices=4).budget_bytes() == 12345
    monkeypatch.setenv("GOL_FLEET_MEM_BUDGET", "54321")
    assert AdmissionController(devices=8).budget_bytes() == 54321


def test_engine_admission_is_placement_aware():
    eng = _mk(CPU4)
    try:
        s = eng.admission.summary()
        assert s["devices"] == 4
        assert s["budget_bytes"] == (
            AdmissionController(devices=4).budget_bytes())
        eng.create_run(64, 64, run_id="acct")
        assert eng.admission.summary()["committed_bytes"] == (
            run_cost(64, 64 // 32))
    finally:
        _teardown(eng, "acct")


# ------------------------------- admit-into-capacity adds no signature


def test_admit_into_sharded_capacity_adds_no_signature():
    eng = _mk(CPU4)
    try:
        eng.create_run(64, 64, board=_soup(64, 64, seed=1),
                       run_id="w0", target_turn=8)
        _park(eng, "w0")
        sig0 = devstats.signature_count()
        for i in range(5):
            eng.create_run(64, 64, board=_soup(64, 64, seed=2 + i),
                           run_id=f"c{i}", target_turn=8)
        for i in range(5):
            _park(eng, f"c{i}")
        assert devstats.signature_count() == sig0
    finally:
        _teardown(eng, "w0", *[f"c{i}" for i in range(5)])


# --------------------------------------- quarantine of a sharded slot


@pytest.mark.timeout(150)
def test_quarantine_restores_sharded_slot_bit_identical(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_QUARANTINE_BACKOFF", "0.05")
    board = _soup(64, 64, seed=7)
    eng = _mk(CPU4)
    try:
        assert eng.stats()["fleet"]["buckets"] == []
        eng.create_run(64, 64, board=board.copy(), run_id="clean",
                       ckpt_every=8, target_turn=40)
        hc = eng._runs["clean"]
        assert hc.done.wait(60)
        clean_board, clean_turn = eng._run_board(hc)
        assert eng.stats()["fleet"]["buckets"][0]["placement"] == "batch"

        q0 = obs_cat.RUNS_QUARANTINED.labels(reason="popcount").value
        monkeypatch.setenv(chaos.ENV, "poison=victim@20,seed=1")
        eng.create_run(64, 64, board=board.copy(), run_id="victim",
                       ckpt_every=8, target_turn=40)
        hv = eng._runs["victim"]
        assert hv.done.wait(90), f"victim stuck in state {hv.state}"
        monkeypatch.delenv(chaos.ENV)

        vb, vt = eng._run_board(hv)
        assert vt == clean_turn == 40
        np.testing.assert_array_equal(vb, clean_board)
        np.testing.assert_array_equal(vb, _replay(board, 40))
        assert (obs_cat.RUNS_QUARANTINED.labels(
            reason="popcount").value - q0) == 1
        assert eng.runs_summary()["quarantined"] == 0
    finally:
        _teardown(eng, "clean", "victim")


# --------------------------------------------- spatial fallback policy


def test_choose_placement_policy():
    assert choose_placement(64, 64, 8, 1) == "single"
    assert choose_placement(64, 64, 8, 4) == "batch"
    assert choose_placement(64, 64, 2, 4) == "spatial"
    assert choose_placement(50, 64, 2, 4) == "batch"


def test_min_slots_env_flips_policy(monkeypatch):
    monkeypatch.setenv("GOL_FLEET_MIN_SLOTS_PER_DEV", "4")
    assert choose_placement(64, 64, 8, 4) == "spatial"
    monkeypatch.setenv("GOL_FLEET_MIN_SLOTS_PER_DEV", "1")
    assert choose_placement(64, 64, 8, 4) == "batch"


@pytest.mark.parametrize("target", [12, 13])
def test_spatial_fallback_parity_and_exact_target(target):
    """A big-board class below batch occupancy builds a SPATIAL bucket
    and parks bit-identical to the torus oracle and to `gol_tpu`'s
    spatial fleet; 13 turns trims the last one through the sharded
    path."""
    seed = _soup(64, 64, seed=31)
    out = {}
    for tag, cls, devs in (("port", FleetEngine, CPU4),
                           ("gol_tpu", JFleet, JDEVS[:4])):
        eng = _mk(devs, cls=cls, slot_base=2)
        try:
            eng.create_run(64, 64, board=seed, run_id="sp",
                           target_turn=target)
            rv = _park(eng, "sp")
            rows = eng.stats()["fleet"]["buckets"]
            assert rows[0]["placement"] == "spatial"
            assert rows[0]["devices"] == 4
            board, turn = rv.get_world()
            out[tag] = ((board != 0).astype(np.uint8), turn,
                        rv.describe_run()["alive"])
        finally:
            _teardown(eng, "sp")
    want = _replay(seed, target)
    for tag in out:
        board, turn, alive = out[tag]
        assert turn == target
        np.testing.assert_array_equal(board, want, err_msg=tag)
        assert alive == int(want.sum())


# --------------------------------------------------- SetRule migration


@pytest.mark.parametrize("slot_base", [8, 2])
def test_set_rule_rehomes_between_sharded_buckets(slot_base):
    """SetRule moves a run from a batch (or spatial) bucket to the new
    rule's with its board; driving on evolves under the new rule."""
    highlife = jparse_rule("B36/S23")
    eng = _mk(CPU4, slot_base=slot_base)
    try:
        seed = _soup(64, 64, seed=55)
        eng.create_run(64, 64, board=seed, run_id="mig", target_turn=8)
        rv = _park(eng, "mig")
        mid, turn = rv.get_world()
        assert turn == 8
        mid01 = (mid != 0).astype(np.uint8)
        rec = eng.set_rule("mig", "B36/S23")
        assert rec["rule"] == highlife.rulestring
        got, turn = rv.get_world()
        assert turn == 8
        np.testing.assert_array_equal((got != 0).astype(np.uint8), mid01)
        px, turn = rv.server_distributor(
            Params(threads=1, image_width=64, image_height=64, turns=8),
            None)
        assert turn == 16
        np.testing.assert_array_equal((px != 0).astype(np.uint8),
                                      _replay(mid01, 8, highlife))
        placements = {r["placement"]
                      for r in eng.stats()["fleet"]["buckets"]}
        assert placements == {"batch" if slot_base == 8 else "spatial"}
    finally:
        _teardown(eng, "mig")


# --------------------------------------------- checkpoint writer pool


def test_ckpt_pool_newest_wins_and_drains(monkeypatch, tmp_path):
    from gol_tpu_torch.ckpt import CheckpointWriterPool, Snapshot
    from gol_tpu_torch.ckpt import manifest as mf

    pool = CheckpointWriterPool(workers=1)
    # Hold the workers back so the replacement is deterministic.
    monkeypatch.setattr(CheckpointWriterPool, "_ensure_threads",
                        lambda self: None)
    d0 = obs_cat.CKPT_WRITES.labels(status="dropped").value

    def snap(turn):
        cells = np.zeros((8, 1), dtype="<u4")
        cells[0, 0] = turn  # distinguishable payloads
        return Snapshot(cells, "packed", turn, (8, 32), "B3/S23")

    assert pool.submit(str(tmp_path / "run-a"), "a", snap(4)) is True
    assert pool.submit(str(tmp_path / "run-a"), "a", snap(8)) is False
    assert pool.submit(str(tmp_path / "run-b"), "b", snap(4)) is True
    assert pool.depth() == 2  # newest-wins collapsed run a's backlog
    assert (obs_cat.CKPT_WRITES.labels(status="dropped").value
            - d0) == 1

    monkeypatch.undo()
    pool._ensure_threads()
    assert pool.close(timeout=30.0)
    latest = mf.latest_checkpoint(str(tmp_path / "run-a"))
    assert latest is not None and latest[0] == 8
    latest_b = mf.latest_checkpoint(str(tmp_path / "run-b"))
    assert latest_b is not None and latest_b[0] == 4
    with pytest.raises(RuntimeError):
        pool.submit(str(tmp_path / "run-a"), "a", snap(12))


@pytest.mark.parametrize("slot_base", [8, 2])
def test_mesh_fleet_cadence_uses_shared_pool(monkeypatch, tmp_path,
                                             slot_base):
    """A batch (or spatial) fleet's cadence checkpoints ride the one
    shared pool and each holds the replay's board at its turn."""
    from gol_tpu_torch.ckpt import manifest as mf
    from gol_tpu_torch.ckpt import reshard

    monkeypatch.setenv("GOL_CKPT", str(tmp_path))
    eng = _mk(CPU4, slot_base=slot_base)
    seeds = [_soup(64, 64, seed=80 + i) for i in range(3)]
    try:
        for i, seed in enumerate(seeds):
            eng.create_run(64, 64, board=seed, run_id=f"p{i}",
                           ckpt_every=4, target_turn=8)
        for i in range(3):
            _park(eng, f"p{i}")
        assert eng._ckpt_pool is not None
        assert eng._ckpt_pool.flush(timeout=30.0)
        for i, seed in enumerate(seeds):
            listed = list(mf.list_checkpoints(str(tmp_path / f"run-p{i}")))
            assert listed and max(t for t, _, _ in listed) >= 4
            for t, man, _ in listed:
                can = reshard.load_canonical(
                    mf.payload_path(man, mf.verify_manifest(man)))
                np.testing.assert_array_equal(reshard.board01_of(can),
                                              _replay(seed, t))
    finally:
        _teardown(eng, "p0", "p1", "p2")


# ------------------------------------------------ per-device telemetry


def test_per_device_resident_attribution():
    eng = _mk(CPU4)
    try:
        for i in range(4):
            eng.create_run(64, 64, board=_soup(64, 64, seed=60 + i),
                           run_id=f"d{i}")
        with eng._fleet_lock:
            counts = eng._device_resident_locked()
        assert len(counts) == 4 and sum(counts) == 4
        # cap 8 over 4 devices: two slots a block, filled from slot 0.
        assert counts == [2, 2, 0, 0]
        _wait(lambda: [obs_cat.FLEET_DEVICE_RESIDENT.labels(
            device=str(d)).value for d in range(4)] == [2, 2, 0, 0],
            what="per-device resident gauges to flush")
        doc = obs_cat.runs_doc()
        assert doc["mesh_devices"] == 4
        assert sum(doc["resident_by_device"].values()) == 4
    finally:
        _teardown(eng, "d0", "d1", "d2", "d3")


def test_spatial_residents_count_on_every_device():
    eng = _mk(CPU4, slot_base=2)
    try:
        eng.create_run(64, 64, board=_soup(64, 64, seed=3), run_id="s0")
        with eng._fleet_lock:
            assert eng._device_resident_locked() == [1, 1, 1, 1]
    finally:
        _teardown(eng, "s0")


# ------------------------------------------- migration between meshes


@pytest.mark.parametrize("slot_base", [8, 2])
def test_migrate_readback_and_import_between_mesh_fleets(slot_base):
    """migrate_quiesce parks a run of a batch (or spatial) bucket with its
    slot's board at its turn; importing it into another mesh fleet and
    committing continues it to its target, bit-identical."""
    seed = _soup(64, 64, seed=91)
    src, dst = _mk(CPU4, slot_base=slot_base), _mk(CPU4,
                                                    slot_base=slot_base)
    try:
        src.create_run(64, 64, board=seed, run_id="mv")
        rv = src.resolve_run("mv")
        _wait(lambda: rv.describe_run()["turn"] >= 8, what="mv to step")
        rec = src.migrate_quiesce("mv")
        np.testing.assert_array_equal(rec["board"],
                                      _replay(seed, rec["turn"]))
        dst.import_run("mv", rec["board"], rec["turn"],
                       target_turn=rec["turn"] + 9)
        dst.activate_imported("mv")
        dv = _park(dst, "mv")
        board, turn = dv.get_world()
        assert turn == rec["turn"] + 9
        np.testing.assert_array_equal((board != 0).astype(np.uint8),
                                      _replay(seed, turn))
    finally:
        _teardown(src, "mv")
        _teardown(dst, "mv")


def test_mesh_devices_env_keeps_a_cpu_fleet_on_one_device(monkeypatch):
    monkeypatch.setenv("GOL_FLEET_MESH_DEVICES", "4")
    eng = FleetEngine(device="cpu", bucket_sizes=(64,))
    try:
        assert eng.stats()["devices"] == 1
        assert eng.stats()["fleet"]["mesh"] == {"devices": 1}
    finally:
        eng.kill_prog()


# ------------------------------------------------------ K9's counted box


@pytest.mark.parametrize("kind", ["resident", "tiled"])
@pytest.mark.parametrize("box", [(0, 40, 0, 3), (3, 35, 0, 3),
                                 (5, 6, 1, 2), (0, 0, 0, 3)])
def test_k9_box_counts_the_popcount_of_each_slots_box(kind, box):
    """The count of K9's plain version with `box` equals, slot by slot,
    the popcount of the box's rows and words of the stepped slot; the
    words are the unboxed call's."""
    rng = np.random.default_rng(7)
    host = rng.integers(0, 2 ** 32, size=(5, 40, 3), dtype=np.uint32)
    words = words_from_numpy(host)
    out, alive = cs.fleet_run_turns(words, 3, CONWAY, kind=kind, box=box)
    full, _ = cs.fleet_run_turns(words, 3, CONWAY, kind=kind)
    assert torch.equal(out, full)
    r0, r1, c0, c1 = box
    crop = bucket_to_jax(out)[:, r0:r1, c0:c1]
    want = [int(np.unpackbits(crop[s].view(np.uint8)).sum())
            for s in range(5)]
    assert alive.tolist() == want


def test_k9_box_outside_the_slot_raises():
    words = torch.zeros((2, 8, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match="box"):
        cs.fleet_run_turns(words, 1, CONWAY, box=(0, 9, 0, 2))
