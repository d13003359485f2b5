"""The port's checkpoint layer (`gol_tpu_torch/ckpt/`) against the JAX
package's (`gol_tpu/ckpt/`): the `gol-ckpt/1` format and its refusals
(copies of `tests/test_ckpt.py`, each manifest read by both packages),
manifests that agree field for field with the JAX engine's at every
checkpoint turn, checkpoints that restore in the other package and
continue bit-identical to the run that was never interrupted (manifest
and legacy `.npz`, for `packed`, `u8`, `gen3` and `gen8`), and the
geometry contract (an 8-device JAX checkpoint, a JAX sparse one).

The JAX engines run on one device (`jax.devices()[:1]`) unless a test
wants the 8-device mesh: a JAX checkpoint records its engine's device
count, and one device is the port's geometry. Boards are seeded numpy;
integer results compare exactly (tolerance 0)."""

import json
import os
import threading
import time

import jax
import numpy as np
import pytest

from gol_tpu import ckpt as jckpt
from gol_tpu import Params as JParams
from gol_tpu.ckpt import manifest as jmf
from gol_tpu.ckpt import reshard as jreshard
from gol_tpu.ckpt.writer import payload_arrays as jpayload_arrays
from gol_tpu.client import GeometryRefused as JGeometryRefused
from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.engine import Engine as JEngine
from gol_tpu.models import parse_rule as jparse_rule
from gol_tpu.ops.reference import run_turns_np
from gol_tpu_torch import Params
from gol_tpu_torch import ckpt
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt import reshard
from gol_tpu_torch.ckpt.writer import payload_arrays
from gol_tpu_torch.client import GeometryRefused, RemoteEngine
from gol_tpu_torch.engine import FLAG_QUIT, Engine
from gol_tpu_torch.models import parse_rule
from gol_tpu_torch.models.generations import to_pixels_gen
from gol_tpu_torch.server import EngineServer

MANIFEST_READERS = {"torch": mf, "jax": jmf}
INTEGRITY_ERRORS = {"torch": ckpt.CheckpointIntegrityError,
                    "jax": jckpt.CheckpointIntegrityError}

# (height, width, rule, the repr both engines choose)
CASES = {
    "u8": (16, 16, "B3/S23", "u8"),
    "packed": (64, 64, "B3/S23", "packed"),
    "packed-tiled": (64, 4096, "B3/S23", "packed"),
    "gen3": (64, 64, "/2/3", "gen3"),
    "gen8": (64, 64, "345/2/4", "gen8"),
}
# The manifest fields the two packages must agree on at a turn
# (payload_sha256 is left out: npz members carry a timestamp).
PARITY_FIELDS = ("turn", "rule", "repr", "board", "dtype", "shape",
                 "board_sha256", "alive", "trigger", "fuse", "mesh")


def random_pixels(h, w, seed=0, density=0.3):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) < density).astype(np.uint8)) * 255


def seed_world(case, seed=0):
    """The seed board of a CASES entry as PGM pixels: {0,255} for
    life-like rules, the rule's gray levels for Generations."""
    h, w, rule, _ = CASES[case]
    if "/" in rule and rule.count("/") == 2:
        rng = np.random.default_rng(seed)
        states = parse_rule(rule).states
        state = rng.choice(np.arange(states, dtype=np.uint8), size=(h, w),
                           p=[0.6, 0.3] + [0.1 / (states - 2)]
                           * (states - 2))
        return to_pixels_gen(state, parse_rule(rule))
    return random_pixels(h, w, seed)


def engines(rule, devices=1):
    """{"jax": JAX engine on `devices` CPU devices, "torch": port engine
    on the CPU}, both under `rule`."""
    return {"jax": JEngine(devices=jax.devices()[:devices],
                           rule=jparse_rule(rule)),
            "torch": Engine(device="cpu", rule=parse_rule(rule))}


def params(pkg, h, w, turns):
    cls = JParams if pkg == "jax" else Params
    return cls(image_width=w, image_height=h, turns=turns)


def write_one(tmp_path, turn=7, seed=1, keep_last=10, rule="B3/S23"):
    """One durable checkpoint from a host-side u8 snapshot, written by
    the port; returns the manifest path."""
    cells = (random_pixels(16, 16, seed=seed) // 255).astype(np.uint8)
    snap = ckpt.Snapshot(cells, "u8", turn, cells.shape, rule)
    w = ckpt.CheckpointWriter(str(tmp_path), run_id="test",
                              keep_last=keep_last)
    return w.write_sync(snap)


# ------------------------------------------------------------- manifest


@pytest.mark.parametrize("reader", sorted(MANIFEST_READERS))
def test_manifest_roundtrip_and_verify(tmp_path, reader):
    rmf = MANIFEST_READERS[reader]
    path = write_one(tmp_path, turn=42)
    m = rmf.read_manifest(path)
    assert m["schema"] == "gol-ckpt/1" == jmf.MANIFEST_SCHEMA
    assert (m["turn"], m["rule"], m["repr"]) == (42, "B3/S23", "u8")
    assert m["board"] == {"h": 16, "w": 16}
    assert set(m["writer"]) == {"pid", "torch", "numpy"}
    assert rmf.verify_manifest(path)["turn"] == 42
    with np.load(rmf.payload_path(path, m)) as z:
        assert int(z["turn"]) == 42
        assert str(z["rulestring"]) == "B3/S23"


@pytest.mark.parametrize("reader", sorted(MANIFEST_READERS))
@pytest.mark.parametrize("field", [
    "schema", "run_id", "turn", "rule", "repr", "payload",
    "payload_sha256", "payload_bytes", "board_sha256", "turn-as-str",
    "unknown-repr", "negative-turn", "board-dims"])
def test_manifest_rejects_missing_and_mistyped_fields(tmp_path, reader,
                                                      field):
    rmf = MANIFEST_READERS[reader]
    m = mf.read_manifest(write_one(tmp_path))
    bad = dict(m)
    if field == "turn-as-str":
        bad["turn"] = "42"
    elif field == "unknown-repr":
        bad["repr"] = "bf16"
    elif field == "negative-turn":
        bad["turn"] = -1
    elif field == "board-dims":
        bad["board"] = {"h": "16", "w": 16}
    else:
        del bad[field]
    p = str(tmp_path / "bad.json")
    with open(p, "w") as f:
        json.dump(bad, f)
    with pytest.raises(INTEGRITY_ERRORS[reader]):
        rmf.read_manifest(p)


@pytest.mark.parametrize("reader", sorted(MANIFEST_READERS))
@pytest.mark.parametrize("evil", ["../escape.npz", "/etc/passwd",
                                  "a/b.npz"])
def test_manifest_payload_traversal_rejected(tmp_path, reader, evil):
    """The payload field must be a bare basename: a manifest naming a
    path outside its own directory is hostile, not broken."""
    m = mf.read_manifest(write_one(tmp_path))
    p = str(tmp_path / "evil.json")
    with open(p, "w") as f:
        json.dump(dict(m, payload=evil), f)
    with pytest.raises(INTEGRITY_ERRORS[reader]):
        MANIFEST_READERS[reader].read_manifest(p)


@pytest.mark.parametrize("reader", sorted(MANIFEST_READERS))
@pytest.mark.parametrize("damage,match", [("flip", "SHA-256"),
                                          ("truncate", "bytes"),
                                          ("delete", "missing")])
def test_damaged_payload_refused(tmp_path, reader, damage, match):
    """A flipped byte, a truncation or a missing payload is refused by
    the verifier, and by a restore of either package."""
    path = write_one(tmp_path)
    payload = mf.payload_path(path, mf.read_manifest(path))
    raw = bytearray(open(payload, "rb").read())
    if damage == "delete":
        os.unlink(payload)
    else:
        if damage == "flip":
            raw[len(raw) // 2] ^= 0xFF
        else:
            raw = raw[:-8]
        with open(payload, "wb") as f:
            f.write(raw)
    with pytest.raises(INTEGRITY_ERRORS[reader], match=match):
        MANIFEST_READERS[reader].verify_manifest(path)
    eng = engines("B3/S23")[reader]
    with pytest.raises(INTEGRITY_ERRORS[reader], match=match):
        eng.restore_run(str(tmp_path))


@pytest.mark.parametrize("a,b", [
    (np.arange(16, dtype=np.uint8), np.arange(16, dtype=np.uint32)),
    (np.arange(16, dtype=np.uint32), np.arange(16, dtype=np.int32)),
    (np.arange(16, dtype=np.uint8).reshape(4, 4),
     np.arange(16, dtype=np.uint8).reshape(2, 8)),
], ids=["dtype-u8-u32", "dtype-u32-i32", "shape"])
def test_board_sha256_distinguishes_dtype_and_shape(a, b):
    assert mf.board_sha256({"x": a}) != mf.board_sha256({"x": b})
    assert mf.board_sha256({"x": a}) == jmf.board_sha256({"x": a.copy()})


@pytest.mark.parametrize("repr_,shape", [("packed", (8, 4)),
                                         ("gen3", (2, 8, 4))])
def test_int32_carrier_goes_out_as_uint32(repr_, shape):
    """The port's int32 words leave as the JAX package's uint32 by
    reinterpretation: same members, dtype, bytes and board hash."""
    rng = np.random.default_rng(5)
    words = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
        np.uint32)
    ours = payload_arrays(words.view(np.int32), repr_)
    theirs = jpayload_arrays(words, repr_, {})
    assert sorted(ours) == sorted(theirs)
    for key, v in theirs.items():
        if hasattr(v, "dtype"):
            assert ours[key].dtype == v.dtype == np.uint32
            assert ours[key].tobytes() == v.tobytes()
        else:
            assert ours[key] == v
    assert mf.board_sha256(ours) == jmf.board_sha256(theirs)


@pytest.mark.parametrize("reader", sorted(MANIFEST_READERS))
def test_list_checkpoints_skips_malformed(tmp_path, reader):
    rmf = MANIFEST_READERS[reader]
    write_one(tmp_path, turn=5)
    write_one(tmp_path, turn=9)
    (tmp_path / f"{mf.CKPT_PREFIX}junk{mf.MANIFEST_SUFFIX}").write_text(
        "{not json")
    assert [t for t, _, _ in rmf.list_checkpoints(str(tmp_path))] == [5, 9]
    assert rmf.latest_checkpoint(str(tmp_path))[0] == 9
    with pytest.raises(INTEGRITY_ERRORS[reader]):
        list(rmf.list_checkpoints(str(tmp_path), strict=True))


def test_resolve_prefers_latest_durable(tmp_path):
    write_one(tmp_path, turn=5)
    p9 = write_one(tmp_path, turn=9)
    assert ckpt.resolve(str(tmp_path)) == ("manifest", p9)
    assert jckpt.resolve(str(tmp_path)) == ("manifest", p9)
    with pytest.raises(FileNotFoundError):
        ckpt.resolve(str(tmp_path / "empty"))


# ------------------------------------------------------------ retention


def test_retention_keeps_last_n_and_pinned_multiples(tmp_path):
    w = ckpt.CheckpointWriter(str(tmp_path), run_id="test",
                              keep_last=2, keep_every=100)
    cells = np.zeros((8, 8), np.uint8)
    for turn in (50, 100, 150, 200):
        w.write_sync(ckpt.Snapshot(cells, "u8", turn, (8, 8), "B3/S23"))
    turns = [t for t, _, _ in ckpt.list_checkpoints(str(tmp_path))]
    # last 2 = {150, 200}; keep_every=100 pins 100 and 200; 50 is GC'd
    assert turns == [100, 150, 200]
    for _, path, _ in ckpt.list_checkpoints(str(tmp_path)):
        jmf.verify_manifest(path)


def test_retention_deletes_manifest_before_payload(tmp_path, monkeypatch):
    """Crash-safety of GC ordering: a checkpoint must never exist as a
    manifest whose payload is gone; an orphan payload is garbage."""
    import gol_tpu_torch.ckpt.retention as retention_mod

    order = []
    real_unlink = os.unlink

    def spy(path, *a, **k):
        order.append(os.path.basename(path))
        return real_unlink(path, *a, **k)

    w = ckpt.CheckpointWriter(str(tmp_path), run_id="test", keep_last=1)
    cells = np.zeros((8, 8), np.uint8)
    w.write_sync(ckpt.Snapshot(cells, "u8", 1, (8, 8), "B3/S23"))
    monkeypatch.setattr(retention_mod.os, "unlink", spy)
    w.write_sync(ckpt.Snapshot(cells, "u8", 2, (8, 8), "B3/S23"))
    victims = [n for n in order if n.startswith(mf.CKPT_PREFIX)]
    assert victims and victims[0].endswith(mf.MANIFEST_SUFFIX)


def test_retention_sweeps_only_aged_garbage(tmp_path):
    w = ckpt.CheckpointWriter(str(tmp_path), run_id="test", keep_last=5)
    cells = np.zeros((8, 8), np.uint8)
    w.write_sync(ckpt.Snapshot(cells, "u8", 1, (8, 8), "B3/S23"))
    fresh = tmp_path / "ckpt-000000000009.npz"  # an orphan payload
    old = tmp_path / "x.npz.1234.tmp"
    fresh.write_bytes(b"x")
    old.write_bytes(b"x")
    aged = time.time() - 2 * ckpt.retention.ORPHAN_GRACE_SECONDS
    os.utime(old, (aged, aged))
    w.retention.apply(str(tmp_path))
    assert fresh.exists() and not old.exists()


# --------------------------------------------------------------- writer


def test_async_writer_double_buffer_drops_stale(tmp_path, monkeypatch):
    """submit() never queues unboundedly: while one write is in flight,
    a newer snapshot REPLACES the pending one (newest state wins)."""
    from gol_tpu_torch.ckpt import writer as writer_mod

    gate = threading.Event()
    cells = np.zeros((8, 8), np.uint8)
    real = writer_mod._materialize

    def gated(snap):
        if snap.turn == 1:
            gate.wait(30)
        return real(snap)

    monkeypatch.setattr(writer_mod, "_materialize", gated)
    w = ckpt.CheckpointWriter(str(tmp_path), run_id="test", keep_last=99)
    assert w.submit(ckpt.Snapshot(cells, "u8", 1, (8, 8), "B3/S23"))
    time.sleep(0.05)
    accepted = [w.submit(ckpt.Snapshot(cells, "u8", t, (8, 8), "B3/S23"))
                for t in (2, 3, 4)]
    gate.set()
    assert w.close(timeout=30)
    turns = [t for t, _, _ in ckpt.list_checkpoints(str(tmp_path))]
    assert turns == [1, 4] and accepted == [True, False, False]


def test_writer_submit_does_not_block(tmp_path):
    w = ckpt.CheckpointWriter(str(tmp_path), run_id="test")
    cells = np.zeros((256, 256), np.uint8)
    t0 = time.monotonic()
    for turn in range(20):
        w.submit(ckpt.Snapshot(cells, "u8", turn, cells.shape, "B3/S23"))
    assert time.monotonic() - t0 < 1.0
    assert w.close(timeout=60)


def test_checkpoint_now_requires_configuration():
    with pytest.raises(RuntimeError, match="GOL_CKPT"):
        Engine(device="cpu").checkpoint_now()


# ----------------------------------------------------- format parity


@pytest.mark.parametrize("case", sorted(CASES) + ["packed-fuse16"])
def test_manifests_agree_with_jax(case, tmp_path, monkeypatch):
    """The same board through the JAX engine and the port's engine with
    GOL_CKPT_EVERY_TURNS: at every turn both checkpointed, the manifests
    agree on PARITY_FIELDS and the payload members agree in dtype and
    bytes. (A writer drops a periodic snapshot the disk has not caught
    up with, so the two sets of turns may differ; the final one is in
    both.)"""
    base = case.replace("-fuse16", "")
    if base != case:
        monkeypatch.setenv("GOL_FUSE_K", "16")
    h, w, rule, repr_ = CASES[base]
    world = seed_world(base, seed=3)
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "32")
    monkeypatch.setenv("GOL_CKPT_KEEP", "100")
    monkeypatch.setenv("GOL_MAX_CHUNK", "16")
    found = {}
    for pkg, eng in engines(rule).items():
        monkeypatch.setenv("GOL_CKPT", str(tmp_path / pkg))
        out, turn = eng.server_distributor(params(pkg, h, w, 100), world)
        assert turn == 100 and eng._repr == repr_
        found[pkg] = {t: (p, m) for t, p, m in
                      jmf.list_checkpoints(str(tmp_path / pkg))}
    common = sorted(set(found["jax"]) & set(found["torch"]))
    assert 100 in common
    assert all(t % 32 == 0 for t in found["torch"] if t != 100)
    for t in common:
        (jp, jm), (tp, tm) = found["jax"][t], found["torch"][t]
        for key in PARITY_FIELDS:
            assert tm.get(key) == jm.get(key), (t, key)
        with np.load(jmf.payload_path(jp, jm)) as a, \
                np.load(mf.payload_path(tp, tm)) as b:
            assert sorted(a.files) == sorted(b.files)
            for key in a.files:
                assert a[key].dtype == b[key].dtype, key
                assert a[key].tobytes() == b[key].tobytes(), key
    assert found["torch"][100][1].get("fuse") == (
        16 if base != case else None)


# -------------------------------------------- restore across packages


def _checkpoint(pkg, eng, form, h, w, turns, world, tmp_path,
                monkeypatch):
    """Run `turns` on `eng` and checkpoint it in `form`: a manifest (the
    run's final one) or the legacy single-file npz. Returns its path."""
    if form == "manifest":
        monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
        monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "1000")
    eng.server_distributor(params(pkg, h, w, turns), world)
    monkeypatch.delenv("GOL_CKPT", raising=False)
    if form == "manifest":
        return jmf.latest_checkpoint(str(tmp_path / "ck"))[1]
    path = str(tmp_path / f"{w}x{h}.npz")
    eng.save_checkpoint(path)
    return path


@pytest.mark.parametrize("form", ["manifest", "npz"])
@pytest.mark.parametrize("direction", ["jax-to-torch", "torch-to-jax"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_restore_across_packages(case, direction, form, tmp_path,
                                 monkeypatch):
    """A checkpoint of one package restores in the other at its turn,
    with the exact alive count published, and K more turns there equal
    the JAX run that was never interrupted."""
    h, w, rule, repr_ = CASES[case]
    world = seed_world(case, seed=7)
    t1, k = 40, 24
    src, dst = direction.split("-to-")
    eng = engines(rule)
    path = _checkpoint(src, eng[src], form, h, w, t1, world, tmp_path,
                       monkeypatch)
    mid_world, _ = eng[src].get_world()
    assert eng[dst].restore_run(path) == t1
    got_world, got_turn = eng[dst].get_world()
    assert got_turn == t1
    np.testing.assert_array_equal(got_world, mid_world)
    # The restored board decides the representation of `eng[dst]` until
    # the next submit: a Generations world pixel file restores as gen8.
    firing = int((mid_world == 255).sum())
    assert eng[dst].alive_count() == (firing, t1)
    final, turn = eng[dst].server_distributor(
        params(dst, h, w, k), got_world, start_turn=t1)
    assert turn == t1 + k
    ref, _ = engines(rule)["jax"].server_distributor(
        params("jax", h, w, t1 + k), world)
    np.testing.assert_array_equal(final, ref)


def _int32_words_npz(path, h=8, w=64):
    rng = np.random.default_rng(2)
    words = rng.integers(0, 2**31, size=(h, w // 32)).astype(np.int32)
    np.savez(path, words=words, width=w, turn=3, rulestring="B3/S23")


@pytest.mark.parametrize("pkg", ["torch", "jax"])
@pytest.mark.parametrize("bad", ["int32-words", "wrong-rule",
                                 "turn-mismatch", "planes-on-4-states",
                                 "bad-gen-state", "while-running"])
def test_each_package_refuses(pkg, bad, tmp_path):
    """The refusals of `load_checkpoint`/`restore_run`, in both packages,
    on files the port wrote."""
    rule = {"planes-on-4-states": "345/2/4",
            "bad-gen-state": "/2/3"}.get(bad, "B3/S23")
    eng = engines(rule)[pkg]
    errors = (ValueError, RuntimeError)
    if bad == "int32-words":
        path = str(tmp_path / "w.npz")
        _int32_words_npz(path)
        match = "uint32"
    elif bad == "wrong-rule":
        path = write_one(tmp_path, rule="B36/S23")
        match = "rule"
    elif bad == "turn-mismatch":
        m = mf.read_manifest(write_one(tmp_path, turn=7))
        os.unlink(str(tmp_path / f"{mf.CKPT_PREFIX}{7:012d}.json"))
        mf.write_manifest(
            str(tmp_path / f"{mf.CKPT_PREFIX}{9:012d}.json"), dict(m, turn=9))
        path, errors, match = str(tmp_path), INTEGRITY_ERRORS[pkg], "turn"
    elif bad == "planes-on-4-states":
        path = str(tmp_path / "p.npz")
        np.savez(path, gen_planes=np.zeros((2, 8, 1), np.uint32), width=32,
                 turn=1, rulestring="345/2/4")
        match = "two-plane"
    elif bad == "bad-gen-state":
        path = str(tmp_path / "s.npz")
        np.savez(path, gen_state=np.full((8, 8), 3, np.uint8), turn=1,
                 rulestring="/2/3")
        match = "Generations state"
    else:
        path = write_one(tmp_path, turn=5)
        match = "while running"
        failed = []
        run = threading.Thread(target=lambda: failed.append(
            eng.server_distributor(params(pkg, 64, 64, 10**9),
                                   random_pixels(64, 64))))
        run.start()
        deadline = time.monotonic() + 60
        while eng.ping() == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
    try:
        with pytest.raises(errors, match=match):
            eng.restore_run(path)
    finally:
        if bad == "while-running":
            eng.cf_put(FLAG_QUIT)
            run.join(60)
            assert not run.is_alive() and failed


# ------------------------------------------------------------- geometry


def _eight_device_checkpoint(tmp_path, monkeypatch, turns=40):
    """A JAX checkpoint of the default 8-device engine (8 shards of a
    64² board): its manifest records mesh devices 8."""
    world = random_pixels(64, 64, seed=11)
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "1000")
    eng = JEngine()
    eng.server_distributor(JParams(image_width=64, image_height=64,
                                   turns=turns), world)
    monkeypatch.delenv("GOL_CKPT_EVERY_TURNS")
    _, path, m = jmf.latest_checkpoint(str(tmp_path / "ck"))
    assert m["mesh"]["devices"] == 8
    return path, world


def test_eight_device_checkpoint_refused_then_resharded(tmp_path,
                                                        monkeypatch):
    path, world = _eight_device_checkpoint(tmp_path, monkeypatch)
    eng = Engine(device="cpu")
    assert ckpt.restore_delta(mf.read_manifest(path), eng) == [
        "mesh devices 8 -> 1"]
    with pytest.raises(ckpt.GeometryMismatch) as err:
        eng.restore_run(path)
    assert err.value.rpc_error_kind == "geometry"
    assert eng.restore_run(path, reshard=True) == 40
    got, turn = eng.get_world()
    want = run_turns_np((world != 0).astype(np.uint8), 40) * 255
    assert turn == 40
    np.testing.assert_array_equal(got, want)
    assert eng.alive_count() == (int((want != 0).sum()), 40)


@pytest.mark.parametrize("client", ["torch", "jax"])
def test_geometry_refused_over_the_wire(client, tmp_path, monkeypatch):
    """The port's server answers a mismatched RestoreRun with
    `geometry:`, which each package's client raises as its
    GeometryRefused; reshard=True restores it."""
    path, world = _eight_device_checkpoint(tmp_path, monkeypatch)
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=Engine(device="cpu"))
    srv.start_background()
    try:
        cls, refused = ((RemoteEngine, GeometryRefused) if client == "torch"
                        else (JRemote, JGeometryRefused))
        remote = cls(f"127.0.0.1:{srv.port}")
        with pytest.raises(refused, match="geometry"):
            remote.restore_run("")
        assert remote.restore_run(os.path.basename(path), reshard=True) == 40
        got, turn = remote.get_world()
    finally:
        srv.shutdown()
    assert turn == 40
    np.testing.assert_array_equal(
        got, run_turns_np((world != 0).astype(np.uint8), 40) * 255)


def test_jax_sparse_checkpoint_reshards_onto_dense(tmp_path, monkeypatch):
    """A checkpoint of the JAX sparse engine (a live window on a 256²
    torus) is refused directly and reshards onto the port's dense
    engine: the torus JAX's own decoder reads, and K more turns on it
    equal the numpy oracle."""
    from gol_tpu.sparse_engine import SparseEngine

    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "16")
    seed = random_pixels(64, 64, seed=11)
    SparseEngine(256).server_distributor(
        JParams(turns=50, image_height=64, image_width=64), seed.copy())
    monkeypatch.delenv("GOL_CKPT")
    t0, path, m = jmf.latest_checkpoint(str(tmp_path / "ck"))
    assert m["repr"] == "sparse" and t0 > 0
    eng = Engine(device="cpu")
    with pytest.raises(ckpt.GeometryMismatch, match="sparse"):
        eng.restore_run(path)
    assert eng.restore_run(path, reshard=True) == t0
    torus = jreshard.load_canonical(jmf.payload_path(path, m)).board
    np.testing.assert_array_equal(
        reshard.load_canonical(mf.payload_path(path, m)).board, torus)
    got, turn = eng.get_world()
    assert turn == t0 and eng._repr == "packed"
    np.testing.assert_array_equal(got, torus * 255)
    final, turn = eng.server_distributor(
        Params(image_width=256, image_height=256, turns=30), got,
        start_turn=t0)
    assert turn == t0 + 30
    np.testing.assert_array_equal(final, run_turns_np(torus, 30) * 255)


@pytest.mark.parametrize("member", ["gen_planes", "gen_state", "words",
                                    "world"])
def test_canonical_decode_matches_jax(member, tmp_path):
    """Both packages' canonical decoders read each payload member to the
    same state (and the port refuses a Generations board as binary)."""
    rng = np.random.default_rng(9)
    state = rng.integers(0, 3, size=(8, 64)).astype(np.uint8)
    board = (state == 1).astype(np.uint8)
    words = np.packbits(board, axis=1, bitorder="little").view("<u4")
    arrays = {
        "gen_planes": dict(
            gen_planes=np.stack([
                np.packbits(state == 1, axis=1,
                            bitorder="little").view("<u4"),
                np.packbits(state == 2, axis=1,
                            bitorder="little").view("<u4")]), width=64),
        "gen_state": dict(gen_state=state),
        "words": dict(words=words, width=64),
        "world": dict(world=board * 255),
    }[member]
    path = str(tmp_path / "p.npz")
    np.savez(path, turn=3, rulestring="/2/3", **arrays)
    ours, theirs = reshard.load_canonical(path), jreshard.load_canonical(
        path)
    assert (ours.kind, ours.turn, ours.rule) == (theirs.kind, theirs.turn,
                                                 theirs.rule)
    np.testing.assert_array_equal(ours.board, theirs.board)
    if ours.kind == "gen":
        with pytest.raises(reshard.GeometryMismatch):
            reshard.board01_of(ours)
    else:
        np.testing.assert_array_equal(reshard.board01_of(ours), board)
