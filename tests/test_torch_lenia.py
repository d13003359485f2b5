"""The port's Lenia family (`gol_tpu_torch/models/lenia.py`) and the conv
families end to end, against the JAX package on the same seeded inputs:
rulestrings, the shell kernel, `lenia_step` on both tiers within 1e-4 of
JAX `lenia_step` and of the float64 `step_np` oracle, the pinned-seed
digest, the engine's `f32` representation (lossless f32 frames, the u8
fallback, the view, float checkpoints and the binary engine's refusal),
then Bosco through `gol_tpu_torch.run` (PGM bytes and every published
alive count equal to `gol_tpu`'s), a Lenia `run` failing exactly as the
JAX one does, and `f32` and Larger-than-Life `u8` checkpoints and
journals restored and verified across the two packages, both ways.
Tolerances: Lenia 1e-4 max-abs (the reference's own, float32 against
float64); Larger-than-Life 0."""

import os
import queue
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gol_tpu
from gol_tpu import Params as JParams
from gol_tpu import ckpt as jckpt
from gol_tpu import events as jev
from gol_tpu import journal as jjournal
from gol_tpu import wire as jwire
from gol_tpu.ckpt.restore import restore_engine as jrestore_engine
from gol_tpu.engine import Engine as JEngine
from gol_tpu.io.pgm import write_pgm as jwrite_pgm
from gol_tpu.models import largerthanlife as jltl
from gol_tpu.models import lenia as JL
from gol_tpu.ops import conv as JC

import gol_tpu_torch
from gol_tpu_torch import Params, ckpt, events as ev, journal, wire
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt.reshard import GeometryMismatch
from gol_tpu_torch.ckpt.restore import restore_engine
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.models import largerthanlife as tltl
from gol_tpu_torch.models import lenia as L
from gol_tpu_torch.ops import conv as C

torch.set_num_threads(2)

# The JAX test's pinned-seed contract (tests/test_lenia.py): the float64
# oracle's digest after 4 turns of seed_board(96, 96, seed=7).
PINNED_SEED = 7
PINNED_TURNS = 4
PINNED_DIGEST = \
    "19d6af2d81c994c3ffdedeb038c78c376484086ded98a43cd94c9fdc52946ee4"
TOL = 1e-4


@pytest.fixture(autouse=True)
def _journal_isolation():
    journal.reset()
    jjournal.reset()
    yield
    journal.reset()
    jjournal.reset()


def _maxabs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# ----------------------------------------------------------- rule/kernel


@pytest.mark.parametrize("s", ["lenia:r=13,mu=0.150,sigma=0.015,dt=0.10",
                               "lenia:r=4,mu=0.15,sigma=0.015,dt=0.1",
                               "lenia:r=128,mu=1e-1,sigma=2E-2,dt=1"])
def test_rulestring_canonicalises_as_jax(s):
    got, want = L.LeniaRule(s), JL.LeniaRule(s)
    assert got.rulestring == want.rulestring
    assert (got.radius, got.mu, got.sigma, got.dt) == \
        (want.radius, want.mu, want.sigma, want.dt)
    assert got.kernel_key == want.kernel_key
    assert L.ORBIUM == L.LeniaRule(
        "lenia:r=13,mu=0.150,sigma=0.015,dt=0.10")


@pytest.mark.parametrize("bad", [
    "lenia:r=1,mu=0.15,sigma=0.015,dt=0.1",
    "lenia:r=13,mu=1.5,sigma=0.015,dt=0.1",
    "lenia:r=13,mu=0.15,sigma=0.0,dt=0.1",
    "lenia:r=13,mu=0.15,sigma=0.015,dt=0.0",
    "R5,C0,M1,S33..57,B34..45,NM",
])
def test_rulestring_rejects(bad):
    with pytest.raises(ValueError):
        JL.LeniaRule(bad)
    with pytest.raises(ValueError):
        L.LeniaRule(bad)


@pytest.mark.parametrize("r", [2, 4, 13])
def test_kernel_matches_jax(r):
    k = L.lenia_kernel_from_key(("lenia", r))
    np.testing.assert_array_equal(k, JL.lenia_kernel_from_key(("lenia", r)))
    assert k.shape == (2 * r + 1, 2 * r + 1)
    assert abs(float(k.sum()) - 1.0) < 1e-6
    assert k[r, r] == 0.0
    assert np.allclose(k, k[::-1, ::-1])


def test_growth_matches_jax():
    u = np.linspace(0.0, 0.4, 101, dtype=np.float32)
    got = L.growth(torch.from_numpy(u), L.ORBIUM).numpy()
    want = np.asarray(JL.growth(jnp.asarray(u), JL.ORBIUM))
    assert got.dtype == np.float32
    assert _maxabs(got, want) < 1e-6


# -------------------------------------------------- step parity/digest


@pytest.mark.parametrize("tier", ["conv", "fft"])
@pytest.mark.parametrize("rs", ["lenia:r=13,mu=0.15,sigma=0.015,dt=0.1",
                                "lenia:r=4,mu=0.15,sigma=0.015,dt=0.1"])
def test_step_matches_jax_and_oracle(tier, rs):
    rule, jrule = L.LeniaRule(rs), JL.LeniaRule(rs)
    s = L.seed_board(64, 48, 3, rule)
    np.testing.assert_array_equal(s, JL.seed_board(64, 48, 3, jrule))
    got = L.lenia_step(torch.from_numpy(s), rule, tier)
    assert got.dtype == torch.float32
    assert _maxabs(got, JL.lenia_step(jnp.asarray(s), jrule, tier)) < TOL
    assert _maxabs(got, L.step_np(s, rule)) < TOL
    np.testing.assert_array_equal(L.step_np(s, rule), JL.step_np(s, jrule))


def test_step_reads_nothing_back_from_the_device(monkeypatch):
    """lenia_step issues its ops without reading a value to the host."""
    s = torch.from_numpy(L.seed_board(32, 32, 1, L.ORBIUM))

    def refuse(*a, **k):
        raise AssertionError("lenia_step read a value back to the host")

    for name in ("item", "tolist", "numpy", "__float__", "__int__",
                 "__bool__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    for tier in ("conv", "fft"):
        L.lenia_step(s, L.ORBIUM, tier)
        C.lenia_run_fn(tier)(s, 3, L.ORBIUM)


def test_pinned_seed_oracle_digest():
    s = L.seed_board(96, 96, PINNED_SEED, L.ORBIUM)
    assert not np.array_equal(s, L.seed_board(96, 96, 8, L.ORBIUM))
    ref = s
    for _ in range(PINNED_TURNS):
        ref = L.step_np(ref, L.ORBIUM)
    assert L.board_digest(ref) == PINNED_DIGEST
    got = C.run_turns(torch.from_numpy(s), PINNED_TURNS, L.ORBIUM)
    assert _maxabs(got, ref) < TOL
    assert L.alive_count_np(ref) > 0
    assert L.alive_count_np(s) != L.alive_count_np(ref)
    a = np.array([[0.0, 0.2004]], dtype=np.float32)
    b = np.array([[-0.0, 0.2001]], dtype=np.float32)
    assert L.board_digest(a) == L.board_digest(b) == JL.board_digest(b)
    assert L.board_digest(a) != L.board_digest(a + 0.001)


def test_run_turns_tracks_jax_on_both_tiers():
    s = L.seed_board(64, 64, PINNED_SEED, L.ORBIUM)
    for tier in ("conv", "fft"):
        got = C.run_turns(torch.from_numpy(s), 3, L.ORBIUM, tier=tier)
        want = JC.run_turns(jnp.asarray(s), 3, JL.ORBIUM, tier=tier)
        assert _maxabs(got, want) < TOL


# ------------------------------------------------------ engine f32


def _roundtrip(frame):
    a, b = socket.socketpair()
    a.settimeout(10)
    b.settimeout(10)
    try:
        out = {}
        t = threading.Thread(target=lambda: out.update(
            resp=wire.recv_msg(b)))
        t.start()
        wire.send_msg(a, {"ok": True}, frame=frame)
        t.join(10)
        return out["resp"][1]
    finally:
        a.close()
        b.close()


def _run_engine(rule, world, turns, h=64, w=64):
    eng = Engine(device="cpu", rule=rule)
    eng.server_distributor(Params(threads=1, image_width=w, image_height=h,
                                  turns=turns), world)
    return eng


def test_engine_f32_frame_and_u8_fallback():
    s0 = L.seed_board(64, 64, PINNED_SEED, L.ORBIUM)
    ref = s0
    for _ in range(3):
        ref = L.step_np(ref, L.ORBIUM)
    eng = _run_engine(L.ORBIUM, s0, 3)
    assert eng._repr == "f32"
    assert eng.frames_diffable is False and eng.binary_pixels is False
    assert eng.geometry()["dtype"] == "float32"
    frame, turn = eng.get_world_frame(frozenset({wire.CAP_F32}))
    got = _roundtrip(frame)
    assert turn == 3 and got.dtype == np.float32
    assert _maxabs(got, ref) < TOL
    assert eng.alive_count() == (int((got > L.ALIVE_THRESHOLD).sum()), 3)
    # Caps-less peer: quantized u8 pixels of the same state.
    px = _roundtrip(eng.get_world_frame(frozenset())[0])
    assert px.dtype == np.uint8
    np.testing.assert_array_equal(px, np.rint(got * 255.0).astype(np.uint8))
    np.testing.assert_array_equal(eng.get_world()[0], px)
    # The f32 frame is byte-identical to the JAX codec's for that state.
    assert jwire.freeze_message({"ok": True}, jwire.encode_board_f32(
        got, frozenset({jwire.CAP_F32}))) == wire.freeze_message(
            {"ok": True}, eng.get_world_frame({wire.CAP_F32})[0])


def test_engine_u8_pixels_ingest_and_view_match_jax():
    """A uint8 world is pixels / 255 in both engines; the downsampled
    view of the same state is the same block maximum, quantized."""
    rng = np.random.default_rng(2)
    px = rng.integers(0, 256, (48, 40)).astype(np.uint8)
    eng = _run_engine(L.ORBIUM, px, 0, 48, 40)
    jeng = JEngine(rule=JL.ORBIUM, devices=jax.devices()[:1])
    jeng.server_distributor(JParams(threads=1, image_width=40,
                                    image_height=48, turns=0), px)
    np.testing.assert_array_equal(eng.get_world()[0], jeng.get_world()[0])
    for cap in (0, 300, 100):
        v, t, f = eng.get_view(cap)
        jv, jt, jf = jeng.get_view(cap)
        assert (t, tuple(f)) == (jt, tuple(jf))
        np.testing.assert_array_equal(v, jv)
    assert eng.alive_count() == jeng.alive_count()


def test_engine_float_checkpoint_roundtrip(tmp_path):
    s0 = L.seed_board(64, 64, PINNED_SEED, L.ORBIUM)
    eng = _run_engine(L.ORBIUM, s0, 2)
    path = str(tmp_path / "lenia.npz")
    eng.save_checkpoint(path)
    before = _roundtrip(eng.get_world_frame({wire.CAP_F32})[0])
    eng2 = Engine(device="cpu", rule=L.ORBIUM)
    assert eng2.load_checkpoint(path) == 2
    after = _roundtrip(eng2.get_world_frame({wire.CAP_F32})[0])
    np.testing.assert_array_equal(before, after)  # bit-exact restore
    ref = before
    for _ in range(2):
        ref = L.step_np(ref, L.ORBIUM)
    eng2.server_distributor(Params(threads=1, image_width=64,
                                   image_height=64, turns=2), before)
    got = _roundtrip(eng2.get_world_frame({wire.CAP_F32})[0])
    assert _maxabs(got, ref) < TOL


@pytest.mark.parametrize("bad", ["nan", "float64", "3d", "pixels",
                                 "binary-engine"])
def test_float_checkpoint_refusals(bad, tmp_path):
    state = L.seed_board(16, 16, 1, L.ORBIUM)
    path = str(tmp_path / "bad.npz")
    rule = L.ORBIUM
    arrays = {"float_state": state}
    if bad == "nan":
        state = state.copy()
        state[3, 4] = np.nan
        arrays = {"float_state": state}
    elif bad == "float64":
        arrays = {"float_state": state.astype(np.float64)}
    elif bad == "3d":
        arrays = {"float_state": state[None]}
    elif bad == "pixels":
        arrays = {"world": np.zeros((16, 16), np.uint8)}
    np.savez(path, turn=1, rulestring=rule.rulestring, **arrays)
    eng = Engine(device="cpu",
                 rule=tltl.BOSCO if bad == "binary-engine" else rule)
    if bad == "binary-engine":
        np.savez(path, turn=1, rulestring=tltl.BOSCO.rulestring, **arrays)
    with pytest.raises(ValueError):
        eng.load_checkpoint(path)


def test_binary_engine_refuses_float_manifest(tmp_path):
    """A float manifest on a binary engine: refused on the cell-dtype
    delta (a geometry error), and even a reshard cannot repack it; a
    Lenia engine restores it."""
    eng = _run_engine(tltl.BOSCO, ((np.random.default_rng(0).random(
        (32, 64)) < 0.3) * 255).astype(np.uint8), 1, 32, 64)
    state = L.seed_board(32, 32, 1, L.ORBIUM)
    snap = ckpt.Snapshot(state, "f32", 5, (32, 32), L.ORBIUM.rulestring,
                         mesh={"devices": 1})
    path = ckpt.CheckpointWriter(str(tmp_path), run_id="t").write_sync(snap)
    with pytest.raises(GeometryMismatch) as ei:
        restore_engine(eng, path)
    assert "cell dtype" in str(ei.value)
    assert ei.value.rpc_error_kind == "geometry"
    with pytest.raises(ValueError):
        restore_engine(eng, path, reshard=True)
    eng2 = _run_engine(L.ORBIUM, state, 1, 32, 32)
    assert restore_engine(eng2, path) == 5
    assert restore_engine(eng2, path, reshard=True) == 5
    np.testing.assert_array_equal(
        _roundtrip(eng2.get_world_frame({wire.CAP_F32})[0]), state)


# ---------------------------------------------------------- end to end


def _stage(tmp_path, world, name="images"):
    d = tmp_path / name
    d.mkdir(exist_ok=True)
    h, w = world.shape
    jwrite_pgm(str(d / f"{w}x{h}.pgm"), world)
    return str(d)


def _drain(q, t):
    evs = ev.drain(q)
    t.join(60)
    return evs


def test_bosco_run_matches_gol_tpu(tmp_path, monkeypatch):
    """Bosco 64² x 20 through `gol_tpu_torch.run` on a CPU engine: one-turn
    chunks, so every turn's (alive, turn) pair is published; each pair
    the poll saw, and each ticker event, equals the JAX package's count
    at its turn, and the final PGM and firing set equal
    `gol_tpu.run`'s."""
    monkeypatch.setenv("GOL_MAX_CHUNK", "1")
    rng = np.random.default_rng(20)
    world = ((rng.random((64, 64)) < 0.4) * 255).astype(np.uint8)
    images = _stage(tmp_path, world)
    turns = 20
    eng = Engine(device="cpu", rule=tltl.BOSCO)
    q = queue.Queue()
    t = gol_tpu_torch.run(Params(threads=1, image_width=64, image_height=64,
                                 turns=turns), q, engine=eng,
                          images_dir=images, out_dir=str(tmp_path / "port"))
    pairs = set()
    while t.is_alive():
        pairs.add(eng.alive_count())
    evs = _drain(q, t)
    assert t.exception is None
    pairs.add(eng.alive_count())
    pairs.discard((0, 0))  # polls before the board loads
    assert eng._repr == "u8"
    counts = {0: int((world != 0).sum())}
    b = jnp.asarray((world != 0).astype(np.uint8))
    for turn in range(1, turns + 1):
        b = JC.run_turns(b, 1, jltl.BOSCO)
        counts[turn] = int(np.asarray(b).sum())
    assert len(pairs) >= 2 and (counts[turns], turns) in pairs
    for alive, turn in pairs:
        assert counts[turn] == alive, turn
    ticks = [e for e in evs if isinstance(e, ev.AliveCellsCount)]
    for tick in ticks:
        assert counts[tick.completed_turns] == tick.cells_count
    jq = queue.Queue()
    gol_tpu.run(JParams(threads=1, image_width=64, image_height=64,
                        turns=turns), jq, None,
                engine=JEngine(rule=jltl.BOSCO, devices=jax.devices()[:1]),
                images_dir=images, out_dir=str(tmp_path / "jax"))
    jevs = jev.drain(jq)
    name = f"64x64x{turns}.pgm"
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    jfinal = [e for e in jevs if isinstance(e, jev.FinalTurnComplete)][0]
    assert set(final.alive) == {tuple(c) for c in jfinal.alive}
    assert len(final.alive) == counts[turns]


def test_lenia_run_fails_as_gol_tpu_does(tmp_path, monkeypatch):
    """The reference's controller writes the final PGM with the strict
    {0, 255} levels, which a Lenia board's gray pixels fail: both runs
    emit FinalTurnComplete, then fail at the write with the same error,
    close the events and leave no PGM."""
    monkeypatch.setenv("GOL_RULE", L.ORBIUM.rulestring)
    monkeypatch.setattr(gol_tpu_torch.distributor, "_default_engine", None)
    import gol_tpu.distributor as jdist

    monkeypatch.setattr(jdist, "_default_engine", None)
    rng = np.random.default_rng(5)
    world = ((rng.random((64, 64)) < 0.35) * 255).astype(np.uint8)
    images = _stage(tmp_path, world)
    q = queue.Queue()
    t = gol_tpu_torch.run(Params(threads=1, image_width=64, image_height=64,
                                 turns=5), q, images_dir=images,
                          out_dir=str(tmp_path / "port"), device="cpu")
    evs = _drain(q, t)
    jq = queue.Queue()
    jt = gol_tpu.run(JParams(threads=1, image_width=64, image_height=64,
                             turns=5), jq, None, images_dir=images,
                     out_dir=str(tmp_path / "jax"))
    jevs = jev.drain(jq)
    jt.join(60)
    def kinds(events):  # the 2 s ticker's events depend on timing
        return [type(e).__name__ for e in events
                if type(e).__name__ != "AliveCellsCount"]

    assert kinds(evs) == kinds(jevs) == ["StateChange", "FinalTurnComplete"]
    assert isinstance(t.exception, ValueError)
    assert type(t.exception) is type(jt.exception)
    msg, jmsg = str(t.exception), str(jt.exception)
    assert msg.split(" ", 1)[1] == jmsg.split(" ", 1)[1] == \
        "cells not in {0, 255} (pass pixels, not {0,1} cells)"
    assert abs(int(msg.split()[0]) - int(jmsg.split()[0])) <= 4
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    jfinal = [e for e in jevs if isinstance(e, jev.FinalTurnComplete)][0]
    assert final.completed_turns == jfinal.completed_turns == 5
    assert not (tmp_path / "port" / "64x64x5.pgm").exists()
    assert not (tmp_path / "jax" / "64x64x5.pgm").exists()


# -------------------------------------- checkpoints and journals, both ways


def _family_run(pkg, family, tmp_path, monkeypatch):
    """A checkpointed, journaled 64² run of `pkg`'s engine: Orbium from
    its seed (f32) or Bosco from a soup (u8). Returns (checkpoint dir,
    journal path, world)."""
    tag = f"{pkg}-{family}"
    monkeypatch.setenv("GOL_JOURNAL", str(tmp_path / f"j-{tag}"))
    monkeypatch.setenv("GOL_JOURNAL_DIGEST_EVERY", "4")
    monkeypatch.setenv("GOL_MAX_CHUNK", "2")
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / f"ck-{tag}"))
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "4")
    monkeypatch.setenv("GOL_CKPT_KEEP", "100")
    if family == "f32":
        world = L.seed_board(64, 64, 11, L.ORBIUM)
        rs = L.ORBIUM.rulestring
    else:
        world = ((np.random.default_rng(12).random((64, 64)) < 0.4)
                 * 255).astype(np.uint8)
        rs = tltl.BOSCO.rulestring
    if pkg == "jax":
        from gol_tpu.models import parse_rule as jparse

        eng = JEngine(rule=jparse(rs), devices=jax.devices()[:1])
        eng.server_distributor(JParams(threads=1, image_width=64,
                                       image_height=64, turns=12), world)
    else:
        from gol_tpu_torch.models import parse_rule

        eng = Engine(device="cpu", rule=parse_rule(rs))
        eng.server_distributor(Params(threads=1, image_width=64,
                                      image_height=64, turns=12), world)
    (jpath,) = [str(p) for p in (tmp_path / f"j-{tag}").iterdir()]
    return str(tmp_path / f"ck-{tag}"), jpath, world


@pytest.mark.parametrize("family", ["f32", "u8"])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_checkpoints_and_journals_cross_packages(family, writer, tmp_path,
                                                 monkeypatch):
    """Manifests and journals of either package's Lenia (f32) or Bosco
    (u8) run verify in both packages; the newest checkpoint restores
    into the other package's engine with its state bit-exact; the u8
    runs agree record for record, the f32 runs on every board within
    the tolerance."""
    ck, jpath, world = _family_run(writer, family, tmp_path, monkeypatch)
    assert journal.verify_file(jpath)["ok"]
    assert jjournal.verify_file(jpath)["ok"]
    recs = journal.load_records(jpath)[0]
    assert recs[0]["kind"] == "create" and recs[0]["repr"] == family
    assert ("seed" in recs[0]) == (family == "u8")
    items = list(mf.list_checkpoints(ck))
    assert [t for t, _, _ in items][-1] == 12
    for _, man_path, m in items:
        mf.verify_manifest(man_path)
        jckpt.verify_manifest(man_path)
        assert m["repr"] == family
        assert m["dtype"] == ("float32" if family == "f32" else "uint8")
    newest = items[-1][1]
    rs = items[-1][2]["rule"]
    with np.load(mf.payload_path(newest, items[-1][2])) as z:
        payload = {k: z[k] for k in z.files}
    # Restore into the other package (and this one), bit-exact.
    from gol_tpu.models import parse_rule as jparse
    from gol_tpu_torch.models import parse_rule

    port = Engine(device="cpu", rule=parse_rule(rs))
    assert restore_engine(port, newest) == 12
    jeng = JEngine(rule=jparse(rs), devices=jax.devices()[:1])
    assert jrestore_engine(jeng, newest) == 12
    if family == "f32":
        got = _roundtrip(port.get_world_frame({wire.CAP_F32})[0])
        np.testing.assert_array_equal(got, payload["float_state"])
        jframe, _ = jeng.get_world_frame(frozenset({jwire.CAP_F32}))
        assert jwire.freeze_message({"ok": True}, jframe) == \
            wire.freeze_message({"ok": True}, wire.encode_board_f32(
                got, frozenset({wire.CAP_F32})))
    else:
        np.testing.assert_array_equal(port.get_world()[0], payload["world"])
        np.testing.assert_array_equal(jeng.get_world()[0],
                                      payload["world"])
    assert port.alive_count() == jeng.alive_count() == \
        (items[-1][2]["alive"], 12)
    # The other package's run of the same world: u8 records equal field
    # for field; f32 boards equal within the tolerance.
    other = "jax" if writer == "torch" else "torch"
    ck2, jpath2, _ = _family_run(other, family, tmp_path, monkeypatch)
    recs2 = journal.load_records(jpath2)[0]

    def content(r):
        return {k: v for k, v in r.items()
                if k not in ("ts", "run_id", "prev", "hash", "seq")}

    # Which digests a run journals depends on when its checkpoint writer
    # catches up (in both packages): compare the turns both wrote.
    def digests(rs_):
        return {r["turn"]: r["board_sha256"] for r in rs_
                if r["kind"] == "digest"}

    d1, d2 = digests(recs), digests(recs2)
    assert {4, 8, 12} & set(d1) & set(d2)
    assert content(recs[-1]) == content(recs2[-1])  # the end bookend
    if family == "u8":
        assert content(recs[0]) == content(recs2[0])
        for turn in set(d1) & set(d2):
            assert d1[turn] == d2[turn], turn
    else:
        assert recs[0]["board_sha256"] == recs2[0]["board_sha256"]
        c1 = {t: mf.payload_path(p, m) for t, p, m in mf.list_checkpoints(ck)}
        c2 = {t: mf.payload_path(p, m)
              for t, p, m in mf.list_checkpoints(ck2)}
        assert 12 in set(c1) & set(c2)  # both write the final one
        for turn in set(c1) & set(c2):
            with np.load(c1[turn]) as a, np.load(c2[turn]) as b:
                assert _maxabs(a["float_state"], b["float_state"]) < TOL


# ----------------------------------------------- control plane, both ways


@pytest.mark.parametrize("side", ["torch-client/jax-server",
                                  "jax-client/torch-server"])
@pytest.mark.parametrize("rs", [L.ORBIUM.rulestring, tltl.BOSCO.rulestring])
def test_served_conv_families_across_packages(side, rs, monkeypatch):
    """Each package's client against the other's server running Lenia or
    Bosco: the run's board and count come back, and GetWorld sends
    Lenia's float32 state as an f32 frame under the negotiated cap."""
    from gol_tpu.client import RemoteEngine as JRemote
    from gol_tpu.models import parse_rule as jparse
    from gol_tpu.server import EngineServer as JServer
    from gol_tpu_torch.client import RemoteEngine as TRemote
    from gol_tpu_torch.models import parse_rule
    from gol_tpu_torch.server import EngineServer as TServer

    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    if side.startswith("torch-client"):
        srv = JServer(port=0, host="127.0.0.1",
                      engine=JEngine(rule=jparse(rs),
                                     devices=jax.devices()[:1]))
        client = TRemote
    else:
        srv = TServer(port=0, host="127.0.0.1",
                      engine=Engine(device="cpu", rule=parse_rule(rs)))
        client = JRemote
    srv.start_background()
    try:
        rem = client(f"127.0.0.1:{srv.port}")
        rng = np.random.default_rng(21)
        world = ((rng.random((64, 64)) < 0.4) * 255).astype(np.uint8)
        out, turn = rem.server_distributor(
            Params(threads=1, image_width=64, image_height=64, turns=3),
            world)
        assert turn == 3
        got, turn = rem.get_world()
        assert turn == 3
        alive, aturn = rem.alive_count()
        assert aturn == 3
        if rs == L.ORBIUM.rulestring:
            ref = world.astype(np.float32) / np.float32(255.0)
            for _ in range(3):
                ref = L.step_np(ref, L.ORBIUM)
            assert got.dtype == np.float32
            assert _maxabs(got, ref) < TOL
            np.testing.assert_array_equal(
                out, np.clip(np.rint(got * 255.0), 0, 255).astype(np.uint8))
            assert alive == int((got > L.ALIVE_THRESHOLD).sum())
        else:
            want = jltl.run_turns_np((world != 0).astype(np.uint8), 3,
                                     jltl.BOSCO)
            np.testing.assert_array_equal(got, want * 255)
            np.testing.assert_array_equal(out, want * 255)
            assert alive == int(want.sum())
    finally:
        srv.shutdown()
