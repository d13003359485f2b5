"""Temporal fusion in the torch port (`gol_tpu_torch.ops.fused`, K6
`tiled_sweep_deep` and `fused_banded_run_turns` in `ops/cuda_stencil`,
`fused_packed_run_turns` in `parallel/halo`, the engine's `GOL_FUSE_K`)
against the JAX package: the depth policy, the
banded fused run against the Pallas kernel in interpret mode, the fused
runs against the JAX functions and the numpy oracle, and the engine end to
end. Integer boards: bit-exact (tolerance 0). The kernels run only on a
CUDA device; here the wrappers run their plain versions."""

import queue

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gol_tpu
from gol_tpu import events as jev
from gol_tpu.engine import Engine as JaxEngine
from gol_tpu.models import generations as jg
from gol_tpu.models import lifelike as jl
from gol_tpu.ops import bitpack as jbp
from gol_tpu.ops import fused as jfused
from gol_tpu.ops.pallas_stencil import (
    fused_banded_run_turns as jax_fused_banded,
    fused_banded_supported as jax_fused_banded_supported,
    interpret_supported,
)

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.io.pgm import write_pgm
from gol_tpu_torch.models import generations as tg
from gol_tpu_torch.models import lifelike as tl
from gol_tpu_torch.ops import bitpack as tbp
from gol_tpu_torch.ops import cuda_stencil as cs
from gol_tpu_torch.ops import fused
from gol_tpu_torch.ops.reference import run_turns_np
from gol_tpu_torch.parallel import halo

torch.set_num_threads(2)


@pytest.fixture
def pallas():
    ok, why = interpret_supported()
    if not ok:
        pytest.skip(why)


def board(h, w, seed, density=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < density).astype(np.uint8)


def words(b):
    return tbp.words_from_numpy(tbp.pack_np(b))


# ------------------------------------------------------------ depth policy

@pytest.mark.parametrize("value,want", [(None, 0), ("8", 8), ("9999", 64),
                                        ("garbage", 0), ("-3", 0)])
def test_configured_fuse_k_matches_jax(value, want, monkeypatch):
    if value is None:
        monkeypatch.delenv(fused.FUSE_K_ENV, raising=False)
    else:
        monkeypatch.setenv(fused.FUSE_K_ENV, value)
    assert fused.configured_fuse_k() == jfused.configured_fuse_k() == want


def test_fuse_constants_match_jax_and_kernel():
    assert fused.FUSE_K_ENV == jfused.FUSE_K_ENV == "GOL_FUSE_K"
    assert fused.MAX_FUSE_K == jfused.MAX_FUSE_K == cs.DEEP_MAX_T
    assert cs.TILE_MAX_T == 32


@pytest.mark.parametrize("fuse,ok", [(0, False), (1, True), (7, True),
                                     (32, True), (33, True), (64, True),
                                     (65, False)])
def test_fused_banded_takes_every_depth_any_shape(fuse, ok):
    """Depths 1..64 on any board (no 8-row or 128-lane gate); others
    raise."""
    for shape in [(1, 32), (5, 3 * 32), (7, 33 * 32)]:
        b = board(*shape, seed=fuse + shape[0])
        if not ok:
            with pytest.raises(ValueError):
                cs.fused_banded_run_turns(words(b), fuse + 1, fuse)
            continue
        got = cs.fused_banded_run_turns(words(b), fuse + 1, fuse)
        assert np.array_equal(tbp.words_to_numpy(got), np.asarray(
            jbp.packed_run_turns(jbp.pack(b), fuse + 1)))


def test_fused_banded_rejects_unsupported_depth():
    w = words(board(8, 64, seed=1))
    for bad in (0, 65):
        with pytest.raises(ValueError):
            cs.fused_banded_run_turns(w, 10, bad)


# ------------------------------------------------------------------- K6

@pytest.mark.parametrize("t", [1, 33, 64])
@pytest.mark.parametrize("shape", [(400, 70 * 32), (5, 3 * 32), (1, 32),
                                   (321, 61 * 32), (3, 200 * 32)])
def test_tiled_sweep_deep_plain_matches_scan(shape, t):
    """Boards not aligned to the 320 x 60-word tile, and boards shorter
    or narrower than one window (the window wraps several times)."""
    b = board(*shape, seed=shape[0] + t)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), t))
    assert np.array_equal(
        tbp.words_to_numpy(cs.tiled_sweep_deep_plain(words(b), t)), want)


def test_tiled_sweep_deep_rule_and_output_buffer():
    b = board(330, 64 * 32, seed=2)
    w = words(b)
    out = torch.zeros_like(w)
    cs.tiled_sweep_deep(w, out, 50, tl.HIGHLIFE)
    want = np.asarray(jbp.packed_run_turns(jbp.pack(b), 50, jl.HIGHLIFE))
    assert np.array_equal(tbp.words_to_numpy(out), want)


@pytest.mark.parametrize("bad", [0, 65])
def test_tiled_sweep_deep_rejects_depth(bad):
    w = words(board(8, 32, seed=1))
    with pytest.raises(ValueError):
        cs.tiled_sweep_deep(w, torch.empty_like(w), bad)


def test_tiled_sweep_deep_rejects_aliased_output():
    w = words(board(8, 32, seed=1))
    with pytest.raises(ValueError):
        cs.tiled_sweep_deep(w, w, 40)


def test_tiled_sweep_deep_counts_nothing_on_cpu():
    cs.reset_launch_counts()
    w = words(board(64, 64, seed=3))
    out = torch.empty_like(w)
    cs.tiled_sweep_deep(w, out, 40)
    assert torch.equal(out, cs.tiled_sweep_deep_plain(w, 40))
    assert cs.tiled_sweep_deep in cs.KERNELS
    assert cs.tiled_sweep_deep.launches == 0


# ------------------------------------------------------------------- B3

@pytest.mark.parametrize("rule", ["B3/S23", "B36/S23"])
@pytest.mark.parametrize("fuse", [8, 16, 40, 64])
def test_fused_banded_matches_pallas(fuse, rule, pallas):
    """64 x 4096 cells, where the TPU gate holds; 2k + 5 turns leaves a
    remainder the TPU runs on its VMEM kernel (5 is not 8-aligned)."""
    b = board(64, 4096, seed=fuse)
    assert jax_fused_banded_supported(jbp.pack(b).shape, fuse)
    turns = 2 * fuse + 5
    want = np.asarray(jax_fused_banded(
        jbp.pack(b), turns, fuse, jl.LifeLikeRule(rule), interpret=True))
    got = cs.fused_banded_run_turns(words(b), turns, fuse,
                                    tl.LifeLikeRule(rule))
    assert np.array_equal(tbp.words_to_numpy(got), want)


def _record_sweeps(monkeypatch):
    """Record (kernel, depth) of every sweep the plain versions run."""
    seen = []
    for name, tag in (("tiled_sweep_plain", "K2"),
                      ("tiled_sweep_deep_plain", "K6")):
        plain = getattr(cs, name)

        def record(w, t, rule=tl.CONWAY, *geometry, plain=plain, tag=tag):
            seen.append((tag, t))
            return plain(w, t, rule, *geometry)

        monkeypatch.setattr(cs, name, record)
    return seen


@pytest.mark.parametrize("fuse,want", [
    (16, [("K2", 16)] * 6 + [("K2", 5)]),
    (32, [("K2", 32)] * 3 + [("K2", 5)]),
    (48, [("K6", 48)] * 2 + [("K2", 5)]),
    (64, [("K6", 64), ("K6", 37)]),
])
def test_pinned_k_sets_sweep_depths(fuse, want, monkeypatch):
    """floor(n/k) sweeps at depth k, one at n mod k; K2 up to 32, K6
    beyond; the input board is never written."""
    seen = _record_sweeps(monkeypatch)
    b = board(100, 96, seed=fuse)
    w = words(b)
    before = w.clone()
    turns = sum(t for _, t in want)
    got = cs.fused_banded_run_turns(w, turns, fuse)
    assert seen == want
    assert torch.equal(w, before)
    assert np.array_equal(tbp.words_to_numpy(got),
                          np.asarray(jbp.packed_run_turns(jbp.pack(b),
                                                          turns)))


# ------------------------------------------------------ fused packed run

@pytest.mark.parametrize("fuse", [2, 3, 8, 33, 48, 64])
@pytest.mark.parametrize("shape", [(1024, 1024), (1000, 1024), (96, 256)])
def test_fused_packed_matches_jax_and_oracle(shape, fuse):
    """Above K1's 116,224 bytes (1024², and a height the 320- and 384-row
    tiles do not divide) and a K1-resident board; 2k + 5 turns."""
    b = board(*shape, seed=fuse + shape[0])
    turns = 2 * fuse + 5
    assert cs.fits_resident(tbp.pack_np(b).shape) == (shape[0] < 1000)
    got = tbp.words_to_numpy(halo.fused_packed_run_turns(
        words(b), turns, tl.CONWAY, fuse))
    want = np.asarray(jfused.fused_packed_run_turns(
        jbp.pack(b), turns, jl.CONWAY, fuse, platform="cpu"))
    assert np.array_equal(got, want)
    assert np.array_equal(got, tbp.pack_np(run_turns_np(b, turns)))


def test_fused_packed_routes_by_shape(monkeypatch):
    """A K1 board stays on K1; any other runs the fused sweeps; fuse <= 1
    is the native stepper; zero turns return the input."""
    calls = []
    monkeypatch.setattr(halo, "resident_run_turns",
                        lambda w, n, r: calls.append("K1") or w)
    monkeypatch.setattr(halo, "fused_banded_run_turns",
                        lambda w, n, k, r: calls.append(("B3", k)) or w)
    small, big = words(board(96, 256, 1)), words(board(1024, 1024, 2))
    halo.fused_packed_run_turns(small, 10, tl.CONWAY, 48)
    halo.fused_packed_run_turns(big, 10, tl.CONWAY, 48)
    halo.fused_packed_run_turns(big, 10, tl.CONWAY, 999)
    assert calls == ["K1", ("B3", 48), ("B3", 64)]
    monkeypatch.undo()
    assert halo.fused_packed_run_turns(big, 0, tl.CONWAY, 48) is big
    seen = _record_sweeps(monkeypatch)
    halo.fused_packed_run_turns(big, 40, tl.CONWAY, 1)
    assert seen == [("K2", 32), ("K2", 8)]


def test_fused_packed_other_rule_matches_jax():
    b = board(1000, 1024, seed=12)
    got = halo.fused_packed_run_turns(words(b), 41, tl.SEEDS, 40)
    want = jfused.fused_packed_run_turns(jbp.pack(b), 41, jl.SEEDS, 40,
                                         platform="cpu")
    assert np.array_equal(tbp.words_to_numpy(got), np.asarray(want))


# ------------------------------------------------------ Generations planes

def _planes(state, family):
    if family == "gen3":
        return tg.pack_state3(state), np.stack(
            [np.asarray(jbp.pack((state == 1).astype(np.uint8))),
             np.asarray(jbp.pack((state == 2).astype(np.uint8)))])
    b0, b1 = tg.pack_state4(state)
    return torch.stack([b0, b1]), np.stack(
        [tbp.words_to_numpy(b0), tbp.words_to_numpy(b1)])


@pytest.mark.parametrize("fuse", [8, 48])
@pytest.mark.parametrize("shape", [(64, 256), (512, 1024)])
@pytest.mark.parametrize("family,rule", [("gen3", "/2/3"),
                                         ("gen4", "345/2/4")])
def test_fused_planes_match_jax(family, rule, shape, fuse):
    """Brian's Brain and Star Wars on planes K4 holds (64 x 256) and on
    planes above its 58,112 bytes (512 x 1024, K5): the planes' native
    dispatcher is the port's fused run at every depth, as the TPU branch
    of the JAX functions is."""
    rng = np.random.default_rng(fuse + shape[0])
    states = 3 if family == "gen3" else 4
    state = rng.integers(0, states, size=shape).astype(np.uint8)
    port, jax_in = _planes(state, family)
    turns = 2 * fuse + 5
    jax_fn = (jfused.fused_gen3_run_turns if family == "gen3"
              else jfused.fused_gen4_run_turns)
    got = halo.planes_run_turns(port, turns, tg.GenerationsRule(rule),
                                family)
    want = jax_fn(jnp.asarray(jax_in), turns, jg.GenerationsRule(rule),
                  fuse, platform="cpu")
    assert np.array_equal(tbp.words_to_numpy(got), np.asarray(want))
    assert halo.planes_run_turns(port, 0, tg.GenerationsRule(rule),
                                 family) is port


# ---------------------------------------------------------------- engine

@pytest.mark.parametrize("fuse,want", [(48, [("K6", 48), ("K2", 2)]),
                                       (8, [("K2", 8)] * 6 + [("K2", 2)])])
def test_fused_run_fn_pins_its_depth(fuse, want, monkeypatch):
    """The engine's `(cells, num_turns, rule)` run sweeps at its depth."""
    seen = _record_sweeps(monkeypatch)
    b = board(1000, 1024, seed=fuse)
    got = halo.fused_run_fn(fuse)(words(b), 50, tl.CONWAY)
    assert seen == want
    assert np.array_equal(tbp.words_to_numpy(got),
                          tbp.pack_np(run_turns_np(b, 50)))


def _stage(tmp_path, b):
    d = tmp_path / "images"
    d.mkdir(exist_ok=True)
    h, w = b.shape
    write_pgm(str(d / f"{w}x{h}.pgm"), b * 255)
    return str(d)


def test_engine_fuse_48_matches_jax_engine_and_oracle(tmp_path,
                                                      monkeypatch):
    """GOL_FUSE_K=48 through `run` on a 1024² board (above K1) to turn
    100, which 48 does not divide, against the JAX engine under the same
    env and the numpy oracle: final board bytes and alive count."""
    monkeypatch.setenv("GOL_FUSE_K", "48")
    b = board(1024, 1024, seed=48)
    images = _stage(tmp_path, b)
    turns = 100
    eng = Engine(device="cpu")
    q = queue.Queue()
    t = gol_tpu_torch.run(Params(threads=1, image_width=1024,
                                 image_height=1024, turns=turns), q, None,
                          engine=eng, images_dir=images,
                          out_dir=str(tmp_path / "port"))
    evs = ev.drain(q)
    t.join(60)
    jq = queue.Queue()
    gol_tpu.run(gol_tpu.Params(threads=1, image_width=1024,
                               image_height=1024, turns=turns), jq, None,
                engine=JaxEngine(), images_dir=images,
                out_dir=str(tmp_path / "jax"))
    jevs = jev.drain(jq)
    name = f"1024x1024x{turns}.pgm"
    assert (tmp_path / "port" / name).read_bytes() == \
        (tmp_path / "jax" / name).read_bytes()
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    jfinal = [e for e in jevs if isinstance(e, jev.FinalTurnComplete)][0]
    want = run_turns_np(b, turns)
    assert final.count() == jfinal.count() == int(want.sum())
    ys, xs = np.nonzero(want)
    assert set(final.alive) == set(zip(xs.tolist(), ys.tolist()))
    assert [k[-1] for k in eng._chunk_hints] == [48]


def test_engine_pinned_k_sets_sweep_depths(monkeypatch):
    """The engine's sweeps follow the pinned depth (K6 for 48, K2 for
    the chunk remainders); unpinned, K2 runs at its native 32."""
    seen = _record_sweeps(monkeypatch)
    world = board(1024, 1024, seed=3) * 255
    p = Params(threads=1, image_width=1024, image_height=1024, turns=100)
    monkeypatch.setenv("GOL_FUSE_K", "48")
    eng = Engine(device="cpu")
    fused_board, _ = eng.server_distributor(p, world)
    assert ("K6", 48) in seen
    assert all(t <= 48 and (tag == "K6") == (t > 32) for tag, t in seen)
    assert sum(t for _, t in seen) == 100
    seen.clear()
    monkeypatch.delenv("GOL_FUSE_K")
    plain_board, _ = Engine(device="cpu").server_distributor(p, world)
    assert seen and all(tag == "K2" and t <= 32 for tag, t in seen)
    assert np.array_equal(fused_board, plain_board)


@pytest.mark.parametrize("width,fuse_eff", [(1024, 16), (1000, 1)])
def test_engine_fuse_eff_keys_the_chunk_hint(width, fuse_eff, monkeypatch):
    """Packed boards apply the pinned depth; u8 boards (a width that is
    not a whole number of words) have no fused tier: fuse_eff = 1."""
    monkeypatch.setenv("GOL_FUSE_K", "16")
    world = board(40, width, seed=width) * 255
    eng = Engine(device="cpu")
    got, _ = eng.server_distributor(
        Params(threads=1, image_width=width, image_height=40, turns=21),
        world)
    assert [k[-1] for k in eng._chunk_hints] == [fuse_eff]
    assert np.array_equal(got // 255, run_turns_np(world // 255, 21))


@pytest.mark.parametrize("rule", ["/2/3", "23/36/8"])
def test_engine_generations_fuse_matches_jax_engine(rule, monkeypatch):
    """gen3 planes keep their native run at fuse_eff = k; gen8 boards
    keep fuse_eff = 1; both equal the JAX engine under the same env."""
    monkeypatch.setenv("GOL_FUSE_K", "8")
    trule, jrule = tg.GenerationsRule(rule), jg.GenerationsRule(rule)
    rng = np.random.default_rng(8)
    state = rng.integers(0, trule.states, size=(64, 128)).astype(np.uint8)
    world = tg.to_pixels_gen(state, trule)
    eng, jeng = Engine(device="cpu", rule=trule), JaxEngine(rule=jrule)
    got, turn = eng.server_distributor(
        Params(threads=1, image_width=128, image_height=64, turns=37), world)
    want, jturn = jeng.server_distributor(
        gol_tpu.Params(threads=1, image_width=128, image_height=64,
                       turns=37), world)
    assert turn == jturn == 37
    assert np.array_equal(got, np.asarray(want))
    assert [k[-1] for k in eng._chunk_hints] == [
        8 if trule.states == 3 else 1]
