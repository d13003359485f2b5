"""The 2-D mesh in the torch port (`gol_tpu_torch/parallel/mesh2d.py`)
against `gol_tpu.parallel.mesh2d` on equal JAX meshes of virtual CPU
devices, and the engine's GOL_MESH fallbacks and warnings against
`gol_tpu`'s engine. Tolerance: none."""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.engine import Engine as JEngine
from gol_tpu.models.lifelike import CONWAY as J_CONWAY
from gol_tpu.models.lifelike import HIGHLIFE as J_HIGHLIFE
from gol_tpu.obs import catalog as jcat
from gol_tpu.ops.bitpack import pack as jpack
from gol_tpu.parallel import halo as jhalo
from gol_tpu.parallel import mesh2d as jm2
from gol_tpu.params import Params as JParams

from gol_tpu_torch.engine import Engine
from gol_tpu_torch.models.lifelike import CONWAY, HIGHLIFE
from gol_tpu_torch.obs import catalog as tcat
from gol_tpu_torch.ops.bitpack import pack_np, words_from_numpy
from gol_tpu_torch.ops.reference import run_turns_np
from gol_tpu_torch.params import Params
from gol_tpu_torch.parallel import halo, mesh2d
from gol_tpu_torch.parallel.mesh import shard

torch.set_num_threads(2)

CPU = [torch.device("cpu")] * 8


def _soup(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < 0.3).astype(np.uint8)


def _halo_counters(cat) -> tuple:
    return tuple((cat.HALO_EXCHANGES.labels(axis=a).value,
                  cat.HALO_BYTES.labels(axis=a).value)
                 for a in ("rows", "cols"))


def _run_both(b, shape, turns, rule=(CONWAY, J_CONWAY), fuse=0):
    mesh, jmesh = mesh2d.make_mesh2d(shape, CPU), jm2.make_mesh2d(shape)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(mesh.size)]
    t0, j0 = _halo_counters(tcat), _halo_counters(jcat)
    got = mesh2d.sharded_packed_run_turns_2d(
        shard(words_from_numpy(pack_np(b)), mesh), turns,
        mesh, rule[0], fuse, count=counts)
    want = np.asarray(jm2.sharded_packed_run_turns_2d(
        jm2.shard_board2d(jpack(jnp.asarray(b)), jmesh), turns, jmesh,
        rule[1], fuse))
    got = got.gather().numpy().view(np.uint32)
    np.testing.assert_array_equal(got, want)
    assert sum(int(c) for c in counts) == int(
        np.unpackbits(want.view(np.uint8)).sum())
    tdelta = [(a[0] - b_[0], a[1] - b_[1])
              for a, b_ in zip(_halo_counters(tcat), t0)]
    jdelta = [(a[0] - b_[0], a[1] - b_[1])
              for a, b_ in zip(_halo_counters(jcat), j0)]
    assert tdelta == jdelta
    return got


@pytest.mark.parametrize("shape", [(2, 2), (2, 4), (4, 2)])
@pytest.mark.parametrize("turns", [1, 16, 37])
def test_2d_matches_jax(shape, turns):
    """Rows then one word column from the row-extended windows; the
    windows' K1/K2 plain versions; the shards' own counts."""
    b = _soup(64, 256, seed=sum(shape) * turns)
    got = _run_both(b, shape, turns)
    np.testing.assert_array_equal(got, pack_np(run_turns_np(b, turns)))


@pytest.mark.parametrize("fuse", [8, 32, 64])
def test_2d_fuse_depths_match_jax(fuse):
    """A pinned depth: k up to 32 (the one-word halo) and the shard
    height; 64 caps at 32."""
    b = _soup(128, 256, seed=fuse)
    _run_both(b, (2, 4), 70, fuse=fuse)
    assert (mesh2d.macro_T_2d(64, fuse) == jm2.macro_T_2d(64, fuse)
            == min(fuse, 32))


def test_2d_single_word_columns_and_shallow_shards():
    _run_both(_soup(32, 128, seed=41), (2, 4), 20)
    _run_both(_soup(16, 256, seed=43), (2, 4), 24)
    _run_both(_soup(32, 256, seed=45), (2, 2), 10, (HIGHLIFE, J_HIGHLIFE))


def test_2d_traffic_equals_jax():
    for shape, h, wp, turns, fuse in (((2, 4), 64, 8, 37, 0),
                                      ((4, 2), 64, 8, 16, 8),
                                      ((2, 2), 1024, 32, 2048, 0)):
        mesh, jmesh = mesh2d.make_mesh2d(shape, CPU), jm2.make_mesh2d(shape)
        assert (halo.halo_traffic("packed", (h, wp), mesh, turns, fuse)
                == jhalo.halo_traffic("packed", (h, wp), jmesh, turns,
                                      fuse))


def test_2d_rejects_indivisible():
    """29 rows do not cut over 2 row shards; 3x3 needs 9 devices of 8."""
    mesh = mesh2d.make_mesh2d((2, 4), CPU)
    with pytest.raises(ValueError):
        shard(words_from_numpy(pack_np(_soup(29, 128))),
                             mesh)
    with pytest.raises(ValueError):
        mesh2d.make_mesh2d((3, 3), CPU)


MESH_CASES = [
    # (GOL_MESH, rule, height, width): each a fallback or the 2-D mesh
    ("2x2", "B3/S23", 64, 128),     # served
    ("2x4", "B3/S23", 64, 256),     # served
    ("abc", "B3/S23", 64, 64),      # not RxC
    ("0x2", "B3/S23", 64, 64),      # non-positive
    ("3x3", "B3/S23", 63, 96),      # 9 devices of 8
    ("2x2", "B3/S23", 64, 40),      # not whole words
    ("2x2", "B3/S23", 62, 64),      # rows do not tile
    ("2x2", "/2/3", 64, 64),        # Generations
    ("2x2", "R2,C0,M1,S2..3,B3..3,NM", 64, 64),  # conv, single-shard
]


def _warned(make, run) -> tuple:
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        eng = make()
        out, turn = run(eng)
    return out, turn, sorted({str(w.message) for w in rec
                              if "mesh" in str(w.message).lower()
                              or "shard" in str(w.message)}), eng


@pytest.mark.parametrize("spec,rule,h,w", MESH_CASES)
def test_gol_mesh_fallbacks_and_warnings_equal_jax(spec, rule, h, w,
                                                  monkeypatch):
    """GOL_MESH through both engines (8 devices each): the same board,
    the same warnings and the same mesh geometry."""
    from gol_tpu.models import parse_rule as jparse
    from gol_tpu_torch.models import parse_rule

    monkeypatch.setenv("GOL_MESH", spec)
    rng = np.random.default_rng(h + w)
    world = (rng.random((h, w)) < 0.3).astype(np.uint8) * np.uint8(255)
    out, turn, warned, eng = _warned(
        lambda: Engine(devices=CPU, rule=parse_rule(rule)),
        lambda e: e.server_distributor(
            Params(threads=1, image_width=w, image_height=h, turns=5),
            world))
    jout, jturn, jwarned, jeng = _warned(
        lambda: JEngine(rule=jparse(rule)),
        lambda e: e.server_distributor(
            JParams(threads=1, image_width=w, image_height=h, turns=5),
            world))
    np.testing.assert_array_equal(out, jout)
    assert turn == jturn == 5
    assert warned == jwarned
    assert eng.stats()["mesh"] == jeng.stats()["mesh"]
    assert eng.alive_count() == jeng.alive_count()
