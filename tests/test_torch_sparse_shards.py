"""The port's row-sharded sparse window (`SparseTorus(mesh=)` over
`["cpu"] * n`, `SparseEngine(shards=n, devices=...)`), the counterparts
of `tests/test_sparse.py`'s mesh cases, held against the unsharded port
torus and `gol_tpu`'s sharded torus on the forced host devices, fed the
same cells:

  * over 2, 4 and 8 shards the window's shape, origin, margins, grows and
    cells equal the unsharded torus's and `gol_tpu`'s after every
    `run(k)`;
  * the sharded occupancy (K8 a shard, rows concatenated, columns summed)
    equals K8 of the gathered window;
  * the per-device budget divides over the shards; a shard count that
    does not divide 256 and the torus fails at construction and at
    restore;
  * a sharded `SparseEngine` run equals the unsharded one (turn, count,
    cells), and a checkpoint taken with either shard count restores onto
    the other, in either package.

Tolerance: none."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax
from gol_tpu.models import sparse as jsp
from gol_tpu.models.lifelike import CONWAY as J_CONWAY
from gol_tpu.params import Params as JParams
from gol_tpu.parallel.mesh import make_mesh as jmake_mesh
from gol_tpu.sparse_engine import SparseEngine as JSparseEngine

from gol_tpu_torch.models import sparse as tsp
from gol_tpu_torch.ops import cuda_stencil as cs
from gol_tpu_torch.params import Params
from gol_tpu_torch.parallel.mesh import make_mesh, shard
from gol_tpu_torch.ops.bitpack import words_from_numpy
from gol_tpu_torch.sparse_engine import SparseEngine

torch.set_num_threads(2)

BIG = 2**20
GLIDER = ((1, 0), (2, 1), (0, 2), (1, 2), (2, 2))


def cpus(n):
    return [torch.device("cpu")] * n


def tmesh(n):
    return make_mesh(n, devices=cpus(n))


def observe(t) -> tuple:
    return (t.turn, t.window_shape(), (t._ox, t._oy), t._margins(),
            t.grows, frozenset(t.alive_cells()), t.alive_count())


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in ("GOL_SPARSE_SHARDS", "GOL_SPARSE_MAX_BYTES", "GOL_CKPT",
              "GOL_MAX_CHUNK"):
        monkeypatch.delenv(k, raising=False)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_window_matches_unsharded_and_gol_tpu(n_shards):
    """The glider crosses window grows: after every run(k) the sharded
    window's geometry, margins, grows and cells equal the unsharded
    torus's, and `gol_tpu`'s sharded torus agrees on all it exposes."""
    start = [(x + 700, y + 700) for x, y in GLIDER]
    one = tsp.SparseTorus(BIG, start, device="cpu")
    many = tsp.SparseTorus(BIG, start, mesh=tmesh(n_shards))
    ref = jsp.SparseTorus(BIG, start, J_CONWAY,
                          mesh=jmake_mesh(n_shards,
                                          devices=jax.devices()[:n_shards]))
    for k in (100, 100, 200):
        for t in (one, many):
            t.run(k, macro=128)
        ref.run(k, macro=128)
        assert observe(many) == observe(one)
        assert many.turn == ref.turn
        assert many.window_shape() == ref.window_shape()
        assert (many._ox, many._oy) == (ref._ox, ref._oy)
        assert many._margins() == ref._margins()
        assert set(many.alive_cells()) == set(ref.alive_cells())
        assert many.alive_count() == ref.alive_count()
    assert many.grows > 0
    assert len(many._packed.shards) == n_shards


@pytest.mark.parametrize("n_shards", [2, 4])
def test_r_pentomino_sharded_geometry_every_run(n_shards):
    one = tsp.SparseTorus(BIG, [(x + 5000, y + 5000)
                                for x, y in tsp.R_PENTOMINO], device="cpu")
    many = tsp.SparseTorus(BIG, [(x + 5000, y + 5000)
                                 for x, y in tsp.R_PENTOMINO],
                           mesh=tmesh(n_shards))
    for k in (200, 300):
        one.run(k)
        many.run(k)
        assert observe(many) == observe(one)
    assert one.grows > 0


@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_sharded_occupancy_equals_k8_of_the_gathered_window(n_shards):
    rng = np.random.default_rng(n_shards)
    host = rng.integers(0, 2**32, size=(256, 64), dtype=np.uint32)
    host[:17] = 0
    host[:, 50:] = 0
    words = words_from_numpy(host)
    got = tsp.occupancy(shard(words, tmesh(n_shards)))
    assert torch.equal(got, cs.window_occupancy(words))


def test_sharded_window_divides_the_budget(monkeypatch):
    cells = [(500, 500), (501, 500), (502, 500)]
    monkeypatch.setenv("GOL_SPARSE_MAX_BYTES", str(40_000))
    with pytest.raises(RuntimeError, match="outgrown"):
        tsp.SparseTorus(BIG, cells, device="cpu")
    tsp.SparseTorus(BIG, cells, mesh=tmesh(8))  # 1/8th a device


def test_shard_count_must_divide_alignment():
    with pytest.raises(ValueError, match="must divide"):
        tsp.SparseTorus(BIG, [(5, 5), (6, 5), (7, 5)], mesh=tmesh(3))
    with pytest.raises(ValueError, match="must divide"):
        SparseEngine(BIG, shards=3, devices=cpus(3))
    with pytest.raises(ValueError, match="must divide"):
        tsp.SparseTorus._from_state(
            BIG, np.zeros((768, 8), dtype=np.uint32), 0, 0,
            mesh=tmesh(3))
    with pytest.raises(ValueError, match="does not split"):
        tsp.SparseTorus._from_state(
            BIG, np.zeros((100, 8), dtype=np.uint32), 0, 0,
            mesh=tmesh(8))


def test_shards_clamp_to_the_engine_devices(monkeypatch):
    assert SparseEngine(BIG, shards=4, device="cpu").stats()["devices"] == 1
    monkeypatch.setenv("GOL_SPARSE_SHARDS", "8")
    assert SparseEngine(BIG, devices=cpus(4)).stats()["devices"] == 4


def _seed():
    seed = np.zeros((8, 8), dtype=np.uint8)
    for x, y in tsp.R_PENTOMINO:
        seed[y + 2, x + 2] = 255
    return seed


def _torus_cells(eng) -> set:
    win, (ox, oy), _ = eng.get_window()
    ys, xs = np.nonzero(win)
    return {(int(x + ox) % BIG, int(y + oy) % BIG) for x, y in zip(xs, ys)}


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sparse_engine_sharded_run(monkeypatch, n_shards):
    """GOL_SPARSE_SHARDS shards the window behind the unchanged control
    surface: turn, count and torus cells equal the unsharded engine's and
    `gol_tpu`'s sharded engine's."""
    p = Params(threads=1, image_width=BIG, image_height=BIG, turns=300)
    one = SparseEngine(BIG, device="cpu")
    _, t1 = one.server_distributor(p, _seed())
    monkeypatch.setenv("GOL_SPARSE_SHARDS", str(n_shards))
    many = SparseEngine(BIG, devices=cpus(8))
    assert many.stats()["devices"] == n_shards
    assert many.geometry()["devices"] == n_shards
    _, tn = many.server_distributor(p, _seed())
    ref = JSparseEngine(BIG)
    _, tj = ref.server_distributor(
        JParams(threads=1, image_width=BIG, image_height=BIG, turns=300),
        _seed())
    assert t1 == tn == tj == 300
    assert one.alive_count() == many.alive_count() == ref.alive_count()
    assert _torus_cells(one) == _torus_cells(many) == _torus_cells(ref)
    for e in (one, many, ref):
        e.kill_prog()


@pytest.mark.parametrize("save_n,load_n", [(4, 1), (1, 4), (2, 8)])
def test_checkpoints_cross_shard_counts_in_either_package(tmp_path,
                                                           save_n, load_n):
    """A window checkpoint (`sparse{N}x{N}.npz`) taken over `save_n`
    shards restores over `load_n` in the port and in `gol_tpu` (and a
    `gol_tpu` one over `save_n` restores in the port), and each restored
    engine steps on to the same cells as an uninterrupted run."""
    p = Params(threads=1, image_width=BIG, image_height=BIG, turns=150)
    src = SparseEngine(BIG, shards=save_n, devices=cpus(8))
    src.server_distributor(p, _seed())
    path = str(tmp_path / f"sparse{BIG}x{BIG}.npz")
    src.save_checkpoint(path)
    jsrc = JSparseEngine(BIG, shards=save_n)
    jsrc.server_distributor(
        JParams(threads=1, image_width=BIG, image_height=BIG, turns=150),
        _seed())
    jpath = str(tmp_path / "jax.npz")
    jsrc.save_checkpoint(jpath)
    want = SparseEngine(BIG, device="cpu")
    want.server_distributor(
        Params(threads=1, image_width=BIG, image_height=BIG, turns=250),
        _seed())
    restored = []
    for ckpt in (path, jpath):
        eng = SparseEngine(BIG, shards=load_n, devices=cpus(8))
        assert eng.load_checkpoint(ckpt) == 150
        restored.append(eng)
    jeng = JSparseEngine(BIG, shards=load_n)
    assert jeng.load_checkpoint(path) == 150
    for eng in restored:
        assert _torus_cells(eng) == _torus_cells(src)
        _, turn = eng.server_distributor(
            Params(threads=1, image_width=BIG, image_height=BIG,
                   turns=100), None, start_turn=150)
        assert turn == 250
        assert _torus_cells(eng) == _torus_cells(want)
        assert eng.alive_count() == want.alive_count()
    _, jturn = jeng.server_distributor(
        JParams(threads=1, image_width=BIG, image_height=BIG, turns=100),
        None, start_turn=150)
    assert jturn == 250 and _torus_cells(jeng) == _torus_cells(want)
    for e in restored + [src, want, jsrc, jeng]:
        e.kill_prog()
