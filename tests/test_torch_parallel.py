"""Row sharding and halo exchange in the torch port
(`gol_tpu_torch/parallel/halo.py`, `mesh.py`) against the goldens and
`gol_tpu.parallel.halo` on an equal-width JAX mesh of virtual CPU
devices. The port's meshes name `torch.device("cpu")` once a shard.
Tolerance: none — boards bit-identical, counts and bytes equal."""

import queue
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.models.generations import BRIANS_BRAIN as J_BRIAN
from gol_tpu.models.generations import STAR_WARS as J_STARWARS
from gol_tpu.models.lifelike import CONWAY as J_CONWAY
from gol_tpu.obs import catalog as jcat
from gol_tpu.ops.bitpack import pack as jpack
from gol_tpu.parallel import halo as jhalo
from gol_tpu.parallel.mesh import make_mesh as jmake_mesh

import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.models.generations import (
    BRIANS_BRAIN,
    STAR_WARS,
    pack_state3,
)
from gol_tpu_torch.models.lifelike import CONWAY
from gol_tpu_torch.obs import catalog as tcat
from gol_tpu_torch.ops.bitpack import pack_np, words_from_numpy
from gol_tpu_torch.ops.reference import run_turns_np
from gol_tpu_torch.parallel import halo
from gol_tpu_torch.parallel.mesh import (
    ShardedBoard,
    make_mesh,
    mesh_geometry,
    resolve_shard_count,
    shard,
)
from gol_tpu_torch.utils.cell import read_alive_cells

torch.set_num_threads(2)

CPU = [torch.device("cpu")] * 16

SIZES_TURNS = [
    (16, 0), (16, 1), (16, 100),
    (64, 0), (64, 1), (64, 100),
    (512, 0), (512, 1), (512, 100),
]
# `tests/test_gol.py:25`'s sweep: non-divisors take the exact-N wrap
# extension; 12 and 16 clamp to the engine's 8 devices.
SHARDS = [1, 2, 3, 4, 5, 6, 7, 8, 12, 16]


def _soup(h, w, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < 0.3).astype(np.uint8)


def _states(h, w, states, seed=0):
    return np.random.default_rng(seed).integers(
        0, states, size=(h, w)).astype(np.uint8)


def _host(board: ShardedBoard) -> np.ndarray:
    """The gathered board as host numpy (packed words as uint32)."""
    out = board.gather().numpy()
    return out.view(np.uint32) if out.dtype == np.int32 else out


def _counts(mesh):
    return [torch.zeros(1, dtype=torch.int64) for _ in range(mesh.size)]


def _popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(np.ascontiguousarray(words).view(np.uint8)).sum())


def _halo_counters(cat) -> tuple:
    return tuple((cat.HALO_EXCHANGES.labels(axis=a).value,
                  cat.HALO_BYTES.labels(axis=a).value)
                 for a in ("rows", "cols"))


def _delta(before, after):
    return tuple((a[0] - b[0], a[1] - b[1]) for a, b in zip(before, after))


# ------------------------------------------------------ the contract sweep


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("size,turns", SIZES_TURNS)
def test_gol_sweep_matches_goldens(size, turns, shards, images_dir,
                                   check_dir, out_dir, monkeypatch):
    """`tests/test_gol.py`'s sweep through the port's `run`: SUB of 1-16
    addresses on an engine of 8 CPU devices; the final cells are the
    golden's, and the last published count is theirs."""
    monkeypatch.delenv("SER", raising=False)
    monkeypatch.delenv("CONT", raising=False)
    monkeypatch.setenv("SUB", ",".join(f"fake:{8030 + i}"
                                       for i in range(shards)))
    eng = Engine(devices=CPU[:8])
    q = queue.Queue()
    t = gol_tpu_torch.run(Params(threads=8, image_width=size,
                                 image_height=size, turns=turns),
                          q, None, engine=eng, images_dir=images_dir,
                          out_dir=out_dir)
    t.join(120)
    assert t.exception is None
    finals = [e for e in ev.drain(q) if isinstance(e, ev.FinalTurnComplete)]
    assert len(finals) == 1 and finals[0].completed_turns == turns
    want = {(c.x, c.y) for c in read_alive_cells(
        str(check_dir / "images" / f"{size}x{size}x{turns}.pgm"),
        size, size)}
    assert set(finals[0].alive) == want
    assert eng.alive_count() == (len(want), turns)
    n = min(shards, 8)
    assert eng.stats()["mesh"] == {"devices": n, "shards": n,
                                   "axes": {"rows": n}, "shape": [n]}


# ------------------------------------------- the packed ring against JAX


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("turns", [1, 3, 16, 48, 100])
def test_sharded_packed_matches_jax(n, turns):
    """Deep-halo macro-steps (T from `_deep_halo_T`) and the per-turn
    path: words, the shards' summed counts and the gol_halo_* deltas
    equal gol_tpu's for the same dispatch."""
    b = _soup(64, 64, seed=n * 100 + turns)
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    counts = _counts(mesh)
    t0, j0 = _halo_counters(tcat), _halo_counters(jcat)
    got = halo.sharded_packed_run_turns(
        shard(words_from_numpy(pack_np(b)), mesh), turns, mesh,
        CONWAY, count=counts)
    want = np.asarray(jhalo.sharded_packed_run_turns(
        jhalo.shard_board(jpack(jnp.asarray(b)), jmesh), turns, jmesh,
        J_CONWAY))
    np.testing.assert_array_equal(_host(got), want)
    assert sum(int(c) for c in counts) == _popcount(want)
    assert (_delta(t0, _halo_counters(tcat))
            == _delta(j0, _halo_counters(jcat)))


@pytest.mark.parametrize("fuse,n,h,turns", [
    (16, 4, 64, 64), (16, 8, 256, 48), (64, 4, 256, 128),
    (64, 2, 256, 100)])
def test_fused_depths_match_jax(fuse, n, h, turns):
    """GOL_FUSE_K's depth on a mesh: T = k when it divides the dispatch
    and fits the shard (64 runs K6's route), else the power-of-two
    fallback capped by k."""
    b = _soup(h, 64, seed=fuse + n)
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    counts = _counts(mesh)
    got = halo.sharded_packed_run_turns(
        shard(words_from_numpy(pack_np(b)), mesh), turns, mesh,
        CONWAY, fuse=fuse, count=counts)
    want = np.asarray(jhalo.sharded_packed_run_turns(
        jhalo.shard_board(jpack(jnp.asarray(b)), jmesh), turns, jmesh,
        J_CONWAY, fuse=fuse))
    np.testing.assert_array_equal(_host(got), want)
    assert sum(int(c) for c in counts) == _popcount(want)
    np.testing.assert_array_equal(
        _host(got), pack_np(run_turns_np(b, turns)))


def test_fused_route_runs_deep_windows():
    """At k = 64 over 4 shards of 64 rows the window is (192, 2) words:
    `window_kind` names K1 (it fits a cluster); a 4096-word-wide shard's
    window does not and takes K6."""
    assert halo.window_kind((192, 2), 64) == "resident"
    assert halo.window_kind((128 + 128, 4096), 64) == "deep"
    assert halo.window_kind((128 + 32, 4096), 16) == "tiled"


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("turns", [1, 5])
def test_sharded_u8_matches_jax(n, turns):
    """A 40-wide board (no whole words): the uint8 ring, one turn a
    halo exchange."""
    b = _soup(64, 40, seed=n + turns)
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    got = halo.sharded_run_turns(
        shard(torch.from_numpy(b), mesh), turns, mesh, CONWAY)
    want = np.asarray(jhalo.sharded_run_turns(
        jhalo.shard_board(jnp.asarray(b), jmesh), turns, jmesh, J_CONWAY))
    np.testing.assert_array_equal(_host(got), want)


@pytest.mark.parametrize("n", [2, 8])
def test_single_row_shards(n):
    """Shards of one row: both halos come from neighbours."""
    b = _soup(n, 64, seed=7)
    mesh = make_mesh(n, CPU)
    got = halo.sharded_packed_run_turns(
        shard(words_from_numpy(pack_np(b)), mesh), 5, mesh)
    np.testing.assert_array_equal(_host(got),
                                  pack_np(run_turns_np(b, 5)))


# --------------------------------------------------------------- exact-N


@pytest.mark.parametrize("h,n", [(64, 3), (64, 5), (64, 7), (24, 5),
                                 (16, 12)])
@pytest.mark.parametrize("packed", [True, False])
def test_exact_n_matches_jax(h, n, packed):
    """Heights the shard count does not divide: the wrap extension. Up
    to 8 shards against `gol_tpu`'s extended run on as many devices; 16
    rows over 12 (ext = 8: 4 shards of pad rows, cyclic) against the
    one-device run, since the JAX mesh has 8."""
    w = 64 if packed else 40
    b = _soup(h, w, seed=h * 31 + n)
    ext = halo.exact_shard_ext(h, n)
    assert ext == jhalo.exact_shard_ext(h, n) and (h + ext) % n == 0
    base = pack_np(b) if packed else b
    ebase = halo.extend_rows(base, ext)
    np.testing.assert_array_equal(ebase, jhalo.extend_rows(base, ext))
    mesh = make_mesh(n, CPU)
    host = words_from_numpy if packed else torch.from_numpy
    counts = _counts(mesh) if packed else None
    got = _host(halo.extended_run_turns(
        shard(host(ebase), mesh), 9, mesh, CONWAY, height=h,
        ext=ext, packed=packed, count=counts))
    if n <= 8:
        jmesh = jmake_mesh(n)
        want = np.asarray(jhalo.extended_run_turns(
            jhalo.shard_board(jnp.asarray(ebase), jmesh), 9, jmesh,
            J_CONWAY, height=h, ext=ext, packed=packed))
        np.testing.assert_array_equal(got, want)
    one = run_turns_np(b, 9)
    np.testing.assert_array_equal(got[:h], pack_np(one) if packed else one)
    if packed:
        assert sum(int(c) for c in counts) == int(one.sum())


# ------------------------------------------------------------ Generations


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_gen3_matches_jax(n):
    """Brian's Brain planes: the alive plane's 1-row halos a turn, K4/K5
    windows (their plain versions here); the count is the alive plane's."""
    s = _states(64, 64, 3, seed=n)
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    counts = _counts(mesh)
    t0, j0 = _halo_counters(tcat), _halo_counters(jcat)
    got = _host(halo.sharded_gen3_run_turns(
        shard(pack_state3(s), mesh), 7, mesh, BRIANS_BRAIN,
        count=counts))
    stacked = jnp.stack([jpack(jnp.asarray((s == 1).astype(np.uint8))),
                         jpack(jnp.asarray((s == 2).astype(np.uint8)))])
    want = np.asarray(jhalo.sharded_gen3_run_turns(
        jhalo.shard_board_gen3(stacked, jmesh), 7, jmesh, J_BRIAN))
    np.testing.assert_array_equal(got, want)
    assert sum(int(c) for c in counts) == _popcount(want[0])
    assert (_delta(t0, _halo_counters(tcat))
            == _delta(j0, _halo_counters(jcat)))


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_gen8_matches_jax(n):
    s = _states(64, 40, 4, seed=n + 1)
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    got = _host(halo.sharded_generations_run_turns(
        shard(torch.from_numpy(s), mesh), 6, mesh, STAR_WARS))
    want = np.asarray(jhalo.sharded_generations_run_turns(
        jhalo.shard_board(jnp.asarray(s), jmesh), 6, jmesh, J_STARWARS))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("h,n", [(17, 3), (23, 5), (2, 8)])
def test_exact_n_generations_match_jax(h, n):
    """The wrap extension for gen8 (Star Wars) and gen3 (Brian's Brain,
    both planes rebuilt), against `gol_tpu`'s extended runs."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    ext = halo.exact_shard_ext(h, n)
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    s8 = _states(h, 40, 4, seed=h)
    e8 = halo.extend_rows(s8, ext)
    got8 = _host(halo.extended_run_turns(
        shard(torch.from_numpy(e8), mesh), 11, mesh, STAR_WARS,
        height=h, ext=ext, packed="gen8"))
    want8 = np.asarray(jhalo.extended_run_turns(
        jax.device_put(e8, NamedSharding(jmesh, P("rows", None))), 11,
        jmesh, J_STARWARS, height=h, ext=ext, packed="gen8"))
    np.testing.assert_array_equal(got8, want8)
    s3 = _states(h, 64, 3, seed=h + 1)
    planes = np.stack([pack_np(s3 == 1), pack_np(s3 == 2)])
    e3 = halo.extend_rows(planes, ext, axis=1)
    counts = _counts(mesh)
    got3 = _host(halo.extended_run_turns(
        shard(words_from_numpy(e3), mesh), 11, mesh,
        BRIANS_BRAIN, height=h, ext=ext, packed="gen3", count=counts))
    want3 = np.asarray(jhalo.extended_run_turns(
        jax.device_put(e3, NamedSharding(jmesh, P(None, "rows", None))),
        11, jmesh, J_BRIAN, height=h, ext=ext, packed="gen3"))
    np.testing.assert_array_equal(got3, want3)
    assert sum(int(c) for c in counts) == _popcount(want3[0, :h])


# -------------------------------------------- policies and the traffic


TRAFFIC_CASES = [
    ("packed", (64, 2), 4, 16, 0), ("packed", (64, 2), 4, 33, 0),
    ("packed", (512, 16), 8, 100, 0), ("packed", (512, 16), 4, 128, 64),
    ("packed", (256, 2), 4, 96, 64), ("packed", (512, 16), 2, 50, 16),
    ("u8", (64, 40), 4, 5, 0), ("gen8", (64, 40), 2, 7, 0),
    ("gen3", (2, 64, 2), 8, 7, 0), ("packed", (64, 2), 1, 16, 0),
    ("packed", (64, 2), 4, 0, 0),
]


@pytest.mark.parametrize("repr_,shape,n,turns,fuse", TRAFFIC_CASES)
def test_halo_traffic_and_depths_equal_jax(repr_, shape, n, turns, fuse):
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    assert (halo.halo_traffic(repr_, shape, mesh, turns, fuse)
            == jhalo.halo_traffic(repr_, shape, jmesh, turns, fuse))
    rows = shape[-2] // n
    assert (halo._deep_halo_T(turns, rows)
            == jhalo._deep_halo_T(turns, rows))
    assert (halo.fused_halo_T(fuse, turns, rows)
            == jhalo.fused_halo_T(fuse, turns, rows))


def test_mesh_geometry_and_shard_policy_equal_jax():
    from gol_tpu.parallel.mesh import mesh_geometry as jgeom
    from gol_tpu.parallel.mesh import resolve_shard_count as jresolve

    for n in (1, 3, 8):
        assert mesh_geometry(make_mesh(n, CPU)) == jgeom(jmake_mesh(n))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for h, req in ((512, 8), (12, 8), (17, 8), (16, 5), (2, 8), (1, 8)):
            assert resolve_shard_count(h, req) == jresolve(h, req)


def test_one_card_clamps_to_one_shard():
    """An engine with one device runs a SUB of 4 as one shard, and
    says so in Stats, as gol_tpu's does on one device."""
    from gol_tpu.engine import Engine as JEngine
    from gol_tpu.params import Params as JParams

    world = _soup(64, 64, seed=5) * np.uint8(255)
    subs = [f"fake:{i}" for i in range(4)]
    eng = Engine(device="cpu")
    out, turn = eng.server_distributor(
        Params(threads=1, image_width=64, image_height=64, turns=9),
        world, sub_workers=subs)
    jeng = JEngine(devices=jax.devices()[:1])
    jout, jturn = jeng.server_distributor(
        JParams(threads=1, image_width=64, image_height=64, turns=9),
        world, sub_workers=subs)
    np.testing.assert_array_equal(out, jout)
    assert turn == jturn == 9
    got, want = eng.stats(), jeng.stats()
    assert got["devices"] == want["devices"] == 1
    assert got["mesh"] == want["mesh"] == {
        "devices": 1, "shards": 1, "axes": {"rows": 1}, "shape": [1]}


@pytest.mark.parametrize("rule,w", [("B3/S23", 64), ("B3/S23", 40),
                                    ("/2/3", 64), ("345/2/4", 40)])
def test_engine_exact_shards_match_jax_engine(rule, w):
    """The engine's family branches at a height 5 shards do not divide:
    the board each returns, the last published pair and the mesh."""
    from gol_tpu.engine import Engine as JEngine
    from gol_tpu.models import parse_rule as jparse
    from gol_tpu.params import Params as JParams
    from gol_tpu_torch.models import parse_rule

    from gol_tpu_torch.models.generations import (
        GenerationsRule,
        gray_levels,
    )

    rng = np.random.default_rng(w)
    trule = parse_rule(rule)
    levels = (gray_levels(trule) if isinstance(trule, GenerationsRule)
              else np.array([0, 255], dtype=np.uint8))
    world = levels[rng.integers(0, len(levels), size=(37, w))]
    eng = Engine(devices=CPU[:8], rule=trule)
    jeng = JEngine(rule=jparse(rule))
    out, turn = eng.server_distributor(
        Params(threads=5, image_width=w, image_height=37, turns=13), world)
    jout, jturn = jeng.server_distributor(
        JParams(threads=5, image_width=w, image_height=37, turns=13), world)
    np.testing.assert_array_equal(out, jout)
    assert turn == jturn == 13
    assert eng.alive_count() == jeng.alive_count()
    assert eng.stats()["mesh"] == jeng.stats()["mesh"]
    assert eng.stats()["board"] == [37, w]
    assert eng.get_world()[0].tobytes() == jeng.get_world()[0].tobytes()
