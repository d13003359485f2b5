"""The mesh and halo telemetry of the torch port (`obs/halostats.py`,
`obs/devstats.note_mesh`, the gol_halo_* and gol_mesh_* families) and the
mesh geometry on every surface (Stats over the wire, /healthz, the run
report, manifests), each against `gol_tpu`'s for the same dispatches
and runs. Tolerance: none."""

import json
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.engine import Engine as JEngine
from gol_tpu.obs import catalog as jcat
from gol_tpu.obs import devstats as jdevstats
from gol_tpu.obs import http as jhttp
from gol_tpu.ops.bitpack import pack as jpack
from gol_tpu.parallel import halo as jhalo
from gol_tpu.parallel.mesh import make_mesh as jmake_mesh
from gol_tpu.params import Params as JParams
from gol_tpu.server import EngineServer as JServer

from gol_tpu_torch.client import RemoteEngine as TRemote
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.obs import catalog as cat
from gol_tpu_torch.obs import devstats, halostats, trace
from gol_tpu_torch.obs import http as thttp
from gol_tpu_torch.ops.bitpack import pack_np, words_from_numpy
from gol_tpu_torch.params import Params
from gol_tpu_torch.parallel import halo
from gol_tpu_torch.parallel.mesh import make_mesh, shard
from gol_tpu_torch.server import EngineServer as TServer

torch.set_num_threads(2)

CPU = [torch.device("cpu")] * 8


def _cells(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, n)) < 0.3).astype(np.uint8)


def _both_on(n, size, seed):
    """The same packed board on a port mesh and a JAX mesh of n shards."""
    c = _cells(size, seed)
    mesh, jmesh = make_mesh(n, CPU), jmake_mesh(n)
    return (mesh, shard(words_from_numpy(pack_np(c)), mesh),
            jmesh, jhalo.shard_board(jpack(jnp.asarray(c)), jmesh))


def _family_values(c) -> dict:
    out = {}
    for a in ("rows", "cols"):
        out[("ex", a)] = c.HALO_EXCHANGES.labels(axis=a).value
        out[("by", a)] = c.HALO_BYTES.labels(axis=a).value
    out["fused"] = c.FUSED_DISPATCHES.labels(tier="mesh").value
    return out


def _deltas(c, before) -> dict:
    now = _family_values(c)
    return {k: now[k] - before[k] for k in now}


@pytest.mark.parametrize("fuse,turns", [(0, 64), (4, 64), (0, 33),
                                        (16, 48)])
def test_dispatch_counts_equal_jax_and_the_model(fuse, turns):
    """The counters' deltas for one direct dispatch equal the analytic
    model and gol_tpu's deltas; a fused one adds one 'mesh' dispatch;
    the per-turn gauges are set from this dispatch."""
    mesh, board, jmesh, jboard = _both_on(8, 256, seed=2)
    want = halo.halo_traffic("packed", tuple(board.shape), mesh, turns,
                             fuse)
    t0, j0 = _family_values(cat), _family_values(jcat)
    halo.sharded_packed_run_turns(board, turns, mesh, fuse=fuse)
    np.asarray(jhalo.sharded_packed_run_turns(jboard, turns, jmesh,
                                              fuse=fuse))
    got = _deltas(cat, t0)
    assert got == _deltas(jcat, j0)
    assert (got[("ex", "rows")], got[("by", "rows")]) == want["rows"]
    assert got["fused"] == (1 if fuse > 1 else 0)
    for fam in ("HALO_EXCHANGES_PER_TURN", "HALO_BYTES_PER_TURN"):
        assert (getattr(cat, fam).labels(axis="rows").value
                == getattr(jcat, fam).labels(axis="rows").value)


def test_single_shard_dispatch_counts_nothing():
    mesh, board, _, _ = _both_on(1, 64, seed=3)
    r0 = cat.HALO_EXCHANGES.labels(axis="rows").value
    halo.sharded_packed_run_turns(board, 32, mesh)
    assert cat.HALO_EXCHANGES.labels(axis="rows").value == r0
    assert halo.halo_traffic("packed", (64, 2), mesh, 32) == {}


def test_measure_shard_imbalance_sets_gauge():
    mesh, board, _, _ = _both_on(8, 256, seed=4)
    out = halo.sharded_packed_run_turns(board, 32, mesh)
    ratio = halostats.measure_shard_imbalance(out)
    assert ratio is not None and ratio >= 1.0
    assert cat.SHARD_IMBALANCE.value == pytest.approx(ratio)
    assert halostats.measure_shard_imbalance(np.zeros(4)) is None


def test_halo_dispatch_span_only_when_armed(monkeypatch, tmp_path):
    mesh, board, _, _ = _both_on(8, 256, seed=5)
    monkeypatch.delenv("GOL_TRACE_SPANS", raising=False)
    monkeypatch.delenv("GOL_FLIGHT", raising=False)
    trace.TRACER.reset()
    halo.sharded_packed_run_turns(board, 32, mesh)
    assert "halo.dispatch" not in [
        r["name"] for r in trace.TRACER.finished_spans()]
    monkeypatch.setenv("GOL_TRACE_SPANS", str(tmp_path / "spans.json"))
    trace.TRACER.reset()
    halo.sharded_packed_run_turns(board, 32, mesh)
    spans = [r for r in trace.TRACER.finished_spans()
             if r["name"] == "halo.dispatch"]
    assert len(spans) == 1
    attrs = spans[0]["attrs"]
    assert attrs["shards"] == 8
    want = halo.halo_traffic("packed", tuple(board.shape), mesh, 32)
    assert (attrs["exchange_rounds"], attrs["halo_bytes"]) == want["rows"]
    trace.TRACER.reset()


def test_engine_run_stamps_mesh_like_gol_tpu(monkeypatch, tmp_path):
    """An 8-shard engine run: the run report's run_start, Stats, the
    cached /healthz fields and the gol_mesh_* gauges carry gol_tpu's
    geometry for the same run; the chunk walls drain into the halo
    histogram, and the rows counters grow by the model's count of each
    popped chunk."""
    from gol_tpu_torch.obs.timeline import read_report

    report = tmp_path / "run.jsonl"
    monkeypatch.setenv("GOL_RUN_REPORT", str(report))
    world = _cells(64, seed=6) * np.uint8(255)
    n0 = sum(h.count for h in cat.HALO_EXCHANGE_SECONDS.children().values())
    r0 = cat.HALO_EXCHANGES.labels(axis="rows").value
    eng = Engine(devices=CPU)
    eng.server_distributor(
        Params(threads=8, image_width=64, image_height=64, turns=256),
        world)
    monkeypatch.delenv("GOL_RUN_REPORT")
    jeng = JEngine()
    jeng.server_distributor(
        JParams(threads=8, image_width=64, image_height=64, turns=256),
        world)
    geom = {"devices": 8, "shards": 8, "axes": {"rows": 8}, "shape": [8]}
    start = [r for r in read_report(str(report))
             if r["event"] == "run_start"][0]
    assert (start["devices"], start["shards"], start["mesh_shape"],
            start["mesh_axes"]) == (8, 8, [8], {"rows": 8})
    assert eng.stats()["mesh"] == jeng.stats()["mesh"] == geom
    assert devstats.mesh_fields() == jdevstats.mesh_fields() == geom
    assert (devstats.healthz_fields()["mesh"]
            == jdevstats.healthz_fields()["mesh"] == geom)
    assert thttp.healthz_doc()["mesh"] == jhttp.healthz_doc()["mesh"]
    for c in (cat, jcat):
        assert c.MESH_DEVICES.value == 8 and c.MESH_SHARDS.value == 8
        assert c.MESH_AXIS_SIZE.labels(axis="rows").value == 8
        assert c.MESH_AXIS_SIZE.labels(axis="cols").value == 0
    assert sum(h.count for h in
               cat.HALO_EXCHANGE_SECONDS.children().values()) > n0
    chunks = [r["turns"] for r in read_report(str(report))
              if r["event"] == "chunk"]
    assert sum(chunks) == 256
    assert cat.HALO_EXCHANGES.labels(axis="rows").value - r0 == sum(
        halo.halo_traffic("packed", (64, 2), eng._mesh, k)["rows"][0]
        for k in chunks)


def test_note_mesh_ignores_empty_and_keeps_last():
    devstats.note_mesh({"devices": 4, "shards": 4, "axes": {"rows": 4},
                        "shape": [4]})
    devstats.note_mesh(None)
    devstats.note_mesh({})
    assert devstats.mesh_fields()["devices"] == 4


def test_bare_snapshot_manifest_carries_the_last_mesh(tmp_path):
    """A snapshot without a mesh of its own takes the last submitted
    run's geometry, as gol_tpu's writer does."""
    from gol_tpu_torch import ckpt

    devstats.note_mesh({"devices": 8, "shards": 8, "axes": {"rows": 8},
                        "shape": [8]})
    cells = _cells(16, seed=7)
    snap = ckpt.Snapshot(cells, "u8", 7, cells.shape, "B3/S23")
    path = ckpt.CheckpointWriter(str(tmp_path), run_id="meshtest",
                                 keep_last=3).write_sync(snap)
    with open(path, encoding="utf-8") as f:
        m = json.load(f)
    assert m["mesh"] == {"devices": 8, "shards": 8, "axes": {"rows": 8},
                         "shape": [8]}


def _stop(srv):
    srv.engine.kill_prog()
    srv.shutdown()
    try:  # wake an accept() that closing the socket left blocked
        socket.create_connection(("127.0.0.1", srv.port), timeout=1).close()
    except OSError:
        pass


def test_four_shard_stats_over_the_wire_equal_gol_tpu():
    """A SUB of 4 addresses driven through each package's client against
    the other package's server (each engine on 4 devices): the replies'
    boards, turns, counts and Stats' mesh and device fields agree."""
    servers = {"port": TServer(port=0, host="127.0.0.1",
                               engine=Engine(devices=CPU[:4])),
               "jax": JServer(port=0, host="127.0.0.1",
                              engine=JEngine(devices=jax.devices()[:4]))}
    threads = [s.start_background() for s in servers.values()]
    world = _cells(64, seed=8) * np.uint8(255)
    subs = [f"fake:{i}" for i in range(4)]
    got = {}
    try:
        for name, cls, params in (("port", JRemote, JParams),
                                  ("jax", TRemote, Params)):
            cli = cls(f"127.0.0.1:{servers[name].port}")
            out, turn = cli.server_distributor(
                params(threads=1, image_width=64, image_height=64,
                       turns=50), world, sub_workers=subs)
            stats = cli.stats()
            got[name] = (out.tobytes(), turn, cli.alive_count(),
                         {k: stats[k] for k in (
                             "turn", "running", "board", "alive",
                             "alive_turn", "packed", "rule", "devices",
                             "mesh")})
    finally:
        for s in servers.values():
            _stop(s)
        for t in threads:
            t.join(timeout=10)
    assert got["port"] == got["jax"]
    assert got["port"][3]["mesh"] == {"devices": 4, "shards": 4,
                                      "axes": {"rows": 4}, "shape": [4]}
