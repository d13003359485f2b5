"""The port's load generator (`gol_tpu_torch/tools/load_smoke.py`)
against the JAX package's (`tools/load_smoke.py`):

  * both tools drive one port fleet server on the CPU with zero errors
    and exactly clients x cycles samples a method, and print summaries
    with the same keys;
  * the port's tool drives a JAX fleet server (the wire both ways);
  * `summarize` of the same seeded samples equals the JAX function's;
  * `--viewers`: every parked viewer is alive after `--hold` and bytes
    were drained, in the port's own server and in the JAX tool against
    the port's server;
  * exit codes: 0 on a clean run, 1 on an unreachable address, alike;
  * the server-side handler / queue-wait split of the load window, read
    through `obs.slo.rpc_snapshot` after `obs.slo.reset`.

Samples from seeded numpy; tolerance: none."""

import contextlib
import io
import json
import socket
import time

import numpy as np
import pytest

from gol_tpu.fleet.engine import FleetEngine as JFleetEngine
from gol_tpu.server import EngineServer as JEngineServer
from gol_tpu_torch.fleet.engine import FleetEngine
from gol_tpu_torch.obs import catalog as obs_cat
from gol_tpu_torch.obs import slo
from gol_tpu_torch.server import EngineServer
from gol_tpu_torch.tools import load_smoke as ptool
from tools import load_smoke as jtool


def _serve(pkg):
    if pkg == "jax":
        srv = JEngineServer(port=0, host="127.0.0.1", engine=JFleetEngine(
            bucket_sizes=(64,), chunk_turns=2, slot_base=8))
    else:
        srv = EngineServer(port=0, host="127.0.0.1", engine=FleetEngine(
            bucket_sizes=(64,), chunk_turns=2, slot_base=8, device="cpu"))
    srv.start_background()
    return srv


@pytest.fixture
def servers(monkeypatch):
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    made = []

    def make(pkg):
        made.append(_serve(pkg))
        return made[-1]
    yield make
    for srv in made:
        srv.engine.kill_prog()
        srv.shutdown()


def _main(tool, argv):
    """(rc, summary dict or None, stdout lines) of `tool.main(argv)`."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        rc = tool.main([str(a) for a in argv])
    lines = out.getvalue().splitlines()
    docs = [json.loads(ln) for ln in lines if ln.startswith("{")]
    return rc, (docs[0] if docs else None), lines


def _check_clean(res, clients, cycles):
    assert res["errors"] == []
    assert res["clients"] == clients and res["cycles"] == cycles
    for method in ptool.CYCLE_METHODS:
        assert len(res["samples"][method]) == clients * cycles, method


def test_both_tools_drive_the_port_server(servers):
    srv = servers("torch")
    addr = f"127.0.0.1:{srv.port}"
    assert ptool.CYCLE_METHODS == jtool.CYCLE_METHODS
    for tool in (ptool, jtool):
        _check_clean(tool.run_load(addr, clients=3, cycles=2, board=64,
                                   view_cells=1024), 3, 2)
    got = {}
    for name, tool in (("torch", ptool), ("jax", jtool)):
        rc, doc, lines = _main(tool, ["--address", addr, "--clients", 2,
                                      "--cycles", 2])
        assert rc == 0 and doc["errors"] == []
        assert lines[-1].startswith("load-smoke: OK — 2 client(s) x "
                                    "2 cycle(s) in ")
        for row in doc["methods"].values():
            assert row["count"] == 4
            assert 0.0 < row["p50_ms"] <= row["p99_ms"] <= row["max_ms"]
        got[name] = (sorted(doc), sorted(doc["methods"]),
                     {m: sorted(r) for m, r in doc["methods"].items()})
    assert got["torch"] == got["jax"]
    assert srv.engine.runs_summary()["resident"] == 0


def test_port_tool_drives_a_jax_server(servers):
    srv = servers("jax")
    addr = f"127.0.0.1:{srv.port}"
    _check_clean(ptool.run_load(addr, clients=2, cycles=2, board=64,
                                view_cells=1024), 2, 2)
    rc, doc, _ = _main(ptool, ["--address", addr, "--clients", 2,
                               "--cycles", 1])
    assert rc == 0 and doc["address"] == addr
    assert srv.engine.runs_summary()["resident"] == 0


def test_summarize_equals_gol_tpu():
    rng = np.random.default_rng(19)
    for n in (1, 2, 7, 64, 1000):
        samples = {m: list(np.exp(rng.normal(-6.0, 1.5, n)))
                   for m in ptool.CYCLE_METHODS[:-1]}
        samples["Other"] = [1.0]  # not a cycle method: left out
        assert ptool.summarize(samples) == jtool.summarize(samples)
    assert ptool.summarize({}) == jtool.summarize({}) == {}


def test_viewers_stay_alive_and_drain_bytes(servers):
    """The port's tool on its own CPU server and the JAX tool against a
    port server, each with parked viewers held for `--hold`."""
    rc, doc, lines = _main(ptool, ["--device", "cpu", "--clients", 2,
                                   "--cycles", 2, "--viewers", 24,
                                   "--hold", 0.5])
    srv = servers("torch")
    jrc, jdoc, jlines = _main(jtool, [
        "--address", f"127.0.0.1:{srv.port}", "--clients", 2,
        "--cycles", 2, "--viewers", 24, "--hold", 0.5])
    for rc, doc, lines in ((rc, doc, lines), (jrc, jdoc, jlines)):
        assert rc == 0, lines
        v = doc["viewers"]
        assert v["errors"] == [] and v["requested"] == 24
        assert v["stats"]["alive"] == 24 and v["stats"]["closed"] == 0
        assert v["stats"]["bytes"] > 0
        assert lines[-2].startswith("load-smoke: viewers OK — 24 "
                                    "subscriber(s) held 0.5s, ")
    assert sorted(doc) == sorted(jdoc)
    assert sorted(doc["viewers"]) == sorted(jdoc["viewers"])


def test_unreachable_address_exits_1_alike():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()  # nothing listens there now
    got = []
    for tool in (ptool, jtool):
        rc, doc, _ = _main(tool, ["--address", f"127.0.0.1:{port}",
                                  "--clients", 2, "--cycles", 1,
                                  "--timeout", 2])
        assert rc == 1 and len(doc["errors"]) == 2
        assert doc["methods"] == {}
        got.append(sorted(doc))
    assert got[0] == got[1]


def _split_when(n):
    """The window's `rpc_snapshot` and its (kind, method) counts, once
    every cycle method holds `n` samples of each kind (or after 10 s):
    the server records its handler and wait samples after the reply."""
    deadline = time.monotonic() + 10.0
    while True:
        slo.flush()
        split = slo.rpc_snapshot()
        counts = {(k, m): split.get(k, {}).get(m, {}).get("count", 0)
                  for k in obs_cat.RPC_KINDS for m in ptool.CYCLE_METHODS}
        if all(c >= n for c in counts.values()) \
                or time.monotonic() > deadline:
            return split, counts
        time.sleep(0.02)


def test_server_side_split_of_the_load_window(servers):
    """A warm cycle, then `slo.reset()` opens the window: the loaded
    window's handler and wait estimators hold exactly clients x cycles
    samples of each cycle method, as the client side does."""
    srv = servers("torch")
    addr = f"127.0.0.1:{srv.port}"
    slo.reset()
    assert ptool.run_load(addr, clients=1, cycles=1)["errors"] == []
    assert set(_split_when(1)[1].values()) == {1}
    slo.reset()
    res = ptool.run_load(addr, clients=3, cycles=2)
    _check_clean(res, 3, 2)
    split, counts = _split_when(6)
    assert set(counts.values()) == {6}, counts
    table = ptool.summarize(res["samples"])
    ratio = slo.LogBucketEstimator().ratio
    for m in ptool.CYCLE_METHODS:
        # A server's handler time is a slice of the client round trip.
        assert split["handler"][m]["p50"] * 1e3 <= \
            table[m]["max_ms"] * ratio
