"""The port's SLO layer (`gol_tpu_torch/obs/slo.py`) against `gol_tpu`'s
(`tests/test_slo.py`'s cases): the log-bucket estimator's one-bucket
error bound on adversarial distributions, out-of-range clamping,
batch/loop equivalence, `percentile` and `reset`, thread safety, exact
percentiles; the measurement window (`reset`, then `observe_rpc`, then
`flush` and `rpc_snapshot`) fed the same observations in both packages,
with equal estimators, percentiles, snapshots and `gol_rpc_latency_ms`
gauges; the handler / wait / client split through a live port fleet
server; breach metering; hostile method names; and the port's load
generator, small-N, against a port fleet server. Same float arithmetic in
both packages: tolerance none."""

import threading
import time

import numpy as np
import pytest

from gol_tpu.obs import catalog as jcat
from gol_tpu.obs import slo as jslo
from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.fleet.engine import FleetEngine
from gol_tpu_torch.obs import catalog as obs_cat
from gol_tpu_torch.obs import flight as obs_flight
from gol_tpu_torch.obs import slo
from gol_tpu_torch.server import EngineServer
from gol_tpu_torch.tools import load_smoke

PAIRS = ((slo, obs_cat), (jslo, jcat))


@pytest.fixture
def slo_state():
    """Scope both packages' module-global estimator state to one test."""
    slo.reset()
    jslo.reset()
    yield
    slo.reset()
    jslo.reset()


@pytest.fixture
def fleet_server(monkeypatch):
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=FleetEngine(bucket_sizes=(64,),
                                          chunk_turns=2, slot_base=8,
                                          device="cpu"))
    srv.start_background()
    yield srv
    srv.engine.kill_prog()
    srv.shutdown()


# ------------------------------------------------- estimator error bound


def _adversarial_distributions():
    rng = np.random.default_rng(7)
    return {
        "uniform": rng.uniform(1e-4, 1.0, 5000),
        "lognormal": np.exp(rng.normal(-6.0, 2.0, 5000)),
        "bimodal": np.concatenate([rng.uniform(1e-4, 3e-4, 4500),
                                   rng.uniform(0.5, 1.0, 500)]),
        "constant": np.full(1000, 0.0123),
        "two-sample": np.array([2e-3, 0.2]),
    }


@pytest.mark.parametrize("name,values",
                         sorted(_adversarial_distributions().items()))
def test_estimator_within_one_bucket_width_and_equal(name, values):
    """For in-range samples the reported quantile brackets the exact one
    from above by at most one bucket width, and both packages report the
    same quantiles, `percentile`s and snapshot."""
    est, jest = slo.LogBucketEstimator(), jslo.LogBucketEstimator()
    est.observe_batch(values)
    jest.observe_batch(values)
    qs = (0.50, 0.95, 0.99)
    exact = slo.exact_percentiles(values, qs)
    assert exact == jslo.exact_percentiles(values, qs)
    got = est.percentiles(qs)
    assert got == jest.percentiles(qs)
    for q, e, g in zip(qs, exact, got):
        assert e <= g <= e * est.ratio * (1 + 1e-12), \
            f"{name} p{int(q * 100)}: exact={e} est={g} ratio={est.ratio}"
        assert est.percentile(q) == jest.percentile(q) == g
    assert est.snapshot() == jest.snapshot()
    assert est._counts == jest._counts


def test_estimator_clamps_out_of_range():
    """Below-lo samples report the first bucket's upper edge, above-hi
    the hi edge; NaN and negatives land in bucket 0. Both packages."""
    for mod in (slo, jslo):
        est = mod.LogBucketEstimator()
        est.observe_batch([1e-9] * 10)
        assert est.percentile(0.5) == pytest.approx(est.lo * est.ratio)
        est2 = mod.LogBucketEstimator()
        est2.observe_batch([1e9] * 10)
        assert est2.percentile(0.99) == est2.hi
        est3 = mod.LogBucketEstimator()
        est3.observe(float("nan"))
        est3.observe(-1.0)
        assert est3.count == 2
        assert est3.percentile(0.5) == pytest.approx(est3.lo * est3.ratio)
    assert slo.LogBucketEstimator().bucket_upper(0) == \
        jslo.LogBucketEstimator().bucket_upper(0)


def test_estimator_batch_matches_loop_and_reset():
    vals = [1e-3, 5e-3, 0.2, 7.0, 1e-5]
    snaps = []
    for mod in (slo, jslo):
        a, b = mod.LogBucketEstimator(), mod.LogBucketEstimator()
        a.observe_batch(vals)
        for v in vals:
            b.observe(v)
        assert a.snapshot() == b.snapshot()
        assert a.count == len(vals)
        snaps.append(a.snapshot())
        a.reset()
        assert a.count == 0 and a.sum == 0.0
        assert a.percentiles((0.5, 0.99)) == (None, None)
        assert a.percentile(0.5) is None
        a.observe(2e-3)
        assert a.count == 1 and sum(a._counts) == 1
        snaps.append(a.snapshot())
    assert snaps[:2] == snaps[2:]


def test_estimator_concurrent_observers_lose_nothing():
    est = slo.LogBucketEstimator()
    n, threads = 2000, 8

    def work(seed):
        for i in range(n):
            est.observe(1e-3 * (1 + (seed * n + i) % 50))

    ts = [threading.Thread(target=work, args=(s,)) for s in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert est.count == n * threads
    assert sum(est._counts) == n * threads


def test_exact_percentiles_rank_semantics():
    for mod in (slo, jslo):
        assert mod.exact_percentiles([], (0.5,)) == (None,)
        vals = list(range(1, 101))
        assert mod.exact_percentiles(vals, (0.50, 0.95, 0.99, 1.0)) \
            == (50, 95, 99, 100)
        assert mod.exact_percentiles([3.0], (0.5, 0.99)) == (3.0, 3.0)


# ----------------------------------------------- the measurement window


def _observations(seed):
    """(kind, method, seconds) triples: every kind, the cycle's methods,
    a lognormal spread of loopback-like latencies."""
    rng = np.random.default_rng(seed)
    methods = load_smoke.CYCLE_METHODS + ("Ping",)
    out = []
    for i in range(600):
        out.append((obs_cat.RPC_KINDS[i % 3], methods[i % len(methods)],
                    float(np.exp(rng.normal(-6.5, 1.0)))))
    return out


def _gauges(cat, snap):
    return {(k, m, q): cat.RPC_LATENCY_MS.labels(kind=k, method=m,
                                                 q=q).value
            for k, ms in snap.items() for m in ms
            for q in cat.SLO_QUANTILES}


def test_window_reset_snapshot_and_gauges_equal(slo_state):
    """One window of the same observations through both packages: equal
    `rpc_snapshot`s ({kind: {method: snapshot}}) and equal published
    gauges; `reset` empties the window in both, and the next window
    holds only its own observations."""
    for seed in (1, 2):
        for mod, _ in PAIRS:
            for kind, method, s in _observations(seed):
                mod.observe_rpc(kind, method, s, now=0.0)  # no auto-flush
        snap, jsnap = slo.rpc_snapshot(), jslo.rpc_snapshot()
        assert snap == jsnap
        assert set(snap) == set(obs_cat.RPC_KINDS)
        assert sum(row["count"] for ms in snap.values()
                   for row in ms.values()) == 600
        for mod, _ in PAIRS:
            mod.flush(now=123.0)
        gauges = _gauges(obs_cat, snap)
        assert gauges == _gauges(jcat, jsnap)
        for (k, m, q), v in gauges.items():
            assert v == round(snap[k][m][q] * 1e3, 3)
        for mod, _ in PAIRS:
            mod.reset()
            assert mod.rpc_snapshot() == {}
            assert mod._last_flush == 0.0 and mod._published == {}


def test_reset_waits_for_a_flush_in_progress(slo_state):
    """`reset` takes the flush lock, then the RPC lock: a flush that holds
    the flush lock finishes before the window is dropped."""
    slo.observe_rpc("client", "Ping", 1e-3, now=0.0)
    done = threading.Event()
    with slo._flush_lock:
        t = threading.Thread(target=lambda: (slo.reset(), done.set()))
        t.start()
        assert not done.wait(0.2)
        assert slo.rpc_snapshot()["client"]["Ping"]["count"] == 1
    t.join(5.0)
    assert done.is_set() and slo.rpc_snapshot() == {}


# ---------------------------------------------- rpc split through a server


def test_handler_wait_client_split_on_live_server(fleet_server,
                                                  slo_state):
    """Every wire method reports three latency kinds: client (round
    trip), handler (dispatch only), wait (accept -> dispatch). All three
    see the same Ping traffic, and the handler time does not exceed the
    client round trip by more than a bucket."""
    cli = RemoteEngine(f"127.0.0.1:{fleet_server.port}")
    for _ in range(8):
        cli.ping()
    # The server records its handler/wait sample after sending the
    # reply, so the 8th can still be in flight when the client returns.
    deadline = time.monotonic() + 5.0
    while True:
        slo.flush()
        snap = slo.rpc_snapshot()
        if all(snap.get(kind, {}).get("Ping", {}).get("count", 0) >= 8
               for kind in obs_cat.RPC_KINDS) \
                or time.monotonic() > deadline:
            break
        time.sleep(0.02)
    for kind in obs_cat.RPC_KINDS:
        assert snap[kind]["Ping"]["count"] >= 8, \
            f"kind={kind} missed the Ping traffic: {snap.get(kind)}"
    ratio = slo.LogBucketEstimator().ratio
    assert snap["handler"]["Ping"]["p50"] \
        <= snap["client"]["Ping"]["p50"] * ratio
    for kind in obs_cat.RPC_KINDS:
        for q in obs_cat.SLO_QUANTILES:
            assert obs_cat.RPC_LATENCY_MS.labels(
                kind=kind, method="Ping", q=q).value > 0.0


def test_breach_meters_counter_and_flight_event(slo_state, monkeypatch):
    """With a 1 ms p99 objective, a 500 ms sample breaches at flush: the
    counter increments and a slo.breach event lands in the flight ring;
    an idle window re-breaches nothing."""
    monkeypatch.setenv(slo.SLO_P99_ENV, "1.0")
    breach0 = obs_cat.RPC_SLO_BREACHES.labels(kind="client",
                                              method="Ping").value
    slo.observe_rpc("client", "Ping", 0.5, now=0.0)
    slo.flush()
    assert obs_cat.RPC_SLO_BREACHES.labels(
        kind="client", method="Ping").value == breach0 + 1
    evs = [e for e in obs_flight.FLIGHT.snapshot("test")["events"]
           if e.get("event") == "slo.breach"]
    assert evs, "no slo.breach event in the flight ring"
    last = evs[-1]
    assert last["kind"] == "client" and last["method"] == "Ping"
    assert last["p99_ms"] > last["objective_ms"] == 1.0
    slo.flush()
    assert obs_cat.RPC_SLO_BREACHES.labels(
        kind="client", method="Ping").value == breach0 + 1


def test_hostile_method_names_clamp_to_unknown(slo_state):
    for mod, _ in PAIRS:
        mod.observe_rpc("client", "EvilMethod'; DROP", 1e-3, now=0.0)
    assert list(slo.rpc_snapshot()["client"]) == ["unknown"]
    assert slo.rpc_snapshot() == jslo.rpc_snapshot()


# -------------------------------------------------- load generator, small-N


def test_load_smoke_small_n_against_live_fleet(fleet_server):
    """Two clients, two full create/attach/view/flag/destroy cycles each
    through the port's tool: zero errors, every method sampled, positive
    p50/p99, and every cycle destroyed its run."""
    res = load_smoke.run_load(f"127.0.0.1:{fleet_server.port}",
                              clients=2, cycles=2, board=64,
                              view_cells=1024)
    assert res["errors"] == []
    for method in load_smoke.CYCLE_METHODS:
        assert len(res["samples"][method]) == 4, \
            f"{method}: {len(res['samples'][method])} samples"
    summary = load_smoke.summarize(res["samples"])
    for method, row in summary.items():
        assert row["count"] == 4
        assert 0.0 < row["p50_ms"] <= row["p99_ms"] <= row["max_ms"]
    assert fleet_server.engine.runs_summary()["resident"] == 0
