"""The port's fleet dashboard (`gol_tpu_torch/tools/fleet_top.py`)
against the JAX package's (`tools/fleet_top.py`): `render` gives the
same frame for the same telemetry, audit, journal and usage documents
(hand-made ones covering every pane and its empty and error forms, and
the documents a port router serves), and `--once` prints one frame and
exits 0 against an in-process port router."""

import contextlib
import io

import pytest

from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.federation.router import FederationRouter
from gol_tpu_torch.tools import fleet_top as ptool
from tools import fleet_top as jtool

NOW = 1_700_000_100.0

TELEMETRY = {
    "fleet": {"runs_resident": 12, "cups": 3.25e11, "queue_depth": 4,
              "staleness_p99_ms": 41.6, "imbalance_ratio": 1.37,
              "members_live": 2, "members_dead": 1,
              "usage": {"admissible_runs": 40, "cups_headroom": 9.5e10}},
    "tsdb": {"series": 17, "points_total": 4096},
    "payload_bytes": {"p99": 2048},
    "audit_seq": 88,
    "members": {
        "127.0.0.1:8094": {"resident": 7, "queue_depth": 1,
                           "cups": 2.1e11, "staleness_p99_ms": 12.0,
                           "slo_breaches": 0},
        "127.0.0.1:8093": {"resident": 5, "queue_depth": 3,
                           "cups": 1.15e11, "staleness_p99_ms": 41.6,
                           "slo_breaches": 2}},
    "alerts": {"active": {
        "member-death": {"since": NOW - 12.4, "value": 1},
        "queue-depth": {"since": NOW + 5, "value": 4}}},
}
AUDIT = [{"seq": i, "kind": kind, **extra} for i, (kind, extra) in
         enumerate([("member_join", {"member": "127.0.0.1:8093"}),
                    ("place", {"run_id": "a", "member": "127.0.0.1:8093"}),
                    ("member_death", {"member": "127.0.0.1:8095",
                                      "reason": "heartbeat"}),
                    ("adopt", {"run_id": "b", "target": "127.0.0.1:8094"}),
                    ("alert_fired", {"rule": "member-death"}),
                    ("migrate", {"run_id": "c", "phase": "commit"})] * 3,
                   start=1)]
JOURNAL = {"run_id": "a", "head": "ab" * 32, "seq": 41, "records": [
    {"seq": 37, "kind": "create", "turn": 0, "rule": "B3/S23",
     "seed_kind": "soup", "board_sha256": "cd" * 32, "repr": "packed"},
    {"seq": 38, "kind": "rule", "turn": 8, "rule": "B36/S23"},
    {"seq": 39, "kind": "digest", "turn": 16, "board_sha256": "ef" * 32,
     "repr": "packed"},
    {"seq": 40, "kind": "pause"},
    {"seq": 41, "kind": "restore", "turn": 12, "reason": "restore",
     "board_sha256": "01" * 32}]}
USAGE = {"runs_tracked": 3,
         "attribution": {"attributed_s": 12.3456, "error_pct": 0.42},
         "top": [{"run_id": "a-run-with-a-very-long-identifier",
                  "share_pct": 61.25, "turns": 1.2e7, "wire_in": 2048,
                  "wire_out": 5.5e6, "bc_bytes": 1.0e5, "sent_bytes": 7},
                 {"run_id": "b", "share_pct": 38.75, "turns": 900}],
         "capacity": [{"admissible": 7, "cups_headroom": 1.5e9},
                      {"admissible": 11, "cups_headroom": 2.5e9}]}

CASES = {
    "empty": ({}, [], None, None),
    "full": (TELEMETRY, AUDIT, JOURNAL, USAGE),
    "usage-from-capacity": (
        {k: v for k, v in TELEMETRY.items() if k != "fleet"}, AUDIT[:2],
        None, USAGE),
    "journal-error": (TELEMETRY, [], {"run_id": "x", "head": "", "seq": -1,
                                      "records": [],
                                      "error": "KeyError: 'x'"}, None),
    "journal-empty": (TELEMETRY, [], {"run_id": "x", "head": None,
                                      "seq": -1, "records": []}, None),
    "usage-error": (TELEMETRY, [], None,
                    {"runs_tracked": 0, "top": [],
                     "error": "RuntimeError: unknown method"}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_equals_the_jax_frame(case):
    doc, records, journal, usage = CASES[case]
    got = ptool.render(doc, records, now=NOW, journal=journal, usage=usage)
    want = jtool.render(doc, records, now=NOW, journal=journal, usage=usage)
    assert got == want
    assert got.splitlines()[0].startswith("fleet  runs=")


def test_helpers_equal_the_jax_tool():
    for v in (0, 999, 1000, 1.5e6, -2.5e9, 7.25e12):
        assert ptool._si(v) == jtool._si(v)
    assert ptool._best_admissible(USAGE) == jtool._best_admissible(USAGE)
    assert ptool._sum_headroom(USAGE) == jtool._sum_headroom(USAGE)


def test_once_against_a_port_router():
    """`--once` prints one frame and exits 0 against an in-process port
    router, and the documents it serves render alike in both tools."""
    router = FederationRouter(port=0).start_background()
    try:
        address = f"127.0.0.1:{router.port}"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ptool.main(["--router", address, "--once"])
        assert rc == 0
        frame = buf.getvalue()
        assert frame.startswith("fleet  runs=0") and "members=0 live" in frame
        assert "(no members reporting)" in frame
        doc, records = ptool.fetch_frame(RemoteEngine(address, timeout=5.0),
                                         0)
        assert ptool.render(doc, records, now=NOW) == jtool.render(
            doc, records, now=NOW)
    finally:
        router.shutdown()


def test_journal_and_usage_panes_from_a_port_fleet_member(tmp_path,
                                                         monkeypatch):
    """The journal and top-talkers panes over a port `--fleet` member's
    GetJournal and GetUsage: `--once` exits 0 with both panes, and the
    fetched documents render alike in both tools."""
    from gol_tpu_torch import journal
    from gol_tpu_torch.fleet.engine import FleetEngine
    from gol_tpu_torch.server import EngineServer

    monkeypatch.setenv("GOL_JOURNAL", str(tmp_path / "j"))
    journal.reset()
    srv = EngineServer(port=0, host="127.0.0.1", engine=FleetEngine(
        bucket_sizes=(64,), chunk_turns=2, slot_base=2, device="cpu"))
    srv.start_background()
    try:
        address = f"127.0.0.1:{srv.port}"
        client = RemoteEngine(address, timeout=10.0)
        client.create_run(64, 64, run_id="top1", target_turn=8)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = ptool.main(["--router", address, "--once", "--journal-run",
                             "top1", "--usage"])
        assert rc == 0
        frame = buf.getvalue()
        assert "journal top1  seq=" in frame and "create" in frame
        assert "usage  tracked=" in frame
        doc, records = ptool.fetch_frame(client, 0)
        jrn = ptool.fetch_journal(address, "top1")
        use = ptool.fetch_usage(client)
        assert "error" not in jrn and "error" not in use
        assert ptool.render(doc, records, now=NOW, journal=jrn, usage=use) \
            == jtool.render(doc, records, now=NOW, journal=jrn, usage=use)
    finally:
        srv.shutdown()
        srv.engine.kill_prog()
        journal.reset()
