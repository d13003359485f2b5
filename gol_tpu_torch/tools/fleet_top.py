"""fleet-top: a terminal dashboard for the fleet telemetry plane.

Polls a federation router's GetTelemetry / GetAudit wire methods and
renders, once per interval:

  * the fleet rollup line — resident runs, aggregate CUPS, queue
    depth, staleness p99, imbalance ratio, live/dead member counts;
  * a per-member table from the registry's snapshot states;
  * active alerts (rule + how long they have been firing);
  * the tail of the gol-fleet-audit/1 log (newest last), streamed
    incrementally by `since_seq` so each frame only fetches records
    it has not seen;
  * with `--journal-run RUN_ID`, that run's hash-chained gol-journal/1
    tail (GetJournal, proxied by the router to the run's owner) — the
    black box pane: chain head, last seq, newest events;
  * with `--usage`, the top-talkers pane: per-run device-time share,
    wire bytes in/out, broadcast bytes, plus the fleet usage rollup and
    capacity headroom rows from GetUsage/GetTelemetry.

    python -m gol_tpu_torch.tools.fleet_top --router HOST:PORT         # live
    python -m gol_tpu_torch.tools.fleet_top --router HOST:PORT --once  # one frame

`--once` prints a single frame and exits 0. Rendering is pure
(`render(doc, records)` returns a string, the JAX package's
`tools/fleet_top.py` frame for the same documents), so a caller can
also render a fetched doc in-process.
"""

from __future__ import annotations

import argparse
import sys
import time

from gol_tpu_torch.client import RemoteEngine


def _si(v: float) -> str:
    """1234567 -> '1.2M' — compact engineering notation."""
    for div, suffix in ((1e9, "G"), (1e6, "M"), (1e3, "k")):
        if abs(v) >= div:
            return f"{v / div:.1f}{suffix}"
    return f"{v:.0f}"


def render(doc: dict, records: list, now: float = None,
           journal: dict = None, usage: dict = None) -> str:
    """One dashboard frame from a GetTelemetry doc, an audit tail
    (oldest first), optionally one run's GetJournal tail, and
    optionally a member GetUsage doc. Pure string building — no I/O,
    no client."""
    if now is None:
        now = time.time()
    fleet = doc.get("fleet", {})
    lines = []
    lines.append(
        "fleet  runs={runs}  cups={cups}  queue={q}  "
        "stale_p99={st:.0f}ms  imbalance={imb:.2f}  "
        "members={live} live / {dead} dead".format(
            runs=fleet.get("runs_resident", 0),
            cups=_si(float(fleet.get("cups", 0.0))),
            q=fleet.get("queue_depth", 0),
            st=float(fleet.get("staleness_p99_ms", 0.0)),
            imb=float(fleet.get("imbalance_ratio", 1.0)),
            live=fleet.get("members_live", 0),
            dead=fleet.get("members_dead", 0)))
    tsdb = doc.get("tsdb", {})
    payload = doc.get("payload_bytes", {})
    lines.append(
        "plane  tsdb {series} series / {pts} pts  "
        "snap_p99={p99}B  audit_seq={seq}".format(
            series=tsdb.get("series", 0),
            pts=tsdb.get("points_total", 0),
            p99=payload.get("p99", "-"),
            seq=doc.get("audit_seq", 0)))
    lines.append("")

    members = doc.get("members", {})
    lines.append(f"{'MEMBER':<22} {'RUNS':>5} {'QUEUE':>6} "
                 f"{'CUPS':>8} {'STALE_P99':>10} {'SLO':>4}")
    for mid, row in sorted(members.items()):
        lines.append(
            f"{mid:<22} {row.get('resident', 0):>5} "
            f"{row.get('queue_depth', 0):>6} "
            f"{_si(float(row.get('cups', 0.0))):>8} "
            f"{row.get('staleness_p99_ms', 0.0):>8.0f}ms "
            f"{row.get('slo_breaches', 0):>4}")
    if not members:
        lines.append("  (no members reporting)")
    lines.append("")

    alerts = doc.get("alerts", {})
    active = alerts.get("active", {})
    if active:
        for rule, st in sorted(active.items()):
            since = float(st.get("since", now))
            lines.append(
                f"ALERT  {rule}  value={st.get('value')}  "
                f"firing {max(0.0, now - since):.0f}s")
    else:
        lines.append("alerts: none active")
    lines.append("")

    lines.append("audit (newest last):")
    for rec in records[-10:]:
        extra = " ".join(
            f"{k}={rec[k]}" for k in
            ("member", "run_id", "rule", "reason", "phase", "target")
            if k in rec)
        lines.append(f"  #{rec.get('seq', '?'):>4} "
                     f"{rec.get('kind', '?'):<16} {extra}")
    if not records:
        lines.append("  (empty)")

    if journal is not None:
        lines.append("")
        head = str(journal.get("head") or "")[:16]
        lines.append(
            f"journal {journal.get('run_id', '?')}  "
            f"seq={journal.get('seq', -1)}  head={head}…")
        for rec in journal.get("records", [])[-10:]:
            extra = " ".join(
                f"{k}={rec[k]}" for k in
                ("turn", "rule", "seed_kind", "reason", "repr")
                if k in rec)
            sha = str(rec.get("board_sha256", ""))[:10]
            if sha:
                extra = f"{extra} sha={sha}…" if extra else f"sha={sha}…"
            lines.append(f"  #{rec.get('seq', '?'):>4} "
                         f"{rec.get('kind', '?'):<12} {extra}")
        if journal.get("error"):
            lines.append(f"  (journal unavailable: {journal['error']})")
        elif not journal.get("records"):
            lines.append("  (no journal records)")

    if usage is not None:
        lines.append("")
        att = usage.get("attribution", {})
        fleet_use = fleet.get("usage", {})
        lines.append(
            "usage  tracked={trk}  attributed={att_s:.2f}s "
            "(err={err:.2f}%)  headroom={adm} runs / "
            "{hr} cups".format(
                trk=usage.get("runs_tracked", 0),
                att_s=float(att.get("attributed_s", 0.0)),
                err=float(att.get("error_pct", 0.0)),
                adm=fleet_use.get("admissible_runs",
                                  _best_admissible(usage)),
                hr=_si(float(fleet_use.get(
                    "cups_headroom", _sum_headroom(usage))))))
        top = usage.get("top", [])
        lines.append(f"{'RUN':<22} {'DEV_SHARE':>9} {'TURNS':>8} "
                     f"{'WIRE_IN':>8} {'WIRE_OUT':>9} {'BCAST':>8}")
        for row in top:
            lines.append(
                f"{str(row.get('run_id', '?'))[:22]:<22} "
                f"{row.get('share_pct', 0.0):>8.1f}% "
                f"{_si(float(row.get('turns', 0))):>8} "
                f"{_si(float(row.get('wire_in', 0))):>8}B "
                f"{_si(float(row.get('wire_out', 0))):>8}B "
                f"{_si(float(row.get('bc_bytes', 0) + row.get('sent_bytes', 0))):>7}B")
        if not top:
            lines.append("  (no talkers metered)")
        if usage.get("error"):
            lines.append(f"  (usage unavailable: {usage['error']})")
    return "\n".join(lines)


def _best_admissible(usage: dict) -> int:
    return max((int(r.get("admissible", 0))
                for r in usage.get("capacity", [])), default=0)


def _sum_headroom(usage: dict) -> float:
    return sum(float(r.get("cups_headroom", 0.0))
               for r in usage.get("capacity", []))


def fetch_frame(client: RemoteEngine, since_seq: int) -> tuple:
    """(telemetry_doc, new_audit_records) — one poll of the router."""
    doc = client.get_telemetry()
    records = client.get_audit(since_seq=since_seq, limit=200)
    return doc, records


def fetch_journal(router: str, run_id: str,
                  timeout: float = 10.0) -> dict:
    """One run's journal tail via the router (a run-scoped client so
    the run_id header routes GetJournal to the owning member). Errors
    render in-pane instead of killing the dashboard."""
    try:
        cli = RemoteEngine(router, timeout=timeout, run_id=run_id)
        j = cli.get_journal(limit=50)
        j["run_id"] = run_id
        return j
    except Exception as e:
        return {"run_id": run_id, "head": "", "seq": -1, "records": [],
                "error": f"{type(e).__name__}: {e}"}


def fetch_usage(client: RemoteEngine) -> dict:
    """One GetUsage poll. Errors render in-pane instead of killing
    the dashboard (a peer without GetUsage answers 'unknown method')."""
    try:
        return client.get_usage()
    except Exception as e:
        return {"runs_tracked": 0, "top": [],
                "error": f"{type(e).__name__}: {e}"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gol_tpu_torch.tools.fleet_top",
        description="terminal dashboard over GetTelemetry/GetAudit")
    ap.add_argument("--router", required=True,
                    help="federation router HOST:PORT")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh period, seconds (default 2)")
    ap.add_argument("--once", action="store_true",
                    help="print a single frame and exit (CI mode)")
    ap.add_argument("--journal-run", default="", metavar="RUN_ID",
                    help="also render RUN_ID's gol-journal/1 tail "
                         "(GetJournal via the router)")
    ap.add_argument("--usage", action="store_true",
                    help="also render the top-talkers pane "
                         "(GetUsage: device-time share, wire and "
                         "broadcast bytes per run)")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)

    client = RemoteEngine(args.router, timeout=args.timeout)
    seen_seq = 0
    tail: list = []
    try:
        while True:
            doc, fresh = fetch_frame(client, seen_seq)
            for rec in fresh:
                seen_seq = max(seen_seq, int(rec.get("seq", 0)))
            tail = (tail + fresh)[-200:]
            jrn = (fetch_journal(args.router, args.journal_run,
                                 timeout=args.timeout)
                   if args.journal_run else None)
            use = fetch_usage(client) if args.usage else None
            frame = render(doc, tail, journal=jrn, usage=use)
            if args.once:
                print(frame)
                return 0
            # Full-screen repaint: clear + home, then the frame.
            sys.stdout.write("\x1b[2J\x1b[H" + frame + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
