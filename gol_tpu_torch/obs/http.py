"""Optional HTTP endpoints: stdlib http.server, daemon thread — the
counterpart of `gol_tpu/obs/http.py`.

`start_metrics_server(port)` binds (port 0 = OS-assigned ephemeral) and
serves three read-only paths from in-process state:

  * `/metrics` (and `/`) — Prometheus text from the shared registry;
  * `/metrics.json` — the registry's dict snapshot, for tooling that
    would rather not parse exposition text;
  * `/healthz` — 200 + `{"run_id", "turn", "uptime_s", "runs", "slo",
    "device_kind", "live_bytes", "compile_count"}`, the liveness
    probe ("runs" summarizes fleet residency/admissions; "slo" is the
    fleet loop's cached health doc — staleness/queue-wait percentiles
    and the top-K worst-runs table, obs/slo.py): run_id
    identifies the process, turn proves the engine loop is advancing
    between polls, live_bytes/compile_count expose leak and
    recompile churn without a Prometheus scrape (both read the
    devstats cache — never a device sync);
  * `/profile` — GET returns the profile controller's status; POST
    (optionally `?turns=N`) arms an on-demand torch.profiler capture of
    the next N engine turns, 409 when no `--profile-dir` was given or
    a capture is already armed.

Returns the running server object — `.port` tells callers (and the
obs-smoke harness) where an ephemeral bind landed. The thread is a
daemon: it dies with the process and never blocks shutdown.
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from gol_tpu_torch.federation import registry as fed_registry
from gol_tpu_torch.obs import catalog, devstats
from gol_tpu_torch.obs import export as obs_export
from gol_tpu_torch.obs import flight as obs_flight
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs import usage as obs_usage
from gol_tpu_torch.obs.metrics import REGISTRY
from gol_tpu_torch.obs.prof import PROFILER, ProfileUnavailable

PROM_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"
JSON_CONTENT_TYPE = "application/json; charset=utf-8"

# Most recent server started in this process, so in-process harnesses
# can find the ephemeral port after main() returns.
_LAST: Optional["MetricsServer"] = None


def healthz_doc() -> dict:
    """The /healthz body (also used by tests without a socket)."""
    doc = {"run_id": obs_flight.RUN_ID,
           "turn": catalog.ENGINE_TURN.value,
           "uptime_s": round(obs_flight.uptime_s(), 3),
           # Fleet summary: resident/admitted/rejected run counts from
           # the registry — zeros on single-run engines.
           "runs": catalog.runs_doc()}
    # Fleet SLO health: the document the fleet loop's batched flush last
    # published. A cached reference read, so /healthz never takes an
    # engine lock or syncs a device; empty dict on single-run engines.
    doc["slo"] = obs_slo.fleet_health()
    doc.update(devstats.healthz_fields())
    # Federation member table: present only in a process running a router
    # registry. A cached-reference read, the same no-lock discipline as
    # the fleet health document.
    fed = fed_registry.active_doc()
    if fed is not None:
        doc["federation"] = fed
    # Fleet telemetry plane: the aggregator's rollups, absent on
    # processes that run no router.
    telemetry = obs_export.active_telemetry_doc()
    if telemetry:
        doc["telemetry"] = telemetry
    # Per-run usage & capacity attribution: the meter's doc, absent
    # while nothing has been metered.
    usage = obs_usage.usage_doc()
    if usage and (usage.get("runs_tracked") or usage.get("retired_runs")
                  or usage.get("capacity")):
        doc["usage"] = usage
    return doc


class _Handler(BaseHTTPRequestHandler):
    def _reply(self, body: bytes, ctype: str) -> None:
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server API)
        path = self.path.split("?", 1)[0]
        if path in ("/metrics", "/"):
            self._reply(REGISTRY.render_prometheus().encode("utf-8"),
                        PROM_CONTENT_TYPE)
        elif path == "/metrics.json":
            self._reply(
                json.dumps(REGISTRY.snapshot(), sort_keys=True,
                           default=str).encode("utf-8"),
                JSON_CONTENT_TYPE)
        elif path == "/healthz":
            self._reply(
                json.dumps(healthz_doc(), sort_keys=True).encode("utf-8"),
                JSON_CONTENT_TYPE)
        elif path == "/profile":
            self._reply(
                json.dumps(PROFILER.status(), sort_keys=True)
                .encode("utf-8"), JSON_CONTENT_TYPE)
        else:
            self.send_error(404)

    def do_POST(self):  # noqa: N802 (http.server API)
        path, _, query = self.path.partition("?")
        if path != "/profile":
            self.send_error(404)
            return
        turns = 0
        for kv in query.split("&"):
            k, _, v = kv.partition("=")
            if k == "turns":
                try:
                    turns = int(v)
                except ValueError:
                    self.send_error(400, "bad turns value")
                    return
        try:
            body = PROFILER.request(turns=turns, source="http")
        except ProfileUnavailable as e:
            payload = json.dumps({"error": str(e)}).encode("utf-8")
            self.send_response(409)
            self.send_header("Content-Type", JSON_CONTENT_TYPE)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)
            return
        self._reply(json.dumps(body, sort_keys=True).encode("utf-8"),
                    JSON_CONTENT_TYPE)

    def log_message(self, fmt, *args):  # silence per-request stderr spam
        pass


class MetricsServer:
    def __init__(self, port: int, host: str = "127.0.0.1") -> None:
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name=f"gol-metrics-:{self.port}", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}/metrics"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)


def start_metrics_server(port: int,
                         host: str = "127.0.0.1") -> MetricsServer:
    global _LAST
    srv = MetricsServer(port, host=host)
    _LAST = srv
    return srv


def last_server() -> Optional[MetricsServer]:
    return _LAST
