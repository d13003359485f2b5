"""Remote engine client — the controller side of the control plane, the
counterpart of `gol_tpu/client.py`, its fleet half included (a client
bound to a fleet run stamps its `run_id` on every run-scoped call;
`create_run`, `list_runs`, `attach_run`, `destroy_run`, `set_rule`),
the live-view subscription (`subscribe` -> `ViewSubscription`, the
broadcast tier's push stream), the telemetry methods (`get_telemetry`,
`get_audit`, `get_usage`, `profile`) and live migration (`rescale`; a
"moved:" answer from a run's old member is a tagged transport error the
retry loop re-sends through the router).

Duck-typed to `Engine` (same method surface), so the controller does not
care whether its engine is in-process or remote, nor whether the server
behind `SER` is this package's or the JAX package's. Counterpart of the
reference controller's `rpc.DialHTTP` + `client.Call`
(`Local/gol/distributor.go:94,182`): one TCP connection per call;
`server_distributor` blocks on its connection for the whole run, like the
Go blocking `API.ServerDistributor` call.

Failure detection: while the blocking run call is outstanding, a
heartbeat watchdog pings the engine every GOL_HB_INTERVAL seconds over
separate connections; after GOL_HB_MISSES consecutive failures it closes
the run socket, turning a silent hang (partition, wedged host) into a
prompt ConnectionError the controller's reconnect logic acts on. A
server that answers pings with EngineKilled is deliberately down, not
lost: the watchdog stands down.
"""

from __future__ import annotations

import random
import socket
import threading
import time
import uuid
from typing import Optional, Sequence, Tuple

import numpy as np

from gol_tpu_torch import wire
from gol_tpu_torch.engine import EngineBusy, EngineKilled
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import flight as obs_flight
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs import trace
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.params import Params
from gol_tpu_torch.utils.envcfg import env_float, env_int
from gol_tpu_torch.wire import recv_msg, send_msg

HB_INTERVAL_ENV = "GOL_HB_INTERVAL"   # seconds between pings; 0 disables
HB_MISSES_ENV = "GOL_HB_MISSES"       # consecutive failures before loss
HB_INTERVAL_DEFAULT = 2.0
HB_MISSES_DEFAULT = 3

# Retry policy for one-shot RPCs through _call (the blocking
# ServerDistributor call has its own watchdog and is never retried): up
# to GOL_RPC_RETRIES re-attempts after a TRANSPORT failure (tagged with
# .rpc_error_kind by _call_once), under exponential backoff with jitter.
# Errors the server replied with are never retried: the request was
# delivered and answered.
RETRIES_ENV = "GOL_RPC_RETRIES"
RETRIES_DEFAULT = 2
RETRY_BACKOFF_BASE_S = 0.05
RETRY_BACKOFF_CAP_S = 2.0
# Per-method budgets that beat the env default: Ping is the heartbeat
# watchdog's loss probe (internal retries would stretch the detection
# window); KillProg's server may exit before replying by design.
METHOD_RETRY_BUDGETS = {"Ping": 0, "KillProg": 0}

# Methods that mutate server state: stamped with a client-generated
# req_id header (stable across retries) so the server's dedupe window
# makes a retry idempotent. Read-only methods are naturally safe.
MUTATING_METHODS = frozenset({
    "CreateRun", "DestroyRun", "SetRule", "Checkpoint", "CFput",
    "DrainFlags", "RestoreRun", "AbortRun", "Profile", "KillProg",
    "AdoptRun", "Rescale", "ReceiveRun", "CommitRun", "PinRun",
})


class GeometryRefused(RuntimeError):
    """The server refused a restore whose checkpoint geometry does not
    match its engine (mesh device count, sparse window). Tagged so
    callers can branch without string-matching; resend with
    reshard=True to route through the host-side canonical repack."""

    rpc_error_kind = "geometry"


class FramesNotDiffable(RuntimeError):
    """The server refused a delta-view request (basis_turn) because the
    board is not delta-codable (a float board of the JAX package).
    Recoverable: drop the cached basis and re-poll for a full frame."""

    rpc_error_kind = "nodiff"


def _dial(addr, timeout):
    """socket.create_connection behind the chaos dial hook: when
    GOL_CHAOS arms `refuse=p` the hook raises ConnectionRefusedError
    before the kernel ever dials."""
    if wire._chaos_enabled():
        from gol_tpu_torch import chaos
        chaos.dial_hook(f"{addr[0]}:{addr[1]}")
    return socket.create_connection(addr, timeout=timeout)


def _transport_error(msg: str, kind: str) -> ConnectionError:
    """A ConnectionError tagged with its transport-failure kind
    (timeout/refused/reset/protocol): the tag is what authorizes a retry
    and attributes the failure."""
    e = ConnectionError(msg)
    e.rpc_error_kind = kind
    return e


def _dial_tagged(addr, timeout, label: str) -> socket.socket:
    """_dial with its failures tagged by kind."""
    where = f"{addr[0]}:{addr[1]}"
    try:
        return _dial(addr, timeout)
    except (socket.timeout, TimeoutError) as e:
        raise _transport_error(
            f"connect timeout to {where} after {timeout}s ({label}): {e}",
            "timeout") from e
    except ConnectionRefusedError as e:
        raise _transport_error(
            f"connect refused by {where} ({label}): {e}", "refused") from e
    except OSError as e:
        raise _transport_error(
            f"connect to {where} failed ({label}): {e}", "refused") from e


def _check_resp(resp: dict):
    if not resp.get("ok"):
        err = resp.get("error", "unknown engine error")
        if err.startswith("killed:"):
            raise EngineKilled(err)
        if err.startswith("busy:"):
            raise EngineBusy(err)
        if err.startswith("overloaded:"):
            # The server shed this connection (cap reached): a transient
            # transport condition, not an engine state — surface it like
            # a network failure so the recovery paths apply.
            raise ConnectionError(err)
        if err.startswith("moved:"):
            # Live migration: the run left this member after the request
            # was relayed. A TAGGED transport error, so the retry loop
            # re-sends through the router, whose placement is already
            # pinned at the new owner: downtime is latency, never a
            # caller-visible error.
            raise _transport_error(err, "moved")
        if err.startswith("geometry:"):
            raise GeometryRefused(err)
        if err.startswith("nodiff:"):
            raise FramesNotDiffable(err)
        raise RuntimeError(f"engine error: {err}")
    return resp


class RemoteEngine:
    # Marks this engine as safe for the controller's lost-engine
    # recovery: ConnectionError/OSError from its calls mean the network
    # or the peer, not local engine internals.
    recoverable = True

    def __init__(self, address: str, timeout: float = 10.0,
                 run_id: str = None) -> None:
        host, _, port = address.rpartition(":")
        self._addr = (host or "localhost", int(port))
        self._timeout = timeout
        # Fleet run this client is bound to: stamped as the "run_id"
        # header on every call. None = the legacy single run (no header:
        # pre-fleet servers never see the key).
        self.run_id = run_id
        # Run-ownership token: lets abort_run() stop THIS controller's
        # orphaned run after a transient partition without being able to
        # touch another controller's run. It doubles as the GetView
        # "vkey" the server's delta cache is keyed by.
        self._token = uuid.uuid4().hex
        # Wire caps the server advertised in its last reply (empty until
        # the first RPC lands; the controller pings before any board
        # moves, so uploads negotiate in practice).
        self._peer_caps: frozenset = frozenset()
        self._view_basis = None  # (turn, fy, fx, pixels)
        # Set when the server refuses delta views ("nodiff:"): stop
        # declaring a basis on later polls.
        self._view_nodiff = False

    @property
    def peer_caps(self) -> frozenset:
        """Codecs the server advertised (intersected with SUPPORTED_CAPS);
        empty until a reply has been seen."""
        return self._peer_caps

    def _note_caps(self, resp) -> None:
        if isinstance(resp, dict) and isinstance(resp.get("caps"), list):
            self._peer_caps = wire.SUPPORTED_CAPS & frozenset(
                c for c in resp["caps"] if isinstance(c, str))

    def _call(self, header: dict, timeout=None, xrle_basis=None,
              world=None):
        label = obs.method_label(str(header.get("method")))
        header.setdefault("caps", sorted(wire.local_caps()))
        if self.run_id is not None:
            header.setdefault("run_id", self.run_id)
        if label in MUTATING_METHODS:
            # One id for ALL attempts of this logical request: a retry
            # whose first attempt already committed replays the cached
            # reply from the server's dedupe window.
            header.setdefault("req_id", uuid.uuid4().hex)
        # minimum=0: GOL_RPC_RETRIES=0 genuinely disables retries.
        budget = METHOD_RETRY_BUDGETS.get(
            label, env_int(RETRIES_ENV, RETRIES_DEFAULT, minimum=0))
        attempt = 0
        while True:
            try:
                resp, resp_world = self._call_once(
                    label, header, timeout, xrle_basis, world)
                self._note_caps(resp)
                # Inside the try: a server-replied error that _check_resp
                # turns into a TAGGED ConnectionError ("moved:") retries
                # like a transport failure; untagged ones ("overloaded:")
                # propagate unretried.
                _check_resp(resp)
            except ConnectionError as e:
                kind = getattr(e, "rpc_error_kind", None)
                if kind is None or attempt >= budget:
                    raise
                attempt += 1
                obs.CLIENT_RETRIES.labels(method=label).inc()
                obs_log("client.rpc_retry", level="warning", method=label,
                        kind=kind, attempt=attempt, error=str(e))
                delay = min(RETRY_BACKOFF_CAP_S,
                            RETRY_BACKOFF_BASE_S * (2 ** (attempt - 1)))
                time.sleep(delay * (0.5 + random.random() * 0.5))
                continue
            return resp, resp_world

    def _call_once(self, label: str, header: dict, timeout, xrle_basis,
                   world=None):
        """One connect+send+recv attempt. Transport failures surface as
        ConnectionError tagged with .rpc_error_kind (timeout / refused /
        reset / protocol)."""
        obs.CLIENT_REQUESTS.labels(method=label).inc()
        addr = f"{self._addr[0]}:{self._addr[1]}"
        t0 = time.monotonic()
        # The span sits on this thread's context stack while send_msg
        # runs, so the wire codec stamps its id into the header as "tc"
        # and the server handler span parents under it.
        with trace.span(f"rpc.{label}"):
            try:
                sock = _dial_tagged(self._addr, self._timeout, label)
                try:
                    wire.enable_nodelay(sock)
                    sock.settimeout(timeout)
                    try:
                        send_msg(sock, header, world)
                        resp, resp_world = recv_msg(sock,
                                                    xrle_basis=xrle_basis)
                    except wire.WireProtocolError as e:
                        e.rpc_error_kind = "protocol"
                        raise
                    except (socket.timeout, TimeoutError) as e:
                        raise _transport_error(
                            f"read timeout from {addr} after {timeout}s "
                            f"mid-{label}: {e}", "timeout") from e
                    except ConnectionError as e:
                        raise _transport_error(
                            f"connection reset by {addr} mid-{label}: "
                            f"{e}", "reset") from e
                    except OSError as e:
                        raise _transport_error(
                            f"socket error from {addr} mid-{label}: {e}",
                            "reset") from e
                finally:
                    sock.close()
            except (ConnectionError, OSError):
                obs.CLIENT_ERRORS.labels(method=label).inc()
                raise
            finally:
                t1 = time.monotonic()
                obs.CLIENT_REQUEST_SECONDS.labels(method=label).observe(
                    t1 - t0)
                # End-to-end observed latency: connect + send + server
                # service + receive.
                obs_slo.observe_rpc("client", label, t1 - t0, now=t1)
        return resp, resp_world

    # --- Engine interface -------------------------------------------------

    def server_distributor(
        self,
        params: Params,
        world: np.ndarray,
        sub_workers: Sequence[str] = (),
        start_turn: int = 0,
    ) -> Tuple[np.ndarray, int]:
        header = {
            "method": "ServerDistributor",
            "params": {
                "threads": params.threads,
                "image_width": params.image_width,
                "image_height": params.image_height,
                "turns": params.turns,
            },
            "sub_workers": list(sub_workers),
            "start_turn": start_turn,
            "token": self._token,
            "caps": sorted(wire.local_caps()),
        }
        if self.run_id is not None:
            header["run_id"] = self.run_id
        hb_interval = env_float(HB_INTERVAL_ENV, HB_INTERVAL_DEFAULT)
        hb_misses = env_int(HB_MISSES_ENV, HB_MISSES_DEFAULT)
        try:
            sock = _dial_tagged(self._addr, self._timeout,
                                "ServerDistributor")
        except ConnectionError:
            obs.CLIENT_ERRORS.labels(method="ServerDistributor").inc()
            raise
        wire.enable_nodelay(sock)
        # The run socket is idle for the whole run; without keepalive a
        # NAT or firewall can evict the flow while fresh ping connections
        # keep succeeding, a hang the watchdog cannot see.
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
        for opt, val in (("TCP_KEEPIDLE", 60), ("TCP_KEEPINTVL", 15),
                         ("TCP_KEEPCNT", 4)):
            if hasattr(socket, opt):
                sock.setsockopt(
                    socket.IPPROTO_TCP, getattr(socket, opt), val)
        stop = threading.Event()
        lost = threading.Event()

        # The blocking-run span: every watchdog probe parents under it,
        # and its id rides the wire so the server handler span joins the
        # same trace.
        run_span = trace.start(
            "rpc.ServerDistributor",
            attrs={"addr": f"{self._addr[0]}:{self._addr[1]}",
                   "turns": params.turns, "start_turn": start_turn})
        run_ctx = run_span.context()

        def watchdog() -> None:
            misses = 0
            while not stop.wait(hb_interval):
                with trace.span("hb.probe", parent=run_ctx) as probe:
                    try:
                        self.ping()
                        misses = 0
                    except (EngineKilled, RuntimeError):
                        return  # engine reachable (killed/errored ≠ lost)
                    except (ConnectionError, OSError):
                        misses += 1
                        probe.attrs["miss"] = misses
                        if misses >= hb_misses:
                            lost.set()
                            run_span.attrs["lost"] = True
                            obs_log("client.heartbeat_lost", level="error",
                                    misses=misses, interval_s=hb_interval)
                            obs_flight.FLIGHT.dump("watchdog")
                            try:
                                sock.shutdown(socket.SHUT_RDWR)
                            except OSError:
                                pass
                            sock.close()
                            return

        obs.CLIENT_REQUESTS.labels(method="ServerDistributor").inc()
        t0 = time.monotonic()
        trace.TRACER.push(run_span)
        try:
            sock.settimeout(None)  # block for the whole run
            # Watchdog up BEFORE the upload: a partition mid-send of a
            # large board would otherwise block the send with nothing
            # watching.
            if hb_interval > 0:
                threading.Thread(target=watchdog, daemon=True).start()
            frame = None
            if world is not None and self._peer_caps:
                # The server advertised caps on an earlier reply (the
                # controller's attach ping at the latest), so the seed
                # board uploads through the negotiated codec: a packed
                # board puts 8x fewer bytes up.
                frame = wire.encode_board(
                    world, self._peer_caps & wire.local_caps())
                world = None
            send_msg(sock, header, world, frame=frame)
            resp, out = recv_msg(sock)
        except (ConnectionError, OSError) as e:
            obs.CLIENT_ERRORS.labels(method="ServerDistributor").inc()
            if lost.is_set():
                raise ConnectionError(
                    f"engine heartbeat lost ({hb_misses} misses x "
                    f"{hb_interval}s)") from e
            raise
        finally:
            stop.set()
            trace.TRACER.pop(run_span)
            trace.finish(run_span)
            t1 = time.monotonic()
            obs.CLIENT_REQUEST_SECONDS.labels(
                method="ServerDistributor").observe(t1 - t0)
            obs_slo.observe_rpc("client", "ServerDistributor", t1 - t0,
                                now=t1)
            try:
                sock.close()
            except OSError:
                pass
        self._note_caps(resp)
        _check_resp(resp)
        return out, int(resp["turn"])

    def ping(self) -> int:
        resp, _ = self._call({"method": "Ping"}, timeout=self._timeout)
        return int(resp["turn"])

    def stats(self) -> dict:
        resp, _ = self._call({"method": "Stats"}, timeout=self._timeout)
        return dict(resp["stats"])

    def get_metrics(self) -> dict:
        """The server's full metrics-registry snapshot
        (`Registry.snapshot()` shape)."""
        resp, _ = self._call({"method": "GetMetrics"},
                             timeout=self._timeout)
        return dict(resp["metrics"])

    def get_telemetry(self, series: Optional[str] = None,
                      tier: str = "raw", since: float = 0.0,
                      labels: Optional[dict] = None) -> dict:
        """The peer's telemetry document: a member's own family values
        (`obs/export.local_doc`); a federation router's fleet view, where
        `series` adds one tsdb series' merged buckets."""
        header: dict = {"method": "GetTelemetry"}
        if series:
            header["series"] = series
            header["tier"] = tier
            if since:
                header["since"] = float(since)
            if labels:
                header["labels"] = dict(labels)
        resp, _ = self._call(header, timeout=self._timeout)
        return dict(resp["telemetry"])

    def get_audit(self, since_seq: int = 0, limit: int = 100) -> list:
        """gol-fleet-audit/1 records with seq > since_seq, oldest first
        (a member answers from its local event ring)."""
        resp, _ = self._call(
            {"method": "GetAudit", "since_seq": int(since_seq),
             "limit": int(limit)},
            timeout=self._timeout)
        return list(resp.get("records", []))

    def get_usage(self) -> dict:
        """The server's per-run usage doc: top-K talkers by device-time
        share, wire/broadcast/checkpoint/journal bytes, attribution
        conservation and capacity headroom rows. A client bound to a run
        also gets that run's live record under "run"."""
        resp, _ = self._call({"method": "GetUsage"},
                             timeout=self._timeout)
        doc = dict(resp["usage"])
        if "run" in resp:
            doc["run"] = dict(resp["run"])
        return doc

    def profile(self, turns: int = 0) -> dict:
        """Arm a profiler capture of the next `turns` engine turns on the
        SERVER, into its configured --profile-dir (the client never
        chooses remote write paths). `turns=0` returns the profile
        controller's status instead of arming."""
        resp, _ = self._call({"method": "Profile", "turns": int(turns)},
                             timeout=self._timeout)
        resp.pop("ok", None)
        return dict(resp)

    def abort_run(self) -> bool:
        """Stop the engine's current run IF it is this controller's own
        (token match); returns whether an abort was delivered."""
        resp, _ = self._call(
            {"method": "AbortRun", "token": self._token},
            timeout=self._timeout)
        return bool(resp.get("aborted"))

    def alive_count(self) -> Tuple[int, int]:
        resp, _ = self._call({"method": "Alivecount"},
                             timeout=self._timeout)
        return int(resp["alive"]), int(resp["turn"])

    def get_world(self) -> Tuple[np.ndarray, int]:
        resp, world = self._call({"method": "GetWorld"},
                                 timeout=self._timeout)
        return world, int(resp["turn"])

    def get_view(self, max_cells: int):
        """(view pixels, turn, (fy, fx)): the full board when it fits
        max_cells, else a server-side downsampled frame whose transfer is
        O(max_cells).

        Declares the frame it already holds ("vkey" + "basis_turn") so an
        xrle-capable server can reply with an XOR-delta instead of the
        whole frame: steady-state polling costs O(changed cells)."""
        header = {"method": "GetView", "max_cells": int(max_cells),
                  "vkey": self._token}
        xb = None
        basis = self._view_basis
        if (basis is not None and not self._view_nodiff
                and wire.CAP_XRLE in self._peer_caps):
            header["basis_turn"] = basis[0]
            xb = (basis[0], basis[3])
        try:
            resp, view = self._call(header, timeout=self._timeout,
                                    xrle_basis=xb)
        except FramesNotDiffable:
            # Float boards refuse deltas by contract: drop the basis and
            # re-poll once for a full frame; the sticky flag stops later
            # polls from declaring a basis.
            self._view_nodiff = True
            self._view_basis = None
            header.pop("basis_turn", None)
            resp, view = self._call(header, timeout=self._timeout)
        turn = int(resp["turn"])
        fy, fx = int(resp["fy"]), int(resp["fx"])
        if view is not None:
            self._view_basis = (turn, fy, fx, view)
        return view, turn, (fy, fx)

    def subscribe(self, max_cells: int,
                  timeout: float = None) -> "ViewSubscription":
        """Upgrade one connection to a server-push live-view stream (the
        broadcast tier): the server ACKs, then pushes epoch-stream frames
        — a keyframe every `keyframe_every` frames plus xrle deltas
        against the previous pushed frame — until either side hangs up.
        N subscribers of one run cost the server ONE encode per
        published frame.

        Requires full codec caps (every subscriber shares the same frozen
        bytes); servers refuse partial-caps peers with an error — poll
        get_view then."""
        header = {"method": "Subscribe", "max_cells": int(max_cells),
                  "vkey": self._token,
                  "caps": sorted(wire.local_caps())}
        if self.run_id is not None:
            header["run_id"] = self.run_id
        to = self._timeout if timeout is None else timeout
        sock = _dial(self._addr, to)
        try:
            wire.enable_nodelay(sock)
            sock.settimeout(to)
            send_msg(sock, header)
            resp, _ = recv_msg(sock)
            self._note_caps(resp)
            _check_resp(resp)
        except BaseException:
            sock.close()
            raise
        return ViewSubscription(sock, resp)

    def get_window(self):
        """Sparse engines: (window pixels, (ox, oy) torus origin, turn)."""
        resp, world = self._call({"method": "GetWindow"},
                                 timeout=self._timeout)
        return world, (int(resp["ox"]), int(resp["oy"])), int(resp["turn"])

    def cf_put(self, flag: int) -> None:
        self._call({"method": "CFput", "flag": int(flag)},
                   timeout=self._timeout)

    def drain_flags(self, pause_only: bool = False) -> None:
        self._call({"method": "DrainFlags", "pause_only": pause_only},
                   timeout=self._timeout)

    def kill_prog(self) -> None:
        self._call({"method": "KillProg"}, timeout=self._timeout)

    def checkpoint_now(self, directory: str = "",
                       trigger: str = "manual") -> Tuple[str, int]:
        """Trigger a durable manifest checkpoint on the SERVER, into its
        configured GOL_CKPT directory (`directory` must be empty: the
        client never chooses remote write paths); returns (manifest
        basename, turn). Duck-types `Engine.checkpoint_now`, so the
        controller's `c` key is engine-agnostic."""
        if directory:
            raise ValueError(
                "remote checkpoints always land in the server's "
                "configured directory")
        # Generous timeout: the server's write is synchronous (hash and
        # fsync of a board that can be hundreds of MB).
        resp, _ = self._call({"method": "Checkpoint"},
                             timeout=max(self._timeout, 120.0))
        return str(resp.get("manifest", "")), int(resp["turn"])

    def restore_run(self, path: str = "", reshard: bool = False) -> int:
        """Adopt a checkpoint on the SERVER: empty `path` = the newest
        durable checkpoint in its configured directory, else a
        checkpoint name within it. Returns the restored turn. A
        checkpoint whose recorded geometry disagrees with the serving
        engine is refused with `GeometryRefused` unless `reshard=True`."""
        resp, _ = self._call({"method": "RestoreRun", "path": path,
                              "reshard": bool(reshard)},
                             timeout=max(self._timeout, 120.0))
        return int(resp["turn"])

    def rescale(self, run_id: str, target: str) -> dict:
        """Live-migrate a fleet run to another federation member (`target`
        = its advertised host:port) via the failure-atomic two-phase
        cutover: quiesce -> durable checkpoint -> transfer -> resume on
        the target -> router redirect, with rollback to THIS member on
        any failure. Returns the coordinator's summary record. Generous
        timeout: the transfer moves the whole board and the redirect
        waits on the router."""
        resp, _ = self._call({"method": "Rescale",
                              "run_id": str(run_id),
                              "target": str(target)},
                             timeout=max(self._timeout, 120.0))
        resp.pop("ok", None)
        return dict(resp)

    # --- Fleet methods -------------------------------------------------

    def create_run(self, h: int, w: int, board: np.ndarray = None,
                   run_id: str = None, rule: str = None,
                   ckpt_every: int = 0, target_turn: int = None,
                   queue: bool = False) -> dict:
        """Admit a new run on a fleet server; returns its describe()
        record ({"run_id", "state", "turn", ...}). An optional seed
        board uploads on the request payload; without one the server
        seeds a deterministic soup. Single-run servers answer with a
        FleetUnsupported error suggesting --fleet."""
        header = {"method": "CreateRun", "h": int(h), "w": int(w),
                  "ckpt_every": int(ckpt_every),
                  "queue": bool(queue)}
        if run_id is not None:
            header["run_id"] = run_id
        if rule is not None:
            header["rule"] = rule
        if target_turn is not None:
            header["target_turn"] = int(target_turn)
        resp, _ = self._call(header, timeout=self._timeout, world=board)
        return dict(resp["run"])

    def list_runs(self) -> Tuple[list, dict]:
        """([describe() records], fleet summary) — one run on single-run
        servers, the whole fleet on --fleet ones."""
        resp, _ = self._call({"method": "ListRuns"},
                             timeout=self._timeout)
        return list(resp["runs"]), dict(resp.get("summary", {}))

    def attach_run(self, run_id: str) -> "RemoteEngine":
        """Verify `run_id` exists on the server, then return a client
        BOUND to it: every run-scoped call on the returned engine
        carries the run_id header. Raises on unknown runs."""
        resp, _ = self._call({"method": "AttachRun", "run_id": run_id},
                             timeout=self._timeout)
        return self.for_run(str(resp["run"]["run_id"]))

    def destroy_run(self, run_id: str) -> dict:
        """Destroy a fleet run outright (resident, queued or parked):
        frees its bucket slot and admission budget and lets a queued run
        promote. Returns the run's final describe() record. Raises on
        unknown ids, the legacy default run, and single-run servers."""
        resp, _ = self._call({"method": "DestroyRun",
                              "run_id": str(run_id)},
                             timeout=self._timeout)
        return dict(resp["run"])

    def set_rule(self, run_id: str, rule: str) -> dict:
        """Migrate a fleet run to a new life-like rule without dropping
        its board (evict -> readmit through the placement queue).
        Returns the run's describe() record — state "queued" until the
        fleet loop re-places it. Raises on unknown ids, the legacy
        default run, and non-life-like rules."""
        resp, _ = self._call({"method": "SetRule",
                              "run_id": str(run_id),
                              "rule": str(rule)},
                             timeout=self._timeout)
        return dict(resp["run"])

    def for_run(self, run_id: str) -> "RemoteEngine":
        """A bound clone addressing one fleet run (no server round trip —
        use attach_run to also verify existence)."""
        clone = RemoteEngine(f"{self._addr[0]}:{self._addr[1]}",
                             timeout=self._timeout, run_id=run_id)
        clone._peer_caps = self._peer_caps
        return clone

    def get_journal(self, since_seq: int = -1, limit: int = 100,
                    run_id: str = "") -> dict:
        """A run's hash-chained gol-journal/1 tail: {"head", "seq",
        "path", "records"} with records of seq > since_seq, oldest
        first. `run_id` names the run (a JAX server needs it; the port's
        server reads its own run when it is empty)."""
        header = {"method": "GetJournal", "since_seq": int(since_seq),
                  "limit": int(limit)}
        if run_id:
            header["run_id"] = run_id
        resp, _ = self._call(header, timeout=self._timeout)
        return {"head": resp.get("head"), "seq": resp.get("seq"),
                "path": resp.get("path"),
                "records": list(resp.get("records", []))}


class ViewSubscription:
    """Consumer half of a Subscribe upgrade: a persistent socket the
    server pushes epoch-stream frames down.

    `recv()` blocks for the next frame and keeps the xrle basis chain:
    keyframes decode standalone, deltas decode against the previous
    received frame. After the gateway skips this subscriber forward (it
    was too slow), the next frame is a keyframe by protocol, so the chain
    re-anchors with no client logic. The stream ends with a
    ConnectionError carrying the server's end sentinel (run destroyed,
    server shutdown) or a raw hangup."""

    def __init__(self, sock: socket.socket, ack: dict) -> None:
        self._sock = sock
        self.run_id = ack.get("run_id")
        self.epoch = int(ack.get("epoch", 0))
        self.keyframe_every = int(ack.get("keyframe_every", 0))
        self.max_cells = int(ack.get("max_cells", 0))
        self._basis = None  # (turn, pixels): the last received frame
        self.frames_received = 0
        self.closed = False

    def fileno(self) -> int:
        return self._sock.fileno()

    def recv(self, timeout: float = None):
        """Block for the next pushed frame; returns (view pixels, turn,
        (fy, fx), header). Raises ConnectionError when the stream ends
        (with the server's end-sentinel reason when one was sent). ANY
        failure, a recv timeout included, closes the subscription: a
        frame may have been half-consumed, and the push framing is not
        resumable mid-message. Re-subscribe to continue (the first frame
        is always a keyframe)."""
        if self.closed:
            raise ConnectionError("subscription closed")
        self._sock.settimeout(timeout)
        try:
            header, view = recv_msg(self._sock, xrle_basis=self._basis)
        except BaseException:
            self.close()
            raise
        if header.get("push") == "end" or not header.get("ok", False):
            self.close()
            raise ConnectionError(
                f"stream ended: {header.get('error', 'closed by server')}")
        turn = int(header["turn"])
        self.epoch = int(header.get("epoch", self.epoch))
        if view is not None:
            self._basis = (turn, view)
        self.frames_received += 1
        return view, turn, (int(header["fy"]), int(header["fx"])), header

    def frames(self, timeout: float = None):
        """Yield (view, turn, (fy, fx), header) until the stream ends (a
        clean end sentinel returns; transport errors propagate)."""
        while True:
            try:
                yield self.recv(timeout)
            except ConnectionError:
                return

    def close(self) -> None:
        self.closed = True
        try:
            self._sock.close()
        except OSError:
            pass
