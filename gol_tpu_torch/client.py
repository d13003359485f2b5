"""Remote engine client — the controller side of the control plane, the
counterpart of `gol_tpu/client.py` (without its live-view subscription
and the methods of slices not yet ported: fleet runs, migration, sparse
windows, telemetry).

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
from typing import Sequence, Tuple

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

    def __init__(self, address: str, timeout: float = 10.0) -> None:
        host, _, port = address.rpartition(":")
        self._addr = (host or "localhost", int(port))
        self._timeout = timeout
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

    def _call(self, header: dict, timeout=None, xrle_basis=None):
        label = obs.method_label(str(header.get("method")))
        header.setdefault("caps", sorted(wire.local_caps()))
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
                    label, header, timeout, xrle_basis)
                self._note_caps(resp)
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

    def _call_once(self, label: str, header: dict, timeout, xrle_basis):
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
                        send_msg(sock, header)
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
