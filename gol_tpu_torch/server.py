"""Engine server: the broker-host process of the reference, on one CUDA
GPU — the counterpart of `gol_tpu/server.py`, wire-compatible with it in
both directions (a JAX controller drives this server, and the port's
controller drives a JAX server).

Wraps an `Engine`, with `--sparse SIZE` a `SparseEngine`, or with
`--fleet` a `FleetEngine` (many resident runs, `fleet/`), behind the
control protocol (`Server/gol/distributor.go:54-83` — ServerDistributor /
Alivecount / GetWorld / CFput / KillProg, plus Ping, Stats, GetMetrics,
GetView, DrainFlags, AbortRun, Checkpoint, RestoreRun, GetJournal, the
fleet's CreateRun / ListRuns / AttachRun / DestroyRun / SetRule, for
the sparse engine GetWindow, the broadcast tier's Subscribe, the
telemetry surface's GetTelemetry / GetAudit / GetUsage / Profile, and the
federation's AdoptRun and live migration's Rescale / ReceiveRun /
CommitRun on a fleet) on a TCP socket (default :8080, the reference
broker port, `Server:235`).
Run-scoped methods honour a `run_id` header (`RUN_SCOPED`); peers that
never send one get the legacy run, on every engine. A Subscribe is
ACKed on its handler thread and its socket handed to the viewer gateway
(`gateway.py`), which pushes the run's encode-once epoch stream
(`broadcast.py`) until either side hangs up.
Long-running: survives controller detach and serves `GetWorld` for
`CONT=yes` reattach, as the Go broker holds `world`/`turn` in globals.
With `--checkpoint DIR` a SIGTERM drains, writes a manifest checkpoint
and the legacy `WxH.npz`, and exits 0; `--resume` restores before
serving; on a fleet server SIGTERM also checkpoints every fleet run
into its run-<id> directory. `--metrics-port` serves /metrics, /healthz
and /profile; `--profile-dir` is where Profile's torch.profiler traces
land. `--federate ROUTER` joins a federation router (either package's):
a heartbeat thread registers the member as `--advertise HOST` plus the
bound port, and the router places runs here, adopts a dead member's runs
through AdoptRun, and takes the Rescale coordinator's PinRun. A run that
migrated away answers a late request with the retryable "moved:" error.

Run:  python -m gol_tpu_torch.server [--port 8080] [--device cpu]
          [--sparse SIZE | --fleet] [--checkpoint DIR [--ckpt-every TURNS]]
          [--resume DIR|MANIFEST|NPZ] [--metrics-port PORT]
          [--profile-dir DIR] [--federate ROUTER [--advertise HOST]]
"""

from __future__ import annotations

import argparse
import collections
import os
import signal
import socket
import sys
import threading
import time
from typing import Optional

from gol_tpu_torch import ckpt as ckpt_mod
from gol_tpu_torch import journal as journal_mod
from gol_tpu_torch import wire
from gol_tpu_torch.engine import Engine, EngineBusy, EngineKilled
from gol_tpu_torch.fleet.handles import FleetUnsupported
from gol_tpu_torch.obs import audit as obs_audit
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import export as obs_export
from gol_tpu_torch.obs import flight as obs_flight
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs import trace
from gol_tpu_torch.obs import usage as obs_usage
from gol_tpu_torch.obs.prof import PROFILER, ProfileUnavailable
from gol_tpu_torch.obs.log import exception as obs_exception
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.obs.metrics import REGISTRY
from gol_tpu_torch.params import Params
from gol_tpu_torch.utils.envcfg import env_float, env_int
from gol_tpu_torch.wire import recv_msg, send_msg

DEFAULT_PORT = 8080  # reference broker port (`Server/gol/distributor.go:235`)

# Accept-loop hardening: a client that connects and sends nothing (or
# trickles its request forever) is shed, and the per-connection threads
# are bounded. The timeout applies per socket op while the request is
# received, so a steadily uploading client never trips it; it is cleared
# before dispatch, since the blocking run call computes for as long as
# the run lasts.
HEADER_TIMEOUT_ENV = "GOL_HDR_TIMEOUT"    # seconds; 0 disables
HEADER_TIMEOUT_DEFAULT = 30.0
MAX_CONNS_ENV = "GOL_MAX_CONNS"           # concurrent connections; 0 = off
MAX_CONNS_DEFAULT = 64

# Graceful drain (SIGTERM): stop accepting, wait up to this many seconds
# for in-flight handlers, then exit 0.
DRAIN_DEADLINE_ENV = "GOL_DRAIN_DEADLINE"
DRAIN_DEADLINE_DEFAULT = 5.0


class EngineServer:
    def __init__(
        self,
        port: int = DEFAULT_PORT,
        host: str = "0.0.0.0",
        engine: Optional[Engine] = None,
    ) -> None:
        self.engine = engine if engine is not None else Engine()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(16)
        self.port = self._sock.getsockname()[1]
        self._shutdown = threading.Event()
        self._header_timeout = env_float(
            HEADER_TIMEOUT_ENV, HEADER_TIMEOUT_DEFAULT)
        max_conns = env_int(MAX_CONNS_ENV, MAX_CONNS_DEFAULT, minimum=0)
        self._conn_slots = (
            threading.BoundedSemaphore(max_conns) if max_conns else None)
        # Per-viewer last-served live-view frames, keyed by the client's
        # "vkey": the xrle codec deltas the next GetView reply against
        # the frame that viewer already holds. Bounded LRU; an eviction
        # only costs one full-frame resend.
        self._view_cache: dict = {}
        self._view_cache_lock = threading.Lock()
        # req_id dedupe window: the last DEDUPE_MAX mutating replies,
        # keyed by "<method>|<req_id>", so a client retry whose first
        # attempt already committed replays the recorded reply instead
        # of re-executing. Peers that send no req_id keep at-most-once.
        self._dedupe: dict = {}
        self._dedupe_lock = threading.Lock()
        self._dedupe_ctx = threading.local()
        # In-flight handler census for graceful drain.
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Broadcast tier (hub + selectors gateway): created on the first
        # Subscribe, so servers that never see one start no threads.
        # (hub, gateway) once armed; _bcast is written last.
        self._bcast = None
        # The accept thread `start_background` started; `shutdown` joins
        # it (see there).
        self._accept_thread: Optional[threading.Thread] = None
        self._bcast_lock = threading.Lock()
        # Set by a Subscribe handler after it handed its socket to the
        # gateway: _serve_conn must then not close the fd the event loop
        # now owns.
        self._adopted_conn = threading.local()
        # The ConnectionEncoder of the request this thread serves: _reply
        # adds its sent bytes there, and the dispatch tail charges them to
        # the run named in the header.
        self._usage_ctx = threading.local()
        # Live migration forwarding map: run_id -> the member address it
        # migrated to. A straggler whose request was relayed here before
        # the router's pin flipped gets a RETRYABLE "moved:" answer
        # instead of "unknown run". Bounded LRU.
        self._moved: "collections.OrderedDict[str, str]" = \
            collections.OrderedDict()
        self._moved_lock = threading.Lock()
        # Federation identity, stamped by main() with --federate: the
        # router address (PinRun destination) and the address this
        # member advertised (its member_id in the registry).
        self._fed_router = ""
        self._self_addr = ""

    VIEW_CACHE_MAX = 4
    DEDUPE_MAX = 512
    # How long a duplicate waits for the original attempt to record its
    # reply before giving up.
    DEDUPE_WAIT_S = 60.0
    # Mirror of the client's MUTATING_METHODS: the set whose replies are
    # recorded for replay. Read-only methods are naturally idempotent.
    MUTATING_METHODS = frozenset({
        "CreateRun", "DestroyRun", "SetRule", "Checkpoint", "CFput",
        "DrainFlags", "RestoreRun", "AbortRun", "Profile", "KillProg",
        "AdoptRun", "Rescale", "ReceiveRun", "CommitRun", "PinRun",
    })

    MOVED_MAX = 256

    def note_moved(self, run_id: str, target: str) -> None:
        """Record that `run_id` now lives at member `target`, so late
        requests answer "moved:" (retryable) instead of "unknown run"."""
        with self._moved_lock:
            self._moved[str(run_id)] = str(target)
            self._moved.move_to_end(str(run_id))
            while len(self._moved) > self.MOVED_MAX:
                self._moved.popitem(last=False)

    def moved_to(self, run_id: str) -> Optional[str]:
        with self._moved_lock:
            return self._moved.get(str(run_id))

    def drop_run_viewers(self, run_id: str, sentinel: str) -> None:
        """Purge every per-viewer xrle basis of a run that left this
        server and end its broadcast streams with `sentinel`: each
        subscriber reconnects and re-keys (the first frame after any
        reconnect is a keyframe by protocol)."""
        self._drop_run_views(run_id)
        bc = self._bcast
        if bc is not None:
            bc[0].drop_run(run_id, sentinel)

    def serve_forever(self) -> None:
        while not self._shutdown.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                break
            # Accept timestamp: the start of the request's queue wait,
            # reported by the SLO layer as the kind="wait" split.
            t_acc = time.monotonic()
            wire.enable_nodelay(conn)
            try:
                # A peer that vanishes mid-call must eventually surface
                # as a reset on long blocking handlers.
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            except OSError:
                pass
            if (self._conn_slots is not None
                    and not self._conn_slots.acquire(blocking=False)):
                # At the cap: refuse with "overloaded:" (not "busy:",
                # which the client maps to EngineBusy, a fatal conflict
                # on a first submission) so the client treats it as a
                # transport failure and rides its recovery path.
                try:
                    conn.settimeout(1.0)
                    send_msg(conn, {"ok": False,
                                    "error": "overloaded: connection limit"})
                except OSError:
                    pass
                finally:
                    conn.close()
                continue
            threading.Thread(
                target=self._serve_slot, args=(conn, t_acc), daemon=True
            ).start()

    def start_background(self) -> threading.Thread:
        t = threading.Thread(target=self.serve_forever, daemon=True)
        self._accept_thread = t
        t.start()
        return t

    def shutdown(self) -> None:
        self._shutdown.set()
        bc = self._bcast
        if bc is not None:
            # Every stream ends with its sentinel before the gateway stops.
            hub, gateway = bc
            try:
                hub.stop()
                gateway.stop()
            except Exception as e:  # shutdown must not raise
                obs_exception("server.bcast_stop_failed", e)
        try:
            # Wakes a thread blocked in accept(); close() alone does not.
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # The accept thread's target holds a reference to this server and
        # its engine. Joined here, it cannot drop the last one (and free
        # the engine's tensors inside torch) while the interpreter exits,
        # which aborts the process: a script that starts a server in a
        # function, shuts it down and returns.
        t = self._accept_thread
        if t is not None and t is not threading.current_thread():
            t.join(5.0)

    # ------------------------------------------------------------------

    def _serve_slot(self, conn: socket.socket,
                    t_acc: Optional[float] = None) -> None:
        with self._inflight_lock:
            self._inflight += 1
        try:
            self._serve_conn(conn, t_acc)
        finally:
            with self._inflight_lock:
                self._inflight -= 1
            if self._conn_slots is not None:
                self._conn_slots.release()

    def inflight(self) -> int:
        with self._inflight_lock:
            return self._inflight

    def wait_drained(self, deadline_s: float) -> int:
        """Block until every in-flight handler finished or the deadline
        passed; returns the handlers still running (0 = fully drained)."""
        t_end = time.monotonic() + max(0.0, deadline_s)
        while time.monotonic() < t_end:
            if self.inflight() == 0:
                return 0
            time.sleep(0.05)
        return self.inflight()

    def _serve_conn(self, conn: socket.socket,
                    t_acc: Optional[float] = None) -> None:
        # One request per connection. The fd closes on every exit path,
        # and transport failures are counted by method and kind.
        label = "unknown"
        try:
            if self._header_timeout > 0:
                conn.settimeout(self._header_timeout)
            header, world = recv_msg(conn)
            label = obs.method_label(str(header.get("method")))
            conn.settimeout(None)  # dispatch may compute for hours
            self._dispatch(conn, header, world, t_acc)
        except (wire.WireProtocolError, ValueError):
            obs.RPC_ERRORS.labels(method=label, kind="protocol").inc()
        except (socket.timeout, TimeoutError):
            obs.RPC_ERRORS.labels(method=label, kind="timeout").inc()
        except (ConnectionError, OSError):
            obs.RPC_ERRORS.labels(method=label, kind="reset").inc()
        except Exception as e:
            # A handler bug must not leak the fd or die silently.
            obs_exception("server.handler_crashed", e, method=label)
        finally:
            if getattr(self._adopted_conn, "flag", False):
                # Subscribe upgrade: the gateway owns this fd now.
                self._adopted_conn.flag = False
            else:
                try:
                    conn.close()
                except OSError:
                    pass

    def _dispatch(
        self, conn: socket.socket, header: dict, world,
        t_acc: Optional[float] = None,
    ) -> None:
        method = header.get("method")
        # Request accounting brackets the whole dispatch, reply included:
        # for ServerDistributor that is the full blocking run.
        label = obs.method_label(str(method))
        obs.SERVER_REQUESTS.labels(method=label).inc()
        t0 = time.monotonic()
        if t_acc is not None:
            obs_slo.observe_rpc("wait", label, t0 - t_acc, now=t0)
        # The handler span joins the caller's trace via the propagated
        # "tc" header (absent or garbage: a fresh root).
        with trace.span(f"serve.{label}", parent=header.get("tc")):
            try:
                self._dispatch_inner(conn, method, label, header, world)
            finally:
                t1 = time.monotonic()
                obs.SERVER_REQUEST_SECONDS.labels(method=label).observe(
                    t1 - t0)
                obs_slo.observe_rpc("handler", label, t1 - t0, now=t1)

    def _reply(self, conn: socket.socket, header: dict, frame=None) -> None:
        """Every reply advertises this server's wire caps, so any
        successful RPC (the controller's attach ping, a flag ack) teaches
        the client which codecs the next board transfer may use."""
        header.setdefault("caps", wire.advertised_caps())
        # Record BEFORE the send: once the handler produced a reply the
        # operation is committed, and a retry after a lost reply must
        # replay this outcome. Mutating replies carry no board frames.
        key = getattr(self._dedupe_ctx, "key", None)
        if key is not None:
            self._dedupe_ctx.key = None
            self._record_reply(key, dict(header))
        n = send_msg(conn, header, frame=frame)
        enc = getattr(self._usage_ctx, "enc", None)
        if enc is not None:
            enc.bytes_out += n

    def _record_reply(self, key: str, reply: dict) -> None:
        with self._dedupe_lock:
            ent = self._dedupe.get(key)
            if ent is not None:
                ent["reply"] = reply
                ent["done"].set()

    def _dedupe_check(self, conn, method, label: str, header: dict) -> bool:
        """True when this request was answered from the dedupe window (a
        retry of a request already executed or executing); False when
        the caller should execute it, with the thread-local key armed
        for _reply to record the outcome."""
        req_id = header.get("req_id")
        if (method not in self.MUTATING_METHODS
                or not isinstance(req_id, str)
                or not 0 < len(req_id) <= 64):
            return False
        key = f"{method}|{req_id}"
        with self._dedupe_lock:
            ent = self._dedupe.get(key)
            if ent is None:
                self._dedupe[key] = {"done": threading.Event(),
                                     "reply": None}
                while len(self._dedupe) > self.DEDUPE_MAX:
                    # A window, not a ledger: the oldest entries age out
                    # (dicts iterate in insertion order).
                    del self._dedupe[next(iter(self._dedupe))]
        if ent is None:
            self._dedupe_ctx.key = key
            return False
        # Duplicate: the first attempt owns execution; wait for its reply.
        obs.SERVER_DEDUP_HITS.labels(method=label).inc()
        ent["done"].wait(self.DEDUPE_WAIT_S)
        reply = ent["reply"]
        if reply is None:
            self._reply(conn, {
                "ok": False,
                "error": "RuntimeError: duplicate request still "
                         "executing"})
        else:
            self._reply(conn, dict(reply))
        return True

    def _encode_view(self, header: dict, caps, out, turn: int,
                     fy: int, fx: int, eng):
        """Frame a GetView reply, delta-encoding (xrle) against the frame
        this viewer already holds when the negotiation, the run surface's
        diffability and the client's declared basis all line up; then
        remember `out` as the viewer's new basis."""
        vkey = self._view_cache_key(header)
        use_cache = (wire.CAP_XRLE in caps
                     and getattr(eng, "frames_diffable", False)
                     and vkey is not None)
        basis = basis_turn = None
        if use_cache:
            want = header.get("basis_turn")
            with self._view_cache_lock:
                ent = self._view_cache.get(vkey)
            if ent is not None and ent[0] == want and ent[1] == (fy, fx):
                basis_turn, _, basis = ent
        frame = wire.encode_view_frame(
            out, caps, basis=basis, basis_turn=basis_turn,
            binary=eng.binary_pixels)
        if use_cache:
            with self._view_cache_lock:
                self._view_cache.pop(vkey, None)
                self._view_cache[vkey] = (turn, (fy, fx), out)
                while len(self._view_cache) > self.VIEW_CACHE_MAX:
                    self._view_cache.pop(next(iter(self._view_cache)))
        return frame

    @staticmethod
    def _view_cache_key(header: dict):
        """The per-viewer basis-cache key of a GetView request (the
        client's vkey, namespaced per fleet run: one viewer key watching
        two runs must not delta one run's frame against the other's), or
        None when the request names no usable viewer."""
        vkey = header.get("vkey")
        if not (isinstance(vkey, str) and 0 < len(vkey) <= 64):
            return None
        if header.get("run_id"):
            return f"{header['run_id']}|{vkey}"
        return vkey

    def _ensure_broadcast(self):
        """The lazily armed (hub, gateway) pair. The first Subscribe
        starts the publisher and event-loop threads and installs the
        hub's poke as the engine's per-chunk publish hook."""
        bc = self._bcast
        if bc is not None:
            return bc
        with self._bcast_lock:
            if self._bcast is None:
                from gol_tpu_torch.broadcast import BroadcastHub
                from gol_tpu_torch.gateway import ViewerGateway

                hub = BroadcastHub()
                gateway = ViewerGateway()
                hub.start(sink=gateway.notify)
                gateway.start()
                # Every engine carries _bcast_notify; a stream also
                # publishes on the hub's GOL_BCAST_HZ tick alone.
                self.engine._bcast_notify = hub.poke
                self._bcast = (hub, gateway)
        return self._bcast

    def _drop_run_views(self, run_id: str) -> None:
        """DestroyRun eviction: every `run_id|vkey` basis entry of the
        destroyed run goes, so a recycled run_id never deltas a new run's
        first frame against the dead run's last one."""
        if not run_id:
            return
        prefix = f"{run_id}|"
        with self._view_cache_lock:
            for k in [k for k in self._view_cache if k.startswith(prefix)]:
                del self._view_cache[k]

    # Methods that act on ONE run and therefore honour a `run_id` header:
    # the engine's resolve_run maps it to a per-run surface (the engine
    # itself for the legacy run and the single-run engines, a fleet
    # RunView otherwise). Engine-wide methods (KillProg, AbortRun,
    # RestoreRun, GetMetrics, ListRuns, CreateRun) stay on the engine.
    RUN_SCOPED = frozenset({
        "ServerDistributor", "Ping", "Stats", "Alivecount", "GetWorld",
        "GetView", "GetWindow", "CFput", "DrainFlags", "Checkpoint",
        "Subscribe",
    })

    def _resolve_target(self, method, header: dict):
        """The engine surface a request dispatches against. Peers that
        never send run_id (every pre-fleet client) resolve to the engine
        itself — the legacy single run — on all engines; unknown ids
        raise KeyError (an "unknown run" error)."""
        rid = header.get("run_id")
        if method in self.RUN_SCOPED and rid not in (None, ""):
            return self.engine.resolve_run(str(rid))
        return self.engine

    def _drop_view_basis(self, header: dict) -> None:
        """Invalidate a viewer's basis after a reply failed mid-send: the
        viewer never received the frame just recorded as its basis, so
        its next poll must get a full frame."""
        vkey = self._view_cache_key(header)
        if vkey is not None:
            with self._view_cache_lock:
                self._view_cache.pop(vkey, None)

    def _dispatch_inner(
        self, conn: socket.socket, method, label: str, header: dict, world
    ) -> None:
        # One encoder per connection (one request per connection): the
        # negotiation and the advert resolve here, once.
        enc = wire.ConnectionEncoder(header)
        caps = enc.caps
        self._usage_ctx.enc = enc
        if self._dedupe_check(conn, method, label, header):
            return
        try:
            eng = self._resolve_target(method, header)
            if method == "ServerDistributor":
                p = Params(**header["params"])
                out, turn = eng.server_distributor(
                    p,
                    world,
                    tuple(header.get("sub_workers", ())),
                    start_turn=int(header.get("start_turn", 0)),
                    token=header.get("token"),
                )
                self._reply(conn, {"ok": True, "turn": turn},
                            frame=wire.encode_board(
                                out, caps, binary=eng.binary_pixels))
            elif method == "AbortRun":
                aborted = self.engine.abort_run(header.get("token"))
                self._reply(conn, {"ok": True, "aborted": aborted})
            elif method == "Ping":
                self._reply(conn, {"ok": True, "turn": eng.ping()})
            elif method == "Stats":
                self._reply(conn, {"ok": True, "stats": eng.stats()})
            elif method == "GetMetrics":
                self._reply(conn,
                            {"ok": True, "metrics": REGISTRY.snapshot()})
            elif method == "GetTelemetry":
                # A member answers with its own family values (a
                # federation router answers with fleet rollups).
                self._reply(conn, {"ok": True,
                                   "telemetry": obs_export.local_doc()})
            elif method == "GetAudit":
                # The member-local event ring.
                self._reply(conn, {
                    "ok": True,
                    "records": obs_audit.recent(
                        int(header.get("since_seq", 0) or 0),
                        int(header.get("limit", 100) or 100))})
            elif method == "GetUsage":
                # The usage meter's doc; a request naming a run also
                # gets that run's live record. Not RUN_SCOPED.
                rid = str(header.get("run_id") or "")
                resp = {"ok": True, "usage": obs_usage.usage_doc()}
                if rid:
                    resp["run"] = obs_usage.METER.run_doc(rid)
                self._reply(conn, resp)
            elif method == "Profile":
                # Arm a torch.profiler capture of the next N engine
                # turns into the server's configured --profile-dir: a
                # peer never chooses paths on this host. turns=0 asks
                # for the status only.
                turns = int(header.get("turns", 0))
                if turns > 0:
                    try:
                        armed = PROFILER.request(turns=turns,
                                                 source="wire")
                    except ProfileUnavailable as e:
                        raise RuntimeError(str(e)) from e
                    self._reply(conn, {"ok": True, **armed})
                else:
                    self._reply(conn, {"ok": True,
                                       "status": PROFILER.status()})
            elif method == "Alivecount":
                alive, turn = eng.alive_count()
                self._reply(conn,
                            {"ok": True, "alive": alive, "turn": turn})
            elif method == "GetWorld":
                # Packed device words go to the socket in bands, with no
                # unpack on the device.
                frame, turn = eng.get_world_frame(caps)
                self._reply(conn, {"ok": True, "turn": turn}, frame=frame)
            elif method == "GetView":
                # O(max_cells) downsampled live-view frame of the board;
                # a fleet run records the viewer.
                vkey = header.get("vkey")
                if (hasattr(eng, "subscribe_view")
                        and isinstance(vkey, str) and 0 < len(vkey) <= 64):
                    eng.subscribe_view(vkey)
                out, turn, (fy, fx) = eng.get_view(
                    int(header.get("max_cells", 0)))
                try:
                    self._reply(conn, {"ok": True, "turn": turn,
                                       "fy": fy, "fx": fx},
                                frame=self._encode_view(header, caps, out,
                                                        turn, fy, fx, eng))
                except (ConnectionError, OSError):
                    self._drop_view_basis(header)
                    raise
            elif method == "Subscribe":
                # Broadcast upgrade: ACK on this thread, then hand the
                # socket to the gateway, which pushes the stream's
                # frames until the peer hangs up; this handler and its
                # connection slot return at once. Every subscriber
                # shares the stream's frozen bytes, so the peer must
                # have negotiated all of the stream's caps (a peer with
                # fewer polls GetView instead).
                if not hasattr(eng, "get_view"):
                    raise RuntimeError("engine has no live view surface")
                vkey = header.get("vkey")
                if (hasattr(eng, "subscribe_view")
                        and isinstance(vkey, str) and 0 < len(vkey) <= 64):
                    eng.subscribe_view(vkey)
                hub, gateway = self._ensure_broadcast()
                stream = hub.stream_for(
                    str(header.get("run_id") or ""), eng,
                    int(header.get("max_cells", 0)))
                if not stream.caps <= caps:
                    raise RuntimeError(
                        "subscribe requires caps "
                        f"{sorted(stream.caps)}; poll GetView instead")
                if not gateway.try_reserve():
                    raise RuntimeError(
                        "overloaded: gateway connection limit")
                try:
                    self._reply(conn, {
                        "ok": True, "run_id": stream.run_id or None,
                        "epoch": stream.epoch,
                        "keyframe_every": stream.keyframe_every,
                        "max_cells": stream.max_cells})
                except BaseException:
                    gateway.release_reservation()
                    raise
                gateway.adopt(conn, stream)
                self._adopted_conn.flag = True
            elif method == "GetWindow":
                # Sparse engines only: live-window pixels and the torus
                # origin of its cell (0, 0).
                out, (ox, oy), turn = eng.get_window()
                self._reply(conn, {"ok": True, "turn": turn,
                                   "ox": ox, "oy": oy},
                            frame=wire.encode_board(
                                out, caps, binary=eng.binary_pixels))
            elif method == "CFput":
                eng.cf_put(int(header["flag"]))
                self._reply(conn, {"ok": True})
            elif method == "DrainFlags":
                eng.drain_flags(
                    pause_only=bool(header.get("pause_only", False)))
                self._reply(conn, {"ok": True})
            elif method == "Checkpoint":
                # A durable snapshot into the server's CONFIGURED
                # directory (GOL_CKPT): the client never chooses write
                # paths on this host.
                path, turn = eng.checkpoint_now(trigger="remote")
                self._reply(conn, {"ok": True, "turn": turn,
                                   "manifest": os.path.basename(path)})
            elif method == "RestoreRun":
                turn = self._restore_run(
                    str(header.get("path", "")),
                    reshard=bool(header.get("reshard", False)))
                self._reply(conn, {"ok": True, "turn": turn})
            elif method == "GetJournal":
                # The hash-chained run journal's tail, by run_id; a
                # request that names none reads this process's run.
                rid = str(header.get("run_id") or obs_flight.RUN_ID)
                jw = journal_mod.get(rid)
                if jw is None:
                    raise KeyError(f"no journal for run {rid!r}")
                since = header.get("since_seq")
                self._reply(conn, {
                    "ok": True, "head": jw.head, "seq": jw.last_seq,
                    "path": journal_mod.journal_path(rid),
                    "records": jw.tail(
                        int(since if since is not None else -1),
                        int(header.get("limit", 100) or 100))})
            elif method == "CreateRun":
                # Fleet admission: single-run engines answer with a
                # FleetUnsupported error pointing at --fleet. The seed
                # board (optional) rides the request payload like a
                # ServerDistributor world upload.
                tt = header.get("target_turn")
                rec = self.engine.create_run(
                    int(header["h"]), int(header["w"]),
                    board=world,
                    run_id=header.get("run_id"),
                    rule=header.get("rule"),
                    ckpt_every=int(header.get("ckpt_every", 0)),
                    target_turn=int(tt) if tt is not None else None,
                    queue=bool(header.get("queue", False)))
                self._reply(conn, {"ok": True, "run": rec})
            elif method == "ListRuns":
                self._reply(conn, {
                    "ok": True,
                    "runs": self.engine.list_runs(),
                    "summary": self.engine.runs_summary()})
            elif method == "AttachRun":
                surf = self.engine.resolve_run(
                    str(header.get("run_id") or ""))
                self._reply(conn, {"ok": True,
                                   "run": surf.describe_run()})
            elif method == "DestroyRun":
                # Explicit slot release: removes the run wherever it
                # sits, frees its admission budget and wakes the loop so
                # a queued run promotes at once; then every viewer basis
                # of the run goes and its broadcast streams end (each
                # subscriber gets the end sentinel, then a hangup).
                # Single-run engines answer FleetUnsupported, as for
                # CreateRun.
                rid = str(header.get("run_id") or "")
                rec = self.engine.destroy_run(rid)
                self.drop_run_viewers(rid, f"killed: run {rid} destroyed")
                self._reply(conn, {"ok": True, "run": rec})
            elif method == "SetRule":
                # Rule migration: evict, re-home under the new rule's
                # bucket, readmit through the placement queue, board
                # intact. The legacy run0 is refused (its rule is fixed
                # at construction); a single-run engine has no set_rule,
                # and answers as `gol_tpu`'s does.
                rec = self.engine.set_rule(
                    str(header.get("run_id") or ""),
                    str(header.get("rule") or ""))
                self._reply(conn, {"ok": True, "run": rec})
            elif method == "KillProg":
                eng.kill_prog()
                self._reply(conn, {"ok": True})
                # The reference broker and workers die on KillProg
                # (os.Exit(0), `SubServer/distributor.go:42-45`): bring
                # the server down.
                self.shutdown()
                if os.environ.get("GOL_SERVER_EXIT_ON_KILL", "1") == "1":
                    threading.Timer(0.2, _exit_after_flush).start()
            elif method == "AdoptRun":
                # Federation failover: adopt a dead member's run from its
                # per-run manifests under the shared GOL_CKPT root. A
                # fleet registers the run quarantined, so the verified,
                # backed-off restore machinery re-homes it; single-run
                # engines answer FleetUnsupported.
                adopt = getattr(self.engine, "adopt_run", None)
                if adopt is None:
                    raise FleetUnsupported(
                        f"{type(self.engine).__name__} serves a single "
                        "run; start the server with --fleet for "
                        "AdoptRun")
                tt = header.get("target_turn")
                rec = adopt(
                    str(header.get("run_id") or ""),
                    ckpt_every=int(header.get("ckpt_every", 0) or 0),
                    target_turn=int(tt) if tt is not None else None)
                self._reply(conn, {"ok": True, "run": rec})
            elif method == "Rescale":
                # Live migration: THIS member is the source; migrate.py
                # coordinates the failure-atomic quiesce -> checkpoint ->
                # transfer -> resume -> redirect cutover (rollback to here
                # on any failure).
                from gol_tpu_torch import migrate as migrate_mod

                rec = migrate_mod.rescale(
                    self, str(header.get("run_id") or ""),
                    str(header.get("target") or ""))
                self._reply(conn, {"ok": True, **rec})
            elif method == "ReceiveRun":
                # Target half of a migration transfer: stage the incoming
                # board hidden ("staged") until CommitRun.
                imp = getattr(self.engine, "import_run", None)
                if imp is None:
                    raise FleetUnsupported(
                        f"{type(self.engine).__name__} serves a single "
                        "run; start the server with --fleet for "
                        "ReceiveRun")
                if world is None:
                    raise RuntimeError(
                        "ReceiveRun carries the board as its payload")
                tt = header.get("target_turn")
                rec = imp(
                    str(header.get("run_id") or ""), world,
                    int(header.get("turn", 0)),
                    rule=header.get("rule"),
                    ckpt_every=int(header.get("ckpt_every", 0) or 0),
                    target_turn=int(tt) if tt is not None else None,
                    activate=str(header.get("state", "resident"))
                    in ("resident", "queued"),
                    journal_head=header.get("journal_head"))
                self._reply(conn, {"ok": True, "run": rec})
            elif method == "CommitRun":
                act = getattr(self.engine, "activate_imported", None)
                if act is None:
                    raise RuntimeError(
                        f"{type(self.engine).__name__} cannot commit "
                        "migrated runs")
                rec = act(str(header.get("run_id") or ""))
                self._reply(conn, {"ok": True, "run": rec})
            else:
                self._reply(conn, {"ok": False,
                                   "error": f"unknown method {method!r}"})
        except KeyError as e:
            # resolve_run's contract: an unknown run id raises KeyError
            # with a presentable message ("unknown run 'x'"), answered as
            # is — or, for a run that MIGRATED away, with the retryable
            # redirect: by the time the client retries, the router's pin
            # points at the new owner. Any other KeyError (a malformed
            # request header) keeps the generic "ExcName: detail" shape.
            obs.SERVER_ERRORS.labels(method=label).inc()
            msg = e.args[0] if e.args else ""
            if isinstance(msg, str) and msg.startswith("unknown run"):
                moved = self.moved_to(str(header.get("run_id") or ""))
                if moved is not None:
                    self._reply(conn, {
                        "ok": False,
                        "error": f"moved: run {header.get('run_id')} "
                                 f"migrated to {moved}"})
                else:
                    self._reply(conn, {"ok": False, "error": msg})
            else:
                self._reply(conn, {"ok": False, "error": f"KeyError: {e}"})
        except EngineKilled as e:
            obs.SERVER_ERRORS.labels(method=label).inc()
            self._reply(conn, {"ok": False, "error": f"killed: {e}"})
        except PermissionError as e:
            obs.SERVER_ERRORS.labels(method=label).inc()
            self._reply(conn, {"ok": False, "error": f"denied: {e}"})
        except EngineBusy as e:
            obs.SERVER_ERRORS.labels(method=label).inc()
            self._reply(conn, {"ok": False, "error": f"busy: {e}"})
        except Exception as e:  # surface engine errors to the client
            obs.SERVER_ERRORS.labels(method=label).inc()
            if getattr(e, "rpc_error_kind", None) == "geometry":
                # A restore whose checkpoint geometry does not match
                # (ckpt/reshard.py): the client raises GeometryRefused;
                # resend with reshard=True to repack.
                self._reply(conn, {"ok": False,
                                   "error": f"geometry: {e}"})
            else:
                self._reply(conn, {"ok": False,
                                   "error": f"{type(e).__name__}: {e}"})
        finally:
            self._usage_ctx.enc = None
            rid = header.get("run_id")
            if rid:
                # Only run-scoped traffic is tenant cost; unscoped RPCs
                # (Stats, GetMetrics, ...) are fleet overhead.
                obs_usage.METER.charge_wire(
                    str(rid), enc.bytes_in, enc.bytes_out)

    def _restore_run(self, req: str, reshard: bool = False) -> int:
        """RestoreRun target resolution: the request names a checkpoint
        WITHIN the server's configured directory (a relative name, or an
        absolute path that resolves inside it) — or nothing, meaning the
        newest durable checkpoint there. A remote peer must not be able
        to point the engine at arbitrary host files."""
        base = os.environ.get(ckpt_mod.CKPT_DIR_ENV, "")
        if not base:
            raise RuntimeError(
                "checkpointing not configured: set GOL_CKPT or pass "
                "--checkpoint DIR")
        target = os.path.join(base, req) if req else base
        real_base = os.path.realpath(base)
        real_target = os.path.realpath(target)
        if (real_target != real_base
                and not real_target.startswith(real_base + os.sep)):
            raise PermissionError(
                f"restore path {req!r} escapes the checkpoint directory")
        return self.engine.restore_run(target, reshard=reshard)


def _final_flush(reason: str) -> None:
    """Last writes on paths that end in os._exit (which skips atexit):
    the flight-recorder dump and the span export. Both are no-ops unless
    their env vars are set, and neither can raise."""
    obs_flight.FLIGHT.dump(reason)
    trace.export_from_env()


def _exit_after_flush() -> None:
    _final_flush("manual")
    os._exit(0)


def _sigterm_checkpoint(engine, ckpt_dir: str) -> None:
    """SIGTERM's checkpoints: a durable manifest first (verified,
    retained, resumable by --resume DIR), then the legacy single-file
    autosave. A failure is logged; the server still exits 0."""
    try:
        path, turn = engine.checkpoint_now(trigger="sigterm")
        obs_log("server.sigterm_checkpoint", turn=turn, path=path)
    except Exception as e:
        obs_exception("server.sigterm_checkpoint_failed", e)
    # Fleet residents: every non-legacy run gets its own per-run
    # manifest, so a replacement server can restore the whole fleet.
    ckpt_fleet = getattr(engine, "checkpoint_fleet", None)
    if ckpt_fleet is not None:
        try:
            n = ckpt_fleet(trigger="sigterm")
            obs_log("server.sigterm_fleet_checkpoint", runs=n)
        except Exception as e:
            obs_exception("server.sigterm_checkpoint_failed", e)
    try:
        board = engine.stats()["board"]
        if board is not None:
            h, w = board
            os.makedirs(ckpt_dir, exist_ok=True)
            engine.save_checkpoint(os.path.join(ckpt_dir, f"{w}x{h}.npz"))
    except Exception as e:
        obs_exception("server.sigterm_checkpoint_failed", e)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="gol_tpu_torch engine server (one CUDA GPU)")
    ap.add_argument("--port", type=int,
                    default=int(os.environ.get("GOL_PORT", DEFAULT_PORT)))
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--rule", metavar="RULE",
                    default=os.environ.get("GOL_RULE") or "B3/S23",
                    help="rulestring this engine evolves: life-like "
                         "'B3/S23', Generations 'survival/birth/states'"
                         " (e.g. '/2/3' = Brian's Brain), Larger-than-"
                         "Life 'R5,C0,M1,S33..57,B34..45,NM' or Lenia "
                         "'lenia:r=13,mu=0.15,sigma=0.015,dt=0.1' "
                         "(default Conway; falls back to GOL_RULE)")
    ap.add_argument("--trace-spans", metavar="PATH", default="",
                    help="export handler spans as Chrome trace-event JSON "
                         "to PATH on shutdown (sets GOL_TRACE_SPANS; a "
                         "directory gets one file per pid)")
    ap.add_argument("--metrics-port", type=int, default=None,
                    metavar="PORT",
                    help="serve Prometheus text on "
                         "http://127.0.0.1:PORT/metrics, plus /healthz "
                         "and /profile (0 = ephemeral port; unset = no "
                         "endpoint)")
    ap.add_argument("--profile-dir", metavar="DIR", default="",
                    help="directory for on-demand torch.profiler captures "
                         "(the Profile method and POST /profile arm one; "
                         "the peer only picks the turn count, this flag "
                         "fixes where the Chrome traces land)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the engine (default cuda; without a "
                         "CUDA device the server exits unless --device "
                         "cpu is given)")
    ap.add_argument("--sparse", metavar="SIZE", type=int, default=0,
                    help="serve a sparse-torus engine of SIZE x SIZE "
                         "cells (SIZE %% 32 == 0, e.g. 1048576 = 2^20) "
                         "instead of the dense engine: runs are seeded "
                         "by a small pattern board, snapshots are the "
                         "live window (life-like rules only)")
    ap.add_argument("--fleet", action="store_true",
                    help="serve the batched multi-run fleet engine: "
                         "many resident runs stepped in shared "
                         "size-bucket launches, admitted against a "
                         "device-memory budget (CreateRun/ListRuns/"
                         "AttachRun/DestroyRun/SetRule + run_id routing "
                         "on the existing methods; peers that never send "
                         "run_id get the legacy single run, "
                         "bit-identically; life-like rules only; "
                         "GOL_FLEET_BUCKETS/GOL_FLEET_CHUNK/"
                         "GOL_FLEET_MEM_BUDGET tune it)")
    ap.add_argument("--resume", metavar="DIR|MANIFEST|NPZ", default="",
                    help="restore (board, turn) before serving: a "
                         "checkpoint directory (newest durable manifest "
                         "wins), a ckpt-*.json manifest (payload SHA-256 "
                         "verified), or a legacy .npz autosave — of "
                         "either package")
    ap.add_argument("--reshard", action="store_true",
                    help="allow --resume to adopt a checkpoint whose "
                         "recorded geometry (mesh device count, sparse "
                         "window) differs from this engine: the payload "
                         "is repacked host-side, bit-identically; "
                         "without this flag a mismatched resume is "
                         "refused")
    ap.add_argument("--checkpoint", metavar="DIR", default="",
                    help="checkpoint directory (sets GOL_CKPT): runs "
                         "write gol-ckpt/1 manifest checkpoints here "
                         "when --ckpt-every is set, plus the legacy "
                         "time-based autosave; SIGTERM checkpoints here "
                         "before the server exits")
    ap.add_argument("--ckpt-every", metavar="TURNS", type=int, default=0,
                    help="manifest checkpoint cadence in TURNS (sets "
                         "GOL_CKPT_EVERY_TURNS; 0 = off; requires "
                         "--checkpoint)")
    ap.add_argument("--ckpt-keep", metavar="N", type=int, default=0,
                    help="retention: keep the newest N checkpoints "
                         "(sets GOL_CKPT_KEEP; default 3; "
                         "GOL_CKPT_KEEP_EVERY additionally pins every "
                         "K-th turn)")
    ap.add_argument("--journal", metavar="DIR", default="",
                    help="run journal root (sets GOL_JOURNAL): each run "
                         "appends a hash-chained gol-journal/1 JSONL log "
                         "replayable by tools/replay_audit.py")
    ap.add_argument("--journal-digest-every", metavar="TURNS", type=int,
                    default=0,
                    help="board-digest journal events every TURNS (sets "
                         "GOL_JOURNAL_DIGEST_EVERY; default 512)")
    ap.add_argument("--federate", metavar="ROUTER_ADDR", default="",
                    help="join a federation: register with the router "
                         "at host:port and heartbeat every "
                         "GOL_FED_HEARTBEAT seconds (the router "
                         "declares this member dead after "
                         "GOL_FED_DEAD_AFTER of silence and re-homes "
                         "its runs from the shared GOL_CKPT root)")
    ap.add_argument("--coordinator", metavar="HOST:PORT", default="",
                    help="join a torch.distributed group at this "
                         "address before any CUDA context (falls back to "
                         "GOL_COORDINATOR, with GOL_NUM_PROCS and "
                         "GOL_PROC_ID; unset = one process); the served "
                         "engine still shards over this process's "
                         "devices only")
    ap.add_argument("--advertise", metavar="HOST", default="127.0.0.1",
                    help="hostname the router should dial this member "
                         "back on (default 127.0.0.1; the port is the "
                         "bound serving port)")
    args = ap.parse_args(argv)
    if args.fleet and args.sparse:
        ap.error("--fleet and --sparse are mutually exclusive")
    if args.trace_spans:
        os.environ[trace.TRACE_SPANS_ENV] = args.trace_spans
    ckpt_mod.export_flags(args)
    if args.profile_dir:
        # configure() only: the server arms nothing at startup; a
        # Profile RPC or POST /profile picks the moment and turn count.
        PROFILER.configure(args.profile_dir)
    trace.set_process_name("gol-server")
    # Join the multi-process group first, before any CUDA context is made
    # (`parallel/multihost.py`).
    from gol_tpu_torch.parallel import multihost

    joined = multihost.initialize(args.coordinator or None)
    from gol_tpu_torch.models import parse_rule

    try:
        if args.sparse:
            from gol_tpu_torch.sparse_engine import SparseEngine

            eng = SparseEngine(args.sparse, rule=parse_rule(args.rule),
                               device=args.device)
        elif args.fleet:
            from gol_tpu_torch.fleet import FleetEngine

            eng = FleetEngine(rule=parse_rule(args.rule),
                              device=args.device)
        else:
            eng = Engine(device=args.device, rule=parse_rule(args.rule))
    except (RuntimeError, ValueError) as e:
        print(f"gol_tpu_torch.server: {e}", file=sys.stderr, flush=True)
        return 1
    if joined:
        import torch.distributed as dist

        # The group is there for direct `parallel.halo` meshes
        # (`multihost.make_global_mesh`); this engine shards over its own
        # process's devices, which the line says beside the group's.
        own = getattr(eng, "_devices", [eng.device])
        every = multihost.global_devices(own)
        print(f"multi-process group: process {dist.get_rank()}/"
              f"{dist.get_world_size()}, {len(every)} device(s), backend "
              f"{dist.get_backend()}; this engine serves its own "
              f"{len(own)} device(s)", flush=True)
    if args.resume:
        try:
            turn = eng.restore_run(args.resume, reshard=args.reshard)
        except (OSError, ValueError) as e:
            print(f"gol_tpu_torch.server: --resume {args.resume}: {e}",
                  file=sys.stderr, flush=True)
            return 1
        print(f"restored checkpoint {args.resume} at turn {turn}"
              + (" (resharded)" if args.reshard else ""), flush=True)
    srv = EngineServer(port=args.port, host=args.host, engine=eng)

    def _on_term(signo, frame):
        # Graceful drain: stop accepting first, give in-flight handlers a
        # bounded window to finish (their replies are the point of
        # draining), then — with GOL_CKPT set — checkpoint, and exit 0:
        # an orderly stop loses no turn, and a replacement server
        # `--resume DIR` picks up where this one ended.
        t_drain = time.monotonic()
        n0 = srv.inflight()
        deadline = env_float(DRAIN_DEADLINE_ENV, DRAIN_DEADLINE_DEFAULT)
        obs.SERVER_DRAIN_INFLIGHT.set(n0)
        obs_log("server.drain_begin", level="warning", inflight=n0,
                deadline_s=deadline)
        srv.shutdown()
        left = srv.wait_drained(deadline)
        ckpt_dir = os.environ.get(ckpt_mod.CKPT_DIR_ENV, "")
        if ckpt_dir:
            _sigterm_checkpoint(srv.engine, ckpt_dir)
        dur = time.monotonic() - t_drain
        obs.SERVER_DRAIN_SECONDS.set(dur)
        obs_log("server.drain", level="warning", inflight_start=n0,
                inflight_left=left, duration_s=round(dur, 3))
        _final_flush("sigterm")
        os._exit(0)

    signal.signal(signal.SIGTERM, _on_term)
    if args.metrics_port is not None:
        from gol_tpu_torch.obs.http import start_metrics_server

        msrv = start_metrics_server(args.metrics_port)
        print(f"metrics on {msrv.url}", flush=True)
    agent = None
    if args.federate:
        from gol_tpu_torch.federation.agent import FederationAgent

        # The Rescale coordinator pins redirects at this router, as this
        # member. The port's engine holds one device: capacity 1.
        srv._fed_router = args.federate
        srv._self_addr = f"{args.advertise}:{srv.port}"
        agent = FederationAgent(
            args.federate, srv._self_addr,
            capacity=1, mesh={"devices": 1}).start()
    # This banner is the readiness contract: harnesses parse
    # "serving on :<port>" from stdout to learn the bound port.
    print(f"gol_tpu_torch engine serving on :{srv.port} "
          f"(device {eng.device}, rule {eng._rule.rulestring}"
          + (f", sparse torus {args.sparse}" if args.sparse else "")
          + (", fleet" if args.fleet else "") + ")",
          flush=True)
    srv.serve_forever()
    if agent is not None:
        agent.stop()
    # Orderly stop (accept loop closed, e.g. KillProg without the exit
    # timer): still export whatever spans were recorded.
    trace.export_from_env()
    return 0


if __name__ == "__main__":
    sys.exit(main())
