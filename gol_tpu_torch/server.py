"""Engine server: the broker-host process of the reference, on one CUDA
GPU — the counterpart of `gol_tpu/server.py`, wire-compatible with it in
both directions (a JAX controller drives this server, and the port's
controller drives a JAX server).

Wraps an `Engine` behind the control protocol
(`Server/gol/distributor.go:54-83` — ServerDistributor / Alivecount /
GetWorld / CFput / KillProg, plus Ping, Stats, GetMetrics, GetView,
DrainFlags, AbortRun, Checkpoint, RestoreRun and GetJournal) on a TCP
socket (default :8080, the reference broker port, `Server:235`).
Long-running: survives controller detach and serves `GetWorld` for
`CONT=yes` reattach, as the Go broker holds `world`/`turn` in globals.
With `--checkpoint DIR` a SIGTERM drains, writes a manifest checkpoint
and the legacy `WxH.npz`, and exits 0; `--resume` restores before
serving. The methods of later slices (subscriptions, fleet runs,
migration, sparse windows) answer with an error naming their ROADMAP
item; the connection is served as usual.

Run:  python -m gol_tpu_torch.server [--port 8080] [--device cpu]
          [--checkpoint DIR [--ckpt-every TURNS]] [--resume DIR|MANIFEST|NPZ]
"""

from __future__ import annotations

import argparse
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
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import flight as obs_flight
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs import trace
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

# Methods of the protocol that later slices of the port bring, and the
# ROADMAP item each waits for.
NOT_YET_PORTED = {
    "Subscribe": "A13", "GetTelemetry": "A13", "GetAudit": "A13",
    "GetUsage": "A13", "Profile": "A13",
    "CreateRun": "A11", "ListRuns": "A11", "AttachRun": "A11",
    "DestroyRun": "A11", "SetRule": "A11",
    "AdoptRun": "A13", "Rescale": "A13", "ReceiveRun": "A13",
    "CommitRun": "A13",
    "GetWindow": "A10",
}


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
        t.start()
        return t

    def shutdown(self) -> None:
        self._shutdown.set()
        try:
            self._sock.close()
        except OSError:
            pass

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
        send_msg(conn, header, frame=frame)

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
                     fy: int, fx: int):
        """Frame a GetView reply, delta-encoding (xrle) against the frame
        this viewer already holds when the negotiation, the engine's
        diffability and the client's declared basis all line up; then
        remember `out` as the viewer's new basis."""
        vkey = self._view_cache_key(header)
        use_cache = (wire.CAP_XRLE in caps
                     and getattr(self.engine, "frames_diffable", False)
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
            binary=self.engine.binary_pixels)
        if use_cache:
            with self._view_cache_lock:
                self._view_cache.pop(vkey, None)
                self._view_cache[vkey] = (turn, (fy, fx), out)
                while len(self._view_cache) > self.VIEW_CACHE_MAX:
                    self._view_cache.pop(next(iter(self._view_cache)))
        return frame

    @staticmethod
    def _view_cache_key(header: dict):
        """The per-viewer basis-cache key of a GetView request, or None
        when the request names no usable viewer."""
        vkey = header.get("vkey")
        if not (isinstance(vkey, str) and 0 < len(vkey) <= 64):
            return None
        return vkey

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
        caps = wire.ConnectionEncoder(header).caps
        if self._dedupe_check(conn, method, label, header):
            return
        eng = self.engine
        try:
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
                aborted = eng.abort_run(header.get("token"))
                self._reply(conn, {"ok": True, "aborted": aborted})
            elif method == "Ping":
                self._reply(conn, {"ok": True, "turn": eng.ping()})
            elif method == "Stats":
                self._reply(conn, {"ok": True, "stats": eng.stats()})
            elif method == "GetMetrics":
                self._reply(conn,
                            {"ok": True, "metrics": REGISTRY.snapshot()})
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
                # O(max_cells) downsampled live-view frame of the board.
                out, turn, (fy, fx) = eng.get_view(
                    int(header.get("max_cells", 0)))
                try:
                    self._reply(conn, {"ok": True, "turn": turn,
                                       "fy": fy, "fx": fx},
                                frame=self._encode_view(header, caps, out,
                                                        turn, fy, fx))
                except (ConnectionError, OSError):
                    self._drop_view_basis(header)
                    raise
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
            elif method == "KillProg":
                eng.kill_prog()
                self._reply(conn, {"ok": True})
                # The reference broker and workers die on KillProg
                # (os.Exit(0), `SubServer/distributor.go:42-45`): bring
                # the server down.
                self.shutdown()
                if os.environ.get("GOL_SERVER_EXIT_ON_KILL", "1") == "1":
                    threading.Timer(0.2, _exit_after_flush).start()
            elif method in NOT_YET_PORTED:
                raise NotImplementedError(
                    f"{method} is not ported to gol_tpu_torch yet "
                    f"(ROADMAP {NOT_YET_PORTED[method]})")
            else:
                self._reply(conn, {"ok": False,
                                   "error": f"unknown method {method!r}"})
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
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="device of the engine (default cuda; without a "
                         "CUDA device the server exits unless --device "
                         "cpu is given)")
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
    args = ap.parse_args(argv)
    if args.trace_spans:
        os.environ[trace.TRACE_SPANS_ENV] = args.trace_spans
    ckpt_mod.export_flags(args)
    trace.set_process_name("gol-server")
    from gol_tpu_torch.models import parse_rule

    try:
        eng = Engine(device=args.device, rule=parse_rule(args.rule))
    except (RuntimeError, ValueError) as e:
        print(f"gol_tpu_torch.server: {e}", file=sys.stderr, flush=True)
        return 1
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
    # This banner is the readiness contract: harnesses parse
    # "serving on :<port>" from stdout to learn the bound port.
    print(f"gol_tpu_torch engine serving on :{srv.port} "
          f"(device {eng.device}, rule {eng._rule.rulestring})",
          flush=True)
    srv.serve_forever()
    # Orderly stop (accept loop closed, e.g. KillProg without the exit
    # timer): still export whatever spans were recorded.
    trace.export_from_env()
    return 0


if __name__ == "__main__":
    sys.exit(main())
