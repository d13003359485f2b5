"""Viewer gateway: the C10k half of the broadcast tier — the counterpart
of `gol_tpu/gateway.py`.

One `selectors`-based event-loop thread owns every Subscribe-upgraded
socket, replacing thread-per-connection FOR THE STREAMING PATH ONLY —
control-plane RPCs (and legacy raw-u8 / per-viewer GetView peers) keep
the server's threaded dispatch untouched. The accept path stays as-is
too: a Subscribe request arrives on a normal threaded connection, the
handler sends the ACK reply, then hands the live socket here
(`adopt`); the handler thread exits immediately, so ten thousand
subscribers never occupy conn slots or threads.

Per subscriber the gateway holds a few ints and a memoryview into the
stream's shared frozen frame — O(1) memory per viewer, zero copies.
Writes are non-blocking with partial-send resume; a stalled socket is
skipped forward to the stream's newest keyframe at the next frame
boundary (never mid-frame — framing integrity), with the skipped
frames metered as `gol_bcast_frames_dropped_total`. Fan-out latency
(frame publication -> last byte handed to a subscriber socket) feeds a
log-bucket estimator (`obs/slo.py`) flushed to `gol_bcast_fanout_ms{q}`.

Adopted sockets get TCP_NODELAY + SO_KEEPALIVE, matching the server
accept-path posture; `GOL_GATEWAY_MAX` caps adopted connections.
"""

from __future__ import annotations

import selectors
import socket
import threading
import time
from collections import deque
from typing import Optional

from gol_tpu_torch import wire
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import slo as obs_slo
from gol_tpu_torch.obs import usage as obs_usage
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.utils.envcfg import env_int

GATEWAY_MAX_ENV = "GOL_GATEWAY_MAX"
GATEWAY_MAX_DEFAULT = 16384

# Metrics/gauge flush cadence, the SLO layer's batching discipline.
FLUSH_SECONDS = 0.5

_READ = selectors.EVENT_READ
_WRITE = selectors.EVENT_WRITE


class _Sub:
    """One adopted subscriber socket and its stream cursor."""

    __slots__ = ("sock", "fd", "stream", "next_seq", "cur", "mv", "off",
                 "want_write")

    def __init__(self, sock: socket.socket, stream) -> None:
        self.sock = sock
        self.fd = sock.fileno()
        self.stream = stream
        self.next_seq = 0
        self.cur = None      # BcastFrame currently being sent
        self.mv = None       # memoryview into cur.raw
        self.off = 0
        self.want_write = False


class ViewerGateway:
    def __init__(self) -> None:
        self._sel = selectors.DefaultSelector()
        # Self-wake pipe: adopt()/notify() from any thread nudge the
        # select() out of its sleep.
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, _READ, None)
        self._adopt_q: deque = deque()
        self._lock = threading.Lock()
        self._subs: dict = {}  # fd -> _Sub
        self._max = env_int(GATEWAY_MAX_ENV, GATEWAY_MAX_DEFAULT)
        self._reserved = 0  # adopted + mid-adoption, for the cap
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        self._fanout = obs_slo.LogBucketEstimator()
        self._fanout_lock = threading.Lock()
        self._samples: list = []
        self._sent_bytes = 0
        self._sent_msgs = 0
        # Delivered per-run (frames, bytes) since the last flush —
        # touched only by the event-loop thread, handed to the usage
        # meter at the 0.5 s flush.
        self._usage_pend: dict = {}
        self._last_flush = 0.0

    # --------------------------------------------------------- lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name="gol-gateway", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        with self._lock:
            self._stopping = True
        self.notify()
        if self._thread is not None:
            self._thread.join(timeout=2.0)

    def connections(self) -> int:
        with self._lock:
            return self._reserved

    # ---------------------------------------------------------- adoption

    def try_reserve(self) -> bool:
        """Claim one connection slot under GOL_GATEWAY_MAX. The server
        reserves BEFORE sending the Subscribe ACK so an over-capacity
        peer gets an error reply, never a dead ACKed socket."""
        with self._lock:
            if self._stopping or self._reserved >= self._max:
                return False
            self._reserved += 1
            return True

    def release_reservation(self) -> None:
        with self._lock:
            self._reserved = max(0, self._reserved - 1)

    def adopt(self, conn: socket.socket, stream) -> None:
        """Hand an ACKed, upgraded socket to the event loop. Requires a
        successful `try_reserve`; never blocks and never raises."""
        with self._lock:
            self._adopt_q.append((conn, stream))
        self.notify()

    def notify(self) -> None:
        """Wake the loop (new adoptions, or the hub published frames).
        Coalescing is fine — one byte wakes one scan."""
        try:
            self._wake_w.send(b"\x01")
        except (BlockingIOError, InterruptedError):
            pass  # wake pipe already full = a wake is already pending
        except OSError:
            pass

    # --------------------------------------------------------- telemetry

    def fanout_snapshot(self) -> dict:
        """Flush pending samples and return the estimator snapshot
        ({count, sum, p50, p95, p99} in seconds) — bench/test surface."""
        with self._fanout_lock:
            if self._samples:
                self._fanout.observe_batch(self._samples)
                self._samples = []
            return self._fanout.snapshot()

    def fanout_reset(self) -> None:
        """Discard accumulated fan-out samples. Admission catch-up
        frames carry the PUBLISH timestamp of a frame that predates
        the subscriber, so a measured window opened after a population
        change should reset first or its tail is attach lag, not
        fan-out latency."""
        with self._fanout_lock:
            self._fanout = obs_slo.LogBucketEstimator()
            self._samples = []

    # -------------------------------------------------------- event loop

    def _loop(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    break
            try:
                events = self._sel.select(timeout=FLUSH_SECONDS)
            except OSError:
                break
            now = time.monotonic()
            woke = False
            for key, mask in events:
                if key.data is None:
                    self._drain_wake()
                    woke = True
                    continue
                sub = key.data
                if mask & _READ:
                    self._on_readable(sub)
                if sub.fd in self._subs and (mask & _WRITE):
                    self._pump(sub, now)
            self._admit_pending(now)
            if woke:
                # Frames were published (or streams closed): pump every
                # subscriber that is not already write-blocked — blocked
                # ones resume via their EVENT_WRITE readiness.
                for sub in list(self._subs.values()):
                    if not sub.want_write:
                        self._pump(sub, now)
            if now - self._last_flush >= FLUSH_SECONDS:
                self._flush(now)
        self._teardown()

    def _drain_wake(self) -> None:
        try:
            while self._wake_r.recv(4096):
                pass
        except (BlockingIOError, InterruptedError):
            pass
        except OSError:
            pass

    def _admit_pending(self, now: float) -> None:
        while True:
            with self._lock:
                if not self._adopt_q:
                    return
                conn, stream = self._adopt_q.popleft()
            try:
                conn.setblocking(False)
                wire.enable_nodelay(conn)
                conn.setsockopt(socket.SOL_SOCKET, socket.SO_KEEPALIVE, 1)
            except OSError:
                self._close_quiet(conn)
                self.release_reservation()
                continue
            sub = _Sub(conn, stream)
            sub.next_seq = stream.attach()
            self._subs[sub.fd] = sub
            try:
                self._sel.register(conn, _READ, sub)
            except (OSError, ValueError):
                self._subs.pop(sub.fd, None)
                stream.detach()
                self._close_quiet(conn)
                self.release_reservation()
                continue
            self._pump(sub, now)

    def _pump(self, sub: _Sub, now: float) -> None:
        """Push stream bytes until the socket blocks or the subscriber
        is caught up. Skips (and meters) frames the ring dropped."""
        try:
            while True:
                if sub.mv is not None:
                    n = sub.sock.send(sub.mv[sub.off:])
                    self._sent_bytes += n
                    pend = self._usage_pend.setdefault(
                        sub.stream.run_id or "run0", [0, 0])
                    pend[1] += n
                    sub.off += n
                    if sub.off < len(sub.mv):
                        self._set_write(sub, True)
                        return
                    # Frame fully handed to the kernel: the fan-out
                    # latency sample for this (frame, subscriber).
                    self._sent_msgs += 1
                    self._usage_pend.setdefault(
                        sub.stream.run_id or "run0", [0, 0])[0] += 1
                    cur = sub.cur
                    sub.mv = None
                    sub.cur = None
                    if cur is not None:
                        with self._fanout_lock:
                            self._samples.append(max(0.0, now - cur.t_pub))
                        if cur.end:
                            self._disconnect(sub)
                            return
                nxt = sub.stream.next_frame(sub.next_seq)
                if nxt is None:
                    self._set_write(sub, False)
                    return
                frame, skipped = nxt
                if skipped:
                    obs.BCAST_FRAMES_DROPPED.inc(skipped)
                sub.cur = frame
                sub.mv = memoryview(frame.raw)
                sub.off = 0
                sub.next_seq = frame.seq + 1
        except (BlockingIOError, InterruptedError):
            self._set_write(sub, True)
        except OSError:
            self._disconnect(sub)

    def _on_readable(self, sub: _Sub) -> None:
        """Subscribers are server-push only: any bytes the peer sends
        are discarded; EOF or an error hangs the subscriber up."""
        try:
            while True:
                data = sub.sock.recv(1 << 16)
                if not data:
                    self._disconnect(sub)
                    return
        except (BlockingIOError, InterruptedError):
            return
        except OSError:
            self._disconnect(sub)

    def _set_write(self, sub: _Sub, want: bool) -> None:
        if want == sub.want_write:
            return
        sub.want_write = want
        try:
            self._sel.modify(sub.sock, _READ | (_WRITE if want else 0), sub)
        except (OSError, ValueError, KeyError):
            self._disconnect(sub)

    def _disconnect(self, sub: _Sub) -> None:
        try:
            self._sel.unregister(sub.sock)
        except (OSError, ValueError, KeyError):
            pass
        self._close_quiet(sub.sock)
        self._subs.pop(sub.fd, None)
        sub.stream.detach()
        self.release_reservation()

    @staticmethod
    def _close_quiet(sock_: socket.socket) -> None:
        try:
            sock_.close()
        except OSError:
            pass

    def _flush(self, now: float) -> None:
        self._last_flush = now
        with self._fanout_lock:
            if self._samples:
                self._fanout.observe_batch(self._samples)
                self._samples = []
            snap = self._fanout.snapshot()
        if snap["count"]:
            obs.BCAST_FANOUT_MS.labels(q="p50").set(snap["p50"] * 1e3)
            obs.BCAST_FANOUT_MS.labels(q="p95").set(snap["p95"] * 1e3)
            obs.BCAST_FANOUT_MS.labels(q="p99").set(snap["p99"] * 1e3)
        if self._sent_bytes:
            obs.BCAST_SENT_BYTES.inc(self._sent_bytes)
            obs.WIRE_BYTES.labels(direction="sent").inc(self._sent_bytes)
            obs.WIRE_MESSAGES.labels(direction="sent").inc(self._sent_msgs)
            self._sent_bytes = 0
            self._sent_msgs = 0
        if self._usage_pend:
            # Delivered per-(run, subscriber) attribution.
            obs_usage.METER.charge_broadcast_sent(self._usage_pend)
            self._usage_pend = {}
        obs.BCAST_SUBSCRIBERS.set(len(self._subs))
        obs.GATEWAY_CONNECTIONS.set(self.connections())

    def _teardown(self) -> None:
        for sub in list(self._subs.values()):
            self._disconnect(sub)
        try:
            self._sel.unregister(self._wake_r)
        except (OSError, ValueError, KeyError):
            pass
        self._close_quiet(self._wake_r)
        self._close_quiet(self._wake_w)
        try:
            self._sel.close()
        except OSError:
            pass
        self._flush(time.monotonic())
        obs_log("gateway.stopped", level="info")
