"""Broadcast tier: encode-once epoch streams for live-view fan-out — the
counterpart of `gol_tpu/broadcast.py`, frame for frame: the same surface
script gives the same frozen bytes in either package.

The per-viewer GetView path encodes a reply per poll per viewer — N
watchers of one popular run cost N encodes and N threads. This module
inverts that: each (run, view geometry) with subscribers gets ONE
`EpochStream`, whose publish path encodes each frame exactly once
(`gol_wire_encode_calls_total` advances by 1 per publication — the
bench.py --broadcast zero-work witness) into a bounded ring of frozen,
ready-to-send wire messages. Any number of subscribers consume the same
immutable bytes through the selectors gateway (gateway.py);
fan-out cost is send syscalls, not re-encoding.

Stream format (reconnect-keyframe semantics, shared):

  * a **keyframe** every `GOL_BCAST_KEYFRAME` published frames — a
    plain-codec frame decodable with no prior state. An xrle delta that
    loses to its plain encoding also ships plain and counts as a
    keyframe (it is standalone by construction).
  * **deltas** between keyframes — xrle against the shared epoch basis
    (the previous published frame), exactly the codec GetView speaks,
    so subscriber frames are bit-identical to what a per-viewer poll at
    the same turn would decode to.
  * the **epoch** increments whenever the basis is invalidated (view
    geometry change, turn regression from a restore) — the next frame
    is forced to a keyframe, mirroring the per-viewer cache's
    basis-mismatch keyframe resend.

Slow subscribers never backpressure the ring or the chunk loop: the
ring is bounded, and a subscriber that falls off its tail is skipped
forward to the newest keyframe by the gateway (dropped frames metered
as `gol_bcast_frames_dropped_total`). New subscribers also start at the
newest keyframe.

The `BroadcastHub` owns the streams and one publisher thread, woken by
the engines' per-chunk `_bcast_notify` poke (`threading.Event.set` —
cheap, never raises) and paced to `GOL_BCAST_HZ`; streams with no
subscribers are not published at all, preserving the no-viewer
zero-work property of the chunk loop.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from gol_tpu_torch import wire
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import usage as obs_usage
from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.utils.envcfg import env_float, env_int

# Keyframe cadence: one standalone frame per this many published frames.
KEYFRAME_ENV = "GOL_BCAST_KEYFRAME"
KEYFRAME_DEFAULT = 16
# Ring capacity floor (frames); raised to keyframe cadence + 2 so the
# newest keyframe is always still in (or newer than) the ring tail a
# lagging subscriber resyncs against.
RING_ENV = "GOL_BCAST_RING"
RING_DEFAULT = 64
# Publish pacing ceiling, frames per second per stream.
HZ_ENV = "GOL_BCAST_HZ"
HZ_DEFAULT = 20.0


class BcastFrame:
    """One frozen wire message in a stream's ring: the complete framed
    header + payload bytes every subscriber receives verbatim."""

    __slots__ = ("seq", "turn", "key", "raw", "t_pub", "end")

    def __init__(self, seq: int, turn: int, key: bool, raw: bytes,
                 t_pub: float, end: bool = False) -> None:
        self.seq = seq
        self.turn = turn
        self.key = key
        self.raw = raw
        self.t_pub = t_pub
        self.end = end


class EpochStream:
    """Encode-once frame ring for one (run, view geometry).

    `publish()` is serialized by `_pub_lock` (the hub thread plus
    test/bench `publish_now` callers); `_lock` guards only the ring and
    subscriber count so the gateway's `next_frame` never waits on an
    in-progress device readback."""

    def __init__(self, run_id: str, surface, max_cells: int,
                 caps: Optional[frozenset] = None) -> None:
        self.run_id = run_id  # "" = the legacy single run
        self.max_cells = int(max_cells)
        self._surface = surface
        # Pinned at creation: every subscriber shares these bytes, so a
        # peer must negotiate a superset (the server refuses Subscribe
        # otherwise and the client falls back to per-viewer GetView).
        self.caps = frozenset(caps) if caps is not None else wire.local_caps()
        self.keyframe_every = env_int(KEYFRAME_ENV, KEYFRAME_DEFAULT)
        self._ring_cap = max(env_int(RING_ENV, RING_DEFAULT, minimum=2),
                             self.keyframe_every + 2)
        self._min_interval = 1.0 / max(env_float(HZ_ENV, HZ_DEFAULT), 1e-3)
        self._ring: deque = deque()
        self._latest_key: Optional[BcastFrame] = None
        self._lock = threading.Lock()
        self._pub_lock = threading.Lock()
        self._seq = 0
        self.epoch = 0
        self._since_key = 0
        self._basis = None  # (turn, (fy, fx), pixels)
        self._last_turn = -1
        self._last_pub_t = float("-inf")
        self.closed = False
        self.subscribers = 0

    # ---------------------------------------------------- subscriber side

    def attach(self) -> int:
        """Register one subscriber; returns the seq it starts at — the
        newest keyframe, so its first frame decodes with no basis."""
        with self._lock:
            self.subscribers += 1
            k = self._latest_key
            return k.seq if k is not None else self._seq

    def detach(self) -> None:
        with self._lock:
            self.subscribers = max(0, self.subscribers - 1)

    def next_frame(self, next_seq: int):
        """The frame a subscriber positioned at `next_seq` should send
        next: (frame, frames skipped) — skipped > 0 when the ring
        overtook the subscriber and it resyncs at the newest keyframe —
        or None when it is caught up."""
        with self._lock:
            ring = self._ring
            if not ring:
                return None
            head = ring[0].seq
            if next_seq > ring[-1].seq:
                return None
            if next_seq >= head:
                return ring[next_seq - head], 0
            k = self._latest_key
            if k is None or k.seq < next_seq:
                # Defensive only: the ring-capacity floor keeps the
                # newest keyframe ahead of any evicted seq.
                return ring[0], head - next_seq
            return k, k.seq - next_seq

    # ------------------------------------------------------- publish side

    def publish(self, now: Optional[float] = None,
                force: bool = False) -> Optional[BcastFrame]:
        """Encode and ring the current view once, if due. Returns the
        frame published this call (a repeated turn returns the ring
        tail without re-encoding), or None when paced off / unchanged.
        Surface failures (engine killed, run evicted) propagate — the
        hub closes the stream."""
        with self._pub_lock:
            if self.closed:
                return None
            if now is None:
                now = time.monotonic()
            if not force and now - self._last_pub_t < self._min_interval:
                return None
            surface = self._surface
            if not force and hasattr(surface, "ping"):
                # Cheap turn probe before the device readback: an idle
                # (paused) run publishes nothing.
                if surface.ping() == self._last_turn:
                    return None
            out, turn, (fy, fx) = surface.get_view(self.max_cells)
            if turn == self._last_turn and self._seq > 0:
                with self._lock:
                    return self._ring[-1] if self._ring else None
            return self._publish_frame(out, turn, fy, fx, now)

    def _publish_frame(self, out, turn: int, fy: int, fx: int,
                       now: float) -> BcastFrame:
        basis = self._basis
        invalidated = basis is not None and (
            basis[1] != (fy, fx) or basis[2].shape != out.shape
            or turn < basis[0])
        if invalidated:
            # Geometry change or turn regression: the shared basis is
            # dead — new epoch, forced keyframe (reconnect semantics).
            self.epoch += 1
            basis = None
        want_delta = (basis is not None
                      and self._since_key < self.keyframe_every
                      and wire.CAP_XRLE in self.caps)
        frame = wire.encode_view_frame(
            out, self.caps,
            basis=basis[2] if want_delta else None,
            basis_turn=basis[0] if want_delta else None,
            binary=getattr(self._surface, "binary_pixels", None))
        key = frame.codec != wire.CODEC_XRLE
        header = {"ok": True, "push": "frame", "seq": self._seq,
                  "turn": int(turn), "fy": int(fy), "fx": int(fx),
                  "epoch": self.epoch, "key": key}
        if self.run_id:
            header["run_id"] = self.run_id
        raw = wire.freeze_message(header, frame)
        bf = BcastFrame(self._seq, int(turn), key, raw, now)
        with self._lock:
            self._ring.append(bf)
            while len(self._ring) > self._ring_cap:
                self._ring.popleft()
            if key:
                self._latest_key = bf
            self._seq += 1
        obs.BCAST_FRAMES.labels(kind="key" if key else "delta").inc()
        # Publish-side attribution, pre fan-out; "" = the legacy
        # single-run stream, owned by run "run0".
        obs_usage.METER.charge_broadcast(self.run_id or "run0", 1, len(raw))
        self._since_key = 0 if key else self._since_key + 1
        self._basis = (int(turn), (int(fy), int(fx)), out)
        self._last_turn = int(turn)
        self._last_pub_t = now
        return bf

    def close(self, error: Optional[str] = None) -> None:
        """Ring an end sentinel and refuse further publishes. The
        gateway disconnects each subscriber after delivering it."""
        with self._pub_lock:
            if self.closed:
                return
            self.closed = True
            header = {"ok": False, "push": "end", "seq": self._seq,
                      "error": error or "killed: stream closed"}
            raw = wire.freeze_message(header)
            bf = BcastFrame(self._seq, self._last_turn, False, raw,
                            time.monotonic(), end=True)
            with self._lock:
                self._ring.append(bf)
                while len(self._ring) > self._ring_cap:
                    self._ring.popleft()
                self._seq += 1


class BroadcastHub:
    """Stream registry + the single publisher thread.

    Engines poke `self.poke` (installed as their `_bcast_notify`) when
    turns retire; the publisher scans subscribed streams at most once
    per `GOL_BCAST_HZ` interval, publishes whatever advanced, then
    calls the sink (the gateway's notify) so subscribers are pumped."""

    def __init__(self) -> None:
        self._streams: dict = {}
        self._lock = threading.Lock()
        self._event = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._sink = None
        self._interval = 1.0 / max(env_float(HZ_ENV, HZ_DEFAULT), 1e-3)

    def start(self, sink=None) -> None:
        self._sink = sink
        self._thread = threading.Thread(
            target=self._loop, name="gol-bcast-pub", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._event.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        with self._lock:
            victims = list(self._streams.values())
            self._streams.clear()
            obs.BCAST_STREAMS.set(0)
        for st in victims:
            st.close("killed: server shutting down")
        self._notify_sink()

    def poke(self) -> None:
        """Per-chunk publish hook: must stay cheap and never raise."""
        self._event.set()

    def stream_for(self, run_id: str, surface, max_cells: int) -> EpochStream:
        """The (possibly new) stream for one (run, view geometry)."""
        key = f"{run_id}|{int(max_cells)}"
        with self._lock:
            st = self._streams.get(key)
            if st is None or st.closed:
                st = EpochStream(run_id, surface, max_cells)
                self._streams[key] = st
                obs.BCAST_STREAMS.set(len(self._streams))
        return st

    def drop_run(self, run_id: str, error: Optional[str] = None) -> None:
        """Close every stream of a destroyed run (subscribers get the
        end sentinel, then the gateway hangs up)."""
        with self._lock:
            victims = [(k, s) for k, s in self._streams.items()
                       if s.run_id == run_id]
            for k, _ in victims:
                del self._streams[k]
            obs.BCAST_STREAMS.set(len(self._streams))
        for _, st in victims:
            st.close(error or "killed: run destroyed")
        if victims:
            self._notify_sink()

    def publish_now(self, force: bool = True) -> dict:
        """Synchronously publish every stream regardless of subscriber
        count (tests/bench: park the run, then pin the exact frame)."""
        with self._lock:
            streams = list(self._streams.items())
        out = {}
        for key, st in streams:
            out[key] = self._publish_one(key, st, force=force)
        self._notify_sink()
        return out

    def _publish_one(self, key: str, st: EpochStream,
                     force: bool = False) -> Optional[BcastFrame]:
        try:
            return st.publish(force=force)
        except Exception as e:  # noqa: BLE001 — run died; close stream
            with self._lock:
                if self._streams.get(key) is st:
                    del self._streams[key]
                    obs.BCAST_STREAMS.set(len(self._streams))
            st.close(f"killed: {type(e).__name__}: {e}")
            obs_log("bcast.stream_closed", level="warning",
                    run_id=st.run_id or "run0", error=str(e))
            return None

    def _notify_sink(self) -> None:
        sink = self._sink
        if sink is not None:
            sink()

    def _loop(self) -> None:
        while not self._stop.is_set():
            self._event.wait(timeout=self._interval)
            self._event.clear()
            if self._stop.is_set():
                break
            with self._lock:
                streams = list(self._streams.items())
            published = False
            for key, st in streams:
                if st.subscribers <= 0:
                    continue  # zero-work: nobody watching, no encode
                if self._publish_one(key, st) is not None:
                    published = True
            if published:
                self._notify_sink()
            # Pace ceiling: at most one scan per interval no matter how
            # fast chunks poke (the event may already be set again).
            self._stop.wait(self._interval)
