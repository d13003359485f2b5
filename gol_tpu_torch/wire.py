"""Wire protocol for the controller<->engine control plane — the
counterpart of `gol_tpu/wire.py`, byte for byte: the same requests give
the same frames in either package, and each decodes the other's.

The reference uses Go net/rpc over HTTP with gob encoding
(`Server/gol/distributor.go:229-245`); this keeps its semantic surface
(SURVEY §2d) over a thin transport: 4-byte big-endian length prefix +
JSON header, with board payloads appended as raw bytes after the header.

Message: { "method"/"ok": ..., ...fields..., "world": {...}? } followed by
the board payload when "world" is present.

Codecs & capability negotiation
-------------------------------
Board payloads are framed by a codec named in the world dict:

  world = {"h": H, "w": W, "codec": C, "nbytes": N[, "basis_turn": T]}

  codec          payload                                    size
  -------------  -----------------------------------------  --------------
  u8             raw {0,255} pixel bytes, row-major         H*W
  packed         32 cells/word, LSB-first little-endian     H*ceil(W/32)*4
                 word bytes (`pack_bits`)
  u8+zlib        zlib(level 1) of the u8 payload            < H*W
  packed+zlib    zlib(level 1) of the packed payload        < packed
  xrle           XOR-delta vs the receiver's previous       <= H*W
                 frame ("basis_turn" names it), run-length
                 tokens `<II`(skip, litlen) + litlen bytes
  f32            raw little-endian float32 state, row-major  H*W*4
  f32+zlib       zlib(level 1) of the f32 payload           < H*W*4

Raw u8 is the universal fallback: an uncompressed u8 frame's payload is
exactly H*W bytes. Every OTHER codec is only ever sent to a peer that
advertised the matching capability flag: requests carry `"caps": [...]`,
replies echo the server's caps, and `negotiate()` intersects them with
`local_caps()` (the GOL_WIRE_CAPS env allowlist; unset = all of packed,
zlib, xrle, f32). Decoding is unconditional: everyone understands every
codec on receive, including the f32 frames either package's server
sends for Lenia boards.

Senders of multi-GB snapshots use band-chunked Frames (the engine
overlaps the device->host copy of band i+1 with the socket send of band
i) instead of materializing one contiguous payload; zlib is only
attempted when the payload is at most GOL_WIRE_ZLIB_MAX (default 64 MiB)
since level-1 deflate of a multi-GB board would stall the send loop.

Hostile-input posture: header length is bounded by MAX_HEADER, h*w by
GOL_MAX_BOARD_CELLS (read per message), and every codec has an exact or
upper payload-size bound checked BEFORE the allocation — violations
raise `WireProtocolError`, a ConnectionError subclass distinct from
ordinary transport failures.

Trace context: when the sending thread has an open span (obs/trace.py)
and the header carries no explicit "tc", send_msg stamps the span's
compact context — `"tc": {"t": <trace_id>, "s": <span_id>}` — into the
header; the receiving dispatcher parents its handler span under it.

Byte metering happens in `finally`: a transfer that dies mid-flight
still counts what it moved. Message counters only count complete
messages.
"""

from __future__ import annotations

import json
import os
import socket
import struct
import time
import zlib
from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import trace
from gol_tpu_torch.utils.envcfg import env_int

_LEN = struct.Struct(">I")
_XRLE_TOKEN = struct.Struct("<II")
MAX_HEADER = 1 << 20


def _chaos_enabled() -> bool:
    """One env lookup on the hot path; the chaos module (and its RNG
    state) is only imported/built when GOL_CHAOS is actually set."""
    return bool(os.environ.get("GOL_CHAOS"))

# Upper bound on h*w accepted from a peer before allocating: 2^35 cells
# covers the largest board the framework demonstrates (131072² = 2^34)
# with one doubling of headroom — a hostile or garbage header must not
# be able to trigger an arbitrary-size allocation. The reference trusts
# gob inside a VPC; a hand-rolled TCP plane bounds its inputs. Settable
# at RUNTIME via GOL_MAX_BOARD_CELLS (read per message, not frozen at
# import, so server processes can be reconfigured the same way SER/CONT
# are).
DEFAULT_MAX_BOARD_CELLS = 1 << 35

# Capability flags a peer may advertise; raw u8 needs no flag.
CAP_PACKED = "packed"
CAP_ZLIB = "zlib"
CAP_XRLE = "xrle"
# A peer advertising CAP_F32 accepts lossless float32 state frames
# (continuous boards, Lenia). Senders without the flag get the quantized
# u8 view instead, which every peer decodes.
CAP_F32 = "f32"
SUPPORTED_CAPS = frozenset({CAP_PACKED, CAP_ZLIB, CAP_XRLE, CAP_F32})

CODEC_U8 = "u8"
CODEC_PACKED = "packed"
CODEC_U8_ZLIB = "u8+zlib"
CODEC_PACKED_ZLIB = "packed+zlib"
CODEC_XRLE = "xrle"
CODEC_F32 = "f32"
CODEC_F32_ZLIB = "f32+zlib"
CODECS = frozenset({CODEC_U8, CODEC_PACKED, CODEC_U8_ZLIB,
                    CODEC_PACKED_ZLIB, CODEC_XRLE,
                    CODEC_F32, CODEC_F32_ZLIB})

ZLIB_LEVEL = 1
DEFAULT_ZLIB_MAX_BYTES = 64 << 20
DEFAULT_BAND_BYTES = 32 << 20
# xrle merges XOR runs separated by gaps of up to this many identical
# bytes into one literal segment — an 8-byte token per isolated changed
# byte would be worse than just shipping the short gap inline.
_XRLE_GAP = 16


# Pre-resolved metric children: `.labels(...)` costs a label-set
# validation, a tuple build, and a family-lock acquisition per call —
# fine per RPC, not fine per frame on the streaming path. The label
# spaces here are tiny and closed (2 directions, 7 codecs), so resolve
# every child once at import and index a plain dict afterwards.
_BYTES_SENT = obs.WIRE_BYTES.labels(direction="sent")
_BYTES_RECV = obs.WIRE_BYTES.labels(direction="received")
_MSGS_SENT = obs.WIRE_MESSAGES.labels(direction="sent")
_MSGS_RECV = obs.WIRE_MESSAGES.labels(direction="received")
_FRAMES = {c: obs.WIRE_FRAMES.labels(codec=c) for c in CODECS}
_FRAME_BYTES = {c: obs.WIRE_FRAME_BYTES.labels(codec=c) for c in CODECS}
_ENCODE_SECONDS = {c: obs.WIRE_ENCODE_SECONDS.labels(codec=c)
                   for c in CODECS}
_DECODE_SECONDS = {c: obs.WIRE_DECODE_SECONDS.labels(codec=c)
                   for c in CODECS}


def max_board_cells() -> int:
    return env_int("GOL_MAX_BOARD_CELLS", DEFAULT_MAX_BOARD_CELLS)


def zlib_max_bytes() -> int:
    return env_int("GOL_WIRE_ZLIB_MAX", DEFAULT_ZLIB_MAX_BYTES)


def band_bytes() -> int:
    return max(1, env_int("GOL_WIRE_BAND_BYTES", DEFAULT_BAND_BYTES))


WORD_BITS = 32


def words(w: int) -> int:
    """Packed words per row for a board of width w."""
    return -(-w // WORD_BITS)


# The `packed` codec's byte layout, the wire's own helpers: a payload of
# any width, in bytes. The stepping helpers of `ops/bitpack.py` take
# word-aligned widths and np.uint32 words instead, and are not used here.

def pack_bits(cells: np.ndarray) -> np.ndarray:
    """uint8 (H, W) board -> LSB-first packed bytes (H, ceil(W/32)*4),
    the little-endian bytes of its packed words. Any nonzero cell counts
    as alive, so {0,1} cells and {0,255} pixels pack alike; W need not be
    word-aligned: trailing columns are zero-padded to the word boundary.
    Byte for byte `gol_tpu.ops.bitpack.pack_np`."""
    if cells.ndim != 2:
        raise ValueError("pack_bits expects a 2-D board")
    h, w = cells.shape
    wp = words(w)
    if w != wp * WORD_BITS:
        padded = np.zeros((h, wp * WORD_BITS), dtype=np.uint8)
        padded[:, :w] = cells != 0
        cells = padded
    return np.packbits(np.ascontiguousarray(cells), axis=1,
                       bitorder="little")


def unpack_bits(payload, h: int, w: int) -> np.ndarray:
    """A buffer of h*ceil(w/32)*4 LSB-first packed bytes -> {0,1} uint8
    (h, w), cropped to w. Accepts bytes/memoryview or a uint8 ndarray;
    always returns a fresh writable array."""
    wp = words(w)
    if isinstance(payload, np.ndarray):
        raw = np.ascontiguousarray(payload, dtype=np.uint8).reshape(-1)
    else:
        raw = np.frombuffer(payload, dtype=np.uint8)
    if raw.size != h * wp * 4:
        raise ValueError(
            f"packed payload is {raw.size} bytes, want {h * wp * 4} "
            f"for a {h}x{w} board")
    return np.unpackbits(raw.reshape(h, wp * 4), axis=1, count=w,
                         bitorder="little")


def words_bytes(band: np.ndarray) -> np.ndarray:
    """(rows, Wp) host words of 4-byte integers -> their wire bytes
    (rows, Wp*4). The engine's int32 carrier is reinterpreted as uint32,
    never converted by value."""
    a = np.ascontiguousarray(band)
    if a.dtype.itemsize != 4 or a.dtype.kind not in "iu":
        raise ValueError(f"packed words must be 4-byte integers, "
                         f"got {a.dtype}")
    return a.view(np.uint32).astype("<u4", copy=False).view(np.uint8)


class WireProtocolError(ConnectionError):
    """A peer sent a frame that violates the protocol (oversized header,
    unknown codec, payload-size bound, corrupt delta …) — distinct from
    an honest transport failure, but still a ConnectionError so every
    existing shed-the-connection handler treats it correctly."""


def local_caps() -> frozenset:
    """Capabilities this process advertises/accepts for SENDING codecs.

    GOL_WIRE_CAPS is a comma-separated allowlist ("" = none: raw-u8
    only, the old-peer posture); unset means all supported caps. Read
    per call so tests and operators can flip it at runtime."""
    raw = os.environ.get("GOL_WIRE_CAPS")
    if raw is None:
        return SUPPORTED_CAPS
    return frozenset(
        t.strip() for t in raw.split(",") if t.strip()) & SUPPORTED_CAPS


# Negotiation/advert memos: both are pure functions of (peer caps tuple,
# env value), so one dict lookup replaces rebuilding the peer∩local set
# and re-reading and re-sorting GOL_WIRE_CAPS on every message. Keyed on the raw env string:
# flipping GOL_WIRE_CAPS at runtime still takes effect immediately.
_NEGOTIATE_CACHE: dict = {}
_ADVERT_CACHE: dict = {}


def advertised_caps() -> list:
    """Sorted caps list for reply/request headers — the `"caps"` advert.
    Memoized per GOL_WIRE_CAPS value; returns a fresh list so callers
    may embed it in mutable headers."""
    raw = os.environ.get("GOL_WIRE_CAPS")
    got = _ADVERT_CACHE.get(raw)
    if got is None:
        if len(_ADVERT_CACHE) > 64:
            _ADVERT_CACHE.clear()
        got = tuple(sorted(local_caps()))
        _ADVERT_CACHE[raw] = got
    return list(got)


def negotiate(header: dict) -> frozenset:
    """Caps usable for the REPLY to this request: the peer's advertised
    list ∩ ours. A peer that advertises nothing (an old client)
    negotiates the empty set and gets raw u8."""
    peer = header.get("caps")
    if not isinstance(peer, (list, tuple)):
        return frozenset()
    try:
        key = (tuple(peer), os.environ.get("GOL_WIRE_CAPS"))
        cached = _NEGOTIATE_CACHE.get(key)
    except TypeError:
        # Unhashable junk in a hostile caps list — negotiate uncached.
        key = cached = None
    if cached is None:
        cached = frozenset(
            c for c in peer if isinstance(c, str)) & local_caps()
        if key is not None:
            if len(_NEGOTIATE_CACHE) > 256:
                _NEGOTIATE_CACHE.clear()
            _NEGOTIATE_CACHE[key] = cached
    return cached


class ConnectionEncoder:
    """Per-connection precomputed encode state: the negotiated caps for
    frames TO this peer and the caps advert for headers, both resolved
    once at connection setup instead of per reply. The server builds one
    per accepted connection; every frame built for that reply reuses
    `caps` without touching the environment or the peer header again."""

    __slots__ = ("caps", "advert")

    def __init__(self, header: Optional[dict] = None) -> None:
        self.caps = negotiate(header) if header is not None \
            else frozenset()
        self.advert = advertised_caps()

    def stamp(self, header: dict) -> dict:
        """Add this connection's caps advert to a reply header."""
        header.setdefault("caps", self.advert)
        return header


def enable_nodelay(sock: socket.socket) -> None:
    """TCP_NODELAY, best-effort: small control RPCs (flag/ping/alive)
    must not eat Nagle delays queued behind board payloads. A no-op on
    non-TCP sockets (AF_UNIX socketpairs in tests)."""
    try:
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    except OSError:
        pass


class _Tally:
    """Mutable byte count shared with a `finally` meter."""

    __slots__ = ("n",)

    def __init__(self) -> None:
        self.n = 0


class Frame:
    """One encoded board payload: a codec, its header metadata, and an
    iterable of byte chunks summing to exactly `nbytes`. `chunks` may be
    a lazy generator — band-chunked senders encode while earlier chunks
    are already on the wire. `raw_nbytes` is the u8-pixel equivalent
    (h*w), the denominator of the bytes-saved/compression-ratio metrics.
    `encode_s` accrues encode time (lazy chunk producers add to it as
    they run)."""

    __slots__ = ("codec", "h", "w", "nbytes", "raw_nbytes", "chunks",
                 "extra", "encode_s")

    def __init__(self, codec: str, h: int, w: int, nbytes: int,
                 raw_nbytes: int, chunks, extra: Optional[dict] = None,
                 encode_s: float = 0.0) -> None:
        self.codec = codec
        self.h = h
        self.w = w
        self.nbytes = nbytes
        self.raw_nbytes = raw_nbytes
        self.chunks = chunks
        self.extra = extra
        self.encode_s = encode_s

    def meta(self) -> dict:
        m = {"h": self.h, "w": self.w, "codec": self.codec,
             "nbytes": self.nbytes}
        if self.extra:
            m.update(self.extra)
        return m


def _build_frame(codec: str, h: int, w: int, nbytes: int, raw_nbytes: int,
                 caps: frozenset,
                 band_iter_factory: Callable[["Frame"], Iterable],
                 extra: Optional[dict] = None) -> Frame:
    """Assemble a Frame from a base codec + chunk producer, layering zlib
    when negotiated and worthwhile. Compression drains the producer
    eagerly (bounded by zlib_max_bytes, checked by the caller passing a
    small-enough nbytes), and falls back to the uncompressed chunks when
    level-1 deflate does not actually shrink the payload — so a zlib
    codec on the wire always means nbytes < base size, which the
    receiver enforces as a bound."""
    # Every encode funnels through here (encode_board, the band framers,
    # and encode_view_frame via its plain-codec base), so this counter is
    # the "did ANY wire-encode work happen" witness the no-viewer
    # turn-path test pins to zero.
    obs.WIRE_ENCODE_CALLS.inc()
    frame = Frame(codec, h, w, nbytes, raw_nbytes, None, extra)
    if CAP_ZLIB in caps \
            and codec in (CODEC_U8, CODEC_PACKED, CODEC_F32) \
            and nbytes <= zlib_max_bytes():
        t0 = time.perf_counter()
        co = zlib.compressobj(ZLIB_LEVEL)
        comp, clen, raw_chunks = [], 0, []
        for buf in band_iter_factory(frame):
            raw_chunks.append(buf)
            d = co.compress(buf)
            if d:
                comp.append(d)
                clen += len(d)
        d = co.flush()
        if d:
            comp.append(d)
            clen += len(d)
        frame.encode_s += time.perf_counter() - t0
        if clen < nbytes:
            frame.codec = codec + "+zlib"
            frame.nbytes = clen
            frame.chunks = comp
        else:
            frame.chunks = raw_chunks
        return frame
    frame.chunks = band_iter_factory(frame)
    return frame


def is_binary_pixels(world: np.ndarray) -> bool:
    """True iff every value is 0 or 255 — the life-like pixels contract.
    Generations boards carry gray levels and must never be bit-packed."""
    return not bool(np.any((world != 0) & (world != 255)))


def encode_board(world: np.ndarray, caps: frozenset = frozenset(), *,
                 binary: Optional[bool] = None) -> Frame:
    """Encode one host-resident {0..255} pixel board for the wire under
    the negotiated caps. `binary` short-circuits the is-it-{0,255} probe
    when the sender already knows (engines do; pass None to probe)."""
    if world.dtype != np.uint8 or world.ndim != 2:
        raise ValueError("world must be 2-D uint8")
    h, w = world.shape
    wp = words(w)
    t0 = time.perf_counter()
    # Packing a narrow board can EXPAND it (wp*4 > w for w < 26 wide
    # remnants); only pack when it actually wins.
    use_packed = CAP_PACKED in caps and wp * 4 < w
    if use_packed:
        if binary is None:
            binary = is_binary_pixels(world)
        use_packed = binary
    if use_packed:
        payload = pack_bits(world)
        codec, nbytes = CODEC_PACKED, h * wp * 4
    else:
        payload = np.ascontiguousarray(world)
        codec, nbytes = CODEC_U8, h * w
    mv = memoryview(payload).cast("B")
    enc = time.perf_counter() - t0
    frame = _build_frame(codec, h, w, nbytes, h * w, caps,
                         lambda f: iter([mv]))
    frame.encode_s += enc
    return frame


def encode_board_f32(state: np.ndarray,
                     caps: frozenset = frozenset()) -> Frame:
    """Encode one host-resident float32 state board (a continuous
    family, Lenia) losslessly for the wire: raw little-endian '<f4' bytes,
    row-major, exactly h*w*4 of them, zlib-layered when negotiated.

    Only sent to peers that advertised CAP_F32 — callers without it
    must quantize to a u8 view and use `encode_board` instead (the
    engine's get_world_frame does exactly that)."""
    if state.ndim != 2:
        raise ValueError("state must be 2-D float32")
    if CAP_F32 not in caps:
        raise ValueError(
            "peer did not negotiate the f32 capability; send a "
            "quantized u8 view via encode_board instead")
    h, w = state.shape
    t0 = time.perf_counter()
    payload = np.ascontiguousarray(state, dtype="<f4")
    mv = memoryview(payload).cast("B")
    enc = time.perf_counter() - t0
    frame = _build_frame(CODEC_F32, h, w, h * w * 4, h * w * 4, caps,
                         lambda f: iter([mv]))
    frame.encode_s += enc
    return frame


def packed_words_frame(h: int, w: int, word_bands: Iterable[np.ndarray],
                       caps: frozenset) -> Frame:
    """Frame a board already in packed-words form: `word_bands` yields
    (rows, ceil(w/32)) uint32 host arrays covering rows 0..h in order —
    the engine's banded device-to-host generator plugs in directly, so the
    board is never unpacked on device OR host. Peers that never
    negotiated CAP_PACKED get each band unpacked host-side into the
    universal raw-u8 codec instead. Lazy unless zlib drains it (only
    for payloads ≤ zlib_max_bytes)."""
    if CAP_PACKED not in caps:
        def px_bands():
            for band in word_bands:
                yield unpack_bits(words_bytes(band), band.shape[0], w)
        return u8_band_frame(h, w, px_bands(), caps, binary=True,
                             values01=True)

    nbytes = h * words(w) * 4

    def bands(frame: Frame):
        got_rows = 0
        for band in word_bands:
            t0 = time.perf_counter()
            mv = memoryview(words_bytes(band)).cast("B")
            frame.encode_s += time.perf_counter() - t0
            got_rows += band.shape[0]
            yield mv
        if got_rows != h:
            raise RuntimeError(
                f"packed bands covered {got_rows} rows, board has {h}")

    return _build_frame(CODEC_PACKED, h, w, nbytes, h * w, caps, bands)


def u8_band_frame(h: int, w: int, bands: Iterable[np.ndarray],
                  caps: frozenset, *, binary: bool,
                  values01: bool = False) -> Frame:
    """Frame a board streamed as uint8 row bands ((rows, w) host arrays
    covering rows 0..h in order). When the peer takes packed frames and
    the board is binary, each band is bit-packed host-side as it
    arrives (any nonzero counts as alive, so {0,1} cell bands need no
    ×255 materialization first); otherwise raw pixels, scaled from
    {0,1} per band when `values01`."""
    wp = words(w)
    use_packed = binary and CAP_PACKED in caps and wp * 4 < w

    if use_packed:
        def bands_iter(frame: Frame):
            for band in bands:
                t0 = time.perf_counter()
                mv = memoryview(pack_bits(band)).cast("B")
                frame.encode_s += time.perf_counter() - t0
                yield mv
        return _build_frame(CODEC_PACKED, h, w, h * wp * 4, h * w, caps,
                            bands_iter)

    def bands_iter(frame: Frame):
        for band in bands:
            t0 = time.perf_counter()
            px = band * np.uint8(255) if values01 else band
            mv = memoryview(np.ascontiguousarray(px)).cast("B")
            frame.encode_s += time.perf_counter() - t0
            yield mv
    return _build_frame(CODEC_U8, h, w, h * w, h * w, caps, bands_iter)


def xrle_encode(cur: np.ndarray, basis: np.ndarray) -> Optional[bytes]:
    """XOR-delta + run-length encode `cur` against `basis` (same shape):
    tokens of `<II`(skip, litlen) each followed by litlen XOR bytes,
    over the row-major flattening. b"" means the frames are identical.
    Returns None when the delta would not beat shipping the raw board —
    the caller falls back to a plain codec."""
    a = np.ascontiguousarray(cur).reshape(-1)
    if a.size >= 1 << 32:  # token fields are u32
        return None
    x = a ^ np.ascontiguousarray(basis).reshape(-1)
    nz = np.flatnonzero(x)
    if nz.size == 0:
        return b""
    breaks = np.flatnonzero(np.diff(nz) > _XRLE_GAP)
    seg_starts = np.concatenate(([0], breaks + 1))
    seg_ends = np.concatenate((breaks, [nz.size - 1]))
    out = bytearray()
    pos = 0
    for s_i, e_i in zip(seg_starts, seg_ends):
        s = int(nz[s_i])
        e = int(nz[e_i]) + 1
        out += _XRLE_TOKEN.pack(s - pos, e - s)
        out += x[s:e].tobytes()
        pos = e
        if len(out) >= a.size:
            return None
    return bytes(out)


def xrle_decode(payload, h: int, w: int, basis: np.ndarray) -> np.ndarray:
    """Apply an xrle delta to the previous frame. Every token is bounds-
    checked against both the payload and the board before any write."""
    if basis.shape != (h, w) or basis.dtype != np.uint8:
        raise WireProtocolError("xrle frame without matching basis")
    n = h * w
    out = np.empty(n, dtype=np.uint8)
    out[:] = np.ascontiguousarray(basis).reshape(-1)
    buf = memoryview(payload)
    total = len(buf)
    pos = off = 0
    while off < total:
        if total - off < _XRLE_TOKEN.size:
            raise WireProtocolError("xrle: truncated token")
        skip, lit = _XRLE_TOKEN.unpack_from(buf, off)
        off += _XRLE_TOKEN.size
        pos += skip
        if lit == 0 or pos + lit > n or off + lit > total:
            raise WireProtocolError("xrle: segment out of bounds")
        out[pos:pos + lit] ^= np.frombuffer(buf, np.uint8, lit, off)
        pos += lit
        off += lit
    return out.reshape(h, w)


def encode_view_frame(view: np.ndarray, caps: frozenset, *,
                      basis: Optional[np.ndarray] = None,
                      basis_turn=None,
                      binary: Optional[bool] = None) -> Frame:
    """Encode a live-view frame, preferring an xrle delta against the
    receiver's previous frame when one is negotiated and available —
    consecutive GoL frames are nearly identical, so a polling viewer
    usually gets a few hundred bytes instead of the board. Falls back to the
    best plain codec whenever the delta loses."""
    plain = encode_board(view, caps, binary=binary)
    if CAP_XRLE in caps and basis is not None \
            and basis.shape == view.shape:
        t0 = time.perf_counter()
        delta = xrle_encode(view, basis)
        dt = time.perf_counter() - t0
        if delta is not None and len(delta) < plain.nbytes:
            h, w = view.shape
            return Frame(CODEC_XRLE, h, w, len(delta), h * w, [delta],
                         extra={"basis_turn": basis_turn}, encode_s=dt)
    return plain


def _recv_exact(sock: socket.socket, n: int,
                tally: Optional[_Tally] = None) -> bytes:
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(min(n - len(buf), 1 << 20))
        if not chunk:
            raise ConnectionError("peer closed mid-message")
        buf.extend(chunk)
        if tally is not None:
            tally.n += len(chunk)
    return bytes(buf)


def _recv_into(sock: socket.socket, mv: memoryview, tally: _Tally) -> None:
    got = 0
    total = len(mv)
    while got < total:
        n_read = sock.recv_into(mv[got:])
        if n_read == 0:
            raise ConnectionError("peer closed mid-message")
        got += n_read
        tally.n += n_read


def send_msg(
    sock: socket.socket, header: dict, world: Optional[np.ndarray] = None,
    frame: Optional[Frame] = None,
) -> int:
    """Send one message; returns the bytes put on the wire.

    `world` is the legacy raw-u8 path (payload = the board's own buffer,
    exactly h*w bytes, no codec key — understood by every peer ever
    shipped); `frame` is a codec-aware Frame from the encode_* functions."""
    if world is not None and frame is not None:
        raise ValueError("pass either world or frame, not both")
    header = dict(header)
    if "tc" not in header:
        tc = trace.context()
        if tc is not None:
            header["tc"] = tc
    payload = None
    if frame is not None:
        header["world"] = frame.meta()
    elif world is not None:
        if world.dtype != np.uint8 or world.ndim != 2:
            raise ValueError("world must be 2-D uint8")
        h, w = world.shape
        header["world"] = {"h": int(h), "w": int(w)}
        # Send the board's own buffer — tobytes() + concatenation would
        # transiently double a multi-GB snapshot.
        payload = memoryview(np.ascontiguousarray(world)).cast("B")
    raw = json.dumps(header).encode()
    head = memoryview(_LEN.pack(len(raw)) + raw)
    if _chaos_enabled():
        from gol_tpu_torch import chaos
        head = memoryview(chaos.send_hook(sock, bytes(head)))
    sent = 0
    try:
        # send() loops instead of sendall() so a connection that dies
        # mid-payload still tells us how many bytes made it out.
        while sent < len(head):
            sent += sock.send(head[sent:])
        if payload is not None:
            off = 0
            while off < payload.nbytes:
                n = sock.send(payload[off:])
                off += n
                sent += n
        elif frame is not None:
            paid = 0
            for chunk in frame.chunks:
                mv = memoryview(chunk)
                if mv.ndim != 1 or mv.itemsize != 1:
                    mv = mv.cast("B")
                off = 0
                while off < mv.nbytes:
                    n = sock.send(mv[off:])
                    off += n
                    sent += n
                paid += mv.nbytes
            if paid != frame.nbytes:
                raise RuntimeError(
                    f"frame chunks produced {paid} bytes, header "
                    f"promised {frame.nbytes}")
    finally:
        if sent:
            _BYTES_SENT.inc(sent)
    _MSGS_SENT.inc()
    if frame is not None:
        _FRAMES[frame.codec].inc()
        _FRAME_BYTES[frame.codec].inc(frame.nbytes)
        if frame.raw_nbytes > frame.nbytes:
            obs.WIRE_BYTES_SAVED.inc(frame.raw_nbytes - frame.nbytes)
        if frame.nbytes:
            obs.WIRE_COMPRESSION_RATIO.set(frame.raw_nbytes / frame.nbytes)
        _ENCODE_SECONDS[frame.codec].observe(frame.encode_s)
    return sent


def _check_frame_size(codec: str, nbytes: int, h: int, w: int) -> None:
    """Each codec's exact or upper payload-size bound for an h x w board,
    checked before anything is allocated."""
    wp = words(w)
    lo, hi = {
        CODEC_U8: (h * w, h * w),
        CODEC_PACKED: (h * wp * 4, h * wp * 4),
        # a conforming sender only ships zlib when it SHRANK the payload
        CODEC_U8_ZLIB: (1, h * w - 1),
        CODEC_PACKED_ZLIB: (1, h * wp * 4 - 1),
        CODEC_XRLE: (0, h * w - 1),
        CODEC_F32: (h * w * 4, h * w * 4),
        CODEC_F32_ZLIB: (1, h * w * 4 - 1),
    }[codec]
    if not lo <= nbytes <= hi:
        raise WireProtocolError(
            f"frame size out of bounds for {codec}: {nbytes} "
            f"(board {h}x{w})")


def _decode_packed(buf, h: int, w: int) -> np.ndarray:
    px = unpack_bits(buf, h, w)
    px *= 255  # pixels contract: life-like boards materialize as {0,255}
    return px


def _recv_frame(sock: socket.socket, codec: str, meta: dict, h: int,
                w: int, tally: _Tally, xrle_basis) -> np.ndarray:
    if codec not in CODECS:
        raise WireProtocolError(f"unknown codec: {codec!r}")
    try:
        nbytes = int(meta["nbytes"])
    except (TypeError, KeyError, ValueError) as e:
        raise WireProtocolError(f"malformed frame size: {e}") from e
    _check_frame_size(codec, nbytes, h, w)
    buf = np.empty(nbytes, dtype=np.uint8)
    if nbytes:
        _recv_into(sock, memoryview(buf).cast("B"), tally)
    t0 = time.perf_counter()
    if codec == CODEC_U8:
        world = buf.reshape(h, w)
    elif codec == CODEC_PACKED:
        world = _decode_packed(buf, h, w)
    elif codec == CODEC_F32:
        world = buf.view(np.dtype("<f4")).reshape(h, w)
    elif codec in (CODEC_U8_ZLIB, CODEC_PACKED_ZLIB, CODEC_F32_ZLIB):
        base = {CODEC_U8_ZLIB: h * w,
                CODEC_PACKED_ZLIB: h * words(w) * 4,
                CODEC_F32_ZLIB: h * w * 4}[codec]
        de = zlib.decompressobj()
        try:
            raw = de.decompress(buf, base)
        except zlib.error as e:
            raise WireProtocolError(f"zlib payload corrupt: {e}") from e
        # max_length bounds the inflation; anything beyond the declared
        # base size (zlib bomb) or short of it (truncated) is protocol
        # garbage, not a transport error.
        if len(raw) != base or de.unconsumed_tail or not de.eof:
            raise WireProtocolError(
                f"zlib payload decodes to {len(raw)} bytes, want {base}")
        if codec == CODEC_U8_ZLIB:
            world = np.frombuffer(raw, np.uint8).reshape(h, w).copy()
        elif codec == CODEC_F32_ZLIB:
            world = np.frombuffer(raw, "<f4").reshape(h, w).copy()
        else:
            world = _decode_packed(np.frombuffer(raw, np.uint8), h, w)
    else:  # xrle
        if xrle_basis is None \
                or xrle_basis[0] != meta.get("basis_turn"):
            raise WireProtocolError("xrle frame without matching basis")
        world = xrle_decode(buf, h, w, xrle_basis[1])
    _DECODE_SECONDS[codec].observe(time.perf_counter() - t0)
    return world


def recv_msg(sock: socket.socket,
             xrle_basis=None) -> Tuple[dict, Optional[np.ndarray]]:
    """Receive one message → (header, decoded board or None).

    `xrle_basis` = (basis_turn, previous frame ndarray) authorizes xrle
    decoding — only the call sites that kept their previous frame (the
    live-view client) pass it; an unsolicited delta is a protocol error."""
    if _chaos_enabled():
        from gol_tpu_torch import chaos
        chaos.recv_hook(sock)
    tally = _Tally()
    try:
        (n,) = _LEN.unpack(_recv_exact(sock, 4, tally))
        if n > MAX_HEADER:
            raise WireProtocolError(f"header too large: {n}")
        raw = _recv_exact(sock, n, tally)
        try:
            header = json.loads(raw)
        except ValueError as e:  # bad UTF-8 or bad JSON — peer is garbage
            raise WireProtocolError(f"malformed header: {e}") from e
        if not isinstance(header, dict):
            raise WireProtocolError(
                f"malformed header: expected object, "
                f"got {type(header).__name__}")
        world = None
        meta = header.get("world")
        if meta is not None:
            try:
                h = int(meta["h"])
                w = int(meta["w"])
            except (TypeError, KeyError, ValueError) as e:
                raise WireProtocolError(
                    f"malformed world dims: {e}") from e
            if h <= 0 or w <= 0 or h * w > max_board_cells():
                raise WireProtocolError(
                    f"board dims out of bounds: {h}x{w}")
            codec = meta.get("codec", CODEC_U8)
            if codec == CODEC_U8 and "nbytes" not in meta:
                # Legacy peer: exactly h*w raw bytes. Receive straight
                # into the final array — going through bytes would peak
                # at ~3x the payload for a multi-GB snapshot.
                world = np.empty((h, w), dtype=np.uint8)
                _recv_into(sock, memoryview(world).cast("B"), tally)
            else:
                world = _recv_frame(sock, codec, meta, h, w, tally,
                                    xrle_basis)
    finally:
        if tally.n:
            _BYTES_RECV.inc(tally.n)
    _MSGS_RECV.inc()
    return header, world


# -- raw relay ------------------------------------------------------
#
# A relay proxies RPCs without re-encoding them: it parses the JSON
# header only to route and to compute how many payload bytes follow,
# then forwards every byte verbatim, which keeps the req_id dedupe, the
# tc trace context and the negotiated codecs (including per-viewer xrle
# bases) intact across the proxy. None of this touches send_msg/
# recv_msg. The JAX package's federation router is the user; the port's
# waits for ROADMAP A13.

def recv_head_raw(sock: socket.socket) -> Tuple[dict, bytes]:
    """Receive one message's framed header WITHOUT consuming its board
    payload: (parsed header, the raw framed bytes — 4-byte length
    prefix + JSON exactly as the peer sent them). Pair with
    `payload_nbytes` + `relay_payload` to stream the rest."""
    tally = _Tally()
    try:
        (n,) = _LEN.unpack(_recv_exact(sock, 4, tally))
        if n > MAX_HEADER:
            raise WireProtocolError(f"header too large: {n}")
        raw = _recv_exact(sock, n, tally)
        try:
            header = json.loads(raw)
        except ValueError as e:
            raise WireProtocolError(f"malformed header: {e}") from e
        if not isinstance(header, dict):
            raise WireProtocolError(
                f"malformed header: expected object, "
                f"got {type(header).__name__}")
    finally:
        if tally.n:
            _BYTES_RECV.inc(tally.n)
    _MSGS_RECV.inc()
    return header, _LEN.pack(n) + raw


def payload_nbytes(header: dict) -> int:
    """Board-payload byte count implied by a received header (0 when it
    carries no `world` meta). Mirrors recv_msg's framing rules — same
    dim bounds, same per-codec size envelope — without decoding, so a
    relay can refuse malformed framing exactly where recv_msg would."""
    meta = header.get("world")
    if meta is None:
        return 0
    try:
        h = int(meta["h"])
        w = int(meta["w"])
    except (TypeError, KeyError, ValueError) as e:
        raise WireProtocolError(f"malformed world dims: {e}") from e
    if h <= 0 or w <= 0 or h * w > max_board_cells():
        raise WireProtocolError(f"board dims out of bounds: {h}x{w}")
    codec = meta.get("codec", CODEC_U8)
    if codec == CODEC_U8 and "nbytes" not in meta:
        return h * w  # legacy raw-u8 peer
    if codec not in CODECS:
        raise WireProtocolError(f"unknown codec: {codec!r}")
    try:
        nbytes = int(meta["nbytes"])
    except (TypeError, KeyError, ValueError) as e:
        raise WireProtocolError(f"malformed frame size: {e}") from e
    _check_frame_size(codec, nbytes, h, w)
    return nbytes


def send_raw(sock: socket.socket, raw: bytes) -> None:
    """Put already-framed message bytes on the wire verbatim."""
    sock.sendall(raw)
    _BYTES_SENT.inc(len(raw))
    _MSGS_SENT.inc()


def frame_header(header: dict) -> bytes:
    """Frame a header dict exactly as send_msg would (length prefix +
    JSON), for relays that must rewrite one field before forwarding."""
    raw = json.dumps(header).encode()
    if len(raw) > MAX_HEADER:
        raise WireProtocolError(f"header too large: {len(raw)}")
    return _LEN.pack(len(raw)) + raw


def freeze_message(header: dict, frame: Optional[Frame] = None) -> bytes:
    """Materialize one complete message (framed header + the frame's
    payload) into a single ready-to-send bytes object.

    A broadcaster freezes each published frame ONCE and writes the same
    immutable buffer to every subscriber socket, so fan-out costs sends,
    not re-encodes. The encode-side frame families (frames, frame bytes,
    bytes saved, ratio, encode seconds) are metered here once per
    freeze; per-send byte accounting is the sender's job."""
    if frame is None:
        return frame_header(header)
    header = dict(header)
    header["world"] = frame.meta()
    head = frame_header(header)
    parts = [head]
    paid = 0
    for chunk in frame.chunks:
        mv = memoryview(chunk)
        if mv.ndim != 1 or mv.itemsize != 1:
            mv = mv.cast("B")
        parts.append(bytes(mv))
        paid += mv.nbytes
    if paid != frame.nbytes:
        raise RuntimeError(
            f"frame chunks produced {paid} bytes, header promised "
            f"{frame.nbytes}")
    _FRAMES[frame.codec].inc()
    _FRAME_BYTES[frame.codec].inc(frame.nbytes)
    if frame.raw_nbytes > frame.nbytes:
        obs.WIRE_BYTES_SAVED.inc(frame.raw_nbytes - frame.nbytes)
    if frame.nbytes:
        obs.WIRE_COMPRESSION_RATIO.set(frame.raw_nbytes / frame.nbytes)
    _ENCODE_SECONDS[frame.codec].observe(frame.encode_s)
    return b"".join(parts)


def relay_payload(src: socket.socket, dst: socket.socket,
                  nbytes: int, chunk: int = 1 << 20) -> None:
    """Stream exactly `nbytes` of payload from src to dst, verbatim."""
    left = int(nbytes)
    moved = 0
    try:
        while left:
            buf = src.recv(min(left, chunk))
            if not buf:
                raise ConnectionError("peer closed mid-payload")
            dst.sendall(buf)
            left -= len(buf)
            moved += len(buf)
    finally:
        if moved:
            _BYTES_RECV.inc(moved)
            _BYTES_SENT.inc(moved)
