"""The metric families of the port's control plane, declared in one place
against the shared default registry — the part of
`gol_tpu/obs/catalog.py` that the wire codecs, the engine server, the
remote engine client, the chaos hooks, the tracer, the flight recorder,
the SLO estimators, the checkpoint writer and restore, the run journal
and the conv-family kernel tiers emit. Names, kinds, labels and pre-seeded children are the JAX
catalogue's, so a `GetMetrics` reply reads the same from either package.
The engine, fleet, checkpoint-pool and fusion families wait for the
modules that emit them (ROADMAP A11, A13).
"""

from __future__ import annotations

from gol_tpu_torch.obs.metrics import REGISTRY

# Every method the wire protocol speaks, plus a catch-all so an
# unrecognised header can't mint unbounded label values.
WIRE_METHODS = (
    "ServerDistributor", "Alivecount", "GetWorld", "GetView", "GetWindow",
    "CFput", "DrainFlags", "KillProg", "Ping", "Stats", "AbortRun",
    "GetMetrics", "Checkpoint", "RestoreRun", "Profile",
    "CreateRun", "ListRuns", "AttachRun", "DestroyRun", "SetRule",
    "RegisterMember", "AdoptRun", "Subscribe",
    "Rescale", "ReceiveRun", "CommitRun", "PinRun",
    "GetTelemetry", "GetAudit", "GetJournal", "GetUsage",
    "unknown",
)

ENGINE_BAND_COPIES = REGISTRY.counter(
    "gol_engine_band_copies_total",
    "Banded device-to-host row copies started by snapshot streaming "
    "(engine._banded_host_rows); stays flat while no viewer or "
    "snapshot consumer is attached.")

# ------------------------------------------------------------ wire bytes

WIRE_BYTES = REGISTRY.counter(
    "gol_wire_bytes_total",
    "Bytes moved over the wire protocol, by direction.",
    label_names=("direction",))
WIRE_MESSAGES = REGISTRY.counter(
    "gol_wire_messages_total",
    "Wire-protocol messages moved, by direction.",
    label_names=("direction",))
for _d in ("sent", "received"):
    WIRE_BYTES.labels(direction=_d)
    WIRE_MESSAGES.labels(direction=_d)

# ----------------------------------------------------- wire codec frames

# Every codec the framing layer can put on the wire (wire.CODECS mirrors
# this), pre-seeded like the methods so /metrics shows the full matrix.
WIRE_CODECS = ("u8", "packed", "u8+zlib", "packed+zlib", "xrle",
               "f32", "f32+zlib")

WIRE_FRAMES = REGISTRY.counter(
    "gol_wire_frames_total",
    "Codec-framed board payloads sent, by codec chosen after "
    "negotiation (legacy raw-u8 sends to caps-less peers are counted "
    "under gol_wire_messages_total only).",
    label_names=("codec",))
WIRE_FRAME_BYTES = REGISTRY.counter(
    "gol_wire_frame_bytes_total",
    "Encoded payload bytes of sent board frames, by codec.",
    label_names=("codec",))
WIRE_BYTES_SAVED = REGISTRY.counter(
    "gol_wire_bytes_saved_total",
    "Payload bytes NOT sent thanks to codec framing: sum over sent "
    "frames of (raw u8 size h*w − encoded size).")
WIRE_COMPRESSION_RATIO = REGISTRY.gauge(
    "gol_wire_compression_ratio",
    "raw u8 size / encoded size of the most recently sent board frame "
    "(8.0 = pure packed, higher = compression on top).")
WIRE_ENCODE_SECONDS = REGISTRY.histogram(
    "gol_wire_encode_seconds",
    "Seconds spent encoding a board frame before/while sending, by "
    "codec (banded senders accrue encode time as chunks stream).",
    label_names=("codec",))
WIRE_DECODE_SECONDS = REGISTRY.histogram(
    "gol_wire_decode_seconds",
    "Seconds spent decoding a received board frame, by codec.",
    label_names=("codec",))
WIRE_ENCODE_CALLS = REGISTRY.counter(
    "gol_wire_encode_calls_total",
    "Board/view frame encode invocations (any codec, eager or banded). "
    "Proves the no-viewer turn path does zero wire-encode work: this "
    "counter must not move while chunks retire without a snapshot "
    "consumer.")

for _c in WIRE_CODECS:
    WIRE_FRAMES.labels(codec=_c)
    WIRE_FRAME_BYTES.labels(codec=_c)

# ---------------------------------------------------------------- server

SERVER_REQUESTS = REGISTRY.counter(
    "gol_server_requests_total",
    "Requests dispatched by the engine server, by wire method.",
    label_names=("method",))
SERVER_ERRORS = REGISTRY.counter(
    "gol_server_errors_total",
    "Requests that raised inside the server dispatch, by wire method.",
    label_names=("method",))
SERVER_REQUEST_SECONDS = REGISTRY.histogram(
    "gol_server_request_seconds",
    "Server-side dispatch latency, by wire method.",
    label_names=("method",))

# ---------------------------------------------------------------- client

CLIENT_REQUESTS = REGISTRY.counter(
    "gol_client_requests_total",
    "RPCs issued by RemoteEngine, by wire method.",
    label_names=("method",))
CLIENT_ERRORS = REGISTRY.counter(
    "gol_client_errors_total",
    "RPCs that failed (socket or protocol error), by wire method.",
    label_names=("method",))
CLIENT_REQUEST_SECONDS = REGISTRY.histogram(
    "gol_client_request_seconds",
    "Round-trip RPC latency seen by RemoteEngine, by wire method.",
    label_names=("method",))

for _m in WIRE_METHODS:
    SERVER_REQUESTS.labels(method=_m)


def method_label(method: str) -> str:
    """Clamp arbitrary header method strings to the declared set."""
    return method if method in WIRE_METHODS else "unknown"


# ------------------------------------------------- chaos & fault tolerance

# Closed kind sets, pre-seeded like the wire methods so the resilience
# families are visible at zero before the first fault. The port's chaos
# module injects the wire-level kinds only (no federation member kills
# or migration faults).
CHAOS_KINDS = ("drop", "delay", "truncate", "corrupt", "stall", "refuse")
RPC_ERROR_KINDS = ("timeout", "refused", "reset", "protocol")

CHAOS_INJECTED = REGISTRY.counter(
    "gol_chaos_injected_total",
    "Faults injected by the GOL_CHAOS wire-layer injector "
    "(gol_tpu_torch/chaos.py), by kind: drop (socket closed instead of "
    "the operation), delay (bounded sleep), truncate (partial header "
    "then close), corrupt (one header byte zeroed so the peer sees a "
    "protocol error), stall (long sleep that outlasts read timeouts), "
    "refuse (dial-time ConnectionRefusedError before the socket "
    "connects). Stays 0 unless GOL_CHAOS is set.",
    label_names=("kind",))
for _k in CHAOS_KINDS:
    CHAOS_INJECTED.labels(kind=_k)

RPC_ERRORS = REGISTRY.counter(
    "gol_rpc_errors_total",
    "Transport-level RPC failures observed in the server per-connection "
    "handler, by method and kind: timeout (header/read deadline), "
    "refused (connect-phase failure), reset (peer closed or OS error "
    "mid-message), protocol (unparseable framing).",
    label_names=("method", "kind"))
for _m in WIRE_METHODS:
    for _k in RPC_ERROR_KINDS:
        RPC_ERRORS.labels(method=_m, kind=_k)

CLIENT_RETRIES = REGISTRY.counter(
    "gol_client_retries_total",
    "RPC attempts re-issued by the RemoteEngine retry policy "
    "(exponential backoff with jitter) after a retryable transport "
    "error, by wire method. Excludes the first attempt.",
    label_names=("method",))

SERVER_DEDUP_HITS = REGISTRY.counter(
    "gol_server_dedup_hits_total",
    "Mutating requests answered from the server-side req_id dedupe "
    "window instead of re-executing (a retried RPC whose first attempt "
    "already committed), by wire method.",
    label_names=("method",))

SERVER_DRAIN_SECONDS = REGISTRY.gauge(
    "gol_server_drain_seconds",
    "Wall seconds the last graceful drain (SIGTERM) spent between "
    "stopping the accept loop and process exit.")
SERVER_DRAIN_INFLIGHT = REGISTRY.gauge(
    "gol_server_drain_inflight",
    "In-flight request handlers observed when the last graceful drain "
    "began.")

# ------------------------------------------------------------ RPC latency

# Quantile gauges published by obs/slo.py's log-bucket estimators.
# Cardinality is bounded by construction: kinds, quantiles and methods
# are closed tuples (methods clamp via method_label).
RPC_KINDS = ("client", "handler", "wait")
SLO_QUANTILES = ("p50", "p95", "p99")

RPC_LATENCY_MS = REGISTRY.gauge(
    "gol_rpc_latency_ms",
    "RPC latency quantiles in milliseconds from the bounded-memory "
    "log-bucket estimators (obs/slo.py; <= one ~16% bucket width of "
    "error): kind=client (RemoteEngine end-to-end round trip), "
    "kind=handler (server dispatch, header received -> reply sent), "
    "kind=wait (server accept -> dispatch start: conn-slot scheduling "
    "plus header receipt).",
    label_names=("kind", "method", "q"))
RPC_SLO_BREACHES = REGISTRY.counter(
    "gol_slo_breaches_total",
    "Flush windows in which a method's p99 exceeded the configured "
    "GOL_SLO_P99_MS objective (0 = objective disabled); each breach "
    "also records a flight-recorder event.",
    label_names=("kind", "method"))

for _k in RPC_KINDS:
    for _q in SLO_QUANTILES:
        RPC_LATENCY_MS.labels(kind=_k, method="unknown", q=_q)

# ------------------------------------------------- tracing / flight recorder

TRACE_SPANS_TOTAL = REGISTRY.counter(
    "gol_trace_spans_total",
    "Spans finished by the in-process span tracer (obs/trace.py).")
TRACE_SPAN_DROPS_TOTAL = REGISTRY.counter(
    "gol_trace_span_drops_total",
    "Finished spans dropped because the tracer's export buffer was full "
    "(the flight-recorder ring still keeps the most recent tail).")
FLIGHT_DUMPS_TOTAL = REGISTRY.counter(
    "gol_flight_dumps_total",
    "Flight-recorder dumps written, by trigger reason.",
    label_names=("reason",))

# Same cardinality discipline as wire methods: reasons are clamped to a
# declared set and pre-seeded at zero.
FLIGHT_REASONS = ("sigterm", "watchdog", "exception", "manual", "unknown")
for _r in FLIGHT_REASONS:
    FLIGHT_DUMPS_TOTAL.labels(reason=_r)


def flight_reason_label(reason: str) -> str:
    """Clamp arbitrary dump reasons to the declared set."""
    return reason if reason in FLIGHT_REASONS else "unknown"


# ------------------------------------------------------------- checkpoints

CKPT_WRITES = REGISTRY.counter(
    "gol_ckpt_writes_total",
    "Checkpoint write attempts by the ckpt writer, by outcome: ok "
    "(durable manifest published), error (write pipeline raised), "
    "dropped (snapshot superseded before the disk caught up).",
    label_names=("status",))
CKPT_WRITE_SECONDS = REGISTRY.histogram(
    "gol_ckpt_write_seconds",
    "Wall seconds per checkpoint write (device→host copy, serialize, "
    "hash, atomic publish, retention) — on the background writer "
    "thread, overlapping engine compute.")
CKPT_BYTES = REGISTRY.counter(
    "gol_ckpt_bytes_total",
    "Payload bytes durably published by the ckpt writer.")
CKPT_LAST_TURN = REGISTRY.gauge(
    "gol_ckpt_last_turn",
    "Turn of the most recent durable checkpoint (manifest published).")
CKPT_RESTORES = REGISTRY.counter(
    "gol_ckpt_restores_total",
    "Checkpoint restore attempts, by outcome: ok, rejected (integrity "
    "verification refused the checkpoint), error.",
    label_names=("status",))

for _s in ("ok", "error", "dropped"):
    CKPT_WRITES.labels(status=_s)
for _s in ("ok", "rejected", "error"):
    CKPT_RESTORES.labels(status=_s)

# ------------------------------------------------------------- run journal

# Event-sourced run journal (gol_tpu_torch/journal.py): the gol-journal/1
# hash-chained black box. Kinds mirror journal.KINDS — a closed set so
# an arbitrary append can't mint unbounded label values.
JOURNAL_KINDS = ("create", "rule", "reseed", "pause", "resume", "fuse",
                 "link", "restore", "digest", "migrate_out", "usage",
                 "end", "other")
JOURNAL_EVENTS = REGISTRY.counter(
    "gol_journal_events_total",
    "gol-journal/1 records appended to per-run hash-chained journals "
    "(GOL_JOURNAL), by event kind.",
    label_names=("kind",))
for _k in JOURNAL_KINDS:
    JOURNAL_EVENTS.labels(kind=_k)
JOURNAL_BYTES = REGISTRY.counter(
    "gol_journal_bytes_total",
    "Bytes appended to journal files, newline included — the black "
    "box's disk footprint rate.")
JOURNAL_WALL_US = REGISTRY.counter(
    "gol_journal_wall_us_total",
    "Host wall microseconds spent inside the journal hot path — "
    "canonical board digests, inline seed encodes, and hash-chained "
    "appends.")
JOURNAL_DIGESTS = REGISTRY.counter(
    "gol_journal_digests_total",
    "Board-digest events journaled (engine chunk-boundary cadence via "
    "GOL_JOURNAL_DIGEST_EVERY plus every checkpoint written while "
    "journaling is on) — each one is a mid-history bit-identity "
    "assertion a replay can check.")

# ---------------------------------------------------------- kernel tiers

# Every tier the conv-family dispatch can select (ops/conv.TIERS
# mirrors this; pre-seeded so /metrics always shows the full matrix).
KERNEL_TIERS = ("bitplane", "fused", "conv", "fft")

KERNEL_TIER = REGISTRY.gauge(
    "gol_kernel_tier",
    "One-hot active kernel tier of the most recent conv-family "
    "dispatch: the selected tier reads 1, every other 0 "
    "(ops/conv.select_tier policy; GOL_KERNEL_TIER forces).",
    label_names=("tier",))
CONV_DISPATCHES = REGISTRY.counter(
    "gol_conv_dispatches_total",
    "Conv-family kernel dispatches (LtL / Lenia run submissions and "
    "standalone run_turns calls), by selected tier.",
    label_names=("tier",))

for _t in KERNEL_TIERS:
    KERNEL_TIER.labels(tier=_t)
    CONV_DISPATCHES.labels(tier=_t)
