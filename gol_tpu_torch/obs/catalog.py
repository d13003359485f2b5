"""The metric families of the port's control plane, declared in one place
against the shared default registry — the part of
`gol_tpu/obs/catalog.py` that the wire codecs, the engine server, the
remote engine client, the chaos hooks, the tracer, the flight recorder,
the SLO estimators, the checkpoint writer and its fleet pool, restore,
the run journal, the conv-family kernel tiers, both engines (their
chunk-loop, run, SLO, audit, usage, fusion and step-signature families),
the telemetry exporter, tsdb and alerts, the federation registry and
router, the migration coordinator, the broadcast tier and its gateway,
device-memory polling, the profiler and the mesh and halo statistics
of sharded runs emit. Names, kinds, labels and pre-seeded children are
the JAX catalogue's, so a `GetMetrics` reply reads the same from either
package. The JAX compile hooks have no counterpart.
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
# families are visible at zero before the first fault.
CHAOS_KINDS = ("drop", "delay", "truncate", "corrupt", "stall",
               "kill_member", "refuse", "migrate_fail")
RPC_ERROR_KINDS = ("timeout", "refused", "reset", "protocol")

CHAOS_INJECTED = REGISTRY.counter(
    "gol_chaos_injected_total",
    "Faults injected by the GOL_CHAOS wire-layer injector "
    "(gol_tpu_torch/chaos.py), by kind: drop (socket closed instead of "
    "the operation), delay (bounded sleep), truncate (partial header "
    "then close), corrupt (one header byte zeroed so the peer sees a "
    "protocol error), stall (long sleep that outlasts read timeouts), "
    "refuse (dial-time ConnectionRefusedError before the socket "
    "connects), kill_member (process-level SIGKILL of a federation "
    "member at a seeded time), migrate_fail (one forced failure at a "
    "named Rescale migration phase). Stays 0 unless GOL_CHAOS is set.",
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
REPLAY_DIVERGENCE = REGISTRY.counter(
    "gol_replay_divergence_total",
    "Digest events at which a tools/replay_audit.py replay disagreed "
    "with the recorded journal. Stays 0 for a healthy deterministic "
    "engine; any increment means the recorded history and the engine "
    "no longer agree and the auditor has bisected to the first "
    "divergent turn.")

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

# ----------------------------------------------------------------- engine

ENGINE_TURN = REGISTRY.gauge(
    "gol_engine_turn",
    "Latest simulated turn completed by the engine chunk loop.")
ENGINE_PUBLISHED_TURN = REGISTRY.gauge(
    "gol_engine_published_turn",
    "Turn of the last published (alive, turn) pair; monotone within a "
    "run — regressions increment "
    "gol_engine_published_turn_regressions_total instead of moving this "
    "gauge backwards.")
ENGINE_PUBLISHED_ALIVE = REGISTRY.gauge(
    "gol_engine_published_alive",
    "Alive-cell count of the last published (alive, turn) pair.")
ENGINE_CUPS = REGISTRY.gauge(
    "gol_engine_cups",
    "Achieved cell updates per second over the most recent untraced "
    "chunk.")
ENGINE_TURNS_PER_S = REGISTRY.gauge(
    "gol_engine_turns_per_s",
    "Achieved turns per second over the most recent untraced chunk.")
ENGINE_CHUNK_SIZE = REGISTRY.gauge(
    "gol_engine_chunk_size",
    "Turns per compiled chunk currently chosen by the pace adapter.")

ENGINE_CHUNKS_TOTAL = REGISTRY.counter(
    "gol_engine_chunks_total",
    "Untraced chunks retired by the engine loop.")
ENGINE_TURNS_TOTAL = REGISTRY.counter(
    "gol_engine_turns_total",
    "Turns simulated across all retired chunks (traced included).")
ENGINE_TRACED_CHUNKS_TOTAL = REGISTRY.counter(
    "gol_engine_traced_chunks_total",
    "Chunks run under the GOL_TRACE profiler path; excluded from pace, "
    "CUPS, and chunk-latency aggregates.")
ENGINE_PUBLISHED_TURN_REGRESSIONS = REGISTRY.counter(
    "gol_engine_published_turn_regressions_total",
    "Publications that would have moved the published turn backwards "
    "within a run (should stay 0).")

ENGINE_CHUNK_SECONDS = REGISTRY.histogram(
    "gol_engine_chunk_seconds",
    "Wall seconds per retired untraced chunk (token wait + bookkeeping).")
ENGINE_FLAG_SERVICE_SECONDS = REGISTRY.histogram(
    "gol_engine_flag_service_seconds",
    "Seconds the chunk loop spent servicing control flags between "
    "chunk issues.")

ENGINE_CHUNK_OVERHEAD_US = REGISTRY.gauge(
    "gol_engine_chunk_overhead_us",
    "Mean host-side microseconds per retired chunk spent OUTSIDE the "
    "device-result wait (dispatch, publish, metrics, flag polling, "
    "pipeline bookkeeping) over the run so far; refreshed at each "
    "metrics flush and at run end.")

# ------------------------------------------------------------ fleet runs

RUNS_RESIDENT = REGISTRY.gauge(
    "gol_runs_resident",
    "Runs currently resident in the fleet engine (placed in a bucket "
    "slot, charged against the admission memory budget). Single-run "
    "engines leave this at 0.")
RUNS_ADMITTED = REGISTRY.counter(
    "gol_runs_admitted_total",
    "CreateRun admissions (a run became resident), including queued "
    "runs promoted when capacity freed.")
RUNS_REJECTED = REGISTRY.counter(
    "gol_runs_rejected_total",
    "CreateRun rejections, by reason: memory (admission byte budget), "
    "max_runs (GOL_FLEET_MAX_RUNS), queue_full, shape (board does not "
    "tile any configured bucket), rule (unsupported rule family), "
    "run_id (invalid or duplicate id).",
    label_names=("reason",))

# Same cardinality discipline as wire methods/flight reasons: reject
# reasons are clamped to a declared set and pre-seeded at zero.
RUN_REJECT_REASONS = ("memory", "max_runs", "queue_full", "shape",
                      "rule", "run_id", "unknown")
for _r in RUN_REJECT_REASONS:
    RUNS_REJECTED.labels(reason=_r)


def run_reject_label(reason: str) -> str:
    """Clamp arbitrary rejection reasons to the declared set."""
    return reason if reason in RUN_REJECT_REASONS else "unknown"


RUNS_DESTROYED = REGISTRY.counter(
    "gol_runs_destroyed_total",
    "DestroyRun removals: runs explicitly destroyed over the wire (or "
    "via FleetEngine.destroy_run), freeing their bucket slot and "
    "admission budget. QUIT/KILL-flag removals are not counted here.")

RUNS_QUARANTINED = REGISTRY.counter(
    "gol_runs_quarantined_total",
    "Runs evicted from their fleet bucket into state 'quarantined', by "
    "reason: popcount (implausible per-slot alive count), step (the "
    "shared bucket dispatch raised), restore (seed/restore of the slot "
    "failed). A quarantined board never re-enters the shared lax.scan "
    "dispatch until auto-restored from its last checkpoint.",
    label_names=("reason",))

QUARANTINE_REASONS = ("popcount", "step", "restore", "unknown")
for _r in QUARANTINE_REASONS:
    RUNS_QUARANTINED.labels(reason=_r)


def quarantine_label(reason: str) -> str:
    """Clamp arbitrary quarantine reasons to the declared set."""
    return reason if reason in QUARANTINE_REASONS else "unknown"


RUNS_QUARANTINE_RESTORES = REGISTRY.counter(
    "gol_runs_quarantine_restores_total",
    "Auto-restore attempts for quarantined runs from their last per-run "
    "checkpoint, by outcome: ok (run re-queued for placement), error "
    "(no usable checkpoint or restore raised; retried under backoff up "
    "to GOL_QUARANTINE_TRIES).",
    label_names=("status",))
for _s in ("ok", "error"):
    RUNS_QUARANTINE_RESTORES.labels(status=_s)


RUNS_RULE_MIGRATIONS = REGISTRY.counter(
    "gol_runs_rule_migrations_total",
    "SetRule bucket migrations: fleet runs moved between (size, "
    "rulestring) bucket classes via evict -> readmit through the "
    "placement queue, board preserved. No-op SetRule (same rulestring) "
    "is not counted.")

FLEET_DEVICE_RESIDENT = REGISTRY.gauge(
    "gol_fleet_device_resident_runs",
    "Resident fleet runs whose bucket slot lives on each device of the "
    "engine's placement mesh (batch-axis buckets put each slot on one "
    "device; spatially sharded buckets count their residents on every "
    "device holding a row shard). Label cardinality is bounded by the "
    "local device count, same as gol_dev_live_bytes.",
    label_names=("device",))

FLEET_MESH_DEVICES = REGISTRY.gauge(
    "gol_fleet_mesh_devices",
    "Devices in the fleet engine's placement mesh (1 = the unsharded "
    "single-device fleet; gol_mesh_* carries the full geometry stamp).")


def runs_doc() -> dict:
    """The /healthz runs summary: resident gauge + admission counters
    (registry reads only — never a device sync or an engine lock).
    On a mesh-placed fleet the summary also carries the placement
    device count and the per-device resident split."""
    rejected = 0.0
    for child in RUNS_REJECTED.children().values():
        rejected += child.value
    doc = {"resident": int(RUNS_RESIDENT.value),
           "admitted_total": int(RUNS_ADMITTED.value),
           "rejected_total": int(rejected)}
    mesh_devices = int(FLEET_MESH_DEVICES.value)
    if mesh_devices:
        doc["mesh_devices"] = mesh_devices
        doc["resident_by_device"] = {
            key[0]: int(child.value)
            for key, child in sorted(
                FLEET_DEVICE_RESIDENT.children().items())}
    return doc


# Fleet serving-tier SLOs (obs/slo.py's estimators, flushed by the fleet
# loop): bucket labels come from the configured bucket sizes, never from
# run ids.
FLEET_QUANTUM_MS = REGISTRY.gauge(
    "gol_fleet_quantum_latency_ms",
    "Serving-quantum wall latency quantiles per fleet bucket class "
    "(dispatch issue -> popcounts home), in milliseconds.",
    label_names=("bucket", "q"))
FLEET_QUEUE_DEPTH = REGISTRY.gauge(
    "gol_fleet_queue_depth",
    "Runs currently waiting in the fleet admission queue.")
FLEET_QUEUE_WAIT_MS = REGISTRY.gauge(
    "gol_fleet_queue_wait_ms",
    "Admission queue wait quantiles in milliseconds (enqueue -> "
    "promotion to placement).",
    label_names=("q",))
FLEET_STALENESS_MS = REGISTRY.gauge(
    "gol_fleet_staleness_ms",
    "Per-run turn staleness quantiles in milliseconds across resident "
    "unpaused runs: time since each run's board last advanced. The "
    "top-K worst runs are named on /healthz, never as metric labels.",
    label_names=("q",))

for _q in SLO_QUANTILES:
    FLEET_QUEUE_WAIT_MS.labels(q=_q)
    FLEET_STALENESS_MS.labels(q=_q)

# Fleet audit log (obs/audit.py): the gol-fleet-audit/1 record kinds,
# clamped like every other label set.
AUDIT_KINDS = ("member_join", "member_rejoin", "member_death", "adopt",
               "migrate", "quarantine", "alert_fired", "alert_resolved",
               "other")
AUDIT_RECORDS = REGISTRY.counter(
    "gol_audit_records_total",
    "gol-fleet-audit/1 records appended (durable log on the registry "
    "tier, bounded in-memory event ring on members), by kind.",
    label_names=("kind",))
for _k in AUDIT_KINDS:
    AUDIT_RECORDS.labels(kind=_k)

# ------------------------- per-run usage metering & capacity attribution

# Per-run accumulators live on the reference-swapped /healthz "usage"
# doc (top-K talkers, K = GOL_USAGE_TOPK), never as metric labels —
# the fleet-health cardinality posture. The registry only carries bounded
# scalars and the closed per-bucket capacity families below.
USAGE_RUNS_TRACKED = REGISTRY.gauge(
    "gol_usage_runs_tracked",
    "Runs with exact usage accumulators open on this member (resident "
    "runs only; bounded by the admission controller's max_runs, not by "
    "lifetime run count).")
USAGE_WALL_US = REGISTRY.counter(
    "gol_usage_wall_us_total",
    "Host wall microseconds spent inside the usage meter — dispatch "
    "apportionment, per-run charge updates, and doc rebuilds. The "
    "bench.py --usage leg gates this as a share of run wall "
    "(usage_overhead_pct), the same in-process cost-accounting pattern "
    "as journal_overhead_pct: a direct measure that cannot flap with "
    "host contention the way differential wall clock does.")
USAGE_FLUSHES = REGISTRY.counter(
    "gol_usage_flushes_total",
    "Usage-doc rebuilds (reference-swapped /healthz 'usage' doc), "
    "throttled to at most one per GOL_USAGE_FLUSH_S.")
USAGE_UNTRACKED = REGISTRY.counter(
    "gol_usage_untracked_total",
    "Charges whose run id had no open accumulator (late broadcast or "
    "checkpoint stragglers after destroy, unscoped legacy traffic) — "
    "folded into a single aggregate so stragglers can never grow the "
    "per-run map past its bound.")

# Capacity headroom model: measured quantum wall + the admission
# controller's memory charge, projected per bucket class. Bucket label
# values are the engine's configured "<h>x<w>" classes — env-dependent
# like gol_fleet_quantum_ms, so not pre-seeded here.
CAPACITY_ADMISSIBLE_RUNS = REGISTRY.gauge(
    "gol_capacity_admissible_runs",
    "Projected additional runs of this bucket class the member could "
    "admit right now: min(free admission budget // per-run memory "
    "charge, free slots).",
    label_names=("bucket",))
CAPACITY_CUPS_HEADROOM = REGISTRY.gauge(
    "gol_capacity_cups_headroom",
    "Projected additional cell updates per second this bucket class "
    "could absorb: admissible runs x cells per board x turns per "
    "dispatch / measured mean quantum wall (0 until a quantum has "
    "been measured).",
    label_names=("bucket",))
CAPACITY_RUN_COST_BYTES = REGISTRY.gauge(
    "gol_capacity_run_cost_bytes",
    "Admission memory charge for one run of this bucket class "
    "(height x words-per-row x 4 bytes x the double-buffer/halo cost "
    "factor).",
    label_names=("bucket",))
CAPACITY_FREE_BYTES = REGISTRY.gauge(
    "gol_capacity_free_bytes",
    "Uncommitted admission memory budget on this member "
    "(budget_bytes - committed_bytes).")

# ------------------------------------------------- checkpoint writer pool

CKPT_POOL_WRITERS = REGISTRY.gauge(
    "gol_ckpt_pool_writers",
    "Worker threads in the shared fleet checkpoint writer pool "
    "(GOL_FLEET_CKPT_WRITERS; 0 until a fleet cadence checkpoint is "
    "first submitted). Replaces the one-CheckpointWriter-per-run "
    "design: 512 residents share this fixed pool.")
CKPT_POOL_DEPTH = REGISTRY.gauge(
    "gol_ckpt_pool_depth",
    "Runs with a cadence snapshot pending in the shared writer pool "
    "(newest-wins per run; superseded snapshots count as "
    "gol_ckpt_writes_total{status='dropped'}). Bounded by resident "
    "runs, drained round-robin.")

# ---------------------------------------------------- mesh & halo telemetry

# Geometry of the most recently submitted run's device mesh (from
# parallel.mesh.mesh_geometry via devstats.note_mesh) plus the halo
# traffic of sharded dispatches (obs/halostats.py) — `gol_tpu`'s
# families, names, help texts and label sets. Axis labels are clamped to
# the declared mesh axes.
MESH_AXES = ("rows", "cols", "slots")

MESH_DEVICES = REGISTRY.gauge(
    "gol_mesh_devices",
    "Devices in the most recently submitted run's mesh (1 for "
    "single-device runs).")
MESH_SHARDS = REGISTRY.gauge(
    "gol_mesh_shards",
    "Board shards in the most recently submitted run's mesh (equal to "
    "gol_mesh_devices for the 1-D and 2-D meshes the engine builds).")
MESH_AXIS_SIZE = REGISTRY.gauge(
    "gol_mesh_axis_size",
    "Mesh extent along each named axis for the most recently submitted "
    "run; 0 for an axis the mesh does not have (a 1-D rows mesh leaves "
    "cols at 0).",
    label_names=("axis",))

HALO_EXCHANGES = REGISTRY.counter(
    "gol_halo_exchanges_total",
    "Halo exchange rounds dispatched, by mesh axis. One round is one "
    "paired ppermute send (both ring directions issued together) across "
    "the whole mesh — the latency-exposure unit of the deep-halo macro "
    "schedule. Analytic from the dispatch geometry, not a link probe.",
    label_names=("axis",))
HALO_BYTES = REGISTRY.counter(
    "gol_halo_bytes_total",
    "Bytes moved by halo exchange rounds, by mesh axis, summed over "
    "every shard's sends (whole-mesh traffic). Analytic from the "
    "dispatch geometry: rows x row-bytes x shards per round.",
    label_names=("axis",))
HALO_EXCHANGE_SECONDS = REGISTRY.histogram(
    "gol_halo_exchange_seconds",
    "Wall seconds per halo exchange round: dispatch wall divided by the "
    "round count of that dispatch. Exact for synchronous callers "
    "(bench legs); pipeline-amortized for engine chunks. Prices the "
    "round including any local compute it failed to overlap.",
    buckets=(1e-6, 5e-6, 1e-5, 5e-5, 1e-4, 5e-4, 1e-3, 5e-3,
             1e-2, 5e-2, 1e-1, 5e-1, 1.0))
SHARD_IMBALANCE = REGISTRY.gauge(
    "gol_shard_imbalance_ratio",
    "max/mean of per-shard cumulative readiness waits observed host-"
    "side after a sharded dispatch (obs/halostats."
    "measure_shard_imbalance): a completion-spread signal (1.0 = "
    "balanced), not a per-device timer.")
HALO_BYTES_PER_TURN = REGISTRY.gauge(
    "gol_halo_bytes_per_turn",
    "Analytic halo bytes per TURN of the most recent sharded dispatch, "
    "by mesh axis. Conserved under temporal fusion on the rows axis (a "
    "k-deep exchange ships 2k rows per k turns = 2 rows/turn) — the "
    "honest companion to the k-fold drop in exchange rounds/turn.",
    label_names=("axis",))
HALO_EXCHANGES_PER_TURN = REGISTRY.gauge(
    "gol_halo_exchanges_per_turn",
    "Analytic halo exchange rounds per TURN of the most recent sharded "
    "dispatch, by mesh axis: 1/T for a T-deep macro schedule — drops "
    "~k-fold when GOL_FUSE_K pins the depth (the latency-exposure win "
    "of temporal fusion).",
    label_names=("axis",))
for _a in MESH_AXES:
    MESH_AXIS_SIZE.labels(axis=_a)
    HALO_EXCHANGES.labels(axis=_a)
    HALO_BYTES.labels(axis=_a)
    HALO_BYTES_PER_TURN.labels(axis=_a)
    HALO_EXCHANGES_PER_TURN.labels(axis=_a)


def mesh_axis_label(axis: str) -> str:
    """Clamp arbitrary mesh-axis names to the declared set."""
    return axis if axis in MESH_AXES else "other"


# ------------------------------------------ fusion and step signatures

FUSE_K = REGISTRY.gauge(
    "gol_fuse_k",
    "Effective temporal-fusion depth of the most recently submitted "
    "run: generations advanced per materialized HBM state / per halo "
    "exchange round (ops/fused.py). 1 = auto/unfused (each dispatch "
    "tier keeps its native adaptive depth).")
# Closed dispatch-site label set: the three stack tiers that route
# through a fused program when GOL_FUSE_K pins a depth.
FUSE_TIERS = ("engine", "mesh", "fleet")
FUSED_DISPATCHES = REGISTRY.counter(
    "gol_fused_dispatches_total",
    "Temporally fused dispatches issued (k > 1 only), by dispatch "
    "site: 'engine' single/sharded chunk dispatches, 'mesh' bench mesh "
    "legs, 'fleet' bucket scans.",
    label_names=("tier",))
for _t in FUSE_TIERS:
    FUSED_DISPATCHES.labels(tier=_t)
FUSE_K.set(1)

COMPILE_STEP_SIGNATURES = REGISTRY.counter(
    "gol_compile_step_signatures_total",
    "Distinct engine step signatures (representation, board shape, "
    "dtype, mesh, rule) seen this process; each new one implies a "
    "fresh jit trace + compile.")

# ------------------------------------------------------------ federation

# Member lifecycle states the router's registry distinguishes. Closed
# set, pre-seeded like every other resilience family.
FED_MEMBER_STATES = ("live", "dead")

FED_MEMBERS = REGISTRY.gauge(
    "gol_fed_members",
    "Fleet servers known to the federation router's member registry, by "
    "state: live (heartbeat within GOL_FED_DEAD_AFTER) or dead "
    "(heartbeats lapsed; its runs are being adopted by survivors). A "
    "re-registering dead member moves back to live.",
    label_names=("state",))
for _s in FED_MEMBER_STATES:
    FED_MEMBERS.labels(state=_s)

FED_HEARTBEAT_AGE_MS = REGISTRY.gauge(
    "gol_fed_heartbeat_age_ms",
    "Heartbeat age quantiles in milliseconds across live members at the "
    "router's last registry sweep (now - last heartbeat stamp). Climbs "
    "toward GOL_FED_DEAD_AFTER*1000 as a member goes quiet.",
    label_names=("q",))
for _q in SLO_QUANTILES:
    FED_HEARTBEAT_AGE_MS.labels(q=_q)

FED_FAILOVERS = REGISTRY.counter(
    "gol_fed_failovers_total",
    "Members declared dead by the router's heartbeat sweep (each "
    "declaration triggers adoption of the member's placed runs by "
    "rendezvous re-placement over the survivors).")

FED_ADOPTED_RUNS = REGISTRY.counter(
    "gol_fed_adopted_runs_total",
    "Runs adopted from a dead member via its shared-root per-run "
    "checkpoints, by outcome: ok (the adopting member verified and "
    "restored the manifest, run re-queued for placement), error "
    "(adoption RPC failed or the restore exhausted its quarantine "
    "budget).",
    label_names=("status",))
for _s in ("ok", "error"):
    FED_ADOPTED_RUNS.labels(status=_s)

FED_ROUTER_OVERHEAD_MS = REGISTRY.gauge(
    "gol_fed_router_overhead_ms",
    "Router proxy overhead quantiles in milliseconds: client-facing "
    "wall time of a proxied RPC minus the member-facing round trip "
    "(relay framing + placement lookup + dedupe bookkeeping), from a "
    "log-bucket estimator flushed at the SLO cadence.",
    label_names=("q",))
for _q in SLO_QUANTILES:
    FED_ROUTER_OVERHEAD_MS.labels(q=_q)


# --------------------------------------------------- telemetry plane

# Heartbeat-borne snapshot export (obs/export.py, member side). The
# drop family labels mirror export.FAMILY_LABELS plus "events" — a
# closed set, so an over-budget snapshot meters exactly what it shed.
SNAPSHOT_FAMILIES = ("resident", "queue", "staleness", "quantum",
                     "slo", "cups", "dev_bytes", "usage", "events",
                     "unknown")

FED_SNAPSHOT_BYTES = REGISTRY.gauge(
    "gol_fed_snapshot_bytes",
    "Encoded size in bytes of the most recent telemetry snapshot this "
    "member attached to its RegisterMember heartbeat; always <= "
    "GOL_FED_SNAPSHOT_MAX (over-budget snapshots degrade by dropping "
    "families, never by fattening the beat).")
FED_SNAPSHOT_TOTAL = REGISTRY.counter(
    "gol_fed_snapshot_total",
    "Telemetry snapshots built for heartbeat export, by kind: full "
    "(first beat, or after the router requested a resync) or delta "
    "(only families whose value changed since the last ACKED beat).",
    label_names=("kind",))
for _k in ("full", "delta"):
    FED_SNAPSHOT_TOTAL.labels(kind=_k)
FED_SNAPSHOT_DROPPED = REGISTRY.counter(
    "gol_fed_snapshot_dropped_total",
    "Snapshot families (or the event batch) dropped to fit the "
    "GOL_FED_SNAPSHOT_MAX byte budget, lowest priority first; dropped "
    "deltas stay uncommitted and re-ship on the next beat.",
    label_names=("family",))
for _f in SNAPSHOT_FAMILIES:
    FED_SNAPSHOT_DROPPED.labels(family=_f)
FED_SNAPSHOT_INGESTED = REGISTRY.counter(
    "gol_fed_snapshot_ingested_total",
    "Heartbeat telemetry snapshots the registry tier merged into its "
    "per-member state (router side).")

# Fleet rollups the registry tier re-publishes every sweep from the
# ingested member snapshots (router side) — the sensing inputs of a
# fleet autoscaler's control loop.
FED_AGG_RUNS_RESIDENT = REGISTRY.gauge(
    "gol_fed_agg_runs_resident",
    "Fleet-wide resident-run total: exact sum of gol_runs_resident "
    "reported by live members at the router's last telemetry sweep.")
FED_AGG_QUEUE_DEPTH = REGISTRY.gauge(
    "gol_fed_agg_queue_depth",
    "Fleet-wide admission-queue depth: sum of gol_fleet_queue_depth "
    "across live members at the last telemetry sweep.")
FED_AGG_CUPS = REGISTRY.gauge(
    "gol_fed_agg_cups",
    "Aggregate cell updates per second: sum of gol_engine_cups across "
    "live members at the last telemetry sweep.")
FED_AGG_STALENESS_MS = REGISTRY.gauge(
    "gol_fed_agg_staleness_ms",
    "Fleet staleness quantiles in milliseconds: per-quantile MAX of "
    "gol_fleet_staleness_ms across live members (the worst member "
    "bounds the fleet).",
    label_names=("q",))
for _q in SLO_QUANTILES:
    FED_AGG_STALENESS_MS.labels(q=_q)
FED_AGG_IMBALANCE = REGISTRY.gauge(
    "gol_fed_agg_imbalance_ratio",
    "max/mean of per-member resident-run counts across reporting live "
    "members (1.0 = balanced or fewer than one resident anywhere).")
FED_AGG_MEMBERS_REPORTING = REGISTRY.gauge(
    "gol_fed_agg_members_reporting",
    "Live members whose telemetry snapshot the registry has ingested "
    "(<= gol_fed_members{state='live'}; lags one heartbeat on join).")
FED_AGG_SLO_BREACHES = REGISTRY.gauge(
    "gol_fed_agg_slo_breaches_total",
    "Fleet-wide SLO breach total: sum of each live member's "
    "gol_slo_breaches_total as last reported (a gauge of summed "
    "member counters, so member death can lower it).")
FED_AGG_DEV_LIVE_BYTES = REGISTRY.gauge(
    "gol_fed_agg_dev_live_bytes",
    "Fleet-wide live device memory in bytes: sum of per-device "
    "gol_dev_live_bytes across live members at the last sweep.")
FED_AGG_PAYLOAD_BYTES = REGISTRY.gauge(
    "gol_fed_agg_payload_bytes",
    "Quantiles of ingested heartbeat-snapshot sizes in bytes (router "
    "side, log-bucket estimator over all members since start).",
    label_names=("q",))
for _q in SLO_QUANTILES:
    FED_AGG_PAYLOAD_BYTES.labels(q=_q)

# Bounded time-series store (obs/tsdb.py, registry tier).
TSDB_SERIES = REGISTRY.gauge(
    "gol_tsdb_series",
    "Distinct series currently resident in the telemetry tsdb rings "
    "(hard-capped at GOL_TSDB_MAX_SERIES).")
TSDB_POINTS = REGISTRY.gauge(
    "gol_tsdb_points_total",
    "Samples appended to the telemetry tsdb since process start "
    "(every sample lands in all retention tiers at once).")
TSDB_EVICTIONS = REGISTRY.gauge(
    "gol_tsdb_evictions_total",
    "Series evicted least-recently-appended-first because the tsdb "
    "hit its GOL_TSDB_MAX_SERIES cardinality cap; a runaway label "
    "source degrades retention, never memory.")

# Alerting (obs/alerts.py). Built-in rule names are pre-seeded; rules
# added via GOL_ALERT_RULES seed their children at manager start.
ALERT_BUILTIN_RULES = ("member-death", "staleness-ceiling",
                       "queue-depth", "resident-imbalance")
ALERTS_ACTIVE = REGISTRY.gauge(
    "gol_alerts_active",
    "1 while the named alert rule is firing, else 0 (firing requires "
    "the breach to hold for the rule's for_s; resolving requires "
    "clear_s continuously below threshold — hysteresis, so a flapping "
    "signal cannot strobe this gauge).",
    label_names=("rule",))
ALERTS_FIRED = REGISTRY.counter(
    "gol_alerts_fired_total",
    "firing transitions of the named alert rule (each one also lands "
    "a flight-recorder event and a fleet audit-log record).",
    label_names=("rule",))
for _r in ALERT_BUILTIN_RULES:
    ALERTS_ACTIVE.labels(rule=_r)
    ALERTS_FIRED.labels(rule=_r)

# Router-side fleet rollups of the heartbeat-borne "use" family.
FED_AGG_USAGE_RUNS_TRACKED = REGISTRY.gauge(
    "gol_fed_agg_usage_runs_tracked",
    "Fleet-wide sum of gol_usage_runs_tracked across live members at "
    "the router's last telemetry sweep.")
FED_AGG_USAGE_ADMISSIBLE_RUNS = REGISTRY.gauge(
    "gol_fed_agg_usage_admissible_runs",
    "Fleet-wide projected admissible runs: sum over live members of "
    "each member's best bucket-class gol_capacity_admissible_runs as "
    "last reported on the heartbeat snapshot.")
FED_AGG_USAGE_CUPS_HEADROOM = REGISTRY.gauge(
    "gol_fed_agg_usage_cups_headroom",
    "Fleet-wide aggregate CUPS headroom: sum of per-member capacity "
    "headroom (all bucket classes) as last reported on the heartbeat "
    "snapshot.")


# ------------------------------------------- live migration & resharding

# Terminal outcomes of one Rescale cutover. Closed set, pre-seeded:
# ok (target authoritative, source copy retired), rolled_back (a phase
# failed before the redirect committed; the source copy resumed),
# error (rollback itself failed — the source copy is still present and
# authoritative, but the failure needed operator-visible attribution).
MIGRATION_STATUSES = ("ok", "rolled_back", "error")

MIGRATIONS = REGISTRY.counter(
    "gol_migrations_total",
    "Rescale live-migration attempts completed by this process's "
    "migration coordinator, by terminal status: ok (two-phase cutover "
    "committed — the run now lives on the target member and the router "
    "placement is pinned there), rolled_back (a phase failed or a "
    "GOL_CHAOS migrate_fail fault fired before the redirect committed; "
    "the staged target copy was destroyed and the source copy resumed "
    "authoritative), error (rollback was itself incomplete; exactly-one-"
    "owner still holds — the source was never released — but the "
    "attempt needs attention).",
    label_names=("status",))
for _s in MIGRATION_STATUSES:
    MIGRATIONS.labels(status=_s)

MIGRATION_DOWNTIME_MS = REGISTRY.gauge(
    "gol_migration_downtime_ms",
    "Quantiles of the redirect-slice wall time in milliseconds across "
    "completed migrations: the window between pinning the router "
    "placement at the target and retiring the source copy (with viewer "
    "re-key), during which a racing run-scoped RPC is answered with a "
    "retryable 'moved:' redirect instead of an error — downtime is "
    "latency, never an error.",
    label_names=("q",))
for _q in SLO_QUANTILES:
    MIGRATION_DOWNTIME_MS.labels(q=_q)


# ------------------------------------------ broadcast tier & gateway

# Deliberately run_id-free: one scalar per family. 100k spectators of
# one viral run must not become 100k label children, and per-run detail
# already lives on /healthz — same cardinality discipline as the fleet
# staleness gauges.
BCAST_STREAMS = REGISTRY.gauge(
    "gol_bcast_streams",
    "Epoch broadcast streams currently open on this server (one per "
    "(run, view geometry) with at least one subscriber ever; dropped "
    "with the run).")
BCAST_SUBSCRIBERS = REGISTRY.gauge(
    "gol_bcast_subscribers",
    "Viewer sockets currently attached to any broadcast stream "
    "(Subscribe upgrades adopted by the gateway event loop). "
    "Deliberately run_id-free — bounded cardinality regardless of how "
    "many runs or viewers exist.")
GATEWAY_CONNECTIONS = REGISTRY.gauge(
    "gol_gateway_connections",
    "Sockets currently owned by the selectors-based viewer gateway "
    "(subscribers plus connections mid-adoption); capped by "
    "GOL_GATEWAY_MAX.")

BCAST_FRAMES = REGISTRY.counter(
    "gol_bcast_frames_total",
    "Frames published into broadcast epoch streams, by kind: key "
    "(standalone keyframe — plain codec, decodable with no basis) or "
    "delta (xrle against the shared epoch basis). Each published frame "
    "is encoded exactly once no matter how many subscribers consume "
    "it: gol_wire_encode_calls_total advances by exactly 1 per "
    "publication (the bench.py --broadcast zero-work witness).",
    label_names=("kind",))
for _k in ("key", "delta"):
    BCAST_FRAMES.labels(kind=_k)

BCAST_FRAMES_DROPPED = REGISTRY.counter(
    "gol_bcast_frames_dropped_total",
    "Frames a slow subscriber never received because the stream ring "
    "overtook it and the gateway skipped it forward to the newest "
    "keyframe (the drop policy that keeps one stalled socket from "
    "backpressuring the ring, other subscribers, or the engine chunk "
    "loop).")
BCAST_SENT_BYTES = REGISTRY.counter(
    "gol_bcast_sent_bytes_total",
    "Bytes the gateway pushed to subscribers (every socket counts the "
    "shared frame bytes it actually received). Fan-out cost of the "
    "broadcast tier; the encode cost is in gol_wire_frame_bytes_total "
    "exactly once per published frame.")

BCAST_FANOUT_MS = REGISTRY.gauge(
    "gol_bcast_fanout_ms",
    "Fan-out latency quantiles in milliseconds from a log-bucket "
    "estimator (obs/slo.py): publication of a frame into the stream "
    "ring -> the last byte of that frame handed to a subscriber's "
    "socket, one sample per (frame, subscriber) delivery.",
    label_names=("q",))
for _q in SLO_QUANTILES:
    BCAST_FANOUT_MS.labels(q=_q)


# --------------------------------------------------- device telemetry

# Values come from devstats.poll_device_memory() (torch.cuda.memory_stats
# on the engine's CUDA device); the CPU leaves the per-device families
# empty and gol_dev_mem_supported at 0.
DEV_LIVE_BYTES = REGISTRY.gauge(
    "gol_dev_live_bytes",
    "Live device memory in bytes per device, from "
    "device.memory_stats(); absent stats (CPU backends) leave the "
    "family empty and flip gol_dev_mem_supported to 0.",
    label_names=("device",))
DEV_PEAK_BYTES = REGISTRY.gauge(
    "gol_dev_peak_bytes",
    "Peak device memory in bytes per device since process start, from "
    "device.memory_stats().",
    label_names=("device",))
DEV_LIMIT_BYTES = REGISTRY.gauge(
    "gol_dev_limit_bytes",
    "Device memory capacity in bytes per device, where the backend "
    "reports one.",
    label_names=("device",))
DEV_MEM_SUPPORTED = REGISTRY.gauge(
    "gol_dev_mem_supported",
    "1 if device.memory_stats() returns data on this backend, else 0.")
DEV_DEVICES = REGISTRY.gauge(
    "gol_dev_devices",
    "Number of addressable devices visible to the process.")

# Per-device kind census: heterogeneous device lists (a CPU host plus
# accelerators, or mixed TPU generations) get one gauge child per kind,
# clamped to a small declared budget so a pathological backend cannot
# mint unbounded label values.
DEV_KIND_MAX = 8

DEV_KIND_DEVICES = REGISTRY.gauge(
    "gol_dev_kind_devices",
    "Addressable devices by device_kind string, from the last device "
    "poll. At most DEV_KIND_MAX distinct kinds are labelled; overflow "
    "kinds aggregate under 'other'.",
    label_names=("kind",))

_seen_kinds: set = set()


def dev_kind_label(kind: str) -> str:
    """Clamp device-kind label values to a bounded set (first
    DEV_KIND_MAX distinct kinds seen, then 'other')."""
    if kind in _seen_kinds:
        return kind
    if len(_seen_kinds) < DEV_KIND_MAX:
        _seen_kinds.add(kind)
        return kind
    return "other"


DEV_MEM_STATS_SUPPORTED = REGISTRY.gauge(
    "gol_dev_mem_stats_supported",
    "1 if device.memory_stats() returns data for this device, else 0 — "
    "one child per addressable device, so heterogeneous lists (some "
    "devices with stats, some without) are visible per device rather "
    "than collapsed into the scalar gol_dev_mem_supported.",
    label_names=("device",))


# ----------------------------------------------------------- profiler

PROFILE_CAPTURES = REGISTRY.counter(
    "gol_profile_captures_total",
    "On-demand torch.profiler trace captures, by outcome.",
    label_names=("status",))
PROFILE_ARMED = REGISTRY.gauge(
    "gol_profile_armed",
    "1 while a profile capture request is pending or in progress.")

for _s in ("ok", "error"):
    PROFILE_CAPTURES.labels(status=_s)
