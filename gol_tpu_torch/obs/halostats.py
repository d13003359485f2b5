"""Halo telemetry (the gol_halo_* families) — the counterpart of
`gol_tpu/obs/halostats.py`.

Two producers feed it, as in the JAX package:

* Direct callers of the sharded run functions (`parallel/halo.py`,
  `parallel/mesh2d.py`; tests, `chip_smoke.py`) note each dispatch here
  as it happens (`halo.dispatch_obs`).
* The engine calls the run functions' inner halves, which note nothing,
  and buffers (turns, wall_s) per popped chunk, drained through
  `flush_chunk_walls` at its batched metrics flush.

gol_halo_exchanges_total and gol_halo_bytes_total are exact analytic
counts from the dispatch geometry (`parallel.halo.halo_traffic`), equal
to `gol_tpu`'s for the same dispatch; gol_halo_exchange_seconds is the
dispatch wall over its rounds; gol_shard_imbalance_ratio is max/mean of
the per-shard completion waits read in shard order.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Tuple

from gol_tpu_torch.obs import catalog as _cat

# Traffic dicts map mesh-axis name -> (exchange_rounds, total_bytes).
Traffic = Dict[str, Tuple[int, int]]


def note_traffic(traffic: Traffic, num_turns: int = 0) -> None:
    """Fold one dispatch's analytic traffic into the counters; with the
    dispatch's turn count, also refresh the per-turn gauges."""
    for axis, (rounds, nbytes) in traffic.items():
        lab = _cat.mesh_axis_label(axis)
        if rounds:
            _cat.HALO_EXCHANGES.labels(axis=lab).inc(int(rounds))
        if nbytes:
            _cat.HALO_BYTES.labels(axis=lab).inc(int(nbytes))
    if num_turns > 0:
        _set_per_turn(traffic, num_turns)


def _set_per_turn(per_axis: Traffic, num_turns: int) -> None:
    for axis, (rounds, nbytes) in per_axis.items():
        lab = _cat.mesh_axis_label(axis)
        _cat.HALO_EXCHANGES_PER_TURN.labels(axis=lab).set(
            rounds / num_turns)
        _cat.HALO_BYTES_PER_TURN.labels(axis=lab).set(nbytes / num_turns)


def total_rounds(traffic: Traffic) -> int:
    return sum(int(r) for r, _ in traffic.values())


def total_bytes(traffic: Traffic) -> int:
    return sum(int(b) for _, b in traffic.values())


def flush_chunk_walls(walls: Iterable[Tuple[int, float]],
                      traffic_for_k: Callable[[int], Traffic]) -> None:
    """The engine's drain: `walls` holds (turns, wall_s) per popped chunk,
    `traffic_for_k(turns)` that chunk's analytic traffic."""
    per_axis: Dict[str, Tuple[int, int]] = {}
    samples = []
    turns = 0
    for k, wall in walls:
        traffic = traffic_for_k(k)
        if not traffic:
            continue
        turns += int(k)
        rounds = 0
        for axis, (r, b) in traffic.items():
            er, eb = per_axis.get(axis, (0, 0))
            per_axis[axis] = (er + int(r), eb + int(b))
            rounds += int(r)
        if rounds and wall > 0:
            samples.append(wall / rounds)
    for axis, (rounds, nbytes) in per_axis.items():
        lab = _cat.mesh_axis_label(axis)
        if rounds:
            _cat.HALO_EXCHANGES.labels(axis=lab).inc(rounds)
        if nbytes:
            _cat.HALO_BYTES.labels(axis=lab).inc(nbytes)
    if turns:
        _set_per_turn(per_axis, turns)
    if samples:
        _cat.HALO_EXCHANGE_SECONDS.observe_batch(samples)


def measure_shard_imbalance(board) -> Optional[float]:
    """Publish gol_shard_imbalance_ratio from a freshly dispatched
    `ShardedBoard`: record an event on each local CUDA shard's stream
    now (after all the work queued for it; a CPU shard is ready), wait
    for them in shard order and record the cumulative wait at each.
    Shards sharing a card share its stream, so they finish together.
    None with fewer than two local shards."""
    shards = [s for s in getattr(board, "shards", ()) if s is not None]
    if len(shards) < 2:
        return None
    import torch

    events = []
    for s in shards:
        ev = None
        if s.is_cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(s.device))
        events.append(ev)
    waits = []
    t0 = time.perf_counter()
    for ev in events:
        if ev is not None:
            ev.synchronize()
        waits.append(max(time.perf_counter() - t0, 0.0))
    mean = sum(waits) / len(waits)
    ratio = max(waits) / mean if mean > 1e-9 else 1.0
    _cat.SHARD_IMBALANCE.set(ratio)
    return ratio
