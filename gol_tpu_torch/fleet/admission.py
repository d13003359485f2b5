"""Admission control: how many runs the fleet may hold resident — the
counterpart of `gol_tpu/fleet/admission.py`, the same budgets, reasons
and environment variables.

Capacity is a DEVICE-MEMORY budget, not a run count: a 2048² board
costs 16× a 512² one, so counting runs would let a handful of large
boards OOM the device while rejecting thousands of small ones. The
budget resolves, in order:

    GOL_FLEET_MEM_BUDGET          explicit byte budget (tests, ops)
    the CUDA device's memory      GOL_FLEET_MEM_FRACTION (default 0.5)
                                  of its total memory
    DEFAULT_BUDGET_BYTES          256 MiB × placement devices — devices
                                  that report no memory size (the CPU)

Each resident run is charged `run_cost(hb, wpb)` = its bucket slot's
packed bytes × COST_FACTOR (3: resident state + the stepped copy each
dispatch writes + scratch; deliberately conservative). GOL_FLEET_MAX_RUNS (default 4096) additionally bounds
the run COUNT — per-run host bookkeeping (handles, flag queues,
checkpoint writers) is not free even when boards are tiny.

Beyond capacity a CreateRun is REJECTED by default (the caller gets a
diagnosable error naming the reason) or, with `queue=true`, parked in
a bounded FIFO (GOL_FLEET_QUEUE_MAX, default 1024) that drains as
resident runs are removed. Every decision is metered:
`gol_runs_admitted_total`, `gol_runs_rejected_total{reason}`,
`gol_runs_resident`.
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.utils.envcfg import env_float, env_int

MEM_BUDGET_ENV = "GOL_FLEET_MEM_BUDGET"      # bytes; overrides probing
MEM_FRACTION_ENV = "GOL_FLEET_MEM_FRACTION"  # of device limit_bytes
MAX_RUNS_ENV = "GOL_FLEET_MAX_RUNS"
QUEUE_MAX_ENV = "GOL_FLEET_QUEUE_MAX"

DEFAULT_BUDGET_BYTES = 256 << 20
DEFAULT_MEM_FRACTION = 0.5
DEFAULT_MAX_RUNS = 4096
DEFAULT_QUEUE_MAX = 1024

# Bytes charged per packed state byte: the resident bucket slot, the
# stepped output array alive during each dispatch, and headroom for
# temporaries (the JAX package's factor, kept for equal admissions).
COST_FACTOR = 3


def run_cost(hb: int, wpb: int) -> int:
    """Admission charge in bytes for one slot of an (hb, wpb) bucket."""
    return int(hb) * int(wpb) * 4 * COST_FACTOR


class AdmissionController:
    """Tracks committed bytes/runs and decides admit/queue/reject."""

    def __init__(self, budget_bytes: Optional[int] = None,
                 max_runs: Optional[int] = None,
                 queue_max: Optional[int] = None,
                 devices: int = 1, device=None) -> None:
        self._lock = threading.Lock()
        self._budget = budget_bytes
        # The torch device, or the placement devices, whose memory the
        # default budget is a share of (None or CPU devices:
        # DEFAULT_BUDGET_BYTES x devices).
        self.device = device
        # Placement-mesh width: the DEFAULT budget scales as
        # devices × per-device bytes — a bucket sharded over 8 devices
        # holds 1/8th of its batch on each. Explicit budgets (arg or
        # GOL_FLEET_MEM_BUDGET) stay ABSOLUTE: tests and operators that
        # pin a byte count mean that byte count; and the probed path
        # already sums per-device limit_bytes, so it needs no scaling.
        self.devices = max(1, int(devices))
        self.max_runs = (max_runs if max_runs is not None
                         else env_int(MAX_RUNS_ENV, DEFAULT_MAX_RUNS,
                                      minimum=1))
        self.queue_max = (queue_max if queue_max is not None
                          else env_int(QUEUE_MAX_ENV, DEFAULT_QUEUE_MAX,
                                       minimum=0))
        self.committed_bytes = 0
        self.resident_runs = 0
        self.queued_runs = 0
        # Promotion waits (seconds) since the last drain — bounded by
        # the queue itself (every entry was a queued run).
        self._queue_waits: list = []

    # ----------------------------------------------------------- budget

    def budget_bytes(self) -> int:
        """Resolve (and cache) the byte budget."""
        if self._budget is not None:
            return self._budget
        env_budget = env_int(MEM_BUDGET_ENV, 0, minimum=0)
        if env_budget:
            self._budget = env_budget
            return self._budget
        budget = DEFAULT_BUDGET_BYTES * self.devices
        devs = (self.device if isinstance(self.device, (list, tuple))
                else [self.device])
        cards = {d for d in devs if getattr(d, "type", None) == "cuda"}
        if cards:
            import torch

            # The distinct cards' memory, summed (the JAX package sums
            # its devices' limits): a card named twice counts once.
            total = sum(int(torch.cuda.get_device_properties(d)
                            .total_memory) for d in cards)
            frac = env_float(MEM_FRACTION_ENV, DEFAULT_MEM_FRACTION)
            budget = int(total * min(max(frac, 0.01), 1.0))
        self._budget = budget
        return budget

    # -------------------------------------------------------- decisions

    def try_admit(self, cost: int) -> Tuple[bool, Optional[str]]:
        """Charge `cost` bytes for a new resident run; (ok, reason)."""
        with self._lock:
            if self.resident_runs >= self.max_runs:
                return False, "max_runs"
            if self.committed_bytes + cost > self.budget_bytes():
                return False, "memory"
            self.committed_bytes += cost
            self.resident_runs += 1
        obs.RUNS_ADMITTED.inc()
        obs.RUNS_RESIDENT.set(self.resident_runs)
        return True, None

    def try_enqueue(self) -> Tuple[bool, Optional[str]]:
        with self._lock:
            if self.queued_runs >= self.queue_max:
                return False, "queue_full"
            self.queued_runs += 1
        return True, None

    def dequeue(self, waited_s: Optional[float] = None) -> None:
        """A run left the wait queue. `waited_s` (enqueue -> now) feeds
        the queue-wait SLO aggregates; abort/removal dequeues pass
        None — only real promotions measure the wait."""
        with self._lock:
            self.queued_runs = max(0, self.queued_runs - 1)
            if waited_s is not None:
                self._queue_waits.append(float(waited_s))

    def drain_queue_waits(self) -> list:
        """Hand the accumulated promotion waits (seconds) to the caller
        and clear them — the fleet loop's batched flush feeds these to
        the gol_fleet_queue_wait_ms estimator, so the hot path never
        touches an estimator lock."""
        with self._lock:
            out, self._queue_waits = self._queue_waits, []
        return out

    def release(self, cost: int) -> None:
        """Return a removed run's charge to the budget."""
        with self._lock:
            self.committed_bytes = max(0, self.committed_bytes - cost)
            self.resident_runs = max(0, self.resident_runs - 1)
        obs.RUNS_RESIDENT.set(self.resident_runs)

    def reject(self, reason: str) -> None:
        """Meter a rejection (shape/rule checks call this too, so the
        counter covers every CreateRun that did not admit)."""
        obs.RUNS_REJECTED.labels(reason=obs.run_reject_label(reason)).inc()

    def summary(self) -> dict:
        with self._lock:
            return {
                "resident": self.resident_runs,
                "queued": self.queued_runs,
                "committed_bytes": self.committed_bytes,
                "budget_bytes": self.budget_bytes(),
                "max_runs": self.max_runs,
                "devices": self.devices,
            }
