"""Fleet serving on one CUDA device: the batched multi-run engine — the
counterpart of `gol_tpu/fleet/`, with its exports.

Layout:

  * `handles`   — RunHandle + the run-surface contract every engine
                  implements (`SingleRunSurface` for the single-run
                  engines); pure data, imports nothing heavy.
  * `admission` — device-memory budgeting: admit / queue / reject.
  * `buckets`   — padded size classes; one batched K9 launch per
                  bucket and serving quantum.
  * `engine`    — FleetEngine (the scheduler loop) + RunView.

`FleetEngine` and `RunView` are exported lazily: `gol_tpu_torch.engine`
imports `fleet.handles` (for the SingleRunSurface mixin), which runs
this package's __init__, and `fleet.engine` imports
`gol_tpu_torch.engine` back; the module __getattr__ defers that edge
until the fleet engine is asked for.
"""

from gol_tpu_torch.fleet.admission import AdmissionController, run_cost
from gol_tpu_torch.fleet.handles import (
    LEGACY_RUN_ID,
    RUN_STATES,
    FleetUnsupported,
    RunHandle,
    SingleRunSurface,
    fits_bucket,
    valid_run_id,
)

__all__ = [
    "AdmissionController",
    "run_cost",
    "LEGACY_RUN_ID",
    "RUN_STATES",
    "FleetUnsupported",
    "RunHandle",
    "SingleRunSurface",
    "fits_bucket",
    "valid_run_id",
    "FleetEngine",
    "RunView",
]


def __getattr__(name: str):
    if name in ("FleetEngine", "RunView"):
        from gol_tpu_torch.fleet import engine as _engine

        return getattr(_engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
