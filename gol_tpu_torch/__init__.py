"""gol_tpu_torch — the PyTorch/CUDA port of `gol_tpu`, for one NVIDIA
Hopper GPU.

Same public surface as the JAX package (reference `Local/gol/gol.go`):

    from gol_tpu_torch import Params, run
    run(Params(image_width=512, image_height=512, turns=100),
        events, key_presses)

Rules are life-like ('B3/S23') or Generations ('/2/3', '345/2/4'; the
`rule=` argument, `GOL_RULE` or the CLI's `--rule`); Generations boards
travel as gray PGM levels (`models/generations.py`).

`run(..., sparse=True)` runs a small pattern on an enormous torus (the
width and height give the torus, `images/seed.pgm` the pattern) on the
sparse engine, which holds only the live window (`sparse_engine.py`).

The engine runs on the CUDA device unless the caller asks for the CPU
(`run(..., device="cpu")` or `engine=Engine(device="cpu")`). The package
imports torch and numpy, never jax nor `gol_tpu`.
"""

from gol_tpu_torch.events import (
    AliveCellsCount,
    CellFlipped,
    CellsFlipped,
    EngineLost,
    EngineReattached,
    Event,
    FinalTurnComplete,
    ImageOutputComplete,
    State,
    StateChange,
    TurnComplete,
)
from gol_tpu_torch.gol import run
from gol_tpu_torch.params import Params

__all__ = [
    "Params",
    "run",
    "Event",
    "AliveCellsCount",
    "CellFlipped",
    "CellsFlipped",
    "EngineLost",
    "EngineReattached",
    "FinalTurnComplete",
    "ImageOutputComplete",
    "State",
    "StateChange",
    "TurnComplete",
]
