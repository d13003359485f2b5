"""Single-device dispatch of the packed board — the counterpart of the
one-shard path of `gol_tpu/parallel/halo.py`. Row sharding and halo
exchange are not ported yet (ROADMAP A5).

The kind depends on the board's shape only; whether a kernel or its plain
version runs is decided by the tensor's device inside the kernel
wrappers, so the CPU tests walk the decomposition the card runs.
"""

from __future__ import annotations

from gol_tpu_torch.ops.bitpack import WORD_BITS
from gol_tpu_torch.ops.cuda_stencil import (
    banded_run_turns,
    fits_resident,
    resident_run_turns,
)
from gol_tpu_torch.ops.stencil import run_turns


def packed_run_kind(shape) -> str:
    """'resident' (K1, the whole board in one block's shared memory) when
    the packed board fits `RESIDENT_BOARD_BYTES`, else 'tiled' (K2
    sweeps). Hopper needs neither of the TPU's 128-lane or wp >= 2 gates:
    K2 takes any height and width, K1 any board that fits."""
    return "resident" if fits_resident(shape) else "tiled"


def packed_run_by_kind(kind: str):
    """The `(words, num_turns, rule) -> words` stepper for a kind."""
    return {"resident": resident_run_turns, "tiled": banded_run_turns}[kind]


def packed_run_turns(words, num_turns: int, rule):
    """Advance a packed board by the stepper its shape selects."""
    return packed_run_by_kind(packed_run_kind(words.shape))(
        words, num_turns, rule)


def select_representation(width: int):
    """(packed, run_fn): bit-packed whenever the width is a whole number
    of 32-cell words, else the uint8 roll-sum path."""
    if width % WORD_BITS == 0:
        return True, packed_run_turns
    return False, run_turns
