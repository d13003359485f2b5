"""Single-device dispatch of the packed board and of the Generations
planes — the counterpart of the one-shard paths of
`gol_tpu/parallel/halo.py`, and the one-shard packed run pinned at a
fuse depth (`fused_packed_run_turns`, `fused_run_fn`; `ops/fused.py`).
Row sharding, halo exchange and the multi-shard deep halo at T = k are
not ported yet (ROADMAP A5).

The kind depends on the board's shape only; whether a kernel or its plain
version runs is decided by the tensor's device inside the kernel
wrappers, so the CPU tests walk the decomposition the card runs.
"""

from __future__ import annotations

import functools

from gol_tpu_torch.models.lifelike import CONWAY
from gol_tpu_torch.ops.bitpack import WORD_BITS
from gol_tpu_torch.ops.cuda_stencil import (
    banded_run_turns,
    banded_run_turns2p,
    fits_resident,
    fits_resident2p,
    fused_banded_run_turns,
    resident_run_turns,
    resident_run_turns2p,
)
from gol_tpu_torch.ops.fused import MAX_FUSE_K
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


def fused_packed_run_turns(words, num_turns: int, rule=CONWAY,
                           fuse: int = 0):
    """Advance a packed board `num_turns` turns at fuse depth `fuse` (the
    counterpart of `gol_tpu/ops/fused.py`'s), bit-identical to
    `packed_run_turns`. `fuse <= 1` and a board K1 holds take the native
    stepper; any other board sweeps at depth min(fuse, MAX_FUSE_K)."""
    if fuse <= 1 or packed_run_kind(words.shape) == "resident":
        return packed_run_turns(words, num_turns, rule)
    return fused_banded_run_turns(words, num_turns, min(fuse, MAX_FUSE_K),
                                  rule)


def fused_run_fn(fuse: int):
    """The engine's `(cells, num_turns, rule)` packed run pinned at fuse
    depth `fuse`."""
    return functools.partial(fused_packed_run_turns, fuse=fuse)


def select_representation(width: int):
    """(packed, run_fn): bit-packed whenever the width is a whole number
    of 32-cell words, else the uint8 roll-sum path."""
    if width % WORD_BITS == 0:
        return True, packed_run_turns
    return False, run_turns


# ------------------------------------------------- Generations planes


def planes_run_kind(shape) -> str:
    """'resident' (K4, both planes in one block's shared memory) when
    each plane of the (2, H, Wp) pair fits `RESIDENT2P_PLANE_BYTES`, else
    'tiled' (K5 sweeps) — the counterpart of `_dispatch_two_planes`'s
    VMEM gate, from the shape alone."""
    return "resident" if fits_resident2p(shape) else "tiled"


def planes_run_by_kind(kind: str):
    """The `(planes, num_turns, rule, family) -> planes` stepper."""
    return {"resident": resident_run_turns2p,
            "tiled": banded_run_turns2p}[kind]


def planes_run_turns(planes, num_turns: int, rule, family: str):
    """Advance stacked (2, H, Wp) planes of `family` ('gen3' or 'gen4')
    by the stepper their shape selects."""
    return planes_run_by_kind(planes_run_kind(planes.shape))(
        planes, num_turns, rule, family)


def gen3_run_turns(stacked, num_turns: int, rule):
    """The engine's gen3 run: stacked (alive, dying) planes — one shard
    of `sharded_gen3_run_turns`."""
    return planes_run_turns(stacked, num_turns, rule, "gen3")


def generations_run_turns(state, num_turns: int, rule):
    """The engine's gen8 run: a uint8 state board — one shard of
    `sharded_generations_run_turns`, plain torch as in the JAX package."""
    from gol_tpu_torch.models.generations import run_turns as gen8_run

    return gen8_run(state, num_turns, rule)


def select_generations_representation(width: int, rule):
    """(repr, run_fn): 'gen3' planes for three-state rules on widths that
    are a whole number of words, else 'gen8' uint8 states (four-state
    rules included, as the JAX engine runs them)."""
    if rule.states == 3 and width % WORD_BITS == 0:
        return "gen3", gen3_run_turns
    return "gen8", generations_run_turns
