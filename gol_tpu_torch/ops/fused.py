"""Temporal fusion: k turns per pass over the board in device memory —
the depth policy of `gol_tpu/ops/fused.py`.

`GOL_FUSE_K` pins the depth k (0, unset or garbage = auto: every tier
keeps its native depth; clamped to `MAX_FUSE_K` = 64). The routing sits
beside the native dispatch in `parallel/halo.py`: `fused_packed_run_turns`
keeps a board that K1 holds on K1 (one launch already keeps every turn on
chip, the counterpart of the JAX tier's "the whole board fits one window
-> plain scan" edge) and sweeps any other packed board at depth k with
`ops/cuda_stencil.fused_banded_run_turns` (K2 up to depth 32, K6
`tiled_sweep_deep` beyond). The stacked Generations planes keep their
native dispatcher (K4/K5) at every depth, as the TPU branch of the JAX
module does, so `planes_run_turns` is the port's fused gen3 and gen4 run.

The JAX module's windowed jnp tier (`_fused_packed_scan`,
`_fused_planes_scan`, `fuse_block_rows`, `GOL_FUSE_BLOCK_BYTES`) is its
route for a platform without Pallas kernels. The port runs a hand-written
kernel at every depth on every shape, so that tier has no counterpart.
"""

from __future__ import annotations

from gol_tpu_torch.utils.envcfg import env_int

FUSE_K_ENV = "GOL_FUSE_K"
# A fuse depth past this is all margin: redundant-compute overhead grows
# while the saving in passes over the board (1/k) has long flattened.
MAX_FUSE_K = 64


def configured_fuse_k() -> int:
    """The pinned fuse depth from GOL_FUSE_K, clamped to [0, MAX_FUSE_K].
    0 (or unset/garbage) means auto: dispatch tiers keep their native
    adaptive depths and no explicit macro-stepping is forced."""
    return min(env_int(FUSE_K_ENV, 0, minimum=0), MAX_FUSE_K)
