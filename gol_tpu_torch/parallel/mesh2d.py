"""The 2-D mesh: a packed board sharded over rows and word columns — the
counterpart of `gol_tpu/parallel/mesh2d.py`.

A macro-step of depth T <= 32 trades T rows with the neighbours above
and below (`halo.exchange_halos` along 'rows'), then one 32-cell word
column with the neighbours left and right, cut from the row-extended
window so the corners ride along ('cols'), and steps the (R + 2T,
wpc + 2)-word window T turns through the single-device dispatch of its
shape (`halo.run_window`: K1 when it fits, else K2); its exact middle
[T:-T, 1:-1] is kept. A one-word halo protects 32 turns of corruption
whatever the shard's width, so T <= 32; a T-row halo comes from the
adjacent shard only, so T <= the shard height.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import torch

from gol_tpu_torch.models.lifelike import CONWAY
from gol_tpu_torch.parallel import halo
from gol_tpu_torch.parallel.halo import dispatch_obs, exchange_halos
from gol_tpu_torch.parallel.mesh import (
    ROWS_AXIS,
    Mesh,
    ShardedBoard,
    default_devices,
    device_grid,
)

COLS_AXIS = "cols"

# T <= 32 so one word column covers the horizontal halo; T <= shard_rows
# so the vertical halo comes from the adjacent shard only.
MAX_T_2D = 16


def macro_T_2d(shard_rows: int, fuse: int = 0) -> int:
    """Macro depth of one 2-D dispatch: MAX_T_2D, or the pinned fuse
    depth k when set — capped at 32 (the one-word horizontal halo) and
    at the shard height. `halo.halo_traffic` mirrors this."""
    if fuse > 1:
        return min(fuse, 2 * MAX_T_2D, shard_rows)
    return min(MAX_T_2D, shard_rows)


def make_mesh2d(shape: Tuple[int, int],
                devices: Optional[Sequence] = None) -> Mesh:
    """(rows_shards, cols_shards) mesh with axes ('rows', 'cols') over
    the first r * c devices, row-major."""
    devices = list(devices if devices is not None else default_devices())
    r, c = shape
    if r * c > len(devices):
        raise ValueError(
            f"mesh {r}x{c} needs {r * c} devices, have {len(devices)}")
    return Mesh(device_grid(devices[:r * c], (r, c)),
                (ROWS_AXIS, COLS_AXIS))


def _macro_2d(board: ShardedBoard, T: int, rule,
              counts=None) -> ShardedBoard:
    """One T-turn macro-step of every shard this process holds; with
    `counts`, each window's launch counts its shard's own words."""
    mesh = board.mesh
    top, bot = exchange_halos(board.shards, mesh, ROWS_AXIS, T, axis=-2)
    tall = [None if s is None else torch.cat([t, s, b], dim=-2)
            for t, s, b in zip(top, board.shards, bot)]
    west, east = exchange_halos(tall, mesh, COLS_AXIS, 1, axis=-1)
    out = []
    for pos, local in enumerate(board.shards):
        if local is None:
            out.append(None)
            continue
        rows, words = local.shape
        count = None if counts is None else counts[pos]
        box = None if count is None else (T, T + rows, 1, 1 + words)
        window = torch.cat([west[pos], tall[pos], east[pos]], dim=-1)
        res = halo._step_window("packed", window, T, rule, count, box)
        out.append(res[T:T + rows, 1:1 + words])
    return ShardedBoard(out, mesh)


def _sharded_2d(board: ShardedBoard, num_turns: int, rule=CONWAY,
                fuse: int = 0, count=None) -> ShardedBoard:
    """`sharded_packed_run_turns_2d` without its telemetry (the
    engine's)."""
    n_rows = board.mesh.shape[ROWS_AXIS]
    T = macro_T_2d(board.shape[-2] // n_rows, fuse)
    full, rem = divmod(num_turns, T)
    depths = [T] * full + ([rem] if rem else [])
    for i, t in enumerate(depths):
        board = _macro_2d(board, t, rule,
                          count if i == len(depths) - 1 else None)
    return board


def sharded_packed_run_turns_2d(board: ShardedBoard, num_turns: int,
                                mesh: Mesh, rule=CONWAY, fuse: int = 0, *,
                                count=None) -> ShardedBoard:
    """Advance a 2-D-sharded packed board `num_turns` turns: full macros
    of depth `macro_T_2d` and one shallower remainder, so every count
    works; `fuse` pins the depth (capped at 32). `count` as
    `halo.sharded_packed_run_turns`'s."""
    n_rows, n_cols = mesh.shape[ROWS_AXIS], mesh.shape[COLS_AXIS]
    h, wp = board.shape
    if h % n_rows or wp % n_cols:
        raise ValueError(f"board {board.shape} not divisible by mesh "
                         f"{n_rows}x{n_cols}")
    with dispatch_obs("packed", board, num_turns, mesh, fuse):
        return _sharded_2d(board, num_turns, rule, fuse, count)


def mesh2d_run_fn(fuse: int = 0):
    """The engine's `(board, num_turns, rule, *, count=None)` run of a
    2-D-sharded packed board at fuse depth `fuse` (0 = MAX_T_2D)."""
    return functools.partial(_sharded_2d, fuse=fuse)
