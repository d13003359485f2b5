"""Device meshes and the sharded board — the counterpart of
`gol_tpu/parallel/mesh.py`.

The reference's broker cuts the board into one horizontal strip a
worker (`Server/gol/distributor.go:104-165`); the length of `SUB` is the
worker count. Here a `Mesh` lays the board's row axis (and, on a 2-D
mesh, its packed-word axis) over a grid of torch devices, and a
`ShardedBoard` holds one tensor a mesh position, in mesh order, each on
its position's device. A device may appear more than once: tests shard
over `[torch.device("cpu")] * 8`, as the JAX tests shard over eight
virtual CPU devices, and `chip_smoke.py` over `[cuda:0] * S`. The
engine's default is the distinct visible CUDA devices, so on one card a
requested shard count clamps to one (`gol_tpu/engine.py:646-652`).

Across processes (`parallel/multihost.py`) every position also names the
rank that owns it; a process holds the shards of its own positions only.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np
import torch

ROWS_AXIS = "rows"

# The fleet's batch axis (a bucket's slots split over devices); kept so
# geometry stamps read alike in both packages.
SLOTS_AXIS = "slots"


class Mesh:
    """A grid of torch devices with named axes, hashable, with the
    `.shape` (by axis name), `.size`, `.devices` and `.axis_names` that
    `jax.sharding.Mesh` offers. `procs` names the process rank owning
    each position (all this process's when not given); a mesh across
    processes also carries its halos' `backend` ('gloo' or 'nccl') and
    the process `group` they ride (None: the default group)."""

    def __init__(self, devices: np.ndarray, axis_names, procs=None,
                 rank: int = 0, backend: Optional[str] = None,
                 group=None):
        if devices.ndim != len(axis_names):
            raise ValueError(f"mesh of shape {devices.shape} needs "
                             f"{devices.ndim} axis names, got {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.procs = (np.full(devices.shape, rank, dtype=np.int64)
                      if procs is None else
                      np.asarray(procs, dtype=np.int64).reshape(
                          devices.shape))
        self.rank = int(rank)
        self.backend, self.group = backend, group
        self._key = (tuple(str(d) for d in devices.flat), devices.shape,
                     self.axis_names,
                     tuple(int(p) for p in self.procs.flat), self.rank,
                     backend)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def local(self, pos: int) -> bool:
        """Whether flat position `pos` is this process's."""
        return int(self.procs.flat[pos]) == self.rank

    def __hash__(self) -> int:
        return hash(self._key)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, devices="
                f"{[str(d) for d in self.devices.flat]})")


def device_grid(devices: Sequence, shape) -> np.ndarray:
    """An object array of `shape` holding `devices` as torch.device."""
    grid = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        grid[i] = torch.device(d)
    return grid.reshape(shape)


def default_devices() -> list:
    """The distinct visible CUDA devices; raises where there are none
    (`engine.resolve_device`'s message)."""
    from gol_tpu_torch.engine import resolve_device

    first = resolve_device(None)
    return [first] + [torch.device("cuda", i)
                      for i in range(torch.cuda.device_count())
                      if i != first.index]


def resolve_shard_count(height: int, requested: int) -> int:
    """Largest n <= requested with height % n == 0 (n >= 1), warning on a
    downgrade: the equal-shards policy for direct kernel users. The
    engine serves any count exactly through the wrap extension
    (`parallel/halo.py`)."""
    if requested < 1:
        raise ValueError(f"shard request must be >= 1, got {requested}")
    n = max(1, min(requested, height))
    while height % n != 0:
        n -= 1
    if n != requested:
        warnings.warn(
            f"shard request {requested} downgraded to {n}: board height "
            f"{height} is not divisible by {requested}", stacklevel=2)
    return n


def make_mesh(num_shards: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the first `num_shards` devices, axis name 'rows'."""
    devices = list(devices if devices is not None else default_devices())
    n = num_shards if num_shards is not None else len(devices)
    if n > len(devices):
        raise ValueError(f"asked for {n} shards, have {len(devices)} devices")
    return Mesh(device_grid(devices[:n], (n,)), (ROWS_AXIS,))


def make_batch_mesh(devices: Sequence) -> Mesh:
    """1-D mesh over `devices`, axis name 'slots': the fleet bucket's
    batch mesh (`fleet/buckets.py`), kept apart from `make_mesh` so that
    geometry stamps never confuse a batch placement with row sharding."""
    devices = list(devices)
    return Mesh(device_grid(devices, (len(devices),)), (SLOTS_AXIS,))


def mesh_geometry(mesh: Mesh) -> dict:
    """The geometry dict every surface stamps (/healthz `mesh`, the run
    report's `run_start`, Stats): device count, shard count (equal for
    the meshes built here), axis sizes by name, grid shape — `gol_tpu`'s,
    key for key."""
    axes = {str(name): int(size)
            for name, size in zip(mesh.axis_names, mesh.devices.shape)}
    return {
        "devices": int(mesh.size),
        "shards": int(mesh.size),
        "axes": axes,
        "shape": [int(s) for s in mesh.devices.shape],
    }


class ShardedBoard:
    """A board cut over a mesh: `shards[pos]` is the tensor of flat mesh
    position `pos` (row-major over the grid), on that position's device,
    or None where another process owns it. Rows are the second-to-last
    axis of every representation (stacked gen3 planes included), packed
    words the last; a 2-D mesh cuts both."""

    def __init__(self, shards: list, mesh: Mesh):
        self.shards = list(shards)
        self.mesh = mesh

    @property
    def grid(self) -> tuple:
        """(row shards, column shards)."""
        s = self.mesh.devices.shape
        return (s[0], s[1] if len(s) > 1 else 1)

    def _first(self) -> torch.Tensor:
        return next(s for s in self.shards if s is not None)

    @property
    def shape(self) -> tuple:
        """The whole board's shape."""
        part = self._first().shape
        r, c = self.grid
        return tuple(part[:-2]) + (part[-2] * r, part[-1] * c)

    @property
    def dtype(self):
        return self._first().dtype

    def device_bytes(self) -> int:
        """The most bytes the shards hold on one device."""
        per: dict = {}
        for s in self.shards:
            if s is not None:
                per[s.device] = per.get(s.device, 0) + (
                    s.numel() * s.element_size())
        return max(per.values())

    def gather(self) -> torch.Tensor:
        """The whole board as one tensor on the first shard's device, the
        shards read in mesh order."""
        if any(s is None for s in self.shards):
            raise RuntimeError(
                "gather needs every shard; this process holds "
                f"{sum(s is not None for s in self.shards)} of "
                f"{len(self.shards)}")
        dev = self.shards[0].device
        r, c = self.grid
        rows = []
        for i in range(r):
            parts = [s.to(dev) for s in self.shards[i * c:(i + 1) * c]]
            rows.append(parts[0] if c == 1 else torch.cat(parts, dim=-1))
        return rows[0] if r == 1 else torch.cat(rows, dim=-2)


def shard(cells: torch.Tensor, mesh: Mesh) -> ShardedBoard:
    """Cut a whole board (rows on axis -2, words on -1) over `mesh`: equal
    row bands (and, on a 2-D mesh, equal word columns), each copied to
    its position's device. Positions of other processes hold None."""
    r = mesh.devices.shape[0]
    c = mesh.devices.shape[1] if mesh.devices.ndim > 1 else 1
    h, w = cells.shape[-2:]
    if h % r or w % c:
        raise ValueError(f"board {tuple(cells.shape)} does not cut into "
                         f"{r}x{c} equal shards")
    rs, cs = h // r, w // c
    out = []
    for pos, dev in enumerate(mesh.devices.flat):
        if not mesh.local(pos):
            out.append(None)
            continue
        i, j = divmod(pos, c)
        part = cells[..., i * rs:(i + 1) * rs, j * cs:(j + 1) * cs]
        out.append(part.to(dev).contiguous())
    return ShardedBoard(out, mesh)
