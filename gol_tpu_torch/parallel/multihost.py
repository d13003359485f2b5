"""Multi-process engines over `torch.distributed` — the counterpart of
`gol_tpu/parallel/multihost.py`.

The reference scales across hosts with broker and worker binaries wired
by addresses (`SUB`, `Local/gol/distributor.go:100-105`). Here every
engine process calls `initialize()` (the same program, another
`GOL_PROC_ID`), which joins one process group; `make_global_mesh` then
lays the shards over every process's devices, each process holding the
shards of its own, and ring neighbours in another process trade halos
point to point (`exchange`, called by `parallel/halo.move`).

Environment (the JAX package's names):

    GOL_COORDINATOR   the group's address host:port (unset: one process)
    GOL_NUM_PROCS     number of engine processes
    GOL_PROC_ID       this process's rank (0-based)

Backends: the group itself is gloo (it carries the device lists and
every CPU halo). `make_global_mesh` picks the halos' backend from the
devices the shards sit on (`halo_backend`): NCCL, in a group of its own,
only when every shard is on a CUDA card, each process on one card and no
card shared by two processes; else gloo. NCCL refuses two ranks on one
card, so processes sharing a card (or holding CPU shards) stay on gloo,
and their CUDA halos are staged through pinned host buffers —
explicitly, and logged once.

The server's `--coordinator` joins the group, but its engine still
shards over its own process's devices only: a served engine does not
span processes, and `ShardedBoard.gather` raises where another process
holds a shard. Meshes across processes serve the `parallel.halo` run
functions called directly (`make_global_mesh`).
"""

from __future__ import annotations

import os
import socket
from typing import Optional, Sequence

import torch

from gol_tpu_torch.obs.log import log as obs_log

_initialized = False
_staged_logged = False


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> bool:
    """Join (or skip joining) the multi-process engine group. Arguments
    fall back to GOL_COORDINATOR / GOL_NUM_PROCS / GOL_PROC_ID. Returns
    True when running multi-process after the call, False when no
    coordinator is configured (one process: a no-op). Safe to call
    twice."""
    global _initialized
    if _initialized:
        return True
    coordinator_address = (coordinator_address
                           or os.environ.get("GOL_COORDINATOR", ""))
    if not coordinator_address:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("GOL_NUM_PROCS", "1"))
    if process_id is None:
        process_id = int(os.environ.get("GOL_PROC_ID", "0"))
    import torch.distributed as dist

    dist.init_process_group("gloo",
                            init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _initialized = True
    return True


def is_multihost() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and \
        dist.get_world_size() > 1


def rank() -> int:
    return torch.distributed.get_rank() if is_multihost() else 0


def _card(dev: torch.device) -> Optional[str]:
    """The physical card a device names, comparable across processes
    (its UUID, else host and index); None for a CPU device."""
    if dev.type != "cuda":
        return None
    uuid = getattr(torch.cuda.get_device_properties(dev), "uuid", None)
    return (str(uuid) if uuid is not None
            else f"{socket.gethostname()}:{dev.index}")


def global_devices(local: Sequence) -> list:
    """[(rank, device, card)] over every process of the group,
    rank-major: each process's `local` devices in its own order, with
    the card each names (`_card`)."""
    local = [torch.device(d) for d in local]
    mine = [(str(d), _card(d)) for d in local]
    if not is_multihost():
        return [(0, torch.device(d), c) for d, c in mine]
    import torch.distributed as dist

    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    return [(r, torch.device(d), c) for r, devs in enumerate(every)
            for d, c in devs]


def halo_backend(placed: Sequence) -> str:
    """The halos' backend for shards placed at `placed` ([(rank, device,
    card)]): 'nccl' when every shard is on a card, each rank on one card
    and no card held by two ranks; else 'gloo'."""
    cards: dict = {}
    for r, _, card in placed:
        if card is None:
            return "gloo"
        cards.setdefault(r, set()).add(card)
    if any(len(c) != 1 for c in cards.values()):
        return "gloo"
    held = [next(iter(c)) for c in cards.values()]
    return "nccl" if len(set(held)) == len(held) else "gloo"


def make_global_mesh(num_shards: Optional[int] = None,
                     local: Optional[Sequence] = None):
    """A 1-D row mesh over the first `num_shards` devices of the whole
    group (`global_devices`), each position owned by its process, its
    halos on `halo_backend`'s choice. Every process calls it (it is
    collective)."""
    import numpy as np

    from gol_tpu_torch.parallel.mesh import (
        ROWS_AXIS,
        Mesh,
        default_devices,
        device_grid,
    )

    placed = global_devices(local if local is not None
                            else default_devices())
    n = num_shards if num_shards is not None else len(placed)
    if n > len(placed):
        raise ValueError(f"asked for {n} shards, the group has "
                         f"{len(placed)} devices")
    placed = placed[:n]
    backend, group = None, None
    if is_multihost():
        backend = halo_backend(placed)
        if backend == "nccl":
            import torch.distributed as dist

            mine = [d for r, d, _ in placed if r == rank()]
            if mine:
                torch.cuda.set_device(mine[0])
            group = dist.new_group(backend="nccl")
        obs_log("multihost.mesh", backend=backend, shards=n,
                ranks=sorted({r for r, _, _ in placed}))
    return Mesh(device_grid([d for _, d, _ in placed], (n,)), (ROWS_AXIS,),
                procs=np.array([r for r, _, _ in placed]), rank=rank(),
                backend=backend, group=group)


def exchange(ops: list, mesh) -> None:
    """Run point-to-point transfers of `mesh`'s halos: ("send", tensor,
    peer, tag) and ("recv", buffer, peer, tag), each tag once per call on
    both sides. On a gloo mesh a CUDA tensor goes through a pinned host
    buffer; an NCCL mesh sends from the card."""
    global _staged_logged
    import torch.distributed as dist

    staged = mesh.backend != "nccl"
    p2p, back = [], []
    for kind, t, peer, tag in ops:
        if staged and t.is_cuda:
            if not _staged_logged:
                obs_log("multihost.staged", backend="gloo",
                        note="CUDA halos staged through pinned host "
                             "buffers")
                _staged_logged = True
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            if kind == "send":
                host.copy_(t)
            else:
                back.append((t, host))
            t = host
        elif kind == "send":
            t = t.contiguous()
        op = dist.isend if kind == "send" else dist.irecv
        p2p.append(dist.P2POp(op, t, peer, group=mesh.group, tag=tag))
    for req in dist.batch_isend_irecv(p2p):
        req.wait()
    for dev_t, host in back:
        dev_t.copy_(host)
