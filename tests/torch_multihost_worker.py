"""Worker process of `tests/test_torch_multihost.py`: joins a two-process
group through `gol_tpu_torch.parallel.multihost.initialize` (the
GOL_COORDINATOR contract), lays an 8-shard row mesh over both
processes' four devices each, runs every sharded path on it and saves
the shards this process holds to `<out>/proc<rank>.npz`, keyed
`<path>_<position>`. Imports no jax and nothing of `gol_tpu`.

    python tests/torch_multihost_worker.py PORT RANK OUT [cpu|cuda]

`cpu` (the default) shards over CPU devices and its halos ride gloo;
`cuda` puts rank r's four shards on card r, one card a process, and its
halos ride NCCL (two cards needed).
"""

import os
import sys

import numpy as np
import torch

CASES = {
    # name: (height, width, turns, repr)
    "packed": (64, 64, 33, "packed"),
    "deep": (64, 64, 32, "packed"),
    "u8": (64, 40, 5, "u8"),
    "gen8": (64, 40, 5, "gen8"),
    "gen3": (64, 64, 5, "gen3"),
    "exact": (60, 64, 5, "packed"),
}


def boards(name: str):
    """The seeded input of a case: {0,1} cells, or Generations states."""
    h, w, _, repr_ = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    if repr_ in ("gen8", "gen3"):
        return rng.integers(0, 3, size=(h, w)).astype(np.uint8)
    return (rng.random((h, w)) < 0.3).astype(np.uint8)


def run_case(name: str, mesh, board: np.ndarray):
    """Run one case on `mesh`; returns (ShardedBoard, counts or None)."""
    from gol_tpu_torch.models.generations import (
        BRIANS_BRAIN,
        pack_state3,
    )
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops.bitpack import pack_np, words_from_numpy
    from gol_tpu_torch.parallel import halo
    from gol_tpu_torch.parallel.mesh import shard

    h, _, turns, repr_ = CASES[name]
    counts = [torch.zeros(1, dtype=torch.int64, device=mesh.devices.flat[p])
              if mesh.local(p) else None for p in range(mesh.size)]
    if repr_ == "packed":
        ext = halo.exact_shard_ext(h, mesh.size)
        if ext:
            words = words_from_numpy(halo.extend_rows(pack_np(board), ext))
            out = halo.extended_run_turns(
                shard(words, mesh), turns, mesh, CONWAY,
                height=h, ext=ext, packed=True, count=counts)
        else:
            out = halo.sharded_packed_run_turns(
                shard(words_from_numpy(pack_np(board)), mesh),
                turns, mesh, CONWAY, count=counts)
        return out, counts
    if repr_ == "u8":
        return halo.sharded_run_turns(
            shard(torch.from_numpy(board), mesh), turns, mesh,
            CONWAY), None
    if repr_ == "gen8":
        return halo.sharded_generations_run_turns(
            shard(torch.from_numpy(board), mesh), turns, mesh,
            BRIANS_BRAIN), None
    return halo.sharded_gen3_run_turns(
        shard(pack_state3(board), mesh), turns, mesh,
        BRIANS_BRAIN, count=counts), counts


def main() -> None:
    port, rank, out_dir = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    kind = sys.argv[4] if len(sys.argv) > 4 else "cpu"
    os.environ["GOL_COORDINATOR"] = f"127.0.0.1:{port}"
    os.environ["GOL_NUM_PROCS"] = "2"
    os.environ["GOL_PROC_ID"] = str(rank)
    torch.set_num_threads(1)

    from gol_tpu_torch.parallel import multihost

    assert multihost.initialize(), "initialize() stayed single-process"
    assert multihost.is_multihost()
    dev = torch.device("cpu") if kind == "cpu" else torch.device("cuda",
                                                                  rank)
    mesh = multihost.make_global_mesh(8, [dev] * 4)
    assert mesh.backend == ("gloo" if kind == "cpu" else "nccl"), \
        mesh.backend
    assert [int(p) for p in mesh.procs] == [0] * 4 + [1] * 4
    saved = {}
    for name in CASES:
        out, counts = run_case(name, mesh, boards(name))
        for pos, shard in enumerate(out.shards):
            if shard is not None:
                saved[f"{name}_{pos}"] = shard.cpu().numpy()
                if counts is not None:
                    saved[f"{name}_count_{pos}"] = counts[pos].cpu().numpy()
    np.savez(os.path.join(out_dir, f"proc{rank}.npz"), **saved)
    torch.distributed.destroy_process_group()
    print(f"TORCH_MULTIHOST_OK proc {rank} ({len(saved)} arrays)",
          flush=True)


if __name__ == "__main__":
    main()
