"""A Gosper glider gun firing on a 2^20 x 2^20 torus with the PyTorch
port (2^40 cells, never materialised: only the live window is). Run:

    python examples/torch_sparse_gun.py [turns] [--device cpu]

This drives `SparseTorus` directly, on the CUDA card unless `--device`
names another; sparse runs also ride the whole control protocol (ticker,
pause, windowed snapshots, detach, checkpoints):

    python -m gol_tpu_torch -w 1048576 -h 1048576 --sparse --rle gosper-gun --headless
    python -m gol_tpu_torch.server --sparse 1048576   # remote sparse engine
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from a bare clone

import argparse
import time

from gol_tpu_torch.models.patterns import pattern_cells
from gol_tpu_torch.models.sparse import SparseTorus


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("turns", nargs="?", type=int, default=3000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    turns = args.turns
    size = 2**20
    sp = SparseTorus(size, pattern_cells("gosper-gun",
                                         at=(size // 2, size // 2)),
                     device=args.device)
    t0 = time.perf_counter()
    sp.run(turns)
    dt = time.perf_counter() - t0
    h, w = sp.window_shape()
    gliders = (sp.alive_count() - 36) // 5  # exact at period-30 phases
    print(f"{turns} turns in {dt:.2f}s ({turns / dt:.0f} turns/s); "
          f"{sp.alive_count()} alive (~{gliders} gliders in flight), "
          f"live window {h}x{w} of {size}x{size}")


if __name__ == "__main__":
    main()
