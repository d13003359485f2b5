"""Brian's Brain ('/2/3') on the PyTorch port: the Generations family on
the packed bit-plane kernels. Run:

    python examples/torch_brians_brain.py [turns] [--device cpu]

This drives `GenerationsTorus` directly, on the CUDA card unless
`--device` names another; the family also rides the whole interactive
stack (ticker, pause, snapshot, detach, checkpoints):

    python -m gol_tpu_torch -w 512 -h 512 --rule /2/3 --headless --turns 100
    python -m gol_tpu_torch.server --rule /2/3   # remote engine
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from a bare clone

import argparse
import time

import numpy as np

from gol_tpu_torch.models.generations import BRIANS_BRAIN, GenerationsTorus


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("turns", nargs="?", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    turns = args.turns
    rng = np.random.default_rng(0)
    board = rng.integers(0, 3, size=(1024, 1024)).astype(np.uint8)
    # Warm the path that will be timed (on a card the first call builds
    # the kernel library), then time a fresh board.
    GenerationsTorus(board, BRIANS_BRAIN, device=args.device).run(turns)
    gt = GenerationsTorus(board, BRIANS_BRAIN, device=args.device)
    t0 = time.perf_counter()
    gt.run(turns)
    firing = gt.alive_count()
    dt = time.perf_counter() - t0
    print(f"{turns} turns of 1024² Brian's Brain in {dt:.2f}s "
          f"({turns / dt:.0f} turns/s); {firing} cells firing "
          f"({'packed bit-plane' if gt._packed else 'uint8'} kernel)")


if __name__ == "__main__":
    main()
