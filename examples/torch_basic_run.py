"""Minimal API usage of the PyTorch port: evolve a board in-process and
read the event stream. Run:

    python examples/torch_basic_run.py [rulestring] [--device cpu]

It runs on the CUDA card unless `--device` names another. The same lines
drive a remote engine instead when SER=host:port is set (start one with
`python -m gol_tpu_torch.server`)."""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from a bare clone

import argparse
import queue

from gol_tpu_torch import Params, events as ev, run
from gol_tpu_torch.models.lifelike import LifeLikeRule


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("rule", nargs="?", help="life-like rulestring")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    rule = LifeLikeRule(args.rule) if args.rule else None
    p = Params(threads=8, image_width=64, image_height=64, turns=100)
    q = queue.Queue()
    # images/64x64.pgm -> out/64x64x100.pgm
    t = run(p, q, None, rule=rule, device=args.device)
    t.join()
    if t.exception is not None:
        raise t.exception
    for e in ev.drain(q):
        if isinstance(e, (ev.AliveCellsCount, ev.FinalTurnComplete,
                          ev.ImageOutputComplete)):
            print(f"turn {e.completed_turns:>4}: {e}" if str(e)
                  else f"turn {e.completed_turns:>4}: final "
                       f"({len(e.alive)} alive)")


if __name__ == "__main__":
    main()
