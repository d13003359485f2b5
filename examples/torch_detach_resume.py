"""The detach/reattach story on the PyTorch port in one script: start an
engine server, run "forever", detach with 'q', then a SECOND controller
session reattaches with CONT=yes and finishes the job. Run:

    python examples/torch_detach_resume.py [--device cpu]

The server's engine runs on the CUDA card unless `--device` names
another.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # runnable from a bare clone

import argparse
import queue
import time

from gol_tpu_torch import Params, events as ev, run
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.server import EngineServer


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    os.environ["GOL_SERVER_EXIT_ON_KILL"] = "0"
    srv = EngineServer(port=0, host="127.0.0.1",
                       engine=Engine(device=args.device))
    srv.start_background()
    os.environ["SER"] = f"127.0.0.1:{srv.port}"

    # Controller 1: run "forever", detach after a few seconds.
    p1 = Params(threads=8, image_width=64, image_height=64, turns=10**8)
    q1, keys1 = queue.Queue(), queue.Queue()
    t1 = run(p1, q1, keys1)
    time.sleep(4.0)
    keys1.put("q")
    t1.join(60)
    fin1 = [e for e in ev.drain(q1)
            if isinstance(e, ev.FinalTurnComplete)][0]
    print(f"controller 1 detached at turn {fin1.completed_turns}; "
          f"engine keeps the board")

    # Controller 2: reattach and run 1000 more turns.
    os.environ["CONT"] = "yes"
    p2 = Params(threads=8, image_width=64, image_height=64,
                turns=fin1.completed_turns + 1000)
    q2 = queue.Queue()
    run(p2, q2, None).join(120)
    fin2 = [e for e in ev.drain(q2)
            if isinstance(e, ev.FinalTurnComplete)][0]
    print(f"controller 2 resumed and finished at turn "
          f"{fin2.completed_turns} ({len(fin2.alive)} alive)")
    os.environ.pop("CONT", None)
    os.environ.pop("SER", None)
    srv.shutdown()


if __name__ == "__main__":
    main()
