#!/usr/bin/env python3
"""Two processes, one CUDA card each, over one row mesh: the check of
`gol_tpu_torch.parallel.multihost`'s NCCL halos, which one card cannot
show (processes sharing a card stay on gloo).

    python3 tools/torch_multihost_cards.py [--out DIR]

Starts two `tests/torch_multihost_worker.py` processes in `cuda` mode
(rank r holds four of eight row shards on card r, and the mesh's halos
must ride NCCL), then runs every case of the worker in this process on
one-process meshes of cuda:0 and of the CPU, and holds the two ranks'
shards and counts against them. Tolerance: none. Prints the cards'
`nvidia-smi` name and power limit, one line a case, and exits non-zero
on any difference, or with fewer than two cards.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import socket
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="directory for the ranks' shards and logs "
                         "(default: a temporary one)")
    args = ap.parse_args()
    import numpy as np
    import torch

    if torch.cuda.device_count() < 2:
        print("torch_multihost_cards: needs two CUDA cards",
              file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip(), flush=True)
    sys.path.insert(0, ROOT)
    from gol_tpu_torch.ops import _build
    from gol_tpu_torch.parallel.mesh import make_mesh

    _build.library()  # built once, before the ranks load it
    out = args.out or tempfile.mkdtemp(prefix="multihost-cards-")
    os.makedirs(out, exist_ok=True)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=ROOT)
    for k in ("GOL_COORDINATOR", "GOL_NUM_PROCS", "GOL_PROC_ID"):
        env.pop(k, None)
    procs = [subprocess.Popen(
        [sys.executable, "-u", WORKER, str(port), str(r), out, "cuda"],
        env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(f"rank {r} exit {p.returncode}:\n{log[-3000:]}", flush=True)
    if any(p.returncode for p in procs):
        return 1
    spec = importlib.util.spec_from_file_location("worker", WORKER)
    worker = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(worker)
    saved = {}
    for r in (0, 1):
        with np.load(os.path.join(out, f"proc{r}.npz")) as z:
            saved.update({k: z[k] for k in z.files})
    ok = True
    for dev in (torch.device("cuda", 0), torch.device("cpu")):
        mesh = make_mesh(8, [dev] * 8)
        for name in worker.CASES:
            got = np.concatenate([saved[f"{name}_{p}"] for p in range(8)],
                                 axis=-2)
            one, counts = worker.run_case(name, mesh, worker.boards(name))
            same = np.array_equal(got, one.gather().cpu().numpy())
            line = f"{dev.type} {name}: equal={same}"
            if counts is not None:
                two = sum(int(saved[f"{name}_count_{p}"][0])
                          for p in range(8))
                single = sum(int(c) for c in counts)
                line += f", count {two} against {single}"
                same = same and two == single
            ok = ok and same
            print(line, flush=True)
    print("MULTIHOST_CARDS", "OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
