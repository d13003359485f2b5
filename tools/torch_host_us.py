#!/usr/bin/env python3
"""Host time a call of two gol_tpu_torch hot calls on one CUDA card, for
one checkout of the package: K9 (`fleet_run_turns`, the fleet's
quantum, 8 turns) at 1, 8 and 64 slots of 512² and 8 slots of 1024² and
2048², and the engine's chunk with its alive token (`Engine._chunk`,
512² x 1 turn and 5120² x 32).

    python3 tools/torch_host_us.py [--root DIR] [--calls N] [--repeats R]

`--root` names the checkout whose `gol_tpu_torch` is timed (default:
the one holding this script), so that two checkouts are compared on one
card in one process tree: run the parent, the change, the change and
the parent in turn. Each checkout builds its own kernels under its own
`build/`. For each call it prints the host µs a call (no synchronisation
between calls, after a warm-up; the median and the least of `--repeats`
batches of `--calls` calls, since a shared host's load moves single
batches by tens of µs) and the CUDA-event ms a call, as one JSON line
with the card's `nvidia-smi` name and power limit. Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time


def host_us(torch, fn, calls: int, repeats: int) -> dict:
    """The median and least host µs a call over `repeats` batches."""
    fn()
    torch.cuda.synchronize()
    batches = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        batches.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return {"median": statistics.median(batches), "least": min(batches)}


def event_ms(torch, fn, calls: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--calls", type=int, default=100)
    ap.add_argument("--repeats", type=int, default=9)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_host_us: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import cuda_stencil as cs
    from gol_tpu_torch.parallel.halo import packed_run_turns

    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    rows = []
    for cap, h, wp in ((1, 512, 16), (8, 512, 16), (64, 512, 16),
                       (8, 1024, 32), (8, 2048, 64)):
        words = torch.randint(-2**31, 2**31 - 1, (cap, h, wp), generator=gen,
                              dtype=torch.int32, device=dev)

        def quantum():
            return cs.fleet_run_turns(words, 8, CONWAY)

        rows.append(dict(call="fleet_run_turns", slots=cap,
                         shape=f"{h}x{wp * 32}", turns=8,
                         route=cs.fleet_run_kind(words.shape),
                         host_us=host_us(torch, quantum, args.calls,
                                         args.repeats),
                         event_ms=event_ms(torch, quantum, args.calls)))
    eng = Engine(device=dev)
    eng._repr = "packed"
    for size, turns in ((512, 1), (5120, 32)):
        words = torch.randint(-2**31, 2**31 - 1, (size, size // 32),
                              generator=gen, dtype=torch.int32, device=dev)

        def chunk():
            return eng._chunk(packed_run_turns, words, turns)

        rows.append(dict(call="Engine._chunk", shape=f"{size}x{size}",
                         turns=turns,
                         host_us=host_us(torch, chunk, args.calls,
                                         args.repeats),
                         event_ms=event_ms(torch, chunk, args.calls)))
    print(json.dumps({"root": root, "card": card,
                      "torch": torch.__version__, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
