#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds in one process: the
program's (no fault), and the control's or a planted fault's
(`yardstick/faults.py`), each at the cell's own size and load.

    python3 benchmark/control.py --workload life-512.ticker \
        --seeds 11,12,13 --seconds 3 [--fault control] [--out FILE]

Prints one JSON line a seed: its fault, `correct` and the numbers
compared. The benchmark's own runs never plant a fault; this is how the
limits' two readings are taken (PERF.md).
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--fault", default="")
    ap.add_argument("--device", default=None,
                    help="cpu to run without a card (rehearsal)")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    from yardstick import faults, registry
    from yardstick.cell import run_cell

    bench = registry.load_benchmark(ROOT)
    cfg = registry.config(bench, registry.workload(
        bench, args.workload)["config"])
    ref = registry.reference(cfg["reference"])
    lines = []
    for seed in (int(s) for s in args.seeds.split(",")):
        plant = (faults.planted(args.fault, ref, cfg["rule"]) if args.fault
                 else contextlib.nullcontext())
        t0 = time.monotonic()
        with plant as handle:
            result, checks = run_cell(
                args.workload, seed, args.seconds, False, t_start=t0,
                device=args.device, on_warm=handle and handle.trip)
        line = {"workload": args.workload, "seed": seed,
                "fault": args.fault or None, "correct": result["correct"],
                "checks": {k: v["value"] for k, v in checks.items.items()},
                "metrics": {k: v["value"]
                            for k, v in result["metrics"].items()},
                "device": result["device"], "wall_s": time.monotonic() - t0}
        print(json.dumps(line), flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
