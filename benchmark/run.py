#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration, traffic and metrics are the entries of
`BENCHMARK.json` at the checkout's root, found by name (`yardstick/
registry.py`). The last line of standard output is the result, one JSON
object; the last lines of standard error are the numbers compared, each
beside its limit. With `--trace 0` the metrics are the cell's end-to-end
ones; with `--trace 1` its per-layer ones, read from a `torch.profiler`
trace of the window. The run exits non-zero, with no result, without
CUDA or enough cards, or when JAX or the JAX package was loaded.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [HERE, ROOT]
    from yardstick import guard, registry

    bench = registry.load_benchmark(ROOT)
    chips = registry.workload(bench, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"the cell asks for {chips} CUDA device(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    print(f"setup torch_and_cuda {time.monotonic() - T_START:.3f} s",
          file=sys.stderr)
    from yardstick.cell import run_cell

    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    found = guard.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for k, v in checks.items.items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
