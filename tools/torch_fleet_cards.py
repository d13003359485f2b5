#!/usr/bin/env python3
"""Fleet mesh placement over distinct CUDA cards: the check of
`gol_tpu_torch.fleet`'s batch and spatial placements across devices
(cross-card count gathers and halo copies), which meshes of one card
cannot show.

    python3 tools/torch_fleet_cards.py [--cards N]

Over the first N cards (default 4):
  * a batch bucket (64 slots of 512², one block a card) and a spatial
    bucket (8 slots of 2048², a quarter of each slot's rows a card) hold
    words and per-slot counts equal to a one-card bucket fed the same
    seeds after every quantum (odd, even and fused quanta);
  * a free-running `FleetEngine(devices=cards)` of each placement: its
    run b0 equals its replay, and its cell updates/s stand beside the
    one-card fleet's.
Tolerance: none. Prints the cards' `nvidia-smi` name and power limit, a
line a case, and exits non-zero on any difference, or with fewer cards.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

QUANTA = ((8, 1), (8, 1), (5, 1), (8, 2), (3, 1))


def bucket_pairs(torch, cards):
    """(what, one-card bucket, bucket over the cards), seeded alike."""
    from chip_smoke import fleet_seed
    from gol_tpu_torch.fleet.buckets import Bucket
    from gol_tpu_torch.fleet.handles import RunHandle
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.parallel.mesh import make_batch_mesh, make_mesh

    n = len(cards)
    for placement, runs, size, mesh in (
            ("batch", 64, 512, make_batch_mesh(cards)),
            ("spatial", 8, 2048, make_mesh(n, devices=cards))):
        one = Bucket(size, size, CONWAY, slot_base=runs, device=cards[0])
        many = Bucket(size, size, CONWAY, slot_base=runs,
                      placement=placement, mesh=mesh)
        for i in range(runs):
            seed = fleet_seed(size, 50_000 + i)
            one.place(RunHandle(f"b{i}", CONWAY, size, size), seed)
            many.place(RunHandle(f"b{i}", CONWAY, size, size), seed)
        yield f"{placement} {runs} x {size}² over {n} cards", one, many


def check_buckets(torch, cards) -> None:
    for what, one, many in bucket_pairs(torch, cards):
        devs = sorted({str(p.device) for p in many.parts})
        if len(devs) != len(cards):
            raise AssertionError(f"{what}: parts on {devs}")
        for q, (turns, fuse) in enumerate(QUANTA):
            a1 = one.dispatch(turns, fuse=fuse)
            an = many.dispatch(turns, fuse=fuse)
            if not torch.equal(an, a1):
                raise AssertionError(f"{what}: counts differ at quantum {q}")
            if not torch.equal(many.words, one.words):
                raise AssertionError(f"{what}: words differ at quantum {q}")
        print(f"ok {what}: words and counts equal the one-card bucket "
              f"after each of {len(QUANTA)} quanta (parts on {devs})",
              flush=True)


def free_running(torch, devices, runs: int, size: int, env: dict) -> tuple:
    """(cell updates/s, placement) of `runs` free-running size² runs in a
    FleetEngine over `devices`; run b0 against its replay."""
    import time

    import numpy as np

    from chip_smoke import fleet_seed
    from gol_tpu_torch.fleet import FleetEngine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import bitpack
    from gol_tpu_torch.parallel.halo import packed_run_turns

    os.environ.update(env)
    try:
        eng = FleetEngine(devices=devices, bucket_sizes=(size,),
                          slot_base=8 if env else runs)
        try:
            for i in range(runs):
                eng.create_run(size, size, board=fleet_seed(size, 60_000 + i),
                               run_id=f"b{i}", wait=False)
            while eng.runs_summary()["resident"] < runs:
                time.sleep(0.02)
            time.sleep(0.5)
            c0 = eng.throughput_counters()
            t0 = time.perf_counter()
            time.sleep(1.5)
            c1 = eng.throughput_counters()
            rate = (c1["cell_updates"] - c0["cell_updates"]) / (
                time.perf_counter() - t0)
            placement = eng.stats()["fleet"]["buckets"][0]["placement"]
            board, turn = eng.resolve_run("b0").get_world()
        finally:
            eng.kill_prog()
    finally:
        for k in env:
            os.environ.pop(k, None)
    words = bitpack.words_from_numpy(bitpack.pack_np(
        fleet_seed(size, 60_000)), devices[0])
    want = bitpack.unpack_np(bitpack.words_to_numpy(
        packed_run_turns(words, turn, CONWAY))) * np.uint8(255)
    if not np.array_equal(board, want):
        raise AssertionError(f"{runs} x {size}² on {len(devices)} cards: b0 "
                             f"at turn {turn} != its replay")
    return rate, placement


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    args = ap.parse_args()
    import torch

    if torch.cuda.device_count() < args.cards:
        print(f"torch_fleet_cards: needs {args.cards} CUDA cards",
              file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(smi, flush=True)
    sys.path.insert(0, ROOT)
    from gol_tpu_torch.ops import _build

    _build.library()
    cards = [torch.device("cuda", i) for i in range(args.cards)]
    check_buckets(torch, cards)
    for runs, size, env in ((64, 512, {}),
                            (4, 2048, {"GOL_FLEET_MIN_SLOTS_PER_DEV": "4"})):
        one, _ = free_running(torch, cards[:1], runs, size, {})
        many, placement = free_running(torch, cards, runs, size, env)
        print(f"ok fleet {runs} free-running {size}² over {len(cards)} cards "
              f"({placement}): b0 equals its replay; {many:.1f} cell "
              f"updates/s beside {one:.1f} on one card "
              f"({smi.splitlines()[0]})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
