#!/usr/bin/env python3
"""Chip smoke for gol_tpu_torch: the quickest proof that the port builds,
is right and runs its main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. the card (nvidia-smi name and power limit, max SM clock), torch, CUDA;
2. the nvcc build of gol_tpu_torch/csrc/stencil.cu;
3. every kernel against its plain PyTorch version on the card, bit-exact
   (integer boards: tolerance 0), at the main path's shapes and at odd
   ones (one-word boards, heights shorter than a tile window);
4. the main path through `gol_tpu_torch.run` on the default (CUDA)
   engine: 512² x 100 against the golden board and PGM, 512² x 10000 with
   every published (alive, turn) pair against check/alive/512x512.csv,
   5120² x 1000 from a seeded board against the plain version, and an
   unbounded 512² run that 'p' holds and resumes and 'q' ends within 5 s;
   the launch counters of the kernels must have moved;
5. timings at 512², 5120² and 65536²: each kernel's ms per launch beside
   its plain version's and its bound, and engine turns/s.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import queue
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
LOGIC_OPS_PER_CLK_PER_SM = 64  # 32-bit LOP3/shift issue, compute 9.0
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a) -> None:
    print(*a, flush=True)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def seeded_words(torch, h: int, wp: int, seed: int, device):
    """Random packed words made on the device from a seeded generator."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (h, wp), generator=g,
                         dtype=torch.int32, device=device)


def time_ms(torch, fn, reps: int) -> float:
    """Mean device ms per call over `reps` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


class Card:
    def __init__(self, torch) -> None:
        self.smi = nvidia_smi("name,power.limit")
        self.max_sm_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
        self.sms = torch.cuda.get_device_properties(0).multi_processor_count
        self.logic_ops_per_s = (self.sms * LOGIC_OPS_PER_CLK_PER_SM
                                * self.max_sm_mhz * 1e6)

    def bound(self, nbytes: float, ops: float):
        """(ms, 'bytes' | 'operations'): the least time for the work."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / self.logic_ops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")


# Largest |kernel - plain| seen per kernel in phase 3, over the words
# read as uint32 (0 whenever they are bit-exact).
MAX_ABS_ERR: dict = {}


def check_equal(torch, what: str, got, want, kernel: str) -> None:
    torch.cuda.synchronize()
    err = 0
    if not torch.equal(got, want):
        mask = 0xFFFFFFFF
        err = int(((got.long() & mask) - (want.long() & mask)).abs().max())
    MAX_ABS_ERR[kernel] = max(MAX_ABS_ERR.get(kernel, 0), err)
    if err:
        bad = int((got != want).sum())
        raise AssertionError(f"{what}: {bad} words differ")
    log(f"  ok {what}")


def phase_kernels(torch, dev) -> None:
    from gol_tpu_torch.models.lifelike import (
        CONWAY, DAY_AND_NIGHT, HIGHLIFE, SEEDS)
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    log("phase 3: kernels against their plain versions (bit-exact)")
    # K1: the resident whole-board kernel.
    for (h, wp) in [(64, 2), (512, 16), (96, 1), (33, 1)]:
        w = seeded_words(torch, h, wp, h * 7 + wp, dev)
        for turns in (1, 8, 100):
            got = cs.resident_run_turns(w, turns)
            want = cs.resident_run_turns_plain(w, turns)
            check_equal(torch, f"K1 {h}x{wp}w {turns} turns", got, want,
                        "resident_run_turns")
    w = seeded_words(torch, 512, 16, 5, dev)
    for rule in (HIGHLIFE, DAY_AND_NIGHT, SEEDS):
        check_equal(torch, f"K1 512x16w 50 turns {rule.rulestring}",
                    cs.resident_run_turns(w, 50, rule),
                    bitpack.packed_run_turns(w, 50, rule),
                    "resident_run_turns")
    # K2: tiled sweeps, at the main path's shapes and odd ones.
    for (h, wp, turns) in [(5120, 160, 32), (5120, 160, 36),
                           (16384, 512, 32), (16384, 512, 36)]:
        w = seeded_words(torch, h, wp, h + turns, dev)
        got = cs.banded_run_turns(w, turns)
        want = w
        for depth in [cs.TILE_MAX_T] * (turns // 32) + (
                [turns % 32] if turns % 32 else []):
            want = cs.tiled_sweep_plain(want, depth)
        check_equal(torch, f"K2 {h}x{wp}w {turns} turns", got, want,
                    "tiled_sweep")
        check_equal(torch, f"K2 {h}x{wp}w {turns} turns vs whole board",
                    got, bitpack.packed_run_turns(w, turns), "tiled_sweep")
    for (h, wp) in [(1, 1), (3, 1), (7, 5), (385, 63), (1000, 200)]:
        w = seeded_words(torch, h, wp, 11 * h + wp, dev)
        for t, rule in ((1, CONWAY), (7, HIGHLIFE), (32, DAY_AND_NIGHT),
                        (32, SEEDS)):
            out = torch.empty_like(w)
            cs.tiled_sweep(w, out, t, rule)
            check_equal(torch, f"K2 {h}x{wp}w T={t} {rule.rulestring}",
                        out, bitpack.packed_run_turns(w, t, rule),
                        "tiled_sweep")
    w = seeded_words(torch, 65536, 2048, 65536, dev)
    got = cs.banded_run_turns(w, 32)
    check_equal(torch, "K2 65536x2048w 32 turns", got,
                cs.tiled_sweep_plain(w, 32), "tiled_sweep")
    # K3: row popcounts.
    for (h, wp) in [(64, 2), (512, 16), (33, 1), (5120, 160),
                    (16384, 512), (65536, 2048)]:
        w = got if h == 65536 else seeded_words(torch, h, wp, h, dev)
        check_equal(torch, f"K3 {h}x{wp}w", cs.row_popcounts(w),
                    bitpack.row_popcounts_plain(w), "row_popcounts")
    del w, got


def read_csv(path: str) -> dict:
    import csv

    with open(path) as f:
        return {int(r["completed_turns"]): int(r["alive_cells"])
                for r in csv.DictReader(f)}


def drive(p, images_dir: str, out_dir: str, engine=None, poll=None):
    """gol_tpu_torch.run to CLOSE; returns (events, polled pairs)."""
    import gol_tpu_torch
    from gol_tpu_torch import events as ev

    events_q: queue.Queue = queue.Queue()
    t = gol_tpu_torch.run(p, events_q, None, engine=engine,
                          images_dir=images_dir, out_dir=out_dir)
    pairs = set()
    while t.is_alive() and poll is not None:
        pair = poll()
        if pair != (0, 0):  # (0, 0) answers polls before the board loads
            pairs.add(pair)
        time.sleep(0.0002)
    evs = ev.drain(events_q)
    t.join(60)
    if t.exception is not None:
        raise t.exception
    return evs, pairs


def phase_main_path(torch, dev) -> None:
    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import read_pgm, write_pgm
    from gol_tpu_torch.ops import bitpack

    log("phase 4: main path through gol_tpu_torch.run on the card")
    images = os.path.join(REPO, "images")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        evs, _ = drive(Params(image_width=512, image_height=512, turns=100),
                       images, out)
        final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
        gold = os.path.join(REPO, "check", "images", "512x512x100.pgm")
        want = read_pgm(gold)
        ys, xs = np.nonzero(want)
        if set(final.alive) != set(zip(xs.tolist(), ys.tolist())):
            raise AssertionError("512² x 100: alive set != golden")
        with open(os.path.join(out, "512x512x100.pgm"), "rb") as f, \
                open(gold, "rb") as g:
            if f.read() != g.read():
                raise AssertionError("512² x 100: PGM bytes != golden")
        log("  ok 512² x 100: alive set and PGM bytes equal the golden")

        csv_counts = read_csv(os.path.join(REPO, "check", "alive",
                                           "512x512.csv"))
        eng = Engine()
        evs, pairs = drive(
            Params(image_width=512, image_height=512, turns=10000),
            images, out, engine=eng, poll=eng.alive_count)
        final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
        if final.count() != csv_counts[10000]:
            raise AssertionError(f"512² x 10000: {final.count()} alive, "
                                 f"CSV says {csv_counts[10000]}")
        for alive, turn in sorted(pairs, key=lambda x: x[1]):
            if csv_counts[turn] != alive:
                raise AssertionError(f"published pair ({alive}, {turn}) "
                                     f"!= CSV {csv_counts[turn]}")
        log(f"  ok 512² x 10000: final count and {len(pairs)} published "
            f"pairs (turns {sorted(t for _, t in pairs)}) match the CSV")

        size = 5120
        rng = np.random.default_rng(5120)
        board = np.where(rng.random((size, size)) < 0.3, 255, 0).astype(
            np.uint8)
        seed_dir = os.path.join(tmp, "images")
        write_pgm(os.path.join(seed_dir, f"{size}x{size}.pgm"), board)
        drive(Params(image_width=size, image_height=size, turns=1000),
              seed_dir, out)
        got = read_pgm(os.path.join(out, f"{size}x{size}x1000.pgm"))
        plain = bitpack.packed_run_turns(
            bitpack.words_from_numpy(bitpack.pack_np(board), dev), 1000)
        want = bitpack.unpack_np(bitpack.words_to_numpy(plain)) * 255
        if not np.array_equal(got, want):
            raise AssertionError("5120² x 1000: board != plain version")
        log("  ok 5120² x 1000: final board equals the plain version")
        check_controls(images, out)


def check_controls(images: str, out: str) -> None:
    """512², unbounded: 'p' holds the turn still, 'p' again resumes it,
    'q' ends the run within 5 s — the chunk adapter must keep launches
    short on the card too."""
    import gol_tpu_torch
    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch.engine import Engine

    eng = Engine()
    keys: queue.Queue = queue.Queue()
    events_q: queue.Queue = queue.Queue()
    t = gol_tpu_torch.run(
        Params(image_width=512, image_height=512, turns=10**12), events_q,
        keys, engine=eng, images_dir=images, out_dir=out)
    time.sleep(2.0)
    keys.put("p")
    deadline = time.monotonic() + 10
    t1 = -1
    while time.monotonic() < deadline:  # parks at the next chunk boundary
        time.sleep(0.5)
        t2 = eng.ping()
        if t2 == t1:
            break
        t1 = t2
    time.sleep(1.0)
    if eng.ping() != t1:
        raise AssertionError("the turn advanced while paused")
    keys.put("p")
    time.sleep(1.0)
    if eng.ping() <= t1:
        raise AssertionError("the turn did not advance after resume")
    t0 = time.monotonic()
    keys.put("q")
    t.join(30)
    latency = time.monotonic() - t0
    evs = ev.drain(events_q)
    if t.is_alive() or latency >= 5.0:
        raise AssertionError(f"quit took {latency:.2f} s")
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    log(f"  ok controls: pause held turn {t1}, quit after "
        f"{latency:.3f} s at turn {final.completed_turns}")


def engine_rate(torch, world: np.ndarray, seconds: float):
    """(turns/s, median alive_count() µs, max gap s between publications,
    last chunk in turns) of the default engine on `world`, from the pairs
    it publishes."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine import Engine, FLAG_QUIT

    eng = Engine()
    h, w = world.shape
    failed = []

    def target() -> None:
        try:
            eng.server_distributor(
                Params(image_width=w, image_height=h, turns=10**12), world)
        except BaseException as e:  # re-raised on the main thread
            failed.append(e)

    t = threading.Thread(target=target)
    t.start()
    seen, calls = [], []
    t_end = None
    while t.is_alive():
        c0 = time.perf_counter()
        alive, turn = eng.alive_count()
        calls.append(time.perf_counter() - c0)
        now = time.monotonic()
        if not seen or seen[-1][1] != turn:
            seen.append((now, turn))
            if t_end is None and turn > 0:
                t_end = now + seconds
        if t_end is not None and now >= t_end and seen[-1][1] > 0:
            eng.cf_put(FLAG_QUIT)
            break
        time.sleep(0.0005)
    t.join()
    if failed:
        raise failed[0]
    chunk = eng.stats()["chunk"]
    steady = [s for s in seen if s[1] > 0]
    steady = steady[len(steady) // 4:] if len(steady) >= 8 else steady
    rate = ((steady[-1][1] - steady[0][1]) / (steady[-1][0] - steady[0][0])
            if len(steady) >= 2 and steady[-1][0] > steady[0][0] else 0.0)
    gaps = [b[0] - a[0] for a, b in zip(steady, steady[1:])]
    return (rate, statistics.median(calls) * 1e6, max(gaps, default=0.0),
            chunk)


def phase_timing(torch, dev, card: Card, launches: dict) -> list:
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    log(f"phase 5: timings on {card.smi}")
    ops = cs.OPS_PER_WORD_TURN
    k1_turns = 1024
    rows = {"resident_run_turns": [], "tiled_sweep": [],
            "row_popcounts": []}
    for (h, wp) in [(512, 16), (64, 2)]:
        w = seeded_words(torch, h, wp, 1, dev)
        ms = time_ms(torch, lambda: cs.resident_run_turns(w, k1_turns), 5)
        plain = time_ms(torch, lambda: cs.resident_run_turns_plain(
            w, k1_turns), 1)
        b, by = card.bound(8 * h * wp, ops * k1_turns * h * wp)
        rows["resident_run_turns"].append(dict(
            shape=f"{h}x{wp * 32}", turns=k1_turns, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by))
    for (h, wp) in [(65536, 2048), (16384, 512), (5120, 160), (512, 16)]:
        w = seeded_words(torch, h, wp, 2, dev)
        o = torch.empty_like(w)
        if h > 512:  # 512² is K1's board on the main path
            ms = time_ms(torch, lambda: cs.tiled_sweep(w, o, 32), 5)
            plain = time_ms(torch, lambda: cs.tiled_sweep_plain(w, 32), 1)
            b, by = card.bound(8 * h * wp, ops * 32 * h * wp)
            rows["tiled_sweep"].append(dict(
                shape=f"{h}x{wp * 32}", turns=32, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by))
        ms = time_ms(torch, lambda: cs.row_popcounts(w), 20)
        plain = time_ms(torch, lambda: bitpack.row_popcounts_plain(w), 3)
        # One __popc per word; it issues at 16 per clock per SM, a
        # quarter of the logic rate `Card` counts in.
        b, by = card.bound(4 * h * wp + 4 * h, 4 * h * wp)
        rows["row_popcounts"].append(dict(
            shape=f"{h}x{wp * 32}", turns=0, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by))
        del w, o
    for name, rs in rows.items():
        for r in rs:
            log(f"  {name} {r['shape']} turns={r['turns']}: {r['ms']:.4f} "
                f"ms/launch, plain {r['plain_ms']:.4f} ms, bound "
                f"{r['bound_ms']:.4f} ms ({r['bound_by']})")

    engine = []
    for size, seconds in ((512, 3.0), (5120, 3.0), (65536, 6.0)):
        words = seeded_words(torch, size, size // 32, 3, dev)
        world = bitpack.unpack_np(bitpack.words_to_numpy(words))
        del words
        world *= 255
        rate, poll_us, gap, chunk = engine_rate(torch, world, seconds)
        del world
        engine.append(dict(size=size, card=card.smi, turns_per_s=rate,
                           cell_updates_per_s=rate * size * size,
                           alive_count_us=poll_us, max_publish_gap_s=gap,
                           chunk_turns=chunk))
        log(f"  engine {size}²: {rate:.1f} turns/s "
            f"({rate * size * size:.4g} cell updates/s), alive_count() "
            f"{poll_us:.2f} µs median, publications at most {gap:.3f} s "
            f"apart, chunk {chunk} turns")
    log("engine:" + json.dumps(engine))

    meta = {
        "resident_run_turns": ("gol_tpu/ops/pallas_stencil.py:508",
                               "512x512"),
        "tiled_sweep": ("gol_tpu/ops/pallas_stencil.py:388", "65536x65536"),
        "row_popcounts": ("gol_tpu/engine.py:158", "65536x65536"),
    }
    kernels = []
    for name, rs in rows.items():
        head = [r for r in rs if r["shape"] == meta[name][1]][0]
        kernels.append(dict(
            name=name, route="cuda",
            source="gol_tpu_torch/csrc/stencil.cu",
            replaces=meta[name][0], launches=launches[name],
            bit_exact=MAX_ABS_ERR[name] == 0,
            max_abs_err=MAX_ABS_ERR[name], card=card.smi,
            shape=head["shape"],
            turns=head["turns"], ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, by_shape=rs))
    return kernels


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from gol_tpu_torch.ops import _build, cuda_stencil as cs

    t_start = time.monotonic()
    dev = torch.device("cuda", 0)
    card = Card(torch)
    log(card.smi)
    log(f"phase 1: torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{card.sms} SMs, max SM clock {card.max_sm_mhz:.0f} MHz, "
        f"{cs.cuda_probe()}")
    log("phase 2: building the kernels with nvcc")
    _build.library()
    rec = _build.build_record()
    log(f"  built {rec['path']} in {rec['seconds']:.1f} s"
        f"{' (cached)' if rec['cached'] else ''}")
    for line in rec["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas: " + line.strip())
    phase_kernels(torch, dev)
    cs.reset_launch_counts()
    phase_main_path(torch, dev)
    launches = {fn.__name__: fn.launches for fn in cs.KERNELS}
    log(f"  main path launches: {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"main path never launched {name}")
    kernels = phase_timing(torch, dev, card, launches)
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
