#!/usr/bin/env python3
"""Chip smoke for gol_tpu_torch: the quickest proof that the port builds,
is right and runs its main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. the card (nvidia-smi name and power limit, max SM clock), torch, CUDA;
2. the nvcc build of gol_tpu_torch/csrc/stencil.cu: ptxas registers and
   stack frames (every kernel's must be 0 bytes), and the stepping loop
   of each stepping kernel's SASS (K1, K2, K4, K5, K6; `cuobjdump
   -sass`: its instructions, in all, by opcode and per word);
3. every kernel against its plain PyTorch version on the card, bit-exact
   (integer boards: tolerance 0), at the main path's shapes and at odd
   ones (one-word boards, heights shorter than a tile window): K1 at
   every cluster size N = 1..16 on 512² and 64² (and at the policy's N
   and N = min(16, h) on one-word and short boards), K2 at every tile
   height R on 5120² and odd boards and at the policy's R up to 65536²;
   K6 at depths 33, 48 and 64 up to 16384², and at 64 on 65536², its
   timed head row, and B3's sweep sequence; the two-plane kernels for
   both Generations families (gen3, gen4) and two rules each: K4 at every
   N = 1..16 on 512², 64², 96 x 1 and 33 x 1, K5 at every tile height R
   on 1024², 4096², 16384² and odd boards; K7 (the Moore-box
   Larger-than-Life turn), route 2 at the policy's tile and route 1
   where its gate admits the shape, on 64², 512², 4096², 1000 x 777 and
   16² at r = 1, 2, 5, 8, 16, 32, 128 (and 16² at r = 10: the box wraps
   the torus more than once), route 1 on 1024² at r = 5, 64, 128, route
   2 at every tile and route 1 on 1000 x 777, route 1 at every cluster
   size that fits on 512² and 64² for 1, 2 and 33 turns in one launch,
   and both on a nearly full 300² board at r = 128 (counts past
   65,535); K8 (the sparse window's
   occupancy) on random words with bit 31 set and on two-word windows,
   at the window ladder's 256 x 64, 768 x 64, 10,240 x 384 and 38,656 x
   1,280 words and an odd 1000 x 77;
4. the main path through `gol_tpu_torch.run` on the default (CUDA)
   engine: the 16², 64² and 512² goldens x {0, 1, 100} against
   check/images (16² is the uint8 roll-sum path, its width not a
   multiple of 32), 512² x 10000 with every published (alive, turn) pair
   against check/alive/512x512.csv, 5120² x 1000 from a seeded board
   against the plain version; then an unbounded 512² run that 'p' holds
   and resumes and 'q' ends within 5 s;
   4b. the Generations path: Brian's Brain through `run` at 512² x 100
   (K4) and 4096² x 1000 (K5), Star Wars through `run` at 512² x 100
   (gen8: plain torch ops), with their rate and largest gap between
   published turns, and Star Wars through `GenerationsTorus` at 512² x 64
   (K4) and 4096² x 64 (K5), each against the uint8 gen8 plain path on
   the card;
   4c. the fused path: GOL_FUSE_K=64 at 8192² x 1024 and GOL_FUSE_K=16 at
   5120² x 1000 through `run`, each against the unfused run's board (the
   unfused references run first, before the counters restart at 0);
   4d. the control plane: `run` with SER set drives an in-process
   `EngineServer` on a CUDA engine through the goldens, the 512² ticker
   against the CSV and 5120² x 1000 against the in-process run's PGM,
   and a second server (rule /2/3) through Brian's Brain 512² x 100
   against the gen8 plain path.
   4f. the conv families: Bosco (`R5,C0,M1,S33..57,B34..45,NM`) through
   `run` at 512² x 100 (K7 route 1, one launch a chunk by the counter
   against the engine's chunks) and 4096² x 100 (route 2) against the
   plain path; then, off the main
   path, the FFT tier's counts at 4096² for r = 8, 16, 32 against
   `box_counts_np`, and the JAX bench's two Lenia legs (Orbium 1024² on
   the FFT tier, r = 4 512² on the conv tier; 8 turns from seed 42)
   within 1e-4 of the float64 oracle, whose digests are the pinned ones.
   4g. the sparse torus: the R-pentomino on the 2^20 torus for 8192
   turns (the JAX bench's leg) through `SparseTorus` (K1, K2, K8)
   against a dense 32768² run of the packed path (K2, run before the
   phase's counters and profile), then through `run(..., sparse=True)`,
   the CLI (`--sparse --rle rpentomino`, its final checkpoint read) and
   SER to a `python -m gol_tpu_torch.server --sparse` subprocess (its
   GetWindow pixels and origin against the in-process engine's), each to
   the same torus cells; 65,536 turns through `SparseEngine`, every
   publication from turn 1103 on counting 116; a `checkpoint_now` of it
   restored into a fresh engine and 1,024 more turns on both to equal
   cells; with turns/s, the final windows, episodes and grows.
   Each path runs with the launch counters at 0, read just after: every
   kernel (and family) it runs must have launched. The paths of 4-4c, 4f
   and 4g run under `torch.profiler`, which sums their device time by
   kernel (each path's and in all), all but the unbounded run: it steps
   as long as the wall clock says, so its device time would rank
   nothing. Then the control plane's numbers
   (Alivecount round trips; GetWorld at 5120² and 65536² under the
   packed and u8 codecs, byte for byte against the served board; GetView
   at 65536²; engine turns/s at 5120² through SER beside the in-process
   rate) and its recovery through a real process split: a
   `python -m gol_tpu_torch.server` subprocess is SIGKILLed mid-run and
   restarted on its port, and the controller reattaches and ends on the
   in-process run's PGM;
   4e. checkpoints: through `run` with GOL_CKPT_EVERY_TURNS and
   GOL_JOURNAL, 512² x 10000, 5120² x 1000 at GOL_FUSE_K=16, Brian's
   Brain 4096² x 1000 and Star Wars 512² x 100, each quit mid-way and
   resumed with `--resume`, ending on the PGM of its uninterrupted run,
   every manifest holding the plain path's board at its turn and every
   journal verifying (the resumed 512² run's pairs against the CSV); a
   `python -m gol_tpu_torch.server --checkpoint` subprocess SIGTERMed
   mid-run and restarted with `--resume`, the controller ending on the
   in-process PGM; then `checkpoint_now` and restore seconds at 512²,
   5120² and 65536², and engine turns/s at 5120² with a 65,536-turn
   checkpoint cadence beside the rate without, on one warm engine;
5. timings at 64², 128², 256², 512², 4096², 5120², 8192², 16384²,
   65536² and 131072²: each kernel's ms per launch beside its plain version's
   and its bound (K1 at N = 1, 2, 4, 8, 16 on 512², 256² and 64², K2 at
   every R on 5120², 8192², 16384² and 65536², K4 at every N on 64² to
   512², K5 at every R on 4096² and 16384²), B3 `fused_banded_run_turns`
   at pinned depths 16, 32 and 64, and engine turns/s and the largest
   publication gap (life-like, unfused and at GOL_FUSE_K=64 at 65536²,
   Brian's Brain at 512² and 4096², Star Wars at 512²); K3 under
   `torch.profiler` at 512², 5120² and 65536² (device ms a launch beside
   the wrapper's host µs a call and CUDA events around the calls); K7's
   route 2 at 4096² for r = 1, 2, 4, 5, 8, 16, 32, 64, 128 at every tile,
   beside its plain version, its byte bound, the library call (F.conv2d
   of the wrap-padded float32 board with a ones kernel, TF32 off) and
   the FFT tier's turn; route 1 at 512² and 1024² (one launch of 1000
   turns) for r = 1, 5, 16, 32, 64, 128 and at 64² (one CTA) for r = 1,
   5, beside route 2 at every tile and,
   at 512² r = 5, F.conv2d; K7 at the gate's route against the FFT tier
   at 512² and 1024² up to r = 128 (the box crossover); the direct tier
   of a circular neighbourhood (F.conv2d, TF32 off) against the FFT tier
   at 512², 1024² and 4096² (the other kinds' crossover); engine turns/s
   for Bosco at 512² and 4096² and Orbium at 1024²; and K8 at the window
   ladder's shapes and on the 65,536-turn run's final window, beside its
   plain version and its byte bound.

The line before the last is the kernels' JSON record; the last line is
`{"ok": true, "device": {...}}`. Without a CUDA device, or without the
package beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
import queue
import re
import shutil
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


def seeded_planes(torch, h: int, wp: int, family: str, seed: int, device):
    """Random stacked (2, h, wp) planes holding valid states: for gen3
    no cell is both alive and dying; every pair is a gen4 state."""
    p = torch.stack([seeded_words(torch, h, wp, seed, device),
                     seeded_words(torch, h, wp, seed + 1, device)])
    if family == "gen3":
        p[1] &= ~p[0]
    return p


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


# K1's rows per thread timed (and checked) beside the policy's at 512².
RESIDENT_PER_TIMED = (1, 3, 5, 9)

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


def stack_frames(ptxas_log: str) -> dict:
    """{kernel: stack frame bytes} from `nvcc -Xptxas -v` output."""
    frames, name = {}, None
    for line in ptxas_log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and name:
            frames[demangle([name])[0]] = int(m.group(1))
            name = None
    return frames


def demangle(names: list) -> list:
    """Names through the toolkit's cu++filt where it has one."""
    from gol_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cu++filt")
    if not os.access(tool, os.X_OK):
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    got = out.stdout.splitlines()
    return got if len(got) == len(names) else names


SASS_COUNTED = ("LOP3", "SHF", "LDS", "LD", "STS", "ST", "IADD3", "IMAD",
                "LEA", "ISETP", "SEL", "BRA")


def step_loops(lib: str) -> dict:
    """{kernel: loop} for the stepping kernels (K1, K2, K4, K5, K6) of a
    built library, from `cuobjdump -sass`. A loop is the span of a
    backward branch; of the innermost ones (no other inside), the stepping
    loop is the one with the most LOP3. Its instructions are counted in
    all and per opcode (LDS and STS are shared-memory loads and stores, LD
    and ST generic ones), and per word: a word is one store in each plane
    (two for the two-plane kernels, whose names carry Gen3, Gen4 or 2p)."""
    from gol_tpu_torch.ops import _build

    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    text = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            funcs[name] = []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name:
            ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(2))
            funcs[name].append((int(m.group(1), 16), ins))
    out = {}
    for name, demangled in zip(funcs, demangle(list(funcs))):
        if (not re.search(r"(resident|tiled)\w*_kernel", name)
                or "ltl_" in name):
            continue
        ins = funcs[name]
        spans = set()
        for addr, op in ins:
            t = re.match(r"BRA\S*\s+.*?0x([0-9a-f]+)", op)
            if t and int(t.group(1), 16) <= addr:
                spans.add((int(t.group(1), 16), addr))
        loops = []
        for lo, hi in spans:
            if any(o != (lo, hi) and lo <= o[0] and o[1] <= hi
                   for o in spans):
                continue
            body = [op.split()[0].split(".")[0] for addr, op in ins
                    if lo <= addr <= hi]
            loops.append(dict(instructions=len(body),
                              **{op: body.count(op) for op in SASS_COUNTED}))
        short = demangled.split("(")[0] if ">(" not in demangled else (
            demangled[:demangled.index(">(") + 1])
        for noise in ("void ", "(anonymous namespace)::", "<unnamed>::"):
            short = short.replace(noise, "")
        loop = max(loops, key=lambda loop: loop["LOP3"])
        planes = 2 if re.search(r"Gen[34]|2p", short) else 1
        words = (loop["STS"] + loop["ST"]) / planes
        loop["per_word"] = loop["instructions"] / words if words else None
        out[short] = loop
    return out


def phase_kernels(torch, dev) -> None:
    from gol_tpu_torch.models.lifelike import (
        CONWAY, DAY_AND_NIGHT, HIGHLIFE, SEEDS)
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    log("phase 3: kernels against their plain versions (bit-exact)")
    # K1: the cluster kernel at every cluster size N on 512² and 64²,
    # and on one-word, short and odd boards at the policy's N and at
    # N = min(16, h) (slabs of 1-3 rows).
    rules = (HIGHLIFE, DAY_AND_NIGHT, SEEDS)
    for (h, wp) in [(512, 16), (64, 2)]:
        w = seeded_words(torch, h, wp, h * 7 + wp, dev)
        for n in range(1, cs.RESIDENT_MAX_CTAS + 1):
            for turns in (1, 8, 100):
                check_equal(torch, f"K1 {h}x{wp}w N={n} {turns} turns",
                            cs.resident_run_turns(w, turns, ctas=n),
                            cs.resident_run_turns_plain(w, turns, ctas=n),
                            "resident_run_turns")
            for rule in rules:
                check_equal(torch, f"K1 {h}x{wp}w N={n} 50 turns "
                            f"{rule.rulestring}",
                            cs.resident_run_turns(w, 50, rule, ctas=n),
                            bitpack.packed_run_turns(w, 50, rule),
                            "resident_run_turns")
    w = seeded_words(torch, 512, 16, 5, dev)
    for per in RESIDENT_PER_TIMED:
        check_equal(torch, f"K1 512x16w N=16 per={per} 100 turns",
                    cs.resident_run_turns(w, 100, ctas=16, per=per),
                    bitpack.packed_run_turns(w, 100), "resident_run_turns")
    for (h, wp) in [(96, 1), (33, 1), (37, 3), (16, 4)]:
        w = seeded_words(torch, h, wp, h * 7 + wp, dev)
        for n in sorted({cs.resident_cluster_ctas(h, wp), min(16, h)}):
            for turns in (1, 8, 100):
                check_equal(torch, f"K1 {h}x{wp}w N={n} {turns} turns",
                            cs.resident_run_turns(w, turns, ctas=n),
                            cs.resident_run_turns_plain(w, turns, ctas=n),
                            "resident_run_turns")
    # K2: tiled sweeps at every tile height R on 5120², at the policy's R
    # on the main path's other shapes, and at every R on odd boards.
    for (h, wp) in [(5120, 160), (8192, 256), (16384, 512)]:
        rows = (cs.TILE_ROW_CHOICES if h == 5120
                else (cs.tile_rows(h, wp),))
        for turns in (32, 36):
            w = seeded_words(torch, h, wp, h + turns, dev)
            whole = bitpack.packed_run_turns(w, turns)
            for r in rows:
                got, want = w, w
                for depth in cs.sweep_depths(turns, cs.TILE_MAX_T):
                    out = torch.empty_like(w)
                    cs.tiled_sweep(got, out, depth, rows=r)
                    got = out
                    want = cs.tiled_sweep_plain(want, depth, rows=r)
                check_equal(torch, f"K2 {h}x{wp}w R={r} {turns} turns",
                            got, want, "tiled_sweep")
                check_equal(torch, f"K2 {h}x{wp}w R={r} {turns} turns vs "
                            "whole board", got, whole, "tiled_sweep")
        got = cs.banded_run_turns(w, 36)
        check_equal(torch, f"K2 {h}x{wp}w banded_run_turns 36 turns", got,
                    whole, "tiled_sweep")
    for (h, wp) in [(1, 1), (3, 1), (7, 5), (385, 63), (1000, 200)]:
        w = seeded_words(torch, h, wp, 11 * h + wp, dev)
        for t, rule in ((1, CONWAY), (7, HIGHLIFE), (32, DAY_AND_NIGHT),
                        (32, SEEDS)):
            want = bitpack.packed_run_turns(w, t, rule)
            for r in cs.TILE_ROW_CHOICES:
                out = torch.empty_like(w)
                cs.tiled_sweep(w, out, t, rule, rows=r)
                check_equal(torch, f"K2 {h}x{wp}w R={r} T={t} "
                            f"{rule.rulestring}", out, want, "tiled_sweep")
    w = seeded_words(torch, 65536, 2048, 65536, dev)
    got = cs.banded_run_turns(w, 32)
    check_equal(torch, f"K2 65536x2048w R={cs.tile_rows(65536, 2048)} 32 "
                "turns", got, cs.tiled_sweep_plain(w, 32), "tiled_sweep")
    phase_kernels_deep(torch, dev)
    phase_kernels_2p(torch, dev)
    # K3: row popcounts.
    for (h, wp) in [(64, 2), (512, 16), (33, 1), (5120, 160),
                    (16384, 512), (65536, 2048)]:
        w = got if h == 65536 else seeded_words(torch, h, wp, h, dev)
        check_equal(torch, f"K3 {h}x{wp}w", cs.row_popcounts(w),
                    bitpack.row_popcounts_plain(w), "row_popcounts")
    del w, got


def phase_kernels_deep(torch, dev) -> None:
    """K6 at depths 33..64 against its plain version and the whole-board
    scan at the fused path's shapes and on short and odd boards, and B3's
    sweep sequence."""
    from gol_tpu_torch.models.lifelike import CONWAY, HIGHLIFE, SEEDS
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    for (h, wp) in [(64, 128), (5120, 160), (8192, 256), (16384, 512)]:
        w = seeded_words(torch, h, wp, 3 * h + wp, dev)
        for t in (33, 48, 64):
            out = torch.empty_like(w)
            cs.tiled_sweep_deep(w, out, t)
            check_equal(torch, f"K6 {h}x{wp}w T={t}", out,
                        cs.tiled_sweep_deep_plain(w, t), "tiled_sweep_deep")
            check_equal(torch, f"K6 {h}x{wp}w T={t} vs whole board", out,
                        bitpack.packed_run_turns(w, t), "tiled_sweep_deep")
    for (h, wp) in [(1, 1), (3, 1), (7, 5), (321, 61), (1000, 200)]:
        w = seeded_words(torch, h, wp, 13 * h + wp, dev)
        for t, rule in ((1, CONWAY), (33, HIGHLIFE), (64, SEEDS)):
            out = torch.empty_like(w)
            cs.tiled_sweep_deep(w, out, t, rule)
            check_equal(torch, f"K6 {h}x{wp}w T={t} {rule.rulestring}",
                        out, bitpack.packed_run_turns(w, t, rule),
                        "tiled_sweep_deep")
    # 65536² at depth 64: the engine's GOL_FUSE_K=64 run in phase 5 and
    # the head row of the `kernels` line.
    w = seeded_words(torch, 65536, 2048, 64, dev)
    out = torch.empty_like(w)
    cs.tiled_sweep_deep(w, out, 64)
    check_equal(torch, "K6 65536x2048w T=64", out,
                cs.tiled_sweep_deep_plain(w, 64), "tiled_sweep_deep")
    del out
    torch.cuda.empty_cache()
    w = seeded_words(torch, 5120, 160, 7, dev)
    for k in (16, 48, 64):
        want = w
        for depth in cs.sweep_depths(2 * k + 5, k):
            plain = (cs.tiled_sweep_plain if depth <= cs.TILE_MAX_T
                     else cs.tiled_sweep_deep_plain)
            want = plain(want, depth)
        check_equal(torch, f"B3 5120x160w k={k} {2 * k + 5} turns",
                    cs.fused_banded_run_turns(w, 2 * k + 5, k), want,
                    "tiled_sweep_deep" if k > cs.TILE_MAX_T
                    else "tiled_sweep")
    del w, want


def phase_kernels_2p(torch, dev) -> None:
    """K4 and K5 for both families and two rules each against their plain
    versions: K4 at every cluster size N = 1..16 on 512², 64² and one-word
    boards (slabs of 1-3 rows at N = 16 on 33 x 1), and at other rows per
    thread on 512²; K5 at every tile height R on 1024², 4096² and 16384²
    (a sweep at 32 and one at 4), on odd boards, and against the
    whole-board plain version."""
    from gol_tpu_torch.models.generations import GenerationsRule
    from gol_tpu_torch.ops import cuda_stencil as cs

    rules = {"gen3": [GenerationsRule("/2/3"), GenerationsRule("125/36/3")],
             "gen4": [GenerationsRule("345/2/4"), GenerationsRule("/234/4")]}
    for fam, (rule, other) in rules.items():
        k4 = f"resident_run_turns2p/{fam}"
        for (h, wp) in [(512, 16), (64, 2), (96, 1), (33, 1)]:
            p = seeded_planes(torch, h, wp, fam, h * 3 + wp, dev)
            for n in range(1, cs.RESIDENT_MAX_CTAS + 1):
                for turns in (1, 8, 19, 100):
                    check_equal(
                        torch, f"K4 {fam} {h}x{wp}w N={n} {turns} turns",
                        cs.resident_run_turns2p(p, turns, rule, fam, ctas=n),
                        cs.resident_run_turns2p_plain(p, turns, rule, fam,
                                                      ctas=n), k4)
                check_equal(
                    torch, f"K4 {fam} {h}x{wp}w N={n} 50 turns "
                    f"{other.rulestring}",
                    cs.resident_run_turns2p(p, 50, other, fam, ctas=n),
                    cs.resident_run_turns2p_plain(p, 50, other, fam,
                                                  ctas=1), k4)
        p = seeded_planes(torch, 512, 16, fam, 9, dev)
        for per in RESIDENT_PER_TIMED:
            check_equal(torch, f"K4 {fam} 512x16w N=16 per={per} 100 turns",
                        cs.resident_run_turns2p(p, 100, rule, fam, ctas=16,
                                                per=per),
                        cs.resident_run_turns2p_plain(p, 100, rule, fam,
                                                      ctas=1), k4)
        k5 = f"tiled_sweep2p/{fam}"
        for (h, wp, turns) in [(1024, 32, 36), (4096, 128, 32),
                               (4096, 128, 36), (16384, 512, 32),
                               (16384, 512, 36)]:
            p = seeded_planes(torch, h, wp, fam, h + turns, dev)
            whole = cs.resident_run_turns2p_plain(p, turns, rule, fam,
                                                  ctas=1)
            for r in cs.TILE2P_ROW_CHOICES:
                got, want = p, p
                for depth in cs.sweep_depths(turns, cs.TILE_MAX_T):
                    out = torch.empty_like(p)
                    cs.tiled_sweep2p(got, out, depth, rule, fam, rows=r)
                    got = out
                    want = cs.tiled_sweep2p_plain(want, depth, rule, fam,
                                                  rows=r)
                check_equal(torch, f"K5 {fam} {h}x{wp}w R={r} {turns} turns",
                            got, want, k5)
                check_equal(torch, f"K5 {fam} {h}x{wp}w R={r} {turns} turns "
                            "vs whole board", got, whole, k5)
            check_equal(torch, f"K5 {fam} {h}x{wp}w banded_run_turns2p "
                        f"{turns} turns (R={cs.tile2p_rows(h, wp)})",
                        cs.banded_run_turns2p(p, turns, rule, fam), whole, k5)
        for (h, wp, t) in [(1, 1, 1), (3, 7, 32), (100, 200, 7),
                           (162, 63, 32), (97, 65, 32)]:
            p = seeded_planes(torch, h, wp, fam, 5 * h + wp, dev)
            for r in (rule, other):
                want = cs.resident_run_turns2p_plain(p, t, r, fam, ctas=1)
                for rows in cs.TILE2P_ROW_CHOICES:
                    out = torch.empty_like(p)
                    cs.tiled_sweep2p(p, out, t, r, fam, rows=rows)
                    check_equal(torch, f"K5 {fam} {h}x{wp}w R={rows} T={t} "
                                f"{r.rulestring}", out, want, k5)
        del p, out, want, whole, got


def read_csv(path: str) -> dict:
    import csv

    with open(path) as f:
        return {int(r["completed_turns"]): int(r["alive_cells"])
                for r in csv.DictReader(f)}


def drive(p, images_dir: str, out_dir: str, engine=None, poll=None,
          sparse: bool = False):
    """gol_tpu_torch.run to CLOSE; returns (events, polled pairs)."""
    import gol_tpu_torch
    from gol_tpu_torch import events as ev

    events_q: queue.Queue = queue.Queue()
    t = gol_tpu_torch.run(p, events_q, None, engine=engine,
                          images_dir=images_dir, out_dir=out_dir,
                          sparse=sparse)
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


GOLDENS = ((16, 0), (16, 1), (16, 100), (64, 0), (64, 1), (64, 100),
           (512, 0), (512, 1), (512, 100))


def check_golden(images: str, out: str, size: int, turns: int,
                 where: str) -> None:
    """One `check/images` golden through `gol_tpu_torch.run`: the final
    alive set and the PGM's bytes."""
    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch.io.pgm import read_pgm

    evs, _ = drive(Params(image_width=size, image_height=size, turns=turns),
                   images, out)
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    name = f"{size}x{size}x{turns}.pgm"
    gold = os.path.join(REPO, "check", "images", name)
    ys, xs = np.nonzero(read_pgm(gold))
    if (final.completed_turns != turns
            or set(final.alive) != set(zip(xs.tolist(), ys.tolist()))):
        raise AssertionError(f"{where} {size}² x {turns}: alive set != "
                             "golden")
    with open(os.path.join(out, name), "rb") as f, open(gold, "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{where} {size}² x {turns}: PGM bytes != "
                                 "golden")


def check_ticker(images: str, out: str, poll, engine=None) -> None:
    """512² x 10000: the final count and every (alive, turn) pair `poll`
    saw published, against check/alive/512x512.csv."""
    from gol_tpu_torch import Params, events as ev

    csv_counts = read_csv(os.path.join(REPO, "check", "alive",
                                       "512x512.csv"))
    evs, pairs = drive(Params(image_width=512, image_height=512,
                              turns=10000), images, out, engine=engine,
                       poll=poll)
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


def seeded_board(size: int, seed: int) -> np.ndarray:
    """A {0,255} board with 30% alive, from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    return np.where(rng.random((size, size)) < 0.3, 255, 0).astype(np.uint8)


def phase_main_path(torch, dev) -> None:
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import read_pgm, write_pgm
    from gol_tpu_torch.ops import bitpack

    log("phase 4: main path through gol_tpu_torch.run on the card")
    images = os.path.join(REPO, "images")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        # 16² runs the uint8 roll-sum path (its width is not a multiple
        # of 32), 64² K1 at N = 1, 512² K1 on a cluster.
        for size, turns in GOLDENS:
            check_golden(images, out, size, turns, "run")
        log(f"  ok goldens {', '.join(f'{s}² x {t}' for s, t in GOLDENS)}: "
            "alive sets and PGM bytes equal check/images")

        eng = Engine()
        check_ticker(images, out, eng.alive_count, engine=eng)

        size = 5120
        board = seeded_board(size, 5120)
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


def phase_controls(torch, dev) -> None:
    """The main path's keys on the card (`check_controls`)."""
    log("phase 4: pause, resume and quit on an unbounded 512² run")
    with tempfile.TemporaryDirectory() as tmp:
        check_controls(os.path.join(REPO, "images"), os.path.join(tmp, "out"))


def phase_fused(torch, dev) -> None:
    """Temporal fusion through `gol_tpu_torch.run`: GOL_FUSE_K=64 at
    8192² x 1024 (K6 sweeps, K2 for shallower chunks) and GOL_FUSE_K=16 at
    5120² x 1000 (K2 at depth 16), each against the unfused run's board.
    The unfused references run first; the launch counters restart at 0
    just before the fused runs, so the phase's counts are theirs alone."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.io.pgm import read_pgm, write_pgm
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 4c: fused path (GOL_FUSE_K) through gol_tpu_torch.run")
    cases = ((8192, 1024, 64), (5120, 1000, 16))
    with tempfile.TemporaryDirectory() as tmp:
        seed_dir = os.path.join(tmp, "images")

        def run_at(size: int, turns: int, fuse):
            """The final board of one run, and the launches it made."""
            if fuse is not None:
                os.environ["GOL_FUSE_K"] = str(fuse)
            before = main_path_launches(cs)
            out = os.path.join(tmp, f"out_{size}_{fuse}")
            try:
                drive(Params(image_width=size, image_height=size,
                             turns=turns), seed_dir, out)
            finally:
                os.environ.pop("GOL_FUSE_K", None)
            after = main_path_launches(cs)
            return (read_pgm(os.path.join(out, f"{size}x{size}x{turns}.pgm")),
                    {n: after[n] - before[n] for n in after
                     if after[n] != before[n]})

        for size, _, k in cases:
            rng = np.random.default_rng(size + k)
            board = np.where(rng.random((size, size)) < 0.3, 255,
                             0).astype(np.uint8)
            write_pgm(os.path.join(seed_dir, f"{size}x{size}.pgm"), board)
            del board
        os.environ.pop("GOL_FUSE_K", None)
        refs = {size: run_at(size, turns, None) for size, turns, _ in cases}
        cs.reset_launch_counts()
        for size, turns, k in cases:
            board, fused = run_at(size, turns, k)
            ref, unfused = refs[size]
            if not np.array_equal(board, ref):
                raise AssertionError(f"{size}² x {turns} GOL_FUSE_K={k}: "
                                     "board != the unfused run's")
            deep = fused.get("tiled_sweep_deep", 0)
            if (deep > 0) != (k > cs.TILE_MAX_T) or not fused.get(
                    "tiled_sweep", 0):
                raise AssertionError(f"GOL_FUSE_K={k} launched {fused}")
            log(f"  ok {size}² x {turns} GOL_FUSE_K={k}: board equals the "
                f"unfused run's; launches {fused}, unfused {unfused}")


@contextlib.contextmanager
def served(engine):
    """An in-process `EngineServer` on `engine` (so the launch counters
    see its kernels), with SER naming it for the controller."""
    from gol_tpu_torch.server import EngineServer

    srv = EngineServer(port=0, host="127.0.0.1", engine=engine)
    srv.start_background()
    os.environ["SER"] = f"127.0.0.1:{srv.port}"
    try:
        yield srv
    finally:
        os.environ.pop("SER", None)
        srv.shutdown()


def phase_control_plane(torch, dev) -> None:
    """The main path through the control plane: `gol_tpu_torch.run` with
    SER set drives an in-process `EngineServer` on a CUDA engine. The
    goldens, the 512² ticker against the CSV and 5120² x 1000 against
    the in-process run's PGM (run first, before the counters restart at
    0); then Brian's Brain 512² x 100 on a second server (rule /2/3)
    against the gen8 plain path."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import read_pgm, write_pgm
    from gol_tpu_torch.models.generations import (
        BRIANS_BRAIN, from_pixels_gen, gray_levels, to_pixels_gen)
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 4d: control plane: gol_tpu_torch.run through SER to an "
        "EngineServer on the card")
    images = os.path.join(REPO, "images")
    with tempfile.TemporaryDirectory() as tmp:
        out, ref_out = os.path.join(tmp, "out"), os.path.join(tmp, "ref")
        seed_dir = os.path.join(tmp, "images")
        write_pgm(os.path.join(seed_dir, "5120x5120.pgm"),
                  seeded_board(5120, 5120))
        p5120 = Params(image_width=5120, image_height=5120, turns=1000)
        drive(p5120, seed_dir, ref_out, engine=Engine())
        cs.reset_launch_counts()
        with served(Engine()) as srv:
            for size, turns in GOLDENS:
                check_golden(images, out, size, turns, "SER")
            log(f"  ok goldens through SER "
                f"({', '.join(f'{s}² x {t}' for s, t in GOLDENS)}): "
                "alive sets and PGM bytes equal check/images")
            check_ticker(images, out,
                         RemoteEngine(f"127.0.0.1:{srv.port}").alive_count)
            drive(p5120, seed_dir, out)
            name = "5120x5120x1000.pgm"
            with open(os.path.join(out, name), "rb") as f, \
                    open(os.path.join(ref_out, name), "rb") as g:
                if f.read() != g.read():
                    raise AssertionError("5120² x 1000 through SER: PGM "
                                         "!= the in-process run's")
            log("  ok 5120² x 1000 through SER: PGM bytes equal the "
                "in-process run's")
        levels = tuple(gray_levels(BRIANS_BRAIN).tolist())
        with served(Engine(rule=BRIANS_BRAIN)):
            drive(Params(image_width=512, image_height=512, turns=100),
                  images, out)
        start = from_pixels_gen(read_pgm(os.path.join(images, "512x512.pgm"),
                                         levels=levels), BRIANS_BRAIN)
        want = gen8_plain(torch, dev, start, 100, BRIANS_BRAIN)
        got = read_pgm(os.path.join(out, "512x512x100.pgm"), levels=levels)
        if not np.array_equal(got, to_pixels_gen(want, BRIANS_BRAIN)):
            raise AssertionError("/2/3 512² x 100 through SER: PGM != gen8")
        log("  ok /2/3 512² x 100 through SER on a /2/3 server: gray PGM "
            "equals the gen8 plain path")


def fetch_world(port: int, caps: list):
    """(reply header, payload bytes, seconds) of one raw GetWorld that
    advertises `caps`: the server's encode and the transfer, no decode."""
    import socket

    from gol_tpu_torch import wire

    t0 = time.perf_counter()
    s = socket.create_connection(("127.0.0.1", port), timeout=600)
    try:
        wire.send_msg(s, {"method": "GetWorld", "caps": caps})
        header, _ = wire.recv_head_raw(s)
        buf = bytearray(wire.payload_nbytes(header))
        view, got = memoryview(buf), 0
        while got < len(buf):
            n = s.recv_into(view[got:])
            if not n:
                raise ConnectionError("server closed mid-payload")
            got += n
    finally:
        s.close()
    return header, buf, time.perf_counter() - t0


def check_world_bytes(srv, size: int, reps: int) -> list:
    """GetWorld of the served engine's board under caps {packed} and {}:
    the payload is exactly the byte packing (LSB-first, width padded to
    words) of get_world()'s pixels, and exactly the u8 pixels. Returns
    one row of timings per codec (median of `reps` fetches)."""
    want_px, turn = srv.engine.get_world()
    rows = []
    for caps, codec in ((["packed"], "packed"), ([], "u8")):
        want = (np.packbits(want_px != 0, axis=1, bitorder="little")
                if codec == "packed" else want_px).reshape(-1)
        times = []
        for _ in range(reps):
            header, buf, sec = fetch_world(srv.port, caps)
            if (header["world"]["codec"] != codec or header["turn"] != turn
                    or not np.array_equal(np.frombuffer(buf, np.uint8),
                                          want)):
                raise AssertionError(f"GetWorld {size}² {caps}: "
                                     f"{header['world']} != {codec} bytes")
            times.append(sec)
            del buf
        sec = statistics.median(times)
        rows.append(dict(size=size, codec=codec, bytes=want.nbytes,
                         ms=sec * 1e3, mb_per_s=want.nbytes / sec / 1e6))
        log(f"  ok GetWorld {size}² under {caps or '{}'}: {codec} payload "
            f"equals the expected {want.nbytes} bytes; {sec * 1e3:.2f} ms, "
            f"{want.nbytes / sec / 1e6:.1f} MB/s (median of {reps})")
    return rows


def spawn_server(port: int, *args: str, env=None):
    """(process, port) of `python -m gol_tpu_torch.server` on the card
    (with more `args`, and `env` over this process's), once its banner
    names the port it serves on."""
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    env.pop("SER", None)
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "gol_tpu_torch.server", "--port",
         str(port), "--host", "127.0.0.1", *args], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    found: queue.Queue = queue.Queue()

    def scan():
        for line in proc.stdout:
            m = re.search(r"serving on :(\d+)", line)
            if m:
                found.put(int(m.group(1)))
        found.put(None)

    threading.Thread(target=scan, daemon=True).start()
    try:
        got = found.get(timeout=120)
    except queue.Empty:
        got = None
    if got is None:
        stop_server(proc)
        raise AssertionError(f"server subprocess gave no banner "
                             f"(exit {proc.poll()})")
    return proc, got


def stop_server(proc) -> None:
    if proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(30)


def round_trips_us(call, n: int) -> dict:
    """Median and p99 µs of `n` calls of `call`."""
    times = []
    for _ in range(n):
        c0 = time.perf_counter()
        call()
        times.append(time.perf_counter() - c0)
    times.sort()
    return dict(median=statistics.median(times) * 1e6,
                p99=times[int(n * 0.99)] * 1e6, n=n)


def rpc_floor_us(n: int) -> dict:
    """The transport floor of one request a connection: round trips of a
    bare server that answers each framed request on a thread of its own
    (what `EngineServer` does before any dispatch work)."""
    import socket

    from gol_tpu_torch import wire

    lsock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(16)

    def answer(conn) -> None:
        with conn:
            wire.recv_msg(conn)
            wire.send_msg(conn, {"ok": True, "alive": 0, "turn": 0})

    def accept() -> None:
        while True:
            try:
                conn, _ = lsock.accept()
            except OSError:
                return
            threading.Thread(target=answer, args=(conn,), daemon=True).start()

    threading.Thread(target=accept, daemon=True).start()

    def call() -> None:
        with socket.create_connection(lsock.getsockname(), timeout=10) as s:
            wire.send_msg(s, {"method": "Alivecount"})
            wire.recv_msg(s)

    try:
        return round_trips_us(call, n)
    finally:
        lsock.close()


def check_recovery(images: str, tmp: str) -> dict:
    """A controller on SER against `python -m gol_tpu_torch.server` in a
    subprocess on the card: about one second into a 512² run of a few
    seconds the server is SIGKILLed and a new one starts on the same
    port. The controller must emit EngineLost then EngineReattached (at
    turn 0: the new server holds no board, so the controller resubmits
    its last-known one) and end on the in-process run's PGM."""
    import signal

    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.distributor import distributor
    from gol_tpu_torch.engine import Engine

    turns = 4_000_000
    p = Params(image_width=512, image_height=512, turns=turns)

    procs = []
    t0 = time.monotonic()
    try:
        proc, port = spawn_server(0)
        procs.append(proc)
        os.environ["SER"] = f"127.0.0.1:{port}"
        os.environ["GOL_RECONNECT"] = "180"
        os.environ["GOL_HB_INTERVAL"] = "0.5"
        q: queue.Queue = queue.Queue()
        failed, seen = [], []

        def control():
            try:
                distributor(p, q, None, images_dir=images,
                            out_dir=os.path.join(tmp, "rec"))
            except BaseException as e:
                failed.append(e)

        def collect():
            while True:
                e = q.get()
                if e is ev.CLOSE:
                    return
                seen.append((time.monotonic(), e))

        threading.Thread(target=collect, daemon=True).start()

        ctrl = threading.Thread(target=control)
        ctrl.start()
        probe = RemoteEngine(f"127.0.0.1:{port}")
        deadline = time.monotonic() + 120
        while probe.ping() == 0:
            if time.monotonic() > deadline:
                raise AssertionError("the served run never started")
            time.sleep(0.01)
        time.sleep(1.0)
        killed_at = probe.ping()
        t_kill = time.monotonic()
        os.kill(proc.pid, signal.SIGKILL)
        proc.wait(30)
        proc2, port2 = spawn_server(port)
        procs.append(proc2)
        if port2 != port:
            raise AssertionError(f"restarted on :{port2}, not :{port}")
        ctrl.join(600)
        if ctrl.is_alive() or failed:
            raise AssertionError(f"controller did not finish: {failed}")
    finally:
        os.environ.pop("SER", None)
        os.environ.pop("GOL_RECONNECT", None)
        os.environ.pop("GOL_HB_INTERVAL", None)
        for proc in procs:
            stop_server(proc)
    wall = time.monotonic() - t0
    deadline = time.monotonic() + 10
    while not any(isinstance(e, ev.StateChange)
                  and e.new_state == ev.State.QUITTING for _, e in seen):
        if time.monotonic() > deadline:
            raise AssertionError("the recovered run sent no QUITTING")
        time.sleep(0.01)
    evs = [e for _, e in seen]
    after = {type(e).__name__: t - t_kill for t, e in seen
             if isinstance(e, (ev.EngineLost, ev.EngineReattached))}
    kinds = [type(e).__name__ for e in evs]
    if (kinds.count("EngineLost") != 1
            or kinds.count("EngineReattached") != 1
            or kinds.index("EngineLost") > kinds.index("EngineReattached")):
        raise AssertionError(f"recovery events: {kinds}")
    reatt = [e for e in evs if isinstance(e, ev.EngineReattached)][0]
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    if reatt.completed_turns != 0 or final.completed_turns != turns:
        raise AssertionError(f"reattached at {reatt.completed_turns}, "
                             f"ended at {final.completed_turns}")
    drive(p, images, os.path.join(tmp, "ref"), engine=Engine())
    name = f"512x512x{turns}.pgm"
    with open(os.path.join(tmp, "rec", name), "rb") as f, \
            open(os.path.join(tmp, "ref", name), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("recovered run's PGM != in-process run's")
    log(f"  ok recovery: server SIGKILLed at turn {killed_at} of {turns} "
        f"(512²), restarted on :{port}; EngineLost "
        f"{after['EngineLost']:.3f} s and EngineReattached (at turn 0) "
        f"{after['EngineReattached']:.3f} s after the kill, final PGM "
        f"equals the in-process run's; {wall:.1f} s from the first spawn "
        "to the end of the run")
    return dict(killed_at_turn=killed_at, turns=turns, wall_s=wall,
                lost_after_s=after["EngineLost"],
                reattached_after_s=after["EngineReattached"])


def phase_control_plane_measure(torch, dev, card: Card) -> dict:
    """The control plane's numbers on the card, and its recovery through
    a real process split. Against a `python -m gol_tpu_torch.server`
    subprocess: engine turns/s at 5120² through SER beside the
    in-process rate (in-process, SER, SER, in-process, twice), and
    Alivecount round trips while it idles and while it runs. Against an
    in-process server (whose engine the check reads): GetWorld bytes and
    times at 5120² and 65536² under packed and u8, GetView at 65536², and
    Alivecount round trips sharing one interpreter. The RPC floor of a
    bare thread-a-connection server. Then `check_recovery`."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.distributor import LIVE_MAX_CELLS_DEFAULT
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.ops import bitpack

    log(f"phase 4d: control-plane measurements on {card.smi}")
    res = {"card": card.smi, "alivecount_us": {}}
    board = seeded_board(5120, 5120)
    proc, port = spawn_server(0)
    try:
        res["alivecount_us"]["subprocess_idle"] = round_trips_us(
            RemoteEngine(f"127.0.0.1:{port}").alive_count, 2000)
        # One in-process engine, like the one the server holds: the first
        # run of each ramps its chunk from 1 turn, later ones start at
        # the converged chunk.
        held = Engine()
        rates = {"in_process": [], "ser": []}
        busy = []
        for where in ("in_process", "ser", "ser", "in_process") * 2:
            eng = (held if where == "in_process"
                   else RemoteEngine(f"127.0.0.1:{port}"))
            rate, poll_us, _, chunk = engine_rate(torch, board, 3.0, eng=eng)
            rates[where].append(rate)
            if where == "ser":
                busy.append(poll_us)
            log(f"  engine 5120² {where}: {rate:.1f} turns/s, chunk "
                f"{chunk} turns, alive_count() {poll_us:.1f} µs median")
        del held
        res["turns_per_s_5120"] = rates
        res["alivecount_us"]["subprocess_running_5120"] = busy
    finally:
        stop_server(proc)
    with served(Engine()) as srv:
        remote = RemoteEngine(f"127.0.0.1:{srv.port}")
        res["alivecount_us"]["in_process_idle"] = round_trips_us(
            remote.alive_count, 2000)
        res["alivecount_us"]["rpc_floor"] = rpc_floor_us(2000)
        for name, r in res["alivecount_us"].items():
            if name != "subprocess_running_5120":
                log(f"  Alivecount round trip, {name}: median "
                    f"{r['median']:.1f} µs, p99 {r['p99']:.1f} µs over "
                    f"{r['n']} calls")
        srv.engine.server_distributor(
            Params(image_width=5120, image_height=5120, turns=100), board)
        res["get_world"] = check_world_bytes(srv, 5120, 3)
        words = seeded_words(torch, 65536, 2048, 65536, dev)
        world = bitpack.unpack_np(bitpack.words_to_numpy(words))
        del words
        world *= 255
        srv.engine.server_distributor(
            Params(image_width=65536, image_height=65536, turns=1), world)
        del world
        res["get_world"] += check_world_bytes(srv, 65536, 1)
        views = []
        for _ in range(3):
            c0 = time.perf_counter()
            view, _, f = remote.get_view(LIVE_MAX_CELLS_DEFAULT)
            views.append((time.perf_counter() - c0) * 1e3)
        want, _, wf = srv.engine.get_view(LIVE_MAX_CELLS_DEFAULT)
        if f != wf or not np.array_equal(view, want):
            raise AssertionError("GetView 65536² != the engine's view")
        res["get_view_65536_ms"] = views
        log(f"  ok GetView 65536² (GOL_LIVE_MAX_CELLS default "
            f"{LIVE_MAX_CELLS_DEFAULT}): {view.shape[0]}x{view.shape[1]} "
            f"view at factor {f[0]} equals the engine's; "
            f"{views[0]:.2f} ms for the first poll (full frame), then "
            f"{', '.join(f'{v:.2f}' for v in views[1:])} ms (xrle)")
    del srv, remote, view, want  # the 65536² board goes with its engine
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        res["recovery"] = check_recovery(os.path.join(REPO, "images"), tmp)
    log("control_plane:" + json.dumps(res))
    return res


# ----------------------------------------------------- phase 4e: checkpoints

# Boards whose checkpoint and restore phase 4e times.
CKPT_SIZES = (512, 5120, 65536)


def plain_step(torch, board, turns: int, repr_: str, rule):
    """`turns` turns of the plain path on the card: packed int32 words
    for life-like boards, uint8 states (gen8) for Generations."""
    from gol_tpu_torch.ops import bitpack

    if repr_ == "packed":
        return bitpack.packed_run_turns(board, turns, rule)
    from gol_tpu_torch.models import generations as gen

    return gen.run_turns(board, turns, rule)


def plain_sha(board, repr_: str) -> str:
    """The manifest's board_sha256 of a plain-path board, in the payload
    of `repr_` (gen3 planes are packed from the uint8 states)."""
    from gol_tpu_torch.ckpt import manifest as mf
    from gol_tpu_torch.ckpt.writer import payload_arrays
    from gol_tpu_torch.ops.bitpack import pack_np

    host = board.cpu().numpy()
    if repr_ == "gen3":
        host = np.stack([pack_np(host == 1), pack_np(host == 2)])
    return mf.board_sha256(payload_arrays(host, repr_))


def check_manifests(torch, ck_dir: str, start, repr_: str, rule) -> list:
    """Every manifest in `ck_dir` verifies (payload SHA-256) and holds
    the board the plain path reaches at its turn from `start` (the turn-0
    board on the card). Returns the manifests' turns."""
    from gol_tpu_torch.ckpt import manifest as mf

    cur, at, turns = start, 0, []
    for turn, path, m in mf.list_checkpoints(ck_dir):
        mf.verify_manifest(path)
        if m["repr"] != repr_:
            raise AssertionError(f"{path}: repr {m['repr']} != {repr_}")
        cur, at = plain_step(torch, cur, turn - at, repr_, rule), turn
        if m["board_sha256"] != plain_sha(cur, repr_):
            raise AssertionError(f"{path}: board_sha256 != plain path")
        turns.append(turn)
    return turns


def resume_cli(ck_dir: str, out: str, turns: int, poll: bool) -> set:
    """`gol_tpu_torch.main.main(["--resume", ck_dir, ...])` as the CLI
    runs it, in this process (so the launch counters see its kernels),
    with a fresh default engine as a new process would have. Returns the
    (alive, turn) pairs its engine published, when `poll`."""
    from gol_tpu_torch import distributor as dist, main as cli

    dist._default_engine = None
    os.environ["GOL_OUT"] = out
    done, pairs = [], set()
    t = threading.Thread(target=lambda: done.append(cli.main(
        ["--turns", str(turns), "--headless", "--resume", ck_dir])))
    t.start()
    try:
        while t.is_alive():
            eng = dist._default_engine
            if poll and eng is not None:
                pair = eng.alive_count()
                if pair[1] > 0:
                    pairs.add(pair)
            time.sleep(0.0002)
        t.join()
    finally:
        for name in ("GOL_OUT", "CONT"):
            os.environ.pop(name, None)
        dist._default_engine = None
    if done != [0]:
        raise AssertionError(f"--resume {ck_dir} exited {done}")
    return pairs


def check_resume(torch, dev, tmp: str, size: int, turns: int, rule,
                 fuse, quit_at: int, every: int, world: np.ndarray,
                 images: str = "") -> dict:
    """One board through `run` on a CUDA engine with GOL_CKPT_EVERY_TURNS
    and GOL_JOURNAL, twice: once to the end, once quit ('q') at about
    `quit_at` and resumed with `--resume`. Both end on the same PGM, and
    every manifest of both holds the plain path's board at its turn."""
    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch import journal as journal_mod
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import write_pgm
    from gol_tpu_torch.models import CONWAY
    from gol_tpu_torch.models.generations import (
        GenerationsRule, from_pixels_gen, gray_levels)
    from gol_tpu_torch.ops import bitpack

    rule = rule or CONWAY
    gen = isinstance(rule, GenerationsRule)
    levels = tuple(gray_levels(rule).tolist()) if gen else None
    tag = f"{rule.rulestring.replace('/', '_')}_{size}_{fuse}"
    if not images:
        images = os.path.join(tmp, f"images_{tag}")
        write_pgm(os.path.join(images, f"{size}x{size}.pgm"), world,
                  levels=levels)
    name = f"{size}x{size}x{turns}.pgm"
    os.environ.update(GOL_CKPT_EVERY_TURNS=str(every), GOL_CKPT_KEEP="1000",
                      GOL_JOURNAL=os.path.join(tmp, f"journal_{tag}"))
    if fuse:
        os.environ["GOL_FUSE_K"] = str(fuse)
    p = Params(image_width=size, image_height=size, turns=turns)
    try:
        whole, cut = (os.path.join(tmp, f"{k}_{tag}") for k in ("whole",
                                                              "cut"))
        os.environ["GOL_CKPT"] = whole
        eng = Engine(rule=rule)
        drive(p, images, os.path.join(whole, "out"), engine=eng)
        repr_ = eng._repr
        os.environ["GOL_CKPT"] = cut
        # One turn a chunk, so the quit lands mid-run on the card.
        os.environ["GOL_MAX_CHUNK"] = "1"
        eng = Engine(rule=rule)
        keys: queue.Queue = queue.Queue()
        events_q: queue.Queue = queue.Queue()
        import gol_tpu_torch

        t = gol_tpu_torch.run(p, events_q, keys, engine=eng,
                              images_dir=images,
                              out_dir=os.path.join(cut, "out"))
        while eng.ping() < quit_at and t.is_alive():
            time.sleep(0.0005)
        keys.put("q")
        t.join(120)
        os.environ.pop("GOL_MAX_CHUNK")
        final = [e for e in ev.drain(events_q)
                 if isinstance(e, ev.FinalTurnComplete)][0]
        t_quit = final.completed_turns
        if not 0 < t_quit < turns:
            raise AssertionError(f"{tag}: quit landed at {t_quit}")
        del eng
        pairs = resume_cli(cut, os.path.join(cut, "out"), turns,
                           poll=size == 512 and not gen)
        journal_dir = os.environ["GOL_JOURNAL"]
    finally:
        for k in ("GOL_CKPT", "GOL_CKPT_EVERY_TURNS", "GOL_CKPT_KEEP",
                  "GOL_JOURNAL", "GOL_FUSE_K", "GOL_MAX_CHUNK"):
            os.environ.pop(k, None)
        journal_mod.reset()
    for jname in os.listdir(journal_dir):
        res = journal_mod.verify_file(os.path.join(journal_dir, jname))
        if not res["ok"]:
            raise AssertionError(f"{tag}: journal {jname}: {res}")
    with open(os.path.join(whole, "out", name), "rb") as f, \
            open(os.path.join(cut, "out", name), "rb") as g:
        if f.read() != g.read():
            raise AssertionError(f"{tag}: resumed PGM != uninterrupted")
    if gen:
        start = torch.from_numpy(from_pixels_gen(world, rule)).to(dev)
    else:
        start = bitpack.words_from_numpy(bitpack.pack_np(world), dev)
    turns_whole = check_manifests(torch, whole, start, repr_, rule)
    turns_cut = check_manifests(torch, cut, start, repr_, rule)
    if t_quit not in turns_cut or turns not in turns_cut:
        raise AssertionError(f"{tag}: manifests at {turns_cut}")
    log(f"  ok {rule.rulestring} {size}² x {turns}"
        f"{f' GOL_FUSE_K={fuse}' if fuse else ''} ({repr_}): quit at "
        f"{t_quit}, resumed with --resume, PGM equals the uninterrupted "
        f"run's; manifests at {turns_whole} and {turns_cut} verify and "
        f"equal the plain path's boards; journal chain verifies "
        f"({res['count']} records)")
    return dict(t_quit=t_quit, pairs=pairs)


def check_sigterm_resume(images: str, tmp: str) -> dict:
    """`python -m gol_tpu_torch.server --checkpoint DIR` on the card takes
    SIGTERM about a second into a 512² run through SER: it writes a
    `sigterm` manifest and the legacy 512x512.npz and exits 0. A new
    server `--resume DIR` on its port restores that turn; the controller
    reattaches there and ends on the in-process run's PGM."""
    import signal

    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch.ckpt import manifest as mf
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.distributor import distributor
    from gol_tpu_torch.engine import Engine

    turns = 4_000_000
    p = Params(image_width=512, image_height=512, turns=turns)
    ck = os.path.join(tmp, "sigterm_ck")
    env = {"GOL_DRAIN_DEADLINE": "0.2"}
    procs = []
    try:
        proc, port = spawn_server(0, "--checkpoint", ck, env=env)
        procs.append(proc)
        os.environ.update(SER=f"127.0.0.1:{port}", GOL_RECONNECT="180",
                          GOL_HB_INTERVAL="0.5")
        q: queue.Queue = queue.Queue()
        failed, seen = [], []

        def control():
            try:
                distributor(p, q, None, images_dir=images,
                            out_dir=os.path.join(tmp, "sigterm_out"))
            except BaseException as e:
                failed.append(e)

        ctrl = threading.Thread(target=control)
        ctrl.start()
        probe = RemoteEngine(f"127.0.0.1:{port}")
        deadline = time.monotonic() + 120
        while probe.ping() == 0:
            if time.monotonic() > deadline:
                raise AssertionError("the served run never started")
            time.sleep(0.01)
        time.sleep(1.0)
        t_term = time.monotonic()
        proc.send_signal(signal.SIGTERM)
        if proc.wait(60) != 0:
            raise AssertionError(f"SIGTERMed server exited {proc.returncode}")
        term_s = time.monotonic() - t_term
        t_sig, _, m = mf.latest_checkpoint(ck)
        if m["trigger"] != "sigterm" or not 0 < t_sig < turns:
            raise AssertionError(f"sigterm manifest: {m}")
        with np.load(os.path.join(ck, "512x512.npz")) as z:
            if int(z["turn"]) < t_sig:
                raise AssertionError("legacy autosave behind the manifest")
        proc2, port2 = spawn_server(port, "--checkpoint", ck, "--resume",
                                    ck, env=env)
        procs.append(proc2)
        if port2 != port:
            raise AssertionError(f"restarted on :{port2}, not :{port}")
        ctrl.join(600)
        if ctrl.is_alive() or failed:
            raise AssertionError(f"controller did not finish: {failed}")
        while True:
            e = q.get(timeout=10)
            if e is ev.CLOSE:
                break
            seen.append(e)
    finally:
        for k in ("SER", "GOL_RECONNECT", "GOL_HB_INTERVAL"):
            os.environ.pop(k, None)
        for proc in procs:
            stop_server(proc)
    reatt = [e for e in seen if isinstance(e, ev.EngineReattached)]
    final = [e for e in seen if isinstance(e, ev.FinalTurnComplete)][0]
    if (len(reatt) != 1 or reatt[0].completed_turns != t_sig
            or final.completed_turns != turns):
        raise AssertionError(f"reattached {reatt}, ended at "
                             f"{final.completed_turns}")
    drive(p, images, os.path.join(tmp, "sigterm_ref"), engine=Engine())
    name = f"512x512x{turns}.pgm"
    with open(os.path.join(tmp, "sigterm_out", name), "rb") as f, \
            open(os.path.join(tmp, "sigterm_ref", name), "rb") as g:
        if f.read() != g.read():
            raise AssertionError("resumed server's PGM != in-process run's")
    log(f"  ok SIGTERM: server exited 0 {term_s:.3f} s after the signal "
        f"with a sigterm manifest at turn {t_sig} and 512x512.npz; the "
        f"server restarted with --resume restored it, the controller "
        f"reattached at turn {t_sig}, final PGM equals the in-process "
        "run's")
    return dict(sigterm_turn=t_sig, sigterm_exit_s=term_s)


def phase_checkpoints(torch, dev) -> None:
    """Phase 4e: checkpoints on the card, through `run` with
    GOL_CKPT_EVERY_TURNS and GOL_JOURNAL: Conway 512² x 10000 quit at
    about 5000 and resumed with `--resume` (its published pairs against
    the CSV), 5120² x 1000 at GOL_FUSE_K=16, Brian's Brain 4096² x 1000
    (K5 gen3), Star Wars 512² x 100 (gen8); then a server subprocess
    SIGTERMed and resumed."""
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.models.generations import (
        BRIANS_BRAIN, STAR_WARS, gray_levels, to_pixels_gen)

    log("phase 4e: checkpoints and the journal on the card")
    images = os.path.join(REPO, "images")
    csv_counts = read_csv(os.path.join(REPO, "check", "alive",
                                       "512x512.csv"))
    with tempfile.TemporaryDirectory() as tmp:
        res = check_resume(torch, dev, tmp, 512, 10000, None, None, 5000,
                           1024, read_pgm(os.path.join(images,
                                                       "512x512.pgm")),
                           images=images)
        bad = [(a, t) for a, t in res["pairs"] if csv_counts[t] != a]
        if not res["pairs"] or bad:
            raise AssertionError(f"resumed pairs off the CSV: {bad}")
        log(f"  ok 512² resumed run: {len(res['pairs'])} published pairs "
            "equal check/alive/512x512.csv")
        check_resume(torch, dev, tmp, 5120, 1000, None, 16, 500, 128,
                     seeded_board(5120, 5120))
        rng = np.random.default_rng(4096)
        for size, turns, rule, every in ((4096, 1000, BRIANS_BRAIN, 128),
                                         (512, 100, STAR_WARS, 16)):
            state = rng.choice(np.arange(rule.states, dtype=np.uint8),
                               size=(size, size))
            check_resume(torch, dev, tmp, size, turns, rule, None,
                         turns // 2, every, to_pixels_gen(state, rule))
        check_sigterm_resume(images, tmp)


def phase_checkpoint_measure(torch, dev, card: Card) -> dict:
    """Phase 4e's numbers: `checkpoint_now` seconds (and its device-to-
    host copy alone) and MB/s of board bytes at 512², 5120² and 65536²,
    the restore of that manifest into a new engine, and engine turns/s
    at 5120² with GOL_CKPT_EVERY_TURNS=65536 beside the rate without it,
    one warm engine alternating off, on, on, off."""
    from gol_tpu_torch.ckpt.writer import device_to_host
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.ops import bitpack

    log(f"phase 4e: checkpoint measurements on {card.smi}")
    res = {"card": card.smi, "sizes": []}
    with tempfile.TemporaryDirectory() as tmp:
        for size in CKPT_SIZES:
            words = seeded_words(torch, size, size // 32, size, dev)
            nbytes = words.numel() * 4
            legacy = os.path.join(tmp, f"seed{size}.npz")
            np.savez(legacy, words=bitpack.words_to_numpy(words),
                     width=size, turn=7, rulestring="B3/S23")
            eng = Engine()
            eng.load_checkpoint(legacy)
            os.unlink(legacy)
            c0 = time.perf_counter()
            host = device_to_host(eng._cells)
            copy_s = time.perf_counter() - c0
            del host
            ck = os.path.join(tmp, f"ck{size}")
            c0 = time.perf_counter()
            path, turn = eng.checkpoint_now(ck)
            save_s = time.perf_counter() - c0
            fresh = Engine()
            c0 = time.perf_counter()
            fresh.restore_run(path)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - c0
            if not torch.equal(fresh._cells, words) or turn != 7:
                raise AssertionError(f"{size}²: restored board != saved")
            payload = os.path.getsize(path.replace(".json", ".npz"))
            row = dict(size=size, board_bytes=nbytes, payload_bytes=payload,
                       copy_s=copy_s, checkpoint_s=save_s,
                       checkpoint_mb_per_s=nbytes / save_s / 1e6,
                       restore_s=restore_s,
                       restore_mb_per_s=nbytes / restore_s / 1e6)
            res["sizes"].append(row)
            log(f"  {size}²: checkpoint_now {save_s:.4f} s "
                f"({row['checkpoint_mb_per_s']:.1f} MB/s of {nbytes} board "
                f"bytes; payload {payload} bytes; device-to-host copy "
                f"{copy_s:.4f} s), restore {restore_s:.4f} s "
                f"({row['restore_mb_per_s']:.1f} MB/s)")
            del eng, fresh, words
            torch.cuda.empty_cache()
            shutil.rmtree(ck)
        board = seeded_board(5120, 5120)
        held = Engine()
        engine_rate(torch, board, 3.0, eng=held)  # warm: converged chunk
        rates = {"off": [], "on": []}
        for mode in ("off", "on", "on", "off"):
            if mode == "on":
                os.environ.update(GOL_CKPT=os.path.join(tmp, "cadence"),
                                  GOL_CKPT_EVERY_TURNS="65536")
            try:
                rate, _, _, chunk = engine_rate(torch, board, 3.0, eng=held)
            finally:
                os.environ.pop("GOL_CKPT", None)
                os.environ.pop("GOL_CKPT_EVERY_TURNS", None)
            rates[mode].append(rate)
            log(f"  engine 5120² checkpoints {mode}: {rate:.1f} turns/s, "
                f"chunk {chunk} turns")
        res["turns_per_s_5120"] = rates
    log("checkpoints:" + json.dumps(res))
    return res


def gen8_plain(torch, dev, state: np.ndarray, turns: int, rule):
    """The uint8 gen8 path in plain torch on the card: the independent
    reference for the packed planes."""
    from gol_tpu_torch.models import generations as gen

    return gen.run_turns(torch.from_numpy(state).to(dev), turns,
                         rule).cpu().numpy()


def phase_generations(torch, dev) -> None:
    """Brian's Brain through `run` on a CUDA engine (512²: K4, 4096²: K5),
    Star Wars through `run` (512²: gen8) and through `GenerationsTorus`
    (512²: K4, 4096²: K5), each against the gen8 plain path on the
    card."""
    log("phase 4b: Generations path through gol_tpu_torch.run and "
        "GenerationsTorus on the card")
    with tempfile.TemporaryDirectory() as tmp:
        check_generations(torch, dev, os.path.join(REPO, "images"), tmp)


def check_generations(torch, dev, images: str, tmp: str) -> None:
    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import read_pgm, write_pgm
    from gol_tpu_torch.models.generations import (
        BRIANS_BRAIN, STAR_WARS, GenerationsTorus, from_pixels_gen,
        gray_levels, to_pixels_gen)

    levels = tuple(gray_levels(BRIANS_BRAIN).tolist())
    out = os.path.join(tmp, "gen_out")
    seed_dir = os.path.join(tmp, "gen_images")
    rng = np.random.default_rng(4096)
    big = rng.choice(np.array([0, 1, 2], np.uint8), size=(4096, 4096),
                     p=[0.7, 0.2, 0.1])
    write_pgm(os.path.join(seed_dir, "4096x4096.pgm"),
              to_pixels_gen(big, BRIANS_BRAIN), levels=levels)
    for size, turns, src in ((512, 100, images), (4096, 1000, seed_dir)):
        eng = Engine(rule=BRIANS_BRAIN)
        seen = []

        def poll():
            pair = eng.alive_count()
            seen.append((time.monotonic(), pair[1]))
            return pair

        evs, _ = drive(Params(image_width=size, image_height=size,
                              turns=turns), src, out, engine=eng, poll=poll)
        if eng._repr != "gen3":
            raise AssertionError(f"{size}² /2/3 ran as {eng._repr}")
        start = from_pixels_gen(read_pgm(
            os.path.join(src, f"{size}x{size}.pgm"), levels=levels),
            BRIANS_BRAIN)
        want = gen8_plain(torch, dev, start, turns, BRIANS_BRAIN)
        got = read_pgm(os.path.join(out, f"{size}x{size}x{turns}.pgm"),
                       levels=levels)
        if not np.array_equal(got, to_pixels_gen(want, BRIANS_BRAIN)):
            raise AssertionError(f"/2/3 {size}² x {turns}: PGM != gen8")
        final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
        if final.count() != int((want == 1).sum()):
            raise AssertionError(f"/2/3 {size}² x {turns}: firing count")
        firsts = first_sightings(seen)
        rate, gap = publication_rate(firsts), publication_gap(firsts)
        log(f"  ok /2/3 {size}² x {turns} through run: gray PGM and "
            f"firing count ({final.count()}) equal the gen8 plain path; "
            f"{len(firsts)} published turns, {rate:.1f} turns/s between the "
            f"first and the last, at most {gap:.3f} s apart")
    # Star Wars through `run`: C = 4 boards take the uint8 gen8
    # representation, stepped in plain torch ops (no kernel).
    sw_levels = tuple(gray_levels(STAR_WARS).tolist())
    eng = Engine(rule=STAR_WARS)
    seen = []

    def poll_sw():
        pair = eng.alive_count()
        seen.append((time.monotonic(), pair[1]))
        return pair

    evs, _ = drive(Params(image_width=512, image_height=512, turns=100),
                   images, out, engine=eng, poll=poll_sw)
    if eng._repr != "gen8":
        raise AssertionError(f"512² 345/2/4 ran as {eng._repr}")
    start = from_pixels_gen(read_pgm(os.path.join(images, "512x512.pgm"),
                                     levels=sw_levels), STAR_WARS)
    want = gen8_plain(torch, dev, start, 100, STAR_WARS)
    got = read_pgm(os.path.join(out, "512x512x100.pgm"), levels=sw_levels)
    if not np.array_equal(got, to_pixels_gen(want, STAR_WARS)):
        raise AssertionError("345/2/4 512² x 100 through run: PGM != gen8")
    final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
    if final.count() != int((want == 1).sum()):
        raise AssertionError("345/2/4 512² x 100 through run: firing count")
    firsts = first_sightings(seen)
    log(f"  ok 345/2/4 512² x 100 through run (gen8): gray PGM and firing "
        f"count ({final.count()}) equal the gen8 plain path; "
        f"{len(firsts)} published turns, "
        f"{publication_rate(firsts):.1f} turns/s between the first and "
        f"the last, at most {publication_gap(firsts):.3f} s apart")
    for size in (512, 4096):
        board = np.random.default_rng(size).integers(
            0, 4, size=(size, size)).astype(np.uint8)
        gt = GenerationsTorus(board, STAR_WARS)
        gt.run(64)
        want = gen8_plain(torch, dev, board, 64, STAR_WARS)
        if not np.array_equal(gt.board, want):
            raise AssertionError(f"345/2/4 torus {size}² x 64 != gen8")
        if gt.alive_count() != int((want == 1).sum()):
            raise AssertionError(f"345/2/4 torus {size}²: firing count")
        log(f"  ok 345/2/4 GenerationsTorus {size}² x 64 equals the gen8 "
            "plain path")


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


def engine_rate(torch, world: np.ndarray, seconds: float, rule=None,
                fuse=None, eng=None):
    """(turns/s, median alive_count() µs, max gap s between publications,
    last chunk in turns) of a CUDA engine on `world` (under `rule`, Conway
    by default; at GOL_FUSE_K=`fuse` when given), from the pairs it
    publishes. A new engine unless `eng` is given: an engine that ran the
    same shape before starts at its converged chunk, and a RemoteEngine
    measures the engine of its server through SER."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine import Engine, FLAG_QUIT

    if eng is None:
        eng = Engine() if rule is None else Engine(rule=rule)
    h, w = world.shape
    failed = []
    if fuse is not None:
        os.environ["GOL_FUSE_K"] = str(fuse)

    base = eng.ping()  # a reused engine continues its turn count

    def target() -> None:
        try:
            eng.server_distributor(
                Params(image_width=w, image_height=h, turns=10**12), world,
                start_turn=base)
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
        if turn > base:
            seen.append((now, turn))
            if t_end is None:
                t_end = now + seconds
        if t_end is not None and now >= t_end:
            eng.cf_put(FLAG_QUIT)
            break
        time.sleep(0.0005)
    t.join()
    os.environ.pop("GOL_FUSE_K", None)
    if failed:
        raise failed[0]
    chunk = eng.stats()["chunk"]
    steady = first_sightings(seen)
    steady = steady[len(steady) // 4:] if len(steady) >= 8 else steady
    return (publication_rate(steady), statistics.median(calls) * 1e6,
            publication_gap(steady), chunk)


def first_sightings(seen: list) -> list:
    """(time, turn) of the first poll that saw each published turn > 0,
    from (time, turn) polls."""
    firsts = []
    for t, turn in seen:
        if turn > 0 and (not firsts or firsts[-1][1] != turn):
            firsts.append((t, turn))
    return firsts


def publication_rate(firsts: list) -> float:
    """Turns per second between the first and the last sighting."""
    if len(firsts) < 2 or firsts[-1][0] <= firsts[0][0]:
        return 0.0
    return (firsts[-1][1] - firsts[0][1]) / (firsts[-1][0] - firsts[0][0])


def publication_gap(firsts: list) -> float:
    """Largest time between two consecutive sightings."""
    return max((b[0] - a[0] for a, b in zip(firsts, firsts[1:])),
               default=0.0)


def log_row(name: str, r: dict) -> None:
    geom = "".join(f" {k}={r[k]}" for k in ("ctas", "per", "rows", "fuse_k",
                                            "radius", "tile") if k in r)
    plain = ("not measured" if r["plain_ms"] is None
             else f"{r['plain_ms']:.4f} ms")
    library = (f", library {r['library_ms']:.4f} ms"
               if r.get("library_ms") is not None else "")
    log(f"  {name} {r['shape']} turns={r['turns']}{geom}"
        f"{' (policy)' if r.get('policy') else ''}: {r['ms']:.4f} ms/launch, "
        f"plain {plain}{library}, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})")


def phase_timing(torch, dev, card: Card, launches: dict) -> list:
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    log(f"phase 5: timings on {card.smi}")
    ops = cs.OPS_PER_WORD_TURN
    k1_turns = 1024
    rows = {"resident_run_turns": [], "tiled_sweep": [],
            "row_popcounts": []}
    # K1 at every power-of-two cluster size, and at 512² (N = 16) at
    # other rows per thread; the plain version at the policy's geometry.
    for (h, wp) in [(512, 16), (256, 8), (64, 2)]:
        w = seeded_words(torch, h, wp, 1, dev)
        policy = (cs.resident_cluster_ctas(h, wp),
                  cs.resident_rows_per_thread(
                      h, wp, cs.resident_cluster_ctas(h, wp)))
        geoms = [(n, cs.resident_rows_per_thread(h, wp, n))
                 for n in (1, 2, 4, 8, 16)]
        if h == 512:
            geoms += [(16, per) for per in RESIDENT_PER_TIMED]
        b, by = card.bound(8 * h * wp, ops * k1_turns * h * wp)
        for n, per in sorted(set(geoms) | {policy}):
            ms = time_ms(torch, lambda: cs.resident_run_turns(
                w, k1_turns, ctas=n, per=per), 5)
            plain = (time_ms(torch, lambda: cs.resident_run_turns_plain(
                w, k1_turns), 1) if (n, per) == policy else None)
            rows["resident_run_turns"].append(dict(
                shape=f"{h}x{wp * 32}", turns=k1_turns, ctas=n, per=per,
                policy=(n, per) == policy, ms=ms, plain_ms=plain,
                bound_ms=b, bound_by=by))
    # K2 at every tile height; the plain version at the policy's.
    for (h, wp) in [(65536, 2048), (16384, 512), (8192, 256), (5120, 160)]:
        w = seeded_words(torch, h, wp, 2, dev)
        o = torch.empty_like(w)
        b, by = card.bound(8 * h * wp, ops * 32 * h * wp)
        for r in cs.TILE_ROW_CHOICES:
            ms = time_ms(torch, lambda: cs.tiled_sweep(w, o, 32, rows=r), 5)
            policy = r == cs.tile_rows(h, wp)
            plain = (time_ms(torch, lambda: cs.tiled_sweep_plain(w, 32), 1)
                     if policy else None)
            rows["tiled_sweep"].append(dict(
                shape=f"{h}x{wp * 32}", turns=32, rows=r, policy=policy,
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=by))
        del w, o
    for (h, wp) in [(65536, 2048), (16384, 512), (5120, 160), (512, 16)]:
        w = seeded_words(torch, h, wp, 2, dev)
        ms = time_ms(torch, lambda: cs.row_popcounts(w), 20)
        plain = time_ms(torch, lambda: bitpack.row_popcounts_plain(w), 3)
        # One __popc per word; it issues at 16 per clock per SM, a
        # quarter of the logic rate `Card` counts in.
        b, by = card.bound(4 * h * wp + 4 * h, 4 * h * wp)
        rows["row_popcounts"].append(dict(
            shape=f"{h}x{wp * 32}", turns=0, ms=ms, plain_ms=plain,
            bound_ms=b, bound_by=by))
        del w
    for name, rs in rows.items():
        for r in rs:
            log_row(name, r)

    engine = []
    # 65536² runs unfused, then at GOL_FUSE_K=64 on the same board.
    for size, seconds, fuses in ((512, 3.0, (None,)), (5120, 3.0, (None,)),
                                 (65536, 6.0, (None, 64))):
        words = seeded_words(torch, size, size // 32, 3, dev)
        world = bitpack.unpack_np(bitpack.words_to_numpy(words))
        del words
        world *= 255
        for fuse in fuses:
            rate, poll_us, gap, chunk = engine_rate(torch, world, seconds,
                                                    fuse=fuse)
            engine.append(dict(size=size, fuse_k=fuse, card=card.smi,
                               turns_per_s=rate,
                               cell_updates_per_s=rate * size * size,
                               alive_count_us=poll_us,
                               max_publish_gap_s=gap, chunk_turns=chunk))
            log(f"  engine {size}²{f' GOL_FUSE_K={fuse}' if fuse else ''}: "
                f"{rate:.1f} turns/s ({rate * size * size:.4g} cell "
                f"updates/s), alive_count() {poll_us:.2f} µs median, "
                f"publications at most {gap:.3f} s apart, chunk {chunk} "
                "turns")
        del world
    engine += engine_rates_generations(torch, dev, card)
    log("engine:" + json.dumps(engine))
    deep, b3 = timing_deep(torch, dev, card, rows["tiled_sweep"])
    rows["tiled_sweep_deep"] = deep
    rows.update(timing_2p(torch, dev, card))

    meta = {
        "resident_run_turns": ("gol_tpu/ops/pallas_stencil.py:508",
                               "512x512"),
        "tiled_sweep": ("gol_tpu/ops/pallas_stencil.py:388", "65536x65536"),
        "row_popcounts": ("gol_tpu/engine.py:158", "65536x65536"),
        "tiled_sweep_deep": ("gol_tpu/ops/pallas_stencil.py:474",
                             "65536x65536"),
    }
    for fam, line in (("gen3", 274), ("gen4", 296)):
        tpu = f"gol_tpu/ops/pallas_stencil.py:{line}"
        meta[f"resident_run_turns2p/{fam}"] = (tpu, "512x512")
        meta[f"tiled_sweep2p/{fam}"] = (tpu, "4096x4096")
    kernels = []
    for name, rs in rows.items():
        head = [r for r in rs if r["shape"] == meta[name][1]
                and r.get("policy", True)][0]
        kernels.append(dict(
            name=name, route="cuda",
            source="gol_tpu_torch/csrc/stencil.cu",
            family=name.split("/")[1] if "/" in name else None,
            replaces=meta[name][0], launches=launches[name],
            bit_exact=MAX_ABS_ERR[name] == 0,
            max_abs_err=MAX_ABS_ERR[name], card=card.smi,
            shape=head["shape"],
            turns=head["turns"], ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, by_shape=rs))
        if name == "tiled_sweep_deep":
            kernels[-1]["fused_banded_run_turns"] = b3
    return kernels


def timing_deep(torch, dev, card: Card, k2_rows: list):
    """K6 (one 64-turn sweep) at 8192², 65536² and 131072² (2 GiB packed),
    K2's 32-turn sweep at 131072², and B3 `fused_banded_run_turns` over 128
    turns at pinned depths 16, 32 and 64; each beside its bound. The
    plain versions are timed where their windows fit the card: K6 up to
    65536², B3 at 8192²."""
    from gol_tpu_torch.ops import cuda_stencil as cs

    ops = cs.OPS_PER_WORD_TURN
    deep, b3 = [], []
    for (h, wp) in [(8192, 256), (65536, 2048), (131072, 4096)]:
        reps = 2 if h > 65536 else 5
        w = seeded_words(torch, h, wp, 4, dev)
        o = torch.empty_like(w)
        ms = time_ms(torch, lambda: cs.tiled_sweep_deep(w, o, 64), reps)
        plain = (time_ms(torch, lambda: cs.tiled_sweep_deep_plain(w, 64), 1)
                 if h <= 65536 else None)
        b, by = card.bound(8 * h * wp, ops * 64 * h * wp)
        deep.append(dict(shape=f"{h}x{wp * 32}", turns=64, ms=ms,
                         plain_ms=plain, bound_ms=b, bound_by=by))
        if h > 65536:  # K2 up to 65536² is timed with K1-K3
            k2 = time_ms(torch, lambda: cs.tiled_sweep(w, o, 32), reps)
            b2, by2 = card.bound(8 * h * wp, ops * 32 * h * wp)
            k2_rows.append(dict(shape=f"{h}x{wp * 32}", turns=32,
                                rows=cs.tile_rows(h, wp), policy=True,
                                ms=k2, plain_ms=None, bound_ms=b2,
                                bound_by=by2))
        del o
        for k in (16, 32, 64):
            ms = time_ms(torch, lambda: cs.fused_banded_run_turns(
                w, 128, k), reps)
            plain = None
            if h == 8192:
                def composed():
                    x = w
                    for depth in cs.sweep_depths(128, k):
                        x = (cs.tiled_sweep_plain if depth <= cs.TILE_MAX_T
                             else cs.tiled_sweep_deep_plain)(x, depth)
                    return x
                plain = time_ms(torch, composed, 1)
            b, by = card.bound(8 * h * wp, ops * 128 * h * wp)
            b3.append(dict(shape=f"{h}x{wp * 32}", turns=128, fuse_k=k,
                           ms=ms, plain_ms=plain, bound_ms=b, bound_by=by))
        del w
        torch.cuda.empty_cache()
    for name, rs in (("tiled_sweep_deep", deep),
                     ("fused_banded_run_turns", b3),
                     ("tiled_sweep", k2_rows[-1:])):
        for r in rs:
            log_row(name, r)
    return deep, b3


def engine_rates_generations(torch, dev, card: Card) -> list:
    """Engine turns/s for Brian's Brain at 512² (K4) and 4096² (K5), and
    for Star Wars at 512² (gen8: plain torch ops, no kernel)."""
    from gol_tpu_torch.models.generations import (
        BRIANS_BRAIN, STAR_WARS, to_pixels_gen)

    engine = []
    for size, rule in ((512, BRIANS_BRAIN), (4096, BRIANS_BRAIN),
                       (512, STAR_WARS)):
        rng = np.random.default_rng(size + 3)
        state = rng.choice(np.array([0, 1, 2], np.uint8), size=(size, size),
                           p=[0.7, 0.2, 0.1])
        world = to_pixels_gen(state, rule)
        rate, poll_us, gap, chunk = engine_rate(torch, world, 3.0, rule)
        engine.append(dict(size=size, rule=rule.rulestring, card=card.smi,
                           turns_per_s=rate,
                           cell_updates_per_s=rate * size * size,
                           alive_count_us=poll_us, max_publish_gap_s=gap,
                           chunk_turns=chunk))
        log(f"  engine {rule.rulestring} {size}²: {rate:.1f} turns/s "
            f"({rate * size * size:.4g} cell updates/s), alive_count() "
            f"{poll_us:.2f} µs median, publications at most {gap:.3f} s "
            f"apart, chunk {chunk} turns")
    return engine


def timing_2p(torch, dev, card: Card) -> dict:
    """ms per launch of K4 (1024 turns) at every cluster size N = 1..16 on
    512², 256², 128² and 64² (and at other rows per thread at N = 16 on
    512²), and of K5 (one 32-turn sweep) at every tile height R on 16384²
    and 4096², per family, beside the plain version at the policy's
    geometry and the bound: 16 bytes per word (both planes read and
    written once) and `OPS_PER_WORD_TURN_2P` ops per word and turn. The
    rows of the `kernels` line keep K1's timed geometries (N = 1, 2, 4,
    8, 16); every N is logged."""
    from gol_tpu_torch.models.generations import BRIANS_BRAIN, STAR_WARS
    from gol_tpu_torch.ops import cuda_stencil as cs

    rows = {}
    turns = 1024
    for fam, rule in (("gen3", BRIANS_BRAIN), ("gen4", STAR_WARS)):
        ops = cs.OPS_PER_WORD_TURN_2P[fam]
        name = f"resident_run_turns2p/{fam}"
        k4, k5 = [], []
        for (h, wp) in [(512, 16), (256, 8), (128, 4), (64, 2)]:
            p = seeded_planes(torch, h, wp, fam, 1, dev)
            n0 = cs.resident2p_cluster_ctas(h, wp)
            policy = (n0, cs.resident2p_rows_per_thread(h, wp, n0))
            geoms = {(n, cs.resident2p_rows_per_thread(h, wp, n))
                     for n in range(1, cs.RESIDENT_MAX_CTAS + 1)} | {policy}
            if h == 512:
                geoms |= {(16, per) for per in RESIDENT_PER_TIMED}
            b, by = card.bound(16 * h * wp, ops * turns * h * wp)
            for n, per in sorted(geoms):
                ms = time_ms(torch, lambda: cs.resident_run_turns2p(
                    p, turns, rule, fam, ctas=n, per=per), 5)
                plain = (time_ms(torch, lambda: cs.resident_run_turns2p_plain(
                    p, turns, rule, fam), 1) if (n, per) == policy else None)
                r = dict(shape=f"{h}x{wp * 32}", turns=turns, ctas=n,
                         per=per, policy=(n, per) == policy, ms=ms,
                         plain_ms=plain, bound_ms=b, bound_by=by)
                log_row(name, r)
                if r["policy"] or n in (1, 2, 4, 8) or (
                        n == 16 and (h == 512 or per == policy[1])):
                    k4.append(r)
        for (h, wp) in [(16384, 512), (4096, 128)]:
            p = seeded_planes(torch, h, wp, fam, 2, dev)
            o = torch.empty_like(p)
            b, by = card.bound(16 * h * wp, ops * 32 * h * wp)
            for rows_ in cs.TILE2P_ROW_CHOICES:
                ms = time_ms(torch, lambda: cs.tiled_sweep2p(
                    p, o, 32, rule, fam, rows=rows_), 5)
                policy = rows_ == cs.tile2p_rows(h, wp)
                plain = (time_ms(torch, lambda: cs.tiled_sweep2p_plain(
                    p, 32, rule, fam), 1) if policy else None)
                k5.append(dict(shape=f"{h}x{wp * 32}", turns=32, rows=rows_,
                               policy=policy, ms=ms, plain_ms=plain,
                               bound_ms=b, bound_by=by))
                log_row(f"tiled_sweep2p/{fam}", k5[-1])
            del p, o
        rows[name] = k4
        rows[f"tiled_sweep2p/{fam}"] = k5
    return rows


# --------------------------------------------- phase 4f: the conv families

# K7's checked shapes and radii, and the board its timings use (the JAX
# bench's CONV_N and CONV_RADII, with Bosco's r = 5, bench.py:841-842).
LTL_SHAPES = ((64, 64), (512, 512), (4096, 4096), (1000, 777), (16, 16))
LTL_RADII = (1, 2, 5, 8, 16, 32, 128)
CONV_N = 4096
CONV_RADII = (1, 2, 4, 5, 8, 16, 32)
# Radii of the crossover sweep at 512², 1024² and 4096², K7 at every tile
# against the FFT tier (the sizes the JAX CPU table's anchors used, and
# beyond the bench's radii).
CROSSOVER_RADII = (8, 16, 32, 64, 128)
# Radii of the other kinds' sweep (a circular neighbourhood: F.conv2d
# against the FFT tier); at 4096² up to GENERAL_MAX_4096 (conv2d takes 61
# ms a turn there at r = 16).
GENERAL_RADII = (2, 3, 4, 5, 6, 8, 12, 16, 32)
GENERAL_MAX_4096 = 16
# Turns one timed K7 call issues (`k7_launch_ms`), and one timed route-1
# launch.
LTL_TIMED_TURNS = 10
LTL_RESIDENT_TURNS = 1000
# Route 2's radii beyond the bench's at 4096², and route 1's at 512² and
# 1024².
LTL_WIDE_RADII = (64, 128)
ROUTE1_RADII = (1, 5, 16, 32, 64, 128)
# The JAX bench's Lenia legs (bench.py:851-861): (board, rule, tier, the
# float64 oracle's pinned digest after 8 turns from seed 42).
LENIA_TURNS = 8
LENIA_SEED = 42
LENIA_TOL = 1e-4
LENIA_LEGS = (
    (1024, "lenia:r=13,mu=0.15,sigma=0.015,dt=0.1", "fft",
     "21229d660f4917e215c5520a7d6f5730bbbd1a34690d669ac53e13067724d0ad"),
    (512, "lenia:r=4,mu=0.15,sigma=0.015,dt=0.1", "conv",
     "fdccc85216d957fd11e7046c014ef0c44b56fa8a429e47869c2b18ea8bec650c"),
)


def conv_rule(r: int):
    """The JAX bench's swept LtL rule at radius r (`bench._conv_rule`):
    Conway at r = 1, Bosco's fractions scaled to the box above it (Bosco
    itself at r = 5)."""
    from gol_tpu_torch.models.largerthanlife import (
        CONWAY_LTL, LargerThanLifeRule)

    if r == 1:
        return CONWAY_LTL
    area = (2 * r + 1) ** 2
    return LargerThanLifeRule(
        f"R{r},C0,M1,S{round(0.273 * area)}..{round(0.471 * area)},"
        f"B{round(0.281 * area)}..{round(0.372 * area)},NM")


def circle_rule(r: int):
    """A circular-neighbourhood (NC) rule at radius r with `conv_rule`'s
    fractions of its neighbourhood: a kind that the direct tier runs
    through F.conv2d, not K7."""
    from gol_tpu_torch.models.largerthanlife import LargerThanLifeRule
    from gol_tpu_torch.ops.conv import neighborhood_kernel

    area = int(neighborhood_kernel(r, "C", True).sum())
    return LargerThanLifeRule(
        f"R{r},C0,M1,S{round(0.273 * area)}..{round(0.471 * area)},"
        f"B{round(0.281 * area)}..{round(0.372 * area)},NC")


def soup(torch, h: int, w: int, seed: int, dev, p: float = 0.4):
    """A {0,1} uint8 board with `p` alive on the card, from numpy."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.random((h, w)) < p).astype(np.uint8)).to(
        dev)


def phase_kernels_ltl(torch, dev) -> None:
    """K7's two routes against their plain versions on the card,
    bit-exact: route 2 (`ltl_box_run_turns` at the policy's tile) against
    `_ltl_step` in torch ops, route 1 (`ltl_resident_run_turns`, where
    `ltl_resident_ctas` admits the shape) against its slab plain version,
    3 turns a case: every shape and radius of LTL_SHAPES x LTL_RADII with
    M0 and M1 rules (16² at r = 10 and beyond wraps the box around the
    torus more than once; r = 128 counts past 16 bits), route 2 at every
    tile and route 1 on the odd 1000 x 777 board, route 1 at every cluster
    size N that fits on 512² and 64² (slabs down to 4 rows, thinner than
    r) at k = 1, 2 and 33 turns in one launch and at 1024² (r = 128 goes
    to route 2 there), and both on a nearly full 300² board at r = 128
    (counts past 65,535)."""
    from gol_tpu_torch.models.largerthanlife import (
        BOSCO, LargerThanLifeRule)
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 3: K7 route 1 (ltl_resident_run_turns) and route 2 "
        "(ltl_box_run_turns) against their plain versions (bit-exact)")

    def route1(what, b, turns, rule, ctas=None):
        want = cs.ltl_resident_run_turns_plain(b, turns, rule, ctas)
        check_equal(torch, f"K7 route 1 {what}",
                    cs.ltl_resident_run_turns(b, turns, rule, ctas=ctas),
                    want, "ltl_resident_run_turns")
        return want

    cases = [(h, w, r) for h, w in LTL_SHAPES for r in LTL_RADII]
    cases += [(16, 16, 10), (1024, 1024, 5), (1024, 1024, 64),
              (1024, 1024, 128)]
    for h, w, r in cases:
        rule = conv_rule(r)
        if r % 2:  # the same ranges with the cell left out (M0)
            rule = LargerThanLifeRule(rule.rulestring.replace(",M1,", ",M0,"))
        b = soup(torch, h, w, h * 31 + w + r, dev)
        what = f"{h}x{w} r={r} {rule.rulestring} 3 turns"
        want = None
        if (h, w) != (1024, 1024):
            tile = cs.ltl_tile(h, w, r)
            want = cs.ltl_box_run_turns_plain(b, 3, rule)
            check_equal(torch, f"K7 route 2 {what} tile={tile}",
                        cs.ltl_box_run_turns(b, 3, rule, tile=tile), want,
                        "ltl_box_run_turns")
        n = cs.ltl_resident_ctas(h, w, r)
        if n:
            got = route1(f"{what} N={n}", b, 3, rule)
            if want is not None and not torch.equal(got, want):
                raise AssertionError(f"K7 {what}: route 1's plain version "
                                     "differs from route 2's")
    b = soup(torch, 1000, 777, 5, dev)
    want = cs.ltl_box_run_turns_plain(b, 7, BOSCO)
    for tile in cs.LTL_TILE_CHOICES:
        check_equal(torch, f"K7 route 2 1000x777 Bosco tile={tile} 7 turns",
                    cs.ltl_box_run_turns(b, 7, BOSCO, tile=tile), want,
                    "ltl_box_run_turns")
    if not torch.equal(route1("1000x777 Bosco 7 turns", b, 7, BOSCO), want):
        raise AssertionError("K7 1000x777: route 1's plain version differs "
                             "from route 2's")
    for size in (512, 64):
        b = soup(torch, size, size, size + 3, dev)
        for r in (5, 32):
            rule = conv_rule(r)
            for n in range(1, cs.RESIDENT_MAX_CTAS + 1):
                if cs.ltl_resident_smem_bytes(size, size, r, n) > \
                        cs.SMEM_BYTES:
                    continue
                for turns in (1, 2, 33):
                    route1(f"{size}² r={r} N={n} {turns} turns", b, turns,
                           rule, n)
    dense = torch.ones((300, 300), dtype=torch.uint8, device=dev)
    dense[torch.randint(0, 300, (40,)), torch.randint(0, 300, (40,))] = 0
    rule = LargerThanLifeRule("R128,C0,M1,S66022..66049,B65900..66048,NM")
    want = cs.ltl_box_run_turns_plain(dense, 2, rule)
    for tile in (64, 32):
        check_equal(torch, f"K7 route 2 300x300 r=128 tile={tile} counts "
                    "past 65,535, 2 turns",
                    cs.ltl_box_run_turns(dense, 2, rule, tile=tile), want,
                    "ltl_box_run_turns")
    if not torch.equal(route1("300x300 r=128 counts past 65,535, 2 turns",
                              dense, 2, rule), want):
        raise AssertionError("K7 300x300 r=128: route 1's plain version "
                             "differs from route 2's")


def phase_conv(torch, dev) -> None:
    """The A12 main path: Bosco through `gol_tpu_torch.run` on a CUDA
    engine, against the plain path on the card: 512² x 100 on K7's route 1
    (one launch a chunk, by the counter against the engine's chunks) and
    4096² x 100 on route 2 (one launch a turn)."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import read_pgm, write_pgm
    from gol_tpu_torch.models.largerthanlife import BOSCO
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 4f: Larger-than-Life (Bosco) through gol_tpu_torch.run")
    for size, turns in ((512, 100), (CONV_N, 100)):
        chunks = []
        eng = Engine(rule=BOSCO)
        chunk = eng._chunk

        def counted(run, cells, k, chunk=chunk, chunks=chunks):
            chunks.append(k)
            return chunk(run, cells, k)

        eng._chunk = counted
        before = (cs.ltl_resident_run_turns.launches,
                  cs.ltl_box_run_turns.launches)
        with tempfile.TemporaryDirectory() as tmp:
            images, out = (os.path.join(tmp, "images"),
                           os.path.join(tmp, "out"))
            rng = np.random.default_rng(size)
            board = ((rng.random((size, size)) < 0.4) * 255).astype(
                np.uint8)
            write_pgm(os.path.join(images, f"{size}x{size}.pgm"), board)
            drive(Params(image_width=size, image_height=size, turns=turns),
                  images, out, engine=eng)
            got = read_pgm(os.path.join(out, f"{size}x{size}x{turns}.pgm"))
        if eng._repr != "u8":
            raise AssertionError(f"Bosco ran as {eng._repr}")
        plain = cs.ltl_box_run_turns_plain(
            torch.from_numpy((board != 0).astype(np.uint8)).to(dev), turns,
            BOSCO).cpu().numpy()
        if not np.array_equal(got, plain * 255):
            raise AssertionError(f"Bosco {size}² x {turns} through run != "
                                 "plain")
        r1 = cs.ltl_resident_run_turns.launches - before[0]
        r2 = cs.ltl_box_run_turns.launches - before[1]
        if cs.ltl_resident_ctas(size, size, BOSCO.radius):
            ok = r1 == len(chunks) and r2 == 0
        else:
            ok = r1 == 0 and r2 == sum(chunks)
        if not ok or sum(chunks) != turns:
            raise AssertionError(
                f"Bosco {size}²: {len(chunks)} chunks of {sum(chunks)} turns "
                f"launched route 1 {r1} and route 2 {r2} times")
        log(f"  ok Bosco {size}² x {turns} through run: PGM equals the plain "
            f"path ({int(plain.sum())} alive); {len(chunks)} chunks "
            f"{chunks}, route 1 launches {r1}, route 2 launches {r2}")


def phase_conv_checks(torch, dev) -> None:
    """The FFT tier's counts at 4096² (cuFFT round-off under the mean
    split) and the JAX bench's two Lenia legs on the card."""
    from gol_tpu_torch.models import lenia as L
    from gol_tpu_torch.ops import conv as C

    log("phase 4f: FFT-tier counts and the Lenia legs on the card")
    b = soup(torch, CONV_N, CONV_N, 11, dev, 0.35)
    host = b.cpu().numpy()
    for r in (8, 16, 32):
        got = torch.round(C.fft_neighbor_sum(b, ("ltl", r, "M", True)))
        want = C.box_counts_np(host, r, True)
        bad = int((got.cpu().numpy().astype(np.int64) != want).sum())
        if bad:
            raise AssertionError(f"FFT tier {CONV_N}² r={r}: {bad} counts "
                                 "differ from box_counts_np")
        log(f"  ok FFT tier {CONV_N}² r={r}: every count equals "
            "box_counts_np")
    for n, rs, tier, pinned in LENIA_LEGS:
        rule = L.LeniaRule(rs)
        s0 = L.seed_board(n, n, LENIA_SEED, rule)
        ref = s0
        for _ in range(LENIA_TURNS):
            ref = L.step_np(ref, rule)
        digest = L.board_digest(ref)
        if digest != pinned:
            raise AssertionError(f"Lenia {n}²: oracle digest {digest} != "
                                 f"pinned {pinned}")
        got = C.run_turns(torch.from_numpy(s0).to(dev), LENIA_TURNS, rule,
                          tier=tier).cpu().numpy()
        err = float(np.max(np.abs(got.astype(np.float64) - ref)))
        if not err < LENIA_TOL:
            raise AssertionError(f"Lenia {n}² {tier}: max|card - oracle| "
                                 f"= {err:.3g} >= {LENIA_TOL}")
        log(f"  ok Lenia {n}² r={rule.radius} {tier} x {LENIA_TURNS}: max "
            f"|card - float64 oracle| {err:.3g} < {LENIA_TOL}; oracle "
            "digest equals the pinned one")


def k7_launch_ms(torch, cells, rule, tile=None) -> float:
    """K7's device ms a turn: LTL_TIMED_TURNS turns issued by one C call
    (as the engine issues a chunk; route 2 unless the gate admits the
    shape and no `tile` is pinned, then one route-1 launch), so the
    wrapper's host work between Python calls stays out of the figure."""
    from gol_tpu_torch.ops import cuda_stencil as cs

    return time_ms(torch, lambda: cs.ltl_box_run_turns(
        cells, LTL_TIMED_TURNS, rule, tile=tile), 5) / LTL_TIMED_TURNS


def route2_tiles(torch, b, rule, r: int) -> dict:
    """{tile: route 2's ms a turn} for every tile whose block fits."""
    from gol_tpu_torch.ops import cuda_stencil as cs

    return {t: k7_launch_ms(torch, b, rule, t) for t in cs.LTL_TILE_CHOICES
            if cs.ltl_tile_smem_bytes(t, r) <= cs.SMEM_BYTES}


def timing_ltl(torch, dev, card: Card) -> tuple:
    """K7's two routes, the library call and the FFT tier on the card:
    route 2 at 4096² for CONV_RADII and r = 64, 128 at every tile that
    fits, beside its plain version, its bound, the library call (F.conv2d
    of the wrap-padded float32 board with a (2r+1)² ones kernel, TF32 off)
    and the FFT tier's turn; route 1 at 512² and 1024² (one launch of
    LTL_RESIDENT_TURNS turns; at 64² on one CTA, r = 1 and 5) beside route
    2 at every tile on the same boards, with F.conv2d at 512² r = 5; K7 at
    the gate's route against the FFT tier at 512² and 1024² up to r = 128
    (the box crossover); a circular neighbourhood's direct tier against
    the FFT tier; and engine turns/s for Bosco at 512² and 4096² and
    Orbium at 1024². Returns
    (route 2 rows, route 1 rows, FFT rows, general rows, engine rows)."""
    from gol_tpu_torch.models.largerthanlife import BOSCO
    from gol_tpu_torch.models.lenia import ORBIUM, seed_board
    from gol_tpu_torch.ops import conv as C, cuda_stencil as cs

    n = CONV_N
    b = soup(torch, n, n, 13, dev, 0.35)
    k7, fft = [], []
    for r in CONV_RADII + LTL_WIDE_RADII:
        rule = conv_rule(r)
        bound, by = card.bound(2 * n * n, cs.LTL_OPS_PER_CELL * n * n)
        lib_ms = conv2d_library_ms(torch, b, r, 5 if r <= 32 else 1)
        plain = time_ms(torch, lambda: cs.ltl_box_run_turns_plain(
            b, 1, rule), 1)
        policy = cs.ltl_tile(n, n, r)
        for tile, ms in route2_tiles(torch, b, rule, r).items():
            row = dict(shape=f"{n}x{n}", turns=1, radius=r, tile=tile,
                       policy=tile == policy, ms=ms,
                       plain_ms=plain if tile == policy else None,
                       library_ms=lib_ms if tile == policy else None,
                       bound_ms=bound, bound_by=by)
            k7.append(row)
            log_row("ltl_box_run_turns", row)
        f_ms = time_ms(torch, lambda: C._ltl_step(b, rule, "fft"), 5)
        conv_ms = [x["ms"] for x in k7 if x["radius"] == r and x["policy"]]
        fft.append(dict(shape=f"{n}x{n}", radius=r, fft_ms=f_ms,
                        conv_ms=conv_ms[0], library_ms=lib_ms))
        log(f"  conv tier {n}² r={r}: K7 route 2 {conv_ms[0]:.4f} ms, FFT "
            f"tier {f_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms a turn")
    del b
    torch.cuda.empty_cache()
    # Route 1: one launch of LTL_RESIDENT_TURNS turns, beside route 2 at
    # every tile on the same board; its head row (Bosco 512²) with its
    # plain version over the same turns and F.conv2d.
    r1 = []
    k = LTL_RESIDENT_TURNS
    for size in (64, 512, 1024):
        b = soup(torch, size, size, size + 7, dev)
        for r in ROUTE1_RADII if size > 64 else (1, 5):
            ctas = cs.ltl_resident_ctas(size, size, r)
            if not ctas:
                continue
            rule = conv_rule(r)
            ms = time_ms(torch, lambda: cs.ltl_resident_run_turns(
                b, k, rule), 3)
            bound, by = card.bound(2 * size * size,
                                   cs.LTL_OPS_PER_CELL * size * size * k)
            head = size == 512 and r == 5
            plain = (time_ms(torch, lambda: cs.ltl_resident_run_turns_plain(
                b, k, rule), 1) if head else None)
            lib_ms = conv2d_library_ms(torch, b, r, 20) if head else None
            tiles = route2_tiles(torch, b, rule, r)
            row = dict(shape=f"{size}x{size}", turns=k, radius=r, ctas=ctas,
                       ms=ms, turn_ms=ms / k, plain_ms=plain,
                       library_ms=lib_ms, bound_ms=bound, bound_by=by,
                       route2_turn_ms=tiles,
                       route2_policy_tile=cs.ltl_tile(size, size, r))
            r1.append(row)
            log_row("ltl_resident_run_turns", row)
            log(f"    a turn: route 1 {ms / k:.5f} ms; route 2 "
                + ", ".join(f"tile {t} {v:.5f}" for t, v in tiles.items())
                + " ms")
        del b
    torch.cuda.empty_cache()
    # The box crossover on smaller boards: K7 at the gate's route against
    # the FFT tier's turn.
    for size in (512, 1024):
        b = soup(torch, size, size, size, dev, 0.35)
        for r in sorted(set(CONV_RADII) | set(CROSSOVER_RADII)):
            if 2 * r + 1 > size:
                continue
            rule = conv_rule(r)
            route = 1 if cs.ltl_resident_ctas(size, size, r) else 2
            c_ms = k7_launch_ms(torch, b, rule)
            f_ms = time_ms(torch, lambda: C._ltl_step(b, rule, "fft"), 5)
            fft.append(dict(shape=f"{size}x{size}", radius=r, fft_ms=f_ms,
                            conv_ms=c_ms, route=route))
            log(f"  conv tier {size}² r={r}: K7 route {route} {c_ms:.4f} "
                f"ms, FFT tier {f_ms:.4f} ms a turn")
        del b
    torch.cuda.empty_cache()
    # The other kinds' crossover: the direct tier of a circular
    # neighbourhood (F.conv2d of the wrap-padded board, TF32 off, then the
    # rule) against the FFT tier's turn.
    general = []
    for size in (512, 1024, CONV_N):
        b = soup(torch, size, size, size + 1, dev, 0.35)
        for r in GENERAL_RADII:
            if 2 * r + 1 > size or (size == CONV_N and r > GENERAL_MAX_4096):
                continue
            rule = circle_rule(r)
            c_ms = time_ms(torch, lambda: C._ltl_step(b, rule, "conv"), 3)
            f_ms = time_ms(torch, lambda: C._ltl_step(b, rule, "fft"), 5)
            general.append(dict(shape=f"{size}x{size}", radius=r, kind="C",
                                conv2d_ms=c_ms, fft_ms=f_ms))
            log(f"  general tier {size}² r={r} NC: F.conv2d {c_ms:.4f} ms, "
                f"FFT tier {f_ms:.4f} ms a turn")
        del b
    torch.cuda.empty_cache()
    engine = []
    for size, rule in ((512, BOSCO), (CONV_N, BOSCO), (1024, ORBIUM)):
        if rule is ORBIUM:
            world = seed_board(size, size, 3, ORBIUM)
        else:
            world = ((np.random.default_rng(size).random((size, size))
                      < 0.4) * 255).astype(np.uint8)
        rate, poll_us, gap, chunk = engine_rate(torch, world, 3.0, rule)
        engine.append(dict(size=size, rule=rule.rulestring, card=card.smi,
                           turns_per_s=rate,
                           cell_updates_per_s=rate * size * size,
                           alive_count_us=poll_us, max_publish_gap_s=gap,
                           chunk_turns=chunk))
        log(f"  engine {rule.rulestring} {size}²: {rate:.1f} turns/s "
            f"({rate * size * size:.4g} cell updates/s), alive_count() "
            f"{poll_us:.2f} µs median, publications at most {gap:.3f} s "
            f"apart, chunk {chunk} turns")
    log("conv:" + json.dumps({"fft_vs_conv": fft, "general": general,
                              "engine": engine}))
    return k7, r1, fft, general, engine


def conv2d_library_ms(torch, b, r: int, reps: int) -> float:
    """ms of the library call that computes K7's box counts on the board
    `b`: F.conv2d of the wrap-padded float32 board with a (2r+1)² ones
    kernel, TF32 off (`reps` calls after one warm-up)."""
    n = b.shape[0]
    ones = torch.ones((1, 1, 2 * r + 1, 2 * r + 1), device=b.device)
    idx = torch.arange(-r, n + r, device=b.device) % n
    padded = b.float().index_select(0, idx).index_select(1, idx)[None, None]

    def library():
        with torch.backends.cudnn.flags(
                enabled=True, benchmark=False, deterministic=False,
                allow_tf32=False):
            return torch.nn.functional.conv2d(padded, ones)

    ms = time_ms(torch, library, reps)
    del padded, ones
    torch.cuda.empty_cache()
    return ms


def k7_records(card: Card, launches: dict, timing: tuple) -> list:
    """K7's two entries of the kernels line: route 2 (head row: Bosco's
    r = 5 at 4096², the policy's tile) and route 1, K7's redesign for
    boards that fit a cluster (head row: Bosco 512², one launch of
    LTL_RESIDENT_TURNS turns; its library call is one F.conv2d, a turn's
    counts)."""
    k7, r1, fft, general, conv_engine = timing
    head2 = [r for r in k7 if r["radius"] == 5 and r["policy"]][0]
    head1 = [r for r in r1 if r["shape"] == "512x512" and r["radius"] == 5][0]
    out = []
    for name, head, rows, extra in (
            ("ltl_box_run_turns", head2, k7,
             dict(fft_tier=fft, general_tier=general, engine=conv_engine)),
            ("ltl_resident_run_turns", head1, r1,
             dict(redesign_of="ltl_box_run_turns (K7)", library_turns=1))):
        out.append(dict(
            name=name, route="cuda", source="gol_tpu_torch/csrc/stencil.cu",
            family=None, replaces="gol_tpu/ops/conv.py:218",
            launches=launches[name], bit_exact=MAX_ABS_ERR[name] == 0,
            max_abs_err=MAX_ABS_ERR[name], card=card.smi,
            shape=head["shape"], turns=head["turns"], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            by_shape=rows, **extra))
    return out


def timing_k3_trace(torch, dev, card: Card) -> list:
    """K3 (`row_popcounts`) at 512², 5120² and 65536²: its device time a
    launch under `torch.profiler` (the kernel's own span, summed over the
    calls), beside the wrapper's host time a call (no synchronisation
    between calls) and CUDA events around the Python calls (how phase 5
    times every kernel)."""
    from torch.profiler import ProfilerActivity, profile

    from gol_tpu_torch.ops import cuda_stencil as cs

    rows = []
    for h, wp in ((512, 16), (5120, 160), (65536, 2048)):
        w = seeded_words(torch, h, wp, h + 3, dev)
        calls = 50 if h == 65536 else 200
        cs.row_popcounts(w)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            cs.row_popcounts(w)
        host_us = (time.perf_counter() - t0) / calls * 1e6
        torch.cuda.synchronize()
        events_ms = time_ms(torch, lambda: cs.row_popcounts(w), calls)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                cs.row_popcounts(w)
            torch.cuda.synchronize()
        spans = [e for e in prof.key_averages()
                 if "row_popcounts_kernel" in e.key]
        device_ms = None
        if spans:
            us = getattr(spans[0], "self_device_time_total",
                         getattr(spans[0], "self_cuda_time_total", 0))
            device_ms = us / 1e3 / max(spans[0].count, 1)
        bound, by = card.bound(h * wp * 4 + h * 4, 0)
        rows.append(dict(shape=f"{h}x{h}",
                         words=wp, calls=calls,
                         device_ms=device_ms if device_ms else
                         "not measured", host_us_per_call=host_us,
                         events_ms_per_call=events_ms, bound_ms=bound,
                         bound_by=by))
        log(f"  K3 {h}² under torch.profiler: "
            + (f"{device_ms:.5f} ms a launch" if device_ms else
               "no device time")
            + f"; wrapper {host_us:.2f} µs of host a call; CUDA events "
            f"{events_ms:.5f} ms a call; bound {bound:.5f} ms ({by})")
        del w
    torch.cuda.empty_cache()
    return rows


# ------------------------------------------------ phase 4g: sparse torus

SPARSE_SIZE = 1 << 20
SPARSE_TURNS = 8192        # the JAX bench's sparse leg (bench.py:58)
SPARSE_LONG_TURNS = 65536
# From turn 1103 on the R-pentomino is still lifes, blinkers and six free
# gliders: 116 cells (LifeWiki), on any torus its light cone never wraps.
SPARSE_STABLE_TURN = 1103
SPARSE_STABLE_ALIVE = 116
SPARSE_RESTORE_TURNS = 1024
# The dense comparator: 3 + 2 x 8192 = 16,387 cells of light cone never
# wrap a 32768² torus (128 MiB packed, K2 sweeps).
SPARSE_DENSE = 32768
# K8 at the window ladder's shapes (rows, words), and an odd one.
OCC_SHAPES = ((256, 64), (768, 64), (10240, 384), (38656, 1280), (1000, 77))
# Phase 4g's figures and final window, for K8's timing and record.
SPARSE_STATS: dict = {}


def phase_kernels_occupancy(torch, dev) -> None:
    """K8 against its plain version on the card, bit-exact: random words
    (every bit pattern, the sign bit included) at OCC_SHAPES, a row of
    all-ones words and sign-bit-only words, and a mostly empty window
    (the zero counts K8 skips)."""
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 3: K8 (window_occupancy) against its plain version "
        "(bit-exact)")
    for h, wp in OCC_SHAPES:
        w = seeded_words(torch, h, wp, h + 3 * wp, dev)
        w[0] = -1
        w[-1, ::3] = -2**31
        check_equal(torch, f"K8 {h}x{wp} words, random",
                    cs.window_occupancy(w), cs.window_occupancy_plain(w),
                    "window_occupancy")
        sparse = torch.zeros_like(w)
        sparse[h // 2, wp // 3] = -2**31 + 5
        sparse[h - 1, wp - 1] = 7
        check_equal(torch, f"K8 {h}x{wp} words, two live words",
                    cs.window_occupancy(sparse),
                    cs.window_occupancy_plain(sparse), "window_occupancy")
        del w, sparse


def word_cells(rows, cols, words, ox: int, oy: int, size: int) -> set:
    """Torus cells (x, y) of the np.uint32 `words` found at (rows, cols)
    of a window whose cell (0, 0) lies at (ox, oy) on the torus."""
    cells = set()
    for r, c, v in zip(rows.tolist(), cols.tolist(), words.tolist()):
        for j in range(32):
            if v >> j & 1:
                cells.add(((ox + 32 * c + j) % size, (oy + r) % size))
    return cells


def sparse_cells(words, ox: int, oy: int, size: int) -> set:
    """Torus cells of a window of np.uint32 words at origin (ox, oy)."""
    rows, cols = np.nonzero(words)
    return word_cells(rows, cols, words[rows, cols], ox, oy, size)


def window_cells(window, size: int) -> set:
    """Torus cells of a (pixels, (ox, oy), turn) window."""
    pix, (ox, oy), _ = window
    ys, xs = np.nonzero(pix)
    return {((int(x) + ox) % size, (int(y) + oy) % size)
            for x, y in zip(xs, ys)}


def sparse_reference(torch, dev) -> None:
    """Phase 4g's comparator, run before the phase's counters and its
    profile start: the R-pentomino for 8192 turns on a dense 32768² board
    through the packed path (K2 sweeps, 128 MiB), its cells mapped to
    where the sparse engines stamp the seed on the 2^20 torus."""
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.models.sparse import R_PENTOMINO
    from gol_tpu_torch.ops import bitpack
    from gol_tpu_torch.parallel.halo import packed_run_turns

    n, turns = SPARSE_SIZE, SPARSE_TURNS
    off = (n - 3) // 2  # where the engines stamp a 3 x 3 seed board
    d, doff = SPARSE_DENSE, SPARSE_DENSE // 2 - 1
    words = np.zeros((d, d // 32), dtype=np.uint32)
    for x, y in R_PENTOMINO:
        words[y + doff, (x + doff) // 32] |= np.uint32(1 << ((x + doff) % 32))
    dense = bitpack.words_from_numpy(words, dev)
    del words
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense = packed_run_turns(dense, turns, CONWAY)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    live = torch.nonzero(dense)
    SPARSE_STATS["want"] = word_cells(
        live[:, 0].cpu().numpy(), live[:, 1].cpu().numpy(),
        bitpack.words_to_numpy(dense[live[:, 0], live[:, 1]]),
        off - doff, off - doff, n)
    SPARSE_STATS["dense"] = dict(size=d, turns=turns,
                                 turns_per_s=turns / secs)
    del dense, live
    torch.cuda.empty_cache()
    log(f"phase 4g: the dense comparator {d}² x {turns} (K2): "
        f"{turns / secs:.1f} turns/s, {len(SPARSE_STATS['want'])} cells")


def phase_sparse(torch, dev) -> None:
    """The sparse torus on the card: the R-pentomino on the 2^20 torus
    for 8192 turns through `SparseTorus` against the dense comparator
    (`sparse_reference`), then the same run through
    `gol_tpu_torch.run(..., sparse=True)`, the CLI and SER to a
    `--sparse` server subprocess (its GetWindow against the in-process
    engine's), each to the same torus cells; 65,536 turns through
    `SparseEngine`, every published count from turn 1103 on equal to 116;
    and a checkpoint of that engine restored into a fresh one, 1024 more
    turns on both to equal cells."""
    from gol_tpu_torch import Params, distributor
    from gol_tpu_torch import events as ev
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.io.pgm import write_pgm
    from gol_tpu_torch.models.sparse import R_PENTOMINO, SparseTorus
    from gol_tpu_torch.sparse_engine import SparseEngine

    log("phase 4g: the sparse torus (R-pentomino on the 2^20 torus)")
    n, turns = SPARSE_SIZE, SPARSE_TURNS
    off = (n - 3) // 2  # where the engines stamp a 3 x 3 seed board
    seed = np.zeros((3, 3), dtype=np.uint8)
    for x, y in R_PENTOMINO:
        seed[y, x] = 255
    want = SPARSE_STATS.pop("want")

    # a. The dense comparator's turns on the sparse torus.
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torus = SparseTorus(n, [(x + off, y + off) for x, y in R_PENTOMINO])
    torus.run(turns)
    alive = torus.alive_count()
    secs = time.perf_counter() - t0
    got = set(torus.alive_cells())
    if got != want or alive != len(want):
        raise AssertionError(f"SparseTorus {turns} turns: {len(got)} cells "
                             f"({alive} counted) != the dense run's "
                             f"{len(want)}")
    h, w = torus.window_shape()
    SPARSE_STATS["torus"] = dict(
        turns=turns, turns_per_s=turns / secs, seconds=secs, window=[h, w],
        margin_fetches=torus.margin_fetches, grows=torus.grows,
        alive=alive)
    log(f"  ok SparseTorus 2^20 x {turns}: {len(got)} cells equal the "
        f"dense run's; {turns / secs:.1f} turns/s ({secs:.3f} s), window "
        f"{h} x {w} cells, {torus.margin_fetches} episodes (margin "
        f"fetches), {torus.grows} grows")
    del torus

    # b. The same run through run(sparse=True), the CLI and SER. A fixed
    # chunk ladder (GOL_CHUNK_TARGET far above any chunk) gives the
    # in-process engine and the server's the same episodes, and so the
    # same window.
    pinned = {"GOL_CHUNK_TARGET": "1000"}
    with tempfile.TemporaryDirectory() as tmp:
        seed_dir = os.path.join(tmp, "images")
        write_pgm(os.path.join(seed_dir, "seed.pgm"), seed)
        p = Params(image_width=n, image_height=n, turns=turns)
        os.environ.update(pinned)
        distributor._default_sparse.clear()
        try:
            t0 = time.perf_counter()
            evs, _ = drive(p, seed_dir, os.path.join(tmp, "run"),
                           sparse=True)
            run_s = time.perf_counter() - t0
        finally:
            os.environ.pop("GOL_CHUNK_TARGET", None)
        final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
        if final.completed_turns != turns or set(final.alive) != want:
            raise AssertionError("run(sparse=True): final cells != the "
                                 "dense run's")
        eng = next(iter(distributor._default_sparse.values()))
        window = eng.get_window()
        log(f"  ok run(sparse=True) 2^20 x {turns}: final cells equal "
            f"({run_s:.2f} s with its PGM)")

        ck = os.path.join(tmp, "cli_ckpt")
        cli = subprocess.run(
            [sys.executable, "-m", "gol_tpu_torch", "-w", str(n), "-h",
             str(n), "--sparse", "--rle", "rpentomino", "--turns",
             str(turns), "--headless", "--checkpoint", ck, "--ckpt-every",
             str(turns)], capture_output=True, text=True, timeout=600,
            stdin=subprocess.DEVNULL, cwd=tmp,
            env=dict(os.environ, PYTHONPATH=REPO,
                     GOL_OUT=os.path.join(tmp, "cli")))
        if cli.returncode != 0:
            raise AssertionError(f"CLI --sparse exit {cli.returncode}: "
                                 f"{cli.stderr[-2000:]}")
        from gol_tpu_torch.ckpt import manifest as mf

        turn, path, m = mf.latest_checkpoint(ck)
        with np.load(mf.payload_path(path, m)) as z:
            cli_cells = sparse_cells(z["sparse_words"], int(z["ox"]),
                                     int(z["oy"]), n)
        pgms = os.listdir(os.path.join(tmp, "cli"))
        if turn != turns or cli_cells != want or not any(
                f.endswith(f"x{turns}.pgm") for f in pgms):
            raise AssertionError(f"CLI --sparse: turn {turn}, "
                                 f"{len(cli_cells)} cells, PGMs {pgms}")
        log(f"  ok CLI --sparse --rle rpentomino --turns {turns}: its "
            f"final checkpoint's cells equal the dense run's ({pgms[0]})")

        proc, port = spawn_server(0, "--sparse", str(n), env=pinned)
        try:
            os.environ["SER"] = f"127.0.0.1:{port}"
            try:
                evs, _ = drive(p, seed_dir, os.path.join(tmp, "ser"),
                               sparse=True)
            finally:
                os.environ.pop("SER", None)
            final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)][0]
            remote = RemoteEngine(f"127.0.0.1:{port}").get_window()
        finally:
            stop_server(proc)
        if (set(final.alive) != want or remote[1:] != window[1:]
                or not np.array_equal(remote[0], window[0])):
            raise AssertionError(
                f"SER --sparse: window {remote[0].shape} at {remote[1]} "
                f"turn {remote[2]} != the in-process engine's "
                f"{window[0].shape} at {window[1]} turn {window[2]}")
        log(f"  ok SER to a --sparse server: final cells equal; GetWindow "
            f"{remote[0].shape[1]} x {remote[0].shape[0]} at {remote[1]} "
            "equals the in-process engine's pixels and origin")
        distributor._default_sparse.clear()
        del eng, window, remote

    # c. 65,536 turns through SparseEngine; every publication recorded.
    eng = SparseEngine(n)
    pubs = []
    publish = eng._publish_locked

    def record(alive=None):
        publish(alive)
        pubs.append((eng._pub[3], eng._pub[4]))

    eng._publish_locked = record
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.server_distributor(Params(image_width=n, image_height=n,
                                  turns=SPARSE_STABLE_TURN), seed)
    stable, at = eng.alive_count()
    eng.server_distributor(
        Params(image_width=n, image_height=n,
               turns=SPARSE_LONG_TURNS - SPARSE_STABLE_TURN), None,
        start_turn=SPARSE_STABLE_TURN)
    long_s = time.perf_counter() - t0
    late = [(t, a) for t, a in pubs if t >= SPARSE_STABLE_TURN]
    bad = [(t, a) for t, a in late if a != stable]
    if (at != SPARSE_STABLE_TURN or stable != SPARSE_STABLE_ALIVE or bad
            or late[-1][0] != SPARSE_LONG_TURNS):
        raise AssertionError(f"{SPARSE_LONG_TURNS} turns: {stable} alive at "
                             f"turn {at}; publications off it: {bad[:5]}")
    torus = eng._torus
    h, w = torus.window_shape()
    SPARSE_STATS["long"] = dict(
        turns=SPARSE_LONG_TURNS, turns_per_s=SPARSE_LONG_TURNS / long_s,
        seconds=long_s, window=[h, w], margin_fetches=torus.margin_fetches,
        grows=torus.grows, publications=len(pubs), alive=stable)
    SPARSE_STATS["final_words"] = torus._packed
    log(f"  ok SparseEngine 2^20 x {SPARSE_LONG_TURNS}: {len(late)} "
        f"publications from turn {SPARSE_STABLE_TURN} on all count "
        f"{stable}; {SPARSE_LONG_TURNS / long_s:.1f} turns/s ({long_s:.3f} "
        f"s), window {h} x {w} cells ({h * w // 8 / 2**20:.1f} MiB "
        f"packed), {torus.margin_fetches} episodes, {torus.grows} grows")

    # d. A checkpoint of that engine restored into a fresh one.
    with tempfile.TemporaryDirectory() as tmp:
        path, turn = eng.checkpoint_now(tmp)
        fresh = SparseEngine(n)
        if fresh.restore_run(path) != turn or fresh.get_window()[1:] != \
                eng.get_window()[1:]:
            raise AssertionError("sparse checkpoint: restored window != "
                                 "the engine's")
        more = Params(image_width=n, image_height=n,
                      turns=SPARSE_RESTORE_TURNS)
        for e in (eng, fresh):
            e.server_distributor(more, None, start_turn=turn)
        a, b = eng.get_window(), fresh.get_window()
        if (a[2] != b[2] or window_cells(a, n) != window_cells(b, n)
                or eng.alive_count() != fresh.alive_count()):
            raise AssertionError("sparse checkpoint: restored engine's "
                                 f"{SPARSE_RESTORE_TURNS} turns differ")
    log(f"  ok checkpoint_now at turn {turn} restored into a fresh engine; "
        f"{SPARSE_RESTORE_TURNS} more turns on both: equal cells")
    log("sparse:" + json.dumps({k: v for k, v in SPARSE_STATS.items()
                                if k != "final_words"}))


def timing_occupancy(torch, dev, card: Card) -> list:
    """K8 per launch at OCC_SHAPES on random words, and on the final
    window of phase 4g's 65,536-turn run (its head row), beside its plain
    version and its byte bound: (H Wp + H + Wp) x 4 bytes."""
    from gol_tpu_torch.ops import cuda_stencil as cs

    rows = []
    cases = [(f"{h}x{wp} random", seeded_words(torch, h, wp, 9, dev))
             for h, wp in OCC_SHAPES]
    final = SPARSE_STATS.pop("final_words", None)
    if final is not None:
        cases.append(("final window", final))
    for what, w in cases:
        h, wp = w.shape
        b, by = card.bound(4 * h * wp + 4 * (h + wp), 4 * h * wp)
        row = dict(shape=f"{h}x{wp * 32}", words=[h, wp], data=what,
                   turns=0, ms=time_ms(torch, lambda: cs.window_occupancy(w),
                                       20),
                   plain_ms=time_ms(torch,
                                    lambda: cs.window_occupancy_plain(w), 2),
                   bound_ms=b, bound_by=by, library_ms=None)
        rows.append(row)
        log_row("window_occupancy", row)
    del cases, final
    torch.cuda.empty_cache()
    return rows


def k8_record(card: Card, launches: dict, rows: list) -> dict:
    """K8's entry of the kernels line (head row: the final window of the
    65,536-turn sparse run)."""
    head = [r for r in rows if r["data"] == "final window"][0]
    return dict(
        name="window_occupancy", route="cuda",
        source="gol_tpu_torch/csrc/stencil.cu", family=None,
        replaces="gol_tpu/models/sparse.py:106",
        launches=launches["window_occupancy"],
        bit_exact=MAX_ABS_ERR["window_occupancy"] == 0,
        max_abs_err=MAX_ABS_ERR["window_occupancy"], card=card.smi,
        shape=head["shape"], turns=0, ms=head["ms"],
        plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
        bound_by=head["bound_by"], library_ms=None, by_shape=rows,
        sparse={k: v for k, v in SPARSE_STATS.items()})


def main_path_launches(cs) -> dict:
    """Launches per kernel on the main path; the two-plane kernels per
    family, as `name/family`."""
    launches = {fn.__name__: fn.launches for fn in cs.KERNELS
                if fn not in cs.KERNELS_2P}
    for fn in cs.KERNELS_2P:
        for fam, n in fn.by_family.items():
            launches[f"{fn.__name__}/{fam}"] = n
    return launches


# Device kernel names (as the profiler reports them, without
# "(anonymous namespace)::") of each wrapper.
KERNEL_SYMBOLS = (
    ("resident_kernel<Life,", "resident_run_turns"),
    ("tiled_kernel<Life, 1,", "tiled_sweep"),
    ("tiled_kernel<Life, 2,", "tiled_sweep_deep"),
    ("row_popcounts_kernel", "row_popcounts"),
    ("resident_kernel<Gen3,", "resident_run_turns2p/gen3"),
    ("resident_kernel<Gen4,", "resident_run_turns2p/gen4"),
    ("tiled_kernel<Gen3,", "tiled_sweep2p/gen3"),
    ("tiled_kernel<Gen4,", "tiled_sweep2p/gen4"),
    ("ltl_tile_kernel", "ltl_box_run_turns"),
    ("ltl_resident_kernel", "ltl_resident_run_turns"),
    ("window_occupancy_kernel", "window_occupancy"),
)


def device_ms_by_kernel(prof) -> dict:
    """Device ms per wrapper (and "other": the plain versions and copies
    the phases run on the card) summed from a profile's key_averages();
    empty when the profiler saw no device time."""
    sums: dict = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0))
        if not us:
            continue
        key = evt.key.replace("(anonymous namespace)::", "")
        name = next((n for sym, n in KERNEL_SYMBOLS if sym in key), "other")
        sums[name] = sums.get(name, 0.0) + us / 1e3
    return sums


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to check",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from torch.profiler import ProfilerActivity, profile

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
    frames = stack_frames(rec["log"])
    log("  stack frames (bytes): " + json.dumps(frames))
    if any(frames.values()):
        raise AssertionError(f"kernels with a stack frame: {frames}")
    for name, loop in step_loops(rec["path"]).items():
        log(f"  sass stepping loop of {name}: {json.dumps(loop)}")
    phase_kernels(torch, dev)
    phase_kernels_ltl(torch, dev)
    phase_kernels_occupancy(torch, dev)
    sparse_reference(torch, dev)
    # Each path runs with the counters at 0 and is read just after; each
    # must have launched every kernel (and family) it runs. The profiler
    # sums the device time of the profiled paths by kernel.
    launches, device_ms, profiled = {}, {}, {}
    for phase, kernels, prof_on in (
            (phase_main_path, ("resident_run_turns", "tiled_sweep",
                               "row_popcounts"), True),
            (phase_controls, ("resident_run_turns", "row_popcounts"), False),
            (phase_generations, ("row_popcounts",
                                 "resident_run_turns2p/gen3",
                                 "resident_run_turns2p/gen4",
                                 "tiled_sweep2p/gen3",
                                 "tiled_sweep2p/gen4"), True),
            (phase_fused, ("tiled_sweep_deep", "tiled_sweep",
                           "row_popcounts"), True),
            (phase_control_plane, ("resident_run_turns", "tiled_sweep",
                                   "row_popcounts",
                                   "resident_run_turns2p/gen3"), False),
            (phase_checkpoints, ("resident_run_turns", "tiled_sweep",
                                 "row_popcounts",
                                 "tiled_sweep2p/gen3"), False),
            (phase_conv, ("ltl_resident_run_turns", "ltl_box_run_turns"),
             True),
            (phase_sparse, ("resident_run_turns", "tiled_sweep",
                            "window_occupancy"), True)):
        cs.reset_launch_counts()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if prof_on
              else contextlib.nullcontext()) as prof:
            phase(torch, dev)
            torch.cuda.synchronize()
        counts = main_path_launches(cs)
        log(f"  {phase.__name__} launches: {counts}")
        for name in kernels:
            if counts[name] <= 0:
                raise AssertionError(f"{phase.__name__} never launched "
                                     f"{name}")
        for name, n in counts.items():
            launches[name] = launches.get(name, 0) + n
            if prof_on:
                profiled[name] = profiled.get(name, 0) + n
        if prof_on:
            mine = device_ms_by_kernel(prof)
            log(f"  {phase.__name__} device ms by kernel: "
                + (json.dumps(mine) if mine else "not measured"))
            for name, ms in mine.items():
                device_ms[name] = device_ms.get(name, 0.0) + ms
        del prof
    log("  main-path device ms by kernel (torch.profiler): "
        + (json.dumps(device_ms) if device_ms else "not measured"))
    log(f"  launches in the profiled phases: {json.dumps(profiled)}")
    phase_conv_checks(torch, dev)
    phase_control_plane_measure(torch, dev, card)
    phase_checkpoint_measure(torch, dev, card)
    kernels = phase_timing(torch, dev, card, launches)
    kernels += k7_records(card, launches, timing_ltl(torch, dev, card))
    k3 = [k for k in kernels if k["name"] == "row_popcounts"][0]
    k3["trace"] = timing_k3_trace(torch, dev, card)
    k3["profiled_launches"] = profiled.get("row_popcounts", 0)
    kernels.append(k8_record(card, launches,
                             timing_occupancy(torch, dev, card)))
    for k in kernels:
        k["main_path_device_ms"] = device_ms.get(
            k["name"], 0.0 if device_ms else "not measured")
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
