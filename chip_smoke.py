#!/usr/bin/env python3
"""Chip smoke for gol_tpu_torch: the quickest proof that the port builds,
is right and runs its main path on one CUDA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; any failure exits non-zero):

1. the card (nvidia-smi name and power limit, max SM clock), torch, CUDA;
2. the nvcc build of gol_tpu_torch/csrc/stencil.cu, with the g++ build
   of the host layer gol_tpu_torch/csrc/golnative.cpp beside it (the run
   fails if either fails): ptxas registers and
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
   1,280 words and an odd 1000 x 77; K9 (the fleet's batched step),
   words and per-slot popcounts, at 8 and 512 slots of 512², 2 of 64²,
   the private 24 x 96 bucket and 8 slots of 1024² and 2048² (route 1;
   route 2 pinned beside the last two) and 2 of 4096² (route 2) for 8,
   32, 40 and 512 turns, route 1 at every CTA count a slot takes and
   route 2 pinned on 512² slots; the counted launches (`count=`: the
   engine's alive count rides a chunk's last stepping launch), board and
   count against the plain board and popcount: K1 at N = 1 and 16, K2 at
   each R, K6 at depth 64, B3 at k = 48, K4 and K5 for gen3, and a 65536²
   all-ones board under B3/S012345678 counting exactly 2^32 cells on K2
   and K6 (a 32-bit counter would wrap);
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
   4h. the fleet: a `python -m gol_tpu_torch.server --fleet` subprocess
   serves the 16², 64² and 512² goldens x 100 to a controller through
   SER, the 24 x 24 board through its private bucket (the dense engine's
   board) and 50 legacy drives beside a client that creates and destroys
   runs (each at its target turn with the oracle's board); then the
   fleet RPCs (CreateRun, ListRuns, AttachRun with a run-scoped GetWorld,
   SetRule, DestroyRun) through the port's client to an in-process
   --fleet server, a run of each class (512², 1024², 2048²) to a turn
   the 8-turn quantum does not divide against a `packed_run_turns`
   replay (K9 route 1 alone: route 2 must not launch; the trims on K1
   and K2), then a 4096² class, beyond a cluster, to turn 13 on route 2.
   4i. the broadcast tier and the telemetry surface: the JAX bench's
   broadcast leg (`bench.py:2276-2495`) on a free-running 64² fleet run
   (chunk 2, K9 route 1) behind an in-process server, 1000 Subscribe
   viewers (clamped to RLIMIT_NOFILE; 2 decoding, the rest drained
   unread) over a 3 s window: exactly 1.0 encode call per published
   frame, frames published, fan-out recorded, and after a pause and a
   forced publish a decoded frame equal to a fresh GetView at that turn;
   then a served CUDA engine at 512² (K1) and 5120² (K2): a run with no
   subscriber publishes no frame and starts no hub; two subscribers at
   2^20 cells see every frame of a 100 / 1000-turn drive equal the view
   of the plain board at its turn (512²: check/'s boards at turns 0 and
   100 and the CSV's count); the engine's turns/s with both attached;
   and the view's device ms a publication (CUDA events around
   `get_view`), there and at 65536², where `poll_device_memory` names
   the card as nvidia-smi does and counts the 512 MiB board live; last,
   a `python -m gol_tpu_torch.server --metrics-port --profile-dir`
   subprocess (a fresh process: this one's profiled windows leave later
   `torch.profiler` sessions without device events) takes a Profile RPC
   of 64 turns on each of the two drives, whose status reaches "ok",
   whose Chrome trace names K1 or K2 and around which every published
   pair equals the CSV or the plain count, then serves a subscriber,
   GetTelemetry, GetAudit and GetUsage, and the gol_bcast_* families on
   /metrics.
   4j. migration and federation: `python -m gol_tpu_torch.server --fleet
   --checkpoint ROOT --ckpt-every 4 --federate ROUTER` member processes
   on the card (each beside a thread that writes its launch counts to a
   file, merged into the phase's) behind the port's in-process
   `FederationRouter`. The JAX bench's federation leg
   (`bench.py:2657-2910`): 3 members, 6 seeded 64² runs created through
   the router and parked at turn 32, a 2 s window of routed Stats, then
   `kill_member` picks the owner of run 0 and it is SIGKILLed; the router
   declares it dead (gol_fed_failovers_total moves by 1, /healthz shows
   one death), adopts its runs onto the survivors from the shared root,
   and every run reads back at turn 32 equal to the numpy replay of its
   seed (availability_pct, failover_downtime_p99_ms,
   router_overhead_p99_ms). The migration leg (`bench.py:3115-3497`): 3
   members (GOL_FLEET_BUCKETS with 4096), one armed with
   GOL_CHAOS=migrate_fail=transfer, 8+ seeded 64² runs parked at turn
   24: the armed member's first Rescale rolls back (the run intact on its
   source, routable, migrated on the next try), four runs ping-pong
   between the clean members, every board equal to the numpy replay;
   then the real sizes: a 2048² run (K9 route 1) and a 4096² run (K9
   route 2), each free-running toward its target turn and Rescaled
   mid-flight, end at the target with the board and alive count of an
   unmigrated control run in this process (K9), itself equal to K9's
   plain version, with each phase's wall ms, the bytes transferred and
   the downtime; last, `kill_member@migrating` SIGKILLs a Rescale's
   source mid-cutover and exactly one listed copy of its run remains
   (migration_downtime_p99_ms, availability_pct, gol_migrations_total by
   status). The card's memory in use before and with three members.
   4k. row sharding on meshes of cuda:0 (`log_mesh_summary`).
   4l. fleet mesh placement and sharded sparse windows on meshes of
   cuda:0: a batch bucket of 64 512² runs over 4 positions and one of 8
   1024² runs over 2, each held quantum by quantum against a one-device
   bucket and K1/K2 on every board, and free-running fleets of each beside
   the unsharded fleet; a 2048² class over 4 with
   GOL_FLEET_MIN_SLOTS_PER_DEV making it spatial: exact targets (a trim
   through the sharded path), a quarantine restored from its cadence
   checkpoint and a `migrate_quiesce` readback against K2, each new
   window's first K9 launch against `fleet_run_turns_plain` with its
   counted box (`spatial_windows` in the kernels line); the R-pentomino
   on the 2^20 torus for 65,536 turns through SparseEngine unsharded and
   over 2 and 4, every publication, the window, grows, episodes and cells
   equal; `Engine.stats()["chunk_overhead_us"]` at 512² and 5120²
   against its gauge. Each rate beside the unsharded one and the card.
   4m. the live view and the native host layer: the port's C++ codec
   (`gol_tpu_torch/csrc/golnative.cpp`, built with g++ at first use; the
   run fails if it does not build) reads the 512² golden and a seeded
   5120² board, and writes them byte-equal to the numpy path, and phase
   4's goldens must have been read by it alone (the codec counter); an
   unbounded 512² `run(..., live_view=True)` on a CUDA engine (K1) for
   3 s and until it has drawn 12 frames (30 s at most), its events
   consumed by `sdl.loop.start` into a window whose every frame at
   TurnComplete(t) counts the CSV's alive cells (t <= 10,000) or
   the settled ash's (`fixtures.ash_512_alive`), at least 10 frames, the
   last equal to the host oracle's board (`native.step_torus`), every
   polled pair and ticker event exact, each poll traced (its host ms
   beside when the engine's stream drained and when its turn was
   published); the same at GOL_CHUNK_TARGET=0.025 for 3 s; a 5120² glider
   lattice (K2), unbounded, drained by `sdl.loop.start` into the
   view-sized window it opens, every frame the lattice's view at its turn
   and at least 5 frames with diffs; a 5120² live run of 1000 turns (K2),
   paused at its start so frames arrive, every frame `get_view`'s
   downsampled shape within GOL_LIVE_MAX_CELLS and no world read, the
   first frame the plain board's view, the final PGM the plain version's;
   each live run's own K1 or K2 launches above 0; and
   `native.render_halfblocks` of a 512² frame against the numpy glyphs,
   with host ms of each codec and renderer.
   Each path runs with the launch counters at 0, read just after: every
   kernel (and family) it runs must have launched, and the paths whose
   alive counts come from chunks alone (4, 4c, 4d) must have launched K3
   no time. The paths of 4-4c, 4f
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
   then phase 4h's measurements, the JAX bench's fleet leg
   (`bench.py:1774-1782,1843-1856`): 1, 64 and 512 free-running 512²
   runs in one FleetEngine over 3 s each (aggregate cell updates/s, p50
   and p99 per-run turn latency, chunk_overhead_us, K9's device ms a
   quantum under `torch.profiler`, one run's board against a K1 replay
   of its seed), a wire-driven single 512² run (one ServerDistributor a
   turn) as its comparator, and K9 a quantum by CUDA events at the
   leg's and phase 3's buckets beside its bound and its plain version;
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
   5, beside route 2 at every tile and one F.conv2d turn (TF32 off); K7 at the gate's route against the FFT tier
   at 512² and 1024² up to r = 128 (the box crossover); the direct tier
   of a circular neighbourhood (F.conv2d, TF32 off) against the FFT tier
   at 512², 1024² and 4096² (the other kinds' crossover); engine turns/s
   for Bosco at 512² and 4096² and Orbium at 1024²; and K8 at the window
   ladder's shapes and on the 65,536-turn run's final window, beside its
   plain version and its byte bound; the engine's chunk token at 512² (1
   and 1024 turns), 5120² and 65536² (32), the old sequence (stepping,
   K3, the torch sum) against the counted launch, CUDA-event ms and host
   µs a chunk, and each stepping kernel's head row counted beside
   uncounted; K9's host µs a call beside its event ms, at every timed
   bucket (route 2 pinned at 1024² and 2048²), and K9 route 1's device
   µs a quantum at every CTA count a slot takes, 1-64 slots of 1024² and
   2048², beside route 2 pinned.

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
import signal
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


def check_count(what: str, got, want, kernel: str) -> None:
    """A counted launch's one int64 against its plain count, exactly (no
    32-bit mask: a counter that wrapped at 2^32 must fail)."""
    got, want = int(got.item()), int(want)
    err = abs(got - want)
    MAX_ABS_ERR[kernel] = max(MAX_ABS_ERR.get(kernel, 0), err)
    if err:
        raise AssertionError(f"{what}: count {got} != {want}")
    log(f"  ok {what}: {got} cells")


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


def plain_count(torch, words) -> int:
    """The live cells of a board (of plane 0 of stacked planes) by the
    plain popcount."""
    from gol_tpu_torch.ops import bitpack

    plane = words[0] if words.dim() == 3 else words
    return int(bitpack.row_popcounts_plain(plane).sum(dtype=torch.int64))


def phase_kernels_counted(torch, dev) -> None:
    """The counted launches (`count=`: the alive count rides a chunk's
    last stepping launch) bit-exact against their plain boards and plain
    counts: K1 at N = 1 and 16, K2 at each R, K6 at depth 64, B3 at k =
    48, K4 and K5 for gen3; and a 65536² all-ones board under
    B3/S012345678 (which leaves it all ones) counting exactly 2^32 cells,
    on K2 and K6: a 32-bit counter would wrap there."""
    from gol_tpu_torch.models.generations import GenerationsRule
    from gol_tpu_torch.models.lifelike import LifeLikeRule
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 3: counted launches against their plain boards and counts")

    def count():
        return torch.full((1,), -1, dtype=torch.int64, device=dev)

    for (h, wp) in [(512, 16), (64, 2), (33, 1)]:
        w = seeded_words(torch, h, wp, 17 * h + wp, dev)
        for n in sorted({1, min(16, h)}):
            for turns in (1, 100):
                c = count()
                got = cs.resident_run_turns(w, turns, ctas=n, count=c)
                what = f"K1 counted {h}x{wp}w N={n} {turns} turns"
                check_equal(torch, what, got, cs.resident_run_turns_plain(
                    w, turns, ctas=n), "resident_run_turns")
                check_count(what, c, plain_count(torch, got),
                            "resident_run_turns")
    for (h, wp) in [(5120, 160), (1000, 200), (7, 5)]:
        w = seeded_words(torch, h, wp, 19 * h + wp, dev)
        for r in cs.TILE_ROW_CHOICES:
            out, c = torch.empty_like(w), count()
            cs.tiled_sweep(w, out, 32, rows=r, count=c)
            what = f"K2 counted {h}x{wp}w R={r} T=32"
            check_equal(torch, what, out, cs.tiled_sweep_plain(w, 32, rows=r),
                        "tiled_sweep")
            check_count(what, c, plain_count(torch, out), "tiled_sweep")
        out, c = torch.empty_like(w), count()
        cs.tiled_sweep_deep(w, out, 64, count=c)
        what = f"K6 counted {h}x{wp}w T=64"
        check_equal(torch, what, out, cs.tiled_sweep_deep_plain(w, 64),
                    "tiled_sweep_deep")
        check_count(what, c, plain_count(torch, out), "tiled_sweep_deep")
        c = count()
        got = cs.fused_banded_run_turns(w, 100, 48, count=c)
        check_count(f"B3 counted {h}x{wp}w k=48 100 turns (K2 last)", c,
                    plain_count(torch, got), "tiled_sweep")
    rule = GenerationsRule("/2/3")
    for (h, wp, n) in [(512, 16, 16), (512, 16, 1), (64, 2, 1)]:
        p = seeded_planes(torch, h, wp, "gen3", h + n, dev)
        c = count()
        got = cs.resident_run_turns2p(p, 50, rule, "gen3", ctas=n, count=c)
        what = f"K4 gen3 counted {h}x{wp}w N={n} 50 turns"
        check_equal(torch, what, got, cs.resident_run_turns2p_plain(
            p, 50, rule, "gen3", ctas=n), "resident_run_turns2p/gen3")
        check_count(what, c, plain_count(torch, got),
                    "resident_run_turns2p/gen3")
    for (h, wp) in [(4096, 128), (97, 65)]:
        p = seeded_planes(torch, h, wp, "gen3", h, dev)
        for r in cs.TILE2P_ROW_CHOICES:
            out, c = torch.empty_like(p), count()
            cs.tiled_sweep2p(p, out, 32, rule, "gen3", rows=r, count=c)
            what = f"K5 gen3 counted {h}x{wp}w R={r} T=32"
            check_equal(torch, what, out, cs.tiled_sweep2p_plain(
                p, 32, rule, "gen3", rows=r), "tiled_sweep2p/gen3")
            check_count(what, c, plain_count(torch, out),
                        "tiled_sweep2p/gen3")
        c = count()
        got = cs.banded_run_turns2p(p, 40, rule, "gen3", count=c)
        check_count(f"K5 gen3 counted {h}x{wp}w 40 turns", c,
                    plain_count(torch, got), "tiled_sweep2p/gen3")
    del w, out, got, p
    full = torch.full((65536, 2048), -1, dtype=torch.int32, device=dev)
    keep = LifeLikeRule("B3/S012345678")
    for name, run in (("tiled_sweep", lambda c: cs.banded_run_turns(
            full, 32, keep, count=c)), ("tiled_sweep_deep", lambda c:
            cs.fused_banded_run_turns(full, 64, 64, keep, count=c))):
        c = count()
        got = run(c)
        what = f"{name} counted 65536² all ones, B3/S012345678"
        check_equal(torch, what, got, full, name)
        check_count(what, c, 1 << 32, name)
        del got
    del full
    torch.cuda.empty_cache()


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
    read_pgm.served.update(native=0, numpy=0)
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "out")
        # 16² runs the uint8 roll-sum path (its width is not a multiple
        # of 32), 64² K1 at N = 1, 512² K1 on a cluster.
        for size, turns in GOLDENS:
            check_golden(images, out, size, turns, "run")
        log(f"  ok goldens {', '.join(f'{s}² x {t}' for s, t in GOLDENS)}: "
            "alive sets and PGM bytes equal check/images")
        # The goldens' reads went through the native codec.
        served = dict(read_pgm.served)
        LIVE_RESULTS["phase4_codec"] = served
        if served["numpy"] or not served["native"]:
            raise AssertionError(f"phase 4's goldens were not all read "
                                 f"by the native codec: {served}")
        log(f"  ok goldens' PGM codec: {json.dumps(served)}")

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
    BCAST_RESULTS["phase5_turns_per_s"] = {
        r["size"]: r["turns_per_s"] for r in engine
        if r.get("size") in (512, 5120) and not r.get("fuse_k")
        and "rule" not in r}
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
    2 at every tile on the same boards and one F.conv2d turn; K7 at
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
    # every tile on the same board and one F.conv2d turn; its head row
    # (Bosco 512²) with its plain version over the same turns.
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
            lib_ms = conv2d_library_ms(torch, b, r, 20 if r <= 32 else 3)
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


# The engine's chunk token timed (`timing_token`): board side, turns a
# chunk, wrapper calls timed.
TOKEN_CHUNKS = ((512, 1, 200), (512, 1024, 50), (5120, 32, 100),
                (65536, 32, 10))
# Each stepping kernel's head row, timed counted and uncounted: (name,
# rows, words, turns, fuse depth or family).
COUNTED_HEADS = (("resident_run_turns", 512, 16, 1024, None),
                 ("tiled_sweep", 65536, 2048, 32, None),
                 ("tiled_sweep_deep", 65536, 2048, 64, 64),
                 ("resident_run_turns2p/gen3", 512, 16, 1024, "gen3"),
                 ("tiled_sweep2p/gen3", 4096, 128, 32, "gen3"))


def host_us_per_call(torch, fn, calls: int) -> float:
    """The host µs a call of `fn` takes to issue, with no synchronisation
    between calls (after one warm-up and a sync)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def timing_token(torch, dev, card: Card) -> dict:
    """The engine's alive token a chunk: the old sequence (the stepping
    launches, then K3, then the torch int64 sum) against the counted
    launch (`count=`: the count rides the chunk's last stepping launch),
    through the engine's run function at 512² (1 and 1024 turns), 5120²
    (32) and 65536² (32), as CUDA-event ms and host µs a chunk, in turns
    (old, counted, counted, old); then each stepping kernel's head row
    counted beside uncounted (events, the same order)."""
    from gol_tpu_torch.models.generations import GenerationsRule
    from gol_tpu_torch.ops import cuda_stencil as cs
    from gol_tpu_torch.parallel.halo import packed_run_turns

    log(f"phase 5: the chunk token, old sequence against the counted "
        f"launch, on {card.smi}")
    rule = cs.CONWAY
    chunks = []
    for size, turns, calls in TOKEN_CHUNKS:
        w = seeded_words(torch, size, size // 32, size + turns, dev)

        def old():
            out = packed_run_turns(w, turns, rule)
            return cs.row_popcounts(out).sum(dtype=torch.int64)

        def counted():
            c = torch.empty(1, dtype=torch.int64, device=dev)
            packed_run_turns(w, turns, rule, count=c)
            return c

        if int(old()) != int(counted()):
            raise AssertionError(f"token {size}² x {turns}: counts differ")
        ms = {"old": [], "counted": []}
        us = {"old": [], "counted": []}
        for name, fn in (("old", old), ("counted", counted),
                         ("counted", counted), ("old", old)):
            ms[name].append(time_ms(torch, fn, calls))
            us[name].append(host_us_per_call(torch, fn, calls))
        row = dict(shape=f"{size}x{size}", turns=turns, calls=calls,
                   card=card.smi,
                   old_ms=statistics.mean(ms["old"]),
                   counted_ms=statistics.mean(ms["counted"]),
                   old_host_us=statistics.mean(us["old"]),
                   counted_host_us=statistics.mean(us["counted"]),
                   spread_ms=ms, spread_host_us=us)
        chunks.append(row)
        log(f"  token {size}² x {turns}: old {row['old_ms']:.5f} ms, "
            f"{row['old_host_us']:.2f} µs of host a chunk; counted "
            f"{row['counted_ms']:.5f} ms, {row['counted_host_us']:.2f} µs "
            f"[{card.smi}]")
        del w
    heads = {}
    gen3 = GenerationsRule("/2/3")
    for name, h, wp, turns, extra in COUNTED_HEADS:
        if extra == "gen3":
            w = seeded_planes(torch, h, wp, "gen3", h + 1, dev)
            run = (cs.resident_run_turns2p if name.startswith("resident")
                   else cs.banded_run_turns2p)

            def step(count=None):
                return run(w, turns, gen3, "gen3", count=count)
        else:
            w = seeded_words(torch, h, wp, h + 1, dev)
            if extra:
                def step(count=None):
                    return cs.fused_banded_run_turns(w, turns, extra,
                                                     count=count)
            else:
                run = (cs.resident_run_turns if name.startswith("resident")
                       else cs.banded_run_turns)

                def step(count=None):
                    return run(w, turns, count=count)
        c = torch.empty(1, dtype=torch.int64, device=dev)
        reps = 3 if h == 65536 else 20
        times = {"uncounted": [], "counted": []}
        for which in ("uncounted", "counted", "counted", "uncounted"):
            times[which].append(time_ms(torch, (lambda: step(c)) if
                                        which == "counted" else step, reps))
        heads[name] = dict(shape=f"{h}x{wp * 32}", turns=turns,
                           uncounted_ms=statistics.mean(times["uncounted"]),
                           counted_ms=statistics.mean(times["counted"]),
                           spread_ms=times, card=card.smi)
        log(f"  {name} {h}x{wp * 32} x {turns}: uncounted "
            f"{heads[name]['uncounted_ms']:.4f} ms, counted "
            f"{heads[name]['counted_ms']:.4f} ms ({times}) [{card.smi}]")
        del w
    torch.cuda.empty_cache()
    return {"chunks": chunks, "heads": heads}


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


# ------------------------------------------------- phase 4h: the fleet

# K9's checked buckets (cap, rows, words), all route 1's: 8 and 512
# slots of 512², 2 of 64², the private 24 x 96 bucket and 8 slots of
# 1024² and of 2048² (route 2 pinned beside them), and 2 of 4096², route
# 2's — and quanta (turns): the default 8, one sweep (32), a sweep and a
# remainder (40) and GOL_FUSE_K's 512.
FLEET_SHAPES = ((8, 512, 16), (512, 512, 16), (2, 64, 2), (1, 24, 3),
                (8, 1024, 32), (8, 2048, 64), (2, 4096, 128))
# The classes that moved from route 2 to route 1, checked on both.
FLEET_MOVED = ((8, 1024, 32), (8, 2048, 64))
FLEET_QUANTA = (8, 32, 40, 512)
# A spatial bucket's window: a quarter of a 2048² slot haloed by 8 rows.
FLEET_BOXED = (528, 64)
# The JAX bench's fleet leg (bench.py:1774-1782): free-running 512² runs
# in one FleetEngine, counted over a wall window.
FLEET_RUN_COUNTS = (1, 64, 512)
FLEET_WINDOW_S = 3.0
# Phase 4h's exact-target runs: one a class, the target not a multiple
# of the 8-turn quantum, so the last 5 turns are the trim (K1 at 512², K2
# at 1024² and 2048²). The default classes all step on K9 route 1; a
# 4096² class, beyond a cluster, keeps route 2 on the path.
FLEET_TRIM_SIZES = (512, 1024, 2048)
FLEET_TRIM_TARGET = 13
FLEET_WIDE = 4096
# Legacy drives repeated beside a busy fleet.
FLEET_DRIVES = 50
# K9's timed buckets (cap, rows, words, route: None for the policy's),
# at the default 8-turn quantum, and the head row of each route in the
# kernels line (the bench leg's top point for route 1; for route 2 the
# 2048² class pinned to it, its route before it moved to route 1).
FLEET_TIMED = ((1, 512, 16, None), (64, 512, 16, None),
               (512, 512, 16, None), (8, 512, 16, None), (2, 64, 2, None),
               (1, 24, 3, None), (8, 1024, 32, None), (8, 2048, 64, None),
               (64, 1024, 32, None), (64, 2048, 64, None),
               (8, 1024, 32, "tiled"), (8, 2048, 64, "tiled"),
               (2, 4096, 128, None))
FLEET_HEADS = {"fleet_run_turns/resident": (512, 512, 16),
               "fleet_run_turns/tiled": (8, 2048, 64)}
# Phase 4h's references, made before its counters start.
FLEET_REF: dict = {}


def seeded_batch(torch, cap: int, h: int, wp: int, seed: int, device):
    """Random (cap, h, wp) packed words made on the device."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (cap, h, wp), generator=g,
                         dtype=torch.int32, device=device)


def fleet_route(cs, shape, kind=None) -> str:
    return f"fleet_run_turns/{kind or cs.fleet_run_kind(shape)}"


def phase_kernels_fleet(torch, dev) -> None:
    """Phase 3: K9 against its plain version, words and popcounts, at the
    fleet's bucket shapes and quanta, route 1 at every CTA count a slot
    takes at 512², and route 2 pinned on 512² slots."""
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 3: K9 (fleet_run_turns) against its plain version "
        "(bit-exact, words and popcounts)")
    t0 = time.perf_counter()
    for i, (cap, h, wp) in enumerate(FLEET_SHAPES):
        w = seeded_batch(torch, cap, h, wp, 90 + i, dev)
        name = fleet_route(cs, w.shape)
        for turns in FLEET_QUANTA:
            got, alive = cs.fleet_run_turns(w, turns)
            want, want_alive = cs.fleet_run_turns_plain(w, turns)
            what = f"K9 {name.split('/')[1]} {cap} x {h}x{wp * 32} x {turns}"
            check_equal(torch, what, got, want, name)
            check_equal(torch, what + " popcounts", alive, want_alive, name)
            if (cap, h, wp) in FLEET_MOVED:
                got, alive = cs.fleet_run_turns(w, turns, kind="tiled")
                what = f"K9 tiled pinned {cap} x {h}x{wp * 32} x {turns}"
                check_equal(torch, what, got, want, "fleet_run_turns/tiled")
                check_equal(torch, what + " popcounts", alive, want_alive,
                            "fleet_run_turns/tiled")
        del w
    w = seeded_batch(torch, 8, 512, 16, 99, dev)
    for ctas in (1, 2, 4, 8, 16):
        got, alive = cs.fleet_run_turns(w, 40, ctas=ctas)
        want, want_alive = cs.fleet_run_turns_plain(w, 40, ctas=ctas)
        check_equal(torch, f"K9 resident 8 x 512² x 40 at {ctas} CTAs a slot",
                    torch.cat([got.flatten(), alive]),
                    torch.cat([want.flatten(), want_alive]),
                    "fleet_run_turns/resident")
    for rows in cs.TILE_ROW_CHOICES:
        got, alive = cs.fleet_run_turns(w, 40, kind="tiled", rows=rows)
        want, want_alive = cs.fleet_run_turns_plain(w, 40, kind="tiled",
                                                    rows=rows)
        check_equal(torch, f"K9 tiled pinned 8 x 512² x 40, {rows} rows",
                    torch.cat([got.flatten(), alive]),
                    torch.cat([want.flatten(), want_alive]),
                    "fleet_run_turns/tiled")
    # The counted box (a spatial bucket's window counts its shard's own
    # rows): a 2048² slot's quarter haloed by 8 rows, both routes.
    w = seeded_batch(torch, 8, *FLEET_BOXED, 98, dev)
    for box in ((8, FLEET_BOXED[0] - 8, 0, FLEET_BOXED[1]),
                (5, 200, 3, 40)):
        for kind, pin in (("resident", {}), ("resident", {"ctas": 16}),
                          ("tiled", {"rows": 128}), ("tiled", {"rows": 384})):
            got, alive = cs.fleet_run_turns(w, 8, kind=kind, box=box, **pin)
            want, want_alive = cs.fleet_run_turns_plain(w, 8, kind=kind,
                                                        box=box, **pin)
            check_equal(torch, f"K9 {kind} {pin} 8 x {FLEET_BOXED} x 8, "
                        f"box {box}", torch.cat([got.flatten(), alive]),
                        torch.cat([want.flatten(), want_alive]),
                        f"fleet_run_turns/{kind}")
    log(f"  K9 checks took {time.perf_counter() - t0:.1f} s")


def fleet_seed(size: int, seed: int) -> np.ndarray:
    """A {0,1} board with 25% alive (the bench's density)."""
    rng = np.random.default_rng(seed)
    return (rng.random((size, size)) < 0.25).astype(np.uint8)


def fleet_reference(torch, dev) -> None:
    """Phase 4h's references, made before its counters start: each trim
    run's board by `packed_run_turns` (K1 or K2) from its seed, and the
    dense engine's 24 x 24 legacy board."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import bitpack
    from gol_tpu_torch.parallel.halo import packed_run_turns

    for size in FLEET_TRIM_SIZES + (FLEET_WIDE,):
        seed = fleet_seed(size, size)
        words = bitpack.words_from_numpy(bitpack.pack_np(seed), dev)
        out = packed_run_turns(words, FLEET_TRIM_TARGET, CONWAY)
        FLEET_REF[size] = (seed, bitpack.unpack_np(
            bitpack.words_to_numpy(out)) * np.uint8(255))
    world = fleet_seed(24, 3) * np.uint8(255)
    FLEET_REF["legacy"] = (world, Engine().server_distributor(
        Params(threads=1, image_width=24, image_height=24, turns=6),
        world)[0])


def legacy_drives_beside_churn(address: str, drives: int) -> dict:
    """`drives` legacy (run_id-less) drives of 24 x 24 boards, 6 turns
    each, through the port's client while another client creates and
    destroys 512² runs on the same server; every drive must return turn
    6 and the torus oracle's board."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.ops.reference import run_turns_np

    stop = threading.Event()
    errors: list = []
    churned = [0]

    def churn():
        cli = RemoteEngine(address)
        try:
            while not stop.is_set():
                rid = f"busy{churned[0] % 4}"
                cli.create_run(512, 512, run_id=rid)
                cli.destroy_run(rid)
                churned[0] += 1
        except Exception as e:  # noqa: BLE001 - raised below
            errors.append(e)

    t = threading.Thread(target=churn, daemon=True)
    t.start()
    cli = RemoteEngine(address)
    p = Params(threads=1, image_width=24, image_height=24, turns=6)
    t0 = time.perf_counter()
    try:
        for i in range(drives):
            world = fleet_seed(24, 1000 + i) * np.uint8(255)
            got, turn = cli.server_distributor(p, world)
            if turn != 6:
                raise AssertionError(f"legacy drive {i} returned turn "
                                     f"{turn}, not 6")
            want = run_turns_np(fleet_seed(24, 1000 + i), 6)
            if not np.array_equal(got, want * np.uint8(255)):
                raise AssertionError(f"legacy drive {i}: board != oracle")
    finally:
        stop.set()
        t.join(30)
    if errors:
        raise AssertionError(f"churn thread failed: {errors[0]!r}")
    return dict(drives=drives, churned_runs=churned[0],
                seconds=time.perf_counter() - t0)


def phase_fleet(torch, dev) -> None:
    """Phase 4h: the fleet on the card. A `python -m gol_tpu_torch.server
    --fleet` subprocess serves the goldens to a controller through SER,
    the 24 x 24 board through its private bucket (the dense engine's
    board) and 50 legacy drives beside a busy fleet; then the fleet RPCs
    through the port's client against an in-process --fleet server (so
    the counters see K9, and K1 and K2 in the trims), each class with a
    target the quantum does not divide, all on K9 route 1; then a 4096²
    class, beyond a cluster, on route 2."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.fleet import FleetEngine
    from gol_tpu_torch.ops import cuda_stencil as cs

    log("phase 4h: the fleet: a --fleet server subprocess on the card")
    images = os.path.join(REPO, "images")
    proc, port = spawn_server(0, "--fleet")
    try:
        address = f"127.0.0.1:{port}"
        with tempfile.TemporaryDirectory() as tmp:
            os.environ["SER"] = address
            try:
                for size in (16, 64, 512):
                    check_golden(images, tmp, size, 100, "--fleet SER")
            finally:
                os.environ.pop("SER", None)
        log("  ok 16², 64², 512² x 100 through SER to the --fleet server: "
            "alive sets and PGM bytes equal check/images")
        world, want = FLEET_REF["legacy"]
        got, turn = RemoteEngine(address).server_distributor(
            Params(threads=1, image_width=24, image_height=24, turns=6),
            world)
        if turn != 6 or not np.array_equal(got, want):
            raise AssertionError("24² x 6 through the private bucket != "
                                 "the dense engine's board")
        log("  ok 24² x 6 (private 24 x 96 bucket) equals the dense "
            "Engine's board")
        rec = legacy_drives_beside_churn(address, FLEET_DRIVES)
        log(f"  ok {rec['drives']} of {rec['drives']} legacy drives at "
            f"turn 6 with the oracle's board, beside {rec['churned_runs']} "
            f"runs created and destroyed, in {rec['seconds']:.1f} s")
        FLEET_STATS["legacy_drives"] = rec
    finally:
        stop_server(proc)

    fleet = FleetEngine()
    with served(fleet) as srv:
        cli = RemoteEngine(f"127.0.0.1:{srv.port}")
        for size in FLEET_TRIM_SIZES:
            seed, want = FLEET_REF[size]
            rid = f"trim{size}"
            cli.create_run(size, size, board=seed * np.uint8(255),
                           run_id=rid, target_turn=FLEET_TRIM_TARGET)
            rv = cli.attach_run(rid)
            deadline = time.monotonic() + 60
            while rv.stats()["state"] != "parked":
                if time.monotonic() > deadline:
                    raise AssertionError(f"{rid} never parked")
                time.sleep(0.01)
            got, turn = rv.get_world()
            if turn != FLEET_TRIM_TARGET or not np.array_equal(got, want):
                raise AssertionError(f"{size}² fleet run at turn {turn}: "
                                     "board != packed_run_turns replay")
            log(f"  ok {size}² run to turn {FLEET_TRIM_TARGET} (quantum "
                f"{srv.engine.turns_per_dispatch}): the packed_run_turns "
                "replay's board")
        runs, summary = cli.list_runs()
        if ({r["run_id"] for r in runs} != {f"trim{s}"
                                            for s in FLEET_TRIM_SIZES}
                or summary["parked"] != len(FLEET_TRIM_SIZES)):
            raise AssertionError(f"ListRuns: {runs}, {summary}")
        rec = cli.set_rule("trim512", "B36/S23")
        if rec["rule"] != "B36/S23":
            raise AssertionError(f"SetRule: {rec}")
        for size in FLEET_TRIM_SIZES:
            if cli.destroy_run(f"trim{size}")["state"] != "removed":
                raise AssertionError("DestroyRun")
        if cli.list_runs()[0]:
            raise AssertionError("runs left after DestroyRun")
        log("  ok CreateRun, ListRuns, AttachRun + GetWorld, SetRule, "
            "DestroyRun through the port's client")
    fleet.kill_prog()
    tiled = cs.fleet_run_turns.by_route["tiled"]
    if tiled or not cs.fleet_run_turns.by_route["resident"]:
        raise AssertionError(f"the default classes' runs launched K9 "
                             f"{cs.fleet_run_turns.by_route}")
    log(f"  ok the default classes stepped on K9 route 1 alone: "
        f"{cs.fleet_run_turns.by_route}")
    fleet = FleetEngine(bucket_sizes=(FLEET_WIDE,))
    try:
        seed, want = FLEET_REF[FLEET_WIDE]
        fleet.create_run(FLEET_WIDE, FLEET_WIDE, board=seed * np.uint8(255),
                         run_id="wide", target_turn=FLEET_TRIM_TARGET)
        view = fleet.resolve_run("wide")
        deadline = time.monotonic() + 60
        while view.stats()["state"] != "parked":
            if time.monotonic() > deadline:
                raise AssertionError("the 4096² run never parked")
            time.sleep(0.01)
        got, turn = view.get_world()
    finally:
        fleet.kill_prog()
    if turn != FLEET_TRIM_TARGET or not np.array_equal(got, want):
        raise AssertionError(f"{FLEET_WIDE}² fleet run at turn {turn}: "
                             "board != packed_run_turns replay")
    if cs.fleet_run_turns.by_route["tiled"] <= tiled:
        raise AssertionError("the 4096² class never launched K9 route 2")
    log(f"  ok {FLEET_WIDE}² run (K9 route 2) to turn {FLEET_TRIM_TARGET}: "
        "the packed_run_turns replay's board")


FLEET_STATS: dict = {}


def wire_single_cups(dev, n: int, window_s: float) -> dict:
    """The bench leg's comparator (bench.py:1796-1834): ONE n² run served
    turn by turn over loopback (one ServerDistributor RPC a turn, board
    up and down), by the port's client and server on the card."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    world = fleet_seed(n, 0) * np.uint8(255)
    with served(Engine()) as srv:
        os.environ.pop("SER", None)
        cli = RemoteEngine(f"127.0.0.1:{srv.port}")
        p = Params(threads=1, image_width=n, image_height=n, turns=1)
        board, turn = cli.server_distributor(p, world)
        t0 = time.perf_counter()
        reps = 0
        while time.perf_counter() - t0 < window_s:
            board, turn = cli.server_distributor(p, board, start_turn=turn)
            reps += 1
        elapsed = time.perf_counter() - t0
    words = bitpack.words_from_numpy(bitpack.pack_np(world), dev)
    want = bitpack.unpack_np(bitpack.words_to_numpy(
        cs.resident_run_turns(words, turn, CONWAY))) * np.uint8(255)
    if not np.array_equal(board, want):
        raise AssertionError("wire-driven single run != its K1 replay")
    return dict(size=n, turns=reps, seconds=elapsed,
                cell_updates_per_s=reps * n * n / elapsed,
                ms_per_turn=elapsed / max(reps, 1) * 1e3)


def fleet_point(torch, dev, count: int, n: int, window_s: float,
                profile) -> dict:
    """One point of the bench leg: `count` free-running n² runs in one
    FleetEngine (slot_base max(8, count), the bench's), counted over a
    wall window; then a short profiled window for K9's device ms; run
    b0's board against a K1 replay of its seed."""
    from torch.profiler import ProfilerActivity

    from gol_tpu_torch.fleet import FleetEngine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    k9_before = cs.fleet_run_turns.launches
    eng = FleetEngine(bucket_sizes=(n,), slot_base=max(8, count))
    try:
        seed0 = None
        for i in range(count):
            seed = fleet_seed(n, 10_000 + i)
            if i == 0:
                seed0 = seed
            eng.create_run(n, n, board=seed, run_id=f"b{i}", wait=False)
        deadline = time.monotonic() + 120
        while eng.runs_summary()["resident"] < count:
            if time.monotonic() > deadline:
                raise AssertionError("fleet placement timed out")
            time.sleep(0.02)
        warm = eng.throughput_counters()["board_turns"]
        while eng.throughput_counters()["board_turns"] == warm:
            time.sleep(0.01)
        time.sleep(0.5)  # past the first flush
        eng.reset_bench_window()
        c0 = eng.throughput_counters()
        t0 = time.perf_counter()
        time.sleep(window_s)
        c1 = eng.throughput_counters()
        elapsed = time.perf_counter() - t0
        p50, p99 = eng.latency_percentiles()
        d0 = eng.throughput_counters()["dispatches"]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5)
            torch.cuda.synchronize()
        quanta = eng.throughput_counters()["dispatches"] - d0
        board, turn = eng.resolve_run("b0").get_world()
    finally:
        eng.kill_prog()
    k9_launches = cs.fleet_run_turns.launches - k9_before
    ms = device_ms_by_kernel(prof)
    k9 = ms.get("fleet_run_turns/resident")
    words = bitpack.words_from_numpy(bitpack.pack_np(seed0), dev)
    want = bitpack.unpack_np(bitpack.words_to_numpy(
        cs.resident_run_turns(words, turn, CONWAY))) * np.uint8(255)
    if not np.array_equal(board, want):
        raise AssertionError(f"fleet {count} x {n}²: run b0 at turn {turn}"
                             " != its K1 replay")
    cells = c1["cell_updates"] - c0["cell_updates"]
    return dict(runs=count, size=n, window_s=elapsed,
                cell_updates_per_s=cells / elapsed,
                turns_per_run_per_s=(c1["board_turns"] - c0["board_turns"])
                / count / elapsed,
                p50_turn_latency_ms=p50 * 1e3, p99_turn_latency_ms=p99 * 1e3,
                chunk_overhead_us=c1["chunk_overhead_us"],
                quanta_profiled=quanta,
                k9_device_ms_profiled=k9 or "not measured",
                k9_device_ms_per_quantum=(k9 / quanta if k9 and quanta
                                          else "not measured"),
                profiled_device_ms=ms or "not measured",
                k9_launches=k9_launches, sampled_run_turn=turn, parity=True)


def timing_fleet(torch, dev, card: Card) -> dict:
    """Phase 4h's measurements: the JAX bench's fleet leg on the card (1,
    64 and 512 free-running 512² runs), the wire-driven single run it is
    measured against, and K9 a quantum (CUDA events) beside its bound
    and its plain version, at the leg's and phase 3's buckets."""
    from torch.profiler import profile

    from gol_tpu_torch.ops import cuda_stencil as cs

    log(f"phase 4h: fleet measurements on {card.smi}")
    single = wire_single_cups(dev, 512, 2.0)
    log(f"  wire-driven single 512² run: {single['cell_updates_per_s']:.4g} "
        f"cell updates/s ({single['ms_per_turn']:.3f} ms a turn) "
        f"[{card.smi}]")
    points = []
    for count in FLEET_RUN_COUNTS:
        r = fleet_point(torch, dev, count, 512, FLEET_WINDOW_S, profile)
        points.append(r)
        log(f"  fleet {count} x 512²: {r['cell_updates_per_s']:.4g} cell "
            f"updates/s ({r['cell_updates_per_s'] / single['cell_updates_per_s']:.1f}"
            f"x the wire-driven run), {r['turns_per_run_per_s']:.1f} turns/s "
            f"a run, turn latency p50 {r['p50_turn_latency_ms']:.4f} ms "
            f"p99 {r['p99_turn_latency_ms']:.4f} ms, chunk_overhead_us "
            f"{r['chunk_overhead_us']:.1f}, K9 device "
            f"{r['k9_device_ms_per_quantum']} ms a quantum under the "
            f"profiler ({r['quanta_profiled']} quanta); run b0 equals its K1 "
            f"replay at turn {r['sampled_run_turn']} [{card.smi}]")
    ops = cs.OPS_PER_WORD_TURN
    lib = cs._library()
    rows = []
    for cap, h, wp, pin in FLEET_TIMED:
        w = seeded_batch(torch, cap, h, wp, 7, dev)
        words = cap * h * wp
        kind = pin or cs.fleet_run_kind(w.shape)
        b, by = card.bound(8 * words + 4 * cap, ops * 8 * words)
        ms = time_ms(torch, lambda: cs.fleet_run_turns(w, 8, kind=pin), 50)
        host_us = host_us_per_call(
            torch, lambda: cs.fleet_run_turns(w, 8, kind=pin), 200)
        plain = (time_ms(torch, lambda: cs.fleet_run_turns_plain(w, 8), 2)
                 if (cap, h, wp) in FLEET_HEADS.values() else None)
        ctas = (cs.fleet_resident_ctas(cap, h, wp) if kind == "resident"
                else None)
        rows.append(dict(
            name=f"fleet_run_turns/{kind}", pinned=pin is not None,
            shape=f"{cap} x {h}x{wp * 32}", turns=8, ctas=ctas,
            rows=(cs.fleet_tile_rows(cap, h, wp) if kind == "tiled"
                  else None),
            clusters_at_once=(lib.gol_fleet_resident_clusters(
                h, wp, ctas, cs.resident_rows_per_thread(h, wp, ctas),
                dev.index) if ctas else None),
            ms=ms, host_us_per_call=host_us, plain_ms=plain, bound_ms=b,
            bound_by=by))
        log_row(rows[-1]["name"], rows[-1])
        log(f"    host {host_us:.2f} µs a call; clusters the card holds "
            f"at once: {rows[-1]['clusters_at_once']} [{card.smi}]")
        del w
    FLEET_STATS.update(single=single, points=points, k9=rows,
                       bench_leg_k9_launches=sum(p["k9_launches"]
                                                 for p in points),
                       cluster_sweep=fleet_cluster_sweep(torch, dev, card))
    log("fleet:" + json.dumps(FLEET_STATS))
    return FLEET_STATS


# K9 route 1's CTAs a slot swept (`fleet_cluster_sweep`): the buckets
# (cap, rows, words) and quanta.
FLEET_SWEEP = ((1, 2048, 64), (8, 2048, 64), (64, 2048, 64),
               (8, 1024, 32), (64, 1024, 32))
FLEET_SWEEP_TURNS = (8, 64)


# A spin on the card long enough to cover the issue of `calls` wrapper
# calls (cycles at ~2 GHz: 10 ms).
QUEUE_SPIN_CYCLES = 20_000_000


def device_us_per_call(torch, fn, calls: int) -> float:
    """The card's µs a call of `fn`, by CUDA events around `calls` calls
    queued behind a spin kernel, so that no host time falls between the
    events (the calls are issued while the card still spins). Raises when
    the spin ended before the last call was issued."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SPIN_CYCLES)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    if start.query():
        raise AssertionError("the spin ended before the calls were issued")
    end.synchronize()
    return start.elapsed_time(end) / calls * 1e3


def fleet_cluster_sweep(torch, dev, card: Card) -> list:
    """K9 route 1's device µs a quantum at every CTA count a slot takes
    (powers of two from the fewest that hold it to 16), beside route 2
    pinned, at 1-64 slots of 1024² and 2048² for 8 and 64 turns, with
    the clusters the card holds at once: the data behind
    `fleet_resident_ctas`. Events behind a spin, not `torch.profiler`,
    which can return a window with no device time."""
    from gol_tpu_torch.ops import cuda_stencil as cs

    lib = cs._library()
    rows = []
    for cap, h, wp in FLEET_SWEEP:
        w = seeded_batch(torch, cap, h, wp, 11, dev)
        for turns in FLEET_SWEEP_TURNS:
            row = dict(shape=f"{cap} x {h}x{wp * 32}", turns=turns,
                       policy_ctas=cs.fleet_resident_ctas(cap, h, wp),
                       card=card.smi, route1_us={}, clusters_at_once={})
            n = cs.fleet_slot_ctas(h, wp)
            while n <= cs.RESIDENT_MAX_CTAS:
                row["route1_us"][n] = device_us_per_call(
                    torch, lambda: cs.fleet_run_turns(w, turns, ctas=n), 20)
                row["clusters_at_once"][n] = lib.gol_fleet_resident_clusters(
                    h, wp, n, cs.resident_rows_per_thread(h, wp, n),
                    dev.index)
                n *= 2
            row["route2_us"] = device_us_per_call(
                torch, lambda: cs.fleet_run_turns(w, turns, kind="tiled"), 20)
            rows.append(row)
            log(f"  K9 {row['shape']} x {turns} device µs by CTAs a slot "
                f"{row['route1_us']} (clusters at once "
                f"{row['clusters_at_once']}), policy N = "
                f"{row['policy_ctas']}, route 2 pinned {row['route2_us']} "
                f"[{card.smi}]")
        del w
    return rows


def k9_records(card: Card, launches: dict, stats: dict) -> list:
    """K9's two routes for the kernels line: route 1 at the bench's top
    point (512 slots of 512²), route 2 at 8 slots of 2048²."""
    out = []
    for name, (cap, h, wp) in FLEET_HEADS.items():
        shape = f"{cap} x {h}x{wp * 32}"
        rs = [r for r in stats["k9"] if r["name"] == name]
        head = [r for r in rs if r["shape"] == shape][0]
        out.append(dict(
            name=name, route="cuda", source="gol_tpu_torch/csrc/stencil.cu",
            family=None, replaces="gol_tpu/fleet/buckets.py:149",
            launches=launches[name], bit_exact=MAX_ABS_ERR[name] == 0,
            max_abs_err=MAX_ABS_ERR[name], card=card.smi, shape=shape,
            turns=8, ms=head["ms"], plain_ms=head["plain_ms"],
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            library_ms=None, by_shape=rs))
    out[0]["bench_leg_launches"] = stats["bench_leg_k9_launches"]
    out[0]["cluster_sweep"] = stats["cluster_sweep"]
    return out


# ------------------------------------- phase 4i: broadcast tier, telemetry

# The JAX bench's broadcast leg (`bench.py:2276-2495`): one free-running
# 64² fleet run (chunk 2) behind an in-process server, 1000 Subscribe
# viewers (2 of them decoding), a 3 s window.
BCAST_VIEWERS = 1000
BCAST_TRACKED = 2
BCAST_WINDOW_S = 3.0
BCAST_BOARD = 64
# Single-run subscriptions: each board, its drive's turns, and the view
# every subscriber asks for (2^20 cells: the whole 512² board, a
# downsampled view of 5120²).
SUB_BOARDS = ((512, 100), (5120, 1000))
SUB_MAX_CELLS = 1 << 20
PROFILE_TURNS = 64
# Phase 4i's numbers, for the summary lines at the end.
BCAST_RESULTS: dict = {}


class DrainPool:
    """Parked subscriptions drained byte-wise (recv and discard, no
    decode) on one selectors thread, so they look idle to the server:
    the gateway keeps pushing and no kernel buffer fills."""

    def __init__(self) -> None:
        import selectors
        import socket

        self._sel = selectors.DefaultSelector()
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, None)
        self._lock = threading.Lock()
        self._pending: list = []
        self._subs: dict = {}
        self.bytes = 0
        self.closed = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def add(self, sub) -> None:
        with self._lock:
            self._pending.append(sub)
        self._wake_w.send(b"\x01")

    def close(self) -> None:
        self._stop.set()
        self._wake_w.send(b"\x01")
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise AssertionError("viewer drain thread did not stop")

    def _loop(self) -> None:
        import selectors

        while not self._stop.is_set():
            for key, _ in self._sel.select(timeout=0.5):
                if key.data is None:
                    self._wake_r.recv(4096)
                else:
                    self._drain(key.data)
            with self._lock:
                pending, self._pending = self._pending, []
            for sub in pending:
                sub._sock.setblocking(False)
                self._sel.register(sub._sock, selectors.EVENT_READ, sub)
                self._subs[sub._sock.fileno()] = sub
        for sub in list(self._subs.values()):
            self._sel.unregister(sub._sock)
            sub.close()
        for sub in self._pending:
            sub.close()
        self._wake_r.close()
        self._wake_w.close()
        self._sel.close()

    def _drain(self, sub) -> None:
        try:
            while True:
                data = sub._sock.recv(1 << 16)
                if not data:
                    break
                self.bytes += len(data)
        except BlockingIOError:
            return
        except OSError:
            pass
        self._sel.unregister(sub._sock)
        del self._subs[sub._sock.fileno()]
        self.closed += 1
        sub.close()


def open_viewers(address: str, run_id, count: int, view_cells: int):
    """`count` Subscribe upgrades bound to `run_id`, opened by 8 threads
    and parked in a DrainPool; raises on the first refusal."""
    from gol_tpu_torch.client import RemoteEngine

    pool = DrainPool()
    errors: list = []
    left = [count]
    lock = threading.Lock()

    def opener() -> None:
        eng = RemoteEngine(address, timeout=30.0, run_id=run_id)
        while True:
            with lock:
                if left[0] <= 0 or errors:
                    return
                left[0] -= 1
            try:
                pool.add(eng.subscribe(view_cells, timeout=30.0))
            except Exception as e:  # reported below, on this thread
                with lock:
                    errors.append(f"{type(e).__name__}: {e}")
                return

    workers = [threading.Thread(target=opener, daemon=True)
               for _ in range(8)]
    for t in workers:
        t.start()
    for t in workers:
        t.join(timeout=300)
    if errors or any(t.is_alive() for t in workers):
        pool.close()
        raise AssertionError(f"subscribe failed: {errors[:3]}")
    return pool


class Tracked:
    """A decoding subscriber on its own thread: every (turn, view) it
    receives, in order, and the error that ended it, if any."""

    def __init__(self, sub) -> None:
        self.sub = sub
        self.frames: list = []
        self.error = None
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for view, turn, geom, _header in self.sub.frames(timeout=60.0):
                with self._lock:
                    self.frames.append((turn, geom, view))
        except Exception as e:  # reported by wait_turn
            self.error = f"{type(e).__name__}: {e}"

    def snapshot(self) -> list:
        with self._lock:
            return list(self.frames)

    def wait_turn(self, turn: int, seconds: float = 60.0):
        """The first frame at `turn`, waiting up to `seconds`."""
        deadline = time.monotonic() + seconds
        while time.monotonic() < deadline:
            got = [f for f in self.snapshot() if f[0] == turn]
            if got:
                return got[0]
            if self.error is not None:
                break
            time.sleep(0.01)
        raise AssertionError(f"no frame at turn {turn} "
                             f"(error {self.error}, turns "
                             f"{[f[0] for f in self.snapshot()][-8:]})")

    def close(self) -> None:
        self.sub.close()
        self._thread.join(timeout=10.0)


def bcast_frames_total() -> float:
    from gol_tpu_torch.obs import catalog as obs

    return sum(c.value for c in obs.BCAST_FRAMES.children().values())


def broadcast_leg(dev) -> dict:
    """The JAX bench's broadcast leg on the port: encode calls per
    published frame (exactly 1.0), the gateway's fan-out quantiles, and
    a tracked viewer's frame bit-identical to a fresh GetView at a
    pinned turn."""
    import resource

    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.engine import FLAG_PAUSE
    from gol_tpu_torch.fleet import FleetEngine
    from gol_tpu_torch.obs import catalog as obs
    from gol_tpu_torch.server import EngineServer

    # Two fds a viewer (client and server ends): clamp to the limit.
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
    soft = resource.getrlimit(resource.RLIMIT_NOFILE)[0]
    viewers = min(BCAST_VIEWERS, max(BCAST_TRACKED + 1, (soft - 256) // 2))
    n = BCAST_BOARD
    cells = n * n
    eng = FleetEngine(bucket_sizes=(n,), chunk_turns=2, slot_base=8,
                      device=dev)
    srv = EngineServer(port=0, host="127.0.0.1", engine=eng)
    srv.start_background()
    address = f"127.0.0.1:{srv.port}"
    tracked, pool = [], None
    try:
        ctl = RemoteEngine(address, timeout=30.0)
        rid = ctl.create_run(n, n, board=seeded_board(n, 14))["run_id"]
        bound = ctl.attach_run(rid)
        tracked = [Tracked(bound.subscribe(cells, timeout=30.0))
                   for _ in range(BCAST_TRACKED)]
        deadline = time.monotonic() + 120.0
        while (min(len(t.snapshot()) for t in tracked) < 2
               and time.monotonic() < deadline):
            time.sleep(0.05)
        if min(len(t.snapshot()) for t in tracked) < 2:
            raise AssertionError("the tracked viewers never warmed")
        pool = open_viewers(address, rid, viewers - BCAST_TRACKED, cells)
        hub, gateway = srv._bcast
        # Admission catch-up frames carry publish stamps older than
        # their subscriber: settle, then measure from a clean estimator.
        time.sleep(0.5)
        gateway.fanout_reset()
        e0, f0 = obs.WIRE_ENCODE_CALLS.value, bcast_frames_total()
        d0, s0 = obs.BCAST_FRAMES_DROPPED.value, obs.BCAST_SENT_BYTES.value
        time.sleep(BCAST_WINDOW_S)
        frames = bcast_frames_total() - f0
        encodes = obs.WIRE_ENCODE_CALLS.value - e0
        dropped = obs.BCAST_FRAMES_DROPPED.value - d0
        snap = gateway.fanout_snapshot()
        gateway._flush(time.monotonic())  # the sent-bytes counter
        sent = obs.BCAST_SENT_BYTES.value - s0
        if frames <= 0:
            raise AssertionError("no frames published in the window")
        ratio = encodes / frames
        if ratio != 1.0:
            raise AssertionError(f"encode-once broken: {encodes} encodes "
                                 f"for {frames} published frames")
        if not snap["count"]:
            raise AssertionError("the gateway recorded no fan-out")
        # Parity: pause, publish the parked turn, and a tracked frame
        # of that turn equals a fresh GetView, bit for bit.
        bound.cf_put(FLAG_PAUSE)
        ref, ref_turn, _ = bound.get_view(cells)
        for _ in range(100):
            out, turn, _ = bound.get_view(cells)
            if turn == ref_turn:
                break
            ref, ref_turn = out, turn
            time.sleep(0.05)
        hub.publish_now(force=True)
        got = tracked[0].wait_turn(ref_turn, 10.0)
        if not np.array_equal(got[2], ref):
            raise AssertionError(f"pushed frame != GetView at turn "
                                 f"{ref_turn}")
        res = dict(viewers=viewers, tracked=BCAST_TRACKED, board=n,
                   window_s=BCAST_WINDOW_S, frames_published=frames,
                   encode_calls=encodes,
                   encode_calls_per_published_frame=ratio,
                   frames_dropped=dropped, bytes_sent=sent,
                   pool_bytes=pool.bytes, fanout_samples=snap["count"],
                   delivered_share=snap["count"] / (frames * viewers),
                   viewer_fanout_p50_ms=snap["p50"] * 1e3,
                   viewer_fanout_p95_ms=snap["p95"] * 1e3,
                   viewer_fanout_p99_ms=snap["p99"] * 1e3,
                   parity_turn=ref_turn)
    finally:
        for t in tracked:
            t.close()
        if pool is not None:
            pool.close()
        eng.kill_prog()
        srv.shutdown()
    log(f"  ok broadcast leg: {viewers} viewers of a {n}² fleet run, "
        f"{frames:.0f} frames published in {BCAST_WINDOW_S} s with "
        f"{encodes:.0f} encodes (1.0 a frame), {dropped:.0f} dropped, "
        f"{sent:.0f} bytes sent; fan-out p50 {res['viewer_fanout_p50_ms']:.3f}"
        f" ms, p99 {res['viewer_fanout_p99_ms']:.3f} ms over "
        f"{snap['count']} deliveries ({res['delivered_share']:.3f} of "
        f"frames x viewers); a tracked frame equals GetView at turn "
        f"{ref_turn}")
    return res


def host_view(words_np, f: int) -> np.ndarray:
    """The engine's view of packed words at factor f, made on the host
    from the unpacked board: each f x f block's brightest pixel (0 or
    255), the board zero-padded to whole blocks."""
    from gol_tpu_torch.ops import bitpack

    board = bitpack.unpack_np(words_np)
    h, w = board.shape
    hp, wp = -(-h // f) * f, -(-w // f) * f
    pad = np.zeros((hp, wp), np.uint8)
    pad[:h, :w] = board
    return (pad.reshape(hp // f, f, wp // f, f).max(axis=(1, 3))
            * np.uint8(255))


def plain_history(torch, world: np.ndarray, turns, dev) -> dict:
    """{turn: packed words on the host} for each of `turns`, stepped from
    `world` by the plain packed step (`bitpack.packed_step`), one turn at
    a time, and the plain count at every turn up to the last."""
    from gol_tpu_torch.ops import bitpack

    want = set(turns)
    words = bitpack.words_from_numpy(bitpack.pack_np(world), dev)
    boards, counts = {}, {}
    for t in range(max(want) + 1):
        if t:
            words = bitpack.packed_step(words)
        counts[t] = plain_count(torch, words)
        if t in want:
            boards[t] = bitpack.words_to_numpy(words)
    return {"boards": boards, "counts": counts}


def view_device_ms(torch, eng, max_cells: int, reps: int = 5) -> float:
    """Median device ms of one publication's view (`Engine.get_view`,
    the reduction and its copy to the host), by CUDA events."""
    eng.get_view(max_cells)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        eng.get_view(max_cells)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def trace_kernels(path: str) -> set:
    """Names of the device kernels in a torch.profiler Chrome trace."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return {str(e.get("name", "")).replace("(anonymous namespace)::", "")
            for e in events if e.get("cat") == "kernel"}


def subscribe_engine(torch, dev, size: int, turns: int):
    """One served CUDA engine at `size`²: no subscriber means no frame and
    no hub; two subscribers then see every frame of a `turns`-turn drive
    equal the engine's view at its turn (a host view of the plain board;
    at 512² also the check/ boards at turns 0 and 100 and the CSV's
    count); the engine's turns/s with both attached; the view's device
    ms. Returns (results, the plain count at every turn of the drive)."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.engine import Engine, view_factor
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.server import EngineServer

    world = sub_world(size)
    csv = (read_csv(os.path.join(REPO, "check", "alive", "512x512.csv"))
           if size == 512 else None)
    f = view_factor(size, size, SUB_MAX_CELLS)
    eng = Engine(device=dev)
    srv = EngineServer(port=0, host="127.0.0.1", engine=eng)
    srv.start_background()
    address = f"127.0.0.1:{srv.port}"
    res = {"size": size, "view_factor": f}
    tracked = []
    try:
        f0 = bcast_frames_total()
        eng.server_distributor(Params(image_width=size, image_height=size,
                                      turns=turns), world)
        if srv._bcast is not None or bcast_frames_total() != f0:
            raise AssertionError("a run with no subscriber published "
                                 "frames or started the hub")
        eng.server_distributor(Params(image_width=size, image_height=size,
                                      turns=0), world)
        tracked = [Tracked(RemoteEngine(address).subscribe(
            SUB_MAX_CELLS, timeout=30.0)) for _ in range(2)]
        for t in tracked:
            t.wait_turn(0)
        eng.server_distributor(Params(image_width=size, image_height=size,
                                      turns=turns), world)
        srv._bcast[0].publish_now(force=True)
        for t in tracked:
            t.wait_turn(turns)
        frames = [fr for t in tracked for fr in t.snapshot()]
        hist = plain_history(torch, world,
                             {fr[0] for fr in frames} | {turns}, dev)
        for turn, geom, view in frames:
            want = host_view(hist["boards"][turn], f)
            if geom != (f, f) or not np.array_equal(view, want):
                raise AssertionError(f"{size}²: the frame at turn {turn} "
                                     f"!= the view at its turn")
            if csv is not None and int((view != 0).sum()) != csv[turn]:
                raise AssertionError(f"{size}²: the frame at turn {turn} "
                                     f"counts {(view != 0).sum()}, the "
                                     f"CSV {csv[turn]}")
        if size == 512:
            gold = read_pgm(os.path.join(REPO, "check", "images",
                                         f"512x512x{turns}.pgm"))
            for turn, board in ((0, world), (turns, gold)):
                if not np.array_equal(tracked[0].wait_turn(turn)[2], board):
                    raise AssertionError(f"512²: the frame at turn {turn} "
                                         "!= check/'s board")
        res["frames_checked"] = len(frames)
        res["frame_turns"] = sorted({fr[0] for fr in frames})
        for t in tracked:
            t.frames.clear()
        rate, _, _, chunk = engine_rate(torch, world, 3.0, eng=eng)
        res["turns_per_s_subscribed"] = rate
        res["frames_during_rate"] = [len(t.snapshot()) for t in tracked]
        # The run ended on a quit: its parked turn, published, equals a
        # fresh view.
        want, turn_end, _ = eng.get_view(SUB_MAX_CELLS)
        srv._bcast[0].publish_now(force=True)
        if not np.array_equal(tracked[1].wait_turn(turn_end)[2], want):
            raise AssertionError(f"{size}²: the frame at the parked turn "
                                 f"{turn_end} != get_view")
        res["view_device_ms"] = view_device_ms(torch, eng, SUB_MAX_CELLS)
    finally:
        for t in tracked:
            t.close()
        eng.kill_prog()
        srv.shutdown()
    log(f"  ok {size}² subscribed: {res['frames_checked']} frames at turns "
        f"{res['frame_turns']} equal the view at their turn (factor {f}); "
        f"{res['turns_per_s_subscribed']:.1f} turns/s with 2 subscribers "
        f"({res['frames_during_rate']} frames each); view "
        f"{res['view_device_ms']:.3f} device ms a publication")
    return res, (csv if csv is not None else hist["counts"])


def sub_world(size: int) -> np.ndarray:
    """The board phase 4i drives at `size`²: the 512² image, or a
    seeded soup."""
    from gol_tpu_torch.io.pgm import read_pgm

    if size == 512:
        return read_pgm(os.path.join(REPO, "images", "512x512.pgm"))
    return seeded_board(size, 15)


def big_view_and_memory(torch, dev, card: Card) -> dict:
    """A 65536² engine (512 MiB of packed words, restored from a legacy
    checkpoint of seeded words): `poll_device_memory` names the card as
    nvidia-smi does and counts at least the board's bytes live; the
    view's device ms a publication."""
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.obs import devstats
    from gol_tpu_torch.ops import bitpack

    size = 65536
    words = bitpack.words_to_numpy(
        seeded_words(torch, size, size // 32, 16, dev))
    eng = Engine(device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{size}x{size}.npz")
        np.savez(path, turn=0, rulestring=CONWAY.rulestring,
                 words=words, width=size)
        del words
        eng.load_checkpoint(path)
    mem = devstats.poll_device_memory()
    name = card.smi.split(",")[0].strip()
    board_bytes = size * size // 8
    if mem["device_kind"] != name:
        raise AssertionError(f"device_kind {mem['device_kind']!r} != "
                             f"nvidia-smi's {name!r}")
    if not mem["supported"] or mem["live_bytes"] < board_bytes:
        raise AssertionError(f"live bytes {mem['live_bytes']} < the "
                             f"board's {board_bytes}")
    ms = view_device_ms(torch, eng, SUB_MAX_CELLS)
    res = dict(size=size, device_kind=mem["device_kind"],
               live_bytes=mem["live_bytes"], peak_bytes=mem["peak_bytes"],
               board_bytes=board_bytes, view_device_ms=ms)
    eng.kill_prog()
    del eng
    torch.cuda.empty_cache()
    log(f"  ok 65536²: poll_device_memory names {mem['device_kind']!r}, "
        f"{mem['live_bytes']} live bytes >= the board's {board_bytes}; "
        f"view {ms:.3f} device ms a publication")
    return res


def served_profiles_and_documents(counts: dict) -> dict:
    """A `python -m gol_tpu_torch.server --metrics-port --profile-dir`
    subprocess on the card (a fresh process, like an operator's server:
    in this one the earlier phases' profiled windows of many thousand
    kernels leave later `torch.profiler` sessions without device
    events). At 512² and 5120² a Profile RPC arms PROFILE_TURNS turns of
    a SUB_BOARDS drive through the client: the status reaches "ok", the
    Chrome trace names K1 / K2, and every (alive, turn) pair Alivecount
    reads around the capture equals `counts` (the CSV, the plain count).
    Then a subscriber, GetTelemetry, GetAudit, GetUsage and the
    gol_bcast_* families on /metrics."""
    import socket
    import urllib.request

    from gol_tpu_torch import Params
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.io.pgm import read_pgm

    with socket.socket() as s:  # a free port for the metrics endpoint
        s.bind(("127.0.0.1", 0))
        mport = s.getsockname()[1]
    res = {"profile": {}}
    with tempfile.TemporaryDirectory() as tmp:
        proc, port = spawn_server(0, "--metrics-port", str(mport),
                                  "--profile-dir", tmp)
        try:
            cli = RemoteEngine(f"127.0.0.1:{port}", timeout=120.0)
            poll = RemoteEngine(f"127.0.0.1:{port}", timeout=60.0)
            for size, turns in SUB_BOARDS:
                if not cli.profile(PROFILE_TURNS)["armed"]:
                    raise AssertionError("Profile did not arm")
                t0 = poll.ping()
                pairs, failed = set(), []

                def drive(size=size, turns=turns) -> None:
                    try:
                        cli.server_distributor(
                            Params(image_width=size, image_height=size,
                                   turns=turns), sub_world(size))
                    except BaseException as e:  # re-raised below
                        failed.append(e)

                runner = threading.Thread(target=drive)
                runner.start()
                while runner.is_alive():
                    pair = poll.alive_count()
                    if pair[1] != t0:
                        pairs.add(pair)
                runner.join()
                if failed:
                    raise failed[0]
                pairs.add(poll.alive_count())
                last = cli.profile()["status"]["last"]
                if last.get("status") != "ok" or len(
                        last["artifacts"]) != 1:
                    raise AssertionError(f"Profile capture: {last}")
                names = trace_kernels(last["artifacts"][0])
                step = ("resident_kernel<Life," if size == 512
                        else "tiled_kernel<Life, 1,")
                if not any(step in n for n in names):
                    raise AssertionError(f"{size}² trace names no {step}: "
                                         f"{sorted(names)[:8]}")
                for alive, turn in pairs:
                    if counts[size][turn] != alive:
                        raise AssertionError(
                            f"{size}²: published ({alive}, {turn}) around "
                            f"the capture != {counts[size][turn]}")
                res["profile"][size] = dict(
                    turns=last["turns"], seconds=last["seconds"],
                    trace_bytes=os.path.getsize(last["artifacts"][0]),
                    pairs_checked=len(pairs),
                    kernels=sorted({n.split("(")[0] for n in names}))
                log(f"  ok Profile {size}²: {last['turns']} turns in "
                    f"{last['seconds']} s, the trace names {step}, "
                    f"{len(pairs)} published pairs around it exact")
            world = read_pgm(os.path.join(REPO, "images", "512x512.pgm"))
            _, turn = cli.server_distributor(
                Params(image_width=512, image_height=512, turns=100), world)
            sub = cli.subscribe(SUB_MAX_CELLS, timeout=60.0)
            try:
                view, vturn, _, _ = sub.recv(timeout=60.0)
            finally:
                sub.close()
            gold = read_pgm(os.path.join(REPO, "check", "images",
                                         "512x512x100.pgm"))
            if (turn, vturn) != (100, 100) or not np.array_equal(view,
                                                                  gold):
                raise AssertionError("the subprocess's frame != check/'s")
            tel = cli.get_telemetry()
            audit = cli.get_audit()
            usage = cli.get_usage()
            if (set(tel) != {"families", "pending_events", "snapshot_max",
                             "ts"} or not isinstance(audit, list)
                    or "attribution" not in usage):
                raise AssertionError(f"documents: {tel} {audit} {usage}")
            text = urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/metrics", timeout=30).read(
                ).decode()
            fams = sorted({m for m in re.findall(r"^(gol_bcast_\w+)", text,
                                                 re.M)})
            keys = re.findall(r'^gol_bcast_frames_total\{kind="key"\} (\S+)',
                              text, re.M)
            if len(fams) < 6 or not keys or float(keys[0]) < 1:
                raise AssertionError(f"/metrics gol_bcast_*: {fams} {keys}")
            health = json.loads(urllib.request.urlopen(
                f"http://127.0.0.1:{mport}/healthz", timeout=30).read())
        finally:
            stop_server(proc)
    res.update(telemetry_keys=sorted(tel), families=tel["families"],
               audit_records=len(audit), usage_keys=sorted(usage),
               metrics_bcast_families=fams,
               healthz_device=health.get("device_kind"))
    log(f"  ok served documents: GetTelemetry {sorted(tel['families'])}, "
        f"GetAudit {len(audit)} records, GetUsage {sorted(usage)}; "
        f"/metrics serves {fams}; /healthz names "
        f"{health.get('device_kind')!r}")
    return res


def log_broadcast_summary(card: Card) -> None:
    """Phase 4i's lines of the summary: the broadcast leg, Subscribe's
    turns/s beside phase 5's unsubscribed engine_rate, the view's device
    ms a publication, the Profile captures and the device memory."""
    leg = BCAST_RESULTS["leg"]
    log(f"phase 4i summary on {card.smi}:")
    log(f"  broadcast leg: encode_calls_per_published_frame "
        f"{leg['encode_calls_per_published_frame']}, viewer_fanout_p99_ms "
        f"{leg['viewer_fanout_p99_ms']:.3f} (p50 "
        f"{leg['viewer_fanout_p50_ms']:.3f}), {leg['viewers']} viewers, "
        f"{leg['frames_published']:.0f} frames published, "
        f"{leg['frames_dropped']:.0f} dropped, {leg['bytes_sent']:.0f} "
        f"bytes sent, {leg['fanout_samples']} deliveries "
        f"({leg['delivered_share']:.3f} of frames x viewers)")
    base = BCAST_RESULTS.get("phase5_turns_per_s", {})
    for r in BCAST_RESULTS["single_run"]:
        plain = base.get(r["size"])
        prof = BCAST_RESULTS["served"]["profile"][r["size"]]
        log(f"  {r['size']}²: {r['turns_per_s_subscribed']:.1f} turns/s "
            f"with 2 subscribers, phase 5's engine_rate without them "
            + (f"{plain:.1f}" if plain is not None else "not measured")
            + f"; view {r['view_device_ms']:.3f} device ms a publication; "
            f"Profile {prof['turns']} turns ok ({prof['kernels']}), trace "
            f"{prof['trace_bytes']} bytes")
    big = BCAST_RESULTS["65536"]
    log(f"  65536²: view {big['view_device_ms']:.3f} device ms a "
        f"publication; device memory {big['live_bytes']} live bytes "
        f"({big['device_kind']})")


def phase_broadcast(torch, dev) -> None:
    """Phase 4i: the broadcast tier and the telemetry surface on the
    card (see the module docstring)."""
    log("phase 4i: the broadcast tier and the telemetry surface")
    BCAST_RESULTS["card"] = nvidia_smi("name,power.limit")
    seconds = {}
    t0 = time.monotonic()
    BCAST_RESULTS["leg"] = broadcast_leg(dev)
    seconds["leg"] = time.monotonic() - t0
    BCAST_RESULTS["single_run"], counts = [], {}
    for size, turns in SUB_BOARDS:
        t0 = time.monotonic()
        res, counts[size] = subscribe_engine(torch, dev, size, turns)
        BCAST_RESULTS["single_run"].append(res)
        seconds[size] = time.monotonic() - t0
    t0 = time.monotonic()
    BCAST_RESULTS["65536"] = big_view_and_memory(torch, dev, Card(torch))
    seconds[65536] = time.monotonic() - t0
    t0 = time.monotonic()
    BCAST_RESULTS["served"] = served_profiles_and_documents(counts)
    seconds["served"] = time.monotonic() - t0
    log("  phase 4i seconds by part: " + json.dumps(
        {k: round(v, 1) for k, v in seconds.items()}))
    log("broadcast:" + json.dumps(BCAST_RESULTS, default=str))


# ------------------------------------ phase 4j: migration and federation

# The JAX bench's federation leg (bench.py:2650-2654) and migration leg
# (:3108-3112), on port members: `python -m gol_tpu_torch.server --fleet
# --checkpoint ROOT --ckpt-every 4 --federate ROUTER` subprocesses on the
# card behind the port's in-process FederationRouter.
FED_ENV = {"GOL_FED_HEARTBEAT": "0.2", "GOL_FED_DEAD_AFTER": "1.2",
           "GOL_FED_REROUTE": "30"}
FED_MEMBERS = 3
FED_RUNS = 6
FED_BOARD = 64
FED_TARGET = 32
FED_WARM_WINDOW_S = 2.0
MIG_MEMBERS = 3
MIG_RUNS = 8
MIG_BOARD = 64
MIG_TARGET = 24
MIG_WARM_WINDOW_S = 1.5
# The migration members' classes: the default three and 4096², so the
# real-size leg's 4096² run (K9 route 2) has a class on both members.
MIG_BUCKETS = "512,1024,2048,4096"
# The real-size leg: (board side, target turn), each run free-running
# toward its target and Rescaled once it passed a quarter of it.
BIG_RUNS = ((2048, 16384), (4096, 4096))
# Phase 4j's numbers, for the summary lines at the end; and the launches
# of every member process a phase started, merged into that phase's.
FED_RESULTS: dict = {}
MEMBER_LAUNCHES: dict = {}

# A member: the server's entry point, beside a thread that writes the
# process's launch counts to a file every 0.1 s (a member may die by
# SIGKILL, so the last file stands for it).
MEMBER_LAUNCHER = (
    "import json, os, sys, threading\n"
    "import chip_smoke\n"
    "from gol_tpu_torch import server\n"
    "from gol_tpu_torch.ops import cuda_stencil as cs\n"
    "def dump(path):\n"
    "    while True:\n"
    "        with open(path + '.tmp', 'w') as f:\n"
    "            json.dump(chip_smoke.main_path_launches(cs), f)\n"
    "        os.replace(path + '.tmp', path)\n"
    "        threading.Event().wait(0.1)\n"
    "threading.Thread(target=dump, args=(sys.argv[1],), daemon=True)"
    ".start()\n"
    "sys.exit(server.main(sys.argv[2:]))\n")


class Members:
    """`n` federated fleet members started together; `env_for(i)` adds
    to member i's environment."""

    def __init__(self, n: int, tmp: str, ckpt_root: str, router_port: int,
                 device: str, env_for=lambda i: {}) -> None:
        self.procs, self.counts, self.addrs = [], [], []
        found = []
        for i in range(n):
            counts = os.path.join(tmp, f"launches-{router_port}-{i}.json")
            env = dict(os.environ, PYTHONPATH=REPO, **FED_ENV,
                       **env_for(i))
            env.pop("SER", None)
            proc = subprocess.Popen(
                [sys.executable, "-u", "-c", MEMBER_LAUNCHER, counts,
                 "--port", "0", "--host", "127.0.0.1", "--fleet",
                 "--device", device, "--checkpoint", ckpt_root,
                 "--ckpt-every", "4", "--federate",
                 f"127.0.0.1:{router_port}", "--advertise", "127.0.0.1"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                env=env, cwd=tmp)
            q: queue.Queue = queue.Queue()

            def scan(proc=proc, q=q):
                for line in proc.stdout:
                    m = re.search(r"serving on :(\d+)", line)
                    if m:
                        q.put(int(m.group(1)))
                q.put(None)

            threading.Thread(target=scan, daemon=True).start()
            self.procs.append(proc)
            self.counts.append(counts)
            found.append(q)
        for q in found:
            try:
                port = q.get(timeout=180)
            except queue.Empty:
                port = None
            if port is None:
                self.stop()
                raise AssertionError("a member gave no banner")
            self.addrs.append(f"127.0.0.1:{port}")

    def kill(self, i: int) -> None:
        os.kill(self.procs[i].pid, signal.SIGKILL)
        self.procs[i].wait(10)

    def launches(self) -> dict:
        total: dict = {}
        for path in self.counts:
            try:
                with open(path) as f:
                    for k, v in json.load(f).items():
                        total[k] = total.get(k, 0) + v
            except (OSError, ValueError):
                pass
        return total

    def stop(self) -> None:
        for k, v in self.launches().items():
            MEMBER_LAUNCHES[k] = MEMBER_LAUNCHES.get(k, 0) + v
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)


def wait_live(router, n: int, timeout: float = 120.0) -> None:
    deadline = time.monotonic() + timeout
    while router.registry.members_doc().get("live", 0) < n:
        if time.monotonic() > deadline:
            raise AssertionError(f"the router never saw {n} live members")
        time.sleep(0.05)


def wait_runs_at(cli, run_ids, turn: int, timeout: float = 240.0) -> dict:
    """{run_id: member} once ListRuns through the router shows every run
    at `turn` or past it."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            recs = {r["run_id"]: r for r in cli.list_runs()[0]}
        except (ConnectionError, RuntimeError):
            recs = {}
        if all(rid in recs and recs[rid]["turn"] >= turn
               for rid in run_ids):
            return {rid: recs[rid]["member"] for rid in run_ids}
        if time.monotonic() > deadline:
            raise AssertionError(f"runs never reached turn {turn}: "
                                 f"{ {r: recs.get(r) for r in run_ids} }")
        time.sleep(0.1)


class Sampler:
    """Routed protected calls (run-scoped Stats through the router):
    (ok, wall s) per call."""

    def __init__(self, cli, ids) -> None:
        self.bound = {rid: cli.for_run(rid) for rid in ids}
        self.samples: list = []

    def call(self, rid) -> bool:
        t0 = time.perf_counter()
        try:
            self.bound[rid].stats()
            ok = True
        except Exception:
            ok = False
        self.samples.append((ok, time.perf_counter() - t0))
        return ok

    def window(self, ids, seconds: float) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for rid in ids:
                self.call(rid)

    def availability_pct(self) -> float:
        calls = len(self.samples)
        failures = sum(1 for ok, _ in self.samples if not ok)
        return 100.0 * (calls - failures) / max(calls, 1)


def check_boards(cli, seeds: dict, target: int, what: str) -> None:
    """Every run through the router at `target`, equal to the numpy
    oracle's replay of its seed."""
    from gol_tpu_torch.ops.reference import run_turns_np

    for rid, seed in seeds.items():
        board, turn = cli.for_run(rid).get_world()
        if turn != target or not np.array_equal(
                (board != 0).astype(np.uint8), run_turns_np(seed, target)):
            raise AssertionError(f"{what}: run {rid} at turn {turn} != the "
                                 f"numpy replay of its seed at {target}")


def p99_ms(values_s) -> float:
    from gol_tpu_torch.obs import slo as obs_slo

    return obs_slo.exact_percentiles(sorted(values_s), (0.99,))[0] * 1e3


def card_memory(torch) -> dict:
    """Device memory in use on the card, by every process on it
    (`torch.cuda.mem_get_info`: one figure for the card, none for each
    process)."""
    free, total = torch.cuda.mem_get_info()
    return {"used_bytes": total - free, "total_bytes": total}


def federation_leg(torch, tmp: str, device: str) -> dict:
    """The JAX bench's federation leg: 3 members, 6 seeded 64² runs
    parked at turn 32 with per-run manifests under one root; after a 2 s
    window of routed traffic, kill_member picks the owner of run 0 and
    the harness SIGKILLs it. The router must declare it dead (one
    failover), adopt its runs onto the survivors, and every run must come
    back at turn 32 equal to the numpy replay of its seed."""
    from gol_tpu_torch import chaos
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.federation.router import FederationRouter
    from gol_tpu_torch.obs import catalog as obs
    from gol_tpu_torch.obs import http as obs_http

    os.environ.update(FED_ENV)
    mem0 = card_memory(torch) if device == "cuda" else None
    router = FederationRouter(port=0).start_background()
    members = None
    try:
        t0 = time.monotonic()
        members = Members(FED_MEMBERS, tmp, os.path.join(tmp, "ck-fed"),
                          router.port, device)
        wait_live(router, FED_MEMBERS)
        start_s = time.monotonic() - t0
        cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=60.0)
        rng = np.random.default_rng(21)
        seeds = {}
        for i in range(FED_RUNS):
            rid = f"b{i}"
            seeds[rid] = (rng.random((FED_BOARD, FED_BOARD))
                          < 0.3).astype(np.uint8)
            cli.create_run(FED_BOARD, FED_BOARD, board=seeds[rid],
                           run_id=rid, ckpt_every=4, target_turn=FED_TARGET)
        ids = sorted(seeds)
        owners = wait_runs_at(cli, ids, FED_TARGET)
        mem = card_memory(torch) if device == "cuda" else None
        sampler = Sampler(cli, ids)
        sampler.window(ids, FED_WARM_WINDOW_S)
        o50, o95, o99 = (v * 1e3 if v is not None else None for v in
                         router._overhead.percentiles((0.50, 0.95, 0.99)))
        if o99 is None:
            raise AssertionError("no steady-state router overhead samples")
        victim = owners["b0"]
        victim_runs = sorted(r for r in ids if owners[r] == victim)
        failovers0 = obs.FED_FAILOVERS.value
        injected0 = obs.CHAOS_INJECTED.labels(kind="kill_member").value
        os.environ["GOL_CHAOS"] = f"kill_member={victim}@0.4,seed=5"
        t_kill = None
        try:
            t_arm = time.perf_counter()
            while t_kill is None:
                elapsed = time.perf_counter() - t_arm
                if elapsed > 10.0:
                    raise AssertionError("kill_member never fired")
                for i, addr in enumerate(members.addrs):
                    if chaos.take_kill_member(addr, i, elapsed):
                        members.kill(i)
                        t_kill = time.perf_counter()
                        break
                else:
                    for rid in ids:
                        sampler.call(rid)
        finally:
            os.environ.pop("GOL_CHAOS", None)
        if obs.CHAOS_INJECTED.labels(kind="kill_member").value \
                != injected0 + 1:
            raise AssertionError("chaos injected no kill_member")
        downtimes = {}

        def recover(rid):
            deadline = time.monotonic() + 90.0
            while time.monotonic() < deadline:
                if sampler.call(rid):
                    downtimes[rid] = time.perf_counter() - t_kill
                    return
                time.sleep(0.05)

        threads = [threading.Thread(target=recover, args=(rid,),
                                    daemon=True) for rid in victim_runs]
        for t in threads:
            t.start()
        while any(t.is_alive() for t in threads):
            for rid in ids:
                if rid not in victim_runs:
                    sampler.call(rid)
            for t in threads:
                t.join(timeout=0.05)
        if sorted(downtimes) != victim_runs:
            raise AssertionError(f"runs never recovered after the kill: "
                                 f"{sorted(set(victim_runs) - set(downtimes))}")
        post = wait_runs_at(cli, ids, FED_TARGET)
        if set(post[r] for r in victim_runs) & {victim}:
            raise AssertionError(f"a run stayed on the dead member: {post}")
        listed = sorted(r["run_id"] for r in cli.list_runs()[0])
        if listed != ids:
            raise AssertionError(f"runs lost or doubled: {listed}")
        check_boards(cli, seeds, FED_TARGET, "federation leg")
        failovers = obs.FED_FAILOVERS.value - failovers0
        if failovers != 1:
            raise AssertionError(f"gol_fed_failovers_total moved by "
                                 f"{failovers}, not 1")
        table = obs_http.healthz_doc()["federation"]
        dead = [m["member_id"] for m in table["members"]
                if m["state"] == "dead"]
        if dead != [victim] or table["live"] != FED_MEMBERS - 1:
            raise AssertionError(f"/healthz member table: {table}")
        return {
            "members": FED_MEMBERS, "runs": FED_RUNS, "size": FED_BOARD,
            "target_turn": FED_TARGET, "member_start_s": start_s,
            "victim_runs": victim_runs,
            "adopted_to": {r: post[r] for r in victim_runs},
            "routed_calls": len(sampler.samples),
            "availability_pct": sampler.availability_pct(),
            "failover_downtime_p99_ms": p99_ms(downtimes.values()),
            "downtime_ms_per_victim_run": {
                r: v * 1e3 for r, v in downtimes.items()},
            "router_overhead_ms": {"p50": o50, "p95": o95, "p99": o99},
            "router_overhead_p99_ms": o99, "failovers": failovers,
            "healthz_dead": len(dead),
            "memory_before_members": mem0, "memory_three_members": mem}
    finally:
        if members is not None:
            members.stop()
        router.shutdown()


def migrations_by_status(addrs) -> dict:
    """gol_migrations_total by status, summed over the members reached."""
    from gol_tpu_torch.client import RemoteEngine

    out: dict = {}
    for a in addrs:
        fam = RemoteEngine(a, timeout=30.0).get_metrics()[
            "gol_migrations_total"]
        for v in fam["values"]:
            s = v["labels"]["status"]
            out[s] = out.get(s, 0) + v["value"]
    return out


def migrate_once(cli, sampler, rid: str, dst: str, stalls: list) -> dict:
    """One Rescale with a reader on the migrating run; a successful
    cutover's client-visible stall (the longest gap between successful
    reads, window edges included) goes into `stalls`."""
    out = {}
    done = threading.Event()

    def call():
        try:
            out["result"] = cli.rescale(rid, dst)
        except Exception as e:
            out["error"] = e
        finally:
            done.set()

    th = threading.Thread(target=call, daemon=True)
    last = time.perf_counter()
    gap = 0.0
    th.start()
    while not done.is_set():
        if sampler.call(rid):
            now = time.perf_counter()
            gap = max(gap, now - last)
            last = now
    th.join()
    deadline = time.monotonic() + 60.0
    while not sampler.call(rid):
        if time.monotonic() > deadline:
            raise AssertionError(f"{rid} unreadable after its Rescale")
        time.sleep(0.02)
    gap = max(gap, time.perf_counter() - last)
    if "error" not in out:
        stalls.append(gap)
    return out


def plain_fleet_board(torch, dev, seed: np.ndarray, turns: int):
    """(board01, alive) of one run's slot stepped `turns` turns by K9's
    plain version."""
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    words = bitpack.words_from_numpy(bitpack.pack_np(seed), dev)[None]
    out, alive = cs.fleet_run_turns_plain(words, turns)
    h, w = seed.shape
    board = bitpack.unpack_np(bitpack.words_to_numpy(out[0]))[:h, :w]
    return board, int(alive[0])


def big_runs_leg(torch, dev, cli, members, clean: list) -> list:
    """The real sizes: a 2048² run (K9 route 1) and a 4096² run (K9 route
    2) on `clean[0]`, each free-running toward its target and Rescaled to
    `clean[1]` mid-flight; at the target, board and alive count equal an
    unmigrated control run of the same seed in this process (K9), held
    against K9's plain version."""
    from gol_tpu_torch.federation import hrw
    from gol_tpu_torch.fleet import FleetEngine

    live = members.addrs
    rows = []
    control = FleetEngine(bucket_sizes=(2048, 4096), device=dev)
    try:
        for side, target in BIG_RUNS:
            rid = next(f"big{side}-{i}" for i in range(10000)
                       if hrw.place(f"big{side}-{i}", live) == clean[0])
            seed = fleet_seed(side, side + 1)
            control.create_run(side, side, board=seed * np.uint8(255),
                               run_id=rid, target_turn=target)
            cli.create_run(side, side, board=seed * np.uint8(255),
                           run_id=rid, target_turn=target)
            bound = cli.for_run(rid)
            deadline = time.monotonic() + 120
            while bound.stats()["turn"] < target // 4:
                if time.monotonic() > deadline:
                    raise AssertionError(f"{rid} never reached a quarter "
                                         "of its target")
                time.sleep(0.002)
            rec = cli.rescale(rid, clean[1])
            if rec["status"] != "ok" or not rec["turn"] < target:
                raise AssertionError(f"{rid}: Rescale not mid-flight: {rec}")
            deadline = time.monotonic() + 300
            while True:
                st = bound.stats()
                if st["turn"] >= target and st["state"] == "parked":
                    break
                if time.monotonic() > deadline:
                    raise AssertionError(f"{rid} never reached {target}")
                time.sleep(0.05)
            view = control.resolve_run(rid)
            while view.stats()["state"] != "parked":
                time.sleep(0.05)
            got, turn = bound.get_world()
            want, want_turn = view.get_world()
            alive = bound.stats()["alive"]
            want_alive = view.stats()["alive"]
            plain, plain_alive = plain_fleet_board(torch, dev, seed, target)
            if (turn != target or want_turn != target
                    or not np.array_equal(got != 0, want != 0)
                    or alive != want_alive):
                raise AssertionError(f"{rid}: migrated run at {turn} != the "
                                     "unmigrated control")
            if (not np.array_equal((want != 0).astype(np.uint8), plain)
                    or want_alive != plain_alive):
                raise AssertionError(f"{rid}: control != K9's plain version")
            owner = {r["run_id"]: r["member"]
                     for r in cli.list_runs()[0]}[rid]
            if owner != clean[1]:
                raise AssertionError(f"{rid} listed on {owner}")
            control.destroy_run(rid)
            cli.destroy_run(rid)
            rows.append({"side": side, "target_turn": target,
                         "quiesce_turn": rec["turn"], "alive": alive,
                         "phase_ms": rec["phase_ms"],
                         "transfer_bytes": rec["transfer_bytes"],
                         "downtime_ms": rec["downtime_ms"]})
            log(f"  ok {side}² run Rescaled at turn {rec['turn']} of "
                f"{target}: board and alive count ({alive}) equal the "
                f"unmigrated control's and K9's plain version; phases "
                f"{json.dumps(rec['phase_ms'])} ms, "
                f"{rec['transfer_bytes']} bytes, downtime "
                f"{rec['downtime_ms']} ms")
    finally:
        control.kill_prog()
    return rows


def migration_leg(torch, dev, tmp: str, device: str) -> dict:
    """The JAX bench's migration leg: 3 members, one armed with
    GOL_CHAOS=migrate_fail=transfer; 8+ seeded 64² runs parked at turn
    24, Rescaled between members while a sampler reads every run. The
    armed member's first Rescale must roll back (the run intact,
    routable, migratable again); clean cutovers ping-pong; then the real
    sizes (`big_runs_leg`); then kill_member@migrating SIGKILLs a source
    mid-Rescale and exactly one listed copy of its run must remain."""
    from gol_tpu_torch import chaos
    from gol_tpu_torch.client import RemoteEngine
    from gol_tpu_torch.federation.router import FederationRouter
    from gol_tpu_torch.obs import catalog as obs

    os.environ.update(FED_ENV)
    router = FederationRouter(port=0).start_background()
    members = None
    mig_env = {"GOL_MIGRATE_DEADLINE": "120", "GOL_FLEET_BUCKETS":
               MIG_BUCKETS}
    try:
        members = Members(
            MIG_MEMBERS, tmp, os.path.join(tmp, "ck-mig"), router.port,
            device, env_for=lambda i: dict(
                mig_env, **({"GOL_CHAOS": "migrate_fail=transfer"}
                            if i == MIG_MEMBERS - 1 else {})))
        wait_live(router, MIG_MEMBERS)
        addrs = members.addrs
        chaos_addr, clean = addrs[-1], addrs[:-1]
        cli = RemoteEngine(f"127.0.0.1:{router.port}", timeout=120.0)
        rng = np.random.default_rng(37)
        seeds = {}

        def create_batch(count):
            for _ in range(count):
                rid = f"m{len(seeds)}"
                seeds[rid] = (rng.random((MIG_BOARD, MIG_BOARD))
                              < 0.3).astype(np.uint8)
                cli.create_run(MIG_BOARD, MIG_BOARD, board=seeds[rid],
                               run_id=rid, ckpt_every=4,
                               target_turn=MIG_TARGET)

        create_batch(MIG_RUNS)
        for _ in range(6):
            owners = wait_runs_at(cli, sorted(seeds), MIG_TARGET)
            by_owner = {a: sorted(r for r, m in owners.items() if m == a)
                        for a in addrs}
            if by_owner[chaos_addr] and sum(
                    len(by_owner[a]) for a in clean) >= 2:
                break
            create_batch(3)
        else:
            raise AssertionError("HRW never placed a run on every member "
                                 "the scenario needs")
        ids = sorted(seeds)
        sampler = Sampler(cli, ids)
        sampler.window(ids, MIG_WARM_WINDOW_S)
        stalls: list = []
        # The armed member's first Rescale fails at transfer and rolls
        # back; the run stays on its source at its turn, and migrates on
        # the next try.
        chaos_rid = by_owner[chaos_addr][0]
        out = migrate_once(cli, sampler, chaos_rid, clean[0], stalls)
        if "rolled back" not in str(out.get("error")):
            raise AssertionError(f"the armed member's Rescale did not roll "
                                 f"back: {out}")
        rec = {r["run_id"]: r for r in cli.list_runs()[0]}[chaos_rid]
        if rec["member"] != chaos_addr or rec["turn"] != MIG_TARGET:
            raise AssertionError(f"rollback left {chaos_rid} as {rec}")
        check_boards(cli, {chaos_rid: seeds[chaos_rid]}, MIG_TARGET,
                     "rolled-back run")
        out = migrate_once(cli, sampler, chaos_rid, clean[0], stalls)
        if "error" in out:
            raise AssertionError(f"{chaos_rid} after its rollback: {out}")
        coordinator_ms = [out["result"]["downtime_ms"]]
        mig_runs = [r for a in clean for r in by_owner[a]][:4]
        for rid in mig_runs:
            src = owners[rid]
            dst = [a for a in clean if a != src][0]
            for hop in (dst, src):
                out = migrate_once(cli, sampler, rid, hop, stalls)
                if "error" in out:
                    raise AssertionError(f"Rescale of {rid} to {hop}: {out}")
                coordinator_ms.append(out["result"]["downtime_ms"])
        check_boards(cli, seeds, MIG_TARGET, "migration leg")
        big = big_runs_leg(torch, dev, cli, members, clean)
        statuses = migrations_by_status(addrs)
        # kill_member@migrating: the source of a Rescale dies mid-cutover.
        victim_rid = mig_runs[0]
        src = owners[victim_rid]
        src_i = addrs.index(src)
        dst = [a for a in clean if a != src][0]
        before_kill = migrations_by_status([a for a in addrs if a != src])
        injected0 = obs.CHAOS_INJECTED.labels(kind="kill_member").value
        os.environ["GOL_CHAOS"] = f"kill_member={src}@migrating"
        killed = False
        kill_out: dict = {}
        kill_done = threading.Event()

        def kill_call():
            try:
                kill_out["result"] = cli.rescale(victim_rid, dst)
            except Exception as e:
                kill_out["error"] = e
            finally:
                kill_done.set()

        try:
            th = threading.Thread(target=kill_call, daemon=True)
            t_arm = time.perf_counter()
            th.start()
            while not killed:
                elapsed = time.perf_counter() - t_arm
                if chaos.take_kill_member(src, src_i, elapsed,
                                          migrating=not kill_done.is_set()):
                    members.kill(src_i)
                    killed = True
                elif kill_done.is_set():
                    break
                else:
                    for rid in ids:
                        if rid != victim_rid:
                            sampler.call(rid)
            th.join(timeout=150.0)
        finally:
            os.environ.pop("GOL_CHAOS", None)
        if not killed or obs.CHAOS_INJECTED.labels(
                kind="kill_member").value != injected0 + 1:
            raise AssertionError("kill_member@migrating never fired")
        wait_runs_at(cli, ids, MIG_TARGET)
        survivors = [a for a in addrs if a != src]
        listed_at = [a for a in survivors
                     for r in RemoteEngine(a, timeout=30.0).list_runs()[0]
                     if r["run_id"] == victim_rid]
        if len(listed_at) != 1:
            raise AssertionError(f"{victim_rid} listed {len(listed_at)} "
                                 f"times after the kill: {listed_at}")
        check_boards(cli, seeds, MIG_TARGET, "after the mid-Rescale kill")
        after_kill = migrations_by_status(survivors)
        for s, n in after_kill.items():
            statuses[s] = statuses.get(s, 0) + n - before_kill.get(s, 0)
        if statuses.get("rolled_back", 0) < 1 or statuses.get("ok", 0) < 9:
            raise AssertionError(f"gol_migrations_total: {statuses}")
        return {
            "members": MIG_MEMBERS, "runs": len(ids), "size": MIG_BOARD,
            "target_turn": MIG_TARGET, "migrations": len(stalls),
            "migration_downtime_p99_ms": p99_ms(stalls),
            "stall_ms": [v * 1e3 for v in stalls],
            "coordinator_downtime_ms": coordinator_ms,
            "availability_pct": sampler.availability_pct(),
            "routed_calls": len(sampler.samples),
            "migrations_by_status": statuses,
            "kill_copies_listed": len(listed_at),
            "kill_rescale_outcome": (str(kill_out.get("error"))[:200]
                                     if "error" in kill_out
                                     else kill_out.get("result")),
            "big_runs": big}
    finally:
        if members is not None:
            members.stop()
        router.shutdown()


def phase_federation(torch, dev) -> None:
    """Phase 4j: migration and federation on the card (see the module
    docstring)."""
    log("phase 4j: federation failover and live migration across "
        "--fleet --federate member processes")
    FED_RESULTS["card"] = nvidia_smi("name,power.limit")
    saved = {k: os.environ.get(k) for k in list(FED_ENV) + ["GOL_CHAOS"]}
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.monotonic()
            FED_RESULTS["federation"] = federation_leg(torch, tmp, "cuda")
            f = FED_RESULTS["federation"]
            log(f"  ok federation leg: the owner of b0 SIGKILLed, "
                f"{len(f['victim_runs'])} runs adopted "
                f"({json.dumps(f['adopted_to'])}), one failover, one death "
                f"on /healthz, every run at turn {FED_TARGET} equal to the "
                f"numpy replay; availability_pct {f['availability_pct']:.3f}"
                f", failover_downtime_p99_ms "
                f"{f['failover_downtime_p99_ms']:.1f}, "
                f"router_overhead_p99_ms {f['router_overhead_p99_ms']:.3f}"
                f" ({time.monotonic() - t0:.1f} s)")
            t0 = time.monotonic()
            FED_RESULTS["migration"] = migration_leg(torch, dev, tmp,
                                                     "cuda")
            m = FED_RESULTS["migration"]
            log(f"  ok migration leg: {m['migrations']} cutovers, the "
                f"armed member's first Rescale rolled back and the run "
                f"migrated on the next, one listed copy after the "
                f"mid-Rescale kill, every board equal to the numpy replay; "
                f"migration_downtime_p99_ms "
                f"{m['migration_downtime_p99_ms']:.1f}, availability_pct "
                f"{m['availability_pct']:.3f}, gol_migrations_total "
                f"{json.dumps(m['migrations_by_status'])} "
                f"({time.monotonic() - t0:.1f} s)")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log("federation:" + json.dumps(FED_RESULTS, default=str))


def log_federation_summary() -> None:
    """Phase 4j's lines of the summary."""
    f, m = FED_RESULTS["federation"], FED_RESULTS["migration"]
    log(f"phase 4j summary on {FED_RESULTS['card']}:")
    log(f"  federation: availability_pct {f['availability_pct']:.3f}, "
        f"failover_downtime_p99_ms {f['failover_downtime_p99_ms']:.1f}, "
        f"router_overhead_p99_ms {f['router_overhead_p99_ms']:.3f} "
        f"({f['routed_calls']} routed calls)")
    log(f"  migration: migration_downtime_p99_ms "
        f"{m['migration_downtime_p99_ms']:.1f}, availability_pct "
        f"{m['availability_pct']:.3f}, gol_migrations_total "
        f"{json.dumps(m['migrations_by_status'])}")
    for r in m["big_runs"]:
        log(f"  {r['side']}² Rescaled at turn {r['quiesce_turn']} of "
            f"{r['target_turn']}: phases {json.dumps(r['phase_ms'])} ms, "
            f"{r['transfer_bytes']} bytes, downtime {r['downtime_ms']} ms")
    mem = f.get("memory_three_members") or {}
    base = f.get("memory_before_members") or {}
    if mem and base:
        log(f"  three members with 6 runs placed: "
            f"{mem['used_bytes'] - base['used_bytes']} bytes of device "
            f"memory (the card's {mem['used_bytes']} in use, "
            f"{base['used_bytes']} before they started)")


# ------------------------------------------ phase 4k: row sharding (A5)

# Meshes that name cuda:0 once a shard: the machinery of `parallel/`
# on one card (the engine's default mesh clamps to one shard there).
MESH_SHARDS = (2, 3, 4, 8)
MESH_BOARD = 5120       # the JAX bench's life-like width (PERF.md §2)
MESH_BIG = 65536
MESH_MULTI_TURNS = 256
# Phase 4k's numbers, for the summary lines and the kernels' records:
# rates (sharded beside unsharded), halo traffic, and each distinct
# window a stepping kernel launched (kernel, shape, T) with its times.
MESH_RESULTS: dict = {"rates": [], "windows": {}}

# One multi-process run: rank `argv[2]` of 2 joins a gloo group at
# `argv[1]`, holds 2 of 4 row shards of the seeded 5120² board on
# cuda:0, steps them MESH_MULTI_TURNS turns (counted) and saves its
# shards, counts and launches to `argv[3]`.
MULTIHOST_RUNNER = (
    "import json, os, sys\n"
    "import numpy as np, torch\n"
    "os.environ.update(GOL_COORDINATOR=sys.argv[1], GOL_NUM_PROCS='2',\n"
    "                  GOL_PROC_ID=sys.argv[2])\n"
    "import chip_smoke\n"
    "from gol_tpu_torch.ops import cuda_stencil as cs\n"
    "from gol_tpu_torch.ops.bitpack import pack_np, words_from_numpy\n"
    "from gol_tpu_torch.parallel import halo, multihost\n"
    "from gol_tpu_torch.parallel.mesh import shard\n"
    "assert multihost.initialize()\n"
    "dev = torch.device('cuda', 0)\n"
    "mesh = multihost.make_global_mesh(4, [dev, dev])\n"
    "assert mesh.backend == 'gloo', mesh.backend\n"
    "world = chip_smoke.seeded_board(chip_smoke.MESH_BOARD, 15)\n"
    "board = shard(words_from_numpy(pack_np(world)), mesh)\n"
    "counts = [torch.zeros(1, dtype=torch.int64, device=dev)\n"
    "          if mesh.local(p) else None for p in range(mesh.size)]\n"
    "torch.cuda.synchronize()\n"
    "import time; t0 = time.perf_counter()\n"
    "out = halo.sharded_packed_run_turns(\n"
    "    board, chip_smoke.MESH_MULTI_TURNS, mesh, count=counts)\n"
    "torch.cuda.synchronize()\n"
    "secs = time.perf_counter() - t0\n"
    "saved = {f'shard_{p}': s.cpu().numpy() for p, s in\n"
    "         enumerate(out.shards) if s is not None}\n"
    "saved.update({f'count_{p}': c.cpu().numpy() for p, c in\n"
    "              enumerate(counts) if c is not None})\n"
    "np.savez(sys.argv[3], seconds=secs,\n"
    "         launches=json.dumps(chip_smoke.main_path_launches(cs)),\n"
    "         **saved)\n"
    "torch.distributed.destroy_process_group()\n")


def window_plain(torch, cs, repr_: str, window, T: int, rule):
    """The plain version of the one launch `_step_window` makes for a
    window of `repr_`: (kernel name, plain result)."""
    from gol_tpu_torch.parallel import halo

    if repr_ == "packed":
        kind = halo.window_kind(tuple(window.shape), T)
        if kind == "resident":
            return ("resident_run_turns",
                    cs.resident_run_turns_plain(window, T, rule))
        if kind == "tiled":
            return "tiled_sweep", cs.tiled_sweep_plain(window, T, rule)
        return "tiled_sweep_deep", cs.tiled_sweep_deep_plain(window, T,
                                                              rule)
    if halo.planes_run_kind(tuple(window.shape)) == "resident":
        return ("resident_run_turns2p",
                cs.resident_run_turns2p_plain(window, T, rule, "gen3"))
    return "tiled_sweep2p", cs.tiled_sweep2p_plain(window, T, rule, "gen3")


@contextlib.contextmanager
def checked_windows(torch, card: Card):
    """While active, the first launch of each distinct (repr, window
    shape, T, counted) that `parallel.halo` steps is held bit-exact
    against its plain version on the same window (and a counted one's
    count against the plain count of its box), and timed beside it.
    The plain versions launch no kernel."""
    from gol_tpu_torch.ops import cuda_stencil as cs
    from gol_tpu_torch.parallel import halo

    step = halo._step_window

    def checked(repr_, window, T, rule, count, box):
        out = step(repr_, window, T, rule, count, box)
        key = (repr_, tuple(window.shape), T, count is not None)
        if (repr_ not in ("packed", "gen3") or key in MESH_RESULTS["seen"]
                or not MESH_RESULTS["check"]):
            return out
        MESH_RESULTS["seen"].add(key)
        name, want = window_plain(torch, cs, repr_, window, T, rule)
        fam = "gen3" if repr_ == "gen3" else None
        name = f"{name}/gen3" if fam else name
        what = f"4k window {name} {tuple(window.shape)} T={T}"
        check_equal(torch, what, out, want, name)
        if count is not None:
            r0, r1, c0, c1 = box
            plane = want[0] if want.dim() == 3 else want
            check_count(what + " counted box", count,
                        plain_count(torch, plane[r0:r1, c0:c1]
                                    .contiguous()), name)
        h, wp = window.shape[-2:]
        per_word = (cs.OPS_PER_WORD_TURN_2P["gen3"] if fam
                    else cs.OPS_PER_WORD_TURN)
        planes = 2 if fam else 1
        bound, by = card.bound(8 * planes * h * wp, per_word * T * h * wp)
        # Timing launches are not the path's: the counters are restored.
        saved = [(fn, fn.launches, dict(getattr(fn, "by_family", {})))
                 for fn in cs.KERNELS]
        ms = time_ms(torch, lambda: step(repr_, window, T, rule, None,
                                         None), 5)
        for fn, n, fams in saved:
            fn.launches = n
            if fams:
                fn.by_family = fams
        MESH_RESULTS["windows"].setdefault(name, []).append({
            "shape": list(window.shape), "turns": T, "ms": ms,
            "plain_ms": time_ms(torch, lambda: window_plain(
                torch, cs, repr_, window, T, rule), 1),
            "bound_ms": bound, "bound_by": by})
        return out

    MESH_RESULTS["seen"] = set()
    MESH_RESULTS["check"] = True
    halo._step_window = checked
    try:
        yield
    finally:
        halo._step_window = step


@contextlib.contextmanager
def unchecked():
    """Timed runs: no window is checked (or timed) meanwhile."""
    MESH_RESULTS["check"] = False
    try:
        yield
    finally:
        MESH_RESULTS["check"] = True


def halo_deltas(cat_before: dict) -> dict:
    from gol_tpu_torch.obs import catalog as cat

    return {a: (cat.HALO_EXCHANGES.labels(axis=a).value
                - cat_before[a][0],
                cat.HALO_BYTES.labels(axis=a).value - cat_before[a][1])
            for a in ("rows", "cols")}


def halo_values() -> dict:
    from gol_tpu_torch.obs import catalog as cat

    return {a: (cat.HALO_EXCHANGES.labels(axis=a).value,
                cat.HALO_BYTES.labels(axis=a).value)
            for a in ("rows", "cols")}


def mesh_run_check(torch, what: str, run, board, want, turns: int,
                   unsharded_s: float, traffic: dict) -> None:
    """Run a sharded dispatch; hold the gathered board against `want`
    (the unsharded run), the shards' summed count against its plain
    popcount and the gol_halo_* deltas against `traffic`; then time it
    again with no window checked and log turns/s beside the unsharded
    rate."""
    counts = [torch.zeros(1, dtype=torch.int64, device=s.device)
              for s in board.shards]
    before = halo_values()
    out = run(board, counts)
    delta = {a: v for a, v in halo_deltas(before).items() if v != (0, 0)}
    with unchecked():
        _, secs = timed(torch, lambda: run(board, counts))
    got = out.gather()
    if not torch.equal(got[:want.shape[-2]], want):
        raise AssertionError(f"4k {what}: sharded board != unsharded")
    total = sum(int(c) for c in counts)
    if total != plain_count(torch, want):
        raise AssertionError(f"4k {what}: counted {total} != popcount "
                             f"{plain_count(torch, want)}")
    want_t = {a: tuple(v) for a, v in traffic.items()}
    if delta != want_t:
        raise AssertionError(f"4k {what}: gol_halo_* {delta} != "
                             f"halo_traffic {want_t}")
    row = {"what": what, "turns": turns,
           "turns_per_s": turns / secs,
           "unsharded_turns_per_s": turns / unsharded_s,
           "halo": {a: {"rounds": r, "bytes": b}
                    for a, (r, b) in delta.items()},
           "alive": total}
    MESH_RESULTS["rates"].append(row)
    log(f"  ok 4k {what}: bit-identical to the unsharded board, count "
        f"{total}; {row['turns_per_s']:.1f} turns/s sharded beside "
        f"{row['unsharded_turns_per_s']:.1f} unsharded; halo "
        f"{json.dumps(row['halo'])}")


def timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def mesh_1d(torch, dev) -> None:
    """The 1-D ring at 5120² over 2, 3, 4 and 8 shards of cuda:0 (3: the
    exact-N wrap extension), 1024 turns (T = 16, K2 windows) and 1023
    (the per-turn path); 65536² over 4 at 32 turns and at fuse 64 (T =
    64, K6 windows)."""
    from gol_tpu_torch.ops.bitpack import pack_np, words_from_numpy
    from gol_tpu_torch.parallel import halo
    from gol_tpu_torch.parallel.mesh import make_mesh, shard

    words = words_from_numpy(pack_np(seeded_board(MESH_BOARD, 15)), dev)
    for turns in (1024, 1023):
        want = halo.packed_run_turns(words, turns, halo.CONWAY)
        _, secs = timed(torch, lambda: halo.packed_run_turns(
            words, turns, halo.CONWAY))
        for n in MESH_SHARDS:
            mesh = make_mesh(n, [dev] * n)
            ext = halo.exact_shard_ext(MESH_BOARD, n)
            if ext:
                ewords = words_from_numpy(halo.extend_rows(
                    words.cpu().numpy().view(np.uint32), ext), dev)
                board = shard(ewords, mesh)
                run = (lambda b, c, ext=ext, mesh=mesh:
                       halo.extended_run_turns(
                           b, turns, mesh, height=MESH_BOARD, ext=ext,
                           packed=True, count=c))
                traffic = {}
            else:
                board = shard(words, mesh)
                run = (lambda b, c, mesh=mesh: halo.sharded_packed_run_turns(
                    b, turns, mesh, count=c))
                traffic = halo.halo_traffic("packed", tuple(words.shape),
                                            mesh, turns)
            mesh_run_check(torch, f"{MESH_BOARD}² x {turns} over {n}"
                           + (f" (exact-N, ext {ext})" if ext else ""),
                           run, board, want, turns, secs, traffic)
    del words
    big = seeded_words(torch, MESH_BIG, MESH_BIG // 32, 16, dev)
    mesh = make_mesh(4, [dev] * 4)
    for turns, fuse in ((32, 0), (64, 64)):
        want = halo.fused_packed_run_turns(big, turns, halo.CONWAY, fuse)
        _, secs = timed(torch, lambda: halo.fused_packed_run_turns(
            big, turns, halo.CONWAY, fuse))
        mesh_run_check(
            torch, f"{MESH_BIG}² x {turns} over 4" + (
                f" at GOL_FUSE_K={fuse}" if fuse else ""),
            lambda b, c: halo.sharded_packed_run_turns(
                b, turns, mesh, fuse=fuse, count=c),
            shard(big, mesh), want, turns, secs,
            halo.halo_traffic("packed", tuple(big.shape), mesh, turns,
                              fuse))
        del want
    del big


def engine_world(eng_args: dict, world, turns: int, subs=(), rule=None):
    """(pixels, turn, alive pair, stats, seconds) of one engine run."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine import Engine

    eng = Engine(**eng_args) if rule is None else Engine(rule=rule,
                                                          **eng_args)
    h, w = world.shape
    t0 = time.perf_counter()
    out, turn = eng.server_distributor(
        Params(threads=1, image_width=w, image_height=h, turns=turns),
        world, sub_workers=subs)
    secs = time.perf_counter() - t0
    return out, turn, eng.alive_count(), eng.stats(), secs


def mesh_engine(torch, dev, images: str, tmp: str) -> None:
    """The contract through `run` (SUB of 4 on `Engine(devices=[cuda:0]
    * 4)`, the goldens), GOL_MESH=2x2 at 1024² and 4096², Brian's Brain
    over 4 (K4, K5 windows), Star Wars over 3 (gen8, exact-N), each
    engine board against the one-shard engine's; and the default
    engine, whose SUB of 4 runs one shard on the one card."""
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.models import parse_rule

    four = {"devices": [dev] * 4}
    os.environ["SUB"] = ",".join(f"fake:{8030 + i}" for i in range(4))
    try:
        for size, turns in GOLDENS:
            out = os.path.join(tmp, f"g{size}x{turns}")
            os.makedirs(out, exist_ok=True)
            from gol_tpu_torch import Params, events as ev
            from gol_tpu_torch.io.pgm import read_pgm

            eng = Engine(**four)
            evs, _ = drive(Params(image_width=size, image_height=size,
                                  turns=turns), images, out, engine=eng)
            final = [e for e in evs if isinstance(e, ev.FinalTurnComplete)]
            gold = os.path.join(REPO, "check", "images",
                                f"{size}x{size}x{turns}.pgm")
            ys, xs = np.nonzero(read_pgm(gold))
            if set(final[0].alive) != set(zip(xs.tolist(), ys.tolist())):
                raise AssertionError(f"4k golden {size}² x {turns} over 4 "
                                     "!= golden")
            with open(os.path.join(out, f"{size}x{size}x{turns}.pgm"),
                      "rb") as f, open(gold, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError(f"4k golden {size}² x {turns}: "
                                         "PGM bytes")
            if eng.stats()["mesh"]["shards"] != 4:
                raise AssertionError(f"4k golden {size}²: "
                                     f"{eng.stats()['mesh']}")
        log("  ok 4k goldens through run with SUB of 4 on "
            "Engine(devices=[cuda:0] * 4): alive sets and PGM bytes")
    finally:
        os.environ.pop("SUB", None)
    for spec, size, turns in (("2x2", 1024, 2048), ("2x2", 4096, 512)):
        world = seeded_board(size, 17)
        os.environ["GOL_MESH"] = spec
        try:
            got = engine_world(four, world, turns)
            with unchecked():
                timed_got = engine_world(four, world, turns)
        finally:
            os.environ.pop("GOL_MESH", None)
        one = engine_world({"device": dev}, world, turns)
        engine_pair_check(f"GOL_MESH={spec} {size}² x {turns}", got, one,
                          {"rows": 2, "cols": 2}, turns, timed_got)
    for rule, size, turns, n in (("/2/3", 512, 200, 4),
                                 ("/2/3", 4096, 100, 4),
                                 ("345/2/4", 512, 100, 3)):
        r = parse_rule(rule)
        from gol_tpu_torch.models.generations import gray_levels

        rng = np.random.default_rng(size + n)
        levels = gray_levels(r)
        world = levels[rng.integers(0, len(levels), size=(size, size))]
        subs = [f"fake:{i}" for i in range(n)]
        got = engine_world({"devices": [dev] * n}, world, turns, subs, r)
        with unchecked():
            timed_got = engine_world({"devices": [dev] * n}, world, turns,
                                     subs, r)
        one = engine_world({"device": dev}, world, turns, (), r)
        engine_pair_check(f"{rule} {size}² x {turns} over {n}", got, one,
                          {"rows": n}, turns, timed_got)
    world = seeded_board(MESH_BOARD, 18)
    subs = [f"fake:{i}" for i in range(4)]
    default = Engine()
    if len(default._devices) != torch.cuda.device_count():
        raise AssertionError("Engine() is not the visible CUDA devices")
    rates = {}
    for label, s in (("SUB of 4", subs), ("no SUB", ())):
        from gol_tpu_torch import Params

        t0 = time.perf_counter()
        default.server_distributor(
            Params(threads=1, image_width=MESH_BOARD,
                   image_height=MESH_BOARD, turns=65536), world,
            sub_workers=s)
        rates[label] = 65536 / (time.perf_counter() - t0)
        st = default.stats()
        if torch.cuda.device_count() == 1 and (
                st["devices"] != 1 or st["mesh"]["shards"] != 1):
            raise AssertionError(f"4k default engine {label}: {st}")
    MESH_RESULTS["default_engine"] = rates
    log(f"  ok 4k Engine() with a SUB of 4 on one card: 1 device, 1 "
        f"shard in Stats; 5120² x 65536: {rates['SUB of 4']:.1f} turns/s "
        f"beside {rates['no SUB']:.1f} without SUB")


def engine_pair_check(what: str, got, one, axes: dict, turns: int,
                      timed_got) -> None:
    """An engine's checked run `got` against the one-shard engine's run
    `one`; `timed_got` (the same run, no window checked) gives the
    rate."""
    out, turn, pair, stats, _ = got
    out1, turn1, pair1, _, secs1 = one
    secs = timed_got[4]
    if turn != turns or turn1 != turns or not np.array_equal(out, out1):
        raise AssertionError(f"4k {what}: engine board != one shard's")
    if pair != pair1:
        raise AssertionError(f"4k {what}: alive pair {pair} != {pair1}")
    if stats["mesh"]["axes"] != axes:
        raise AssertionError(f"4k {what}: mesh {stats['mesh']}")
    MESH_RESULTS["rates"].append({
        "what": what + " (engine)", "turns": turns,
        "turns_per_s": turns / secs, "unsharded_turns_per_s": turns / secs1,
        "alive": pair[0]})
    log(f"  ok 4k {what}: engine board equals the one-shard engine's, "
        f"alive {pair[0]}; {turns / secs:.1f} turns/s beside "
        f"{turns / secs1:.1f} (wall of a whole run, submit included)")


def mesh_multihost(torch, dev, tmp: str) -> None:
    """Two processes on cuda:0, 2 of 4 shards each, over gloo (NCCL
    refuses two ranks on one card): their gathered shards equal the
    unsharded run's board and their counts its popcount."""
    import socket

    from gol_tpu_torch.ops.bitpack import pack_np, words_from_numpy
    from gol_tpu_torch.parallel import halo

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, PYTHONPATH=REPO)
    outs = [os.path.join(tmp, f"multihost-{r}.npz") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_RUNNER, f"127.0.0.1:{port}",
         str(r), outs[r]], env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(10)
    for r, (p, text) in enumerate(zip(procs, logs)):
        if p.returncode:
            raise AssertionError(f"4k multihost rank {r}: exit "
                                 f"{p.returncode}\n{text[-3000:]}")
    shards, total, secs = {}, 0, []
    for path in outs:
        with np.load(path) as z:
            secs.append(float(z["seconds"]))
            for name, n in json.loads(str(z["launches"])).items():
                MEMBER_LAUNCHES[name] = MEMBER_LAUNCHES.get(name, 0) + n
            for k in z.files:
                if k.startswith("shard_"):
                    shards[int(k[6:])] = z[k]
                elif k.startswith("count_"):
                    total += int(z[k][0])
    got = np.concatenate([shards[p] for p in range(4)])
    words = words_from_numpy(pack_np(seeded_board(MESH_BOARD, 15)), dev)
    want, one_s = timed(torch, lambda: halo.packed_run_turns(
        words, MESH_MULTI_TURNS, halo.CONWAY))
    if not np.array_equal(got, want.cpu().numpy()):
        raise AssertionError("4k multihost: gathered shards != unsharded")
    if total != plain_count(torch, want):
        raise AssertionError(f"4k multihost: count {total}")
    rate = MESH_MULTI_TURNS / max(secs)
    MESH_RESULTS["rates"].append({
        "what": f"{MESH_BOARD}² x {MESH_MULTI_TURNS}, 2 processes x 2 "
                "shards, gloo", "turns": MESH_MULTI_TURNS,
        "turns_per_s": rate,
        "unsharded_turns_per_s": MESH_MULTI_TURNS / one_s, "alive": total})
    log(f"  ok 4k multihost: 2 processes x 2 shards on cuda:0 over gloo "
        f"(halos staged through pinned host buffers) equal the unsharded "
        f"board, count {total}; {rate:.1f} turns/s beside "
        f"{MESH_MULTI_TURNS / one_s:.1f} unsharded")


def phase_mesh(torch, dev) -> None:
    """4k: row sharding and halo exchange on meshes of cuda:0."""
    card = Card(torch)
    tmp = tempfile.mkdtemp(prefix="gol_4k_")
    images = os.path.join(REPO, "images")
    t0 = time.monotonic()
    try:
        with checked_windows(torch, card):
            mesh_1d(torch, dev)
            log(f"  4k 1-D rings took {time.monotonic() - t0:.1f} s")
            mesh_engine(torch, dev, images, tmp)
            log(f"  4k engines took {time.monotonic() - t0:.1f} s")
        mesh_multihost(torch, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  4k windows checked against their plain versions: "
        f"{len(MESH_RESULTS['seen'])} distinct (repr, shape, T, counted)")


def log_mesh_summary(card: Card) -> None:
    log(f"4k row sharding on {card.smi} (meshes of cuda:0: the sharded "
        f"rates measure the machinery, not what one card's user gets):")
    for row in MESH_RESULTS["rates"]:
        log("  4k " + json.dumps(row))
    for name, rows in MESH_RESULTS["windows"].items():
        for row in rows:
            log(f"  4k window {name} {json.dumps(row)}")
    log("  4k default engine turns/s: "
        + json.dumps(MESH_RESULTS.get("default_engine", {})))


# --------------- phase 4l: fleet mesh placement, sharded sparse windows
#
# Meshes of cuda:0 only, as in 4k: on one card the sharded rates measure
# the machinery (a block or a shard a position, the halo exchange), not
# what a user of one card gets, and each is printed beside the unsharded
# rate of the same work.

FM_CHUNK = 8             # the fleet's serving quantum (turns)
FM_QUANTA = 8            # quanta held bucket against bucket, one by one
# Batch placement: (runs, class side, devices).
FM_BATCH = ((64, 512, 4), (8, 1024, 2))
FM_SPATIAL = 2048        # a class below batch occupancy: spatial over 4
FM_SPATIAL_DEVICES = 4
FM_SPATIAL_TARGETS = (13, 21)   # exact targets: quanta of 8 and a trim
FM_QUARANTINE_TARGET = 40
FM_RATE_S = 1.5          # a free-running fleet's counted window
SPARSE_SHARDS = (2, 4)
C1_BOARDS = ((512, 20000), (5120, 2000))   # (side, turns)
FM_RESULTS: dict = {"rates": [], "windows": {}, "seen": set(),
                    "check": True}


@contextlib.contextmanager
def checked_fleet_windows(torch, card: Card):
    """While active, the first K9 launch on each distinct spatial window
    (shape, T) is held bit-exact against `fleet_run_turns_plain` on the
    same windows with the same box (words and every slot's boxed count)
    and timed beside it; the timing launches are not the path's."""
    from gol_tpu_torch.fleet import buckets
    from gol_tpu_torch.ops import cuda_stencil as cs

    step = buckets.step_slot_windows

    def checked(windows, turns, rule, box):
        out, alive = step(windows, turns, rule, box)
        key = (tuple(windows.shape), turns)
        if key in FM_RESULTS["seen"] or not FM_RESULTS["check"]:
            return out, alive
        FM_RESULTS["seen"].add(key)
        name = f"fleet_run_turns/{cs.fleet_run_kind(tuple(windows.shape))}"
        want, want_alive = cs.fleet_run_turns_plain(windows, turns, rule,
                                                    box=box)
        what = f"4l spatial window {name} {tuple(windows.shape)} T={turns}"
        check_equal(torch, what, out, want, name)
        check_equal(torch, f"{what} box {box} counts", alive, want_alive,
                    name)
        cap, h, wp = windows.shape
        bound, by = card.bound(8 * cap * h * wp,
                               cs.OPS_PER_WORD_TURN * turns * cap * h * wp)
        saved = [(fn, fn.launches) for fn in cs.KERNELS]
        routes = dict(cs.fleet_run_turns.by_route)
        ms = time_ms(torch, lambda: step(windows, turns, rule, box), 5)
        for fn, n in saved:
            fn.launches = n
        cs.fleet_run_turns.by_route = routes
        FM_RESULTS["windows"].setdefault(name, []).append({
            "shape": list(windows.shape), "turns": turns, "box": list(box),
            "ms": ms, "plain_ms": time_ms(torch, lambda: cs
                                          .fleet_run_turns_plain(
                                              windows, turns, rule,
                                              box=box), 1),
            "bound_ms": bound, "bound_by": by, "card": card.smi})
        return out, alive

    FM_RESULTS["seen"] = set()
    buckets.step_slot_windows = checked
    try:
        yield
    finally:
        buckets.step_slot_windows = step


def fm_rate(card: Card, what: str, sharded: float, unsharded: float,
            unit: str, **extra) -> None:
    """Log and keep one rate beside the unsharded rate of the same work."""
    row = {"what": what, unit: sharded, f"unsharded_{unit}": unsharded,
           "card": card.smi, **extra}
    FM_RESULTS["rates"].append(row)
    log(f"  4l {what}: {row[unit]:.1f} {unit} sharded beside "
        f"{row['unsharded_' + unit]:.1f} unsharded ({card.smi})")


def fm_buckets(torch, dev, card: Card) -> None:
    """Batch placement bucket against bucket: the same seeds in a batch
    Bucket over `n` positions of cuda:0 and in a one-device Bucket; after
    every quantum the words and per-slot counts are equal, and each
    run's slot equals its board stepped alone by K1 or K2. Then a
    quantum of each is timed (one, many, many, one)."""
    from gol_tpu_torch.fleet.buckets import Bucket
    from gol_tpu_torch.fleet.handles import RunHandle
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs
    from gol_tpu_torch.parallel.halo import packed_run_turns
    from gol_tpu_torch.parallel.mesh import make_batch_mesh

    for runs, size, n in FM_BATCH:
        one = Bucket(size, size, CONWAY, slot_base=runs, device=dev)
        many = Bucket(size, size, CONWAY, slot_base=runs,
                      placement="batch", mesh=make_batch_mesh([dev] * n))
        boards = []
        for i in range(runs):
            seed = fleet_seed(size, 20_000 + i)
            one.place(RunHandle(f"b{i}", CONWAY, size, size), seed)
            many.place(RunHandle(f"b{i}", CONWAY, size, size), seed)
            boards.append(bitpack.words_from_numpy(bitpack.pack_np(seed),
                                                   dev))
        if many.cap != one.cap or len(many.parts) != n:
            raise AssertionError(f"4l batch {size}²: cap {many.cap} in "
                                 f"{len(many.parts)} blocks")
        for q in range(FM_QUANTA):
            a1 = one.dispatch(FM_CHUNK)
            an = many.dispatch(FM_CHUNK)
            boards = [packed_run_turns(b, FM_CHUNK, CONWAY) for b in boards]
            want = torch.stack(boards)
            if not (torch.equal(many.words, one.words)
                    and torch.equal(many.words[:runs], want)):
                raise AssertionError(f"4l batch {runs} x {size}² over {n}: "
                                     f"words differ after quantum {q}")
            if not (torch.equal(an, a1) and torch.equal(
                    an[:runs], cs.slot_popcounts(want))):
                raise AssertionError(f"4l batch {runs} x {size}² over {n}: "
                                     f"counts differ after quantum {q}")
        log(f"  ok 4l batch {runs} x {size}² over {n} positions: words and "
            f"counts equal the one-device bucket and K1/K2 on each board "
            f"after each of {FM_QUANTA} quanta ({card.smi})")
        secs = {}
        for tag, b in (("one", one), ("many", many), ("many", many),
                       ("one", one)):
            _, t = timed(torch, lambda b=b: b.dispatch(FM_CHUNK))
            secs.setdefault(tag, []).append(t)
        cells = runs * size * size * FM_CHUNK
        fm_rate(card, f"batch bucket {runs} x {size}² over {n}, a quantum "
                f"of {FM_CHUNK}", cells / min(secs["many"]),
                cells / min(secs["one"]), "cell_updates_per_s")
        del one, many, boards


def fm_free_running(torch, dev, card: Card, runs: int, size: int,
                    devices: int, **kw) -> float:
    """Cell updates/s of `runs` free-running size² runs over FM_RATE_S
    in a FleetEngine on `devices` positions of cuda:0; run b0's board is
    held against its K1/K2 replay at its turn."""
    from gol_tpu_torch.fleet import FleetEngine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import bitpack
    from gol_tpu_torch.parallel.halo import packed_run_turns

    eng = FleetEngine(devices=[dev] * devices, bucket_sizes=(size,),
                      slot_base=kw.get("slot_base", runs))
    try:
        for i in range(runs):
            eng.create_run(size, size, board=fleet_seed(size, 30_000 + i),
                           run_id=f"b{i}", wait=False)
        deadline = time.monotonic() + 120
        while eng.runs_summary()["resident"] < runs:
            if time.monotonic() > deadline:
                raise AssertionError("4l fleet placement timed out")
            time.sleep(0.02)
        time.sleep(0.5)
        c0 = eng.throughput_counters()
        t0 = time.perf_counter()
        time.sleep(FM_RATE_S)
        c1 = eng.throughput_counters()
        elapsed = time.perf_counter() - t0
        placement = eng.stats()["fleet"]["buckets"][0]["placement"]
        board, turn = eng.resolve_run("b0").get_world()
    finally:
        eng.kill_prog()
    words = bitpack.words_from_numpy(bitpack.pack_np(
        fleet_seed(size, 30_000)), dev)
    want = bitpack.unpack_np(bitpack.words_to_numpy(
        packed_run_turns(words, turn, CONWAY))) * np.uint8(255)
    if not np.array_equal(board, want):
        raise AssertionError(f"4l fleet {runs} x {size}² on {devices}: b0 "
                             f"at turn {turn} != its replay")
    log(f"  ok 4l fleet {runs} x {size}² on {devices} position(s) "
        f"({placement}): b0 at turn {turn} equals its replay")
    return (c1["cell_updates"] - c0["cell_updates"]) / elapsed


def fm_spatial(torch, dev, card: Card, tmp: str) -> None:
    """A 2048² class over 4 positions with GOL_FLEET_MIN_SLOTS_PER_DEV
    making the spatial placement win: exact targets (a trim through the
    sharded path), a quarantine restored from its cadence checkpoint,
    and a migrate_quiesce readback, each against K2 on the board."""
    from gol_tpu_torch import chaos
    from gol_tpu_torch.fleet import FleetEngine
    from gol_tpu_torch.models.lifelike import CONWAY
    from gol_tpu_torch.ops import bitpack
    from gol_tpu_torch.parallel.halo import packed_run_turns

    n = FM_SPATIAL

    def replay(seed, turns):
        words = bitpack.words_from_numpy(bitpack.pack_np(seed), dev)
        return bitpack.unpack_np(bitpack.words_to_numpy(
            packed_run_turns(words, turns, CONWAY)))

    def parked(eng, rid):
        rv = eng.resolve_run(rid)
        deadline = time.monotonic() + 120
        while rv.describe_run()["state"] != "parked":
            if time.monotonic() > deadline:
                raise AssertionError(f"4l spatial run {rid} never parked")
            time.sleep(0.02)
        board, turn = rv.get_world()
        return (board != 0).astype(np.uint8), turn

    env = {"GOL_FLEET_MIN_SLOTS_PER_DEV": "4",
           "GOL_CKPT": os.path.join(tmp, "ck"),
           "GOL_QUARANTINE_BACKOFF": "0.05"}
    os.environ.update(env)
    eng = FleetEngine(devices=[dev] * FM_SPATIAL_DEVICES,
                      bucket_sizes=(n,), chunk_turns=FM_CHUNK, slot_base=8)
    try:
        seeds = {}
        for t in FM_SPATIAL_TARGETS:
            seeds[t] = fleet_seed(n, 40_000 + t)
            eng.create_run(n, n, board=seeds[t], run_id=f"t{t}",
                           target_turn=t)
        for t in FM_SPATIAL_TARGETS:
            board, turn = parked(eng, f"t{t}")
            if turn != t or not np.array_equal(board, replay(seeds[t], t)):
                raise AssertionError(f"4l spatial target {t}: turn {turn}, "
                                     "board != K2's")
        row = eng.stats()["fleet"]["buckets"][0]
        if row["placement"] != "spatial" or row["devices"] != 4:
            raise AssertionError(f"4l spatial bucket: {row}")
        log(f"  ok 4l spatial {n}² over {FM_SPATIAL_DEVICES}: exact targets "
            f"{FM_SPATIAL_TARGETS} equal K2 on each board")

        qseed = fleet_seed(n, 41_000)
        eng.create_run(n, n, board=qseed, run_id="clean", ckpt_every=8,
                       target_turn=FM_QUARANTINE_TARGET)
        clean, _ = parked(eng, "clean")
        from gol_tpu_torch.obs import catalog as obs_cat

        q0 = obs_cat.RUNS_QUARANTINED.labels(reason="popcount").value
        os.environ[chaos.ENV] = "poison=victim@20,seed=1"
        chaos.injector()
        eng.create_run(n, n, board=qseed, run_id="victim", ckpt_every=8,
                       target_turn=FM_QUARANTINE_TARGET)
        victim, vturn = parked(eng, "victim")
        os.environ.pop(chaos.ENV, None)
        quarantined = obs_cat.RUNS_QUARANTINED.labels(
            reason="popcount").value - q0
        if (vturn != FM_QUARANTINE_TARGET or quarantined != 1
                or not np.array_equal(victim, clean) or not np.array_equal(
                    clean, replay(qseed, FM_QUARANTINE_TARGET))):
            raise AssertionError(f"4l spatial quarantine: turn {vturn}, "
                                 f"{quarantined} quarantined, boards differ")
        log(f"  ok 4l spatial quarantine restored from its checkpoint: "
            f"turn {vturn} equals the clean run and K2")

        mseed = fleet_seed(n, 42_000)
        eng.create_run(n, n, board=mseed, run_id="mv")
        rv = eng.resolve_run("mv")
        while rv.describe_run()["turn"] < 2 * FM_CHUNK:
            time.sleep(0.01)
        rec = eng.migrate_quiesce("mv")
        if not np.array_equal(rec["board"], replay(mseed, rec["turn"])):
            raise AssertionError(f"4l spatial migrate_quiesce at turn "
                                 f"{rec['turn']}: board != K2's")
        log(f"  ok 4l spatial migrate_quiesce readback at turn "
            f"{rec['turn']} equals K2 on the board")
    finally:
        eng.kill_prog()
        os.environ.pop(chaos.ENV, None)
        for k in env:
            os.environ.pop(k, None)


def fm_sparse(torch, dev, card: Card) -> None:
    """The R-pentomino on the 2^20 torus for 65,536 turns through
    SparseEngine unsharded and over 2 and 4 positions of cuda:0, with a
    pinned chunk ladder: every publication's (turn, count, window shape,
    origin), the margins, grows, episodes and final cells are equal, and
    the count is 116 from turn 1,103 on."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.models.sparse import R_PENTOMINO
    from gol_tpu_torch.sparse_engine import SparseEngine

    n = SPARSE_SIZE
    seed = np.zeros((3, 3), dtype=np.uint8)
    for x, y in R_PENTOMINO:
        seed[y, x] = 255
    os.environ["GOL_CHUNK_TARGET"] = "1000"
    runs = {}
    try:
        for shards in (1,) + SPARSE_SHARDS:
            eng = SparseEngine(n, devices=[dev] * shards, shards=shards)
            pubs = []
            publish = eng._publish_locked

            def record(alive=None, eng=eng, pubs=pubs, publish=publish):
                publish(alive)
                words, ox, oy, turn, count = eng._pub
                pubs.append((turn, count, tuple(words.shape), ox, oy))

            eng._publish_locked = record
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eng.server_distributor(Params(image_width=n, image_height=n,
                                          turns=SPARSE_STABLE_TURN), seed)
            eng.server_distributor(
                Params(image_width=n, image_height=n,
                       turns=SPARSE_LONG_TURNS - SPARSE_STABLE_TURN), None,
                start_turn=SPARSE_STABLE_TURN)
            secs = time.perf_counter() - t0
            torus = eng._torus
            runs[shards] = dict(
                pubs=pubs, secs=secs, window=torus.window_shape(),
                origin=(torus._ox, torus._oy), margins=torus._margins(),
                grows=torus.grows, episodes=torus.margin_fetches,
                cells=window_cells(eng.get_window(), n),
                devices=eng.stats()["devices"])
            eng.kill_prog()
            del eng, torus
            late = [c for t, c, *_ in pubs if t >= SPARSE_STABLE_TURN]
            if set(late) != {SPARSE_STABLE_ALIVE} or pubs[-1][0] != \
                    SPARSE_LONG_TURNS:
                raise AssertionError(f"4l sparse over {shards}: counts "
                                     f"{sorted(set(late))} from turn "
                                     f"{SPARSE_STABLE_TURN}")
    finally:
        os.environ.pop("GOL_CHUNK_TARGET", None)
    base = runs[1]
    for shards in SPARSE_SHARDS:
        r = runs[shards]
        same = {k: r[k] == base[k] for k in ("pubs", "window", "origin",
                                             "margins", "grows", "episodes",
                                             "cells")}
        if not all(same.values()) or r["devices"] != shards:
            raise AssertionError(f"4l sparse over {shards}: {same}, "
                                 f"{r['devices']} devices")
        log(f"  ok 4l sparse 2^20 x {SPARSE_LONG_TURNS} over {shards}: "
            f"{len(r['pubs'])} publications, window {r['window']} at "
            f"{r['origin']}, {r['grows']} grows, {r['episodes']} episodes "
            f"and {len(r['cells'])} cells equal the unsharded run's")
        fm_rate(card, f"sparse 2^20 x {SPARSE_LONG_TURNS} over {shards}",
                SPARSE_LONG_TURNS / r["secs"],
                SPARSE_LONG_TURNS / base["secs"], "turns_per_s",
                window=list(r["window"]), grows=r["grows"],
                episodes=r["episodes"])


def c1_overhead(torch, dev, card: Card) -> None:
    """C1 on the card: the engine's chunk_overhead_us after a run at 512²
    (K1) and 5120² (K2) is positive and equal to its gauge."""
    from gol_tpu_torch import Params
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.obs import catalog as obs_cat

    for size, turns in C1_BOARDS:
        eng = Engine()
        eng.server_distributor(Params(threads=1, image_width=size,
                                      image_height=size, turns=turns),
                               seeded_board(size, 7))
        us = eng.stats()["chunk_overhead_us"]
        gauge = obs_cat.ENGINE_CHUNK_OVERHEAD_US.value
        eng.kill_prog()
        if not (us > 0 and abs(gauge - us) <= 0.011):
            raise AssertionError(f"4l C1 {size}²: chunk_overhead_us {us}, "
                                 f"gauge {gauge}")
        FM_RESULTS.setdefault("chunk_overhead_us", {})[f"{size}²"] = us
        log(f"  ok 4l C1 {size}² x {turns}: chunk_overhead_us {us} equals "
            f"the gauge ({gauge:.4f}) ({card.smi})")


def phase_fleet_mesh(torch, dev) -> None:
    """4l: fleet mesh placement (batch, spatial) and sharded sparse
    windows on meshes of cuda:0, and C1's gauge on the card."""
    card = Card(torch)
    tmp = tempfile.mkdtemp(prefix="gol_4l_")
    t0 = time.monotonic()
    try:
        with checked_fleet_windows(torch, card):
            fm_buckets(torch, dev, card)
            for runs, size, n in FM_BATCH:
                one = fm_free_running(torch, dev, card, runs, size, 1)
                many = fm_free_running(torch, dev, card, runs, size, n)
                fm_rate(card, f"fleet {runs} free-running {size}² over "
                        f"{n} (batch)", many, one, "cell_updates_per_s")
            fm_spatial(torch, dev, card, tmp)
            os.environ["GOL_FLEET_MIN_SLOTS_PER_DEV"] = "4"
            try:
                many = fm_free_running(torch, dev, card, 4, FM_SPATIAL,
                                       FM_SPATIAL_DEVICES, slot_base=8)
            finally:
                os.environ.pop("GOL_FLEET_MIN_SLOTS_PER_DEV", None)
            one = fm_free_running(torch, dev, card, 4, FM_SPATIAL, 1,
                                  slot_base=8)
            fm_rate(card, f"fleet 4 free-running {FM_SPATIAL}² over "
                    f"{FM_SPATIAL_DEVICES} (spatial)", many, one,
                    "cell_updates_per_s")
        log(f"  4l fleet took {time.monotonic() - t0:.1f} s")
        fm_sparse(torch, dev, card)
        log(f"  4l sparse took {time.monotonic() - t0:.1f} s")
        c1_overhead(torch, dev, card)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not FM_RESULTS["windows"]:
        raise AssertionError("4l checked no spatial window")
    log(f"  4l spatial windows checked against fleet_run_turns_plain: "
        f"{len(FM_RESULTS['seen'])} distinct (shape, T)")


def log_fleet_mesh_summary(card: Card) -> None:
    log(f"4l fleet mesh placement and sharded sparse windows on {card.smi} "
        "(meshes of cuda:0: the sharded rates measure the machinery):")
    for row in FM_RESULTS["rates"]:
        log("  4l " + json.dumps(row))
    log("  4l chunk_overhead_us: "
        + json.dumps(FM_RESULTS.get("chunk_overhead_us", {})))


# -- 4m: the live view and the native host layer ---------------------------

# The unbounded 512² live run lasts LIVE_SECONDS, and then until it has
# drawn LIVE_MIN_FRAMES + 2 frames, LIVE_DEADLINE_S at most. A frame is a
# newly published board: a view reads the newest board the engine has
# issued, so each poll waits for the chunk that made it, behind the
# chunks in flight (~0.44 s a chunk at 512² by default). The same run at
# LIVE_SHORT_TARGET (the chunk's target seconds, GOL_CHUNK_TARGET) shows
# the polls shrinking with the chunks.
LIVE_SECONDS = 3.0
LIVE_MIN_FRAMES = 10
LIVE_DEADLINE_S = 30.0
LIVE_SHORT_TARGET = 0.025
LIVE_BIG = 5120           # the bounded live run, downsampled frames
LIVE_BIG_TURNS = 1000
# The glider lattice: one glider a GLIDER_TILE² tile of the LIVE_BIG²
# torus, all moving alike, so the board never settles and every board is
# the tile's (a GLIDER_TILE² torus) repeated. Drawn through loop.start
# until LIVE_GLIDER_FRAMES frames with diffs, LIVE_DEADLINE_S at most.
GLIDER_TILE = 40
LIVE_GLIDER_FRAMES = 5
NATIVE_SIZES = (512, 5120)
LIVE_RESULTS: dict = {}


def native_codec(torch, card: Card, tmp: str) -> None:
    """4m: the port's C++ host layer built on this host; the 512² golden
    and a seeded 5120² board read through it (host ms beside the numpy
    path, which `levels=` takes), and its write byte-equal to io.pgm's
    (numpy) write, with the write's host ms."""
    from gol_tpu_torch import native
    from gol_tpu_torch.io.pgm import MAXVAL, read_pgm, write_pgm

    t0 = time.perf_counter()
    if native.lib() is None:
        raise AssertionError("4m: the native library did not build (the "
                             "native.build_failed line says why)")
    log(f"  ok 4m native library {native.library_path()} "
        f"({(time.perf_counter() - t0) * 1e3:.1f} ms to load)")
    numpy_path = (0, MAXVAL)
    for size in NATIVE_SIZES:
        src = os.path.join(REPO, "images", f"{size}x{size}.pgm")
        board = (read_pgm(src, levels=numpy_path) if size == 512
                 else seeded_board(size, size))
        path = os.path.join(tmp, f"numpy_{size}.pgm")
        t0 = time.perf_counter()
        write_pgm(path, board)
        ms = {"write_numpy": (time.perf_counter() - t0) * 1e3}
        for codec, levels in (("native", None), ("numpy", numpy_path)):
            t0 = time.perf_counter()
            got = read_pgm(path, levels=levels)
            ms[f"read_{codec}"] = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(got, board):
                raise AssertionError(f"4m {size}²: the {codec} read != "
                                     "the board")
        native_path = os.path.join(tmp, f"native_{size}.pgm")
        if not native.write_pgm(native_path, board):
            raise AssertionError(f"4m {size}²: the native write failed")
        with open(native_path, "rb") as f, open(path, "rb") as g:
            if f.read() != g.read():
                raise AssertionError(f"4m {size}²: native PGM bytes != "
                                     "the numpy path's")
        if size == 512:
            with open(path, "rb") as f, open(src, "rb") as g:
                if f.read() != g.read():
                    raise AssertionError("4m 512²: PGM bytes != "
                                         "images/512x512.pgm")
        LIVE_RESULTS.setdefault("codec_ms", {})[f"{size}²"] = ms
        log(f"  ok 4m PGM {size}²: native and numpy bytes equal; host ms "
            f"{json.dumps({k: round(v, 3) for k, v in ms.items()})} "
            f"({card.smi})")
    log(f"  phase 4's goldens were read by: "
        f"{json.dumps(LIVE_RESULTS['phase4_codec'])}")


class _TapQueue(queue.Queue):
    """An events queue that keeps every event its consumer takes."""

    def __init__(self) -> None:
        super().__init__()
        self.taken: list = []

    def get(self, block=True, timeout=None):
        e = super().get(block, timeout)
        self.taken.append(e)
        return e


def live_512(torch, dev, card: Card, chunk_target=None) -> None:
    """4m: `run(..., live_view=True)` on a CUDA engine at 512², unbounded,
    its events consumed by `sdl.loop.start` into a window that checks
    each frame: at every TurnComplete(t) the window's popcount is the CSV
    count (t <= 10,000) or the settled ash's, the last frame equals the
    host oracle's board, every polled (alive, turn) is exact, and the run
    itself launched K1. Each poll records its host ms, how far the view's
    turn ran ahead of the pair published when it began, when the work
    queued on the engine's stream at its start drained and when the
    view's turn was published: which handle the view's copy waits for.
    `chunk_target` sets GOL_CHUNK_TARGET for the run."""
    import gol_tpu_torch
    from gol_tpu_torch import Params, events as ev, native
    from gol_tpu_torch.engine import CHUNK_TARGET_ENV, Engine
    from gol_tpu_torch.fixtures import ASH_512_SETTLED_BY, ash_512_alive
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.ops import cuda_stencil as cs
    from gol_tpu_torch.sdl import loop
    from gol_tpu_torch.sdl.window import Window

    key = "512" if chunk_target is None else "512_short_chunks"
    csv_counts = read_csv(os.path.join(REPO, "check", "alive",
                                       "512x512.csv"))

    def want(t: int) -> int:
        return csv_counts[t] if t <= ASH_512_SETTLED_BY else ash_512_alive(t)

    frames, flips = [], [0]

    class CheckedWindow(Window):
        def flip_pixel(self, x: int, y: int) -> None:
            flips[0] += 1
            super().flip_pixel(x, y)

        def render_frame(self, status: str = "") -> None:
            t = int(status.split()[-1])
            frames.append((t, int(self._pixels.sum()), flips[0]))
            flips[0] = 0
            if frames[-1][1] != want(t):
                raise AssertionError(f"4m 512² live frame at turn {t}: "
                                     f"{frames[-1][1]} alive, want {want(t)}")
            super().render_frame(status)

    images = os.path.join(REPO, "images")
    p = Params(image_width=512, image_height=512, turns=10**12)
    eng = Engine()
    # Per poll: host ms, view turn - published turn, chunk, start, view
    # turn; and [start, an event recorded on the engine's stream at the
    # start, when the main loop saw it complete].
    polls, marks = [], []
    get_view = eng.get_view
    cuda = torch.cuda.is_available()

    def timed_view(max_cells):
        published = eng.alive_count()[1]
        t0 = time.monotonic()
        if cuda:
            mark = torch.cuda.Event()
            mark.record()  # the current stream: the one the chunks run on
            marks.append([t0, mark, None])
        out = get_view(max_cells)
        ms = (time.monotonic() - t0) * 1e3
        polls.append((ms, out[1] - published, eng.stats()["chunk"], t0,
                      out[1]))
        return out

    eng.get_view = timed_view
    win = CheckedWindow(512, 512)
    events_q, keys = _TapQueue(), queue.Queue()
    failed = []

    def consume() -> None:
        try:
            loop.start(p, events_q, None, window=win)
        except BaseException as e:  # re-raised on the main thread
            failed.append(e)

    if chunk_target is not None:
        os.environ[CHUNK_TARGET_ENV] = str(chunk_target)
    k1_before = cs.resident_run_turns.launches
    try:
        with tempfile.TemporaryDirectory() as tmp:
            t = gol_tpu_torch.run(p, events_q, keys, engine=eng,
                                  images_dir=images, out_dir=tmp,
                                  live_view=True)
            viewer = threading.Thread(target=consume)
            viewer.start()
            seen, pairs = [], set()
            t_start = time.monotonic()
            t_end = None
            while t.is_alive() and viewer.is_alive():
                alive, turn = eng.alive_count()
                now = time.monotonic()
                for m in marks[-3:]:
                    if m[2] is None and m[1].query():
                        m[2] = now
                if turn > 0:
                    pairs.add((alive, turn))
                    seen.append((now, turn))
                    t_end = t_end or now + LIVE_SECONDS
                if t_end is not None and now >= t_end and (
                        len(frames) >= LIVE_MIN_FRAMES + 2
                        or now - t_start >= LIVE_DEADLINE_S):
                    break
                time.sleep(0.0005)
            live_s = time.monotonic() - t_start
            keys.put("q")
            t.join(60)
            viewer.join(60)
    finally:
        os.environ.pop(CHUNK_TARGET_ENV, None)
    k1 = cs.resident_run_turns.launches - k1_before
    if t.is_alive() or viewer.is_alive():
        raise AssertionError("4m 512² live run did not end after 'q'")
    if failed:
        raise failed[0]
    if t.exception is not None:
        raise t.exception
    if k1 <= 0:
        raise AssertionError(f"4m {key} live run launched K1 {k1} times")
    for alive, turn in pairs:
        if alive != want(turn):
            raise AssertionError(f"4m 512² polled ({alive}, {turn}), want "
                                 f"{want(turn)}")
    for e in events_q.taken:
        if isinstance(e, ev.AliveCellsCount) \
                and e.cells_count != want(e.completed_turns):
            raise AssertionError(f"4m 512² ticker {e}: want "
                                 f"{want(e.completed_turns)}")
    if len(frames) < LIVE_MIN_FRAMES:
        raise AssertionError(f"4m {key} live run drew {len(frames)} frames "
                             f"in {live_s:.1f} s (polls, host ms: "
                             f"{[round(v[0], 1) for v in polls]})")
    # The last frame against the host oracle: the ash is period 2 from
    # turn 10,000, which the oracle checks.
    start = (read_pgm(os.path.join(images, "512x512.pgm")) != 0)
    last = frames[-1][0]
    if last >= ASH_512_SETTLED_BY:
        settled = native.step_torus(start.astype(np.uint8),
                                    ASH_512_SETTLED_BY)
        if not np.array_equal(native.step_torus(settled, 2), settled):
            raise AssertionError("4m: the 512² ash is not period 2")
        oracle = native.step_torus(settled,
                                   (last - ASH_512_SETTLED_BY) % 2)
    else:
        oracle = native.step_torus(start.astype(np.uint8), last)
    if not np.array_equal(win._pixels, oracle != 0):
        raise AssertionError(f"4m 512² last frame (turn {last}) != the "
                             "host oracle's board")
    steady = first_sightings(seen)
    steady = steady[len(steady) // 4:] if len(steady) >= 8 else steady
    live_rate = publication_rate(steady)
    # A poll's predicted wait: the turns its view ran ahead of the
    # published pair, at the run's rate (the polls of the chunk ramp,
    # before any chunk was published, left out).
    traced = [(ms, ahead, chunk) for ms, ahead, chunk, _, _ in polls
              if 0 < ahead <= 4 * chunk]
    # Which handle a poll waits on: the work queued on the engine's
    # stream at its start (the event's completion), or the chunk that
    # made its board (the first sighting of that turn's pair).
    drained = [(m[2] - m[0]) * 1e3 for m in marks if m[2] is not None]
    board_ready = []
    for _, _, _, t0, view_turn in polls:
        at = next((t for t, turn in seen if t >= t0 and turn >= view_turn),
                  None)
        if at is not None:
            board_ready.append((at - t0) * 1e3)
    cells = [c for _, _, c in frames]
    LIVE_RESULTS[key] = {
        "chunk_target_s": chunk_target, "frames": len(frames),
        "seconds": live_s, "last_turn": last,
        "frames_per_s": len(frames) / live_s,
        "cells_flipped_per_frame_median": statistics.median(cells),
        "cells_flipped_first_frame": cells[0],
        "poll_host_ms_median": statistics.median(v[0] for v in polls),
        "poll_host_ms_max": max(v[0] for v in polls), "polls": len(polls),
        "poll_chunks_ahead_median": statistics.median(
            ahead / chunk for _, ahead, chunk in traced) if traced else None,
        "poll_predicted_ms_median": statistics.median(
            ahead / live_rate * 1e3 for _, ahead, _ in traced)
        if traced and live_rate else None,
        "poll_stream_drained_ms_median": statistics.median(drained)
        if drained else None,
        "poll_board_published_ms_median": statistics.median(board_ready)
        if board_ready else None,
        "chunk_turns": polls[-1][2], "turns_per_s_live": live_rate,
        "polled_pairs": len(pairs), "k1_launches": k1}
    log(f"  ok 4m {key} live: {len(frames)} frames to turn {last}, each "
        f"popcount the CSV's or the ash's, the last the oracle's board; "
        f"{len(pairs)} polled pairs exact; "
        f"{json.dumps(LIVE_RESULTS[key])} ({card.smi})")


def glider_tile(t: int) -> np.ndarray:
    """The GLIDER_TILE² torus holding one glider, at turn t (the glider
    repeats every 4 * GLIDER_TILE turns there), stepped with numpy."""
    tile = np.zeros((GLIDER_TILE, GLIDER_TILE), np.uint8)
    tile[1, 2] = tile[2, 3] = tile[3, 1] = tile[3, 2] = tile[3, 3] = 1
    for _ in range(t % (4 * GLIDER_TILE)):
        n = sum(np.roll(np.roll(tile, dy, 0), dx, 1)
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)) - tile
        tile = ((n == 3) | ((tile == 1) & (n == 2))).astype(np.uint8)
    return tile


def live_gliders(torch, dev, card: Card) -> None:
    """4m: a LIVE_BIG² glider lattice, unbounded, its events drained by
    `sdl.loop.start` into the window loop.start opens itself: the
    downsampled view's size, and at every TurnComplete(t) the view of the
    lattice at t, rebuilt from the tile's oracle. The board never
    settles, so the frames carry diffs; the window's 'q' ends the run,
    which launched K2."""
    import gol_tpu_torch
    from gol_tpu_torch import Params
    from gol_tpu_torch.distributor import live_view_shape
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import write_pgm
    from gol_tpu_torch.ops import cuda_stencil as cs
    from gol_tpu_torch.sdl import loop
    from gol_tpu_torch.sdl.window import Window

    size, reps = LIVE_BIG, LIVE_BIG // GLIDER_TILE
    rows, cols = live_view_shape(size, size)
    f = size // rows
    frames, flips, quit_sent = [], [0], []

    def want(t: int) -> np.ndarray:
        tile = glider_tile(t)
        view = tile.reshape(GLIDER_TILE // f, f, GLIDER_TILE // f,
                            f).max(axis=(1, 3))
        return np.tile(view, (reps, reps)) != 0

    class CheckedWindow(Window):
        def flip_pixel(self, x: int, y: int) -> None:
            flips[0] += 1
            super().flip_pixel(x, y)

        def render_frame(self, status: str = "") -> None:
            t = int(status.split()[-1])
            frames.append((t, flips[0], self._pixels.shape))
            flips[0] = 0
            if not np.array_equal(self._pixels, want(t)):
                raise AssertionError(f"4m glider frame at turn {t} != the "
                                     "lattice's view")
            super().render_frame(status)

        def poll_event(self):
            drawn = sum(1 for _, n, _ in frames[1:] if n)
            if not quit_sent and (drawn >= LIVE_GLIDER_FRAMES
                                  or time.monotonic() > deadline):
                quit_sent.append(time.monotonic())
                return "q"
            return None

    p = Params(image_width=size, image_height=size, turns=10**12)
    board = np.tile(glider_tile(0), (reps, reps)) * np.uint8(255)
    k2_before = cs.tiled_sweep.launches
    opened = loop.Window
    loop.Window = CheckedWindow
    try:
        with tempfile.TemporaryDirectory() as tmp:
            seed_dir = os.path.join(tmp, "images")
            write_pgm(os.path.join(seed_dir, f"{size}x{size}.pgm"), board)
            events_q, keys = queue.Queue(), queue.Queue()
            t0 = time.monotonic()
            deadline = t0 + LIVE_DEADLINE_S
            t = gol_tpu_torch.run(p, events_q, keys, engine=Engine(),
                                  images_dir=seed_dir, out_dir=tmp,
                                  live_view=True)
            loop.start(p, events_q, keys)
            seconds = time.monotonic() - t0
            t.join(60)
    finally:
        loop.Window = opened
    k2 = cs.tiled_sweep.launches - k2_before
    if t.is_alive() or t.exception is not None:
        raise AssertionError(f"4m glider run: alive {t.is_alive()}, "
                             f"{t.exception!r}")
    drawn = [n for _, n, _ in frames[1:] if n]
    if (len(drawn) < LIVE_GLIDER_FRAMES or k2 <= 0
            or any(shape != (rows, cols) for _, _, shape in frames)):
        raise AssertionError(f"4m glider run: {len(frames)} frames, "
                             f"{len(drawn)} with diffs, K2 launched {k2}, "
                             f"window {frames[0][2] if frames else None}")
    LIVE_RESULTS["gliders"] = {
        "board": size, "tile": GLIDER_TILE, "view": [rows, cols],
        "factor": f, "frames": len(frames), "frames_with_diffs": len(drawn),
        "cells_flipped_per_frame_median": statistics.median(drawn),
        "last_turn": frames[-1][0], "seconds": seconds,
        "k2_launches": k2}
    log(f"  ok 4m {size}² glider lattice live through loop.start: every "
        f"frame the lattice's {rows}x{cols} view at its turn; "
        f"{json.dumps(LIVE_RESULTS['gliders'])} ({card.smi})")


def live_5120(torch, dev, card: Card) -> None:
    """4m: a 5120² live run of 1000 turns, paused at its start so frames
    arrive: every frame get_view's downsampled shape within
    GOL_LIVE_MAX_CELLS (no get_world), the first against the plain
    board's view, and the final PGM equal to the plain version."""
    import gol_tpu_torch
    from gol_tpu_torch import Params, events as ev
    from gol_tpu_torch.distributor import LIVE_MAX_CELLS_DEFAULT
    from gol_tpu_torch.engine import Engine
    from gol_tpu_torch.io.pgm import read_pgm, write_pgm
    from gol_tpu_torch.ops import bitpack, cuda_stencil as cs

    size, cap = LIVE_BIG, LIVE_MAX_CELLS_DEFAULT
    board = seeded_board(size, size)
    eng = Engine()
    views, worlds = [], [0]
    get_view = eng.get_view

    def spy_view(max_cells):
        out = get_view(max_cells)
        views.append((out[0].shape, out[1], tuple(out[2]), out[0].copy()))
        return out

    def spy_world():
        worlds[0] += 1
        raise AssertionError(f"4m {size}² live view asked for the world")

    eng.get_view, eng.get_world = spy_view, spy_world
    events_q, keys = queue.Queue(), queue.Queue()
    keys.put("p")  # the engine parks at its first chunk boundary
    k2_before = cs.tiled_sweep.launches
    with tempfile.TemporaryDirectory() as tmp:
        seed_dir = os.path.join(tmp, "images")
        write_pgm(os.path.join(seed_dir, f"{size}x{size}.pgm"), board)
        out = os.path.join(tmp, "out")
        t = gol_tpu_torch.run(
            Params(image_width=size, image_height=size,
                   turns=LIVE_BIG_TURNS), events_q, keys, engine=eng,
            images_dir=seed_dir, out_dir=out, live_view=True)
        deadline = time.monotonic() + 60
        while len(views) < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        keys.put("p")
        t.join(120)
        if t.is_alive():
            raise AssertionError(f"4m {size}² live run did not end")
        if t.exception is not None:
            raise t.exception
        got = read_pgm(os.path.join(
            out, f"{size}x{size}x{LIVE_BIG_TURNS}.pgm"))
    k2 = cs.tiled_sweep.launches - k2_before
    evs = ev.drain(events_q)
    if worlds[0] or not views or k2 <= 0:
        raise AssertionError(f"4m {size}²: {len(views)} views, "
                             f"{worlds[0]} world reads, {k2} K2 launches")
    for shape, turn, (fy, fx), _ in views:
        if (fy != fx or fy <= 1 or shape != (-(-size // fy),) * 2
                or shape[0] * shape[1] > cap):
            raise AssertionError(f"4m {size}² frame {shape} at factor "
                                 f"{(fy, fx)}")
    shape, turn, (f, _), first = views[0]
    words = bitpack.words_from_numpy(bitpack.pack_np(board), dev)
    at = bitpack.packed_run_turns(words, turn) if turn else words
    if not np.array_equal(first, host_view(bitpack.words_to_numpy(at), f)):
        raise AssertionError(f"4m {size}² first frame (turn {turn}) != the "
                             "plain board's view")
    turns = [e.completed_turns for e in evs
             if isinstance(e, ev.TurnComplete)]
    flipped = [c for e in evs if isinstance(e, ev.CellsFlipped)
               for c in e.cells]
    if not turns or any(not (0 <= x < shape[1] and 0 <= y < shape[0])
                        for x, y in flipped):
        raise AssertionError(f"4m {size}²: {len(turns)} frames, cells "
                             "outside the view")
    plain = bitpack.packed_run_turns(words, LIVE_BIG_TURNS)
    want = bitpack.unpack_np(bitpack.words_to_numpy(plain)) * 255
    if not np.array_equal(got, want):
        raise AssertionError(f"4m {size}² live: board != plain version")
    LIVE_RESULTS["big"] = {"views": len(views), "frames": len(turns),
                            "view_shape": list(shape), "factor": f,
                            "paused_at": turn, "k2_launches": k2}
    log(f"  ok 4m {size}² x {LIVE_BIG_TURNS} live: "
        f"{json.dumps(LIVE_RESULTS['big'])}, every frame view-sized "
        f"(<= {cap} cells), no world read, the first equal to the plain "
        "board's view, the final board the plain version's")


def halfblocks(card: Card) -> None:
    """4m: `native.render_halfblocks` of a 512² frame against the numpy
    glyph mapping the window falls back to, with host ms of each."""
    from gol_tpu_torch import native
    from gol_tpu_torch.io.pgm import read_pgm
    from gol_tpu_torch.sdl.window import halfblocks_np

    frame = read_pgm(os.path.join(REPO, "check", "images",
                                  "512x512x100.pgm"))
    ms = {}
    for name, fn in (("native", native.render_halfblocks),
                     ("numpy", halfblocks_np)):
        t0 = time.perf_counter()
        text = fn(frame)
        ms[name] = (time.perf_counter() - t0) * 1e3
        ms[f"{name}_text"] = text
    if ms.pop("native_text") != ms.pop("numpy_text"):
        raise AssertionError("4m render_halfblocks != the numpy glyphs")
    LIVE_RESULTS["halfblocks_ms"] = ms
    log(f"  ok 4m render_halfblocks 512²: equal to the numpy glyphs; host "
        f"ms {json.dumps({k: round(v, 3) for k, v in ms.items()})} "
        f"({card.smi})")


def phase_live_view(torch, dev) -> None:
    """4m: the native host layer; the live view at 512² (by default and
    with short chunks), of a 5120² glider lattice and of a bounded 5120²
    run; the half-block renderer. Each live run checks its own launches:
    the phase's gate alone would pass on any of them."""
    card = Card(torch)
    log("phase 4m: the live view and the native host layer")
    os.environ["GOL_HEADLESS"] = "1"  # the windows draw no SDL here
    t0 = time.monotonic()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            native_codec(torch, card, tmp)
        live_512(torch, dev, card)
        live_512(torch, dev, card, chunk_target=LIVE_SHORT_TARGET)
        live_gliders(torch, dev, card)
        live_5120(torch, dev, card)
        halfblocks(card)
    finally:
        os.environ.pop("GOL_HEADLESS", None)
    log(f"  4m took {time.monotonic() - t0:.1f} s")


def log_live_summary(card: Card) -> None:
    log(f"4m live view and native host layer on {card.smi}:")
    LIVE_RESULTS["512_turns_per_s_phase5_engine_rate"] = BCAST_RESULTS.get(
        "phase5_turns_per_s", {}).get(512)
    for key, row in LIVE_RESULTS.items():
        log(f"  4m {key}: " + json.dumps(row))


def main_path_launches(cs) -> dict:
    """Launches per kernel on the main path; the two-plane kernels per
    family, as `name/family`, and K9 per route, as `name/route`."""
    launches = {fn.__name__: fn.launches for fn in cs.KERNELS
                if fn not in cs.KERNELS_2P and fn is not cs.fleet_run_turns}
    for fn in cs.KERNELS_2P:
        for fam, n in fn.by_family.items():
            launches[f"{fn.__name__}/{fam}"] = n
    for route, n in cs.fleet_run_turns.by_route.items():
        launches[f"fleet_run_turns/{route}"] = n
    return launches


# Device kernel names (as the profiler reports them, without
# "(anonymous namespace)::") of each wrapper.
KERNEL_SYMBOLS = (
    ("resident_kernel<Life, true, true>", "fleet_run_turns/resident"),
    ("resident_kernel<Life, false, true>", "fleet_run_turns/resident"),
    ("tiled_kernel<Life, 1, 128, true>", "fleet_run_turns/tiled"),
    ("tiled_kernel<Life, 1, 384, true>", "fleet_run_turns/tiled"),
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


# The main-path phases whose alive counts come from chunks alone.
CHUNK_COUNTED_PHASES = (phase_main_path, phase_controls, phase_fused,
                        phase_control_plane)


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
    log("phase 2: building the kernels with nvcc, the host layer with g++")
    from gol_tpu_torch import native

    t_host = time.monotonic()
    host = threading.Thread(target=native.lib)  # beside nvcc
    host.start()
    _build.library()
    rec = _build.build_record()
    log(f"  built {rec['path']} in {rec['seconds']:.1f} s"
        f"{' (cached)' if rec['cached'] else ''}")
    host.join()
    if native.lib() is None:
        raise AssertionError("the native host layer did not build (the "
                             "native.build_failed line says why)")
    log(f"  built {native.library_path()} with g++ "
        f"({time.monotonic() - t_host:.1f} s, beside nvcc)")
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
    phase_kernels_counted(torch, dev)
    phase_kernels_ltl(torch, dev)
    phase_kernels_occupancy(torch, dev)
    phase_kernels_fleet(torch, dev)
    sparse_reference(torch, dev)
    fleet_reference(torch, dev)
    # Each path runs with the counters at 0 and is read just after; each
    # must have launched every kernel (and family) it runs. The profiler
    # sums the device time of the profiled paths by kernel.
    # The phases whose counts come from chunks alone (the goldens, the
    # CSV ticker, the fused runs, SER) must launch K3 no time: the count
    # rides each chunk's last stepping launch. 4b's `GenerationsTorus`
    # and 4e's restores count boards no chunk just stepped (K3).
    launches, device_ms, profiled = {}, {}, {}
    for phase, kernels, prof_on in (
            (phase_main_path, ("resident_run_turns", "tiled_sweep"), True),
            (phase_controls, ("resident_run_turns",), False),
            (phase_generations, ("resident_run_turns2p/gen3",
                                 "resident_run_turns2p/gen4",
                                 "tiled_sweep2p/gen3",
                                 "tiled_sweep2p/gen4"), True),
            (phase_fused, ("tiled_sweep_deep", "tiled_sweep"), True),
            (phase_control_plane, ("resident_run_turns", "tiled_sweep",
                                   "resident_run_turns2p/gen3"), False),
            (phase_checkpoints, ("resident_run_turns", "tiled_sweep",
                                 "row_popcounts",
                                 "tiled_sweep2p/gen3"), False),
            (phase_conv, ("ltl_resident_run_turns", "ltl_box_run_turns"),
             True),
            (phase_sparse, ("resident_run_turns", "tiled_sweep",
                            "window_occupancy"), True),
            (phase_fleet, ("fleet_run_turns/resident",
                           "fleet_run_turns/tiled", "resident_run_turns",
                           "tiled_sweep"), True),
            # 4i runs torch.profiler itself (the Profile captures).
            (phase_broadcast, ("fleet_run_turns/resident",
                               "resident_run_turns", "tiled_sweep"),
             False),
            # 4j's runs step in member processes (their launches are
            # merged in) and in this one (the real-size controls).
            (phase_federation, ("fleet_run_turns/resident",
                                "fleet_run_turns/tiled"), False),
            # 4k's sharded windows; its multi-process run's launches are
            # merged in from the two processes.
            (phase_mesh, ("resident_run_turns", "tiled_sweep",
                          "tiled_sweep_deep", "resident_run_turns2p/gen3",
                          "tiled_sweep2p/gen3"), False),
            # 4l's batch blocks and spatial windows (K9 route 1 with its
            # counted box), the spatial trims' and the sharded sparse
            # windows' K1/K2 windows, and K8 a shard.
            (phase_fleet_mesh, ("fleet_run_turns/resident",
                                "resident_run_turns", "tiled_sweep",
                                "window_occupancy"), False),
            # 4m's live runs: K1 at 512², K2 at 5120² (each run also
            # checks its own launches).
            (phase_live_view, ("resident_run_turns", "tiled_sweep"),
             False)):
        t_phase = time.monotonic()
        cs.reset_launch_counts()
        MEMBER_LAUNCHES.clear()
        with (profile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) if prof_on
              else contextlib.nullcontext()) as prof:
            phase(torch, dev)
            torch.cuda.synchronize()
        counts = main_path_launches(cs)
        if MEMBER_LAUNCHES:
            log(f"  {phase.__name__} launches in member processes: "
                f"{MEMBER_LAUNCHES}")
            for name, n in MEMBER_LAUNCHES.items():
                counts[name] = counts.get(name, 0) + n
        log(f"  {phase.__name__} launches: {counts}")
        for name in kernels:
            if counts[name] <= 0:
                raise AssertionError(f"{phase.__name__} never launched "
                                     f"{name}")
        if phase in CHUNK_COUNTED_PHASES and counts["row_popcounts"]:
            raise AssertionError(f"{phase.__name__} launched K3 "
                                 f"{counts['row_popcounts']} times")
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
        log(f"  {phase.__name__} took {time.monotonic() - t_phase:.1f} s")
    log("  main-path device ms by kernel (torch.profiler): "
        + (json.dumps(device_ms) if device_ms else "not measured"))
    log(f"  launches in the profiled phases: {json.dumps(profiled)}")
    phase_conv_checks(torch, dev)
    phase_control_plane_measure(torch, dev, card)
    phase_checkpoint_measure(torch, dev, card)
    fleet = timing_fleet(torch, dev, card)
    log(f"  measurements so far: {time.monotonic() - t_start:.1f} s")
    kernels = phase_timing(torch, dev, card, launches)
    kernels += k7_records(card, launches, timing_ltl(torch, dev, card))
    k3 = [k for k in kernels if k["name"] == "row_popcounts"][0]
    k3["trace"] = timing_k3_trace(torch, dev, card)
    k3["profiled_launches"] = profiled.get("row_popcounts", 0)
    token = timing_token(torch, dev, card)
    k3["chunk_token"] = token["chunks"]
    for k in kernels:
        if k["name"] in token["heads"]:
            k["counted"] = token["heads"][k["name"]]
    kernels.append(k8_record(card, launches,
                             timing_occupancy(torch, dev, card)))
    kernels += k9_records(card, launches, fleet)
    for k in kernels:
        k["main_path_device_ms"] = device_ms.get(
            k["name"], 0.0 if device_ms else "not measured")
        if k["name"] in MESH_RESULTS["windows"]:
            k["mesh_windows"] = MESH_RESULTS["windows"][k["name"]]
        if k["name"] in FM_RESULTS["windows"]:
            # K9's counted box on the spatial buckets' windows (4l).
            k["spatial_windows"] = FM_RESULTS["windows"][k["name"]]
    log_broadcast_summary(card)
    log_federation_summary()
    log_mesh_summary(card)
    log_fleet_mesh_summary(card)
    log_live_summary(card)
    log(f"total {time.monotonic() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
