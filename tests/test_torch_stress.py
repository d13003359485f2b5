"""Concurrency stress on the port (`Engine(device="cpu")`), the
counterpart of `tests/test_stress.py`: many threads hammer every
read-side call — in process, and through the port's server with a
client each — while a run is in flight. Every (alive, turn) pair and
every world read must equal the numpy replay at its turn, stats stay
self-consistent, and nothing deadlocks: each join and the run itself
have a deadline, and a thread still alive after it fails the test."""

from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import pytest
import torch

from gol_tpu.ops.reference import run_turns_np

from gol_tpu_torch.client import RemoteEngine
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.params import Params
from gol_tpu_torch.server import EngineServer

torch.set_num_threads(2)

TURNS = 160
DEADLINE_S = 120.0


def _replay(world0: np.ndarray) -> dict:
    """alive count at every turn 0..TURNS: the parity oracle."""
    alive_at = {0: int(world0.sum())}
    b = world0
    for t in range(1, TURNS + 1):
        b = run_turns_np(b, 1)
        alive_at[t] = int(b.sum())
    return alive_at


@pytest.mark.parametrize("via", ["engine", "server"])
def test_concurrent_rpc_storm(monkeypatch, via):
    monkeypatch.setenv("GOL_MAX_CHUNK", "8")  # frequent state swaps
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    eng = Engine(device="cpu")
    srv = None
    if via == "server":
        srv = EngineServer(port=0, host="127.0.0.1", engine=eng)
        srv.start_background()

        def surface():
            return RemoteEngine(f"127.0.0.1:{srv.port}", timeout=30.0)
    else:
        def surface():
            return eng

    rng = np.random.default_rng(17)
    world0 = (rng.random((64, 64)) < 0.3).astype(np.uint8)
    alive_at = _replay(world0)
    errors: "queue.Queue[str]" = queue.Queue()
    stop = threading.Event()
    reads = {"alive": 0, "world": 0}

    def guarded(body):
        def loop():
            s = surface()
            try:
                while not stop.is_set():
                    body(s)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.put(f"{body.__name__}: {type(e).__name__}: {e}")
        return loop

    def alive_reader(s):
        alive, turn = s.alive_count()
        if turn == 0 and alive == 0:
            return  # before the board is loaded
        if alive_at.get(turn) != alive:
            errors.put(f"alive {alive} != {alive_at.get(turn)} @ {turn}")
        reads["alive"] += 1
        time.sleep(0.002)

    def world_reader(s):
        try:
            world, turn = s.get_world()
        except RuntimeError:
            return  # before the board is loaded
        if int((world != 0).sum()) != alive_at.get(turn):
            errors.put(f"world alive mismatch @ {turn}")
        reads["world"] += 1
        time.sleep(0.005)

    def stats_reader(s):
        st = s.stats()
        if st["board"] not in (None, [64, 64]):
            errors.put(f"bad stats board {st['board']}")
        if not 0 <= st["turn"] <= TURNS:
            errors.put(f"bad stats turn {st['turn']}")
        time.sleep(0.001)

    def pinger(s):
        t = s.ping()
        if not 0 <= t <= TURNS:
            errors.put(f"bad ping turn {t}")
        time.sleep(0.001)

    bodies = [alive_reader] * 3 + [world_reader] * 2 + [stats_reader,
                                                         pinger]
    readers = [threading.Thread(target=guarded(b), daemon=True)
               for b in bodies]
    result: dict = {}

    def drive():
        try:
            p = Params(threads=2, image_width=64, image_height=64,
                       turns=TURNS)
            result["out"] = surface().server_distributor(p, world0 * 255)
        except Exception as e:  # noqa: BLE001 — reported below
            result["error"] = e

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in readers:
            t.start()
        runner = threading.Thread(target=drive, daemon=True)
        runner.start()
        runner.join(DEADLINE_S)
        assert not runner.is_alive(), "the run deadlocked"
    finally:
        stop.set()
        for t in readers:
            t.join(10)
        sys.setswitchinterval(switch)
        if srv is not None:
            srv.shutdown()
    assert not any(t.is_alive() for t in readers), "a reader deadlocked"
    assert "error" not in result, result.get("error")
    out, turn = result["out"]
    assert turn == TURNS
    np.testing.assert_array_equal((out != 0).astype(np.uint8),
                                  run_turns_np(world0, TURNS))
    assert errors.empty(), [errors.get() for _ in range(errors.qsize())]
    assert reads["alive"] > 0 and reads["world"] > 0
