"""`GOL_PIPELINE_BUDGET` sets the port engine's pipeline depth as it sets
the JAX engine's (`gol_tpu/engine.py:1076-1089`): a value > 0 replaces
half the device's memory (`PIPELINE_BOARD_BUDGET` where the device
reports none, as the CPU does), and depth + 1 boards of a device's share
must fit it, between 1 and min(GOL_PIPELINE_DEPTH, 8)."""

import types

import pytest
import torch

from gol_tpu import engine as jengine
from gol_tpu_torch import engine as pengine
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.parallel.mesh import ShardedBoard

GiB = 1 << 30


def _jax_depth(env: dict, board_bytes: int, shards: int) -> int:
    """`gol_tpu/engine.py:1076-1089` on a device that reports no memory
    limit (the default budget), with its env_int parsing."""
    def env_int(name, default, minimum=1):
        try:
            v = int(env.get(name, default))
        except ValueError:
            return default
        return max(v, minimum)

    budget = env_int(jengine.PIPELINE_BUDGET_ENV, 0, minimum=0)
    if budget <= 0:
        budget = jengine.PIPELINE_BOARD_BUDGET
    shard_bytes = board_bytes // max(shards, 1)
    return max(1, min(env_int(jengine.PIPELINE_DEPTH_ENV,
                              jengine.PIPELINE_DEPTH), 8,
                      budget // max(shard_bytes, 1) - 1))


def _cells(board_bytes: int, shards: int):
    """A board of `board_bytes` int32 words: one meta tensor (no memory),
    or a ShardedBoard whose shards sit on distinct devices."""
    if shards == 1:
        return torch.empty(board_bytes // 4, dtype=torch.int32,
                           device="meta")
    per = board_bytes // shards
    shard = [types.SimpleNamespace(device=f"dev{i}", numel=lambda: per // 4,
                                   element_size=lambda: 4)
             for i in range(shards)]
    return ShardedBoard(shard, mesh=None)


CASES = [
    # (GOL_PIPELINE_BUDGET, GOL_PIPELINE_DEPTH, board bytes, shards)
    (None, None, 1 * GiB, 1),          # default budget: depth 3
    (None, None, 3 * GiB, 1),          # 8 GiB // 3 GiB - 1 = 1
    ("0", None, 2 * GiB, 1),           # 0 keeps the default half
    (str(3 * GiB), None, 1 * GiB, 1),  # 3 GiB // 1 GiB - 1 = 2
    (str(1 * GiB), None, 1 * GiB, 1),  # clamped up to 1
    (str(64 * GiB), None, 1 * GiB, 1),  # GOL_PIPELINE_DEPTH's 3
    (str(64 * GiB), "12", 1 * GiB, 1),  # capped at 8
    (str(64 * GiB), "5", 16 * GiB, 1),  # 64 // 16 - 1 = 3
    (str(3 * GiB), None, 4 * GiB, 4),  # a 1 GiB share a device: 2
    (str(5 * GiB), "6", 8 * GiB, 8),   # a 1 GiB share: 4
    ("-7", None, 2 * GiB, 2),          # negative: the default half
    ("garbage", None, 6 * GiB, 2),     # unparsable: the default half
    (str(1 << 20), None, 4096, 1),     # 256 boards fit: depth 3
]


@pytest.mark.parametrize("budget,depth,board_bytes,shards", CASES)
def test_pipeline_depth_equals_the_jax_formula(monkeypatch, budget, depth,
                                               board_bytes, shards):
    env = {}
    for name, value in ((pengine.PIPELINE_BUDGET_ENV, budget),
                        (pengine.PIPELINE_DEPTH_ENV, depth)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
            env[name] = value
    assert pengine.PIPELINE_BUDGET_ENV == jengine.PIPELINE_BUDGET_ENV
    assert pengine.PIPELINE_BOARD_BUDGET == jengine.PIPELINE_BOARD_BUDGET
    eng = Engine(device="cpu")
    got = eng._pipeline_depth(_cells(board_bytes, shards))
    assert got == _jax_depth(env, board_bytes, shards)
