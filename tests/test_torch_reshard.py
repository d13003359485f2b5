"""Checkpoints across shard counts (`gol_tpu/ckpt/reshard.py`'s contract)
in the torch port: a manifest written by an S-shard run of either
package restores into an S'-shard engine of either — refused without a
reshard when the device counts differ, bit-identical with one — and the
resumed run stays on the torus oracle's trajectory. Both packages stamp
the same mesh and the same board digest for the same run. Tolerance:
none."""

import json

import jax
import numpy as np
import pytest
import torch

from gol_tpu.ckpt import reshard as jreshard
from gol_tpu.engine import Engine as JEngine
from gol_tpu.params import Params as JParams

from gol_tpu_torch.ckpt import reshard as treshard
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.ops.reference import run_turns_np
from gol_tpu_torch.params import Params

torch.set_num_threads(2)

SHARDS = [1, 2, 3, 4, 8]
# Each count restores into the next one (8 wraps to 1).
NEXT = dict(zip(SHARDS, SHARDS[1:] + SHARDS[:1]))


def _engine(package, shards):
    if package == "port":
        return Engine(devices=[torch.device("cpu")] * shards)
    return JEngine(devices=jax.devices()[:shards])


def _params(package, shards, turns):
    cls = Params if package == "port" else JParams
    return cls(threads=shards, image_width=64, image_height=60,
               turns=turns)


def _seed():
    rng = np.random.default_rng(60)
    return (rng.random((60, 64)) < 0.3).astype(np.uint8)


def _write(package, shards, directory):
    """An S-shard run of 20 turns (60 rows: exact-N at 8 shards),
    checkpointed; returns the manifest path and document."""
    eng = _engine(package, shards)
    out, turn = eng.server_distributor(_params(package, shards, 20),
                                       _seed() * np.uint8(255))
    assert turn == 20
    assert eng.stats()["mesh"]["shards"] == shards
    path, turn = eng.checkpoint_now(directory=str(directory))
    assert turn == 20
    eng.kill_prog()
    with open(path) as f:
        return path, json.load(f)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_manifest_restores_into_another_shard_count(tmp_path, writer,
                                                    shards):
    reader = "jax" if writer == "port" else "port"
    path, doc = _write(writer, shards, tmp_path)
    assert doc["mesh"] == {"devices": shards}
    target = NEXT[shards]
    eng = _engine(reader, target)
    mismatch = (treshard.GeometryMismatch if reader == "port"
                else jreshard.GeometryMismatch)
    with pytest.raises(mismatch) as info:
        eng.restore_run(path)
    assert f"mesh devices {shards} -> {target}" in str(info.value)
    assert eng.restore_run(path, reshard=True) == 20
    world, turn = eng.get_world()
    assert turn == 20
    np.testing.assert_array_equal(world != 0, run_turns_np(_seed(), 20))
    out, turn = eng.server_distributor(_params(reader, target, 10), world,
                                       start_turn=20)
    assert turn == 30
    np.testing.assert_array_equal(out != 0, run_turns_np(_seed(), 30))
    assert eng.stats()["mesh"]["shards"] == target
    eng.kill_prog()


@pytest.mark.parametrize("shards", SHARDS)
def test_manifests_agree_across_packages(tmp_path, shards):
    """The same S-shard run checkpointed by each package: mesh, board
    digest, alive count, repr and board agree; an equal device count
    restores directly, with no reshard."""
    docs = {}
    for package in ("port", "jax"):
        path, docs[package] = _write(package, shards, tmp_path / package)
        other = _engine("jax" if package == "port" else "port", shards)
        assert other.restore_run(path) == 20
        other.kill_prog()
    keys = ("mesh", "board_sha256", "alive", "repr", "board", "turn")
    assert ({k: docs["port"].get(k) for k in keys}
            == {k: docs["jax"].get(k) for k in keys})
