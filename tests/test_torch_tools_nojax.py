"""The port's operator tools run where JAX cannot be imported: each
`python -m gol_tpu_torch.tools.<name>` entry runs in a subprocess whose
`jax`, `jaxlib` and `gol_tpu` imports fail (`sys.modules[name] = None`),
and returns the exit code the JAX package's tool returns here on the
same journal, checkpoint directory, router or address."""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from gol_tpu_torch import Params
from gol_tpu_torch import journal
from gol_tpu_torch.ckpt.writer import CheckpointWriter
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.federation.router import FederationRouter
from tools import ckpt_inspect, fleet_top, load_smoke, replay_audit

REPO = pathlib.Path(__file__).resolve().parent.parent

RUNNER = """
import json, runpy, sys
for name in ("jax", "jaxlib", "gol_tpu"):
    sys.modules[name] = None
module, runs = sys.argv[1], json.loads(sys.argv[2])
rcs = []
for argv in runs:
    sys.argv = [module] + argv
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=True)
        rcs.append(0)
    except SystemExit as e:
        rcs.append(e.code if isinstance(e.code, int) else 1)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in
                ("jax", "jaxlib", "gol_tpu") and sys.modules[m] is not None)
print(json.dumps({"rcs": rcs, "loaded": loaded}))
"""


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """A journaled, checkpointed 64² port run on the CPU, and a copy of
    its journal with a forged (re-chained) digest."""
    base = tmp_path_factory.mktemp("nojax")
    saved = dict(os.environ)
    os.environ.update(GOL_JOURNAL=str(base / "j"), GOL_CKPT=str(base / "ck"),
                      GOL_CKPT_EVERY_TURNS="32", GOL_CKPT_KEEP="100",
                      GOL_JOURNAL_DIGEST_EVERY="32", GOL_MAX_CHUNK="16")
    journal.reset()
    mp = pytest.MonkeyPatch()
    try:
        # Each periodic snapshot is written before the run steps on: the
        # writer replaces a snapshot still pending, and `diff` of the
        # oldest and the newest checkpoint needs two turns.
        submit = CheckpointWriter.submit

        def submit_and_flush(self, snap):
            kept = submit(self, snap)
            self.flush()
            return kept
        mp.setattr(CheckpointWriter, "submit", submit_and_flush)
        world = ((np.random.default_rng(9).random((64, 64)) < 0.3) * 255
                 ).astype(np.uint8)
        Engine(device="cpu").server_distributor(
            Params(image_width=64, image_height=64, turns=100), world)
    finally:
        mp.undo()
        os.environ.clear()
        os.environ.update(saved)
        journal.reset()
    (path,) = [str(p) for p in (base / "j").iterdir()]
    recs, _ = journal.load_records(path)
    forged = str(base / "forged.jsonl")
    head = journal.GENESIS
    with open(forged, "w") as fh:
        for r in recs:
            if r["kind"] == "digest" and r["turn"] == 64:
                r["board_sha256"] = "00" * 32
            r["prev"] = head
            r["hash"] = head = journal.chain_hash(r)
            fh.write(json.dumps(r) + "\n")
    return {"journal": path, "forged": forged, "ck": str(base / "ck"),
            "absent": str(base / "absent.jsonl")}


def _without_jax(module, runs):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-c", RUNNER, module, json.dumps(runs)],
        capture_output=True, text=True, timeout=150, env=env, cwd=str(REPO))
    assert out.returncode == 0, out.stderr[-4000:]
    doc = json.loads(out.stdout.strip().splitlines()[-1])
    assert doc["loaded"] == []
    return doc["rcs"]


def _jax_rcs(tool, runs):
    rcs = []
    for argv in runs:
        with contextlib.redirect_stdout(io.StringIO()), \
                contextlib.redirect_stderr(io.StringIO()):
            try:
                rcs.append(tool.main(argv))
            except SystemExit as e:
                rcs.append(e.code if isinstance(e.code, int) else 1)
    return rcs


def test_replay_audit_without_jax(artifacts):
    runs = [[artifacts["journal"]], [artifacts["forged"]],
            [artifacts["absent"]],
            [artifacts["journal"], "--expect-seq", "99"]]
    want = _jax_rcs(replay_audit, runs)
    assert want == [0, 1, 2, 2]
    got = _without_jax("gol_tpu_torch.tools.replay_audit",
                       [r + ["--device", "cpu", "--quiet"] for r in runs])
    assert got == want


def test_ckpt_inspect_without_jax(artifacts):
    ck = artifacts["ck"]
    names = sorted(n for n in os.listdir(ck) if n.endswith(".json"))
    runs = [["list", ck], ["verify", ck],
            ["diff", os.path.join(ck, names[0]), ck],
            ["diff", ck, ck], ["list", artifacts["absent"]]]
    want = _jax_rcs(ckpt_inspect, runs)
    assert want == [0, 0, 1, 0, 1]
    assert _without_jax("gol_tpu_torch.tools.ckpt_inspect", runs) == want


def test_fleet_top_without_jax():
    router = FederationRouter(port=0).start_background()
    try:
        runs = [["--router", f"127.0.0.1:{router.port}", "--once"]]
        want = _jax_rcs(fleet_top, runs)
        assert want == [0]
        assert _without_jax("gol_tpu_torch.tools.fleet_top", runs) == want
    finally:
        router.shutdown()


def test_load_smoke_without_jax():
    """The port's load generator on its own CPU fleet server (with and
    without parked viewers) exits 0, and against an address where nothing
    listens exits 1, as the JAX tool does there."""
    import socket

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    dead = f"127.0.0.1:{s.getsockname()[1]}"
    s.close()
    runs = [["--address", dead, "--clients", "1", "--cycles", "1",
             "--timeout", "2"]]
    want = _jax_rcs(load_smoke, runs)
    assert want == [1]
    got = _without_jax("gol_tpu_torch.tools.load_smoke", [
        ["--device", "cpu", "--clients", "2", "--cycles", "2"],
        ["--device", "cpu", "--clients", "1", "--cycles", "1",
         "--viewers", "8", "--hold", "0.3"]] + runs)
    assert got == [0, 0] + want
