"""The port's checkpoint inspector (`gol_tpu_torch/tools/ckpt_inspect.py`)
against the JAX package's (`tools/ckpt_inspect.py`): `list` (lenient and
`--strict`), `verify` (a directory and a manifest) and `diff` give the
same lines and exit codes on the same directories, written by either
package: engine roots (the legacy root layout) in each representation
(`packed` 64², `u8` 40 x 24, `gen3` Brian's Brain, `gen8` Star Wars),
a fleet root whose runs nest in `run-<id>/` beside a root run, and a
directory with a corrupted payload and a malformed manifest. Boards from
seeded numpy; tolerance: none."""

import contextlib
import io
import os
import time

import jax
import numpy as np
import pytest

from gol_tpu import Params as JParams
from gol_tpu.ckpt.writer import CheckpointWriter as JCheckpointWriter
from gol_tpu.engine import Engine as JEngine
from gol_tpu.fleet.engine import FleetEngine as JFleetEngine
from gol_tpu.models import parse_rule as jparse_rule
from gol_tpu_torch import Params
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt.writer import CheckpointWriter
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.fleet.engine import FleetEngine
from gol_tpu_torch.models import parse_rule
from gol_tpu_torch.models.generations import to_pixels_gen
from gol_tpu_torch.tools import ckpt_inspect as ptool
from tools import ckpt_inspect as jtool

PKGS = ("torch", "jax")
# family -> (rule, h, w)
FAMILIES = {"packed": ("B3/S23", 64, 64), "u8": ("B3/S23", 24, 40),
            "gen3": ("/2/3", 64, 64), "gen8": ("345/2/4", 32, 32)}
ENV = ("GOL_CKPT", "GOL_CKPT_EVERY_TURNS", "GOL_CKPT_KEEP", "GOL_MAX_CHUNK")
# The turns an engine root holds: every 32 turns of 100, then the final.
ENGINE_TURNS = [32, 64, 96, 100]


@contextlib.contextmanager
def _env(**values):
    saved = {k: os.environ.get(k) for k in ENV}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _every_write_lands():
    """Each package's engine waits for its periodic snapshot's write
    before it steps on. The writer keeps only the newest unwritten
    snapshot (`CheckpointWriter.submit` replaces a pending one), so a
    writer thread that starts late under load would leave a run with its
    final checkpoint alone, and no two turns of it to diff."""
    with pytest.MonkeyPatch.context() as mp:
        for cls in (JCheckpointWriter, CheckpointWriter):
            def submit(self, snap, _submit=cls.submit):
                kept = _submit(self, snap)
                self.flush()
                return kept
            mp.setattr(cls, "submit", submit)
        yield


def _world(rule, h, w, seed):
    rng = np.random.default_rng(seed)
    r = parse_rule(rule)
    if hasattr(r, "states"):
        return to_pixels_gen(rng.integers(0, r.states, (h, w)).astype(
            np.uint8), r)
    return ((rng.random((h, w)) < 0.3) * 255).astype(np.uint8)


def _engine_root(pkg, family, root):
    """An engine run of `pkg` checkpointing every 32 turns into `root`."""
    rule, h, w = FAMILIES[family]
    world = _world(rule, h, w, h * w)
    with _env(GOL_CKPT=str(root), GOL_CKPT_EVERY_TURNS="32",
              GOL_CKPT_KEEP="100", GOL_MAX_CHUNK="16"), \
            _every_write_lands():
        if pkg == "jax":
            JEngine(devices=jax.devices()[:1],
                    rule=jparse_rule(rule)).server_distributor(
                JParams(image_width=w, image_height=h, turns=100), world)
        else:
            Engine(device="cpu", rule=parse_rule(rule)).server_distributor(
                Params(image_width=w, image_height=h, turns=100), world)
    assert [c[0] for c in mf.list_checkpoints(str(root))] == ENGINE_TURNS


def _fleet_runs(pkg, root):
    """Two fleet runs of `pkg` (64² and a u8 16²) checkpointing every
    4 turns into `root/run-<id>/`, each parked at turn 12."""
    with _env(GOL_CKPT=str(root)):
        if pkg == "jax":
            eng = JFleetEngine(bucket_sizes=(64,), chunk_turns=2,
                               slot_base=2)
        else:
            eng = FleetEngine(bucket_sizes=(64,), chunk_turns=2,
                              slot_base=2, device="cpu")
        try:
            rng = np.random.default_rng(3)
            for rid, (h, w) in (("a", (64, 64)), ("b", (16, 16))):
                eng.create_run(h, w, run_id=rid, ckpt_every=4,
                               target_turn=12, board=(rng.random(
                                   (h, w)) < 0.3).astype(np.uint8))
            deadline = time.monotonic() + 60
            while not all(
                    (mf.latest_checkpoint(str(root / f"run-{rid}"))
                     or (0,))[0] == 12 for rid in ("a", "b")):
                assert time.monotonic() < deadline, "fleet checkpoints"
                time.sleep(0.02)
        finally:
            eng.kill_prog()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """{(pkg, kind): directory} for every layout both tools inspect."""
    base = tmp_path_factory.mktemp("ckpt-inspect")
    out = {}
    for pkg in PKGS:
        for family in FAMILIES:
            out[pkg, family] = base / f"{pkg}-{family}"
            _engine_root(pkg, family, out[pkg, family])
        # A fleet root: a root run's checkpoints beside run-<id>/ dirs.
        out[pkg, "fleet"] = base / f"{pkg}-fleet"
        _engine_root(pkg, "packed", out[pkg, "fleet"])
        _fleet_runs(pkg, out[pkg, "fleet"])
    return out


def _run_both(argv):
    """{pkg: (rc, stdout)} of each tool on `argv`; a SystemExit's
    message stands for its stdout."""
    res = {}
    for pkg, tool in (("jax", jtool), ("torch", ptool)):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            try:
                rc = tool.main([str(a) for a in argv])
            except SystemExit as e:
                rc = e.code
        res[pkg] = (rc, buf.getvalue())
    assert res["torch"] == res["jax"]
    return res["jax"]


KINDS = tuple(FAMILIES) + ("fleet",)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("kind", KINDS)
def test_list_verify_and_diff_agree(roots, pkg, kind):
    root = roots[pkg, kind]
    rc, out = _run_both(["list", root])
    assert rc == 0 and out.splitlines()[0].split()[0] == "RUN"
    assert _run_both(["list", root, "--strict"]) == (rc, out)
    if kind == "fleet":
        labels = {line.split()[0] for line in out.splitlines()[1:]}
        assert labels == {"-", "a", "b"}
    rc, out = _run_both(["verify", root])
    assert rc == 0 and out.splitlines()[-1].endswith(" ok, 0 failed")
    items = list(mf.list_checkpoints(str(root)))
    rc, out = _run_both(["verify", items[0][1]])
    assert rc == 0 and out.startswith("ok    ")
    # Two turns of one run: the XOR-popcount (or cell) count.
    rc, out = _run_both(["diff", items[0][1], items[-1][1]])
    assert rc == 1 and "boards: DIFFER" in out
    # The newest checkpoint of a directory against itself.
    rc, out = _run_both(["diff", root, items[-1][1]])
    assert rc == 0 and "IDENTICAL" in out


@pytest.mark.parametrize("kind", KINDS)
def test_diff_across_packages(roots, kind):
    """The same run checkpointed by each package: the newest boards are
    identical (the port is bit-exact), and a port checkpoint against an
    older JAX one differs by the same count in both tools."""
    rc, out = _run_both(["diff", roots["torch", kind], roots["jax", kind]])
    assert rc == 0 and "IDENTICAL" in out
    older = list(mf.list_checkpoints(str(roots["jax", kind])))[0][1]
    rc, out = _run_both(["diff", roots["torch", kind], older])
    assert rc == 1 and "cell(s)" in out


def test_corrupted_payload_and_malformed_manifest(roots, tmp_path):
    """A flipped payload byte fails `verify` (exit 1) at that checkpoint,
    a manifest that does not parse is skipped by `list` and named by
    `verify`, and `list --strict` refuses it, alike in both tools."""
    import shutil

    root = tmp_path / "bad"
    shutil.copytree(roots["torch", "packed"], root)
    items = list(mf.list_checkpoints(str(root)))
    payload = mf.payload_path(items[1][1], items[1][2])
    raw = bytearray(open(payload, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(payload, "wb").write(bytes(raw))
    rc, out = _run_both(["verify", root])
    assert rc == 1 and f"{len(items) - 1} ok, 1 failed" in out
    rc, out = _run_both(["verify", items[1][1]])
    assert rc == 1 and out.startswith("FAIL  ")
    with open(items[2][1], "w") as fh:
        fh.write("{not json")
    rc, out = _run_both(["verify", root])
    assert rc == 1 and "manifest does not parse/validate" in out
    rc, out = _run_both(["list", root])
    assert rc == 0 and len(out.splitlines()) == len(items)
    res = {}
    for pkg, tool in (("jax", jtool), ("torch", ptool)):
        with pytest.raises(Exception) as e:
            with contextlib.redirect_stdout(io.StringIO()):
                tool.main(["list", str(root), "--strict"])
        res[pkg] = (type(e.value).__name__, str(e.value))
    assert res["torch"] == res["jax"]
    # An empty directory: nothing to list or verify (exit 1).
    empty = tmp_path / "empty"
    empty.mkdir()
    assert _run_both(["list", empty])[0] == 1
    assert _run_both(["verify", empty])[0] == 1
