"""The port's replay auditor (`gol_tpu_torch/tools/replay_audit.py`, on
`--device cpu`: the packed replay runs the plain versions that
`parallel/halo.py` selects for CPU tensors) against the JAX package's
(`tools/replay_audit.py`) on the same journals: equal exit codes, equal
report lines (chain, replay, divergence: checked, skipped, the first
divergent seq and turn, the last good digest) and equal dumped boards.

Journals: engine runs of either package at u8 16², packed 64² and
64 x 4096; fleet runs of either package from a run_id-keyed soup; a
hand-written chain (by either package's writer) with rule changes and
restore/link rewinds, its digests from the JAX tool's numpy stepper; a
two-segment lineage of a run migrated between two port fleets; a forged
digest (exit 1, with `--ckpt` recovering the expected board), a flipped
byte, a torn tail and `--expect-head` truncation (exit 2); a gen3
journal and a missing file (each the JAX tool's own exit). Seeds from
numpy; tolerance: none."""

import json
import os
import time

import jax
import numpy as np
import pytest

from gol_tpu import Params as JParams
from gol_tpu import journal as jjournal
from gol_tpu.engine import Engine as JEngine
from gol_tpu.fleet.buckets import board_to_words as jboard_to_words
from gol_tpu.fleet.engine import FleetEngine as JFleetEngine
from gol_tpu.models import parse_rule as jparse_rule
from gol_tpu_torch import Params
from gol_tpu_torch import journal
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.fleet.engine import FleetEngine
from gol_tpu_torch.models import parse_rule
from gol_tpu_torch.models.generations import to_pixels_gen
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.tools import replay_audit as ptool
from tools import replay_audit as jtool

JOURNALS = {"torch": journal, "jax": jjournal}


@pytest.fixture(autouse=True)
def _journal_isolation():
    journal.reset()
    jjournal.reset()
    yield
    journal.reset()
    jjournal.reset()


def _audit_both(capsys, tmp_path, argv):
    """Run both tools on `argv`, each with a dump directory of its own
    when `--dump` is asked for; returns {pkg: (rc, stdout, stderr)} with
    each tool's dump directory written as DUMP."""
    capsys.readouterr()
    out = {}
    for pkg, tool, extra in (("jax", jtool, []),
                             ("torch", ptool, ["--device", "cpu"])):
        dump = str(tmp_path / f"dump-{pkg}")
        args = [dump if a == "DUMP" else a for a in argv] + extra
        rc = tool.main(args)
        cap = capsys.readouterr()
        out[pkg] = (rc, _report(cap.out, dump), _report(cap.err, dump))
    return out


def _report(text, dump):
    """A tool's lines, its dump directory written as DUMP, without the
    structured log lines that background threads of a stopped engine
    may still print."""
    return "".join(line for line in text.replace(dump, "DUMP").splitlines(
        keepends=True) if not line.startswith("[gol:"))


def _assert_same(res):
    assert res["torch"] == res["jax"]
    return res["jax"]


def _journaled_run(pkg, h, w, turns, world, tmp_path, monkeypatch,
                   ckpt_dir=None, rule="B3/S23"):
    """One run of `pkg`'s engine with GOL_JOURNAL (digests every 32
    turns); returns the journal's path."""
    jdir = tmp_path / f"j-{pkg}-{h}x{w}"
    monkeypatch.setenv("GOL_JOURNAL", str(jdir))
    monkeypatch.setenv("GOL_JOURNAL_DIGEST_EVERY", "32")
    monkeypatch.setenv("GOL_MAX_CHUNK", "16")
    if ckpt_dir:
        monkeypatch.setenv("GOL_CKPT", str(ckpt_dir))
        monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "64")
        monkeypatch.setenv("GOL_CKPT_KEEP", "100")
    if pkg == "jax":
        eng = JEngine(devices=jax.devices()[:1], rule=jparse_rule(rule))
        eng.server_distributor(JParams(image_width=w, image_height=h,
                                       turns=turns), world)
    else:
        eng = Engine(device="cpu", rule=parse_rule(rule))
        eng.server_distributor(Params(image_width=w, image_height=h,
                                      turns=turns), world)
    (path,) = [str(p) for p in jdir.iterdir()]
    return path


def _world(h, w, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random((h, w)) < 0.3) * 255).astype(np.uint8)


def _rechain(path, recs):
    head = journal.GENESIS
    with open(path, "w") as fh:
        for r in recs:
            r["prev"] = head
            r["hash"] = head = journal.chain_hash(r)
            fh.write(json.dumps(r) + "\n")


# ------------------------------------------------------- engine journals

@pytest.mark.parametrize("pkg", ["torch", "jax"])
@pytest.mark.parametrize("h,w", [(16, 16), (64, 64), (64, 4096)],
                         ids=["u8-16", "packed-64", "packed-64x4096"])
def test_engine_journal_replays_alike(pkg, h, w, tmp_path, monkeypatch,
                                      capsys):
    path = _journaled_run(pkg, h, w, 100, _world(h, w, h + w), tmp_path,
                          monkeypatch)
    rc, out, err = _assert_same(_audit_both(capsys, tmp_path, [path]))
    assert rc == 0 and err == ""
    assert "replay ok: 3 digest(s) bit-identical, final turn 96" in out


# -------------------------------------------------------- fleet journals

def _wait(pred, timeout=60.0, what="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


def _digest_turns(path):
    if not os.path.exists(path):
        return set()
    recs, _ = journal.load_records(path)
    return {r["turn"] for r in recs if r["kind"] == "digest"}


def _fleet(pkg):
    if pkg == "jax":
        return JFleetEngine(bucket_sizes=(64,), chunk_turns=2, slot_base=2)
    return FleetEngine(bucket_sizes=(64,), chunk_turns=2, slot_base=2,
                       device="cpu")


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_fleet_soup_journal_replays_alike(pkg, tmp_path, monkeypatch,
                                          capsys):
    """A seedless CreateRun journals seed_kind "soup"; its digests ride
    the cadence checkpoints; both tools rebuild the soup from the run id
    and check every digest."""
    monkeypatch.setenv("GOL_JOURNAL", str(tmp_path / "j"))
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    eng = _fleet(pkg)
    path = JOURNALS[pkg].journal_path("soupy")
    try:
        eng.create_run(64, 64, run_id="soupy", ckpt_every=4,
                       target_turn=24)
        _wait(lambda: 24 in _digest_turns(path), what="digest at 24")
    finally:
        eng.kill_prog()
    recs, _ = journal.load_records(path)
    assert recs[0]["kind"] == "create" and recs[0]["seed_kind"] == "soup"
    rc, out, err = _assert_same(_audit_both(capsys, tmp_path, [path]))
    assert rc == 0 and err == ""
    n = sum(r["kind"] == "digest" for r in journal.load_records(path)[0])
    assert f"replay ok: {n} digest(s) bit-identical, final turn 24" in out


def _true_boards(seed, script):
    """{turn: board} of `seed` under `script` [(turn, rule)...] by the
    JAX tool's numpy stepper, one turn at a time up to the last turn."""
    boards, b, rule = {0: seed}, seed, jparse_rule("B3/S23")
    changes = dict(script)
    for t in range(1, max(changes) + 1):
        b = jtool._step_np(b, 1, rule)
        boards[t] = b
        if t in changes:
            rule = jparse_rule(changes[t])
    return boards


def _sha(board, repr_):
    if repr_ == "packed":
        return jjournal.board_digest(
            np.ascontiguousarray(jboard_to_words(board)), "packed")
    return jjournal.board_digest(board, "u8")


@pytest.mark.parametrize("writer", ["torch", "jax"])
@pytest.mark.parametrize("w,repr_", [(64, "packed"), (40, "u8")])
def test_rule_changes_and_rewinds_replay_alike(writer, w, repr_, tmp_path,
                                               capsys):
    """create → digests → a rule change → a restore that rewinds to a
    checked digest → a link that rewinds between two → digests past a
    second rule change: both tools rewind to their anchors and agree on
    every digest. (A rewind replays from its anchor under the current
    rule, in both tools, so no rule change lies between them.)"""
    rng = np.random.default_rng(w)
    seed = (rng.random((48, w)) < 0.3).astype(np.uint8)
    boards = _true_boards(seed, [(12, "B36/S23"), (22, "B3/S23"),
                                 (28, "B3/S23")])
    path = str(tmp_path / "rw.jsonl")
    jw = JOURNALS[writer].JournalWriter(path, "rw")
    jw.append("create", turn=0, h=48, w=w, rule="B3/S23",
              seed_kind="inline", seed=journal.encode_board(seed),
              board_sha256=_sha(seed, repr_), repr=repr_)
    for kind, turn, extra in (
            ("digest", 8, {}), ("rule", 12, {"rule": "B36/S23"}),
            ("digest", 16, {}), ("digest", 20, {}), ("pause", 20, {}),
            ("restore", 16, {"reason": "restore"}),
            ("digest", 20, {}), ("link", 18, {"reason": "adopt"}),
            ("rule", 22, {"rule": "B3/S23"}), ("digest", 24, {}),
            ("digest", 28, {})):
        if kind in ("digest", "restore", "link"):
            extra = dict(extra, board_sha256=_sha(boards[turn], repr_),
                         repr=repr_)
        assert jw.append(kind, turn=turn, **extra) is not None
    jw.close()
    rc, out, err = _assert_same(_audit_both(capsys, tmp_path, [path]))
    assert rc == 0 and err == ""
    assert "replay ok: 8 digest(s) bit-identical, final turn 28" in out


def test_migration_lineage_replays_alike(tmp_path, monkeypatch, capsys):
    """A run migrated between two port fleets (quiesce, checkpoint and
    commit on the source; import with the source's chain head and
    activate on the target), each member journaling to its own root:
    the two segments stitch through the target's link and replay."""
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_JOURNAL", str(tmp_path / "j1"))
    rng = np.random.default_rng(21)
    seed = (rng.random((64, 64)) < 0.3).astype(np.uint8)
    src, dst = _fleet("torch"), _fleet("torch")
    seg0 = journal.journal_path("mig")
    try:
        src.create_run(64, 64, board=seed, run_id="mig", ckpt_every=4,
                       target_turn=16)
        _wait(lambda: 16 in _digest_turns(seg0), what="source digest")
        q = src.migrate_quiesce("mig")
        src.migrate_checkpoint("mig")
        src.migrate_commit("mig")
        journal.forget("mig")
        monkeypatch.setenv("GOL_JOURNAL", str(tmp_path / "j2"))
        seg1 = journal.journal_path("mig")
        dst.import_run("mig", q["board"], q["turn"], rule=q["rule"],
                       ckpt_every=4, target_turn=32,
                       journal_head=q["journal_head"])
        dst.activate_imported("mig")
        _wait(lambda: 32 in _digest_turns(seg1), what="target digest")
    finally:
        src.kill_prog()
        dst.kill_prog()
    assert seg0 != seg1
    assert journal.load_records(seg1)[0][0]["kind"] == "link"
    rc, out, err = _assert_same(_audit_both(capsys, tmp_path,
                                            [seg0, seg1]))
    assert rc == 0 and err == ""
    assert ", final turn 32" in out
    # A wrong head on a lineage is truncation (exit 2).
    rc, _, err = _assert_same(_audit_both(
        capsys, tmp_path, [seg0, seg1, "--expect-head", "ab" * 32]))
    assert rc == 2 and "does not match --expect-head" in err


# --------------------------------------------------- divergence, tamper

def test_forged_digest_diverges_alike_with_dumps(tmp_path, monkeypatch,
                                                capsys):
    """A forged (and re-chained) digest at a checkpointed turn: exit 1
    at its seq and turn, the last good digest before it, equal replayed
    boards, and `--ckpt` recovers the journaled run's board at that
    turn; the port's gol_replay_divergence_total rises by one."""
    ck = tmp_path / "ck"
    path = _journaled_run("torch", 64, 64, 200, _world(64, 64, 4),
                          tmp_path, monkeypatch, ckpt_dir=ck)
    recs, _ = journal.load_records(path)
    forged = next(r for r in recs if r["kind"] == "digest"
                  and r["turn"] == 64)
    forged["board_sha256"] = "00" * 32
    _rechain(path, recs)
    before = obs.REPLAY_DIVERGENCE.value
    res = _audit_both(capsys, tmp_path,
                      [path, "--dump", "DUMP", "--ckpt", str(ck)])
    rc, out, err = _assert_same(res)
    assert obs.REPLAY_DIVERGENCE.value == before + 1
    assert rc == 1
    assert (f"DIVERGENCE at seq {forged['seq']} turn 64: expected "
            "0000000000000000…") in err
    assert "(last good digest: turn 32)" in err
    boards = {}
    for pkg in ("jax", "torch"):
        stem = tmp_path / f"dump-{pkg}" / (
            f"divergence-{journal._safe_name(recs[0]['run_id'])}"
            f"-seq{forged['seq']}")
        with np.load(f"{stem}-replayed.npz") as z:
            boards[pkg] = (z["board"], int(z["turn"]))
        with np.load(f"{stem}-expected.npz") as z:
            np.testing.assert_array_equal(z["board"], boards[pkg][0])
        report = json.loads(open(f"{stem}.json").read())
        assert (report["seq"], report["turn"], report["last_good_seq"],
                report["last_good_turn"]) == (forged["seq"], 64,
                                              forged["seq"] - 1, 32)
        assert os.path.exists(f"{stem}-flight.json")
    np.testing.assert_array_equal(boards["torch"][0], boards["jax"][0])
    assert boards["torch"][1] == boards["jax"][1] == 64


def test_flipped_byte_torn_tail_and_truncation_fail_the_chain(
        tmp_path, monkeypatch, capsys):
    path = _journaled_run("torch", 64, 64, 100, _world(64, 64, 5),
                          tmp_path, monkeypatch)
    good = open(path).read()
    recs, _ = journal.load_records(path)
    # --expect-head / --expect-seq past the file's end: truncation.
    rc, _, err = _assert_same(_audit_both(
        capsys, tmp_path, [path, "--expect-seq", str(len(recs))]))
    assert rc == 2 and f"chain FAILED at seq {len(recs)}" in err
    rc, _, err = _assert_same(_audit_both(
        capsys, tmp_path, [path, "--expect-head", "cd" * 32]))
    assert rc == 2 and "truncated" in err
    # A flipped byte inside record 2's digest.
    lines = good.splitlines(keepends=True)
    i = lines[2].index('"board_sha256":"') + len('"board_sha256":"')
    flip = "0" if lines[2][i] != "0" else "1"
    lines[2] = lines[2][:i] + flip + lines[2][i + 1:]
    with open(path, "w") as fh:
        fh.writelines(lines)
    rc, _, err = _assert_same(_audit_both(capsys, tmp_path, [path]))
    assert rc == 2 and "chain FAILED at seq 2" in err
    # A torn tail: the last record cut mid-line.
    with open(path, "w") as fh:
        fh.write(good[: len(good) - 20])
    rc, _, err = _assert_same(_audit_both(capsys, tmp_path, [path]))
    assert rc == 2 and "torn trailing record" in err


def test_gen3_and_missing_journal_exit_as_the_jax_tool(tmp_path,
                                                      monkeypatch, capsys):
    """A gen3 run journals its seed by digest only: both tools report it
    unreplayable with its digests unchecked (exit 3). A missing file is
    an unreadable chain (exit 2)."""
    r = parse_rule("/2/3")
    rng = np.random.default_rng(6)
    world = to_pixels_gen(rng.integers(0, 3, (64, 64)).astype(np.uint8), r)
    path = _journaled_run("torch", 64, 64, 100, world, tmp_path,
                          monkeypatch, rule="/2/3")
    rc, out, err = _assert_same(_audit_both(capsys, tmp_path, [path]))
    assert rc == 3 and "unreplayable: seed is external" in err
    assert "(3 digest(s) unchecked)" in err
    rc, _, err = _assert_same(_audit_both(
        capsys, tmp_path, [str(tmp_path / "absent.jsonl")]))
    assert rc == 2 and "absent.jsonl" in err


def test_cuda_default_raises_without_a_card(tmp_path, monkeypatch):
    """`--device` defaults to cuda; without a card the tool raises as
    `resolve_device` does, before it reads anything."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ptool.main([str(tmp_path / "absent.jsonl")])
