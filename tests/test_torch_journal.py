"""The port's run journal (`gol_tpu_torch/journal.py`) against the JAX
package's (`gol_tpu/journal.py`): copies of `tests/test_journal.py`'s
chain contracts, each chain written by one package and verified by both
(truncation, bit flip, reorder and removed lines named at the exact seq;
torn tails; segment lineages), and a journaled port run on the CPU that
`gol_tpu.journal.verify_file` verifies, `tools/replay_audit.py` replays
with every digest matching, and whose records equal the JAX engine's in
every field but `ts`, `run_id`, `prev` and `hash`. `tools/ckpt_inspect.py`
verifies the port's checkpoint directories. Tolerance: none."""

import json
import os

import jax
import numpy as np
import pytest

from gol_tpu import Params as JParams
from gol_tpu import journal as jjournal
from gol_tpu.engine import Engine as JEngine
from gol_tpu_torch import Params
from gol_tpu_torch import ckpt
from gol_tpu_torch import journal
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt.writer import payload_arrays
from gol_tpu_torch.engine import Engine
from gol_tpu_torch.obs import flight
from tools import ckpt_inspect, replay_audit

JOURNALS = {"torch": journal, "jax": jjournal}


@pytest.fixture(autouse=True)
def _journal_isolation():
    """Every test starts and ends with empty registries in both
    packages (GOL_JOURNAL is cleared by the conftest)."""
    journal.reset()
    jjournal.reset()
    yield
    journal.reset()
    jjournal.reset()


def _write(tmp_path, writer="torch", run_id="r1",
           kinds=("create", "rule", "digest", "pause", "resume", "end")):
    """A small valid journal written by `writer`; returns (path,
    records)."""
    path = str(tmp_path / f"{run_id}.jsonl")
    jw = JOURNALS[writer].JournalWriter(path, run_id)
    for i, kind in enumerate(kinds):
        fields = {"turn": i * 10}
        if kind == "digest":
            fields["board_sha256"] = "ab" * 32
            fields["repr"] = "packed"
        assert jw.append(kind, **fields) is not None
    jw.close()
    records, torn = journal.load_records(path)
    assert torn is None
    return path, records


PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]
PAIR_IDS = [f"{w}-writes-{v}-verifies" for w, v in PAIRS]


# ------------------------------------------------------------ the chain

@pytest.mark.parametrize("writer,verifier", PAIRS, ids=PAIR_IDS)
def test_chain_verifies_and_resumes(tmp_path, writer, verifier):
    """A chain one package wrote verifies under the other, and the
    other's writer resumes it in place (seq and head continue)."""
    path, records = _write(tmp_path, writer)
    vj = JOURNALS[verifier]
    res = vj.verify_chain(records)
    assert res["ok"] and res["bad_seq"] is None
    assert res["last_seq"] == len(records) - 1
    assert records[0]["prev"] == journal.GENESIS == jjournal.GENESIS
    jw = vj.JournalWriter(path, "r1")
    assert jw.last_seq == len(records) - 1
    assert jw.head == records[-1]["hash"]
    jw.append("link", turn=60, reason="adopt")
    jw.close()
    for j in JOURNALS.values():
        res = j.verify_file(path)
        assert res["ok"] and res["last_seq"] == len(records)


def test_append_line_is_plain_json_with_hash(tmp_path):
    path, records = _write(tmp_path, kinds=("create",))
    rec = records[0]
    assert rec["hash"] == journal.chain_hash(rec) == jjournal.chain_hash(
        rec)
    with open(path) as fh:
        assert json.loads(fh.readline()) == rec


@pytest.mark.parametrize("verifier", sorted(JOURNALS))
@pytest.mark.parametrize("tamper,bad_seq,reason", [
    ("truncate", 3, "truncated"),
    ("stale-head", 3, "head"),
    ("bit-flip", 2, "tampered"),
    ("reorder", 3, "seq 4 after 2"),
    ("remove", 2, "seq 3 after 1"),
])
def test_tamper_names_the_offending_seq(tmp_path, verifier, tamper,
                                        bad_seq, reason):
    path, records = _write(tmp_path)
    head, last = records[-1]["hash"], records[-1]["seq"]
    expect = {}
    recs = [dict(r) for r in records]
    if tamper == "truncate":
        recs, expect = recs[:3], dict(expected_head=head, expected_seq=last)
    elif tamper == "stale-head":
        recs, expect = recs[:3], dict(expected_head=head)
    elif tamper == "bit-flip":
        recs[2]["turn"] = 999999
    elif tamper == "reorder":
        recs[3], recs[4] = recs[4], recs[3]
    else:
        del recs[2]
    res = JOURNALS[verifier].verify_chain(recs, **expect)
    assert not res["ok"]
    assert res["bad_seq"] == bad_seq
    assert reason in res["reason"]


# ------------------------------------------------- torn tails & garbage

@pytest.mark.parametrize("recoverer", sorted(JOURNALS))
def test_torn_tail_reported_then_truncated_on_resume(tmp_path, recoverer):
    path, records = _write(tmp_path)
    with open(path, "a", encoding="utf-8") as fh:
        fh.write('{"schema":"gol-journal/1","seq":')  # killed mid-line
    loaded, torn = journal.load_records(path)
    assert torn == len(records) + 1
    assert [r["seq"] for r in loaded] == [r["seq"] for r in records]
    for j in JOURNALS.values():
        res = j.verify_file(path)
        assert not res["ok"] and "torn" in res["reason"]
    # A writer of either package truncates the torn tail and welds its
    # next append onto the last INTACT record.
    jw = JOURNALS[recoverer].JournalWriter(path, "r1")
    assert jw.last_seq == records[-1]["seq"]
    jw.append("link", turn=60, reason="adopt")
    jw.close()
    for j in JOURNALS.values():
        res = j.verify_file(path)
        assert res["ok"] and res["last_seq"] == records[-1]["seq"] + 1


def test_mid_file_garbage_raises(tmp_path):
    path, records = _write(tmp_path)
    lines = open(path).read().splitlines()
    lines[1] = lines[1][:-5]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    with pytest.raises(journal.JournalError):
        journal.load_records(path)
    assert not journal.verify_file(path)["ok"]


def test_digest_turn_floor_drops_stale_async_digests(tmp_path):
    jw = journal.JournalWriter(str(tmp_path / "f.jsonl"), "f")
    jw.append("create", turn=0)
    jw.append("rule", turn=100, rule="B36/S23")
    assert jw.digest(90, "cd" * 32) is None
    assert jw.digest(100, "cd" * 32) is not None
    jw.close()


# ------------------------------------------------------ segment lineage

def _segment(run_id, prev_head=None, prev_seq=None, extra_tail=()):
    recs = []
    head, seq = journal.GENESIS, -1
    kinds = ["link" if prev_head else "create"] + ["digest"]
    for kind in list(kinds) + list(extra_tail):
        rec = {"schema": journal.SCHEMA, "run_id": run_id, "kind": kind,
               "ts": 0.0, "seq": seq + 1, "prev": head, "turn": 0}
        if prev_head and kind == "link":
            rec["prev_head"], rec["prev_seq"] = prev_head, prev_seq
        rec["hash"] = journal.chain_hash(rec)
        head, seq = rec["hash"], rec["seq"]
        recs.append(rec)
    return recs


@pytest.mark.parametrize("verifier", sorted(JOURNALS))
def test_segments_stitch_through_link(verifier):
    vj = JOURNALS[verifier]
    seg0 = _segment("m")
    seg1 = _segment("m", prev_head=seg0[-1]["hash"],
                    prev_seq=seg0[-1]["seq"])
    assert vj.verify_segments([seg0, seg1])["ok"]
    bad = _segment("m", prev_head="0" * 64, prev_seq=seg0[-1]["seq"])
    res = vj.verify_segments([seg0, bad])
    assert not res["ok"] and res["segment"] == 1
    # Only bookend kinds may trail the head a link references.
    seg0b = _segment("m", extra_tail=("digest", "migrate_out"))
    seg1b = _segment("m", prev_head=seg0b[-3]["hash"],
                     prev_seq=seg0b[-3]["seq"])
    assert vj.verify_segments([seg0b, seg1b])["ok"]
    seg0c = _segment("m", extra_tail=("rule",))
    seg1c = _segment("m", prev_head=seg0c[-2]["hash"],
                     prev_seq=seg0c[-2]["seq"])
    assert not vj.verify_segments([seg0c, seg1c])["ok"]


# ------------------------------------------------------- board payloads

@pytest.mark.parametrize("shape", [(48, 80), (16, 16), (1, 7)])
def test_seed_encode_decode_roundtrip(shape):
    rng = np.random.default_rng(7)
    board = (rng.random(shape) < 0.3).astype(np.uint8)
    seed = journal.encode_board(board)
    assert seed == jjournal.encode_board(board)
    np.testing.assert_array_equal(journal.decode_board(seed), board)
    np.testing.assert_array_equal(jjournal.decode_board(seed), board)


@pytest.mark.parametrize("repr_", ["u8", "packed", "gen3", "gen8"])
def test_board_digest_matches_manifest_hash_and_jax(repr_):
    """A journal digest and a manifest compare ONE number, and the
    port's digest of its int32 words equals the JAX digest of the same
    words as uint32."""
    rng = np.random.default_rng(8)
    if repr_ in ("packed", "gen3"):
        shape = (32, 2) if repr_ == "packed" else (2, 32, 2)
        host = rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(
            np.uint32)
        ours = host.view(np.int32)
    else:
        host = ours = rng.integers(0, 2 if repr_ == "u8" else 4,
                                   size=(32, 32)).astype(np.uint8)
    digest = journal.board_digest(ours, repr_)
    assert digest == mf.board_sha256(payload_arrays(ours, repr_))
    assert digest == jjournal.board_digest(host, repr_)


def test_manifest_carries_chain_head(tmp_path, monkeypatch):
    monkeypatch.setenv(journal.JOURNAL_ENV, str(tmp_path / "j"))
    jw = journal.for_run("stamped")
    jw.append("create", turn=0)
    cells = (np.arange(64, dtype=np.uint8).reshape(8, 8) % 2)
    w = ckpt.CheckpointWriter(str(tmp_path / "ck"), run_id="stamped")
    man = mf.read_manifest(w.write_sync(ckpt.Snapshot(
        cells, "u8", 5, (8, 8), "B3/S23")))
    w.close()
    stamp = man.get("journal")
    assert stamp == {"head": jw.head, "seq": jw.last_seq}
    for j in JOURNALS.values():
        assert j.verify_file(jw.path, expected_head=stamp["head"],
                             expected_seq=stamp["seq"])["ok"]
    tail = journal.load_records(jw.path)[0]
    assert tail[-1]["kind"] == "digest"
    assert tail[-1]["board_sha256"] == man["board_sha256"]


def test_sink_failure_latches_dead_not_raises(tmp_path):
    jw = journal.JournalWriter(str(tmp_path / "dead.jsonl"), "d")
    assert jw.append("create", turn=0) is not None

    class _GoneDisk:
        def write(self, _):
            raise OSError("no space left on device")

        def flush(self):
            pass

        def close(self):
            pass

    jw._sink._fh = _GoneDisk()
    assert jw.append("rule", turn=1, rule="B3/S23") is None
    assert jw.dead
    assert jw.append("end", turn=2) is None
    jw.close()


def test_registry_for_run_get_forget(tmp_path, monkeypatch):
    assert journal.for_run("a") is None  # journaling off
    monkeypatch.setenv(journal.JOURNAL_ENV, str(tmp_path / "j"))
    monkeypatch.setenv(journal.DIGEST_EVERY_ENV, "junk")
    assert journal.digest_every() == journal.DIGEST_EVERY_DEFAULT
    jw = journal.for_run("a/b")
    assert journal.get("a/b") is jw and journal.for_run("a/b") is jw
    assert os.path.basename(jw.path) == "a_b.jsonl"
    journal.forget("a/b")
    assert journal.get("a/b") is None and jw.dead


# ------------------------------------------- journaled runs, both ways

def _journaled_run(pkg, h, w, turns, world, tmp_path, monkeypatch,
                   ckpt_dir=None):
    """One run of `pkg`'s engine with GOL_JOURNAL (digests every 32
    turns); returns (journal path, its records)."""
    jdir = tmp_path / f"j-{pkg}"
    monkeypatch.setenv("GOL_JOURNAL", str(jdir))
    monkeypatch.setenv("GOL_JOURNAL_DIGEST_EVERY", "32")
    monkeypatch.setenv("GOL_MAX_CHUNK", "16")
    if ckpt_dir:
        monkeypatch.setenv("GOL_CKPT", str(ckpt_dir))
        monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "64")
        monkeypatch.setenv("GOL_CKPT_KEEP", "100")
    if pkg == "jax":
        eng = JEngine(devices=jax.devices()[:1])
        eng.server_distributor(JParams(image_width=w, image_height=h,
                                       turns=turns), world)
    else:
        eng = Engine(device="cpu")
        eng.server_distributor(Params(image_width=w, image_height=h,
                                      turns=turns), world)
    (path,) = [str(p) for p in jdir.iterdir()]
    return path, journal.load_records(path)[0]


@pytest.mark.parametrize("h,w", [(16, 16), (64, 64), (64, 4096)],
                         ids=["u8-16", "packed-64", "packed-64x4096"])
def test_port_journal_verifies_replays_and_equals_jax(h, w, tmp_path,
                                                      monkeypatch):
    rng = np.random.default_rng(h + w)
    world = ((rng.random((h, w)) < 0.3) * 255).astype(np.uint8)
    path, recs = _journaled_run("torch", h, w, 100, world, tmp_path,
                                monkeypatch)
    assert os.path.basename(path) == f"{flight.RUN_ID}.jsonl"
    assert jjournal.verify_file(path)["ok"]
    assert journal.verify_file(path)["ok"]
    assert replay_audit.main([path, "--quiet"]) == 0
    assert [(r["kind"], r.get("turn")) for r in recs] == (
        [("create", 0)] + [("digest", t) for t in (32, 64, 96)]
        + [("end", 100)])
    assert "seed" in recs[0]
    _, jrecs = _journaled_run("jax", h, w, 100, world, tmp_path,
                              monkeypatch)

    def content(rs):
        return [{k: v for k, v in r.items()
                 if k not in ("ts", "run_id", "prev", "hash")} for r in rs]

    assert content(recs) == content(jrecs)


def test_replay_catches_a_forged_digest(tmp_path, monkeypatch):
    """The audit is not vacuous: a port journal whose digest was forged
    (and re-chained, so the chain still verifies) diverges."""
    world = ((np.random.default_rng(4).random((64, 64)) < 0.3) * 255
             ).astype(np.uint8)
    path, recs = _journaled_run("torch", 64, 64, 100, world, tmp_path,
                                monkeypatch)
    recs[2]["board_sha256"] = "00" * 32
    head = journal.GENESIS
    with open(path, "w") as fh:
        for r in recs:
            r["prev"] = head
            r["hash"] = head = journal.chain_hash(r)
            fh.write(json.dumps(r) + "\n")
    assert jjournal.verify_file(path)["ok"]
    assert replay_audit.main([path, "--quiet"]) == 1


@pytest.mark.parametrize("rule", ["B3/S23", "/2/3"])
def test_checkpointed_journaled_run_and_ckpt_inspect(rule, tmp_path,
                                                     monkeypatch, capsys):
    """With GOL_CKPT too, every manifest carries a chain head the file
    verifies against, each checkpoint's digest is in the chain, and
    `tools/ckpt_inspect.py verify` passes on the port's directory."""
    from gol_tpu_torch.models import parse_rule
    from gol_tpu_torch.models.generations import to_pixels_gen

    rng = np.random.default_rng(6)
    if rule == "B3/S23":
        world = ((rng.random((64, 64)) < 0.3) * 255).astype(np.uint8)
    else:
        world = to_pixels_gen(rng.integers(0, 3, (64, 64)).astype(
            np.uint8), parse_rule(rule))
    monkeypatch.setenv("GOL_JOURNAL", str(tmp_path / "j"))
    monkeypatch.setenv("GOL_CKPT", str(tmp_path / "ck"))
    monkeypatch.setenv("GOL_CKPT_EVERY_TURNS", "64")
    monkeypatch.setenv("GOL_CKPT_KEEP", "100")
    eng = Engine(device="cpu", rule=parse_rule(rule))
    eng.server_distributor(Params(image_width=64, image_height=64,
                                  turns=200), world)
    (jpath,) = [str(p) for p in (tmp_path / "j").iterdir()]
    recs = journal.load_records(jpath)[0]
    digests = {(r["turn"], r["board_sha256"]) for r in recs
               if r["kind"] == "digest"}
    items = list(mf.list_checkpoints(str(tmp_path / "ck")))
    assert [t for t, _, _ in items][-1] == 200
    for _, _, m in items:
        assert (m["turn"], m["board_sha256"]) in digests
        assert jjournal.verify_file(jpath, expected_seq=m["journal"]["seq"])[
            "ok"]
    assert recs[-1]["kind"] == "end" and recs[-2]["trigger"] == "final"
    assert ckpt_inspect.main(["verify", str(tmp_path / "ck")]) == 0
    assert ckpt_inspect.main(["list", str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "200" in out
