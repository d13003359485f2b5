"""Event-sourced run journal: the hash-chained black box — the counterpart
of `gol_tpu/journal.py`, writing and verifying the same `gol-journal/1`
chains: a journal either package writes verifies under the other's
verifier, and `tools/replay_audit.py` replays the port's.

Every state-mutating input to a run — creation (seed board or derived
soup key), SetRule, reseed, pause/resume, fuse-depth change, migration
cutover, quarantine restore — is appended to a per-run `gol-journal/1`
JSONL log, plus periodic board-digest events so a replay can check
itself mid-history instead of only at the end (the reference's
`FinalTurnComplete` golden boards tell you *that* a run diverged,
never *where*).

Integrity is a SHA-256 hash chain: each record carries a monotonic
`seq`, the previous record's hash as `prev`, and its own hash over the
canonical JSON of everything else. A flipped bit, a removed line, or a
reordered pair is evident at the exact offending seq (`verify_chain`);
truncation of the tail is evident against the chain head that rides
checkpoint manifests (`manifest["journal"]`). Journals survive topology
changes: an adopted or migrated run appends a `link` event referencing
its predecessor's head, either continuing the same file (shared journal
root — the chain never breaks) or opening a fresh segment that
`verify_segments` stitches end to end.

Activation: `GOL_JOURNAL=DIR` (one `<run_id>.jsonl` per run under DIR);
`GOL_JOURNAL_DIGEST_EVERY=N` sets the engine's digest cadence in turns
(default 512); every checkpoint written while journaling adds a digest
too. The writer sits on the shared `obs.sink.GuardedLineSink`:
observability must never sink a run, so the first OSError disables the
journal and the engine carries on unjournaled.

Replay lives in `tools/replay_audit.py`; this module owns the record
format, the chain, the writer registry, and the verifier.
"""

from __future__ import annotations

import base64
import hashlib
import json
import os
import threading
import time
import zlib
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs.sink import GuardedLineSink

SCHEMA = "gol-journal/1"
JOURNAL_ENV = "GOL_JOURNAL"
DIGEST_EVERY_ENV = "GOL_JOURNAL_DIGEST_EVERY"
# 512-turn default, the JAX package's: each digest costs one small
# device-to-host copy + sha256 + append on the host.
DIGEST_EVERY_DEFAULT = 512

# The chain's genesis: a segment's first record links to 64 zero nibbles.
GENESIS = "0" * 64

# Every event kind a journal may carry (closed set — the catalog
# pre-seeds the metric children from the same tuple).
KINDS = ("create", "rule", "reseed", "pause", "resume", "fuse", "link",
         "restore", "digest", "migrate_out", "usage", "end", "other")

# Seed boards larger than this (compressed) are journaled digest-only:
# the record proves WHAT seeded the run without making the journal a
# second checkpoint store. Replay refuses digest-only external seeds.
SEED_INLINE_LIMIT = 1 << 20

RING = 512  # in-memory tail served to GetJournal


class JournalError(ValueError):
    """A journal file or record failed structural validation."""


# ------------------------------------------------------------- the chain

def chain_hash(rec: dict) -> str:
    """The record's chain hash: SHA-256 of the canonical JSON of every
    field EXCEPT `hash` itself (sorted keys, no whitespace)."""
    body = {k: v for k, v in rec.items() if k != "hash"}
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------- board codecs

def encode_board(board01: np.ndarray) -> Optional[dict]:
    """Inline-journal encoding of a {0,1} seed board: packbits + zlib +
    base64. None when the compressed payload exceeds SEED_INLINE_LIMIT
    (the caller journals digest-only instead)."""
    t0 = time.perf_counter()
    b = np.ascontiguousarray(np.asarray(board01, dtype=np.uint8))
    h, w = int(b.shape[0]), int(b.shape[1])
    # Level 1: soup-like boards barely compress past packbits anyway,
    # and the create event lands inside the run's hot path — speed
    # beats ratio here.
    raw = zlib.compress(np.packbits(b.ravel()).tobytes(), 1)
    obs.JOURNAL_WALL_US.inc((time.perf_counter() - t0) * 1e6)
    if len(raw) > SEED_INLINE_LIMIT:
        return None
    return {"enc": "pb+zlib+b64", "h": h, "w": w,
            "data": base64.b64encode(raw).decode("ascii")}


def decode_board(seed: dict) -> np.ndarray:
    """Inverse of encode_board -> {0,1} uint8 board."""
    if seed.get("enc") != "pb+zlib+b64":
        raise JournalError(f"unknown seed encoding {seed.get('enc')!r}")
    h, w = int(seed["h"]), int(seed["w"])
    raw = zlib.decompress(base64.b64decode(seed["data"]))
    bits = np.unpackbits(np.frombuffer(raw, dtype=np.uint8))
    if bits.size < h * w:
        raise JournalError("seed payload shorter than h*w bits")
    return bits[: h * w].reshape(h, w).astype(np.uint8)


def board_digest(host: np.ndarray, repr_: str = "packed") -> str:
    """Canonical digest of a host board state: the SAME board_sha256
    over the SAME payload arrays a checkpoint manifest records, so a
    journal digest event, a manifest, and a replay all compare one
    number. `host` may hold the port's int32 words: `payload_arrays`
    reinterprets them as the JAX package's uint32."""
    from gol_tpu_torch.ckpt import manifest as mf
    from gol_tpu_torch.ckpt.writer import payload_arrays

    t0 = time.perf_counter()
    arrays = payload_arrays(np.asarray(host), repr_)
    sha = mf.board_sha256(arrays)
    obs.JOURNAL_WALL_US.inc((time.perf_counter() - t0) * 1e6)
    return sha


# ------------------------------------------------------------ the writer

class JournalWriter:
    """Append-only hash-chained JSONL journal for one run.

    Opening a path that already holds a valid chain RESUMES it (seq and
    head recovered from the newest intact record) — an adopter writing
    into a shared journal root continues its predecessor's chain in
    place. All appends are thread-safe; sink failures latch the shared
    GuardedLineSink dead and appends become silent no-ops.
    """

    def __init__(self, path: str, run_id: str) -> None:
        self.path = path
        self.run_id = run_id
        self._lock = threading.Lock()
        self._sink = GuardedLineSink(path)
        self._ring: deque = deque(maxlen=RING)
        self._head = GENESIS
        self._last_seq = -1
        # Digest ordering floor: checkpoint-writer digests append
        # asynchronously, so a digest captured before a control event
        # can try to land after it. Dropping digests below the newest
        # journaled turn keeps every journal's digest turns monotonic —
        # the replay auditor stays a single forward pass. Non-digest
        # events always land and may rewind the floor (restore/link).
        self._turn_floor = -1
        self._recover()

    def _recover(self) -> None:
        """Resume (seq, head) from the newest intact record on disk, if
        any, and TRUNCATE a torn trailing fragment (a predecessor
        SIGKILLed mid-write leaves a partial line; appending after it
        would weld the next record onto garbage). A torn line is a
        crash artifact, not history — its hash never joined the chain.
        Garbage BEFORE intact records is left in place: that is
        corruption for the verifier to report, not ours to hide."""
        try:
            with open(self.path, "rb") as fh:
                raw = fh.read()
        except OSError:
            return
        pos, good_end = 0, 0
        while pos <= len(raw):
            nl = raw.find(b"\n", pos)
            end = len(raw) if nl < 0 else nl + 1
            chunk = raw[pos:end].strip()
            if chunk:
                rec = None
                try:
                    rec = json.loads(chunk.decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    pass
                if isinstance(rec, dict) and "seq" in rec \
                        and "hash" in rec:
                    self._last_seq = int(rec["seq"])
                    self._head = str(rec["hash"])
                    if isinstance(rec.get("turn"), int):
                        self._turn_floor = rec["turn"]
                    self._ring.append(rec)
                    good_end = end
            elif pos == good_end:
                good_end = end  # blank line right after the chain
            if nl < 0:
                break
            pos = end
        if good_end < len(raw):
            try:
                with open(self.path, "r+b") as fh:
                    fh.truncate(good_end)
            except OSError:
                pass

    # ------------------------------------------------------------- state

    @property
    def head(self) -> str:
        return self._head

    @property
    def last_seq(self) -> int:
        return self._last_seq

    @property
    def dead(self) -> bool:
        return self._sink.dead

    def head_info(self) -> dict:
        """The chain head that rides checkpoint manifests."""
        with self._lock:
            return {"head": self._head, "seq": self._last_seq}

    # ------------------------------------------------------------ append

    def append(self, kind: str, **fields) -> Optional[dict]:
        """Chain and append one record; returns it (None once dead).
        `fields` must be JSON-serializable."""
        t0 = time.perf_counter()
        with self._lock:
            if self._sink.dead:
                return None
            turn = fields.get("turn")
            if isinstance(turn, int):
                if kind == "digest" and turn < self._turn_floor:
                    return None  # stale async digest; keep turns monotone
                self._turn_floor = turn
            rec = {"schema": SCHEMA, "run_id": self.run_id,
                   "kind": kind, "ts": round(time.time(), 3),
                   "seq": self._last_seq + 1, "prev": self._head}
            rec.update(fields)
            # One canonical dump does double duty: it IS the chain-hash
            # preimage (chain_hash semantics: every field except `hash`,
            # sorted, compact), and the on-disk line is that blob with
            # the hash spliced in as the last key. Verifiers re-parse
            # and recompute from the fields, so line-level key order is
            # free — and the append path is on the engine's digest
            # cadence, where a second json.dumps per event is real cost.
            blob = json.dumps(rec, sort_keys=True,
                              separators=(",", ":"))
            rec["hash"] = hashlib.sha256(
                blob.encode("utf-8")).hexdigest()
            line = blob[:-1] + ',"hash":"' + rec["hash"] + '"}'
            if not self._sink.write_line(line):
                return None
            self._last_seq = rec["seq"]
            self._head = rec["hash"]
            self._ring.append(rec)
        label = kind if kind in KINDS else "other"
        obs.JOURNAL_EVENTS.labels(kind=label).inc()
        obs.JOURNAL_BYTES.inc(len(line) + 1)
        obs.JOURNAL_WALL_US.inc((time.perf_counter() - t0) * 1e6)
        if kind == "digest":
            obs.JOURNAL_DIGESTS.inc()
        try:  # best-effort per-run attribution
            from gol_tpu_torch.obs import usage as obs_usage
            obs_usage.METER.charge_journal(self.run_id, len(line) + 1)
        except Exception:
            pass
        return rec

    def digest(self, turn: int, sha: str, repr_: str = "packed",
               **fields) -> Optional[dict]:
        """Append one board-digest event at an exact turn."""
        return self.append("digest", turn=int(turn), board_sha256=sha,
                           repr=repr_, **fields)

    def tail(self, since_seq: int = -1, limit: int = 100) -> List[dict]:
        """Up to `limit` in-memory records with seq > since_seq,
        oldest first — the GetJournal wire surface."""
        with self._lock:
            recs = [r for r in self._ring if r["seq"] > since_seq]
        return recs[: max(0, int(limit))]

    def close(self) -> None:
        self._sink.close()


# ---------------------------------------------------------- the registry

_REG_LOCK = threading.Lock()
_JOURNALS: Dict[str, JournalWriter] = {}


def journal_dir(environ=os.environ) -> str:
    return environ.get(JOURNAL_ENV, "").strip()


def enabled(environ=os.environ) -> bool:
    return bool(journal_dir(environ))


def digest_every(environ=os.environ) -> int:
    """Engine digest cadence in turns; 0 disables cadence digests
    (checkpoint-coupled digests still land)."""
    raw = environ.get(DIGEST_EVERY_ENV, "").strip()
    if not raw:
        return DIGEST_EVERY_DEFAULT
    try:
        return max(0, int(raw))
    except ValueError:
        return DIGEST_EVERY_DEFAULT


def _safe_name(run_id: str) -> str:
    return "".join(c if (c.isalnum() or c in "-_.") else "_"
                   for c in run_id) or "run"


def journal_path(run_id: str, environ=os.environ) -> str:
    return os.path.join(journal_dir(environ),
                        _safe_name(run_id) + ".jsonl")


def for_run(run_id: str, environ=os.environ) -> Optional[JournalWriter]:
    """The process-wide journal for `run_id`, created under GOL_JOURNAL
    on first use; None while journaling is disabled. Never raises —
    observability must never sink a run."""
    if not enabled(environ):
        return None
    with _REG_LOCK:
        jw = _JOURNALS.get(run_id)
        if jw is None:
            try:
                d = journal_dir(environ)
                os.makedirs(d, exist_ok=True)
                jw = JournalWriter(journal_path(run_id, environ), run_id)
            except OSError:
                return None
            _JOURNALS[run_id] = jw
        return jw


def get(run_id: str) -> Optional[JournalWriter]:
    """The already-open journal for `run_id`, or None. Does not create:
    the checkpoint-writer hook must journal only runs that opted in."""
    with _REG_LOCK:
        return _JOURNALS.get(run_id)


def forget(run_id: str) -> None:
    """Close and drop a removed run's journal."""
    with _REG_LOCK:
        jw = _JOURNALS.pop(run_id, None)
    if jw is not None:
        jw.close()


def reset() -> None:
    """Close every registered journal (tests and process teardown)."""
    with _REG_LOCK:
        jws = list(_JOURNALS.values())
        _JOURNALS.clear()
    for jw in jws:
        jw.close()


# --------------------------------------------------------------- reading

def load_records(path: str) -> Tuple[List[dict], Optional[int]]:
    """Parse one journal file. Returns (records, torn_lineno): records
    are the parsed JSON objects in file order; torn_lineno is the
    1-based line number of a trailing unparsable line (mid-line
    truncation evidence), or None. An unparsable line FOLLOWED by valid
    lines raises — that is corruption, not truncation."""
    records: List[dict] = []
    torn: Optional[int] = None
    with open(path, "r", encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, 1):
            line = line.strip()
            if not line:
                continue
            if torn is not None:
                raise JournalError(
                    f"{path}:{torn}: unparsable record mid-file")
            try:
                rec = json.loads(line)
            except ValueError:
                torn = lineno
                continue
            if not isinstance(rec, dict):
                raise JournalError(
                    f"{path}:{lineno}: record is not an object")
            records.append(rec)
    return records, torn


# ------------------------------------------------------------ the verifier

def verify_chain(records: Sequence[dict],
                 expected_head: Optional[str] = None,
                 expected_seq: Optional[int] = None,
                 genesis: str = GENESIS) -> dict:
    """Walk a segment's chain; report the EXACT offending seq on the
    first break.

    Returns {"ok", "count", "head", "last_seq", "bad_seq", "reason"}:
      * bit-flip      -> hash mismatch at the flipped record's seq
      * reorder       -> seq out of order at the first displaced position
      * removed line  -> seq gap at the removed record's seq
      * tail truncation -> chain intact but short of `expected_seq` /
        `expected_head` (the head riding a checkpoint manifest): the
        first missing seq is reported.
    """
    def bad(seq: int, reason: str) -> dict:
        return {"ok": False, "count": len(records), "head": head,
                "last_seq": last_seq, "bad_seq": int(seq),
                "reason": reason}

    head, last_seq = genesis, -1
    for pos, rec in enumerate(records):
        if not isinstance(rec, dict):
            return bad(last_seq + 1, "record is not an object")
        seq = rec.get("seq")
        if not isinstance(seq, int):
            return bad(last_seq + 1, "missing seq")
        if rec.get("schema") != SCHEMA:
            return bad(seq, f"schema {rec.get('schema')!r} != {SCHEMA!r}")
        if pos == 0:
            if rec.get("prev") != genesis:
                return bad(seq, f"first record prev {rec.get('prev')!r} "
                                f"is not the segment genesis")
        else:
            if seq != last_seq + 1:
                return bad(last_seq + 1,
                           f"seq {seq} after {last_seq} "
                           f"(want {last_seq + 1})")
            if rec.get("prev") != head:
                return bad(seq, "prev does not match prior record hash")
        if chain_hash(rec) != rec.get("hash"):
            return bad(seq, "record hash mismatch (tampered)")
        head, last_seq = rec["hash"], seq
    if expected_seq is not None and last_seq < expected_seq:
        return bad(last_seq + 1,
                   f"truncated: chain ends at seq {last_seq}, "
                   f"expected through seq {expected_seq}")
    if expected_head is not None and head != expected_head:
        return bad(last_seq + 1,
                   "truncated: chain head does not match the expected "
                   "head (checkpoint manifest is newer than the file)")
    return {"ok": True, "count": len(records), "head": head,
            "last_seq": last_seq, "bad_seq": None, "reason": None}


def verify_file(path: str, expected_head: Optional[str] = None,
                expected_seq: Optional[int] = None) -> dict:
    """verify_chain over one file, folding in mid-line truncation."""
    try:
        records, torn = load_records(path)
    except (OSError, JournalError) as e:
        return {"ok": False, "count": 0, "head": GENESIS, "last_seq": -1,
                "bad_seq": 0, "reason": str(e)}
    res = verify_chain(records, expected_head=expected_head,
                       expected_seq=expected_seq)
    if res["ok"] and torn is not None:
        res = dict(res, ok=False, bad_seq=res["last_seq"] + 1,
                   reason=f"torn trailing record at line {torn}")
    return res


#: Kinds that may legitimately trail the head a link event references:
#: the transfer captures the head at quiesce, then the source still
#: appends its sync-checkpoint digest, the final usage accounting
#: record, and the migrate_out/end bookend.
_TRAILING_KINDS = ("digest", "migrate_out", "usage", "end")


def verify_segments(segments: Sequence[Sequence[dict]]) -> dict:
    """Stitch-verify an ordered lineage of journal segments (a run that
    crossed members with per-member journal roots). Segment k>0 must
    open with a `link` record whose prev_head/prev_seq name a record in
    segment k-1 — normally its final head; records past the referenced
    seq are tolerated only if they are trailing bookends (digest /
    migrate_out / end), which the source legitimately appends after the
    transfer captured its head. The post-failover history then verifies
    end to end."""
    prev_seg: Sequence[dict] = ()
    head, last_seq, total = GENESIS, -1, 0
    for i, seg in enumerate(segments):
        res = verify_chain(seg)
        if not res["ok"]:
            return dict(res, segment=i)
        if i > 0:
            first = seg[0] if seg else {}
            if first.get("kind") != "link":
                return {"ok": False, "count": total + res["count"],
                        "head": res["head"], "last_seq": res["last_seq"],
                        "bad_seq": first.get("seq", 0), "segment": i,
                        "reason": "segment does not open with a link "
                                  "record"}
            want_seq = first.get("prev_seq")
            want_head = first.get("prev_head")
            anchor = None
            if isinstance(want_seq, int) and prev_seg:
                idx = want_seq - prev_seg[0]["seq"]
                if 0 <= idx < len(prev_seg):
                    anchor = prev_seg[idx]
            if (anchor is None or anchor.get("hash") != want_head
                    or any(r.get("kind") not in _TRAILING_KINDS
                           for r in prev_seg[idx + 1:])):
                return {"ok": False, "count": total + res["count"],
                        "head": res["head"], "last_seq": res["last_seq"],
                        "bad_seq": first.get("seq", 0), "segment": i,
                        "reason": "link does not reference the prior "
                                  "segment's head"}
        head, last_seq = res["head"], res["last_seq"]
        total += res["count"]
        prev_seg = seg
    return {"ok": True, "count": total, "head": head,
            "last_seq": last_seq, "bad_seq": None, "reason": None}
