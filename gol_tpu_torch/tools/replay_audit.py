"""Deterministic replay auditor for gol-journal/1 black boxes, on the card.

Feeds a recorded journal (one file, or an ordered lineage of segment
files for a run that crossed members) into a fresh replay and asserts
bit-identical board digests at EVERY digest event:

  1. chain verification first — a flipped bit, removed line, reordered
     pair, or truncated tail is reported at the exact offending seq
     (tools never replay a tampered history);
  2. forward replay — the seed is reconstructed from the create event
     (inline board, or the deterministic run_id-keyed soup), rule
     changes apply at their recorded turns, link/restore events rewind
     to their recorded turn, and each digest event's board_sha256 is
     recomputed from the replayed board with the same canonical payload
     hashing checkpoint manifests use;
  3. on mismatch the auditor stops at the first divergent digest (the
     tightest bracket the recorded digests allow), dumps the replayed
     board, the expected board recovered from a matching checkpoint
     when --ckpt is given, and a flight record, then exits nonzero and
     increments gol_replay_divergence_total.

Word-aligned boards replay as packed words on `--device` through the
engine's own dispatch (`parallel.halo.packed_run_turns`: on a card K1
for a board one cluster holds, K2 sweeps beyond), and stay there between
digests: the words come to the host only to hash a digest and to keep a
rewind anchor. Other widths replay in numpy, as the JAX package's
auditor does.

Exit codes: 0 verified, 1 divergence, 2 chain verification failure,
3 unusable input (missing file, unreplayable seed with digests to
check, unsupported representation).

    python -m gol_tpu_torch.tools.replay_audit JOURNAL.jsonl
        [SEGMENT2.jsonl ...] [--expect-head HEX] [--expect-seq N]
        [--ckpt DIR] [--dump DIR] [--device cuda|cpu] [--quiet]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

import numpy as np

from gol_tpu_torch import journal
from gol_tpu_torch.ckpt import manifest as mf
from gol_tpu_torch.ckpt import reshard as reshard_mod
from gol_tpu_torch.engine import resolve_device
from gol_tpu_torch.fleet.buckets import board_to_words, words_to_board
from gol_tpu_torch.fleet.engine import _soup
from gol_tpu_torch.models import parse_rule
from gol_tpu_torch.obs import catalog as obs
from gol_tpu_torch.obs import flight
from gol_tpu_torch.ops.bitpack import (
    WORD_BITS,
    words_from_numpy,
    words_to_numpy,
)
from gol_tpu_torch.parallel.halo import packed_run_turns

# Turns a stepping call: the engine's largest chunk. Any chunking gives
# the same board; the words stay on the device between calls.
CHUNK = 1 << 21
# Rewind anchors kept besides the seed (link/restore recompute from the
# nearest earlier anchor — bounded so a long journal stays O(1) memory).
CACHE_BOARDS = 32


def _step_np(board01: np.ndarray, turns: int, rule) -> np.ndarray:
    """Pure-numpy torus stepper for boards whose width is not
    word-aligned (the fleet checkpoints those as u8). Integer-exact —
    any correct evolution of the same torus is bit-identical."""
    born = np.array([1 if n in rule.born else 0 for n in range(9)],
                    dtype=np.uint8)
    surv = np.array([1 if n in rule.survive else 0 for n in range(9)],
                    dtype=np.uint8)
    b = board01.astype(np.uint8)
    for _ in range(turns):
        n = sum(np.roll(np.roll(b, dy, 0), dx, 1)
                for dy in (-1, 0, 1) for dx in (-1, 0, 1)
                if (dy, dx) != (0, 0))
        b = np.where(b != 0, surv[n], born[n]).astype(np.uint8)
    return b


def _padded_words(board01: np.ndarray) -> np.ndarray:
    """Host packed words of a board of any width, its last word's
    columns past the board zero (the JAX package's `pack_np`)."""
    pad = -board01.shape[1] % WORD_BITS
    if pad:
        board01 = np.pad(board01, ((0, 0), (0, pad)))
    return board_to_words(board01)


class Replayer:
    """Forward-replays one run's journal records, checking digests.

    A word-aligned board lives as packed words on `device` (`_words`);
    any other lives as a host {0,1} board (`_board`)."""

    def __init__(self, dump_dir: str = "", ckpt_root: str = "",
                 device="cuda"):
        self.dump_dir = dump_dir
        self.ckpt_root = ckpt_root
        self.device = resolve_device(device)
        self._board: Optional[np.ndarray] = None
        self._words = None
        self._shape: Tuple[int, int] = (0, 0)
        self.turn = 0
        self.rule = None
        self.run_id = ""
        self.unreplayable: Optional[str] = None
        self.checked = 0
        self.skipped = 0
        self.last_good: Optional[Tuple[int, int]] = None  # (seq, turn)
        # turn -> host state: packed words, or the board for u8 widths.
        self._cache: "dict[int, np.ndarray]" = {}

    # ------------------------------------------------------------ state

    @property
    def seeded(self) -> bool:
        return self._board is not None or self._words is not None

    @property
    def board(self) -> np.ndarray:
        """The replayed {0,1} board on the host."""
        if self._board is not None:
            return self._board
        return words_to_board(words_to_numpy(self._words), *self._shape)

    def _set_state(self, host: np.ndarray, shape) -> None:
        """Adopt a host state: packed words for a word-aligned board,
        else the board itself."""
        self._shape = (int(shape[0]), int(shape[1]))
        if self._shape[1] % WORD_BITS == 0:
            self._words = words_from_numpy(host, self.device)
            self._board = None
        else:
            self._board = host.copy()
            self._words = None

    def _set_board(self, board01: np.ndarray) -> None:
        host = (board_to_words(board01) if board01.shape[1] % WORD_BITS == 0
                else board01)
        self._set_state(host, board01.shape)

    def _host_state(self) -> np.ndarray:
        """A host copy of the state: the words (one device-to-host copy)
        or the board."""
        if self._words is not None:
            return words_to_numpy(self._words)
        return self._board.copy()

    def _remember(self, turn: int, host: Optional[np.ndarray] = None) -> None:
        self._cache[turn] = self._host_state() if host is None else host
        if len(self._cache) > CACHE_BOARDS + 1:
            # Keep the oldest anchor (the seed) and the newest rest.
            evict = sorted(self._cache)[1]
            del self._cache[evict]

    def _advance(self, to_turn: int) -> None:
        n = to_turn - self.turn
        if n < 0:
            raise journal.JournalError(
                f"cannot advance backwards {self.turn} -> {to_turn}")
        if n == 0:
            return
        if self._words is not None:
            while n:
                step = min(n, CHUNK)
                self._words = packed_run_turns(self._words, step, self.rule)
                n -= step
        else:
            self._board = _step_np(self._board, n, self.rule)
        self.turn = to_turn

    def _rewind_to(self, to_turn: int) -> None:
        if to_turn >= self.turn:
            self._advance(to_turn)
            return
        anchors = [t for t in self._cache if t <= to_turn]
        if not anchors:
            raise journal.JournalError(
                f"no replay anchor at or before turn {to_turn} "
                f"(earliest cached: {min(self._cache, default='none')})")
        t0 = max(anchors)
        self._set_state(self._cache[t0], self._shape)
        self.turn = t0
        self._advance(to_turn)

    def _board_sha(self, repr_: str) -> Tuple[str, Optional[np.ndarray]]:
        """(digest of the replayed board in `repr_`, the host words it
        hashed where they are the state's anchor, else None)."""
        if repr_ == "packed":
            if self._words is not None:
                host = words_to_numpy(self._words)
                return journal.board_digest(host, "packed"), host
            return journal.board_digest(_padded_words(self._board),
                                        "packed"), None
        if repr_ == "u8":
            return journal.board_digest(self.board, "u8"), None
        raise journal.JournalError(
            f"unsupported digest representation {repr_!r}")

    # ----------------------------------------------------------- events

    def _seed_board(self, rec: dict) -> Optional[np.ndarray]:
        if isinstance(rec.get("seed"), dict):
            return journal.decode_board(rec["seed"])
        if rec.get("seed_kind") == "soup":
            return _soup(str(rec.get("run_id", self.run_id)),
                         int(rec["h"]), int(rec["w"]))
        return None

    def _apply_create(self, rec: dict) -> None:
        self.run_id = str(rec.get("run_id", ""))
        self.rule = parse_rule(rec.get("rule") or "B3/S23")
        self.turn = int(rec.get("turn", 0))
        board = self._seed_board(rec)
        if board is None:
            self.unreplayable = (
                f"seed is external (seq {rec['seq']}): digest-only "
                "create events cannot reseed a replay")
            return
        self._set_board(board)
        self._cache.clear()
        self._remember(self.turn)
        want = rec.get("board_sha256")
        if want and self._board_sha(rec.get("repr", "packed"))[0] != want:
            raise journal.JournalError(
                f"seed digest mismatch at seq {rec['seq']}: the "
                "recorded seed does not hash to the recorded "
                "board_sha256")

    def _check(self, rec: dict) -> Optional[dict]:
        """Compare the replayed board with a record's digest; on a match
        count it and keep the board as an anchor."""
        want = rec.get("board_sha256")
        got, host = self._board_sha(rec.get("repr", "packed"))
        if got != want:
            return self._diverged(rec, want, got)
        self.checked += 1
        self.last_good = (rec["seq"], self.turn)
        self._remember(self.turn, host)
        return None

    def apply(self, rec: dict) -> Optional[dict]:
        """Apply one record; returns a divergence report or None."""
        kind = rec.get("kind")
        if self.unreplayable is not None:
            if kind == "digest":
                self.skipped += 1
            return None
        if kind == "create":
            self._apply_create(rec)
            return None
        if not self.seeded:
            # Records before the run's create (a pool digest racing
            # registration) have nothing to check against yet.
            if kind == "digest":
                self.skipped += 1
            return None
        if kind == "rule":
            self._advance(int(rec["turn"]))
            self.rule = parse_rule(rec["rule"])
        elif kind == "reseed":
            board = self._seed_board(rec)
            if board is None:
                self.unreplayable = (
                    f"reseed at seq {rec['seq']} is external "
                    "(digest-only)")
                return None
            self._set_board(board)
            self.turn = int(rec.get("turn", self.turn))
            self._cache.clear()
            self._remember(self.turn)
        elif kind in ("link", "restore"):
            self._rewind_to(int(rec["turn"]))
            if rec.get("board_sha256"):
                return self._check(rec)
        elif kind == "digest":
            self._rewind_to(int(rec["turn"]))
            return self._check(rec)
        # pause/resume/fuse/end/migrate_out carry no replayable state.
        return None

    # ------------------------------------------------------- divergence

    def _expected_board(self, turn: int) -> Optional[np.ndarray]:
        """Best-effort recovery of the ORIGINAL board at the divergent
        turn from a checkpoint root (the digest events at checkpoint
        cadence have a durable twin)."""
        if not self.ckpt_root:
            return None
        try:
            for d in (os.path.join(self.ckpt_root, f"run-{self.run_id}"),
                      self.ckpt_root):
                if not os.path.isdir(d):
                    continue
                for name in sorted(os.listdir(d)):
                    if not (name.startswith(mf.CKPT_PREFIX)
                            and name.endswith(mf.MANIFEST_SUFFIX)):
                        continue
                    path = os.path.join(d, name)
                    try:
                        m = mf.read_manifest(path)
                    except Exception:
                        continue
                    if int(m.get("turn", -1)) != turn:
                        continue
                    m = mf.verify_manifest(path)
                    can = reshard_mod.load_canonical(
                        mf.payload_path(path, m))
                    return reshard_mod.board01_of(can)
        except Exception:
            return None
        return None

    def _diverged(self, rec: dict, want: str, got: str) -> dict:
        report = {
            "run_id": self.run_id,
            "seq": rec.get("seq"),
            "turn": int(rec.get("turn", self.turn)),
            "expected_sha": want,
            "replayed_sha": got,
            "last_good_seq": (self.last_good or (None, None))[0],
            "last_good_turn": (self.last_good or (None, None))[1],
        }
        obs.REPLAY_DIVERGENCE.inc()
        if self.dump_dir:
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                stem = os.path.join(
                    self.dump_dir,
                    f"divergence-{journal._safe_name(self.run_id)}"
                    f"-seq{rec.get('seq')}")
                np.savez_compressed(
                    stem + "-replayed.npz", board=self.board,
                    turn=self.turn)
                report["replayed_board"] = stem + "-replayed.npz"
                expected = self._expected_board(report["turn"])
                if expected is not None:
                    np.savez_compressed(
                        stem + "-expected.npz", board=expected,
                        turn=report["turn"])
                    report["expected_board"] = stem + "-expected.npz"
                with open(stem + ".json", "w", encoding="utf-8") as f:
                    json.dump(report, f, indent=2, sort_keys=True)
                    f.write("\n")
                flight.FLIGHT.record_event(
                    {"level": "error", "event": "replay.divergence",
                     **{k: v for k, v in report.items()
                        if isinstance(v, (str, int, float))}})
                fpath = flight.FLIGHT.dump(
                    reason="replay-divergence",
                    path=stem + "-flight.json")
                if fpath:
                    report["flight_record"] = fpath
            except Exception as e:
                report["dump_error"] = f"{type(e).__name__}: {e}"
        return report


def _load_segments(paths: List[str]) -> Tuple[List[List[dict]],
                                              Optional[str]]:
    segments: List[List[dict]] = []
    for p in paths:
        records, torn = journal.load_records(p)
        if torn is not None:
            return segments, f"{p}: torn trailing record at line {torn}"
        segments.append(records)
    return segments, None


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gol_tpu_torch.tools.replay_audit",
        description="verify + deterministically replay a gol-journal/1 "
                    "black box")
    ap.add_argument("segments", nargs="+", metavar="JOURNAL.jsonl",
                    help="journal file(s); multiple files form an "
                         "ordered lineage stitched across link events")
    ap.add_argument("--expect-head", default="",
                    help="expected final chain head (e.g. from the "
                         "newest checkpoint manifest's journal stamp) "
                         "— catches tail truncation")
    ap.add_argument("--expect-seq", type=int, default=None,
                    help="expected final seq (paired with "
                         "--expect-head)")
    ap.add_argument("--ckpt", default="",
                    help="checkpoint root for recovering the original "
                         "board at a divergent digest turn")
    ap.add_argument("--dump", default="",
                    help="directory for divergence artifacts (boards, "
                         "report, flight record)")
    ap.add_argument("--device", default="cuda",
                    help="device the packed replay steps on (default "
                         "cuda; raises without a card)")
    ap.add_argument("--quiet", action="store_true")
    args = ap.parse_args(argv)

    def say(msg: str) -> None:
        if not args.quiet:
            print(msg)

    rp = Replayer(dump_dir=args.dump, ckpt_root=args.ckpt,
                  device=args.device)
    try:
        segments, torn_err = _load_segments(args.segments)
    except (OSError, journal.JournalError) as e:
        print(f"replay_audit: {e}", file=sys.stderr)
        return 2
    if torn_err is not None:
        print(f"replay_audit: chain FAILED: {torn_err}",
              file=sys.stderr)
        return 2

    if len(segments) == 1:
        res = journal.verify_chain(
            segments[0],
            expected_head=args.expect_head or None,
            expected_seq=args.expect_seq)
    else:
        res = journal.verify_segments(segments)
        if res["ok"] and args.expect_head \
                and res["head"] != args.expect_head:
            res = dict(res, ok=False, bad_seq=res["last_seq"] + 1,
                       reason="truncated: final head does not match "
                              "--expect-head")
    if not res["ok"]:
        seg = f" segment {res['segment']}" if "segment" in res else ""
        print(f"replay_audit: chain FAILED at seq {res['bad_seq']}"
              f"{seg}: {res['reason']}", file=sys.stderr)
        return 2
    say(f"chain ok: {res['count']} records, head {res['head'][:16]}…, "
        f"last seq {res['last_seq']}")

    for seg in segments:
        for rec in seg:
            try:
                report = rp.apply(rec)
            except journal.JournalError as e:
                print(f"replay_audit: replay FAILED at seq "
                      f"{rec.get('seq')}: {e}", file=sys.stderr)
                return 3
            if report is not None:
                print("replay_audit: DIVERGENCE at seq "
                      f"{report['seq']} turn {report['turn']}: "
                      f"expected {report['expected_sha'][:16]}…, "
                      f"replayed {report['replayed_sha'][:16]}… "
                      f"(last good digest: turn "
                      f"{report['last_good_turn']})", file=sys.stderr)
                for k in ("replayed_board", "expected_board",
                          "flight_record", "first_divergent_turn"):
                    if k in report:
                        print(f"  {k}: {report[k]}", file=sys.stderr)
                return 1
    if rp.unreplayable is not None:
        level = sys.stderr if rp.skipped else sys.stdout
        print(f"replay_audit: unreplayable: {rp.unreplayable} "
              f"({rp.skipped} digest(s) unchecked)", file=level)
        return 3 if rp.skipped else 0
    say(f"replay ok: {rp.checked} digest(s) bit-identical"
        + (f", {rp.skipped} skipped (pre-create)" if rp.skipped else "")
        + f", final turn {rp.turn}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
