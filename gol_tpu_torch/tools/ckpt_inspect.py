"""ckpt-inspect: operator tool for gol-ckpt/1 checkpoint directories.

    python -m gol_tpu_torch.tools.ckpt_inspect list   DIR [--strict]
    python -m gol_tpu_torch.tools.ckpt_inspect verify DIR|MANIFEST
    python -m gol_tpu_torch.tools.ckpt_inspect diff   A B

`list` tabulates every durable checkpoint (run, turn, trigger, repr,
rule, board, alive, payload bytes, file) — malformed manifests are
skipped unless --strict. Fleet directories nest per-run checkpoints in
`run-<id>/` subdirectories; `list` walks those too, labelling each row
with its run id ("-" = the legacy root run). `verify` re-parses every
manifest AND recomputes the payload SHA-256 from disk (the same refusal
gate `--resume` runs); exit 1 if anything fails. `diff` compares two
checkpoints (manifest paths, or directories meaning their newest
durable checkpoint) and reports the number of differing cells — exact
for every representation via XOR-popcount on the packed families, no
decode needed.

Host only (numpy over `gol_tpu_torch.ckpt.manifest`): it needs no card,
and its output and exit codes are the JAX package's
`tools/ckpt_inspect.py`'s for the same directories."""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from gol_tpu_torch.ckpt import manifest as mf


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KB", "MB", "GB"):
        if n < 1024 or unit == "GB":
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024.0
    return f"{n}B"


def _fleet_run_dirs(base: str) -> list:
    """Fleet layout: per-run checkpoints live in contained
    `run-<id>` subdirectories under the configured root (the legacy
    run keeps writing at the root itself). Returns sorted
    (run_id, dir) pairs — empty for pre-fleet layouts."""
    out = []
    try:
        names = sorted(os.listdir(base))
    except OSError:
        return out
    for nm in names:
        full = os.path.join(base, nm)
        if nm.startswith("run-") and os.path.isdir(full):
            out.append((nm[len("run-"):], full))
    return out


def cmd_list(args) -> int:
    rows = [("RUN", "TURN", "TRIGGER", "REPR", "RULE", "BOARD", "ALIVE",
             "BYTES", "FILE")]
    n = 0
    scan = [("-", args.dir)] + _fleet_run_dirs(args.dir)
    for run_label, directory in scan:
        for turn, path, m in mf.list_checkpoints(directory,
                                                 strict=args.strict):
            board = m.get("board") or {}
            rows.append((
                run_label, str(turn), str(m.get("trigger", "?")),
                m["repr"], m["rule"],
                f"{board.get('h', '?')}x{board.get('w', '?')}",
                str(m.get("alive", "?")), _fmt_bytes(m["payload_bytes"]),
                os.path.basename(path)))
            n += 1
    if n == 0:
        print(f"{args.dir}: no durable checkpoints")
        return 1
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
    return 0


def cmd_verify(args) -> int:
    if os.path.isdir(args.path):
        targets = [(p, m) for _, p, m in
                   mf.list_checkpoints(args.path, strict=False)]
        # strict re-read below catches what the lenient listing skipped
        names = [nm for nm in sorted(os.listdir(args.path))
                 if nm.startswith(mf.CKPT_PREFIX)
                 and nm.endswith(mf.MANIFEST_SUFFIX)]
        listed = {os.path.basename(p) for p, _ in targets}
        bad_parse = [nm for nm in names if nm not in listed]
    else:
        targets, bad_parse = [(args.path, None)], []
    failures = len(bad_parse)
    for nm in bad_parse:
        print(f"FAIL  {nm}: manifest does not parse/validate")
    for path, _ in targets:
        try:
            m = mf.verify_manifest(path)
            print(f"ok    {os.path.basename(path)}: turn {m['turn']}, "
                  f"payload sha256 {m['payload_sha256'][:12]}… verified")
        except mf.CheckpointIntegrityError as e:
            failures += 1
            print(f"FAIL  {os.path.basename(path)}: {e}")
    if not targets and not bad_parse:
        print(f"{args.path}: nothing to verify")
        return 1
    print(f"{len(targets) + len(bad_parse) - failures} ok, "
          f"{failures} failed")
    return 1 if failures else 0


def _resolve_one(ref: str):
    """manifest path or directory (newest durable) -> (path, manifest)."""
    if os.path.isdir(ref):
        latest = mf.latest_checkpoint(ref)
        if latest is None:
            raise SystemExit(f"{ref}: no durable checkpoint")
        return latest[1], latest[2]
    return ref, mf.read_manifest(ref)


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint16)


def _payload_cells(path: str, m: dict):
    """(array, kind): the payload's state array plus how to count cell
    diffs on it — 'bits' (uint32 words, XOR+popcount) or 'cells'
    (elementwise uint8 compare)."""
    with np.load(mf.payload_path(path, m)) as z:
        for key, kind in (("words", "bits"), ("gen_planes", "bits"),
                          ("sparse_words", "bits"),
                          ("gen_state", "cells"), ("world", "cells")):
            if key in z.files:
                return z[key], kind
    raise SystemExit(f"{path}: unrecognized payload members")


def cmd_diff(args) -> int:
    pa, ma = _resolve_one(args.a)
    pb, mb = _resolve_one(args.b)
    same_meta = True
    for field in ("turn", "rule", "repr", "board"):
        va, vb = ma.get(field), mb.get(field)
        marker = "" if va == vb else "   <-- differs"
        same_meta &= va == vb
        print(f"{field:6} {va!r:>24} | {vb!r}{marker}")
    print(f"{'alive':6} {ma.get('alive')!r:>24} | {mb.get('alive')!r}")
    if ma["board_sha256"] == mb["board_sha256"]:
        print("boards: IDENTICAL (board_sha256 match)")
        return 0
    if ma["repr"] != mb["repr"] or ma.get("board") != mb.get("board"):
        print("boards: DIFFER (shape/representation mismatch — "
              "cell diff unavailable)")
        return 1
    a, ka = _payload_cells(pa, ma)
    b, _ = _payload_cells(pb, mb)
    if a.shape != b.shape:
        print(f"boards: DIFFER (payload shapes {a.shape} vs {b.shape})")
        return 1
    if ka == "bits":
        xor = (a ^ b).view(np.uint8)
        ndiff = int(_POP8[xor].sum(dtype=np.int64))
    else:
        ndiff = int((a != b).sum(dtype=np.int64))
    print(f"boards: DIFFER in {ndiff} cell(s)")
    return 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gol_tpu_torch.tools.ckpt_inspect",
        description="list / verify / diff gol-ckpt/1 checkpoints")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="tabulate durable checkpoints")
    p.add_argument("dir")
    p.add_argument("--strict", action="store_true",
                   help="fail on malformed manifests instead of skipping")
    p.set_defaults(fn=cmd_list)
    p = sub.add_parser("verify",
                       help="recompute payload hashes, exit 1 on mismatch")
    p.add_argument("path", help="checkpoint directory or manifest")
    p.set_defaults(fn=cmd_verify)
    p = sub.add_parser("diff", help="compare two checkpoints")
    p.add_argument("a", help="manifest path or directory (newest)")
    p.add_argument("b", help="manifest path or directory (newest)")
    p.set_defaults(fn=cmd_diff)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
