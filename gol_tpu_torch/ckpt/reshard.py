"""Reshard-at-restore: resume a checkpoint written under another geometry
— the counterpart of `gol_tpu/ckpt/reshard.py` for the port's one-device
dense and sparse engines.

* `restore_delta(manifest, engine)` names every way the checkpoint's
  recorded geometry disagrees with the engine that wants to load it
  (mesh device count, sparse-window representation and torus size,
  cell-dtype family). A sparse manifest restores directly onto a sparse
  engine of the same torus.
  A non-empty delta without an explicit reshard request is refused with
  `GeometryMismatch` — tagged `rpc_error_kind="geometry"` so the wire
  layer answers with a `geometry:` error.

* `reshard_into(engine, manifest, payload)` is the host-side repack:
  decode the payload to a canonical board (exact, bit-identical — no
  resampling, the board IS the state), then re-encode it in the npz
  dialect the engine's own `load_checkpoint` verifies and installs. A
  checkpoint of the JAX package's 8-device mesh, or of a sparse engine
  onto a dense one (and a torus-sized dense board onto a sparse engine),
  thus resumes on one card without a bit of drift.

Canonical decode covers every payload either package's writer emits:
packed `words`, raw `world` pixels, Generations `gen_planes`/`gen_state`,
Lenia's continuous `float_state`, and a sparse engine's window words
(embedded into its full torus with wraparound).
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional

import numpy as np

from gol_tpu_torch.obs.log import log as obs_log
from gol_tpu_torch.wire import unpack_bits, words_bytes


class GeometryMismatch(ValueError):
    """Checkpoint geometry disagrees with the resuming engine and no
    reshard was requested. Tagged so server.py can answer with a
    `geometry:` error the client maps back to `GeometryRefused`."""

    rpc_error_kind = "geometry"


class Canonical:
    """One checkpoint decoded to its exact host-side state.

    kind is "life" ({0,1} board01), "gen" (Generations state bytes),
    "float" (continuous float32 state — Lenia) or "pixels" (raw u8
    pixels whose interpretation the target engine's rule decides — the
    legacy `world` member round-trips verbatim)."""

    __slots__ = ("kind", "board", "turn", "rule")

    def __init__(self, kind: str, board: np.ndarray, turn: int,
                 rule: Optional[str]) -> None:
        self.kind = kind
        self.board = board
        self.turn = int(turn)
        self.rule = rule


def _words_to_board(words: np.ndarray, h: int, w: int) -> np.ndarray:
    return unpack_bits(words_bytes(np.asarray(words)), h, w)


def load_canonical(payload_path: str) -> Canonical:
    """Decode any writer payload (or legacy autosave npz) to canonical
    host state. Pure host-side numpy — bit-exact by construction."""
    with np.load(payload_path) as z:
        turn = int(z["turn"]) if "turn" in z else 0
        rule = str(z["rulestring"]) if "rulestring" in z else None
        if "sparse_words" in z:
            sw = np.ascontiguousarray(z["sparse_words"], dtype=np.uint32)
            size = int(z["size"])
            ox, oy = int(z["ox"]), int(z["oy"])
            if sw.ndim != 2:
                raise ValueError("sparse_words must be 2-D")
            win = _words_to_board(sw, sw.shape[0], sw.shape[1] * 32)
            board = np.zeros((size, size), dtype=np.uint8)
            rows = (np.arange(win.shape[0]) + oy) % size
            cols = (np.arange(win.shape[1]) + ox) % size
            board[np.ix_(rows, cols)] = win
            return Canonical("life", board, turn, rule)
        if "gen_planes" in z:
            planes = np.asarray(z["gen_planes"], dtype=np.uint32)
            width = int(z["width"])
            if planes.ndim != 3 or planes.shape[0] != 2:
                raise ValueError("gen_planes must be (2, h, words)")
            h = planes.shape[1]
            state = (_words_to_board(planes[0], h, width)
                     + 2 * _words_to_board(planes[1], h, width)
                     ).astype(np.uint8)
            return Canonical("gen", state, turn, rule)
        if "gen_state" in z:
            state = np.ascontiguousarray(z["gen_state"], dtype=np.uint8)
            if state.ndim != 2:
                raise ValueError("gen_state must be 2-D")
            return Canonical("gen", state, turn, rule)
        if "float_state" in z:
            state = np.ascontiguousarray(z["float_state"],
                                         dtype=np.float32)
            if state.ndim != 2:
                raise ValueError("float_state must be 2-D")
            return Canonical("float", state, turn, rule)
        if "words" in z:
            words = np.ascontiguousarray(z["words"], dtype=np.uint32)
            width = int(z["width"])
            if words.ndim != 2 or words.shape[-1] * 32 != width:
                raise ValueError(
                    f"words shape {words.shape} inconsistent with "
                    f"width {width}")
            board = _words_to_board(words, words.shape[0], width)
            return Canonical("life", board, turn, rule)
        if "world" in z:
            world = np.ascontiguousarray(z["world"], dtype=np.uint8)
            if world.ndim != 2:
                raise ValueError("world must be 2-D")
            return Canonical("pixels", world, turn, rule)
    raise ValueError(
        f"{payload_path}: no decodable payload member (expected one of "
        f"sparse_words / gen_planes / gen_state / float_state / words / "
        f"world)")


def board01_of(can: Canonical) -> np.ndarray:
    """Canonical state as a {0,1} uint8 board (life-like kinds only)."""
    if can.kind == "life":
        return can.board
    if can.kind == "pixels":
        return (can.board != 0).astype(np.uint8)
    if can.kind == "float":
        raise GeometryMismatch(
            "continuous float state has no binary-board form; restore "
            "it onto an engine running its own (Lenia) rule")
    raise GeometryMismatch(
        "Generations state has no binary-board form; reshard it onto a "
        "Generations engine with the same rule family")


# -- engine geometry contract ------------------------------------------

def restore_delta(manifest: dict, engine) -> List[str]:
    """Every way `manifest`'s recorded geometry disagrees with
    `engine.geometry()`. Empty list = the direct payload load is already
    correct. Board height/width are deliberately NOT a delta for the
    dense engine: its install path adopts the checkpoint's shape. A
    sparse engine's torus size is fixed at construction, so it is."""
    geo = engine.geometry()
    deltas: List[str] = []
    mrepr = str(manifest.get("repr", ""))
    kind = geo.get("kind")
    if kind == "sparse":
        if mrepr != "sparse":
            deltas.append(f"repr {mrepr} -> sparse engine")
        else:
            extra = manifest.get("sparse") or {}
            msize = int(extra.get("size",
                                  manifest.get("board", {}).get("h", 0)))
            if msize != int(geo.get("size", msize)):
                deltas.append(f"sparse torus {msize} -> "
                              f"{geo.get('size')}")
    elif mrepr == "sparse":
        deltas.append(f"repr sparse -> {kind} engine")
    mdev = (manifest.get("mesh") or {}).get("devices")
    gdev = geo.get("devices")
    if mdev and gdev and int(mdev) != int(gdev):
        deltas.append(f"mesh devices {mdev} -> {gdev}")
    # Cell-dtype family: a float32 payload must not be bit-reinterpreted
    # into a binary engine. The manifest's dtype is the PAYLOAD dtype
    # (uint32 words for packed), so the comparison is float vs integer.
    mdtype = str(manifest.get("dtype", ""))
    gdtype = str(geo.get("dtype", ""))
    if mdtype and gdtype and \
            mdtype.startswith("float") != gdtype.startswith("float"):
        deltas.append(f"cell dtype {mdtype} -> {gdtype}")
    return deltas


# -- the repack itself -------------------------------------------------

def write_repacked(can: Canonical, out_path: str,
                   geometry: Optional[dict] = None) -> None:
    """Re-encode canonical state into the npz dialect the `load_checkpoint`
    of the engine of `geometry` accepts (the dense engine's when None), at
    `out_path`. A sparse engine takes the whole torus as its window, at
    origin (0, 0)."""
    meta = {"turn": np.int64(can.turn)}
    if can.rule is not None:
        meta["rulestring"] = np.str_(can.rule)
    if (geometry or {}).get("kind") == "sparse":
        from gol_tpu_torch.ops.bitpack import pack_np

        board = board01_of(can)
        size = int(geometry.get("size", 0))
        if board.shape != (size, size):
            raise GeometryMismatch(
                f"board {board.shape[0]}x{board.shape[1]} cannot "
                f"reshard onto a {size}-torus sparse engine (the torus "
                f"size is fixed at construction)")
        np.savez(out_path, sparse_words=pack_np(board),
                 ox=np.int64(0), oy=np.int64(0), size=np.int64(size),
                 **meta)
    elif can.kind == "gen":
        np.savez(out_path, gen_state=can.board, **meta)
    elif can.kind == "float":
        # The float board is placement-invariant state; the engine's own
        # load_checkpoint enforces that its rule family can hold it.
        np.savez(out_path, float_state=can.board, **meta)
    elif can.kind == "pixels":
        np.savez(out_path, world=can.board, **meta)
    else:
        # Life board01 -> legacy world pixels: the one dialect the dense
        # install path accepts at any width; the engine re-packs to
        # words itself when its representation choice says so.
        np.savez(out_path, world=(can.board * np.uint8(255)), **meta)


def reshard_into(engine, manifest: Optional[dict],
                 payload_path: str) -> int:
    """Decode `payload_path`, repack for `engine`, install through the
    engine's own verified `load_checkpoint`. Returns the restored turn
    (always the checkpoint's turn — resharding never advances time)."""
    can = load_canonical(payload_path)
    fd, tmp = tempfile.mkstemp(suffix=".npz", prefix="gol-reshard-")
    os.close(fd)
    try:
        write_repacked(can, tmp, engine.geometry())
        turn = engine.load_checkpoint(tmp)
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    geo = engine.geometry()
    obs_log("ckpt.resharded", kind=can.kind, turn=turn,
            devices=geo.get("devices"), engine=geo.get("kind"),
            payload=os.path.basename(payload_path))
    return turn
