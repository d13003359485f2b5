"""Size buckets: how thousands of runs share a handful of launches — the
counterpart of `gol_tpu/fleet/buckets.py` on one CUDA device.

Runs are binned into a few PADDED SIZE CLASSES (default 512², 1024²,
2048²): each bucket owns ONE batched packed-word tensor of shape
(cap, hb, wb/32), `torch.int32` with `pack`'s exact bit layout, on the
fleet's device, and one launch of K9 (`ops/cuda_stencil.fleet_run_turns`)
steps every slot and popcounts each in a serving quantum — what the JAX
package's jitted `step_program` scan does.

Placement is the PERIODIC-TILING trick (`handles.fits_bucket`): a board
whose sides divide the bucket's is stamped as `np.tile` copies filling
the slot. GoL commutes with translations and a periodic state stays
periodic, so the bucket-torus evolution restricted to any board-sized
window is bit-identical to the board's own torus evolution. Per-run
alive = slot popcount / tiles, exact.

Boards that divide no configured class (the reference's 24×24 test
board from a legacy client) get a PRIVATE bucket shaped
(h, lcm(w, 32)); fleet-created runs are instead rejected with reason
"shape".

Slot capacity is allocated in powers of two (`slot_base`, growing ×2),
so admitting a run into existing free capacity keeps the batch shape:
zero new step signatures (`obs.devstats`, the JAX package's witness,
with its key). The port compiles nothing per shape; the key is kept so
the witness reads the same in both packages.

Only `placement == "single"` is ported: mesh placement (the batch and
spatial placements of `choose_placement`) waits for ROADMAP A5, and a
`Bucket` refuses it.

Device work runs on the device's current stream, which every thread
shares: `stamp` writes a slot in place, a dispatch writes a new tensor
(K9 never writes its input), and readers enqueue their slot's copy under
the fleet lock, so the stream orders each read after the writes before
it.
"""

from __future__ import annotations

import math
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from gol_tpu_torch.fleet.handles import RunHandle, fits_bucket, tile_board
from gol_tpu_torch.obs import devstats
from gol_tpu_torch.ops.bitpack import (
    WORD_BITS,
    pack_np,
    unpack_np,
    words_from_numpy,
    words_to_numpy,
)
from gol_tpu_torch.ops.cuda_stencil import fleet_run_turns

# Bucket side lengths (square, word-aligned). Overridable per engine
# (GOL_FLEET_BUCKETS / constructor).
DEFAULT_BUCKET_SIZES = (512, 1024, 2048)

# Initial slot capacity per bucket; rounded up to a power of two.
DEFAULT_SLOT_BASE = 8

# Batch-axis placement needs at least this many EXPECTED slots per device
# (slot_base / devices) to be worth splitting the slot axis.
# Overridable for policy tests via GOL_FLEET_MIN_SLOTS_PER_DEV.
DEFAULT_MIN_SLOTS_PER_DEVICE = 1


def min_slots_per_device() -> float:
    raw = os.environ.get("GOL_FLEET_MIN_SLOTS_PER_DEV")
    if raw:
        try:
            return float(raw)
        except ValueError:
            pass
    return DEFAULT_MIN_SLOTS_PER_DEVICE


def choose_placement(hb: int, wb: int, slot_base: int,
                     devices: int) -> str:
    """Per-bucket-class placement policy: 'single' | 'batch' | 'spatial'
    (the JAX package's; on one device always 'single')."""
    if devices <= 1:
        return "single"
    if slot_base / devices >= min_slots_per_device():
        return "batch"
    if hb % devices == 0:
        return "spatial"
    return "batch"


def cell_dtype(rule) -> str:
    """Logical cell dtype of a rule family — the bucket key's fourth
    element: "float32" for Lenia, which may never land in a packed
    bucket, "bit" for the binary families."""
    from gol_tpu_torch.models.lenia import LeniaRule

    return "float32" if isinstance(rule, LeniaRule) else "bit"


def choose_bucket_size(h: int, w: int,
                       sizes: Sequence[int]) -> Optional[int]:
    """Smallest configured bucket class the (h, w) board tiles exactly,
    or None — fleet admission rejects with reason "shape"."""
    for size in sorted(sizes):
        if fits_bucket(h, w, size, size):
            return size
    return None


def private_shape(h: int, w: int) -> Tuple[int, int]:
    """The minimal word-aligned bucket an arbitrary board tiles: its
    own height, width padded to lcm(w, 32)."""
    return h, math.lcm(w, WORD_BITS)


def board_to_words(board01: np.ndarray) -> np.ndarray:
    """{0,1} (h, w) board -> host packed words (h, ceil(w/32)) '<u4'."""
    return pack_np(board01).view("<u4")


def words_to_board(words: np.ndarray, h: int, w: int) -> np.ndarray:
    """Inverse of board_to_words (host-side)."""
    return np.ascontiguousarray(
        unpack_np(np.asarray(words))[..., :h, :w])


def bucket_from_jax(words_u32: np.ndarray) -> torch.Tensor:
    """The JAX fleet's (cap, hb, wpb) uint32 batch as the port's int32
    tensor on the CPU: a view of the same bits."""
    return words_from_numpy(words_u32)


def bucket_to_jax(words: torch.Tensor) -> np.ndarray:
    """The port's int32 batch as the JAX fleet's uint32 array."""
    return words_to_numpy(words)


class Bucket:
    """One padded size class: a batched device tensor plus its slot map.

    Mutated only under the fleet engine's scheduling lock (placement,
    stamping, dispatch all happen there), so no lock lives here."""

    def __init__(self, hb: int, wb: int, rule,
                 slot_base: int = DEFAULT_SLOT_BASE,
                 device=None, placement: str = "single") -> None:
        if wb % WORD_BITS:
            raise ValueError(f"bucket width {wb} not word-aligned")
        if placement != "single":
            raise NotImplementedError(
                f"{placement!r} bucket placement needs a device mesh, "
                "which waits for ROADMAP A5")
        self.hb = int(hb)
        self.wb = int(wb)
        self.wpb = self.wb // WORD_BITS
        self.rule = rule
        self.placement = placement
        self.devices = 1
        self.device = torch.device("cpu" if device is None else device)
        cap = 1
        while cap < max(1, slot_base):
            cap *= 2
        self.words = torch.zeros((cap, self.hb, self.wpb),
                                 dtype=torch.int32, device=self.device)
        self.slots: List[Optional[RunHandle]] = [None] * cap
        self.free: List[int] = list(range(cap - 1, -1, -1))
        # Round-robin bookkeeping the fairness test reads.
        self.dispatches = 0
        self.turns_served = 0

    # ------------------------------------------------------------ slots

    @property
    def cap(self) -> int:
        return len(self.slots)

    @property
    def occupied(self) -> int:
        return self.cap - len(self.free)

    def handles(self) -> List[RunHandle]:
        return [h for h in self.slots if h is not None]

    def active_count(self) -> int:
        return sum(1 for h in self.slots if h is not None and h.active)

    def _grow(self) -> None:
        """Double capacity, preserving resident slots."""
        new_cap = self.cap * 2
        grown = torch.zeros((new_cap, self.hb, self.wpb),
                            dtype=torch.int32, device=self.device)
        grown[: self.cap].copy_(self.words)
        self.words = grown
        self.free.extend(range(new_cap - 1, self.cap - 1, -1))
        self.slots.extend([None] * self.cap)

    def place(self, handle: RunHandle, board01: np.ndarray) -> int:
        """Stamp a board into a free slot (tiled to fill it); returns
        the slot index. Grows capacity ×2 when full."""
        if not self.free:
            self._grow()
        slot = self.free.pop()
        self.slots[slot] = handle
        self.stamp(slot, board01)
        return slot

    def stamp(self, slot: int, board01: np.ndarray) -> None:
        """(Re)write a slot's device words from a host {0,1} board —
        placement, reseed, and pause-resume all land here."""
        tiled = tile_board(np.asarray(board01, dtype=np.uint8),
                           self.hb, self.wb)
        host = words_from_numpy(board_to_words(tiled))
        self.words[slot].copy_(host)

    def slot_copy(self, slot: int) -> torch.Tensor:
        """A device copy of the slot's words (hb, wpb), enqueued now: call
        under the fleet lock, materialize outside it."""
        return self.words[slot].clone()

    def read_board(self, slot: int, h: int, w: int) -> np.ndarray:
        """Host {0,1} board of a slot: device readback of the slot's
        words, cropped to the run's own (h, w) window of the tiling."""
        return words_to_board(words_to_numpy(self.words[slot]), h, w)

    def slot_words(self, slot: int) -> torch.Tensor:
        """The slot's packed device words (hb, wpb): a view of the batch
        a dispatch never writes (it writes a new tensor)."""
        return self.words[slot]

    def evict(self, slot: int, h: int, w: int) -> np.ndarray:
        """Free a slot, returning its final cropped board. The words stay
        in the batch (stepping garbage is harmless and keeps the batch
        shape); the slot just becomes placeable."""
        board = self.read_board(slot, h, w)
        self.slots[slot] = None
        self.free.append(slot)
        return board

    def release(self, slot: int) -> None:
        """Free a slot WITHOUT reading its board back — the quarantine
        eviction: a faulted slot's contents are untrusted."""
        self.slots[slot] = None
        if slot not in self.free:
            self.free.append(slot)

    def rebuild(self) -> None:
        """Recreate the batch from scratch and restamp every still-placed
        handle from its host `frozen` board (the step-exception recovery
        path; faulted actives were released before this call)."""
        self.words = torch.zeros((self.cap, self.hb, self.wpb),
                                 dtype=torch.int32, device=self.device)
        for slot, h in enumerate(self.slots):
            if h is not None and h.frozen is not None:
                self.stamp(slot, h.frozen)

    # --------------------------------------------------------- dispatch

    def signature_key(self, turns: int, fuse: int = 1) -> tuple:
        # The JAX package's key: the batch shape, the quantum, the rule,
        # the placement and the fuse depth. Admission into free capacity
        # changes none of them.
        return ("fleet", self.cap, self.hb, self.wpb, turns,
                self.rule.rulestring, self.placement, self.devices, fuse)

    def dispatch(self, turns: int, fuse: int = 1) -> torch.Tensor:
        """One serving quantum: advance every slot `turns × fuse` turns
        in one K9 call. Returns the per-slot popcount DEVICE tensor — the
        caller decides when to sync (that sync is the fleet's device-wait
        measurement point)."""
        total = turns * max(1, fuse)
        devstats.note_signature(self.signature_key(turns, max(1, fuse)))
        self.words, alive = fleet_run_turns(self.words, total, self.rule)
        self.dispatches += 1
        self.turns_served += total
        return alive
