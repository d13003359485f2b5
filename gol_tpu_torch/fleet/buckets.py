"""Size buckets: how thousands of runs share a handful of launches — the
counterpart of `gol_tpu/fleet/buckets.py`.

Runs are binned into a few PADDED SIZE CLASSES (default 512², 1024²,
2048²): each bucket owns ONE batched packed-word tensor of shape
(cap, hb, wb/32), `torch.int32` with `pack`'s exact bit layout, and one
launch of K9 (`ops/cuda_stencil.fleet_run_turns`) steps every slot and
popcounts each in a serving quantum — what the JAX package's jitted
`step_program` scan does.

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

Mesh placement (`choose_placement`, over a fleet's placement devices):
  * 'single' — the batch on one device, one K9 call a quantum; a
    one-device mesh collapses to it.
  * 'batch' — the slot axis split into equal contiguous blocks, one
    tensor a device (capacity floored at the device count, so admission
    into free capacity still changes no shape); a quantum is one K9 call
    a block, on its block's device and stream, and the per-slot counts
    are gathered in slot order. No halo: slots are independent tori.
  * 'spatial' — every slot's rows split over the mesh (big boards below
    batch occupancy). The JAX package steps a turn at a time with a
    1-row `ppermute` ring; here each macro-step trades T-row halos with
    the ring neighbours (`parallel/halo.exchange_halos`, the deep
    halo) and steps each shard's (cap, hb/n + 2T, wpb) window T turns by
    K9, its count boxed to the shard's own rows, then keeps the window's
    exact middle: bit-identical to the turn-at-a-time ring. A slot's
    count is the sum of its shards' (the reference's `lax.psum`).
A slot read (`slot_words`, `read_board`, `evict`) gathers the slot in
mesh order, so checkpoints and quarantine readbacks equal the
single-device fleet's.

Device work runs on each device's current stream, which every thread
shares: `stamp` writes a slot in place, a dispatch writes new tensors
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
from gol_tpu_torch.parallel import halo
from gol_tpu_torch.parallel.mesh import ROWS_AXIS, ShardedBoard

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


def step_slot_windows(windows: torch.Tensor, turns: int, rule, box):
    """One macro-step of a spatial bucket's shard: every slot's haloed
    (cap, R + 2T, wpb) window `turns` turns by K9, each slot's count
    taken over `box` (the shard's own rows). Returns (windows', alive)."""
    return fleet_run_turns(windows, turns, rule, box=box)


class Bucket:
    """One padded size class: a batched tensor (or one a mesh position)
    plus its slot map.

    Mutated only under the fleet engine's scheduling lock (placement,
    stamping, dispatch all happen there), so no lock lives here."""

    def __init__(self, hb: int, wb: int, rule,
                 slot_base: int = DEFAULT_SLOT_BASE,
                 device=None, placement: str = "single",
                 mesh=None) -> None:
        if wb % WORD_BITS:
            raise ValueError(f"bucket width {wb} not word-aligned")
        self.hb = int(hb)
        self.wb = int(wb)
        self.wpb = self.wb // WORD_BITS
        self.rule = rule
        if mesh is not None and mesh.size <= 1:
            device, mesh = mesh.devices.flat[0], None
        if mesh is None:
            placement = "single"
        elif placement not in ("batch", "spatial"):
            raise ValueError(f"unknown bucket placement {placement!r}")
        self.mesh = mesh
        self.placement = placement
        self.devices = mesh.size if mesh is not None else 1
        self.device = torch.device(
            mesh.devices.flat[0] if mesh is not None
            else "cpu" if device is None else device)
        if placement == "spatial" and self.hb % self.devices:
            raise ValueError(
                f"spatial bucket: {self.hb} rows not divisible by "
                f"{self.devices} devices")
        # Batch placement floors capacity at the device count and keeps
        # it a whole number of equal blocks.
        floor = max(1, slot_base,
                    self.devices if placement == "batch" else 1)
        cap = 1
        while cap < floor:
            cap *= 2
        if placement == "batch":
            cap = -(-cap // self.devices) * self.devices
        self.parts = self._zeros(cap)
        self.slots: List[Optional[RunHandle]] = [None] * cap
        self.free: List[int] = list(range(cap - 1, -1, -1))
        # Round-robin bookkeeping the fairness test reads.
        self.dispatches = 0
        self.turns_served = 0

    def _zeros(self, cap: int) -> List[torch.Tensor]:
        """Zero words for `cap` slots in this placement's layout: the
        whole batch, a block of cap / n slots a device, or every slot's
        band of hb / n rows a device."""
        if self.placement == "single":
            return [torch.zeros((cap, self.hb, self.wpb),
                                dtype=torch.int32, device=self.device)]
        n = self.devices
        shape = ((cap // n, self.hb, self.wpb) if self.placement == "batch"
                 else (cap, self.hb // n, self.wpb))
        return [torch.zeros(shape, dtype=torch.int32, device=d)
                for d in self.mesh.devices.flat]

    @property
    def words(self) -> torch.Tensor:
        """The whole (cap, hb, wpb) batch on the first device (the batch
        itself under 'single'; a gathered copy otherwise)."""
        if self.placement == "single":
            return self.parts[0]
        dim = 0 if self.placement == "batch" else 1
        return torch.cat([halo._to_device(p, self.device)
                          for p in self.parts], dim=dim)

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

    def slot_device(self, slot: int) -> int:
        """The mesh position holding `slot` (batch), else 0: where the
        per-device residency gauge counts it."""
        if self.placement != "batch":
            return 0
        return slot // (self.cap // self.devices)

    def _grow(self) -> None:
        """Double capacity, preserving resident slots. A batch bucket's
        blocks are recut (slot s moves to block s // (2 cap / n))."""
        new_cap = self.cap * 2
        if self.placement == "spatial":
            self.parts = [torch.cat([p, torch.zeros_like(p)], dim=0)
                          for p in self.parts]
        else:
            whole = self.words
            grown = torch.zeros((new_cap, self.hb, self.wpb),
                                dtype=torch.int32, device=self.device)
            grown[: self.cap].copy_(whole)
            if self.placement == "single":
                self.parts = [grown]
            else:
                per = new_cap // self.devices
                self.parts = [
                    halo._to_device(grown[i * per:(i + 1) * per], d)
                    for i, d in enumerate(self.mesh.devices.flat)]
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

    def _block(self, slot: int) -> Tuple[torch.Tensor, int]:
        """(tensor, index) holding a slot's words under 'single' and
        'batch'."""
        if self.placement == "single":
            return self.parts[0], slot
        per = self.cap // self.devices
        return self.parts[slot // per], slot % per

    def stamp(self, slot: int, board01: np.ndarray) -> None:
        """(Re)write a slot's device words from a host {0,1} board —
        placement, reseed, and pause-resume all land here."""
        tiled = tile_board(np.asarray(board01, dtype=np.uint8),
                           self.hb, self.wb)
        host = words_from_numpy(board_to_words(tiled))
        if self.placement == "spatial":
            rows = self.hb // self.devices
            for j, p in enumerate(self.parts):
                p[slot].copy_(host[j * rows:(j + 1) * rows])
            return
        block, i = self._block(slot)
        block[i].copy_(host)

    def slot_words(self, slot: int) -> torch.Tensor:
        """The slot's packed words (hb, wpb): a view of the batch (or of
        its block) that a dispatch never writes (it writes new tensors);
        a spatial slot's shards gathered in mesh order on the first
        device."""
        if self.placement == "spatial":
            return torch.cat([halo._to_device(p[slot], self.device)
                              for p in self.parts], dim=0)
        block, i = self._block(slot)
        return block[i]

    def slot_copy(self, slot: int) -> torch.Tensor:
        """A device copy of the slot's words (hb, wpb), enqueued now: call
        under the fleet lock, materialize outside it."""
        words = self.slot_words(slot)
        return words if self.placement == "spatial" else words.clone()

    def run_slot(self, slot: int, turns: int) -> torch.Tensor:
        """The slot's full bucket torus advanced `turns` turns outside the
        batch (the exact-target trim): K1 or K2 on one device, the
        sharded deep-halo path (`parallel/halo.py`) on a spatial bucket.
        Returns its (hb, wpb) words; the batch is not written."""
        if self.placement != "spatial":
            return halo.packed_run_turns(self.slot_words(slot), turns,
                                         self.rule)
        board = ShardedBoard([p[slot] for p in self.parts], self.mesh)
        return halo.mesh_run_fn("packed")(board, turns, self.rule).gather()

    def read_board(self, slot: int, h: int, w: int) -> np.ndarray:
        """Host {0,1} board of a slot: device readback of the slot's
        words, cropped to the run's own (h, w) window of the tiling."""
        return words_to_board(words_to_numpy(self.slot_words(slot)), h, w)

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
        self.parts = self._zeros(self.cap)
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
        """One serving quantum: advance every slot `turns × fuse` turns.
        Returns the per-slot popcount tensor on the first device — the
        caller decides when to sync (that sync is the fleet's device-wait
        measurement point)."""
        total = turns * max(1, fuse)
        devstats.note_signature(self.signature_key(turns, max(1, fuse)))
        if self.placement == "single":
            self.parts[0], alive = fleet_run_turns(self.parts[0], total,
                                                   self.rule)
        elif self.placement == "batch":
            stepped = [fleet_run_turns(p, total, self.rule)
                       for p in self.parts]
            self.parts = [out for out, _ in stepped]
            alive = torch.cat([halo._to_device(a, self.device)
                               for _, a in stepped])
        else:
            alive = self._spatial(total)
        self.dispatches += 1
        self.turns_served += total
        return alive

    def _spatial(self, total: int) -> torch.Tensor:
        """`total` turns of every slot's row shards: macro-steps of depth
        T (`halo._deep_halo_T`: the largest power of two up to 16 that
        divides `total` and fits a shard), each a T-row halo exchange and
        one K9 call a shard on its (cap, R + 2T, wpb) window, the count
        boxed to the shard's rows R; the last macro-step's counts, summed
        over the shards, are the slots'."""
        rows = self.hb // self.devices
        T = halo._deep_halo_T(total, rows)
        box = (T, T + rows, 0, self.wpb)
        parts = self.parts
        counts: list = []
        for _ in range(total // T):
            lows, highs = halo.exchange_halos(parts, self.mesh, ROWS_AXIS,
                                              T)
            stepped = [step_slot_windows(
                torch.cat([lo, p, hi], dim=-2), T, self.rule, box)
                for lo, p, hi in zip(lows, parts, highs)]
            parts = [w[:, T:T + rows] for w, _ in stepped]
            counts = [a for _, a in stepped]
        self.parts = [p.contiguous() for p in parts]
        alive = counts[0]
        for a in counts[1:]:
            alive = alive + halo._to_device(a, self.device)
        return alive
