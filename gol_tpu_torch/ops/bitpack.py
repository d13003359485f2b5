"""Bit-parallel life-like stencil on packed words — the counterpart of
`gol_tpu/ops/bitpack.py`, in plain torch.

Layout: a (H, W) board packs to (H, W/32) words, LSB-first — column
c = 32*w + j lives in bit j of word w of its row — bit for bit the
layout of `gol_tpu.ops.bitpack.pack`. The carrier dtype is `torch.int32`,
not uint32: CPU torch refuses `<<`, `>>` and `~` on uint32, and on int32
they are the same bit operations except that `>>` sign-extends, so every
right shift here is made logical with a mask. `words_from_numpy` /
`words_to_numpy` reinterpret to and from the JAX package's np.uint32
words without changing a bit.

The 8-neighbour count is a carry-save adder network over bit-planes and
the rule is applied bit-sliced on the 4-bit count (`_rule_from_count_bits`).
Every op takes optional leading batch axes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from gol_tpu_torch.models.lifelike import CONWAY, LifeLikeRule

WORD_BITS = 32
_LOW31 = 0x7FFFFFFF


def pack_np(cells: np.ndarray) -> np.ndarray:
    """uint8 (..., H, W) board, W a multiple of 32 → np.uint32 words
    (..., H, W/32), LSB-first. Any nonzero cell counts as alive, so {0,1}
    cells and {0,255} pixels pack alike. Packs bytes with `np.packbits`
    and views them as little-endian words: no (..., W/32, 32) temporary,
    which would cost ~16x the board."""
    w = cells.shape[-1]
    if w % WORD_BITS != 0:
        raise ValueError(f"width {w} not a multiple of {WORD_BITS}")
    bits = np.packbits(np.ascontiguousarray(cells) != 0, axis=-1,
                       bitorder="little")
    return bits.view("<u4").astype(np.uint32, copy=False)


def unpack_np(words: np.ndarray) -> np.ndarray:
    """np.uint32 words (..., H, Wp) → {0,1} uint8 cells (..., H, Wp*32)."""
    raw = np.ascontiguousarray(words, dtype="<u4").view(np.uint8)
    return np.unpackbits(raw, axis=-1, bitorder="little")


def words_from_numpy(words: np.ndarray, device="cpu") -> torch.Tensor:
    """np.uint32 packed words (the JAX package's layout) → the port's
    int32 carrier on `device`, bit for bit."""
    a = np.ascontiguousarray(words, dtype="<u4").view(np.int32)
    if not a.flags.writeable:  # torch wants a buffer it may write
        a = a.copy()
    return torch.from_numpy(a).to(device)


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """The port's int32 carrier → np.uint32 words on the host."""
    return words.detach().cpu().contiguous().numpy().view(np.uint32)


def pack(cells: torch.Tensor) -> torch.Tensor:
    """{0,1} uint8 (..., H, W) cells → int32 words (..., H, W/32) on the
    same device. Packing runs on the host (`pack_np`)."""
    return words_from_numpy(pack_np(cells.cpu().numpy()), cells.device)


def unpack(words: torch.Tensor) -> torch.Tensor:
    """int32 words (..., H, Wp) → {0,1} uint8 cells (..., H, Wp*32) on the
    same device. Works on the little-endian byte view, so the temporary
    is the size of the output."""
    raw = words.contiguous().view(torch.uint8)
    shifts = torch.arange(8, dtype=torch.uint8, device=words.device)
    bits = (raw.unsqueeze(-1) >> shifts) & 1
    return bits.reshape(*words.shape[:-1], words.shape[-1] * WORD_BITS)


def _shr(x: torch.Tensor, n: int) -> torch.Tensor:
    """Logical right shift of int32 words by 0 < n < 32."""
    return (x >> n) & (_LOW31 >> (n - 1))


def _shift_west(row: torch.Tensor) -> torch.Tensor:
    """Bitboard of each cell's west (col-1) neighbour, torus wrap."""
    return (row << 1) | _shr(torch.roll(row, 1, dims=-1), WORD_BITS - 1)


def _shift_east(row: torch.Tensor) -> torch.Tensor:
    """Bitboard of each cell's east (col+1) neighbour, torus wrap."""
    return _shr(row, 1) | (torch.roll(row, -1, dims=-1) << (WORD_BITS - 1))


def _full_add(x, y, z):
    """Bitwise full adder: per-bit x+y+z as (sum, carry)."""
    xy = x ^ y
    return xy ^ z, (x & y) | (z & xy)


def neighbour_count_bits(above, mid, below):
    """4-bit bit-sliced 8-neighbour counts (n0, n1, n2, n3) for the cells
    of `mid`, given the packed rows above and below (torus-resolved)."""
    s0a, s1a = _full_add(_shift_west(above), above, _shift_east(above))
    s0c, s1c = _full_add(_shift_west(below), below, _shift_east(below))
    w_mid, e_mid = _shift_west(mid), _shift_east(mid)
    s0b, s1b = w_mid ^ e_mid, w_mid & e_mid
    u0, u1 = _full_add(s0a, s0b, s0c)      # ones column (0..3)
    v0, v1 = _full_add(s1a, s1b, s1c)      # twos column (0..3)
    return combine_count_columns(u0, u1, v0, v1)


def combine_count_columns(u0, u1, v0, v1):
    """(ones-sum bits, twos-sum bits) → 4 bit-planes of
    n = u0 + 2*(u1 + v0) + 4*v1."""
    n1 = u1 ^ v0
    carry2 = u1 & v0
    n2 = v1 ^ carry2
    n3 = v1 & carry2
    return u0, n1, n2, n3


def _rule_from_count_bits(mid, n0, n1, n2, n3, rule: LifeLikeRule,
                          count_offset: int = 0):
    """Apply a life-like rule to bit-sliced neighbour counts.

    `count_offset=0`: (n0..n3) is the plain 8-neighbour count.
    `count_offset=1`: the count is self-inclusive (neighbours + the cell
    itself, 0..9) — Conway becomes `(n9==3) | (alive & n9==4)` and the
    survive LUT shifts by one."""
    if rule.is_conway:
        if count_offset == 0:
            return n1 & ~n2 & ~n3 & (n0 | mid)
        return ~n3 & ((~n2 & n1 & n0) | (mid & n2 & ~n1 & ~n0))
    born, survive = rule_masks(
        n0, n1, n2, n3, rule.born, rule.survive, count_offset)
    return (~mid & born) | (mid & survive)


def rule_masks(n0, n1, n2, n3, born_set, survive_set,
               count_offset: int = 0):
    """(born_mask, survive_mask) from bit-sliced neighbour counts: bit i
    of born_mask is set iff cell i's count is in born_set (likewise
    survive, shifted by `count_offset` for self-inclusive counts)."""
    bits = (n0, n1, n2, n3)

    def eq(k: int) -> torch.Tensor:
        m = torch.full_like(n0, -1)
        for i, b in enumerate(bits):
            m = m & (b if (k >> i) & 1 else ~b)
        return m

    zero = torch.zeros_like(n0)
    born = functools.reduce(
        lambda a, k: a | eq(k), sorted(born_set), zero)
    survive = functools.reduce(
        lambda a, k: a | eq(k + count_offset), sorted(survive_set), zero)
    return born, survive


def gen3_transition(a, d, born, surv):
    """The 3-state (alive, dying) plane transition given born/survive
    masks: a' = (~a & ~d & born) | (a & surv);  d' = a & ~surv."""
    return (~a & ~d & born) | (a & surv), a & ~surv


def gen4_transition(b0, b1, born, surv):
    """The 4-state binary-encoded transition (states 0=00, 1=01 alive,
    2=10, 3=11; the dying chain 2 -> 3 -> 0 is pure bit logic)."""
    a = b0 & ~b1
    dying1 = ~b0 & b1
    return ((~b0 & ~b1 & born) | (a & surv) | dying1,
            (a & ~surv) | dying1)


def packed_step(packed: torch.Tensor,
                rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """One whole-board torus turn on (..., H, Wp) packed words."""
    above = torch.roll(packed, 1, dims=-2)
    below = torch.roll(packed, -1, dims=-2)
    n0, n1, n2, n3 = neighbour_count_bits(above, packed, below)
    return _rule_from_count_bits(packed, n0, n1, n2, n3, rule)


def packed_run_turns(packed: torch.Tensor, num_turns: int,
                     rule: LifeLikeRule = CONWAY) -> torch.Tensor:
    """Advance `num_turns` turns, one `packed_step` per turn."""
    for _ in range(num_turns):
        packed = packed_step(packed, rule)
    return packed


_BYTE_POPCOUNT = [bin(i).count("1") for i in range(256)]


def row_popcounts_plain(words: torch.Tensor) -> torch.Tensor:
    """(..., H) int32 live cells per row of packed words. Torch has no
    popcount op: look each byte up in a 256-entry table."""
    lut = torch.tensor(_BYTE_POPCOUNT, dtype=torch.int32,
                       device=words.device)
    raw = words.contiguous().view(torch.uint8)
    return lut[raw.to(torch.int32)].sum(dim=-1, dtype=torch.int32)


def packed_alive_count(words: torch.Tensor) -> int:
    """Exact alive count of a packed board: per-row counts in int32,
    summed in int64 (a 65536² board has 2^32 cells)."""
    from gol_tpu_torch.ops.cuda_stencil import row_popcounts

    return int(row_popcounts(words).sum(dtype=torch.int64))
