// Hopper (sm_90a) kernels for bit-packed life-like and two-plane
// Generations stepping.
//
// Boards are (h, wp) arrays of 32-bit words, 32 cells per word, LSB-first
// (column c = 32*w + j is bit j of word w of its row), on a torus. The
// rule arrives as two 9-bit masks (bit i of `born` set: a dead cell with i
// live neighbours is born; bit i of `survive`: a live one survives), so
// one build serves every life-like rule.
//
// Shared arithmetic (the self-inclusive count of
// gol_tpu/ops/pallas_stencil.py:_self_inclusive_count_bits): per row the
// horizontal sum hs = west + self + east is kept as two bit-planes
// (hs0, hs1); the vertical full adder over rows r-1, r, r+1 of hs gives
// the four bit-planes n0..n3 of n9 = live neighbours + self (0..9). The
// rule reads n9 directly for a dead cell and n9 - 1 for a live one.
// Per word and turn that is 11 shift/logic ops for the count and 19 for
// the rule (a mux tree over n0..n3 whose leaves are the rule's bits), 30
// in all — the figure `OPS_PER_WORD_TURN` in ops/cuda_stencil.py holds.
// Each thread slides down a column of rows and keeps the hs planes of
// the two rows above in registers, so a word costs three shared-memory
// loads and one store per turn and plane. Every stepping kernel (K1, K2,
// K4, K5, K6) shares `step_rows<Family>`, whose inner loop is kept near
// those counted ops: row addresses advance as pointers, a thread's column
// and neighbours are fixed before the turn loop, no load is guarded,
// buffers swap as pointers (no array indexed by turn parity, so no stack
// frame), and two rows go per iteration. The family says how a row is
// loaded and its next words stored: `Life` (one plane) for K1, K2 and K6,
// `Gen3` and `Gen4` (two planes) for K4 and K5.
//
// Kernels and the TPU kernels they replace:
//   resident_kernel<Life>    K1 <- pallas_packed_run_turns
//                                  (pallas_stencil.py:508)
//   tiled_kernel<Life, 1>    K2 <- _banded_pass (pallas_stencil.py:388)
//   tiled_kernel<Life, 2>    K6 <- fused_banded_run_turns
//                                  (pallas_stencil.py:474), whose k-deep
//                                  _banded_pass sweeps reach k = 64: the
//                                  tiled sweep with a two-word halo
//   row_popcounts_kernel     K3 <- the alive token's popcount reduction,
//                                  which the JAX package leaves to XLA
//                                  (engine.py:158-160); the engine's
//                                  chunks now count in their last
//                                  stepping launch (below), and K3 serves
//                                  the counts of boards not just stepped
//                                  (a restore)
//   resident_kernel<Gen3|4>  K4 <- pallas_packed_run_turns3
//                                  (pallas_stencil.py:274) and
//                                  pallas_packed_run_turns4 (:296)
//   tiled_kernel<Gen3|4, 1>  K5 <- the same two, for boards beyond K4's
//                                  shared memory (the TPU ran them from
//                                  VMEM)
//   window_occupancy_kernel  K8 <- the sparse window's occupancy, the row
//                                  and word-column popcounts that the JAX
//                                  package leaves to XLA
//                                  (gol_tpu/models/sparse.py:106-112)
//   resident_kernel<Life,    K9 route 1 <- the fleet's batched step
//     kCluster, true>                (gol_tpu/fleet/buckets.py:149-170,
//                                    `step_program`: a jnp scan over
//                                    (cap, hb, wpb) slots plus a per-slot
//                                    popcount, XLA, not Pallas): K1 with a
//                                    slot axis in the grid, a cluster of
//                                    up to 16 CTAs a slot, for every slot
//                                    a cluster holds (the 512², 1024² and
//                                    2048² classes): each slot read and
//                                    written once a quantum, its edge rows
//                                    through DSMEM, no column computed
//                                    twice
//   tiled_kernel<Life, 1,    K9 route 2: K2 with a slot axis in the grid,
//     R, true>                       for slots beyond a cluster
//
// The alive count rides the stepping launch: with a counter given, K1,
// K2, K4 (Gen3), K5 (Gen3) and K6 add the live cells of the words they
// store (plane 0, the alive plane of Gen3) to one 64-bit counter, and K9
// to one int32 a slot: a 32-bit sum in each block's shared memory, then
// one atomicAdd a block (`add_block_count`). The engine counts only a
// chunk's last launch, so its alive token costs no launch of its own:
// K3's own launch is floored at a launch's ~1-2 µs on the card and ~20 µs
// of host (ctypes, the stream, its output), against a bound of
// nanoseconds at 512². The resident kernels zero their counter in the
// kernel, before their first barrier; the tiled ones, whose blocks share
// no barrier, have it zeroed on the stream first. Each launch's driver
// set-up (shared-memory attributes, the cluster placement check) runs
// once per kernel and geometry and is kept (`prepare_launch`).
//   ltl_resident_kernel      K7 <- Larger-than-Life turns of a Moore-box
//   ltl_tile_kernel                rule on a uint8 torus: the box path of
//                                  `_conv_sum` and `_ltl_step`, which the
//                                  JAX package leaves to XLA
//                                  (gol_tpu/ops/conv.py:218, :363); route
//                                  1 holds a board that fits a cluster for
//                                  a whole chunk, route 2 tiles the rest
// The two-plane kernels spend per word and turn the 11-op count network,
// two 9-mux trees (born and survive) and the transition (3 ops for Gen3;
// 3 for Gen4 plus one b0 & ~b1 for each of the 3 words a row load reads)
// — `OPS_PER_WORD_TURN_2P` in ops/cuda_stencil.py.
//
// C interface: every entry point sets the device, launches on the given
// stream, does not synchronise and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>
#include <vector>

namespace {

namespace cg = cooperative_groups;

// Shared memory one block can use, and one SM holds (with 1 KiB that the
// runtime keeps per resident block).
constexpr int kBlockSmemBytes = 232448;
constexpr int kSmSmemBytes = 233472;
constexpr int kBlockReservedSmem = 1024;

// Tiled sweep geometry; ops/cuda_stencil.py mirrors these constants.
// A sweep of depth t needs t cells of horizontal halo, so the halo width
// in words sets the deepest sweep: 32 for one word (K2, K5), 64 for two
// (K6).
constexpr int kWinWords = 64;      // window words per row and plane
constexpr int kTileSegments = 8;   // threads down each window column
constexpr int kTileMaxT = 32;      // K2, K5: one halo word a side
// K2 R, output rows per block: one instantiation each; tile_rows() in
// ops/cuda_stencil.py picks one per board so that the grid fills the
// card. At T = 32 the buffers of a 128-row tile leave room for two
// blocks on an SM.
constexpr int kTileRowChoices[] = {384, 128};
constexpr int kTileWords = kWinWords - 2;  // K2, K5 C: output words a block
// K6: two buffers of (R + 2 x 64) x 64 words must fit 232,448 bytes, so
// R <= 326; R = 320 uses 229,376.
constexpr int kDeepMaxT = 64;
constexpr int kDeepRows = 320;
constexpr int kDeepWords = kWinWords - 4;
// K5 R (two planes, two buffers: 4 x (R + 2T) x 64 words must fit 232,448
// bytes, so R + 2T <= 227): one instantiation each; tile2p_rows() in
// ops/cuda_stencil.py picks one per board. 161 cuts 16384 rows into 102
// tiles, 918 blocks in 7 waves of 132 (160 would need 927, 8 waves); 96
// cuts 4096 rows into 43, 129 blocks in one wave (160: 78 blocks).
constexpr int kTile2pRowChoices[] = {161, 96};
static_assert(4 * 4 * (kTile2pRowChoices[0] + 2 * kTileMaxT) * kWinWords <=
                  kBlockSmemBytes,
              "K5's tallest tile must fit one block's shared memory");
// K1: threads a CTA. K4's two planes need more than the 64 registers a
// thread that 1024 threads leave (ptxas spilled 8-16 bytes on one CTA),
// so its CTAs take at most 512 threads (128 registers). The kernel's
// launch bounds also name one block an SM: with the thread count alone,
// ptxas still fitted K4's one-CTA gen3 variant into 64 registers and
// spilled 16 bytes.
constexpr int kResidentThreads = 1024;
constexpr int kResident2pThreads = 512;
// K1, K4: the largest cluster H100 places (a non-portable size above 8).
constexpr int kResidentMaxCtas = 16;
constexpr int kPortableClusterCtas = 8;
constexpr int kPopcountThreads = 256;

__device__ __forceinline__ uint32_t mux(uint32_t s, uint32_t a,
                                        uint32_t b) {
  return (s & a) | (~s & b);  // per bit: s ? a : b
}

// The rule as 20 leaf words: b[k] (s[k]) is all ones iff a dead (live)
// cell whose self-inclusive count is k is alive next turn.
struct RuleLeaves {
  uint32_t b[10];
  uint32_t s[10];
};

__device__ __forceinline__ RuleLeaves make_leaves(uint32_t born,
                                                  uint32_t survive) {
  RuleLeaves r;
#pragma unroll
  for (int k = 0; k < 10; ++k) {
    r.b[k] = (k <= 8 && ((born >> k) & 1u)) ? 0xFFFFFFFFu : 0u;
    r.s[k] = (k >= 1 && ((survive >> (k - 1)) & 1u)) ? 0xFFFFFFFFu : 0u;
  }
  return r;
}

// Per bit: v[n9] for the count n9 (0..9) held in the bit-planes n0..n3.
__device__ __forceinline__ uint32_t lut_tree(const uint32_t v[10],
                                             uint32_t n0, uint32_t n1,
                                             uint32_t n2, uint32_t n3) {
  const uint32_t m01 = mux(n0, v[1], v[0]);
  const uint32_t m23 = mux(n0, v[3], v[2]);
  const uint32_t m45 = mux(n0, v[5], v[4]);
  const uint32_t m67 = mux(n0, v[7], v[6]);
  const uint32_t m89 = mux(n0, v[9], v[8]);
  const uint32_t m03 = mux(n1, m23, m01);
  const uint32_t m47 = mux(n1, m67, m45);
  const uint32_t m07 = mux(n2, m47, m03);
  // n3 set means n9 is 8 or 9, where n1 = n2 = 0.
  return mux(n3, m89, m07);
}

// Next state of the 32 cells of `mid` from its self-inclusive count bits.
__device__ __forceinline__ uint32_t apply_rule(const RuleLeaves& r,
                                               uint32_t mid, uint32_t n0,
                                               uint32_t n1, uint32_t n2,
                                               uint32_t n3) {
  uint32_t v[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) v[k] = mux(mid, r.s[k], r.b[k]);
  return lut_tree(v, n0, n1, n2, n3);
}

// Horizontal sum west + self + east of one word, as bit-planes (s0, s1).
__device__ __forceinline__ void hsum(uint32_t w, uint32_t p, uint32_t e,
                                     uint32_t& s0, uint32_t& s1) {
  const uint32_t west = __funnelshift_l(w, p, 1);  // (p << 1) | (w >> 31)
  const uint32_t east = __funnelshift_r(p, e, 1);  // (p >> 1) | (e << 31)
  s0 = west ^ p ^ east;
  s1 = (west & p) | (east & (west ^ p));
}

// The self-inclusive count bits n0..n3 of the middle row from the
// horizontal-sum planes (s0, s1) of the rows above, at and below.
template <typename Row>
__device__ __forceinline__ void count_bits(const Row& u, const Row& m,
                                           const Row& d, uint32_t& n0,
                                           uint32_t& n1, uint32_t& n2,
                                           uint32_t& n3) {
  n0 = u.s0 ^ m.s0 ^ d.s0;
  const uint32_t u1 = (u.s0 & m.s0) | (d.s0 & (u.s0 ^ m.s0));
  const uint32_t v0 = u.s1 ^ m.s1 ^ d.s1;
  const uint32_t v1 = (u.s1 & m.s1) | (d.s1 & (u.s1 ^ m.s1));
  n1 = u1 ^ v0;
  const uint32_t c2 = u1 & v0;
  n2 = v1 ^ c2;
  n3 = v1 & c2;
}

// ------------------------------------------------------------ families
//
// A family loads a row (`load`: the row's words at `line`, its plane-1
// words `plane` words further on, its word at `col` and the neighbours at
// `west` and `east`) and stores the middle row's next words from three
// loaded rows (`store`). `kPlanes` is its number of planes and
// `kResidentThreads` the most threads its resident CTAs take.

// Life-like: one plane. A row is its own word and the horizontal-sum
// planes of its three words.
struct Life {
  static constexpr int kPlanes = 1;
  static constexpr int kResidentThreads = ::kResidentThreads;
  struct Row {
    uint32_t p, s0, s1;
  };
  __device__ static __forceinline__ Row load(const uint32_t* line, int,
                                             int col, int west, int east) {
    Row r;
    r.p = line[col];
    hsum(line[west], r.p, line[east], r.s0, r.s1);
    return r;
  }
  __device__ static __forceinline__ void store(uint32_t* line, int, int col,
                                               const RuleLeaves& rule,
                                               const Row& u, const Row& m,
                                               const Row& d) {
    uint32_t n0, n1, n2, n3;
    count_bits(u, m, d, n0, n1, n2, n3);
    line[col] = apply_rule(rule, m.p, n0, n1, n2, n3);
  }
};

// Generations on two planes. The count is the self-inclusive count of
// the ALIVE cells: a row is its two own words and the horizontal-sum
// planes of its three alive words (`Family::neighbour` and
// `Family::alive`, once per loaded word). The rule's two masks give two
// bit-planes per word, born = lut_tree(b) (a dead cell has n9 = n8) and
// survive = lut_tree(s) (an alive cell has n9 = n8 + 1, which the survive
// leaves already shift), and the family's transition combines them with
// the cell's own planes.
template <typename Family>
struct TwoPlanes {
  static constexpr int kPlanes = 2;
  static constexpr int kResidentThreads = kResident2pThreads;
  struct Row {
    uint32_t p0, p1, s0, s1;
  };
  __device__ static __forceinline__ Row load(const uint32_t* line, int plane,
                                             int col, int west, int east) {
    Row r;
    r.p0 = line[col];
    r.p1 = line[plane + col];
    hsum(Family::neighbour(line, plane, west), Family::alive(r.p0, r.p1),
         Family::neighbour(line, plane, east), r.s0, r.s1);
    return r;
  }
  __device__ static __forceinline__ void store(uint32_t* line, int plane,
                                               int col,
                                               const RuleLeaves& rule,
                                               const Row& u, const Row& m,
                                               const Row& d) {
    uint32_t n0, n1, n2, n3;
    count_bits(u, m, d, n0, n1, n2, n3);
    uint32_t o0, o1;
    Family::next(m.p0, m.p1, lut_tree(rule.b, n0, n1, n2, n3),
                 lut_tree(rule.s, n0, n1, n2, n3), o0, o1);
    line[col] = o0;
    line[plane + col] = o1;
  }
};

// C = 3: plane 0 alive, plane 1 dying (gen3_transition, ops/bitpack.py);
// a neighbour's alive word is its plane-0 word.
struct Gen3 : TwoPlanes<Gen3> {
  __device__ static __forceinline__ uint32_t alive(uint32_t p0, uint32_t) {
    return p0;
  }
  __device__ static __forceinline__ uint32_t neighbour(const uint32_t* line,
                                                       int, int c) {
    return line[c];
  }
  __device__ static __forceinline__ void next(uint32_t a, uint32_t d,
                                              uint32_t born, uint32_t surv,
                                              uint32_t& o0, uint32_t& o1) {
    o0 = (~a & ~d & born) | (a & surv);
    o1 = a & ~surv;
  }
};

// C = 4: the state in binary, b0 = bit 0, b1 = bit 1; alive = b0 & ~b1,
// dying chain 2 -> 3 -> 0 (gen4_transition, ops/bitpack.py).
struct Gen4 : TwoPlanes<Gen4> {
  __device__ static __forceinline__ uint32_t alive(uint32_t b0,
                                                   uint32_t b1) {
    return b0 & ~b1;
  }
  __device__ static __forceinline__ uint32_t neighbour(const uint32_t* line,
                                                       int plane, int c) {
    return alive(line[c], line[plane + c]);
  }
  __device__ static __forceinline__ void next(uint32_t b0, uint32_t b1,
                                              uint32_t born, uint32_t surv,
                                              uint32_t& o0, uint32_t& o1) {
    const uint32_t a = b0 & ~b1;
    const uint32_t dying1 = ~b0 & b1;
    o0 = (~b0 & ~b1 & born) | (a & surv) | dying1;
    o1 = (a & ~surv) | dying1;
  }
};

// One turn for n >= 1 consecutive rows of one word column: the rows at
// first, first + stride, ... (written to dst, dst + stride, ...), with
// the row above the first at `above` and the row below the last at
// `below` (another CTA's shared memory in a cluster). `col`, `west` and
// `east` are the offsets in a row of the word and its neighbours, and
// `plane` the offset of a row's plane-1 words (two-plane families). Each
// row is loaded once; two rows go per iteration.
template <typename F>
__device__ __forceinline__ void step_rows(
    const uint32_t* above, const uint32_t* first, const uint32_t* below,
    uint32_t* dst, int n, int stride, int plane, int col, int west,
    int east, const RuleLeaves& rule) {
  using Row = typename F::Row;
  Row u = F::load(above, plane, col, west, east);
  Row m = F::load(first, plane, col, west, east);
  const uint32_t* next = first + stride;
  int i = 0;
  for (; i + 2 < n; i += 2) {  // rows i, i + 1 read rows up to i + 2 < n
    const Row d = F::load(next, plane, col, west, east);
    const Row d2 = F::load(next + stride, plane, col, west, east);
    F::store(dst, plane, col, rule, u, m, d);
    F::store(dst + stride, plane, col, rule, m, d, d2);
    u = d;
    m = d2;
    next += 2 * stride;
    dst += 2 * stride;
  }
  if (i + 1 < n) {
    const Row d = F::load(next, plane, col, west, east);
    F::store(dst, plane, col, rule, u, m, d);
    u = m;
    m = d;
    dst += stride;
  }
  F::store(dst, plane, col, rule, u, m,
           F::load(below, plane, col, west, east));
}

// Cluster barrier halves (PTX defaults: the arrive releases, the wait
// acquires, at cluster scope).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// First board row of CTA `rank`'s slab: slabs of floor(h/N) or
// ceil(h/N) rows (ops/cuda_stencil.py:_slab_starts mirrors it).
__host__ __device__ __forceinline__ int slab_start(int rank, int h,
                                                   int ctas) {
  return (int)((long long)rank * h / ctas);
}

// The counter a counted launch adds the live cells it stores into: K9's
// one int32 a slot (`step_program` counts in int32; a 2048² slot holds
// 2^22 cells), else one 64-bit count for the board (a 65536² board holds
// 2^32 cells, 131072² 2^34).
template <bool kBatched>
using Count = std::conditional_t<kBatched, int, unsigned long long>;

// A counted launch's epilogue: `pop` is this thread's __popc sum over the
// words it stored. The block sums them in a 32-bit count at `scratch`
// (shared memory that no thread reads any more, zeroed by `leader` before
// a barrier that precedes the stores; a block stores under 2^20 cells)
// and `leader` adds the block's sum to *counter with one atomic: integer
// atomics, exact in any order.
template <typename C>
__device__ __forceinline__ void add_block_count(int* scratch, int pop,
                                                C* counter, bool leader) {
  if (pop) atomicAdd(scratch, pop);
  __syncthreads();
  if (leader && *scratch) atomicAdd(counter, (C)*scratch);
}

// The words a counted launch counts: rows [r0, r1) x word columns [c0,
// c1) of its result. A sharded board's window (`parallel/halo.py`) and
// each slot of a spatial fleet bucket's window (`fleet/buckets.py`, K9)
// count their shard's own rows and words, not the halo around them; a
// whole board or a fleet slot counts everything (`full_box`).
struct CountBox {
  int r0, r1, c0, c1;
};

inline CountBox full_box(int h, int wp) { return CountBox{0, h, 0, wp}; }

// K1 (F = Life) and K4 (F = Gen3, Gen4): the board's planes in the shared
// memory of one cluster of N CTAs (kCluster), or of one CTA, for `turns`
// turns.
//
// K1 replaces pallas_packed_run_turns (pallas_stencil.py:508), K4
// pallas_packed_run_turns3 (:274) and pallas_packed_run_turns4 (:296),
// which keep the board in VMEM for K turns. Bound: the logic ops per word
// and turn (30 for K1, 32 or 35 for K4); one CTA would reach at most 1/132
// of the card's rate, so the board is spread over a cluster of up to 16
// SMs (1/8 of the card). A cluster turn has a floor of about 1 µs (the
// split barrier and the DSMEM reads), so small boards run on one CTA.
//
// CTA i owns rows [a_i, a_{i+1}) in two buffers (ping-pong) of ceil(h/N)
// rows per plane; a buffer holds plane 0's slab, then plane 1's, so the
// rows a warp walks keep K1's bank pattern. The rows above and below its
// slab are the last row of CTA i - 1's slab and the first row of CTA
// i + 1's (ranks modulo N: the torus), read in place, in every plane,
// from their shared memory through DSMEM. A turn is:
//   1. the slab's first and last rows, the only rows that read a
//      neighbour (threads of slots 0 and 1), both planes;
//   2. barrier.cluster.arrive (release);
//   3. the rows between (the other slots), then __syncthreads: they are
//      written after the arrive, so only the block barrier orders them
//      for this CTA's threads, the only ones that read them;
//   4. barrier.cluster.wait (acquire).
// Why that is safe: turn k + 1 writes the buffer that the neighbours
// read in turn k, and they made those reads (in step 1) before they
// arrived, so before anyone's wait of turn k returned. The neighbours
// read only edge rows, and those (both planes: a row's two words are
// written together) were written before the release. The wait that
// closes the last turn is the full cluster barrier that lets a CTA copy
// out its slab and exit: every read of its shared memory came before
// some arrive of that turn. With one CTA (kCluster false) the rows above
// and below are its own last and first, and the block barrier alone ends
// a turn.
//
// Threads: `lanes` columns x (2 + slots) slots, at most
// F::kResidentThreads, fixed before the turn loop; a slot walks `per`
// rows (the interior split into slots), a lane columns lane, lane +
// lanes, ... (once when wp <= lanes).
//
// The count (`alive` given): after the last turn each CTA counts the
// live cells of the slab it writes out (plane 0, the alive plane of
// Gen3), adds them in its shared memory (in the buffer the last turn
// read, free once the turn's barrier has passed) and adds its sum to the
// counter (`add_block_count`). Rank 0 zeroes the counter before the
// barrier that every CTA of its group passes before its first turn, so
// the launch needs no memset before it: the count of K1's and K4's
// chunk token (64-bit) and of K9's slots.
//
// K9 route 1 (kBatched, F = Life): the same kernel over a (cap, h, wp)
// batch of slots, each its own torus. The grid holds cap groups of
// `slot_ctas` CTAs (a cluster each when kCluster); group g steps slot g,
// whose words start g * h * wp words into `in` and `out`, and counts
// into alive[g].
template <typename F, bool kCluster, bool kBatched = false>
__global__ void __launch_bounds__(F::kResidentThreads, 1)
resident_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int h, int wp, long long turns, uint32_t born,
                uint32_t survive, int lanes, int per,
                Count<kBatched>* __restrict__ alive, int slot_ctas,
                CountBox box) {
  static_assert(!kBatched || F::kPlanes == 1, "K9 steps one plane");
  extern __shared__ uint32_t smem[];
  const long long board = (long long)h * wp;       // words per board plane
  int ctas = gridDim.x;
  int rank = blockIdx.x;
  int group = 0;  // the batch slot this CTA steps (K9)
  if constexpr (kBatched) {
    ctas = slot_ctas;
    group = blockIdx.x / slot_ctas;
    rank = blockIdx.x - group * slot_ctas;
    in += group * F::kPlanes * board;
    out += group * F::kPlanes * board;
  }
  const int a = slab_start(rank, h, ctas);
  const int len = slab_start(rank + 1, h, ctas) - a;
  const int plane = ((h + ctas - 1) / ctas) * wp;  // words per slab plane
  const int buf = F::kPlanes * plane;              // words per buffer
  if (alive != nullptr && rank == 0 && threadIdx.x == 0) alive[group] = 0;
#pragma unroll
  for (int p = 0; p < F::kPlanes; ++p) {
    const uint32_t* src_in = in + p * board + (long long)a * wp;
    for (int i = threadIdx.x; i < len * wp; i += blockDim.x) {
      smem[p * plane + i] = src_in[i];
    }
  }
  const uint32_t* up = smem;
  const uint32_t* down = smem;
  int up_last = len - 1;  // row of `up` above the slab
  if constexpr (kCluster) {
    cg::cluster_group cluster = cg::this_cluster();
    const int ru = rank == 0 ? ctas - 1 : rank - 1;
    up = cluster.map_shared_rank(smem, ru);
    down = cluster.map_shared_rank(smem, rank == ctas - 1 ? 0 : rank + 1);
    up_last = slab_start(ru + 1, h, ctas) - slab_start(ru, h, ctas) - 1;
    cluster.sync();  // every slab loaded, every CTA running
  } else {
    __syncthreads();
  }
  // This thread's rows [first, first + n) and column.
  const int slot = threadIdx.x / lanes;
  const int lane = threadIdx.x - slot * lanes;
  const bool edge = slot < 2;
  int first, n;
  if (slot == 0) {
    first = 0;
    n = 1;
  } else if (slot == 1) {
    first = len - 1;
    n = len >= 2 ? 1 : 0;
  } else {
    first = 1 + (slot - 2) * per;
    n = max(0, min(per, len - 1 - first));
  }
  const int last = first + n - 1;
  const uint32_t* above = first == 0 ? up : smem;
  const int above_off = (first == 0 ? up_last : first - 1) * wp;
  const uint32_t* below = last == len - 1 ? down : smem;
  const int below_off = last == len - 1 ? 0 : (last + 1) * wp;
  const int first_off = first * wp;
  const int west0 = lane == 0 ? wp - 1 : lane - 1;
  const int east0 = lane + 1 == wp ? 0 : lane + 1;
  const RuleLeaves rule = make_leaves(born, survive);
  auto step = [&](int src, int dst) {
    if (n <= 0) return;
    int col = lane, west = west0, east = east0;
    while (true) {
      step_rows<F>(above + src + above_off, smem + src + first_off,
                   below + src + below_off, smem + dst + first_off, n, wp,
                   plane, col, west, east, rule);
      col += lanes;
      if (col >= wp) break;
      west = col - 1;
      east = col + 1 == wp ? 0 : col + 1;
    }
  };
  int src = 0;  // word offset of the current buffer
  for (long long k = 0; k < turns; ++k) {
    const int dst = buf - src;
    if (edge) step(src, dst);
    if constexpr (kCluster) cluster_arrive();
    if (!edge) step(src, dst);
    __syncthreads();
    if constexpr (kCluster) cluster_wait();
    src = dst;
  }
  const bool counted = alive != nullptr;
  int* scratch = reinterpret_cast<int*>(smem + (buf - src));
  if (counted) {
    if (threadIdx.x == 0) *scratch = 0;
    __syncthreads();
  }
  int pop = 0;
  // The box in slab rows; a slab inside it counts every word it stores.
  const int b0 = box.r0 - a, b1 = box.r1 - a;
  const bool whole = b0 <= 0 && b1 >= len && box.c0 <= 0 && box.c1 >= wp;
#pragma unroll
  for (int p = 0; p < F::kPlanes; ++p) {
    uint32_t* dst_out = out + p * board + (long long)a * wp;
    for (int i = threadIdx.x; i < len * wp; i += blockDim.x) {
      const uint32_t v = smem[src + p * plane + i];
      dst_out[i] = v;
      if (p == 0 && counted) {
        if (whole) {
          pop += __popc(v);
        } else {
          const int r = i / wp, c = i - r * wp;
          if (r >= b0 && r < b1 && c >= box.c0 && c < box.c1) {
            pop += __popc(v);
          }
        }
      }
    }
  }
  if (counted) {
    add_block_count(scratch, pop, alive + group, threadIdx.x == 0);
  }
}

// The device as the current one, with no driver call when it already is.
cudaError_t use_device(int device) {
  int current = -1;
  if (cudaGetDevice(&current) == cudaSuccess && current == device) {
    return cudaSuccess;
  }
  return cudaSetDevice(device);
}

// A launch's set-up, kept for the process: the largest dynamic shared
// memory allowed so far and whether clusters above 8 CTAs are allowed,
// per (kernel, device); and the (kernel, device, shared memory, cluster
// size, threads) whose cluster the card was found to place. A launch
// whose set-up is kept makes none of these driver calls: at a few slots
// they cost more host time than K9's kernel takes on the card.
struct KernelAttrs {
  const void* kernel;
  int device;
  size_t smem;
  bool wide;
};
struct PlacedCluster {
  const void* kernel;
  int device;
  size_t smem;
  int ctas, threads;
};
std::mutex g_setup_mu;
std::vector<KernelAttrs> g_attrs;
std::vector<PlacedCluster> g_placed;

// Allows `smem` bytes of dynamic shared memory (and, with `ctas` above 8,
// a non-portable cluster) for `kernel` on `device`; with `cfg`, checks
// once that the card places the launch's cluster (no fallback when it
// cannot: cudaErrorLaunchOutOfResources).
cudaError_t prepare_launch(const void* kernel, int device, size_t smem,
                           int ctas, int threads,
                           const cudaLaunchConfig_t* cfg) {
  std::lock_guard<std::mutex> lock(g_setup_mu);
  for (const PlacedCluster& p : g_placed) {
    if (p.kernel == kernel && p.device == device && p.smem == smem &&
        p.ctas == ctas && p.threads == threads) {
      return cudaSuccess;
    }
  }
  KernelAttrs* attrs = nullptr;
  for (KernelAttrs& k : g_attrs) {
    if (k.kernel == kernel && k.device == device) attrs = &k;
  }
  if (attrs == nullptr) {
    g_attrs.push_back({kernel, device, 0, false});
    attrs = &g_attrs.back();
  }
  cudaError_t e;
  if (smem > attrs->smem) {  // the attribute is a maximum: only raised
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return e;
    attrs->smem = smem;
  }
  if (ctas > kPortableClusterCtas && !attrs->wide) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    attrs->wide = true;
  }
  if (cfg != nullptr) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, kernel, cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
  }
  g_placed.push_back({kernel, device, smem, ctas, threads});
  return cudaSuccess;
}

// The configuration of a launch of `blocks` blocks of `threads` threads
// in clusters of `ctas`, with `smem` bytes of dynamic shared memory a
// block (not copyable: `cfg` points at `attr`).
struct ClusterLaunch {
  cudaLaunchAttribute attr = {};
  cudaLaunchConfig_t cfg = {};
  ClusterLaunch(int ctas, int blocks, int threads, size_t smem,
                cudaStream_t stream) {
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = ctas;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
  ClusterLaunch(const ClusterLaunch&) = delete;
  ClusterLaunch& operator=(const ClusterLaunch&) = delete;
};

// Launches `slots` groups of `ctas` CTAs (one group when not kBatched).
template <typename F, bool kCluster, bool kBatched = false>
cudaError_t launch_resident(const void* in, void* out, int h, int wp,
                            long long turns, unsigned born, unsigned survive,
                            int ctas, int lanes, int threads, int per,
                            size_t smem, int device, cudaStream_t stream,
                            Count<kBatched>* alive, int slots,
                            CountBox box) {
  auto kernel = resident_kernel<F, kCluster, kBatched>;
  const ClusterLaunch launch(ctas, ctas * slots, threads, smem, stream);
  cudaError_t e = prepare_launch((const void*)kernel, device, smem, ctas,
                                 threads, &launch.cfg);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&launch.cfg, kernel, (const uint32_t*)in,
                         (uint32_t*)out, h, wp, turns, (uint32_t)born,
                         (uint32_t)survive, lanes, per, alive, ctas, box);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// The geometry of K1, K4 and K9 route 1 for `ctas` CTAs a board or slot
// whose thread slots walk `per` rows: the dynamic shared memory of a CTA,
// its lanes and threads. Returns false for a geometry they do not take.
template <typename F>
bool resident_geometry(int h, int wp, int ctas, int per, size_t* smem,
                       int* lanes, int* threads) {
  if (h < 1 || wp < 1 || ctas < 1 || ctas > kResidentMaxCtas || ctas > h ||
      per < 1) {
    return false;
  }
  const int len_max = (h + ctas - 1) / ctas;
  *smem = 2 * F::kPlanes * sizeof(uint32_t) * (size_t)len_max * wp;
  const int inner = len_max - 2;
  const int thread_slots = 2 + (inner > 0 ? (inner + per - 1) / per : 0);
  constexpr int kThreads = F::kResidentThreads;
  if (*smem > (size_t)kBlockSmemBytes || thread_slots > kThreads) {
    return false;
  }
  *lanes = wp < kThreads / thread_slots ? wp : kThreads / thread_slots;
  *threads = *lanes * thread_slots;
  return true;
}

// K1 or K4 on one cluster of `ctas` CTAs (1..16, at most h), each thread
// slot walking `per` rows of its slab's interior; with `alive` given,
// the live cells of plane 0 of the result added into *alive, which the
// launch zeroes. Returns cudaErrorInvalidValue for a geometry it does not
// take and cudaErrorLaunchOutOfResources when the cluster cannot be
// placed.
//
// With kBatched (K9 route 1): `groups` groups of `ctas` CTAs over a
// (groups, h, wp) batch of slots, each slot's live cells into
// alive[slot].
template <typename F, bool kBatched = false>
int run_resident(const void* in, void* out, int h, int wp, long long turns,
                 unsigned born, unsigned survive, int ctas, int per,
                 int device, void* stream, Count<kBatched>* alive = nullptr,
                 int groups = 1, const CountBox* box = nullptr) {
  size_t smem;
  int lanes, threads;
  if (!resident_geometry<F>(h, wp, ctas, per, &smem, &lanes, &threads) ||
      turns < 1 || groups < 1 || (long long)groups * ctas > 0x7FFFFFFF) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  const CountBox b = box != nullptr ? *box : full_box(h, wp);
  if (ctas == 1) {
    return launch_resident<F, false, kBatched>(
        in, out, h, wp, turns, born, survive, 1, lanes, threads, per, smem,
        device, s, alive, groups, b);
  }
  return launch_resident<F, true, kBatched>(
      in, out, h, wp, turns, born, survive, ctas, lanes, threads, per, smem,
      device, s, alive, groups, b);
}

// Blocks of a tiled sweep that share one SM at its deepest sweep.
constexpr int tiled_blocks_per_sm(int planes, int halo, int rows) {
  return 2 * (2 * planes * 4 * (rows + 2 * 32 * halo) * kWinWords +
              kBlockReservedSmem) <= kSmSmemBytes ? 2 : 1;
}

// K2 (F = Life, kHalo = 1, R = kRows, one of kTileRowChoices), K6 (Life,
// kHalo = 2, R = kDeepRows) and K5 (F = Gen3, Gen4, kHalo = 1, R one of
// kTile2pRowChoices): one block per R x C output tile, C = 64 - 2 kHalo
// words. The block loads a window of (R + 2t) rows x 64 words of every
// plane around its tile, indices taken modulo the board, steps it t turns
// and writes the exact R x C interior, window columns kHalo .. kHalo +
// C - 1. Wrong values enter at the window's edges and advance one row and
// one cell per turn, so each turn computes only rows [turn, R + 2t -
// turn) and t <= 32 x kHalo cells of horizontal halo are enough. K5's
// dying/encoding plane reads only its own cell, but its next value
// depends on the alive count, so its wrong margin advances like the
// alive plane's. The edge columns read their missing neighbour by
// wrapping within the window, as the plain version's windows do: their
// cells are wrong either way. A window row holds each plane's 64 words in
// turn, so a row's plane-1 words sit at a fixed offset from its plane-0
// words and every address in the loop is a pointer plus a constant.
//
// Bound: the ops (32 x 30 per word and sweep for K2, 32 x 32 or 35 for
// K5) against 8 (16 for K5) bytes per word read and written; the tile
// height R sets how many blocks fill the 132 SMs and how much of each
// window is margin ((R + t - 1) / R of the useful rows).
//
// The count (`alive` given: the last sweep of a chunk or a quantum):
// each block counts the live cells of the words it writes (plane 0, the
// alive plane of Gen3), adds them in shared memory (in the buffer the
// last turn read) and adds its sum to the counter (`add_block_count`),
// which the entry point zeroes on the stream before the launch: the
// blocks share no barrier that could order a zeroing in the kernel.
//
// K9 route 2 (kBatched, F = Life, kHalo = 1): the grid's z axis is the
// slot of a (cap, h, wp) batch, each slot its own torus, whose words
// start z * h * wp words into `in` and `out`, counted into alive[z].
template <typename F, int kHalo, int kRows, bool kBatched = false>
__global__ void __launch_bounds__(kWinWords * kTileSegments,
                                  tiled_blocks_per_sm(F::kPlanes, kHalo,
                                                      kRows))
tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
             int h, int wp, int t, uint32_t born, uint32_t survive,
             Count<kBatched>* __restrict__ alive, CountBox box) {
  static_assert(!kBatched || F::kPlanes == 1, "K9 steps one plane");
  constexpr int kWords = kWinWords - 2 * kHalo;
  constexpr int kRowWords = F::kPlanes * kWinWords;
  extern __shared__ uint32_t smem[];
  const int win_rows = kRows + 2 * t;
  const long long board = (long long)h * wp;  // words per board plane
  if constexpr (kBatched) {
    in += blockIdx.z * F::kPlanes * board;
    out += blockIdx.z * F::kPlanes * board;
  }
  const int r0 = blockIdx.y * kRows;
  const int c0 = blockIdx.x * kWords;
  const int col = threadIdx.x;
  const int seg = threadIdx.y;
  const long long gc = ((long long)c0 - kHalo + col) % wp;
  const int gcol = (int)(gc < 0 ? gc + wp : gc);
  for (int i = seg; i < win_rows; i += kTileSegments) {
    long long gr = ((long long)r0 - t + i) % h;
    if (gr < 0) gr += h;
#pragma unroll
    for (int p = 0; p < F::kPlanes; ++p) {
      smem[i * kRowWords + p * kWinWords + col] =
          in[p * board + gr * wp + gcol];
    }
  }
  __syncthreads();
  const RuleLeaves rule = make_leaves(born, survive);
  const int west = (col - 1) & (kWinWords - 1);
  const int east = (col + 1) & (kWinWords - 1);
  uint32_t* src = smem;
  uint32_t* dst = smem + win_rows * kRowWords;
  for (int turn = 1; turn <= t; ++turn) {
    const int per = (win_rows - 2 * turn + kTileSegments - 1) /
                    kTileSegments;
    const int a = turn + seg * per;
    const int b = min(a + per, win_rows - turn);
    if (a < b) {
      step_rows<F>(src + (a - 1) * kRowWords, src + a * kRowWords,
                   src + b * kRowWords, dst + a * kRowWords, b - a,
                   kRowWords, kWinWords, col, west, east, rule);
    }
    __syncthreads();
    uint32_t* const done = dst;
    dst = src;
    src = done;
  }
  const int gw = c0 + col - kHalo;
  const bool counted = alive != nullptr;
  int* scratch = reinterpret_cast<int*>(dst);  // the buffer last read
  if (counted) {
    if (col == 0 && seg == 0) *scratch = 0;
    __syncthreads();
  }
  int pop = 0;
  if (col >= kHalo && col < kHalo + kWords && gw < wp) {
    const bool in_cols = gw >= box.c0 && gw < box.c1;
    for (int i = seg; i < kRows && r0 + i < h; i += kTileSegments) {
      const long long o = (long long)(r0 + i) * wp + gw;
      const bool in_box = in_cols && r0 + i >= box.r0 && r0 + i < box.r1;
#pragma unroll
      for (int p = 0; p < F::kPlanes; ++p) {
        const uint32_t v = src[(t + i) * kRowWords + p * kWinWords + col];
        out[p * board + o] = v;
        if (p == 0 && in_box) pop += __popc(v);
      }
    }
  }
  if (counted) {
    add_block_count(scratch, pop, alive + (kBatched ? blockIdx.z : 0),
                    col == 0 && seg == 0);
  }
}

// `alive` (when given) is zeroed on the stream first: `slots` counters
// with kBatched (K9 route 2, the slots in the grid's z axis), else one.
template <typename F, int kHalo, int kRows, bool kBatched = false>
cudaError_t launch_tiled(const void* in, void* out, int h, int wp, int t,
                         unsigned born, unsigned survive, int device,
                         cudaStream_t stream,
                         Count<kBatched>* alive = nullptr, int slots = 1,
                         const CountBox* box = nullptr) {
  constexpr int kWords = kWinWords - 2 * kHalo;
  const size_t smem = 2 * F::kPlanes * sizeof(uint32_t) *
                      (size_t)(kRows + 2 * t) * kWinWords;
  cudaError_t e = prepare_launch(
      (const void*)tiled_kernel<F, kHalo, kRows, kBatched>, device, smem, 1,
      kWinWords * kTileSegments, nullptr);
  if (e != cudaSuccess) return e;
  if (alive != nullptr) {
    e = cudaMemsetAsync(alive, 0, sizeof(*alive) * (size_t)slots, stream);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((wp + kWords - 1) / kWords, (h + kRows - 1) / kRows,
                  slots);
  const dim3 block(kWinWords, kTileSegments);
  tiled_kernel<F, kHalo, kRows, kBatched><<<grid, block, smem, stream>>>(
      (const uint32_t*)in, (uint32_t*)out, h, wp, t, born, survive, alive,
      box != nullptr ? *box : full_box(h, wp));
  return cudaGetLastError();
}

// K5 at `rows` output rows per tile, one of kTile2pRowChoices.
template <typename F>
cudaError_t launch_tiled2p(const void* in, void* out, int h, int wp, int t,
                           int rows, unsigned born, unsigned survive,
                           int device, cudaStream_t stream,
                           unsigned long long* count, const CountBox* box) {
  switch (rows) {
    case kTile2pRowChoices[0]:
      return launch_tiled<F, 1, kTile2pRowChoices[0]>(
          in, out, h, wp, t, born, survive, device, stream, count, 1, box);
    case kTile2pRowChoices[1]:
      return launch_tiled<F, 1, kTile2pRowChoices[1]>(
          in, out, h, wp, t, born, survive, device, stream, count, 1, box);
    default:
      return cudaErrorInvalidValue;
  }
}

// K3: live cells per row, one warp per row.
__global__ void __launch_bounds__(kPopcountThreads)
row_popcounts_kernel(const uint32_t* __restrict__ in,
                     int32_t* __restrict__ out, int h, int wp) {
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (warp >= h) return;  // whole warps leave together
  const uint32_t* line = in + warp * wp;
  int s = 0;
  for (int w = lane; w < wp; w += 32) s += __popc(line[w]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s += __shfl_down_sync(0xFFFFFFFFu, s, off);
  }
  if (lane == 0) out[warp] = s;
}

// K8: the occupancy of an (h, wp) window, into one zeroed int32 buffer of
// h + wp counts: rows[r] = live cells of row r (K3's row popcounts), then
// cols[c] = live cells of word column c summed over all rows. A block
// takes kOccRows rows x kOccThreads words, a thread one word column of
// them: it adds each word's popcount into its column's count, and the
// warp's popcounts of a row are summed (one redux) into the block's
// shared row count. Rows and columns then go to the buffer with integer
// atomicAdd, exact in any order, and only where the count is not 0, so
// the empty margins of a sparse window cost loads and no atomics. Bound:
// one read of the window (4 bytes a word) and one write of the counts.
constexpr int kOccThreads = 128;
constexpr int kOccRows = 32;

__global__ void __launch_bounds__(kOccThreads)
window_occupancy_kernel(const uint32_t* __restrict__ in,
                        int32_t* __restrict__ rows,
                        int32_t* __restrict__ cols, int h, int wp) {
  __shared__ int32_t band[kOccRows];
  const int lane = threadIdx.x % 32;
  const int r0 = blockIdx.y * kOccRows;
  const int n = min(kOccRows, h - r0);
  const int c = blockIdx.x * kOccThreads + threadIdx.x;
  const bool mine = c < wp;
  if (threadIdx.x < kOccRows) band[threadIdx.x] = 0;
  __syncthreads();
  const uint32_t* p = in + (long long)r0 * wp + (mine ? c : 0);
  int col = 0;
#pragma unroll 8
  for (int r = 0; r < n; ++r) {
    const int v = mine ? __popc(p[(long long)r * wp]) : 0;
    col += v;
    const int s = __reduce_add_sync(0xFFFFFFFFu, v);
    if (lane == 0 && s) atomicAdd(&band[r], s);
  }
  __syncthreads();
  if (threadIdx.x < n && band[threadIdx.x]) {
    atomicAdd(&rows[r0 + threadIdx.x], band[threadIdx.x]);
  }
  if (col) atomicAdd(&cols[c], col);
}

// K7: Larger-than-Life turns of a Moore-box rule (R<r>,...,NM) on an
// (h, w) uint8 {0,1} torus — what `_ltl_step(cells, rule, "conv")` of
// gol_tpu/ops/conv.py computes for a box kernel: the (2r+1)^2 box count
// (minus the cell itself unless M1), then the rule's survive or born test
// on the count. The JAX package runs it as 4r+2 rolled float32 adds and
// interval compares under XLA (`_conv_sum` :218, `_ltl_step` :363).
//
// Both routes count the box in two passes, rows and columns by true
// modulo, so a board narrower or shorter than 2r + 1 counts each offset
// as often as the rolls do:
//   V. vertical sums of 2r + 1 cells for four columns at once: a 32-bit
//      word of four cells is added to a running word of four byte lanes
//      as the window slides down (exact while 2r + 1 <= 255, r < 128; at
//      r = 128 the lanes are 16 bits, two columns a word). A turn's
//      vertical pass costs about one instruction a cell;
//   H. for each output a running sum of 2r + 1 vertical sums along the
//      row (32-bit: counts reach 66,049 at r = 128), then the rule: one
//      table indexed by (cell, box count including the cell), t[me][n]
//      the cell's next state, M0's "minus the cell" folded in
//      (ops/cuda_stencil.py:ltl_table builds it); bytes up to r = 64 (33
//      KB), bits beyond. Loads go eight outputs at a time, ahead of the
//      stores (`row_rule`).
// A thread takes a run of rows (V) or columns (H) whose length balances
// the 2r + 1 terms that start its running sum against the threads left
// idle (`best_run`, picked by the entry point for the launch); H starts
// its sums four bytes a load (`range_sum`).
//
// Route 1, ltl_resident_kernel: a board whose cells (two buffers), one
// buffer of vertical sums and the table fit a CTA of one thread-block
// cluster (up to 16 CTAs; 512² at every r, 1024² below r = 128) runs a
// whole chunk of turns in one launch. Bound: the board is read and
// written once a chunk, so the arithmetic (LTL_OPS_PER_CELL a cell and
// turn) on at most 16 SMs and one cluster barrier a turn bound it, where
// one launch a turn of tiles would pay a launch's issue and every tile's
// halo loads each turn.
// CTA i owns the rows [a_i, a_{i+1}) of the board (slab_start, as K1),
// whole rows, so columns wrap inside a CTA. A turn k is: V from the cells
// of buffer k & 1 of the 2r + 1 rows around each own row, read through
// DSMEM from whichever CTAs own them (a walker follows the rows across
// slabs, modulo h, so a slab thinner than r and a board shorter than
// 2r + 1 are exact); a block barrier; H and the rule into buffer
// (k + 1) & 1 of the CTA's own rows; a cluster barrier. Buffer (k + 1) & 1
// was last read remotely in turn k - 1, before its readers arrived at
// that turn's cluster barrier.
//
// Route 2, ltl_tile_kernel: every other board (4096², the JAX bench's
// conv board), one launch a turn, a tile of `tile` x `tile` outputs a
// block: the (tile + 2r)^2 window by asynchronous copies (cp.async, all
// in flight at once) where it does not cross the torus seam and w is a
// multiple of 16 (else a byte a lane by modulo, four loads in flight), V
// over the window, H and the rule into a staged tile, written 16 bytes a
// lane. Bound: one read and one write of the board, 2 bytes a cell at
// 3.35 TB/s.
constexpr int kLtlMaxRadius = 128;  // LargerThanLifeRule's radius limit
constexpr int kLtlByteTableMaxRadius = 64;
constexpr int kLtlWideRadius = 128;  // vertical sums past a byte from here
constexpr int kLtlTileThreads = 256;
constexpr int kLtlResidentThreads = 1024;

// Entries of one half of the rule table: box counts 0 .. (2r+1)^2.
__host__ __device__ constexpr int ltl_stride(int r) {
  return (2 * r + 1) * (2 * r + 1) + 1;
}

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

// Bytes of the rule table in shared memory (16-byte multiples).
__host__ __device__ constexpr int ltl_table_bytes(int r) {
  return r <= kLtlByteTableMaxRadius
             ? round16(2 * ltl_stride(r))
             : round16(4 * ((2 * ltl_stride(r) + 31) / 32));
}

// Bytes of one vertical sum.
__host__ __device__ constexpr int ltl_sum_bytes(int r) {
  return r >= kLtlWideRadius ? 2 : 1;
}

// A byte pitch of at least n that is an odd number of words (lanes on
// consecutive rows take distinct banks).
__host__ __device__ constexpr int odd_word_pitch(int n) {
  return (n + 7) / 8 * 8 + 4;
}

// Route 2's dynamic shared memory: the table, the window (room for a
// 16-byte-aligned start up to 15 bytes before it and reads past its end),
// the vertical sums of `tile` rows, 16 bytes of slack for the batched
// reads past a row, and the staged outputs.
__host__ __device__ constexpr int ltl_tile_smem_bytes(int tile, int r) {
  return ltl_table_bytes(r) +
         round16((tile + 2 * r) * odd_word_pitch(tile + 2 * r + 30)) +
         round16(tile * odd_word_pitch((tile + 2 * r + 30) *
                                       ltl_sum_bytes(r))) +
         16 + tile * odd_word_pitch(tile);
}

// Route 1's dynamic shared memory a CTA: the table, the cluster's cell
// bases and slab lengths, two buffers of ceil(h/N) rows of cells, one of
// their vertical sums and 16 bytes of slack.
__host__ __device__ constexpr int ltl_resident_smem_bytes(int h, int w, int r,
                                                          int ctas) {
  return ltl_table_bytes(r) + kResidentMaxCtas * 12 +
         2 * ((h + ctas - 1) / ctas) * odd_word_pitch(w) +
         round16((h + ctas - 1) / ctas *
                 odd_word_pitch(w * ltl_sum_bytes(r))) +
         16;
}

__device__ __forceinline__ int mod_floor(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

// First row of CTA `rank`'s slab in 32-bit arithmetic (K7's boards have
// h * 16 < 2^31): slab_start's value without a 64-bit division.
__device__ __forceinline__ int slab_start32(int rank, int h, int ctas) {
  return rank * h / ctas;
}

// The run length, `unit` times a power of two, for `lines` lines of n
// entries cut into runs among `threads` threads, where a run costs
// `start` loads to begin and `per` an entry: the least rounds of the
// longest chain, weighted by kLtlChainCycles, plus all the loads over
// the 32 lanes an SM serves a cycle (a long run leaves threads idle, a
// short one repeats its start). The entry points pick it once a launch,
// for the kernels' arguments.
constexpr int kLtlChainCycles = 16;  // a chained load, about an LDS latency

int best_run(int n, int lines, int start, int per, int threads, int unit) {
  int best = unit;
  long long best_cost = -1;
  for (int run = unit;; run *= 2) {
    const long long items = (long long)lines * ((n + run - 1) / run);
    const long long chain = start + (long long)per * run;
    const long long cost =
        (items + threads - 1) / threads * chain * kLtlChainCycles +
        items * chain / 32;
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = run;
    }
    if (run >= n) break;
  }
  return best;
}

// The start cost of a horizontal running sum: 2r + 1 sums four bytes (two
// 16-bit sums) a load, and its ends.
constexpr int ltl_hstart(int r, int bytes) {
  return (2 * r + 1) * bytes / 4 + 2;
}

// The sum of n >= 1 consecutive vertical sums from p: byte sums four to
// a word load (`__dp4a`) between byte loads at the unaligned ends, 16-bit
// sums two to a word.
template <typename T>
__device__ __forceinline__ uint32_t range_sum(const T* p, int n) {
  const int each = 4 / (int)sizeof(T);
  uint32_t s = 0;
  int i = 0;
  for (; i < n && (reinterpret_cast<uintptr_t>(p + i) & 3); ++i) s += p[i];
  const uint32_t* q = reinterpret_cast<const uint32_t*>(p + i);
  const int words = (n - i) / each;
#pragma unroll 4
  for (int k = 0; k < words; ++k) {
    if constexpr (sizeof(T) == 1) {
      s = __dp4a(q[k], 0x01010101u, s);
    } else {
      s += (q[k] & 0xFFFFu) + (q[k] >> 16);
    }
  }
  for (i += words * each; i < n; ++i) s += p[i];
  return s;
}

// The next state of a cell `me` whose box (itself included) counts n.
template <bool kByte>
__device__ __forceinline__ uint32_t ltl_next(const unsigned char* table,
                                             uint32_t me, uint32_t n,
                                             int stride) {
  const uint32_t i = me * stride + n;
  if constexpr (kByte) {
    return table[i];
  } else {
    return (reinterpret_cast<const uint32_t*>(table)[i >> 5] >> (i & 31)) &
           1u;
  }
}

// An asynchronous 4-byte copy from device to shared memory, and the wait
// for all of a thread's.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void copy_table(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  for (int i = threadIdx.x; i < bytes / 16; i += blockDim.x) {
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
  }
}

// The vertical sums of a four-cell word `v` as the sum type's lanes: the
// word itself for byte lanes, two words of 16-bit lanes (columns 0, 1 and
// 2, 3) for wide sums.
template <typename T>
struct Lanes;

template <>
struct Lanes<uint8_t> {
  uint32_t a;
  __device__ __forceinline__ void add(uint32_t v) { a += v; }
  __device__ __forceinline__ void step(uint32_t in, uint32_t out) {
    a += in - out;
  }
  __device__ __forceinline__ void store(uint8_t* dst) const {
    *reinterpret_cast<uint32_t*>(dst) = a;
  }
};

template <>
struct Lanes<uint16_t> {
  uint32_t a, b;
  __device__ __forceinline__ void add(uint32_t v) {
    a += __byte_perm(v, 0, 0x4140);
    b += __byte_perm(v, 0, 0x4342);
  }
  __device__ __forceinline__ void step(uint32_t in, uint32_t out) {
    a += __byte_perm(in, 0, 0x4140) - __byte_perm(out, 0, 0x4140);
    b += __byte_perm(in, 0, 0x4342) - __byte_perm(out, 0, 0x4342);
  }
  __device__ __forceinline__ void store(uint8_t* dst) const {
    reinterpret_cast<uint32_t*>(dst)[0] = a;
    reinterpret_cast<uint32_t*>(dst)[1] = b;
  }
};

// n outputs of one row: output k's count is first plus add[1..k] minus
// sub[1..k] (add[k] enters the box, sub[k] leaves it; add[0] and sub[0]
// are read and cancel, so they need only lie in shared memory), and its
// next state t[me[k]][count] goes to out[k]. Loads go eight outputs at a
// time ahead of the stores, which are two words where out is 4-aligned.
// Reads past n stay within eight entries of the row's end.
template <typename T, bool kByte>
__device__ __forceinline__ void row_rule(const T* add, const T* sub,
                                         uint32_t first, int n,
                                         const uint8_t* me, uint8_t* out,
                                         const unsigned char* table,
                                         int stride) {
  uint32_t s = first - add[0] + sub[0];
  for (int k = 0; k < n; k += 8) {
    uint32_t v[8], m[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      v[u] = (uint32_t)add[k + u] - sub[k + u];
      m[u] = me[k + u];
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      s += v[u];
      v[u] = k + u < n ? ltl_next<kByte>(table, m[u], s, stride) : 0u;
    }
    if (k + 8 <= n) {
      uint32_t* o = reinterpret_cast<uint32_t*>(out + k);
      o[0] = v[0] | v[1] << 8 | v[2] << 16 | v[3] << 24;
      o[1] = v[4] | v[5] << 8 | v[6] << 16 | v[7] << 24;
    } else {
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (k + u < n) out[k + u] = (uint8_t)v[u];
      }
    }
  }
}

template <bool kCluster, bool kByte, typename T>
__global__ void __launch_bounds__(kLtlResidentThreads, 1)
ltl_resident_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int h, int w, int r, long long turns, int vrows,
                    int hseg, const unsigned char* __restrict__ table_g) {
  extern __shared__ __align__(16) unsigned char smem8[];
  const int ctas = gridDim.x;
  const int rank = blockIdx.x;
  const int a = slab_start32(rank, h, ctas);
  const int len = slab_start32(rank + 1, h, ctas) - a;
  const int rows = (h + ctas - 1) / ctas;  // a slab's allocation
  const int stride = ltl_stride(r);
  const int cp = odd_word_pitch(w);
  const int vp = odd_word_pitch(w * (int)sizeof(T));
  const int nt = blockDim.x;
  const int tid = threadIdx.x;
  unsigned char* table = smem8;
  const uint8_t** bases =
      reinterpret_cast<const uint8_t**>(smem8 + ltl_table_bytes(r));
  int* lens = reinterpret_cast<int*>(bases + kResidentMaxCtas);
  uint8_t* cells = reinterpret_cast<uint8_t*>(lens + kResidentMaxCtas);
  uint8_t* vsum = cells + 2 * rows * cp;
  copy_table(table, table_g, ltl_table_bytes(r));
  for (int i = tid; i < len * w; i += nt) {
    const int j = i / w;
    cells[j * cp + i - j * w] = in[(size_t)a * w + i];
  }
  if (tid < ctas) {
    if constexpr (kCluster) {
      bases[tid] = cg::this_cluster().map_shared_rank(cells, tid);
    } else {
      bases[tid] = cells;
    }
    lens[tid] = slab_start32(tid + 1, h, ctas) - slab_start32(tid, h, ctas);
  }
  if constexpr (kCluster) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
  // A thread's items: in V `vrows` rows of a word column, in H `hseg`
  // columns of a row (`best_run`).
  const int words = (w + 3) / 4;
  const int vsegs = (len + vrows - 1) / vrows;
  const int hsegs = (w + hseg - 1) / hseg;
  for (long long k = 0; k < turns; ++k) {
    const int cur = (int)(k & 1) * rows * cp;
    const int nxt = rows * cp - cur;
    // V: vsum[y][x] = cells[a + y - r .. a + y + r][x], rows modulo h,
    // each read where its owner (the CTA whose slab holds it) keeps it. A
    // walker (o, l) is a slab and a row in it; past a slab's last row
    // comes the next CTA's first (after the last CTA's, CTA 0's: the
    // torus). Within a run of rows that stays in both walkers' slabs the
    // loads go four rows at a time.
    for (int item = tid; item < words * vsegs; item += nt) {
      const int q = item % words;
      const int ya = (item / words) * vrows;
      const int yb = min(ya + vrows, len);
      const int g = mod_floor(a + ya - r, h);
      int so = ((g + 1) * ctas - 1) / h;
      int sl = g - slab_start32(so, h, ctas);
      int ao = so, al = sl;
      Lanes<T> acc{};
      for (int left = 2 * r + 1; left > 0;) {
        const int run = min(left, lens[ao] - al);
        const uint32_t* p =
            reinterpret_cast<const uint32_t*>(bases[ao] + cur + al * cp) + q;
#pragma unroll 4
        for (int i = 0; i < run; ++i) acc.add(p[i * (cp / 4)]);
        left -= run;
        al += run;
        if (al == lens[ao]) {
          ao = ao + 1 == ctas ? 0 : ao + 1;
          al = 0;
        }
      }
      for (int y = ya; y < yb;) {
        const int run = min(yb - y, min(lens[ao] - al, lens[so] - sl));
        const int pw = cp / 4;
        const uint32_t* pa =
            reinterpret_cast<const uint32_t*>(bases[ao] + cur + al * cp) + q;
        const uint32_t* ps =
            reinterpret_cast<const uint32_t*>(bases[so] + cur + sl * cp) + q;
        uint8_t* d = vsum + y * vp + 4 * (int)sizeof(T) * q;
        for (int i = 0; i < run; i += 4) {
          uint32_t va[4], vs[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (i + u < run) {
              va[u] = pa[u * pw];
              vs[u] = ps[u * pw];
            }
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (i + u < run) {
              acc.store(d + u * vp);
              acc.step(va[u], vs[u]);
            }
          }
          pa += 4 * pw;
          ps += 4 * pw;
          d += 4 * vp;
        }
        y += run;
        al += run;
        sl += run;
        if (al == lens[ao]) {
          ao = ao + 1 == ctas ? 0 : ao + 1;
          al = 0;
        }
        if (sl == lens[so]) {
          so = so + 1 == ctas ? 0 : so + 1;
          sl = 0;
        }
      }
    }
    __syncthreads();
    // H and the rule: cells[nxt][j][x] from vsum[j][x - r .. x + r],
    // columns modulo w. A segment whose box never wraps runs batched
    // (`row_rule`), one that wraps a column at a time.
    for (int item = tid; item < len * hsegs; item += nt) {
      const int j = item % len;
      const int x0 = (item / len) * hseg;
      const int x1 = min(x0 + hseg, w);
      const T* row = reinterpret_cast<const T*>(vsum + j * vp);
      const uint8_t* me = cells + cur + j * cp;
      uint8_t* dst = cells + nxt + j * cp;
      if (x0 >= r && x1 + r <= w) {
        row_rule<T, kByte>(row + x0 + r, row + x0 - r - 1,
                           range_sum(row + x0 - r, 2 * r + 1), x1 - x0,
                           me + x0, dst + x0, table, stride);
        continue;
      }
      int is = mod_floor(x0 - r, w);
      int ia = is;
      uint32_t s = 0;
      for (int c = 0; c <= 2 * r; ++c) {
        s += row[ia];
        if (++ia == w) ia = 0;
      }
      for (int x = x0; x < x1; ++x) {
        dst[x] = (uint8_t)ltl_next<kByte>(table, me[x], s, stride);
        s += row[ia] - row[is];
        if (++ia == w) ia = 0;
        if (++is == w) is = 0;
      }
    }
    if constexpr (kCluster) {
      cg::this_cluster().sync();
    } else {
      __syncthreads();
    }
  }
  const uint8_t* last = cells + (int)(turns & 1) * rows * cp;
  for (int i = tid; i < len * w; i += nt) {
    const int j = i / w;
    out[(size_t)a * w + i] = last[j * cp + i - j * w];
  }
}

template <bool kByte, typename T>
__global__ void __launch_bounds__(kLtlTileThreads)
ltl_tile_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                int h, int w, int r, int tile, int vrows, int hseg,
                const unsigned char* __restrict__ table_g) {
  extern __shared__ __align__(16) unsigned char smem8[];
  const int stride = ltl_stride(r);
  const int span = tile + 2 * r;
  const int wp = odd_word_pitch(span + 30);
  const int vp = odd_word_pitch((span + 30) * (int)sizeof(T));
  const int sp = odd_word_pitch(tile);
  unsigned char* table = smem8;
  uint8_t* win = smem8 + ltl_table_bytes(r);
  uint8_t* vsum = win + round16(span * wp);
  uint8_t* stage = vsum + round16(tile * vp) + 16;
  const int tid = threadIdx.x;
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int th = min(tile, h - y0), tw = min(tile, w - x0);
  const int wh = th + 2 * r, ww = tw + 2 * r;
  copy_table(table, table_g, ltl_table_bytes(r));

  // The window: row j is board row y0 - r + j (mod h); its byte off + c
  // is column x0 - r + c.
  int off = 0;
  if (w % 16 == 0 && x0 >= r && x0 + tw + r <= w) {
    const int gs = (x0 - r) & ~15;
    off = x0 - r - gs;
    const int chunks = (off + ww + 15) / 16;
    for (int item = tid; item < wh * chunks; item += kLtlTileThreads) {
      const int j = item / chunks;
      const int c = item - j * chunks;
      const uint8_t* src =
          in + (size_t)mod_floor(y0 - r + j, h) * w + gs + 16 * c;
      uint8_t* d = win + j * wp + 16 * c;
#pragma unroll
      for (int b = 0; b < 16; b += 4) cp_async4(d + b, src + b);
    }
    cp_async_wait_all();
  } else {
    // Seam tiles and other widths: a byte a lane, one warp a row; a lane's
    // column advances 32 modulo w.
    const int lane = tid & 31;
    const int step = 32 % w;
    const int gx0 = mod_floor(x0 - r + lane, w);
    for (int j = tid >> 5; j < wh; j += kLtlTileThreads / 32) {
      const uint8_t* row = in + (size_t)mod_floor(y0 - r + j, h) * w;
      uint8_t* d = win + j * wp;
      int gx = gx0;
      // Four loads in flight before their stores.
      for (int c = lane; c < ww; c += 128) {
        uint8_t v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c + 32 * u < ww) v[u] = row[gx];
          gx += step;
          if (gx >= w) gx -= w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          if (c + 32 * u < ww) d[c + 32 * u] = v[u];
        }
      }
    }
  }
  __syncthreads();

  // V over the window's columns, four a word: vsum[y][c] = win[y .. y +
  // 2r][c] for the output rows y.
  const int words = (off + ww + 3) / 4;
  const int vsegs = (th + vrows - 1) / vrows;
  for (int item = tid; item < words * vsegs; item += kLtlTileThreads) {
    const int q = item % words;
    const int ya = (item / words) * vrows;
    const int yb = min(ya + vrows, th);
    const uint32_t* p = reinterpret_cast<const uint32_t*>(win) + q;
    uint8_t* dst = vsum + 4 * (int)sizeof(T) * q;
    Lanes<T> acc{};
#pragma unroll 4
    for (int j = ya; j <= ya + 2 * r; ++j) acc.add(p[j * (wp / 4)]);
    const int pw = wp / 4;
    const uint32_t* pin = p + (ya + 2 * r + 1) * pw;  // the row that enters
    const uint32_t* pout = p + ya * pw;               // the row that leaves
    uint8_t* d = dst + ya * vp;
    for (int y = ya; y < yb; y += 4) {
      uint32_t va[4], vs[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (y + u < yb) {
          va[u] = pin[u * pw];
          vs[u] = pout[u * pw];
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (y + u < yb) {
          acc.store(d + u * vp);
          acc.step(va[u], vs[u]);
        }
      }
      pin += 4 * pw;
      pout += 4 * pw;
      d += 4 * vp;
    }
  }
  __syncthreads();

  // H and the rule into the staged tile.
  const int hsegs = (tw + hseg - 1) / hseg;
  for (int item = tid; item < th * hsegs; item += kLtlTileThreads) {
    const int y = item % th;
    const int i0 = (item / th) * hseg;
    const T* row = reinterpret_cast<const T*>(vsum + y * vp) + off + i0;
    row_rule<T, kByte>(row + 2 * r, row - 1, range_sum(row, 2 * r + 1),
                       min(hseg, tw - i0),
                       win + (y + r) * wp + off + r + i0,
                       stage + y * sp + i0, table, stride);
  }
  __syncthreads();

  // Whole-width tiles of a width that is a multiple of 16 go out 16 bytes
  // a lane, others a byte a lane.
  if (tw == tile && w % 16 == 0) {
    const int chunks = tile / 16;
    for (int item = tid; item < th * chunks; item += kLtlTileThreads) {
      const int y = item / chunks;
      const int c = item - y * chunks;
      const uint32_t* src =
          reinterpret_cast<const uint32_t*>(stage + y * sp) + 4 * c;
      *reinterpret_cast<uint4*>(out + (size_t)(y0 + y) * w + x0 + 16 * c) =
          make_uint4(src[0], src[1], src[2], src[3]);
    }
  } else {
    for (int item = tid; item < th * tw; item += kLtlTileThreads) {
      const int y = item / tw;
      const int x = item - y * tw;
      out[(size_t)(y0 + y) * w + x0 + x] = stage[y * sp + x];
    }
  }
}

template <bool kCluster, bool kByte, typename T>
cudaError_t launch_ltl_resident(const void* in, void* out, int h, int w,
                                long long turns, int r, int ctas,
                                const void* table, int smem,
                                cudaStream_t stream) {
  auto kernel = ltl_resident_kernel<kCluster, kByte, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  if (ctas > kPortableClusterCtas) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = ctas;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kLtlResidentThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = kCluster ? &attr : nullptr;
  cfg.numAttrs = kCluster ? 1 : 0;
  if constexpr (kCluster) {
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;  // no fallback
  }
  const int rows = (h + ctas - 1) / ctas;
  const int vrows = best_run(rows, (w + 3) / 4, 2 * r + 1, 2,
                             kLtlResidentThreads, 1);
  const int hseg = best_run(w, rows, ltl_hstart(r, sizeof(T)), 3,
                            kLtlResidentThreads, 8);
  e = cudaLaunchKernelEx(&cfg, kernel, (const uint8_t*)in, (uint8_t*)out, h,
                         w, r, turns, vrows, hseg,
                         (const unsigned char*)table);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <bool kCluster>
cudaError_t launch_ltl_resident_r(const void* in, void* out, int h, int w,
                                  long long turns, int r, int ctas,
                                  const void* table, int smem,
                                  cudaStream_t s) {
  if (r >= kLtlWideRadius) {
    return launch_ltl_resident<kCluster, false, uint16_t>(
        in, out, h, w, turns, r, ctas, table, smem, s);
  }
  if (r <= kLtlByteTableMaxRadius) {
    return launch_ltl_resident<kCluster, true, uint8_t>(
        in, out, h, w, turns, r, ctas, table, smem, s);
  }
  return launch_ltl_resident<kCluster, false, uint8_t>(
      in, out, h, w, turns, r, ctas, table, smem, s);
}

template <bool kByte, typename T>
cudaError_t launch_ltl_tile(const void* in, void* buf_a, void* buf_b, int h,
                            int w, long long turns, int r, int tile,
                            const void* table, int smem,
                            cudaStream_t stream) {
  auto kernel = ltl_tile_kernel<kByte, T>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
  // Runs sized for a whole tile (edge tiles take the same).
  const int vrows = best_run(tile, (tile + 2 * r + 18) / 4, 2 * r + 1, 2,
                             kLtlTileThreads, 1);
  const int hseg = best_run(tile, tile, ltl_hstart(r, sizeof(T)), 3,
                            kLtlTileThreads, 8);
  const uint8_t* src = (const uint8_t*)in;
  for (long long t = 0; t < turns; ++t) {
    uint8_t* dst = (uint8_t*)(t % 2 == 0 ? buf_a : buf_b);
    kernel<<<grid, kLtlTileThreads, smem, stream>>>(
        src, dst, h, w, r, tile, vrows, hseg, (const unsigned char*)table);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K2's halo depth and tile width, and its row choices (at most `cap`
// written to `rows`); returns how many choices there are.
int gol_tile_geometry(int* max_t, int* words, int* rows, int cap) {
  constexpr int n = sizeof(kTileRowChoices) / sizeof(kTileRowChoices[0]);
  *max_t = kTileMaxT;
  *words = kTileWords;
  for (int i = 0; i < n && i < cap; ++i) rows[i] = kTileRowChoices[i];
  return n;
}

// Every stepping entry point below takes `count`: null, or one 64-bit
// counter (K9: one int32 a slot) that the launch sets to the live cells
// of its result (plane 0 for the two-plane families; not taken for
// family 4, whose plane 0 is not the alive plane). The engine's entry
// points count the box rows [r0, r1) x words [c0, c1) of the result
// (`CountBox`; the whole board is 0, h, 0, wp).

// K1 on one cluster of `ctas` CTAs (1..16, at most h), each thread slot
// walking `per` rows of its slab's interior.
int gol_resident_run_turns(const void* in, void* out, void* count, int h,
                           int wp, long long turns, unsigned born,
                           unsigned survive, int ctas, int per, int device,
                           void* stream, int r0, int r1, int c0, int c1) {
  const CountBox box{r0, r1, c0, c1};
  return run_resident<Life>(in, out, h, wp, turns, born, survive, ctas, per,
                            device, stream, (unsigned long long*)count, 1,
                            &box);
}

// K2 at `rows` output rows per tile, one of kTileRowChoices.
int gol_tiled_sweep(const void* in, void* out, void* count, int h, int wp,
                    int t, int rows, unsigned born, unsigned survive,
                    int device, void* stream, int r0, int r1, int c0,
                    int c1) {
  if (t < 1 || t > kTileMaxT) return cudaErrorInvalidValue;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)count;
  const CountBox box{r0, r1, c0, c1};
  switch (rows) {
    case kTileRowChoices[0]:
      return launch_tiled<Life, 1, kTileRowChoices[0]>(
          in, out, h, wp, t, born, survive, device, s, c, 1, &box);
    case kTileRowChoices[1]:
      return launch_tiled<Life, 1, kTileRowChoices[1]>(
          in, out, h, wp, t, born, survive, device, s, c, 1, &box);
    default:
      return cudaErrorInvalidValue;
  }
}

int gol_deep_geometry(int* max_t, int* rows, int* words) {
  *max_t = kDeepMaxT;
  *rows = kDeepRows;
  *words = kDeepWords;
  return 0;
}

int gol_tiled_sweep_deep(const void* in, void* out, void* count, int h,
                         int wp, int t, unsigned born, unsigned survive,
                         int device, void* stream, int r0, int r1, int c0,
                         int c1) {
  if (t < 1 || t > kDeepMaxT) return cudaErrorInvalidValue;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const CountBox box{r0, r1, c0, c1};
  return launch_tiled<Life, 2, kDeepRows>(in, out, h, wp, t, born, survive,
                                          device, (cudaStream_t)stream,
                                          (unsigned long long*)count, 1,
                                          &box);
}

// K5's row choices (at most `cap` written to `rows`); returns how many
// there are.
int gol_tile2p_rows(int* rows, int cap) {
  constexpr int n = sizeof(kTile2pRowChoices) / sizeof(kTile2pRowChoices[0]);
  for (int i = 0; i < n && i < cap; ++i) rows[i] = kTile2pRowChoices[i];
  return n;
}

// K4, family 3 (alive, dying planes) or 4 (binary-encoded planes), on one
// cluster of `ctas` CTAs whose thread slots walk `per` rows, as K1.
int gol_resident_run_turns2p(const void* in, void* out, void* count, int h,
                             int wp, long long turns, unsigned born,
                             unsigned survive, int family, int ctas, int per,
                             int device, void* stream, int r0, int r1,
                             int c0, int c1) {
  if (family == 3) {
    const CountBox box{r0, r1, c0, c1};
    return run_resident<Gen3>(in, out, h, wp, turns, born, survive, ctas,
                              per, device, stream,
                              (unsigned long long*)count, 1, &box);
  }
  if (family == 4 && count == nullptr) {
    return run_resident<Gen4>(in, out, h, wp, turns, born, survive, ctas,
                              per, device, stream);
  }
  return cudaErrorInvalidValue;
}

// K5 at `rows` output rows per tile, one of kTile2pRowChoices.
int gol_tiled_sweep2p(const void* in, void* out, void* count, int h, int wp,
                      int t, int rows, unsigned born, unsigned survive,
                      int family, int device, void* stream, int r0, int r1,
                      int c0, int c1) {
  if (t < 1 || t > kTileMaxT) return cudaErrorInvalidValue;
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* c = (unsigned long long*)count;
  const CountBox box{r0, r1, c0, c1};
  if (family == 3) {
    return launch_tiled2p<Gen3>(in, out, h, wp, t, rows, born, survive,
                                device, s, c, &box);
  }
  if (family == 4 && c == nullptr) {
    return launch_tiled2p<Gen4>(in, out, h, wp, t, rows, born, survive,
                                device, s, nullptr, &box);
  }
  return cudaErrorInvalidValue;
}

// K9 route 1: `turns` turns of every slot of a (slots, h, wp) batch in
// one launch of `slots` groups of `ctas` CTAs (a cluster each above 1),
// thread slots walking `per` rows as K1's; alive[slot] gets the live
// cells of each slot's box rows [r0, r1) x words [c0, c1) (the same box
// for every slot; zeroed by the launch itself). A spatial bucket's
// window counts its shard's own rows; a whole slot is 0, h, 0, wp.
int gol_fleet_resident(const void* in, void* out, void* alive, int slots,
                       int h, int wp, long long turns, unsigned born,
                       unsigned survive, int ctas, int per, int device,
                       void* stream, int r0, int r1, int c0, int c1) {
  if (alive == nullptr) return cudaErrorInvalidValue;
  const CountBox box{r0, r1, c0, c1};
  return run_resident<Life, true>(in, out, h, wp, turns, born, survive,
                                  ctas, per, device, stream, (int*)alive,
                                  slots, &box);
}

// How many of K9 route 1's slot groups (clusters of `ctas` CTAs) the card
// holds at once for (h, wp) slots at `per` rows a thread slot, or minus a
// CUDA error code.
int gol_fleet_resident_clusters(int h, int wp, int ctas, int per,
                                int device) {
  size_t smem;
  int lanes, threads;
  if (!resident_geometry<Life>(h, wp, ctas, per, &smem, &lanes, &threads)) {
    return -(int)cudaErrorInvalidValue;
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return -(int)e;
  auto kernel = ctas == 1 ? resident_kernel<Life, false, true>
                          : resident_kernel<Life, true, true>;
  const ClusterLaunch launch(ctas, ctas, threads, smem, nullptr);
  e = prepare_launch((const void*)kernel, device, smem, ctas, threads,
                     &launch.cfg);
  if (e != cudaSuccess) return -(int)e;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (const void*)kernel,
                                     &launch.cfg);
  return e == cudaSuccess ? clusters : -(int)e;
}

// K9 route 2: one sweep of t (1..32) turns of every slot of a (slots, h,
// wp) batch at `rows` output rows per tile (one of kTileRowChoices);
// with `alive` non-null (a quantum's last sweep) alive[slot] gets the
// live cells of each slot's box, as route 1's.
int gol_fleet_tiled_sweep(const void* in, void* out, void* alive, int slots,
                          int h, int wp, int t, int rows, unsigned born,
                          unsigned survive, int device, void* stream,
                          int r0, int r1, int c0, int c1) {
  if (t < 1 || t > kTileMaxT || slots < 1 || slots > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  int* a = (int*)alive;
  const CountBox box{r0, r1, c0, c1};
  switch (rows) {
    case kTileRowChoices[0]:
      return launch_tiled<Life, 1, kTileRowChoices[0], true>(
          in, out, h, wp, t, born, survive, device, s, a, slots, &box);
    case kTileRowChoices[1]:
      return launch_tiled<Life, 1, kTileRowChoices[1], true>(
          in, out, h, wp, t, born, survive, device, s, a, slots, &box);
    default:
      return cudaErrorInvalidValue;
  }
}

int gol_row_popcounts(const void* in, void* out, int h, int wp, int device,
                      void* stream) {
  cudaError_t e = use_device(device);
  if (e != cudaSuccess) return e;
  const int rows_per_block = kPopcountThreads / 32;
  const int blocks = (h + rows_per_block - 1) / rows_per_block;
  row_popcounts_kernel<<<blocks, kPopcountThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)in, (int32_t*)out, h, wp);
  return cudaGetLastError();
}

// K8 into `out`: h row counts, then wp word-column counts. The buffer is
// zeroed on the stream first (the kernel adds into it).
int gol_window_occupancy(const void* in, void* out, int h, int wp,
                         int device, void* stream) {
  if (h < 1 || wp < 1) return cudaErrorInvalidValue;
  const dim3 grid((wp + kOccThreads - 1) / kOccThreads,
                  (h + kOccRows - 1) / kOccRows);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  int32_t* rows = (int32_t*)out;
  e = cudaMemsetAsync(rows, 0, sizeof(int32_t) * ((size_t)h + wp), s);
  if (e != cudaSuccess) return e;
  window_occupancy_kernel<<<grid, kOccThreads, 0, s>>>(
      (const uint32_t*)in, rows, rows + h, h, wp);
  return cudaGetLastError();
}

// K7's rule table bytes and each route's dynamic shared memory, for the
// Python mirror's check at load.
int gol_ltl_table_bytes(int r) { return ltl_table_bytes(r); }

int gol_ltl_tile_smem_bytes(int tile, int r) {
  return ltl_tile_smem_bytes(tile, r);
}

int gol_ltl_resident_smem_bytes(int h, int w, int r, int ctas) {
  return ltl_resident_smem_bytes(h, w, r, ctas);
}

// K7 route 1: `turns` turns in one launch on a cluster of `ctas` CTAs
// (1..16, at most h); `table` is the rule table
// (ops/cuda_stencil.py:ltl_table). Returns cudaErrorInvalidValue for a
// geometry it does not take and cudaErrorLaunchOutOfResources when the
// cluster cannot be placed.
int gol_ltl_resident_run_turns(const void* in, void* out, int h, int w,
                               long long turns, int r, int ctas,
                               const void* table, int device, void* stream) {
  if (turns < 1 || h < 1 || w < 1 || r < 1 || r > kLtlMaxRadius ||
      ctas < 1 || ctas > kResidentMaxCtas || ctas > h) {
    return cudaErrorInvalidValue;
  }
  const int smem = ltl_resident_smem_bytes(h, w, r, ctas);
  if (smem > kBlockSmemBytes) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctas == 1) {
    return launch_ltl_resident_r<false>(in, out, h, w, turns, r, 1, table,
                                        smem, s);
  }
  return launch_ltl_resident_r<true>(in, out, h, w, turns, r, ctas, table,
                                     smem, s);
}

// K7 route 2 over a chunk: `turns` launches on the stream, turn t from the
// previous turn's board (the input for t = 0) into buf_a for even t and
// buf_b for odd t, so the result is in buf_a when `turns` is odd and buf_b
// when it is even; the input is never written.
int gol_ltl_box_run_turns(const void* in, void* buf_a, void* buf_b, int h,
                          int w, long long turns, int r, int tile,
                          const void* table, int device, void* stream) {
  if (turns < 1 || h < 1 || w < 1 || r < 1 || r > kLtlMaxRadius ||
      (tile != 32 && tile != 64 && tile != 128)) {
    return cudaErrorInvalidValue;
  }
  const int smem = ltl_tile_smem_bytes(tile, r);
  if (smem > kBlockSmemBytes || (h + tile - 1) / tile > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (r >= kLtlWideRadius) {
    return launch_ltl_tile<false, uint16_t>(in, buf_a, buf_b, h, w, turns, r,
                                            tile, table, smem, s);
  }
  if (r <= kLtlByteTableMaxRadius) {
    return launch_ltl_tile<true, uint8_t>(in, buf_a, buf_b, h, w, turns, r,
                                          tile, table, smem, s);
  }
  return launch_ltl_tile<false, uint8_t>(in, buf_a, buf_b, h, w, turns, r,
                                         tile, table, smem, s);
}

}  // extern "C"
