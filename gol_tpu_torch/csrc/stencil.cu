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
//                                  (engine.py:158-160)
//   resident_kernel<Gen3|4>  K4 <- pallas_packed_run_turns3
//                                  (pallas_stencil.py:274) and
//                                  pallas_packed_run_turns4 (:296)
//   tiled_kernel<Gen3|4, 1>  K5 <- the same two, for boards beyond K4's
//                                  shared memory (the TPU ran them from
//                                  VMEM)
//   ltl_box_kernel           K7 <- one Larger-than-Life turn of a Moore-box
//                                  rule on a uint8 torus: the box path of
//                                  `_conv_sum` and `_ltl_step`, which the
//                                  JAX package leaves to XLA
//                                  (gol_tpu/ops/conv.py:218, :363)
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
template <typename F, bool kCluster>
__global__ void __launch_bounds__(F::kResidentThreads, 1)
resident_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int h, int wp, long long turns, uint32_t born,
                uint32_t survive, int lanes, int per) {
  extern __shared__ uint32_t smem[];
  const int ctas = gridDim.x;
  const int rank = blockIdx.x;
  const int a = slab_start(rank, h, ctas);
  const int len = slab_start(rank + 1, h, ctas) - a;
  const int plane = ((h + ctas - 1) / ctas) * wp;  // words per slab plane
  const int buf = F::kPlanes * plane;              // words per buffer
  const long long board = (long long)h * wp;       // words per board plane
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
#pragma unroll
  for (int p = 0; p < F::kPlanes; ++p) {
    uint32_t* dst_out = out + p * board + (long long)a * wp;
    for (int i = threadIdx.x; i < len * wp; i += blockDim.x) {
      dst_out[i] = smem[src + p * plane + i];
    }
  }
}

template <typename F, bool kCluster>
cudaError_t launch_resident(const void* in, void* out, int h, int wp,
                            long long turns, unsigned born, unsigned survive,
                            int ctas, int lanes, int threads, int per,
                            size_t smem, cudaStream_t stream) {
  auto kernel = resident_kernel<F, kCluster>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
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
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
  if (e != cudaSuccess) return e;
  if (clusters < 1) return cudaErrorLaunchOutOfResources;  // no fallback
  e = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)in, (uint32_t*)out,
                         h, wp, turns, (uint32_t)born, (uint32_t)survive,
                         lanes, per);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K1 or K4 on one cluster of `ctas` CTAs (1..16, at most h), each thread
// slot walking `per` rows of its slab's interior. Returns
// cudaErrorInvalidValue for a geometry it does not take and
// cudaErrorLaunchOutOfResources when the cluster cannot be placed.
template <typename F>
int run_resident(const void* in, void* out, int h, int wp, long long turns,
                 unsigned born, unsigned survive, int ctas, int per,
                 int device, void* stream) {
  if (h < 1 || wp < 1 || ctas < 1 || ctas > kResidentMaxCtas || ctas > h ||
      per < 1) {
    return cudaErrorInvalidValue;
  }
  const int len_max = (h + ctas - 1) / ctas;
  const size_t smem =
      2 * F::kPlanes * sizeof(uint32_t) * (size_t)len_max * wp;
  const int inner = len_max - 2;
  const int slots = 2 + (inner > 0 ? (inner + per - 1) / per : 0);
  constexpr int kThreads = F::kResidentThreads;
  if (smem > (size_t)kBlockSmemBytes || slots > kThreads) {
    return cudaErrorInvalidValue;
  }
  const int lanes = wp < kThreads / slots ? wp : kThreads / slots;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (ctas == 1) {
    return launch_resident<F, false>(in, out, h, wp, turns, born, survive,
                                     1, lanes, lanes * slots, per, smem, s);
  }
  return launch_resident<F, true>(in, out, h, wp, turns, born, survive,
                                  ctas, lanes, lanes * slots, per, smem, s);
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
template <typename F, int kHalo, int kRows>
__global__ void __launch_bounds__(kWinWords * kTileSegments,
                                  tiled_blocks_per_sm(F::kPlanes, kHalo,
                                                      kRows))
tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
             int h, int wp, int t, uint32_t born, uint32_t survive) {
  constexpr int kWords = kWinWords - 2 * kHalo;
  constexpr int kRowWords = F::kPlanes * kWinWords;
  extern __shared__ uint32_t smem[];
  const int win_rows = kRows + 2 * t;
  const long long board = (long long)h * wp;  // words per board plane
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
  if (col >= kHalo && col < kHalo + kWords && gw < wp) {
    for (int i = seg; i < kRows && r0 + i < h; i += kTileSegments) {
      const long long o = (long long)(r0 + i) * wp + gw;
#pragma unroll
      for (int p = 0; p < F::kPlanes; ++p) {
        out[p * board + o] = src[(t + i) * kRowWords + p * kWinWords + col];
      }
    }
  }
}

template <typename F, int kHalo, int kRows>
cudaError_t launch_tiled(const void* in, void* out, int h, int wp, int t,
                         unsigned born, unsigned survive,
                         cudaStream_t stream) {
  constexpr int kWords = kWinWords - 2 * kHalo;
  const size_t smem = 2 * F::kPlanes * sizeof(uint32_t) *
                      (size_t)(kRows + 2 * t) * kWinWords;
  cudaError_t e = cudaFuncSetAttribute(
      tiled_kernel<F, kHalo, kRows>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((wp + kWords - 1) / kWords, (h + kRows - 1) / kRows);
  const dim3 block(kWinWords, kTileSegments);
  tiled_kernel<F, kHalo, kRows><<<grid, block, smem, stream>>>(
      (const uint32_t*)in, (uint32_t*)out, h, wp, t, born, survive);
  return cudaGetLastError();
}

// K5 at `rows` output rows per tile, one of kTile2pRowChoices.
template <typename F>
cudaError_t launch_tiled2p(const void* in, void* out, int h, int wp, int t,
                           int rows, unsigned born, unsigned survive,
                           cudaStream_t stream) {
  switch (rows) {
    case kTile2pRowChoices[0]:
      return launch_tiled<F, 1, kTile2pRowChoices[0]>(in, out, h, wp, t,
                                                      born, survive, stream);
    case kTile2pRowChoices[1]:
      return launch_tiled<F, 1, kTile2pRowChoices[1]>(in, out, h, wp, t,
                                                      born, survive, stream);
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


// K7: one Larger-than-Life turn of a Moore-box rule (R<r>,...,NM) on an
// (h, w) uint8 {0,1} torus — what `_ltl_step(cells, rule, "conv")` of
// gol_tpu/ops/conv.py computes for a box kernel: the (2r+1)^2 box count
// (minus the cell itself unless M1), then the rule's survive or born test
// on the count. The JAX package runs it as 4r+2 rolled float32 adds and
// interval compares under XLA; the card's bound is one read and one write
// of the board (2 bytes a cell at 3.35 TB/s), so the kernel keeps every
// intermediate in shared memory:
//   A. a tile of `tile` x `tile` outputs loads its window of (tile + 2r)^2
//      cells, rows and columns taken modulo the board by true modulo, so a
//      board narrower than 2r + 1 is counted with the rolls' multiplicity
//      (each of the (2r+1)^2 offsets once, however often it wraps);
//   B. horizontal sums of 2r+1 cells for every window row and output
//      column, as running sums along segments of kLtlSeg columns (uint16:
//      at most 257);
//   C. vertical running sums of 2r+1 horizontal sums down segments of rows
//      (int32: (2*128+1)^2 = 66,049 does not fit 16 bits), then the rule:
//      one bit of a survive or born table of neighbourhood size + 1 bits
//      (the rule's `luts()`), held in shared memory.
// Thread mappings keep shared memory conflict-free: in B lanes take
// consecutive window rows, whose pitch is an odd number of words; in C
// lanes take consecutive columns, and their stores to the board are
// coalesced. Each running sum starts by adding 2r+1 terms: a B segment
// serves kLtlSeg outputs and a C segment tile*tile/kLtlThreads rows (64 at
// tile 128, 4 at tile 32), so a cell costs about 2 + (2r+1)/32 adds in B,
// on (1 + 2r/tile) window rows an output row, and 2 + (2r+1)*256/tile^2 in
// C (1 more at tile 128 and r = 32, 64 more at tile 32 and r = 128). The
// window's halo costs (1 + 2r/tile)^2 loads a cell.
constexpr int kLtlThreads = 256;
constexpr int kLtlSeg = 32;        // phase B outputs per running sum
constexpr int kLtlMaxRadius = 128;  // LargerThanLifeRule's radius limit

// Window pitch in bytes: >= tile + 2r and 4 (mod 8), an odd number of
// words.
__host__ __device__ constexpr int ltl_win_pitch(int tile, int r) {
  return ((tile + 2 * r + 7) / 8) * 8 + 4;
}

// Horizontal-sum pitch in uint16 elements: tile + 2, an odd number of
// words for the tiles taken (multiples of 4).
__host__ __device__ constexpr int ltl_sum_pitch(int tile) { return tile + 2; }

// Dynamic shared memory of one K7 block: both rule tables, the horizontal
// sums and the window.
__host__ __device__ constexpr int ltl_smem_bytes(int tile, int r,
                                                 int lut_words) {
  return 8 * lut_words + 2 * (tile + 2 * r) * ltl_sum_pitch(tile) +
         (tile + 2 * r) * ltl_win_pitch(tile, r);
}

__device__ __forceinline__ int mod_floor(int a, int n) {
  const int m = a % n;
  return m < 0 ? m + n : m;
}

__global__ void __launch_bounds__(kLtlThreads)
ltl_box_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
               int h, int w, int r, int middle, int tile,
               const uint32_t* __restrict__ luts, int lut_words) {
  extern __shared__ __align__(16) unsigned char ltl_smem[];
  uint32_t* survive = reinterpret_cast<uint32_t*>(ltl_smem);
  const uint32_t* born = survive + lut_words;
  const int wp = ltl_win_pitch(tile, r);
  const int hp = ltl_sum_pitch(tile);
  uint16_t* sums = reinterpret_cast<uint16_t*>(survive + 2 * lut_words);
  uint8_t* win = reinterpret_cast<uint8_t*>(sums + (tile + 2 * r) * hp);
  const int y0 = blockIdx.y * tile, x0 = blockIdx.x * tile;
  const int th = min(tile, h - y0), tw = min(tile, w - x0);
  const int wh = th + 2 * r, ww = tw + 2 * r;
  const int tid = threadIdx.x;
  for (int i = tid; i < 2 * lut_words; i += kLtlThreads) survive[i] = luts[i];

  // A: the window, one warp a row; a lane's column advances 32 modulo w.
  const int lane = tid & 31;
  const int step = 32 % w;
  const int gx0 = mod_floor(x0 - r + lane, w);
  for (int j = tid >> 5; j < wh; j += kLtlThreads / 32) {
    const uint8_t* row = in + (size_t)mod_floor(y0 - r + j, h) * w;
    uint8_t* dst = win + j * wp;
    int gx = gx0;
    for (int c = lane; c < ww; c += 32) {
      dst[c] = row[gx];
      gx += step;
      if (gx >= w) gx -= w;
    }
  }
  __syncthreads();

  // B: sums[j][i] = win[j][i .. i + 2r].
  const int segs = (tw + kLtlSeg - 1) / kLtlSeg;
  for (int item = tid; item < wh * segs; item += kLtlThreads) {
    const int j = item % wh;
    const int i0 = (item / wh) * kLtlSeg;
    const int i1 = min(i0 + kLtlSeg, tw);
    const uint8_t* src = win + j * wp;
    uint16_t* dst = sums + j * hp;
    int s = 0;
    for (int c = i0; c <= i0 + 2 * r; ++c) s += src[c];
    dst[i0] = (uint16_t)s;
    for (int i = i0 + 1; i < i1; ++i) {
      s += src[i + 2 * r] - src[i - 1];
      dst[i] = (uint16_t)s;
    }
  }
  __syncthreads();

  // C: count[y][i] = sums[y .. y + 2r][i], minus the cell unless M1, then
  // the rule's bit; each thread walks `rows` rows of one column.
  const int rows = tile * tile / kLtlThreads;
  const int vsegs = (th + rows - 1) / rows;
  for (int item = tid; item < tw * vsegs; item += kLtlThreads) {
    const int i = item % tw;
    const int ya = (item / tw) * rows;
    const int yb = min(ya + rows, th);
    int s = 0;
    for (int j = ya; j <= ya + 2 * r; ++j) s += sums[j * hp + i];
    for (int y = ya;;) {
      const int me = win[(y + r) * wp + i + r];
      const int n = s - (middle ? 0 : me);
      const uint32_t* lut = me == 1 ? survive : born;
      out[(size_t)(y0 + y) * w + x0 + i] =
          (uint8_t)((lut[n >> 5] >> (n & 31)) & 1u);
      if (++y >= yb) break;
      s += sums[(y + 2 * r) * hp + i] - sums[(y - 1) * hp + i];
    }
  }
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

// K1 on one cluster of `ctas` CTAs (1..16, at most h), each thread slot
// walking `per` rows of its slab's interior.
int gol_resident_run_turns(const void* in, void* out, int h, int wp,
                           long long turns, unsigned born, unsigned survive,
                           int ctas, int per, int device, void* stream) {
  return run_resident<Life>(in, out, h, wp, turns, born, survive, ctas, per,
                            device, stream);
}

// K2 at `rows` output rows per tile, one of kTileRowChoices.
int gol_tiled_sweep(const void* in, void* out, int h, int wp, int t,
                    int rows, unsigned born, unsigned survive, int device,
                    void* stream) {
  if (t < 1 || t > kTileMaxT) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (rows) {
    case kTileRowChoices[0]:
      return launch_tiled<Life, 1, kTileRowChoices[0]>(in, out, h, wp, t,
                                                       born, survive, s);
    case kTileRowChoices[1]:
      return launch_tiled<Life, 1, kTileRowChoices[1]>(in, out, h, wp, t,
                                                       born, survive, s);
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

int gol_tiled_sweep_deep(const void* in, void* out, int h, int wp, int t,
                         unsigned born, unsigned survive, int device,
                         void* stream) {
  if (t < 1 || t > kDeepMaxT) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  return launch_tiled<Life, 2, kDeepRows>(in, out, h, wp, t, born, survive,
                                          (cudaStream_t)stream);
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
int gol_resident_run_turns2p(const void* in, void* out, int h, int wp,
                             long long turns, unsigned born,
                             unsigned survive, int family, int ctas, int per,
                             int device, void* stream) {
  if (family == 3) {
    return run_resident<Gen3>(in, out, h, wp, turns, born, survive, ctas,
                              per, device, stream);
  }
  if (family == 4) {
    return run_resident<Gen4>(in, out, h, wp, turns, born, survive, ctas,
                              per, device, stream);
  }
  return cudaErrorInvalidValue;
}

// K5 at `rows` output rows per tile, one of kTile2pRowChoices.
int gol_tiled_sweep2p(const void* in, void* out, int h, int wp, int t,
                      int rows, unsigned born, unsigned survive, int family,
                      int device, void* stream) {
  if (t < 1 || t > kTileMaxT) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  if (family == 3) {
    return launch_tiled2p<Gen3>(in, out, h, wp, t, rows, born, survive, s);
  }
  if (family == 4) {
    return launch_tiled2p<Gen4>(in, out, h, wp, t, rows, born, survive, s);
  }
  return cudaErrorInvalidValue;
}

int gol_row_popcounts(const void* in, void* out, int h, int wp, int device,
                      void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const int rows_per_block = kPopcountThreads / 32;
  const int blocks = (h + rows_per_block - 1) / rows_per_block;
  row_popcounts_kernel<<<blocks, kPopcountThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)in, (int32_t*)out, h, wp);
  return cudaGetLastError();
}

// K7's dynamic shared memory for a tile, radius and table size; callers
// pick a tile whose block fits kBlockSmemBytes.
int gol_ltl_smem_bytes(int tile, int r, int lut_words) {
  return ltl_smem_bytes(tile, r, lut_words);
}

// K7 over a chunk: `turns` launches on the stream, turn t from the previous
// turn's board (the input for t = 0) into buf_a for even t and buf_b for
// odd t, so the result is in buf_a when `turns` is odd and buf_b when it
// is even; the input is never written. `luts` holds the survive table
// then the born table, `lut_words` 32-bit words each.
int gol_ltl_box_run_turns(const void* in, void* buf_a, void* buf_b, int h,
                          int w, long long turns, int r, int middle,
                          int tile, const void* luts, int lut_words,
                          int device, void* stream) {
  if (turns < 1 || h < 1 || w < 1 || r < 1 || r > kLtlMaxRadius ||
      (tile != 32 && tile != 64 && tile != 128) || lut_words < 1) {
    return cudaErrorInvalidValue;
  }
  const int smem = ltl_smem_bytes(tile, r, lut_words);
  const dim3 grid((w + tile - 1) / tile, (h + tile - 1) / tile);
  if (smem > kBlockSmemBytes || grid.y > 65535) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(ltl_box_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const cudaStream_t s = (cudaStream_t)stream;
  const uint8_t* src = (const uint8_t*)in;
  for (long long t = 0; t < turns; ++t) {
    uint8_t* dst = (uint8_t*)(t % 2 == 0 ? buf_a : buf_b);
    ltl_box_kernel<<<grid, kLtlThreads, smem, s>>>(
        src, dst, h, w, r, middle, tile, (const uint32_t*)luts, lut_words);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    src = dst;
  }
  return cudaSuccess;
}

}  // extern "C"
