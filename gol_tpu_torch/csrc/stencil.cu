// Hopper (sm_90a) kernels for bit-packed life-like stepping.
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
// loads and one store per turn.
//
// Kernels and the TPU kernels they replace:
//   resident_run_turns  <- pallas_packed_run_turns (pallas_stencil.py:508)
//   tiled_sweep         <- _banded_pass (pallas_stencil.py:388)
//   row_popcounts       <- the alive token's popcount reduction, which the
//                          JAX package leaves to XLA (engine.py:158-160)
//
// C interface: every entry point sets the device, launches on the given
// stream, does not synchronise and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// tiled_sweep geometry; ops/cuda_stencil.py mirrors these constants.
constexpr int kTileMaxT = 32;      // deepest sweep: one halo word a side
constexpr int kTileRows = 384;     // R: output rows per block
constexpr int kWinWords = 64;      // C + 2: window words per row
constexpr int kTileWords = kWinWords - 2;  // C: output words per block
constexpr int kTileSegments = 8;   // threads down each window column
constexpr int kResidentThreads = 1024;
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

// Next state of the 32 cells of `mid` from its self-inclusive count bits.
__device__ __forceinline__ uint32_t apply_rule(const RuleLeaves& r,
                                               uint32_t mid, uint32_t n0,
                                               uint32_t n1, uint32_t n2,
                                               uint32_t n3) {
  uint32_t v[10];
#pragma unroll
  for (int k = 0; k < 10; ++k) v[k] = mux(mid, r.s[k], r.b[k]);
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

// Horizontal sum west + self + east of one word, as bit-planes (s0, s1).
__device__ __forceinline__ void hsum(uint32_t w, uint32_t p, uint32_t e,
                                     uint32_t& s0, uint32_t& s1) {
  const uint32_t west = __funnelshift_l(w, p, 1);  // (p << 1) | (w >> 31)
  const uint32_t east = __funnelshift_r(p, e, 1);  // (p >> 1) | (e << 31)
  s0 = west ^ p ^ east;
  s1 = (west & p) | (east & (west ^ p));
}

// One turn for rows [a, b) of one word column. `row(i)` maps a row index
// to its offset in `src` (torus wrap or window), `west`/`east` are the
// column offsets of the neighbouring words, or -1 for "no word" (zero).
template <typename RowFn>
__device__ __forceinline__ void step_column(
    const uint32_t* __restrict__ src, uint32_t* __restrict__ dst, int a,
    int b, int col, int west, int east, RowFn row, const RuleLeaves& rule) {
  auto load = [&](int r, uint32_t& p, uint32_t& s0, uint32_t& s1) {
    const uint32_t* line = src + row(r);
    p = line[col];
    const uint32_t w = west >= 0 ? line[west] : 0u;
    const uint32_t e = east >= 0 ? line[east] : 0u;
    hsum(w, p, e, s0, s1);
  };
  uint32_t pu, au0, au1, pm, am0, am1;
  load(a - 1, pu, au0, au1);
  load(a, pm, am0, am1);
  for (int r = a; r < b; ++r) {
    uint32_t pd, ad0, ad1;
    load(r + 1, pd, ad0, ad1);
    const uint32_t u0 = au0 ^ am0 ^ ad0;
    const uint32_t u1 = (au0 & am0) | (ad0 & (au0 ^ am0));
    const uint32_t v0 = au1 ^ am1 ^ ad1;
    const uint32_t v1 = (au1 & am1) | (ad1 & (au1 ^ am1));
    const uint32_t n1 = u1 ^ v0;
    const uint32_t c2 = u1 & v0;
    dst[row(r) + col] = apply_rule(rule, pm, u0, n1, v1 ^ c2, v1 & c2);
    au0 = am0; au1 = am1;
    pm = pd; am0 = ad0; am1 = ad1;
  }
}

// K1: the whole board in shared memory (ping-pong), `turns` turns, one
// block. Threads take (word column, row segment) items.
__global__ void __launch_bounds__(kResidentThreads)
resident_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
                int h, int wp, long long turns, uint32_t born,
                uint32_t survive, int segs) {
  extern __shared__ uint32_t smem[];
  const int n = h * wp;
  uint32_t* buf[2] = {smem, smem + n};
  for (int i = threadIdx.x; i < n; i += blockDim.x) buf[0][i] = in[i];
  __syncthreads();
  const RuleLeaves rule = make_leaves(born, survive);
  const int seg_len = (h + segs - 1) / segs;
  const int items = wp * segs;
  // step_column only asks for rows -1 .. h.
  auto row = [h, wp](int r) {
    return (r < 0 ? r + h : (r >= h ? r - h : r)) * wp;
  };
  for (long long k = 0; k < turns; ++k) {
    const uint32_t* src = buf[k & 1];
    uint32_t* dst = buf[(k + 1) & 1];
    for (int item = threadIdx.x; item < items; item += blockDim.x) {
      const int col = item % wp;
      const int a = (item / wp) * seg_len;
      const int b = min(a + seg_len, h);
      if (a < b) {
        step_column(src, dst, a, b, col, (col + wp - 1) % wp,
                    (col + 1) % wp, row, rule);
      }
    }
    __syncthreads();
  }
  const uint32_t* fin = buf[turns & 1];
  for (int i = threadIdx.x; i < n; i += blockDim.x) out[i] = fin[i];
}

// K2: one block per R x C output tile. The block loads a window of
// (R + 2t) rows x (C + 2) words around its tile, indices taken modulo the
// board, steps it t turns and writes the exact R x C interior. Wrong
// values enter at the window's edges and advance one row and one cell per
// turn, so each turn computes only rows [turn, R + 2t - turn) and t <= 32
// cells of horizontal halo (one word) are enough.
__global__ void __launch_bounds__(kWinWords * kTileSegments)
tiled_kernel(const uint32_t* __restrict__ in, uint32_t* __restrict__ out,
             int h, int wp, int t, uint32_t born, uint32_t survive) {
  extern __shared__ uint32_t smem[];
  const int win_rows = kTileRows + 2 * t;
  uint32_t* buf[2] = {smem, smem + win_rows * kWinWords};
  const int r0 = blockIdx.y * kTileRows;
  const int c0 = blockIdx.x * kTileWords;
  const int col = threadIdx.x;
  const int seg = threadIdx.y;
  const long long gc = ((long long)c0 - 1 + col) % wp;
  const int gcol = (int)(gc < 0 ? gc + wp : gc);
  for (int i = seg; i < win_rows; i += kTileSegments) {
    long long gr = ((long long)r0 - t + i) % h;
    if (gr < 0) gr += h;
    buf[0][i * kWinWords + col] = in[gr * wp + gcol];
  }
  __syncthreads();
  const RuleLeaves rule = make_leaves(born, survive);
  auto row = [](int r) { return r * kWinWords; };
  const int west = col > 0 ? col - 1 : -1;
  const int east = col < kWinWords - 1 ? col + 1 : -1;
  for (int turn = 1; turn <= t; ++turn) {
    const uint32_t* src = buf[(turn - 1) & 1];
    uint32_t* dst = buf[turn & 1];
    const int lo = turn;
    const int per = (win_rows - 2 * turn + kTileSegments - 1) /
                    kTileSegments;
    const int a = lo + seg * per;
    const int b = min(a + per, win_rows - turn);
    if (a < b) step_column(src, dst, a, b, col, west, east, row, rule);
    __syncthreads();
  }
  const uint32_t* fin = buf[t & 1];
  const int gw = c0 + col - 1;
  if (col >= 1 && col <= kTileWords && gw < wp) {
    for (int i = seg; i < kTileRows && r0 + i < h; i += kTileSegments) {
      out[(long long)(r0 + i) * wp + gw] = fin[(t + i) * kWinWords + col];
    }
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

}  // namespace

extern "C" {

const char* gol_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int gol_tile_geometry(int* max_t, int* rows, int* words) {
  *max_t = kTileMaxT;
  *rows = kTileRows;
  *words = kTileWords;
  return 0;
}

int gol_resident_run_turns(const void* in, void* out, int h, int wp,
                           long long turns, unsigned born, unsigned survive,
                           int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem = 2 * sizeof(uint32_t) * (size_t)h * wp;
  e = cudaFuncSetAttribute(resident_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int segs = kResidentThreads / wp;
  if (segs < 1) segs = 1;
  if (segs > h) segs = h;
  resident_kernel<<<1, kResidentThreads, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, h, wp, turns, born, survive,
      segs);
  return cudaGetLastError();
}

int gol_tiled_sweep(const void* in, void* out, int h, int wp, int t,
                    unsigned born, unsigned survive, int device,
                    void* stream) {
  if (t < 1 || t > kTileMaxT) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const size_t smem =
      2 * sizeof(uint32_t) * (size_t)(kTileRows + 2 * t) * kWinWords;
  e = cudaFuncSetAttribute(tiled_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((wp + kTileWords - 1) / kTileWords,
                  (h + kTileRows - 1) / kTileRows);
  const dim3 block(kWinWords, kTileSegments);
  tiled_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, h, wp, t, born, survive);
  return cudaGetLastError();
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

}  // extern "C"
