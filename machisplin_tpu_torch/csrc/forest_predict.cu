// Kernel K3: weighted forest prediction by leaf bin-intervals.
//
// Replaces machisplin_tpu/ops/pallas_forest.py::_kernel (launched from
// _predict_impl / forest_predict_bins).  For every cell i with features
// x[i, 0..p) and every leaf slot s:
//   bin_f(i) = #{ e : etab[f, e] < x[i, f] }             (edges, +inf padded)
//   member   = lo[s, f] <= bin_f(i) <= hi[s, f] for every feature f
//   out[i, r] = sum_s member * wv[s, r]                   (r < R responses)
// The tables come from build_leaf_bins on the host; the drop-leaf offset is
// added by the caller.  Padding slots have lo = 1 > hi = 0 on feature 0 and
// match no cell.
//
// What bounds it: operations.  The bytes are the cells' features and the
// (m, R) output, plus small tables read from shared memory; the work is
// cells x slots membership tests (2p compares each) and R adds, 1e12-1e13 of
// them for a raster pass of a gbm forest.
//
// Design: the membership test runs on packed bytes (SIMD within a register).
// A slot's bounds are packed four features to a 32-bit word, lo as bytes lo_f
// and hi as bytes 0x80 | hi_f; a cell's bins likewise as B = 0x80 | bin_f and
// Bn = bin_f.  Bins and bounds are < 128, so each byte of B - LO is
// 0x80 + bin - lo and of HI - Bn is 0x80 + hi - bin, in [1, 255]: no borrow
// crosses a byte, and the byte's top bit is set exactly when the bound holds.
// A slot matches when ((B - LO) & (HI - Bn)) keeps every top bit of every
// word: 4W + 2 integer operations for up to 4W features, no branches.
// Unused bytes of the last word hold lo = 0 and hi = 0xFF and always pass.
// Each thread owns CELLS cells (strided by the block size, so loads and
// stores of a warp are close together) with their packed bins and R float32
// accumulators in registers; the block stages CHUNK slots of the tables in
// shared memory, which every thread reads as broadcasts.  Sums run in slot
// order, without atomics.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 4;
constexpr int CHUNK = 512;
constexpr int MAX_FEAT = 16;   // W <= 4 words
constexpr int MAX_EDGES = 128;
constexpr uint32_t GUARD = 0x80808080u;

template <int W, int R>
__global__ void __launch_bounds__(THREADS)
forest_kernel(const float* __restrict__ x, const float* __restrict__ etab,
              const uint32_t* __restrict__ lo_w, const uint32_t* __restrict__ hi_w,
              const float* __restrict__ wv, float* __restrict__ out,
              int m, int p, int b_pad, int n_slots) {
  __shared__ float s_edges[MAX_FEAT * MAX_EDGES];
  __shared__ uint32_t s_lo[CHUNK * W];
  __shared__ uint32_t s_hi[CHUNK * W];
  __shared__ float s_wv[CHUNK * R];

  for (int j = threadIdx.x; j < p * b_pad; j += THREADS) s_edges[j] = etab[j];
  __syncthreads();

  const int base = blockIdx.x * (THREADS * CELLS) + threadIdx.x;
  uint32_t bg[CELLS][W], bn[CELLS][W];
  float acc[CELLS][R];
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int cell = min(base + q * THREADS, m - 1);
#pragma unroll
    for (int k = 0; k < W; ++k) { bg[q][k] = GUARD; bn[q][k] = 0u; }
    for (int f = 0; f < p; ++f) {
      const float xv = x[(size_t)cell * p + f];
      const float* e = s_edges + f * b_pad;
      uint32_t cnt = 0;
      for (int j = 0; j < b_pad; ++j) cnt += (xv > e[j]) ? 1u : 0u;
      const int sh = 8 * (f & 3);
#pragma unroll
      for (int k = 0; k < W; ++k) {
        if (k == (f >> 2)) { bg[q][k] |= cnt << sh; bn[q][k] |= cnt << sh; }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = 0.0f;
  }

  for (int s0 = 0; s0 < n_slots; s0 += CHUNK) {
    const int len = min(CHUNK, n_slots - s0);
    __syncthreads();
    for (int j = threadIdx.x; j < len * W; j += THREADS) {
      s_lo[j] = lo_w[(size_t)s0 * W + j];
      s_hi[j] = hi_w[(size_t)s0 * W + j];
    }
    for (int j = threadIdx.x; j < len * R; j += THREADS) s_wv[j] = wv[(size_t)s0 * R + j];
    __syncthreads();
#pragma unroll 2
    for (int s = 0; s < len; ++s) {
      uint32_t lo[W], hi[W];
#pragma unroll
      for (int k = 0; k < W; ++k) { lo[k] = s_lo[s * W + k]; hi[k] = s_hi[s * W + k]; }
      float v[R];
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = s_wv[s * R + r];
#pragma unroll
      for (int q = 0; q < CELLS; ++q) {
        uint32_t ok = GUARD;
#pragma unroll
        for (int k = 0; k < W; ++k) ok &= (bg[q][k] - lo[k]) & (hi[k] - bn[q][k]);
        const bool match = ok == GUARD;
#pragma unroll
        for (int r = 0; r < R; ++r) acc[q][r] += match ? v[r] : 0.0f;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int cell = base + q * THREADS;
    if (cell < m) {
#pragma unroll
      for (int r = 0; r < R; ++r) out[(size_t)cell * R + r] = acc[q][r];
    }
  }
}

template <int W, int R>
cudaError_t launch(const float* x, const float* etab, const uint32_t* lo, const uint32_t* hi,
                   const float* wv, float* out, int m, int p, int b_pad, int n_slots, cudaStream_t s) {
  const int per_block = THREADS * CELLS;
  const int blocks = (m + per_block - 1) / per_block;
  forest_kernel<W, R><<<blocks, THREADS, 0, s>>>(x, etab, lo, hi, wv, out, m, p, b_pad, n_slots);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_r(int n_resp, const float* x, const float* etab, const uint32_t* lo, const uint32_t* hi,
                     const float* wv, float* out, int m, int p, int b_pad, int n_slots, cudaStream_t s) {
  switch (n_resp) {
    case 1: return launch<W, 1>(x, etab, lo, hi, wv, out, m, p, b_pad, n_slots, s);
    case 2: return launch<W, 2>(x, etab, lo, hi, wv, out, m, p, b_pad, n_slots, s);
    case 3: return launch<W, 3>(x, etab, lo, hi, wv, out, m, p, b_pad, n_slots, s);
    case 4: return launch<W, 4>(x, etab, lo, hi, wv, out, m, p, b_pad, n_slots, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (m, p) float32 cells; etab (p, b_pad) float32 sorted edges (+inf pad,
// b_pad <= 128, at most 127 finite); lo_w, hi_w (n_slots, n_words) packed
// bounds; wv (n_slots, n_resp) float32; out (m, n_resp) float32.  Contiguous,
// on the device of `stream`; 1 <= n_words <= 4, p <= 4 n_words,
// 1 <= n_resp <= 4.  Returns the launch's cudaError_t.
extern "C" int forest_predict_launch(const void* x, const void* etab, const void* lo_w, const void* hi_w,
                                     const void* wv, void* out, int m, int p, int b_pad, int n_slots,
                                     int n_words, int n_resp, void* stream) {
  if (m <= 0 || p <= 0 || n_words < 1 || n_words > 4 || p > 4 * n_words || b_pad <= 0 ||
      b_pad > MAX_EDGES || n_slots < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float* xx = static_cast<const float*>(x);
  const float* e = static_cast<const float*>(etab);
  const uint32_t* lo = static_cast<const uint32_t*>(lo_w);
  const uint32_t* hi = static_cast<const uint32_t*>(hi_w);
  const float* v = static_cast<const float*>(wv);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: return (int)launch_r<1>(n_resp, xx, e, lo, hi, v, o, m, p, b_pad, n_slots, s);
    case 2: return (int)launch_r<2>(n_resp, xx, e, lo, hi, v, o, m, p, b_pad, n_slots, s);
    case 3: return (int)launch_r<3>(n_resp, xx, e, lo, hi, v, o, m, p, b_pad, n_slots, s);
    case 4: return (int)launch_r<4>(n_resp, xx, e, lo, hi, v, o, m, p, b_pad, n_slots, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
