// Kernel K3: weighted forest prediction by leaf bin-intervals.
//
// Replaces machisplin_tpu/ops/pallas_forest.py::_kernel (launched from
// _predict_impl / forest_predict_bins).  For every cell i with features
// x[i, 0..p) and every leaf slot s of the tables build_leaf_bins makes:
//   bin_f(i) = #{ e : etab[f, e] < x[i, f] }             (edges, +inf padded)
//   member   = lo[s, f] <= bin_f(i) <= hi[s, f] for every feature f
//   out[i, r] = sum_s member * wv[s, r]                   (r < R responses)
// The drop-leaf offset is added by the caller.  A cell lies in at most one
// leaf of each tree, so the kernel sums the same terms tree by tree, in two
// loops chosen by the tree's shape (the host decides, ops/forest.py):
//
// 1. Outcome tables, for trees of S <= 6 split nodes when p <= 8.  A tree's
//    descriptor holds, for split node j, a byte selector of its feature and
//    the byte k_j + 1 of its bin threshold (left iff bin <= k_j); its value
//    table holds 2^S rows of R floats, row u being wv of the leaf reached by
//    going right at node j iff bit j of u (zeros for the dropped leaf).  The
//    cell's bins are packed as bytes 0x80 | bin_f, features 0-3 in word 0
//    and 4-7 in word 1.  Per (cell, tree): two byte permutes (prmt) gather
//    the nodes' bytes, two subtractions of the k_j + 1 bytes leave each byte's top bit
//    set exactly when bin > k_j (0x80 + bin - k - 1 lies in [1, 255]: no
//    borrow crosses a byte; an unused node has 0x80 and gives bit 0), a
//    shift, two masks and one multiply fold the eight top bits into u, and
//    one shared-memory load reads the row: ten integer instructions, the
//    load and R float adds.
// 2. Slot membership, for the other trees' slots only (deeper trees, or
//    every tree when p > 8): bounds packed four features a word, lo as bytes
//    lo_f and hi as bytes 0x80 | hi_f; with B = 0x80 | bin_f and Bn = bin_f,
//    a slot matches when ((B - LO) & (HI - Bn)) keeps every top bit:
//    4W + 2 integer operations a slot.
//
// What bounds it: operations on the integer pipe (the bytes are the cells'
// features, the (m, R) output and tables that stay in L2).  Each thread owns
// CELLS cells (strided by the block size, so a warp's loads and stores are
// close together) with their packed bins and R float32 accumulators in
// registers; the block streams chunks of descriptors and value tables (or of
// slots) through shared memory, read as broadcasts except the row lookup.
// Loop bounds depend only on the tables, so no warp diverges.  Sums run in
// tree order, then slot order, without atomics.
//
// ptxas (nvcc -Xptxas -v, sm_90a, -O3, CUDA 12.8), the main path's instance
// (W = 2 words, R = 2, 256 threads x 5 cells): 80 registers, no spills, no
// stack, 45,056 bytes of static shared memory (8 KB of edges and a 36 KB
// stage buffer), so three blocks an SM.  The block shape was measured with
// tools/block_tune.py; chip_smoke.py prints ptxas' summary when it builds.
#include <cuda_runtime.h>
#include <cstdint>

namespace {

#ifndef K3_THREADS
#define K3_THREADS 256
#endif
#ifndef K3_CELLS
#define K3_CELLS 5
#endif
constexpr int THREADS = K3_THREADS;   // tools/block_tune.py builds other values
constexpr int CELLS = K3_CELLS;
constexpr int MAX_FEAT = 16;        // W <= 4 words
constexpr int MAX_EDGES = 128;
constexpr int TAB_FEAT = 8;         // the table loop gathers from two words
constexpr int S_MAX = 6;            // split nodes of a tabled tree
constexpr int MAX_CHUNK_TREES = 256;
constexpr int TAB_FLOATS = 8192;    // value-table floats staged per chunk
constexpr int SLOT_CHUNK = 512;
constexpr int BUF_WORDS = 4 * MAX_CHUNK_TREES + TAB_FLOATS;
constexpr uint32_t GUARD = 0x80808080u;

// prmt without __byte_perm's masking of the selector: every nibble is < 8
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t d;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(sel));
  return d;
}

template <int R>
__device__ __forceinline__ void add_row(float (&acc)[R], const float* v) {
  if constexpr (R == 2) {
    const float2 t = *reinterpret_cast<const float2*>(v);
    acc[0] += t.x;
    acc[1] += t.y;
  } else if constexpr (R == 4) {
    const float4 t = *reinterpret_cast<const float4*>(v);
    acc[0] += t.x;
    acc[1] += t.y;
    acc[2] += t.z;
    acc[3] += t.w;
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] += v[r];
  }
}

template <int W, int R>
__global__ void __launch_bounds__(THREADS)
forest_kernel(const float* __restrict__ x, const float* __restrict__ etab,
              const uint4* __restrict__ desc, const float* __restrict__ vtab,
              const uint32_t* __restrict__ lo_w, const uint32_t* __restrict__ hi_w,
              const float* __restrict__ wv, float* __restrict__ out,
              int m, int p, int b_pad, int n_tab, int log2_rows, int n_slots) {
  __shared__ float s_edges[MAX_FEAT * MAX_EDGES];
  // one buffer for either loop's stage
  __shared__ __align__(16) uint32_t s_buf[BUF_WORDS];

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
#pragma unroll
    for (int f = 0; f < 4 * W; ++f) {
      if (f < p) {
        const float xv = x[(size_t)cell * p + f];
        const float* e = s_edges + f * b_pad;
        uint32_t cnt = 0;
        for (int j = 0; j < b_pad; ++j) cnt += (xv > e[j]) ? 1u : 0u;
        bg[q][f >> 2] |= cnt << (8 * (f & 3));
        bn[q][f >> 2] |= cnt << (8 * (f & 3));
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = 0.0f;
  }

  // 1. outcome tables
  if (n_tab > 0) {
    const int row_floats = R << log2_rows;
    const int chunk = min(MAX_CHUNK_TREES, TAB_FLOATS / row_floats);
    uint4* s_desc = reinterpret_cast<uint4*>(s_buf);
    float* s_val = reinterpret_cast<float*>(s_buf + 4 * MAX_CHUNK_TREES);
    uint32_t b1[CELLS];
#pragma unroll
    for (int q = 0; q < CELLS; ++q) b1[q] = W > 1 ? bg[q][W > 1 ? 1 : 0] : GUARD;
    for (int t0 = 0; t0 < n_tab; t0 += chunk) {
      const int len = min(chunk, n_tab - t0);
      const int n_val = len * row_floats;
      const float* src = vtab + (size_t)t0 * row_floats;
      __syncthreads();
      for (int j = threadIdx.x; j < len; j += THREADS) s_desc[j] = desc[t0 + j];
      if ((row_floats & 3) == 0) {
        const float4* s4 = reinterpret_cast<const float4*>(src);
        float4* d4 = reinterpret_cast<float4*>(s_val);
        for (int j = threadIdx.x; j < n_val / 4; j += THREADS) d4[j] = s4[j];
      } else {
        for (int j = threadIdx.x; j < n_val; j += THREADS) s_val[j] = src[j];
      }
      __syncthreads();
#pragma unroll 2
      for (int i = 0; i < len; ++i) {
        const uint4 d = s_desc[i];
        const float* v = s_val + i * row_floats;
#pragma unroll
        for (int q = 0; q < CELLS; ++q) {
          // top bit of byte j: go right at node j (nodes 0-3 in g0, 4-7 in g1)
          const uint32_t g0 = prmt(bg[q][0], b1[q], d.x) - d.z;
          const uint32_t g1 = prmt(bg[q][0], b1[q], d.y) - d.w;
          // g0's top bits to bit 3 of their bytes, g1's stay at bit 7; the
          // multiply moves bit 8j+3 to 24+j and bit 8j+7 to 28+j, and its
          // other partial products land below bit 24 or above bit 31
          const uint32_t bits = ((g0 >> 4) & 0x08080808u) | (g1 & 0x80808080u);
          const uint32_t u = (bits * 0x00204081u) >> 24;
          add_row<R>(acc[q], v + u * R);
        }
      }
    }
  }

  // 2. slot membership for the other trees
  if (n_slots > 0) {
    uint32_t* s_lo = s_buf;
    uint32_t* s_hi = s_buf + SLOT_CHUNK * W;
    float* s_wv = reinterpret_cast<float*>(s_buf + 2 * SLOT_CHUNK * W);
    for (int s0 = 0; s0 < n_slots; s0 += SLOT_CHUNK) {
      const int len = min(SLOT_CHUNK, n_slots - s0);
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

struct Args {
  const float* x;
  const float* etab;
  const uint4* desc;
  const float* vtab;
  const uint32_t* lo;
  const uint32_t* hi;
  const float* wv;
  float* out;
  int m, p, b_pad, n_tab, log2_rows, n_slots;
};

template <int W, int R>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int per_block = THREADS * CELLS;
  const int blocks = (a.m + per_block - 1) / per_block;
  forest_kernel<W, R><<<blocks, THREADS, 0, s>>>(a.x, a.etab, a.desc, a.vtab, a.lo, a.hi, a.wv, a.out, a.m, a.p,
                                                 a.b_pad, a.n_tab, a.log2_rows, a.n_slots);
  return cudaGetLastError();
}

template <int W>
cudaError_t launch_r(int n_resp, const Args& a, cudaStream_t s) {
  switch (n_resp) {
    case 1: return launch<W, 1>(a, s);
    case 2: return launch<W, 2>(a, s);
    case 3: return launch<W, 3>(a, s);
    case 4: return launch<W, 4>(a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// x (m, p) float32 cells; etab (p, b_pad) float32 sorted edges (+inf pad,
// b_pad <= 128, at most 127 finite); desc (n_tab, 4) uint32 and vtab
// (n_tab, 2^log2_rows, n_resp) float32 outcome tables (n_tab = 0 unless
// p <= 8; log2_rows <= 6); lo_w, hi_w (n_slots, n_words) packed bounds and
// wv (n_slots, n_resp) float32 of the other trees' slots; out (m, n_resp)
// float32.  Contiguous, on the device of `stream`; 1 <= n_words <= 4,
// p <= 4 n_words, 1 <= n_resp <= 4.  Returns the launch's cudaError_t.
extern "C" int forest_predict_launch(const void* x, const void* etab, const void* desc, const void* vtab,
                                     const void* lo_w, const void* hi_w, const void* wv, void* out, int m, int p,
                                     int b_pad, int n_tab, int log2_rows, int n_slots, int n_words, int n_resp,
                                     void* stream) {
  if (m <= 0 || p <= 0 || n_words < 1 || n_words > 4 || p > 4 * n_words || b_pad <= 0 ||
      b_pad > MAX_EDGES || n_slots < 0 || n_tab < 0 || log2_rows < 0 || log2_rows > S_MAX ||
      (n_tab > 0 && p > TAB_FEAT)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{static_cast<const float*>(x), static_cast<const float*>(etab), static_cast<const uint4*>(desc),
               static_cast<const float*>(vtab), static_cast<const uint32_t*>(lo_w),
               static_cast<const uint32_t*>(hi_w), static_cast<const float*>(wv), static_cast<float*>(out),
               m, p, b_pad, n_tab, log2_rows, n_slots};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_words) {
    case 1: return (int)launch_r<1>(n_resp, a, s);
    case 2: return (int)launch_r<2>(n_resp, a, s);
    case 3: return (int)launch_r<3>(n_resp, a, s);
    case 4: return (int)launch_r<4>(n_resp, a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
