// Kernel K1: thin-plate-spline surface at every cell of a grid.
//
// Replaces machisplin_tpu/ops/pallas_tps.py::_kernel (launched from
// _compiled_grid_eval / tps_grid_pallas).  For every cell centre
//   gx = xmin + (col + 0.5) dx,  gy = ymax - (row + 0.5) dy,
//   px = (gx - sx0) / sx1,       py = (gy - sy0) / sy1,
// it computes, for each response r,
//   out[r] = sum_k c[r, k] * phi(r2_k) + d[r, 0] px + d[r, 1] py + d[r, 2],
//   r2_k   = (kx_k - px)^2 + (ky_k - py)^2   (explicit differences),
//   phi    = r2 * log(fmaxf(r2, FLT_MIN))    (the 1/2 is folded into c).
// The host passes only the live knots (a knot budget's padding has c = 0
// and adds nothing), padded with c = 0 to a multiple of UNROLL.
//
// What bounds it: operations.  The bytes are only the R x cells float32
// output and a few KB of tables; the work is one log per (cell, knot) pair,
// shared by all R responses, and ~8 + 2R float32 operations around it.
//
// Design: one launch holds every response of a surface up to MAX_RESP
// (24: the 19 bioclim variables, 12 monthly layers), so phi is computed
// once a (cell, knot) pair and fed to all R accumulators; the wrapper
// slices only above the cap.  A thread holds CELLS cells of one grid row
// (strided by the threads of that row, so a warp's stores are contiguous)
// with R float32 accumulators each in registers; the row's (ky - py)^2 is
// computed once per knot and thread.  A block covers ROWS grid rows of
// THREADS / ROWS threads each.  The block stages the knot tables through
// shared memory in chunks of CHUNK knots (kx, ky and the R coefficient
// rows), which every thread reads as broadcasts (four knots a load).  The
// block shape is a compile-time function of R (Shape<R>): R <= 8, the TPS
// tiles of mltps (R = 1-2), keep one row of 256 threads x 3 cells; R > 8
// takes 128 threads over 4 rows x 4 cells, a warp on 128 columns of one
// row, so a row of 3,163 cells costs 3,200 cell slots, not the 3,840 of
// 768-cell blocks.  The log
// is an explicit range reduction, a = 2^e m with m in [2/3, 4/3): e from
// the exponent bits, turned into a float by adding it to the bits of
// 1.5 * 2^23, and log(m) = f + f^2 q(f), f = m - 1, q a degree-7 polynomial
// (least-squares fit on Chebyshev nodes): within 2 ulp of log on every
// float32 m of [2/3, 4/3) and over [FLT_MIN, 8]
// (tests/test_torch_tps.py::test_k1_log_within_two_ulp emulates it).
// r2 >= FLT_MIN after the clamp, so there are no special cases (zero,
// denormal, negative, infinite or NaN arguments) to handle.  Each output
// sums its knots in the same order whatever R and block shape it is
// launched with, so a surface is bit for bit the same in one launch or in
// slices of its responses.
//
// ptxas (nvcc -Xptxas -v, sm_90a, -O3, CUDA 12.8), R = 2, 256 threads x 3
// cells (the block shape measured best by tools/block_tune.py): 48
// registers, no spills, 2,048 bytes of shared memory (R = 8: 64 registers,
// 12 bytes of spill stores).  R = 19, 128 threads
// x 4 cells x 4 rows: 128 registers, no spills, 10,752 bytes; R = 24: 168
// registers, no spills, 13,312 bytes; no spills from R = 9 to 24.  The
// wide shape, by tools/block_tune.py k1 --resp R on the benchmark cell's
// surface (10,000 knots, 3,163 x 3,163 cells; H100 80GB HBM3, 700 W), ms
// a launch, threads x cells x rows: R = 19 148.4 at 128x4x4 (256x4x8
// 147.8, 512x3x16 154.0, 256x3x8 156.5, 256x2x8 158.3); R = 24 172.1 (256x3x8 178.6, 256x4x8 189.1); R = 12 119.8 and
// R = 14 125.3, the best of four or five; R = 9 110.6 (256x3x8 108.5).
#include <cuda_runtime.h>
#include <cfloat>

namespace {

// tools/block_tune.py builds other shapes: K1_* for R <= NARROW, K1_WIDE_* above
#ifndef K1_THREADS
#define K1_THREADS 256
#endif
#ifndef K1_CELLS
#define K1_CELLS 3
#endif
#ifndef K1_WIDE_THREADS
#define K1_WIDE_THREADS 128
#endif
#ifndef K1_WIDE_CELLS
#define K1_WIDE_CELLS 4
#endif
#ifndef K1_WIDE_ROWS
#define K1_WIDE_ROWS 4
#endif
constexpr int NARROW = 8;     // R <= NARROW keeps the block shape of mltps's TPS tiles
constexpr int MAX_RESP = 24;  // responses a launch holds
constexpr int CHUNK = 128;
constexpr int UNROLL = 4;

// block shape for R responses: THREADS threads over ROWS grid rows, CELLS cells a thread
template <int R>
struct Shape {
  static constexpr bool wide = R > NARROW;
  static constexpr int THREADS = wide ? K1_WIDE_THREADS : K1_THREADS;
  static constexpr int CELLS = wide ? K1_WIDE_CELLS : K1_CELLS;
  static constexpr int ROWS = wide ? K1_WIDE_ROWS : 1;
  static constexpr int ROW_THREADS = THREADS / ROWS;
  static constexpr int COLS = ROW_THREADS * CELLS;  // columns a block covers
  static_assert(THREADS % ROWS == 0 && ROW_THREADS % 32 == 0, "a warp lies in one row");
};

// log(a) for FLT_MIN <= a < inf
__device__ __forceinline__ float log_pos(float a) {
  const int i = __float_as_int(a);
  const int e = (i - 0x3f2aaaab) & (int)0xff800000;          // a = 2^k m, m in [2/3, 4/3)
  const float m = __int_as_float(i - e);
  const float k = __int_as_float((e >> 23) + 0x4b400000) - 12582912.0f;
  const float f = m - 1.0f;
  const float s = f * f;
  float q = 0.14223834872245789f;
  q = fmaf(q, f, -0.1568501591682434f);
  q = fmaf(q, f, 0.13950958847999573f);
  q = fmaf(q, f, -0.16352400183677673f);
  q = fmaf(q, f, 0.20014333724975586f);
  q = fmaf(q, f, -0.2501194179058075f);
  q = fmaf(q, f, 0.33333131670951843f);
  q = fmaf(q, f, -0.4999985992908478f);
  return fmaf(k, 0.693147182f, fmaf(q, s, f));
}

template <int R>
__global__ void __launch_bounds__(Shape<R>::THREADS)
tps_grid_kernel(const float* __restrict__ kxy, const float* __restrict__ c,
                const float* __restrict__ d, float* __restrict__ out,
                int n_knots, int nrows, int ncols,
                float sx0, float sx1, float sy0, float sy1,
                float xmin, float dx, float ymax, float dy) {
  constexpr int THREADS = Shape<R>::THREADS, CELLS = Shape<R>::CELLS, ROWS = Shape<R>::ROWS;
  constexpr int ROW_THREADS = Shape<R>::ROW_THREADS;
  __shared__ float s_kx[CHUNK];
  __shared__ float s_ky[CHUNK];
  __shared__ float s_c[R][CHUNK];

  // a block's last rows past the grid repeat its last row and store nothing
  const int ty = ROWS == 1 ? 0 : threadIdx.x / ROW_THREADS;
  const int tx = ROWS == 1 ? threadIdx.x : threadIdx.x % ROW_THREADS;
  const int row_at = blockIdx.y * ROWS + ty;
  const int row = ROWS == 1 ? row_at : min(row_at, nrows - 1);
  const int col0 = blockIdx.x * Shape<R>::COLS + tx;
  const float py = ((ymax - ((float)row + 0.5f) * dy) - sy0) / sy1;
  float px[CELLS], acc[CELLS][R];
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int col = min(col0 + q * ROW_THREADS, ncols - 1);
    px[q] = ((xmin + ((float)col + 0.5f) * dx) - sx0) / sx1;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = 0.0f;
  }

  for (int k0 = 0; k0 < n_knots; k0 += CHUNK) {
    const int len = min(CHUNK, n_knots - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += THREADS) {
      s_kx[i] = kxy[k0 + i];
      s_ky[i] = kxy[n_knots + k0 + i];
#pragma unroll
      for (int r = 0; r < R; ++r) s_c[r][i] = c[r * n_knots + k0 + i];
    }
    __syncthreads();
    for (int j0 = 0; j0 < len; j0 += UNROLL) {
#pragma unroll
      for (int j = j0; j < j0 + UNROLL; ++j) {
        const float ddy = s_ky[j] - py;
        const float ddy2 = ddy * ddy;
        const float kx = s_kx[j];
#pragma unroll
        for (int q = 0; q < CELLS; ++q) {
          const float ddx = kx - px[q];
          const float r2 = fmaf(ddx, ddx, ddy2);
          const float phi = r2 * log_pos(fmaxf(r2, FLT_MIN));
#pragma unroll
          for (int r = 0; r < R; ++r) acc[q][r] = fmaf(s_c[r][j], phi, acc[q][r]);
        }
      }
    }
  }

  if (ROWS > 1 && row_at >= nrows) return;
  const size_t n_cells = (size_t)nrows * ncols;
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int col = col0 + q * ROW_THREADS;
    if (col < ncols) {
      const size_t cell = (size_t)row * ncols + col;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        out[r * n_cells + cell] = acc[q][r] + (d[r * 3 + 0] * px[q] + d[r * 3 + 1] * py + d[r * 3 + 2]);
      }
    }
  }
}

template <int R>
cudaError_t launch(const float* kxy, const float* c, const float* d, float* out,
                   int n_knots, int nrows, int ncols, const float* g, cudaStream_t stream) {
  using S = Shape<R>;
  const dim3 blocks((ncols + S::COLS - 1) / S::COLS, (nrows + S::ROWS - 1) / S::ROWS);
  tps_grid_kernel<R><<<blocks, S::THREADS, 0, stream>>>(
      kxy, c, d, out, n_knots, nrows, ncols,
      g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7]);
  return cudaGetLastError();
}

// launch<n_resp> for 1 <= n_resp <= MAX_RESP
template <int R = 1>
cudaError_t dispatch(int n_resp, const float* kxy, const float* c, const float* d, float* out,
                     int n_knots, int nrows, int ncols, const float* g, cudaStream_t stream) {
  if (n_resp == R) return launch<R>(kxy, c, d, out, n_knots, nrows, ncols, g, stream);
  if constexpr (R < MAX_RESP) {
    return dispatch<R + 1>(n_resp, kxy, c, d, out, n_knots, nrows, ncols, g, stream);
  } else {
    return cudaErrorInvalidValue;
  }
}

}  // namespace

// kxy (2, n_knots), c (n_resp, n_knots), d (n_resp, 3), out (n_resp, nrows,
// ncols): float32, contiguous, on the device of `stream`.  n_knots is the
// live knot count padded with c = 0 to a multiple of 4; 1 <= n_resp <= 24,
// nrows <= 65535.  Returns the launch's cudaError_t.
extern "C" int tps_grid_launch(const void* kxy, const void* c, const void* d, void* out,
                               int n_knots, int n_resp, int nrows, int ncols,
                               float sx0, float sx1, float sy0, float sy1,
                               float xmin, float dx, float ymax, float dy,
                               void* stream) {
  if (n_knots <= 0 || n_knots % UNROLL != 0 || nrows <= 0 || nrows > 65535 || ncols <= 0 ||
      n_resp < 1 || n_resp > MAX_RESP) {
    return (int)cudaErrorInvalidValue;
  }
  const float g[8] = {sx0, sx1, sy0, sy1, xmin, dx, ymax, dy};
  return (int)dispatch(n_resp, static_cast<const float*>(kxy), static_cast<const float*>(c),
                       static_cast<const float*>(d), static_cast<float*>(out), n_knots, nrows, ncols, g,
                       static_cast<cudaStream_t>(stream));
}
