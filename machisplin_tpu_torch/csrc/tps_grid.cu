// Kernel K1: thin-plate-spline surface at every cell of a grid.
//
// Replaces machisplin_tpu/ops/pallas_tps.py::_kernel (launched from
// _compiled_grid_eval / tps_grid_pallas).  For every cell centre
//   gx = xmin + (col + 0.5) dx,  gy = ymax - (row + 0.5) dy,
//   px = (gx - sx0) / sx1,       py = (gy - sy0) / sy1,
// it computes, for each response r,
//   out[r] = sum_k c[r, k] * phi(r2_k) + d[r, 0] px + d[r, 1] py + d[r, 2],
//   r2_k   = (kx_k - px)^2 + (ky_k - py)^2   (explicit differences),
//   phi    = r2 * logf(fmaxf(r2, FLT_MIN))   (the 1/2 is folded into c).
//
// What bounds it: one precise logf per (cell, knot) pair, shared by all R
// responses, plus ~8 + 2R float32 operations around it.  The bytes are only
// the R x cells float32 output and a few KB of tables, so the kernel is
// bound by operations (the log's instruction sequence), not by memory.
//
// Design: each thread owns CELLS cells (strided by the block size, so the
// output stores of a warp are contiguous) and keeps their coordinates and
// R float32 accumulators in registers.  The block stages the knot tables
// through shared memory in chunks of CHUNK knots (kx, ky and the R
// coefficient rows); every thread then reads each staged knot as a
// broadcast, with no bank conflicts.  Knots are padded on the host to a
// multiple of CHUNK with coordinate 0.5 and c = 0, so the inner loop has no
// bounds test.  logf is the precise libm version: no fast-math, no __logf,
// which would break the 2e-4 agreement with the plain version.
#include <cuda_runtime.h>
#include <cfloat>

namespace {

constexpr int THREADS = 256;
constexpr int CELLS = 2;
constexpr int CHUNK = 128;

template <int R>
__global__ void __launch_bounds__(THREADS)
tps_grid_kernel(const float* __restrict__ kxy, const float* __restrict__ c,
                const float* __restrict__ d, float* __restrict__ out,
                int n_pad, int ncols, int n_cells,
                float sx0, float sx1, float sy0, float sy1,
                float xmin, float dx, float ymax, float dy) {
  __shared__ float s_kx[CHUNK];
  __shared__ float s_ky[CHUNK];
  __shared__ float s_c[R][CHUNK];

  const int base = blockIdx.x * (THREADS * CELLS) + threadIdx.x;
  float px[CELLS], py[CELLS], acc[CELLS][R];
#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int cell = min(base + q * THREADS, n_cells - 1);
    const int row = cell / ncols;
    const int col = cell - row * ncols;
    const float gx = xmin + ((float)col + 0.5f) * dx;
    const float gy = ymax - ((float)row + 0.5f) * dy;
    px[q] = (gx - sx0) / sx1;
    py[q] = (gy - sy0) / sy1;
#pragma unroll
    for (int r = 0; r < R; ++r) acc[q][r] = 0.0f;
  }

  for (int k0 = 0; k0 < n_pad; k0 += CHUNK) {
    __syncthreads();
    for (int i = threadIdx.x; i < CHUNK; i += THREADS) {
      s_kx[i] = kxy[k0 + i];
      s_ky[i] = kxy[n_pad + k0 + i];
#pragma unroll
      for (int r = 0; r < R; ++r) s_c[r][i] = c[r * n_pad + k0 + i];
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < CHUNK; ++j) {
      const float kx = s_kx[j];
      const float ky = s_ky[j];
#pragma unroll
      for (int q = 0; q < CELLS; ++q) {
        const float ddx = kx - px[q];
        const float ddy = ky - py[q];
        const float r2 = ddx * ddx + ddy * ddy;
        const float phi = r2 * logf(fmaxf(r2, FLT_MIN));
#pragma unroll
        for (int r = 0; r < R; ++r) acc[q][r] += s_c[r][j] * phi;
      }
    }
  }

#pragma unroll
  for (int q = 0; q < CELLS; ++q) {
    const int cell = base + q * THREADS;
    if (cell < n_cells) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        out[(size_t)r * n_cells + cell] =
            acc[q][r] + (d[r * 3 + 0] * px[q] + d[r * 3 + 1] * py[q] + d[r * 3 + 2]);
      }
    }
  }
}

template <int R>
cudaError_t launch(const float* kxy, const float* c, const float* d, float* out,
                   int n_pad, int nrows, int ncols, const float* g, cudaStream_t stream) {
  const int n_cells = nrows * ncols;
  const int per_block = THREADS * CELLS;
  const int blocks = (n_cells + per_block - 1) / per_block;
  tps_grid_kernel<R><<<blocks, THREADS, 0, stream>>>(
      kxy, c, d, out, n_pad, ncols, n_cells,
      g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7]);
  return cudaGetLastError();
}

}  // namespace

// kxy (2, n_pad), c (n_resp, n_pad), d (n_resp, 3), out (n_resp, nrows, ncols):
// float32, contiguous, on the device of `stream`.  n_pad is a multiple of
// 128 and 1 <= n_resp <= 8.  Returns the launch's cudaError_t.
extern "C" int tps_grid_launch(const void* kxy, const void* c, const void* d, void* out,
                               int n_pad, int n_resp, int nrows, int ncols,
                               float sx0, float sx1, float sy0, float sy1,
                               float xmin, float dx, float ymax, float dy,
                               void* stream) {
  if (n_pad <= 0 || n_pad % CHUNK != 0 || nrows <= 0 || ncols <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const float g[8] = {sx0, sx1, sy0, sy1, xmin, dx, ymax, dy};
  const float* k = static_cast<const float*>(kxy);
  const float* cc = static_cast<const float*>(c);
  const float* dd = static_cast<const float*>(d);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_resp) {
    case 1: return (int)launch<1>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    case 2: return (int)launch<2>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    case 3: return (int)launch<3>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    case 4: return (int)launch<4>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    case 5: return (int)launch<5>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    case 6: return (int)launch<6>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    case 7: return (int)launch<7>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    case 8: return (int)launch<8>(k, cc, dd, o, n_pad, nrows, ncols, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
