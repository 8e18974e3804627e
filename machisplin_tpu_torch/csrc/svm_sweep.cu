// Kernel K4: the SVM's augmented-Lagrangian coordinate sweep, every lane's
// whole fit in one launch.
//
// Replaces the sweep of machisplin_tpu/models/svm.py::fit (a lax.scan of
// `epochs` sweeps over a lax.fori_loop of n coordinates, svm.py:121-141):
// not a Pallas kernel, a JAX loop that XLA runs as one program.  For each
// lane (one (response x fold) model), with q the lane's (n, n) masked RBF
// matrix, and per sweep, for i = 0 .. n-1 in order:
//   r_i   = q[i] . theta + mu * s * w_i - diag_i * theta_i
//   z     = (ys_i - lam) * w_i - r_i
//   cand  = sign(z) * max(|z| - eps * w_i, 0)
//   cand  = clip(cand / max(diag_i, 1e-12), -C, C) * w_i
//   s    += cand - theta_i;  theta_i = cand
// and after each sweep lam += mu * s.  Outputs theta (n) and lam.
//
// What bounds it: neither bytes nor operations but the chain of dependent
// steps.  Coordinate i reads theta_0 .. theta_{i-1} of this sweep, so the
// n * epochs steps of a lane run one after another; a step moves one row of
// q (n values) and does 2n + ~15 operations.  At the CV shape (20 lanes x
// 813 rows x 120 sweeps) the card could do the whole work in ~0.05 ms; the
// chain of 97,560 steps of a few hundred cycles each is what it takes.
//
// Design: one block per lane, THREADS threads.  theta, w, ys and diag stay
// in shared memory for the whole fit; the running s and lam are registers,
// computed the same way by every thread.  Thread t owns the coordinates
// j = t (mod THREADS): it alone reads and writes theta_j, so a step needs
// one barrier: the owner of i hands theta_i to the others beside the warp
// partials of q[i] . theta (double-buffered, so the next step's partials
// never overwrite ones still being read).  Row i + 1 of q is loaded into
// registers while step i reduces and updates, which hides the load's
// latency (q stays in L2 when it fits: 20 x 813^2 floats is 53 MB).
// Sums run in the thread's strided order, then a butterfly over the warp,
// then the warps in order: another order than the plain version's, so the
// two agree to a tolerance, not bit for bit.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_PER_THREAD = 32;          // n <= 32 * THREADS = 8192
constexpr int SMEM_LIMIT = 232448;          // an H100 block's dynamic shared memory

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
svm_sweep_kernel(const T* __restrict__ q, const T* __restrict__ ys, const T* __restrict__ w,
                 const T* __restrict__ diag, T* __restrict__ theta_out, T* __restrict__ lam_out,
                 int n, int epochs, T c_reg, T eps, T mu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_theta = reinterpret_cast<T*>(smem_raw);
  T* s_w = s_theta + n;
  T* s_y = s_w + n;
  T* s_d = s_y + n;
  // [buffer][warp partials..., theta_i]
  __shared__ T s_part[2][WARPS + 1];

  const int tid = threadIdx.x;
  const size_t lane = blockIdx.x;
  const T* ql = q + lane * n * n;
  for (int j = tid; j < n; j += THREADS) {
    s_theta[j] = T(0);
    s_w[j] = w[lane * n + j];
    s_y[j] = ys[lane * n + j];
    s_d[j] = diag[lane * n + j];
  }
  __syncthreads();

  T row[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = tid + k * THREADS;
    row[k] = j < n ? ql[j] : T(0);
  }
  T s = T(0), lam = T(0);
  int buf = 0;
  for (int ep = 0; ep < epochs; ++ep) {
    for (int i = 0; i < n; ++i) {
      T acc = T(0);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + k * THREADS;
        if (j < n) acc += row[k] * s_theta[j];
      }
      const int owner = i % THREADS;
      if (tid == owner) s_part[buf][WARPS] = s_theta[i];
      // the next step's row (row 0 after the last), in flight during the reduction
      const T* nr = ql + (size_t)(i + 1 < n ? i + 1 : 0) * n;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int j = tid + k * THREADS;
        row[k] = j < n ? nr[j] : T(0);
      }
      acc = warp_sum(acc);
      if ((tid & 31) == 0) s_part[buf][tid >> 5] = acc;
      __syncthreads();
      T dot = T(0);
#pragma unroll
      for (int k = 0; k < WARPS; ++k) dot += s_part[buf][k];
      const T th = s_part[buf][WARPS];
      const T wi = s_w[i], di = s_d[i];
      const T r = dot + mu * s * wi - di * th;
      const T z = (s_y[i] - lam) * wi - r;
      const T mag = fmax(fabs(z) - eps * wi, T(0));
      T cand = z > T(0) ? mag : (z < T(0) ? -mag : T(0));
      cand = fmin(fmax(cand / fmax(di, T(1e-12)), -c_reg), c_reg) * wi;
      s = s + cand - th;
      if (tid == owner) s_theta[i] = cand;
      buf ^= 1;
    }
    lam = lam + mu * s;
  }
  __syncthreads();
  for (int j = tid; j < n; j += THREADS) theta_out[lane * n + j] = s_theta[j];
  if (tid == 0) lam_out[lane] = lam;
}

template <typename T, int K>
cudaError_t launch_k(const void* q, const void* ys, const void* w, const void* diag, void* theta, void* lam,
                     int lanes, int n, int epochs, double c_reg, double eps, double mu, cudaStream_t s) {
  const int smem = 4 * n * (int)sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(svm_sweep_kernel<T, K>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  svm_sweep_kernel<T, K><<<lanes, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(ys), static_cast<const T*>(w), static_cast<const T*>(diag),
      static_cast<T*>(theta), static_cast<T*>(lam), n, epochs, T(c_reg), T(eps), T(mu));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* ys, const void* w, const void* diag, void* theta, void* lam,
                   int lanes, int n, int epochs, double c_reg, double eps, double mu, cudaStream_t s) {
  const int per_thread = (n + THREADS - 1) / THREADS;
#define K4_CASE(K) \
  if (per_thread <= K) return launch_k<T, K>(q, ys, w, diag, theta, lam, lanes, n, epochs, c_reg, eps, mu, s);
  K4_CASE(1) K4_CASE(2) K4_CASE(4) K4_CASE(8) K4_CASE(16) K4_CASE(32)
#undef K4_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q (lanes, n, n), ys, w, diag (lanes, n), theta (lanes, n), lam (lanes):
// all float32 (is_double = 0) or all float64 (is_double = 1), contiguous, on
// the device of `stream`.  1 <= n <= 8192 with 4 n values within a block's
// shared memory; epochs >= 0.  Returns the launch's cudaError_t.
extern "C" int svm_sweep_launch(const void* q, const void* ys, const void* w, const void* diag, void* theta,
                                void* lam, int lanes, int n, int epochs, double c_reg, double eps, double mu,
                                int is_double, void* stream) {
  const int elem = is_double ? 8 : 4;
  if (lanes <= 0 || n <= 0 || epochs < 0 || n > MAX_PER_THREAD * THREADS || 4 * n * elem > SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double ? (int)launch<double>(q, ys, w, diag, theta, lam, lanes, n, epochs, c_reg, eps, mu, s)
                   : (int)launch<float>(q, ys, w, diag, theta, lam, lanes, n, epochs, c_reg, eps, mu, s);
}
