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
// n * epochs steps of a lane run one after another (97,560 at the CV shape,
// 20 lanes x 813 rows x 120 sweeps, where the card could do the whole work
// in ~0.05 ms).  The design keeps the dot product off that chain.
//
// Design: one block per lane; warp 0 runs the chain, the other UPD warps
// feed it.  The coordinates go in chunks of 32, one per lane of warp 0.
// - Chain warp, chunk c: lane l holds g_l = q[i0 + l] . theta for its
//   coordinate, exact at the chunk's start.  A step is scalar work that
//   every lane repeats on the same values (so no broadcast of the result
//   is needed), then each lane adds its row's share of the step's change,
//   g_l += q[i0 + k][i0 + l] * delta_k: the residual kept current within
//   the chunk, as libsvm's SMO keeps its gradient (q is symmetric).  The
//   next coordinate's g is shuffled one step ahead, so the chain of a step
//   is ~10 dependent floating-point instructions: no reduction, no barrier.
// - Updater warps, during chunk c: the exact partial sums
//   q[k][i1 + l] * theta_k of the next chunk (start i1) over every row k
//   outside chunk c, each warp over its own whole chunks of rows, in
//   ascending order, skipping theta_k = 0 (bit-exact: such terms add 0; a
//   mask word per chunk of rows, written by the chain warp's ballot, says
//   which); and the next chunk's constants and its two 32 x 32 blocks of q.
//   Chunk c's own rows reach the next chunk through the chain warp: lane l
//   adds q[i0 + k][i1 + l] * theta_k(new) as each step ends.  The rows come
//   by cp.async into the warp's buffer, every copy of a batch in flight at
//   once (plain loads into registers were scheduled next to their use, a
//   few in flight); at the CV shape one batch covers a warp's rows, so a
//   chunk waits one memory round trip, beside the chain's 32 steps.
// - One barrier a chunk (not a step) hands the stage over;
//   the stages are double-buffered.
// So g is recomputed from q and theta at every chunk: no drift builds up
// across a sweep.  q is read once a sweep, the rows of nonzero theta only,
// as 128-byte row segments; 20 x 813^2 x 4 B = 52.9 MB exceeds the H100's
// 50 MB L2, so part of it comes from HBM each sweep.  Sums run in another
// order than the plain version's, so the two agree to a tolerance, not bit
// for bit.
//
// Where theta lives (the template's GLOBAL_THETA): in shared memory beside
// the stages and the row buffers while n fits (ops/svm_sweep.py's max_rows:
// 21,152 rows in float32, 8,000 in float64); above that in the lane's own
// slice of theta_out, theta_out + lane * n, in device memory (L2-resident:
// 96 KB at 24,576 float32 rows).  Only the address changes: the nonzero masks
// stay in shared memory (4 B per 32 rows), and every step and sum is the
// same, so the two layouts give the same theta and lam bit for bit.  The
// chain warp writes theta and the updaters read it after the barrier, so it
// is read through plain coherent loads only: no __ldg, no const __restrict__
// alias (a non-coherent LDG would hand the updaters a stale theta).
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int CH = 32;                       // coordinates a chunk: warp 0's lanes
constexpr int UPD = THREADS / 32 - 1;        // updater warps (ops/svm_sweep.py's max_rows counts 15)
constexpr int ROW_BYTES = 8192;              // an updater warp's row buffer
constexpr int SMEM_LIMIT = 232448;           // an H100 block's dynamic shared memory
constexpr unsigned FULL = 0xffffffffu;

// The block's barrier 0, reached from the two roles' own code: the form
// without .aligned, which threads may reach at different instructions.
__device__ __forceinline__ void role_sync() { asm volatile("barrier.sync 0;" ::: "memory"); }

// one coordinate's constants: y, w, diag, w / max(diag, 1e-12), eps w, mu w, C w
template <typename T>
struct __align__(16) Coord {
  T y, w, d, invw, ew, mw, cw, pad;
};

// what the updaters hand to the chain warp for one chunk (start i0; i1 the next chunk's start)
template <typename T>
struct Stage {
  Coord<T> co[CH];
  T qd[CH][CH];      // qd[k][l] = q[i0 + k][i0 + l]
  T qx[CH][CH];      // qx[k][l] = q[i0 + k][i1 + l]
  T part[UPD][CH];   // updater u's sum of q[k][i0 + l] * theta_k over its rows k
};

// cp.async of one T from global to shared memory when `on`: no register
// holds the value, so every copy of a batch is in flight at once.
template <typename T>
__device__ __forceinline__ void cp_async(unsigned dst, const T* src, bool on = true) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async of 4 or 8 bytes");
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p cp.async.ca.shared.global [%0], [%1], %3;\n}"
      ::"r"(dst), "l"(src), "r"((int)on), "n"((int)sizeof(T)) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;" ::: "memory");
}
template <typename T>
__device__ __forceinline__ unsigned smem_addr(const T* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Updater warp u stages chunk `cn` into `st`: its two blocks, its constants and
// the partial sums over its chunks of rows except chunk `cex`, the one the
// chain warp runs now; `th` is the lane's theta, in either layout.  Rows of
// theta = 0 are left out by the chunks' nonzero masks `nz`, so a row costs a
// bit test.  The rows come by cp.async into the warp's buffer `buf` (ROWS rows
// of 32 columns), a batch at a time, each lane its own column: at the CV shape
// one batch covers a warp's rows in float32.
template <typename T>
__device__ void stage_chunk(Stage<T>& st, T* buf, const T* __restrict__ ql, const T* __restrict__ yl,
                            const T* __restrict__ wl, const T* __restrict__ dl, const T* th,
                            const unsigned* nz, int n, int chunks, int cn, int cex, int u, int lane, T c_reg, T eps,
                            T mu) {
  constexpr int ROWS = ROW_BYTES / sizeof(T) / CH;
  constexpr int WRD = ROWS / CH;                    // chunks of rows a batch
  const int i1 = cn * CH;
  const int i2 = (cn + 1 == chunks ? 0 : cn + 1) * CH;
  const int kc = i1 + lane;
  const bool colok = kc < n;
  for (int r = u; r < CH; r += UPD) {
    const int row = i1 + r, cx = i2 + lane;
    if (row < n && colok) cp_async(smem_addr(&st.qd[r][lane]), ql + (size_t)row * n + kc);
    else st.qd[r][lane] = T(0);
    if (row < n && cx < n) cp_async(smem_addr(&st.qx[r][lane]), ql + (size_t)row * n + cx);
    else st.qx[r][lane] = T(0);
  }
  const bool consts = u == UPD - 1;
  if (consts && colok) {
    cp_async(smem_addr(&st.co[lane].y), yl + kc);
    cp_async(smem_addr(&st.co[lane].w), wl + kc);
    cp_async(smem_addr(&st.co[lane].d), dl + kc);
  }

  const int cpw = (chunks + UPD - 1) / UPD;        // chunks of rows a warp sums
  const int g0 = u * cpw, g1 = min(chunks, g0 + cpw);
  const T* qc = ql + (colok ? kc : 0);
  const unsigned sb = smem_addr(buf + lane);
  T acc = T(0);
  for (int gb = g0; gb < g1; gb += WRD) {
    unsigned bits[WRD];
#pragma unroll
    for (int i = 0; i < WRD; ++i) bits[i] = gb + i < g1 && gb + i != cex && colok ? nz[gb + i] : 0u;
    const T* p = qc + (size_t)gb * CH * n;
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      cp_async(sb + m * CH * sizeof(T), p + (size_t)m * n, (bits[m / CH] >> (m % CH)) & 1u);
    cp_async_wait_all();                            // this lane's copies (rows, blocks, constants) have landed
#pragma unroll
    for (int m = 0; m < ROWS; ++m)
      if ((bits[m / CH] >> (m % CH)) & 1u) acc = fma(buf[m * CH + lane], th[gb * CH + m], acc);
  }
  cp_async_wait_all();                              // a warp with no rows: its blocks and constants
  st.part[u][lane] = acc;
  if (consts) {
    if (colok) {
      Coord<T>& c = st.co[lane];
      const T w = c.w;
      c.invw = (T(1) / fmax(c.d, T(1e-12))) * w;
      c.ew = eps * w;
      c.mw = mu * w;
      c.cw = c_reg * w;
    } else {
      st.co[lane] = Coord<T>{T(0), T(0), T(1), T(0), T(0), T(0), T(0), T(0)};
    }
  }
}

#ifdef K4_PROBE
// Block 0's clock64 cycles, summed over phases: [0] the chain warp's work,
// [1] its wait for the stage, [2] phases, [3 + u] updater warp u's work.
__device__ unsigned long long k4_probe[3 + UPD];
// the clock, read after `dep` is computed and after earlier memory accesses
__device__ __forceinline__ long long clock_after(float dep) {
  long long t;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(t) : "f"(dep) : "memory");
  return t;
}
#define K4_CLOCK(t, dep) const long long t = clock_after(float(dep))
#else
#define K4_CLOCK(t, dep)
#endif

// theta_out carries no __restrict__: with GLOBAL_THETA it is read back
// after other threads wrote it, so no load of it may be non-coherent.
template <typename T, bool GLOBAL_THETA>
__global__ void __launch_bounds__(THREADS, 1)
svm_sweep_kernel(const T* __restrict__ q, const T* __restrict__ ys, const T* __restrict__ w,
                 const T* __restrict__ diag, T* theta_out, T* __restrict__ lam_out,
                 int n, int epochs, T c_reg, T eps, T mu) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Stage<T>* stage = reinterpret_cast<Stage<T>*>(smem_raw);
  const int chunks = (n + CH - 1) / CH;
  T* rowbuf = reinterpret_cast<T*>(stage + 2);                // UPD buffers of ROW_BYTES
  T* after = rowbuf + UPD * ROW_BYTES / sizeof(T);
  const size_t ln = blockIdx.x;
  // the lane's theta: whole chunks in shared memory, or its slice of theta_out
  T* theta_l = GLOBAL_THETA ? theta_out + ln * n : after;
  unsigned* nz = reinterpret_cast<unsigned*>(GLOBAL_THETA ? after : after + chunks * CH);   // chunk c's bit l: theta_{32 c + l} != 0

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* ql = q + ln * n * n;
  const T* yl = ys + ln * n;
  const T* wl = w + ln * n;
  const T* dl = diag + ln * n;
  const int phases = epochs * chunks;
  for (int j = tid; j < n; j += THREADS) theta_l[j] = T(0);
  for (int j = tid; j < chunks; j += THREADS) nz[j] = 0u;
  __syncthreads();

  // Both roles pass the same 1 + phases barriers.
  if (warp == 0) {
    T s = T(0), lam = T(0), b = T(0);
    role_sync();                                      // chunk 0 staged
    int c = 0;
#ifdef K4_PROBE
    long long tlast = clock_after(0.f);
#endif
    for (int ph = 0; ph < phases; ++ph) {
      const Stage<T>& st = stage[ph & 1];
      const int i0 = c * CH, m = min(CH, n - i0);
      T g = st.part[0][lane];
      K4_CLOCK(t0, g);                                // after the barrier has released the stage
#pragma unroll
      for (int u = 1; u < UPD; ++u) g += st.part[u][lane];
      g += b;                                         // the previous chunk's rows, theta as updated
      b = T(0);
      const T th0 = lane < m ? theta_l[i0 + lane] : T(0);
      T thn = th0;
      T gk = __shfl_sync(FULL, g, 0);                 // this step's g
      T pre = __shfl_sync(FULL, g, 1);                // the next coordinate's g before this step's change
      Coord<T> co = st.co[0];
      T thk = __shfl_sync(FULL, th0, 0);
      for (int k = 0; k < m; ++k) {
        const int kn = (k + 1) & (CH - 1);
        const Coord<T> con = st.co[kn];               // the next step's operands, a step early
        const T thkn = __shfl_sync(FULL, th0, kn);
        const T qn = st.qd[k][kn];
        const T a = fma(co.y - lam, co.w, co.d * thk);
        const T z = a - fma(co.mw, s, gk);
        const T t = fmin(fmax(z, -co.ew), co.ew);     // z - t: the soft threshold of z at eps w
        const T cand = fmin(fmax((z - t) * co.invw, -co.cw), co.cw);
        const T dk = cand - thk;
        s = s + dk;
        if (lane == k) thn = cand;
        g = fma(st.qd[k][lane], dk, g);
        b = fma(st.qx[k][lane], cand, b);
        const T pre2 = __shfl_sync(FULL, g, (k + 2) & (CH - 1));
        gk = fma(qn, dk, pre);                        // the next coordinate's g, as its lane computes it
        pre = pre2;
        co = con;
        thk = thkn;
      }
      if (lane < m) theta_l[i0 + lane] = thn;
      const unsigned nzm = __ballot_sync(FULL, lane < m && thn != T(0));
      if (lane == 0) nz[c] = nzm;
      if (++c == chunks) {
        c = 0;
        lam = lam + mu * s;
      }
      K4_CLOCK(t1, s);
      role_sync();
#ifdef K4_PROBE
      if (blockIdx.x == 0 && lane == 0) {
        k4_probe[0] += t1 - t0;
        k4_probe[1] += t0 - tlast;                    // the wait before this chunk
        k4_probe[2] += 1;
      }
      tlast = t1;
#endif
    }
    if (lane == 0) lam_out[ln] = lam;
  } else {
    const int u = warp - 1;
    T* buf = rowbuf + u * ROW_BYTES / sizeof(T);
    stage_chunk(stage[0], buf, ql, yl, wl, dl, theta_l, nz, n, chunks, 0, -1, u, lane, c_reg, eps, mu);
    role_sync();
    int c = 0;
    for (int ph = 0; ph < phases; ++ph) {
      K4_CLOCK(t0, nz[0]);                            // after the barrier has released the masks
      const int cn = c + 1 == chunks ? 0 : c + 1;
#ifndef K4_PROBE_IDLE_UPDATERS                        // a probe: the chain's time alone (results wrong)
      if (ph + 1 < phases) {
        stage_chunk(stage[(ph + 1) & 1], buf, ql, yl, wl, dl, theta_l, nz, n, chunks, cn, c, u, lane, c_reg, eps,
                    mu);
      }
#endif
      c = cn;
#ifdef K4_PROBE
      K4_CLOCK(t1, stage[(ph + 1) & 1].part[u][lane]);
      if (blockIdx.x == 0 && lane == 0) k4_probe[3 + u] += t1 - t0;
#endif
      role_sync();
    }
  }
  if (!GLOBAL_THETA) {
    __syncthreads();
    for (int j = tid; j < n; j += THREADS) theta_out[ln * n + j] = theta_l[j];
  }
}

// the layout's shared memory: two stages, the row buffers, and a mask word
// (with GLOBAL_THETA = false also theta's 32 values) per chunk of 32 rows
template <typename T, bool GLOBAL_THETA>
size_t smem_bytes(int n) {
  return 2 * sizeof(Stage<T>) + (size_t)UPD * ROW_BYTES +
         ((GLOBAL_THETA ? 0 : CH * sizeof(T)) + sizeof(unsigned)) * ((n + CH - 1) / CH);
}

template <typename T, bool GLOBAL_THETA>
cudaError_t launch(const void* q, const void* ys, const void* w, const void* diag, void* theta, void* lam,
                   int lanes, int n, int epochs, double c_reg, double eps, double mu, cudaStream_t s) {
  const size_t smem = smem_bytes<T, GLOBAL_THETA>(n);
  if (smem > SMEM_LIMIT || (long long)epochs * ((n + CH - 1) / CH) > 0x7fffffffLL) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(svm_sweep_kernel<T, GLOBAL_THETA>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  svm_sweep_kernel<T, GLOBAL_THETA><<<lanes, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(ys), static_cast<const T*>(w), static_cast<const T*>(diag),
      static_cast<T*>(theta), static_cast<T*>(lam), n, epochs, T(c_reg), T(eps), T(mu));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_layout(const void* q, const void* ys, const void* w, const void* diag, void* theta, void* lam,
                          int lanes, int n, int epochs, double c_reg, double eps, double mu, int global_theta,
                          cudaStream_t s) {
  return global_theta ? launch<T, true>(q, ys, w, diag, theta, lam, lanes, n, epochs, c_reg, eps, mu, s)
                      : launch<T, false>(q, ys, w, diag, theta, lam, lanes, n, epochs, c_reg, eps, mu, s);
}

}  // namespace

// q (lanes, n, n) symmetric, ys, w, diag (lanes, n), theta (lanes, n), lam
// (lanes): all float32 (is_double = 0) or all float64 (is_double = 1),
// contiguous, on the device of `stream`.  global_theta = 0 keeps each lane's
// theta in shared memory (n within 32 values and a word per chunk of 32 rows
// beside two stages and the row buffers), 1 in theta itself (n within a word
// per chunk); epochs >= 0.  Returns the launch's cudaError_t.
extern "C" int svm_sweep_launch(const void* q, const void* ys, const void* w, const void* diag, void* theta,
                                void* lam, int lanes, int n, int epochs, double c_reg, double eps, double mu,
                                int is_double, int global_theta, void* stream) {
  if (lanes <= 0 || n <= 0 || epochs < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_double
             ? (int)launch_layout<double>(q, ys, w, diag, theta, lam, lanes, n, epochs, c_reg, eps, mu, global_theta, s)
             : (int)launch_layout<float>(q, ys, w, diag, theta, lam, lanes, n, epochs, c_reg, eps, mu, global_theta, s);
}

#ifdef K4_PROBE
// Copies block 0's probe counts (3 + updater warps values) to `out` and zeroes them.
extern "C" int svm_sweep_probe_read(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k4_probe, sizeof(k4_probe));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[3 + UPD] = {};
  return (int)cudaMemcpyToSymbol(k4_probe, zero, sizeof(k4_probe));
}

extern "C" int svm_sweep_probe_size() { return 3 + UPD; }
#endif
