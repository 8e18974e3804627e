// Kernel K2: one best-first boosting tree per chain, plus the boosting update.
//
// Replaces machisplin_tpu/ops/pallas_grow.py::_tree_kernel (launched from
// gbm_tree_update).  For every chain c (one row of y, f, w), over bins that
// every chain shares (xbt, p x n bytes, bin < nb):
//   r = y - f, wy = w * r;
//   root: cumulative split stats of all rows, best (feature, bin) by gbm's
//   squared-error gain
//     gain = clwy^2/max(clw,1e-12) + rwy^2/max(rw,1e-12) - twy^2/max(tw,1e-12)
//   over candidates with clw >= min_leaf, rw >= min_leaf and bin < nb - 1
//   (first maximum in flattened (feature, bin) order);
//   n_splits best-first steps: split the node slot of largest gain (first
//   maximum) if its gain exceeds 1e-9, children in slots 2k+1 (bin <= thr)
//   and 2k+2, with exact node totals and the children's best splits;
//   value[s] = swy[s] / max(sw[s], 1e-12);  f_out = f + lr * value[node].
// With emit (feat != NULL) it also writes the tree: feat, thr (bin index),
// internal, left, right, value per node slot and the summed gain per feature.
//
// Split statistics keep the TPU kernel's accuracy class: each row's w and
// w * r are split into bfloat16 hi and lo halves; the halves are summed
// apart in float32 and then added.  Totals (tw, twy, node sums, hence leaf
// values) are exact float32 row sums.  There are no float atomics: every sum
// runs in a fixed order, so two launches on the same inputs give the same
// trees.  Round-to-nearest intrinsics keep nvcc from contracting a*b + c.
//
// What bounds it: neither bytes nor operations in the roofline sense.  A
// chain reads (p + 12) n bytes and writes 4 n, and a tree costs some
// (n_splits + 1) p nb n compare-and-adds, but the n_splits steps depend on
// each other, so a launch is a chain of short block-wide passes separated
// by barriers: latency.
//
// Design: one thread block per chain; everything a chain touches lives in
// shared memory (the rows' bins, their hi/lo parts, exact w and w r, the
// node id of every row, the node and tree tables).  One thread per
// (feature, bin) column walks the rows in order and accumulates the
// cumulative left and parent sums of the rows in the two new children; all
// threads of a warp read the same row at once (a broadcast), and the branch
// on a row's node is uniform across the block.  Argmaxes are warp-shuffle
// reductions that keep the lowest index on a tie.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

constexpr float EPS = 1e-12f;
constexpr int MAX_SPLITS = 127;  // node ids fit in one byte

struct Layout {
  size_t hl, w, wy, gl, gr, ng, nf, nbin, nsw, nswy, tf, tt, ti, tl, tr, vg, red, redi, bins, cur, total;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes, size_t align) {
  off = (off + align - 1) / align * align;
  const size_t at = off;
  off += bytes;
  return at;
}

__host__ __device__ inline Layout make_layout(int n, int p, int nb, int n_total) {
  Layout s;
  size_t off = 0;
  const size_t L = (size_t)p * nb;
  s.hl = take(off, 16 * (size_t)n, 16);      // float4 (w_hi, w_lo, wy_hi, wy_lo)
  s.w = take(off, 4 * (size_t)n, 4);
  s.wy = take(off, 4 * (size_t)n, 4);
  s.gl = take(off, 4 * L, 4);
  s.gr = take(off, 4 * L, 4);
  s.ng = take(off, 4 * (size_t)n_total, 4);  // node gain (then node value)
  s.nf = take(off, 4 * (size_t)n_total, 4);
  s.nbin = take(off, 4 * (size_t)n_total, 4);
  s.nsw = take(off, 4 * (size_t)n_total, 4);
  s.nswy = take(off, 4 * (size_t)n_total, 4);
  s.tf = take(off, 4 * (size_t)n_total, 4);
  s.tt = take(off, 4 * (size_t)n_total, 4);
  s.ti = take(off, 4 * (size_t)n_total, 4);
  s.tl = take(off, 4 * (size_t)n_total, 4);
  s.tr = take(off, 4 * (size_t)n_total, 4);
  s.vg = take(off, 4 * (size_t)p, 4);
  s.red = take(off, 4 * 4 * 32, 4);
  s.redi = take(off, 4 * 32, 4);
  s.bins = take(off, (size_t)p * n, 1);
  s.cur = take(off, (size_t)n, 1);
  s.total = take(off, 0, 16);
  return s;
}

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& g, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(0xffffffffu, g, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(og, oi, g, i)) { g = og; i = oi; }
  }
}

// First maximum of vals[0..len) over the block; every thread gets it.
__device__ void block_argmax(const float* vals, int len, float* s_red, int* s_redi, float& out_g, int& out_i) {
  float g = -CUDART_INF_F;
  int i = INT_MAX;
  for (int j = threadIdx.x; j < len; j += blockDim.x) {
    if (better(vals[j], j, g, i)) { g = vals[j]; i = j; }
  }
  warp_argmax(g, i);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
  if (lane == 0) { s_red[warp] = g; s_redi[warp] = i; }
  __syncthreads();
  if (warp == 0) {
    g = lane < nwarps ? s_red[lane] : -CUDART_INF_F;
    i = lane < nwarps ? s_redi[lane] : INT_MAX;
    warp_argmax(g, i);
    if (lane == 0) { s_red[0] = g; s_redi[0] = i; }
  }
  __syncthreads();
  out_g = s_red[0];
  out_i = s_redi[0];
  __syncthreads();
}

// Block sums of four per-thread partials, in a fixed order.
__device__ void block_sum4(float a[4], float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a[k] = __fadd_rn(a[k], __shfl_down_sync(0xffffffffu, a[k], off));
    if (lane == 0) s_red[k * 32 + warp] = a[k];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      float v = lane < nwarps ? s_red[k * 32 + lane] : 0.0f;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
      if (lane == 0) s_red[k * 32] = v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) a[k] = s_red[k * 32];
  __syncthreads();
}

__device__ __forceinline__ float split_gain(float clw, float clwy, float tw, float twy, bool last_bin, float min_leaf) {
  const float rw = __fsub_rn(tw, clw);
  const float rwy = __fsub_rn(twy, clwy);
  if (!(clw >= min_leaf && rw >= min_leaf) || last_bin) return -CUDART_INF_F;
  const float a = __fdiv_rn(__fmul_rn(clwy, clwy), fmaxf(clw, EPS));
  const float b = __fdiv_rn(__fmul_rn(rwy, rwy), fmaxf(rw, EPS));
  const float c = __fdiv_rn(__fmul_rn(twy, twy), fmaxf(tw, EPS));
  return __fsub_rn(__fadd_rn(a, b), c);
}

__global__ void tree_grow_kernel(const uint8_t* __restrict__ xbt, const float* __restrict__ y,
                                 const float* __restrict__ f, const float* __restrict__ w,
                                 float* __restrict__ f_out, int* __restrict__ o_feat, int* __restrict__ o_thr,
                                 float* __restrict__ o_int, int* __restrict__ o_left, int* __restrict__ o_right,
                                 float* __restrict__ o_value, float* __restrict__ o_vg,
                                 int n, int p, int nb, int n_splits, float min_leaf, float lr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_total = 2 * n_splits + 1;
  const int L = p * nb;
  const Layout lay = make_layout(n, p, nb, n_total);
  float4* s_hl = reinterpret_cast<float4*>(smem + lay.hl);
  float* s_w = reinterpret_cast<float*>(smem + lay.w);
  float* s_wy = reinterpret_cast<float*>(smem + lay.wy);
  float* s_gl = reinterpret_cast<float*>(smem + lay.gl);
  float* s_gr = reinterpret_cast<float*>(smem + lay.gr);
  float* s_ng = reinterpret_cast<float*>(smem + lay.ng);
  int* s_nf = reinterpret_cast<int*>(smem + lay.nf);
  int* s_nb = reinterpret_cast<int*>(smem + lay.nbin);
  float* s_nsw = reinterpret_cast<float*>(smem + lay.nsw);
  float* s_nswy = reinterpret_cast<float*>(smem + lay.nswy);
  int* s_tf = reinterpret_cast<int*>(smem + lay.tf);
  int* s_tt = reinterpret_cast<int*>(smem + lay.tt);
  float* s_ti = reinterpret_cast<float*>(smem + lay.ti);
  int* s_tl = reinterpret_cast<int*>(smem + lay.tl);
  int* s_tr = reinterpret_cast<int*>(smem + lay.tr);
  float* s_vg = reinterpret_cast<float*>(smem + lay.vg);
  float* s_red = reinterpret_cast<float*>(smem + lay.red);
  int* s_redi = reinterpret_cast<int*>(smem + lay.redi);
  uint8_t* s_bins = smem + lay.bins;
  uint8_t* s_cur = smem + lay.cur;

  const size_t row0 = (size_t)blockIdx.x * n;
  const int tid = threadIdx.x, nt = blockDim.x;

  for (int i = tid; i < n; i += nt) {
    const float wi = w[row0 + i];
    const float wyi = __fmul_rn(wi, __fsub_rn(y[row0 + i], f[row0 + i]));
    const __nv_bfloat16 wh = __float2bfloat16_rn(wi);
    const __nv_bfloat16 yh = __float2bfloat16_rn(wyi);
    const float whf = __bfloat162float(wh), yhf = __bfloat162float(yh);
    const float wl = __bfloat162float(__float2bfloat16_rn(__fsub_rn(wi, whf)));
    const float yl = __bfloat162float(__float2bfloat16_rn(__fsub_rn(wyi, yhf)));
    s_hl[i] = make_float4(whf, wl, yhf, yl);
    s_w[i] = wi;
    s_wy[i] = wyi;
    s_cur[i] = 0;
  }
  for (int j = tid; j < p * n; j += nt) s_bins[j] = xbt[j];
  for (int s = tid; s < n_total; s += nt) {
    s_ng[s] = -CUDART_INF_F;
    s_nf[s] = 0; s_nb[s] = 0; s_nsw[s] = 0.0f; s_nswy[s] = 0.0f;
    s_tf[s] = 0; s_tt[s] = 0; s_ti[s] = 0.0f; s_tl[s] = 0; s_tr[s] = 0;
  }
  for (int j = tid; j < p; j += nt) s_vg[j] = 0.0f;
  __syncthreads();

  // ---- root: exact totals, cumulative stats of every row, best split ----
  float tot[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int i = tid; i < n; i += nt) {
    tot[0] = __fadd_rn(tot[0], s_w[i]);
    tot[1] = __fadd_rn(tot[1], s_wy[i]);
  }
  block_sum4(tot, s_red);
  const float tw0 = tot[0], twy0 = tot[1];
  for (int col = tid; col < L; col += nt) {
    const int fc = col / nb, bc = col - fc * nb;
    const uint8_t* bf = s_bins + (size_t)fc * n;
    float hw = 0.0f, lw = 0.0f, hy = 0.0f, ly = 0.0f;
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      if (bf[i] <= bc) {
        const float4 v = s_hl[i];
        hw = __fadd_rn(hw, v.x); lw = __fadd_rn(lw, v.y);
        hy = __fadd_rn(hy, v.z); ly = __fadd_rn(ly, v.w);
      }
    }
    s_gl[col] = split_gain(__fadd_rn(hw, lw), __fadd_rn(hy, ly), tw0, twy0, bc >= nb - 1, min_leaf);
  }
  __syncthreads();
  {
    float g; int idx;
    block_argmax(s_gl, L, s_red, s_redi, g, idx);
    if (tid == 0) {
      s_ng[0] = g; s_nf[0] = idx / nb; s_nb[0] = idx - (idx / nb) * nb;
      s_nsw[0] = tw0; s_nswy[0] = twy0;
    }
    __syncthreads();
  }

  // ---- best-first splits ----
  for (int k = 0; k < n_splits; ++k) {
    float gq; int q;
    block_argmax(s_ng, n_total, s_red, s_redi, gq, q);
    if (!(gq > 1e-9f)) break;  // no node left to split: every later step is a no-op
    const int bfq = s_nf[q], bbq = s_nb[q];
    const int lid = 2 * k + 1, rid = 2 * k + 2;
    const uint8_t* bq = s_bins + (size_t)bfq * n;
    for (int i = tid; i < n; i += nt) {
      if (s_cur[i] == q) s_cur[i] = (uint8_t)(bq[i] <= bbq ? lid : rid);
    }
    __syncthreads();
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // left w, left wy, parent w, parent wy
    for (int i = tid; i < n; i += nt) {
      const int cu = s_cur[i];
      if (cu == lid) { t[0] = __fadd_rn(t[0], s_w[i]); t[1] = __fadd_rn(t[1], s_wy[i]); }
      if (cu == lid || cu == rid) { t[2] = __fadd_rn(t[2], s_w[i]); t[3] = __fadd_rn(t[3], s_wy[i]); }
    }
    block_sum4(t, s_red);
    const float tl_w = t[0], tl_wy = t[1], tp_w = t[2], tp_wy = t[3];
    const float tr_w = __fsub_rn(tp_w, tl_w), tr_wy = __fsub_rn(tp_wy, tl_wy);
    for (int col = tid; col < L; col += nt) {
      const int fc = col / nb, bc = col - fc * nb;
      const uint8_t* bf = s_bins + (size_t)fc * n;
      float lhw = 0.0f, llw = 0.0f, lhy = 0.0f, lly = 0.0f;
      float phw = 0.0f, plw = 0.0f, phy = 0.0f, ply = 0.0f;
#pragma unroll 4
      for (int i = 0; i < n; ++i) {
        const int cu = s_cur[i];
        if (cu == lid || cu == rid) {
          if (bf[i] <= bc) {
            const float4 v = s_hl[i];
            phw = __fadd_rn(phw, v.x); plw = __fadd_rn(plw, v.y);
            phy = __fadd_rn(phy, v.z); ply = __fadd_rn(ply, v.w);
            if (cu == lid) {
              lhw = __fadd_rn(lhw, v.x); llw = __fadd_rn(llw, v.y);
              lhy = __fadd_rn(lhy, v.z); lly = __fadd_rn(lly, v.w);
            }
          }
        }
      }
      const float clw = __fadd_rn(lhw, llw), clwy = __fadd_rn(lhy, lly);
      const float cpw = __fadd_rn(phw, plw), cpwy = __fadd_rn(phy, ply);
      const bool last = bc >= nb - 1;
      s_gl[col] = split_gain(clw, clwy, tl_w, tl_wy, last, min_leaf);
      s_gr[col] = split_gain(__fsub_rn(cpw, clw), __fsub_rn(cpwy, clwy), tr_w, tr_wy, last, min_leaf);
    }
    __syncthreads();
    float gl, gr; int il, ir;
    block_argmax(s_gl, L, s_red, s_redi, gl, il);
    block_argmax(s_gr, L, s_red, s_redi, gr, ir);
    if (tid == 0) {
      s_ng[q] = -CUDART_INF_F;
      s_ng[lid] = gl; s_nf[lid] = il / nb; s_nb[lid] = il - (il / nb) * nb;
      s_ng[rid] = gr; s_nf[rid] = ir / nb; s_nb[rid] = ir - (ir / nb) * nb;
      s_nsw[lid] = tl_w; s_nswy[lid] = tl_wy;
      s_nsw[rid] = tr_w; s_nswy[rid] = tr_wy;
      s_tf[q] = bfq; s_tt[q] = bbq; s_ti[q] = 1.0f; s_tl[q] = lid; s_tr[q] = rid;
      s_vg[bfq] = __fadd_rn(s_vg[bfq], gq);
    }
    __syncthreads();
  }

  // ---- leaf values and the boosting update ----
  for (int s = tid; s < n_total; s += nt) s_ng[s] = __fdiv_rn(s_nswy[s], fmaxf(s_nsw[s], EPS));
  __syncthreads();
  for (int i = tid; i < n; i += nt) {
    f_out[row0 + i] = __fadd_rn(f[row0 + i], __fmul_rn(lr, s_ng[s_cur[i]]));
  }
  if (o_feat != nullptr) {
    const size_t t0 = (size_t)blockIdx.x * n_total;
    for (int s = tid; s < n_total; s += nt) {
      o_feat[t0 + s] = s_tf[s]; o_thr[t0 + s] = s_tt[s]; o_int[t0 + s] = s_ti[s];
      o_left[t0 + s] = s_tl[s]; o_right[t0 + s] = s_tr[s]; o_value[t0 + s] = s_ng[s];
    }
    for (int j = tid; j < p; j += nt) o_vg[(size_t)blockIdx.x * p + j] = s_vg[j];
  }
}

}  // namespace

// Dynamic shared memory a launch of these sizes takes, in bytes.
extern "C" int tree_grow_smem_bytes(int n, int p, int nb, int n_splits) {
  return (int)make_layout(n, p, nb, 2 * n_splits + 1).total;
}

// xbt (p, n) uint8 bins < nb; y, f, w, f_out (n_chains, n) float32; with the
// tree outputs (all non-NULL or all NULL): feat, thr, left, right int32 and
// internal, value float32 (n_chains, 2 n_splits + 1), var_gain float32
// (n_chains, p).  Contiguous, on the device of `stream`.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for unsupported sizes).
extern "C" int tree_grow_launch(const void* xbt, const void* y, const void* f, const void* w,
                                void* f_out, void* feat, void* thr, void* internal, void* left,
                                void* right, void* value, void* var_gain,
                                int n_chains, int n, int p, int nb, int n_splits,
                                float min_leaf, float lr, void* stream) {
  if (n_chains <= 0 || n <= 0 || p <= 0 || nb < 2 || nb > 256 || n_splits < 1 || n_splits > MAX_SPLITS) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_total = 2 * n_splits + 1;
  const size_t smem = make_layout(n, p, nb, n_total).total;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(tree_grow_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols = p * nb;
  int threads = ((cols > 32 ? cols : 32) + 31) / 32 * 32;
  if (threads > 1024) threads = 1024;
  tree_grow_kernel<<<n_chains, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(xbt), static_cast<const float*>(y), static_cast<const float*>(f),
      static_cast<const float*>(w), static_cast<float*>(f_out), static_cast<int*>(feat),
      static_cast<int*>(thr), static_cast<float*>(internal), static_cast<int*>(left),
      static_cast<int*>(right), static_cast<float*>(value), static_cast<float*>(var_gain),
      n, p, nb, n_splits, min_leaf, lr);
  return (int)cudaGetLastError();
}
