// Kernel K2: T consecutive best-first boosting trees per chain in one launch
// (one boosting cycle), each followed by its boosting update.
//
// Replaces machisplin_tpu/ops/pallas_grow.py::_tree_kernel (launched from
// gbm_tree_update, once per tree; the JAX package runs a cycle of trees as one
// device program, lax.scan in models/gbm_step.py::_cycle_program).  It also
// grows the serial gbm.step's trees, which the JAX package grows with the jnp
// grower models/trees.py::grow_bestfirst_tree: the same function, with a bin
// table per chain (each CV fold bins its own training rows) and gbm's
// monotone check.  For every chain c (one row of y and f) and tree t < T, over
// the chain's bins (xbt, p x n bytes, bin < nb: one table that every chain
// shares, or one table per chain), with w = bags[t, c]:
//   r = y - f, wy = w * r;
//   root: cumulative split stats of all rows, best (feature, bin) by gbm's
//   squared-error gain
//     gain = clwy^2/max(clw,1e-12) + rwy^2/max(rw,1e-12) - twy^2/max(tw,1e-12)
//   over candidates with clw >= min_leaf, rw >= min_leaf and bin < nb - 1
//   and, with a monotone sign s = mono[feature] (mono != NULL), not
//   s * (rwy/max(rw,1e-12) - clwy/max(clw,1e-12)) < 0 (gbm's var.monotone)
//   (first maximum in flattened (feature, bin) order);
//   n_splits best-first steps: split the node slot of largest gain (first
//   maximum) if its gain exceeds 1e-9, children in slots 2k+1 (bin <= thr)
//   and 2k+2, with exact node totals and the children's best splits;
//   value[s] = swy[s] / max(sw[s], 1e-12);  f_new = f + lr * value[node];
//   f = f_new, or with scale (T, C): f = f + scale[t, c] * (f_new - f).
// With emit (feat != NULL) it also writes tree t: feat, thr (bin index),
// internal, left, right, value per node slot and the summed gain per feature.
// With dev (dev_out != NULL) it writes, after tree t's update, the sums
// over rows of dev_w[k, c] * (y - f)^2 for k = 0, 1.
//
// Split statistics keep the TPU kernel's accuracy class: each row's w and
// w * r are split into bfloat16 hi and lo halves; the halves are summed
// apart in float32 and then added.  Totals (tw, twy, node sums, hence leaf
// values) are exact float32 row sums.  There are no float atomics: every sum
// runs in a fixed order, so two launches on the same inputs give the same
// trees, and a cycle of T trees gives what T launches of one tree give.
// Round-to-nearest intrinsics keep nvcc from contracting a*b + c.
//
// What bounds it: neither bytes nor operations in the roofline sense.  A
// tree needs some (n_splits + 1) * 4 p n adds, but the n_splits steps depend
// on each other: a tree is a chain of short block-wide passes separated by
// barriers, so latency.
//
// Design: one thread block per chain, for the whole cycle.  One thread per
// (feature, bin) column walks only its own bin's segment of the feature's
// rows sorted by bin (about n / nb rows) and sums the rows of the two new
// children (branch-free: any other row adds 0), then a warp shuffle scan and
// one carry per earlier warp of the feature turn the per-bin sums into
// cumulative ones: a step costs about n p row visits, not n p nb.  Columns
// are laid out with each feature padded to whole warps, so the scan never
// crosses a feature.  Argmaxes are two warp reductions (redux.sync max of an
// order-preserving key of the gain, then min of the index among the lanes
// that hold it), so a tie keeps the lowest index; the small ones (node pick,
// the per-warp winners) are repeated by every warp, so a split step has four
// barriers.
//
// Where the rows live, two layouts of one kernel body (a template on
// GLOBAL_ROWS), so both run the same arithmetic in the same order and give
// bit-identical results wherever both fit:
// * shared (when it fits the 227 KB opt-in: 21 + 3p bytes a row, up to some
//   6,000 rows at p = 5): the rows' bins, their sorted order (int16) and the
//   bins' offsets, copied from the chain's table, the rows' hi/lo parts as
//   four packed bfloat16, exact w and w r, f and node id, all in shared
//   memory beside the scans and the node and tree tables;
// * global (any n that device memory holds): the rows' hi/lo parts, w, w r
//   and node id in the chain's slice of a scratch buffer the caller
//   allocates (tree_grow_scratch_bytes a chain), f in f_out, and the bins
//   and sorted order (int16 or int32) read where the table lies; the scans,
//   node tables, bin offsets and per-warp winners stay in shared memory.
//   Simple, not fast: every row visit is a load through L1/L2.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>
#include <climits>
#include <cstdint>

namespace {

constexpr float EPS = 1e-12f;
constexpr int MAX_SPLITS = 127;  // node ids fit in one byte

// Sections of a tree's time, for tools/k2_probe.py.  Built with -DK2_PROBE,
// thread 0 of block 0 adds the clock64 cycles since its previous mark to the
// section that a mark closes; the default build has no marks.
enum Section { INIT, NODE_PICK, ROUTE_TOTALS, SCAN_BARRIER, ARGMAX_BARRIER, NODE_WRITE, TO_LEAF, LEAF_UPDATE,
               WALK, GAINS, N_SECTIONS };
#ifdef K2_PROBE
__device__ unsigned long long g_section_cycles[N_SECTIONS];
__device__ long long g_mark;
#define MARK_START() do { if (blockIdx.x == 0 && threadIdx.x == 0) g_mark = clock64(); } while (0)
#define MARK(k) do { if (blockIdx.x == 0 && threadIdx.x == 0) { const long long now_ = clock64(); \
  g_section_cycles[k] += (unsigned long long)(now_ - g_mark); g_mark = now_; } } while (0)
#else
#define MARK_START() do { } while (0)
#define MARK(k) do { } while (0)
#endif

struct Layout {
  size_t hl, w, wy, f, scan, ng, nf, nbin, nsw, nswy, tf, tt, ti, tl, tr, vg, tot, best, off, order, bins, cur, total;
};

__host__ __device__ inline size_t take(size_t& off, size_t bytes, size_t align) {
  off = (off + align - 1) / align * align;
  const size_t at = off;
  off += bytes;
  return at;
}

// columns: each feature's nb bins padded to whole warps
__host__ __device__ inline int padded_bins(int nb) { return (nb + 31) / 32 * 32; }

// Shared memory of a block; with rows_global the rows' arrays take none.
__host__ __device__ inline Layout make_layout(int n, int p, int nb, int n_total, bool rows_global) {
  Layout s;
  size_t off = 0;
  const size_t pc = (size_t)p * padded_bins(nb);
  const size_t nr = rows_global ? 0 : (size_t)n;
  s.hl = take(off, 8 * nr, 16);              // bfloat16 pairs (w_hi | w_lo, wy_hi | wy_lo)
  s.w = take(off, 4 * nr, 4);
  s.wy = take(off, 4 * nr, 4);
  s.f = take(off, 4 * nr, 4);
  s.scan = take(off, 4 * 8 * pc, 4);         // 8 warp-scanned sums per column
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
  s.tot = take(off, 4 * 4 * 32, 4);          // per-warp partial sums
  s.best = take(off, 16 * 32, 16);           // per-warp winners (gl, il, gr, ir)
  s.off = take(off, 4 * (size_t)p * (nb + 1), 4);
  s.order = take(off, 2 * (size_t)p * nr, 2);
  s.bins = take(off, (size_t)p * nr, 1);
  s.cur = take(off, nr, 1);
  s.total = take(off, 0, 16);
  return s;
}

// A chain's slice of the global scratch buffer (the global layout).
struct ScratchLayout {
  size_t hl, w, wy, cur, total;
};

__host__ __device__ inline ScratchLayout scratch_layout(int n) {
  ScratchLayout g;
  size_t off = 0;
  g.hl = take(off, 8 * (size_t)n, 16);
  g.w = take(off, 4 * (size_t)n, 4);
  g.wy = take(off, 4 * (size_t)n, 4);
  g.cur = take(off, (size_t)n, 1);
  g.total = take(off, 0, 256);
  return g;
}

__device__ __forceinline__ bool better(float g, int i, float bg, int bi) {
  return g > bg || (g == bg && i < bi);
}

// A key whose unsigned order is the float order of gains (NaN lowest, -0
// as +0, as the comparisons of `better` treat them).
__device__ __forceinline__ unsigned gain_key(float g) {
  const unsigned u = __float_as_uint(__fadd_rn(g, 0.0f));
  if (g != g) return 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// First maximum over the warp; every lane gets it.
__device__ __forceinline__ void warp_argmax(float& g, int& i) {
  const unsigned k = gain_key(g);
  const unsigned kmax = __reduce_max_sync(0xffffffffu, k);
  i = __reduce_min_sync(0xffffffffu, k == kmax ? i : INT_MAX);
  g = kmax == 0u ? __uint_as_float(0x7fc00000u)
                 : __uint_as_float((kmax & 0x80000000u) ? (kmax & 0x7fffffffu) : ~kmax);
}

// Block sums of K per-thread partials in a fixed order (a shuffle tree per
// warp, then one over the warps' sums, which every warp repeats); every
// thread gets them.  One barrier; s_tot must not be rewritten before a later
// barrier.
template <int K>
__device__ __forceinline__ void block_sum(float (&a)[K], float* s_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) a[k] = __fadd_rn(a[k], __shfl_down_sync(0xffffffffu, a[k], off));
    if (lane == 0) s_tot[k * 32 + warp] = a[k];
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float v = lane < nwarps ? s_tot[k * 32 + lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    a[k] = __shfl_sync(0xffffffffu, v, 0);
  }
}

// sgn: the feature's monotone sign (0: unconstrained).
__device__ __forceinline__ float split_gain(float clw, float clwy, float tw, float twy, bool last_bin, float min_leaf,
                                            float sgn) {
  const float rw = __fsub_rn(tw, clw);
  const float rwy = __fsub_rn(twy, clwy);
  if (!(clw >= min_leaf && rw >= min_leaf) || last_bin) return -CUDART_INF_F;
  if (sgn != 0.0f) {
    const float lmean = __fdiv_rn(clwy, fmaxf(clw, EPS));
    const float rmean = __fdiv_rn(rwy, fmaxf(rw, EPS));
    if (__fmul_rn(sgn, __fsub_rn(rmean, lmean)) < 0.0f) return -CUDART_INF_F;
  }
  const float a = __fdiv_rn(__fmul_rn(clwy, clwy), fmaxf(clw, EPS));
  const float b = __fdiv_rn(__fmul_rn(rwy, rwy), fmaxf(rw, EPS));
  const float c = __fdiv_rn(__fmul_rn(twy, twy), fmaxf(tw, EPS));
  return __fsub_rn(__fadd_rn(a, b), c);
}

// What a block works on: the rows' arrays (in shared memory, or in the
// chain's scratch, f_out and table with the global layout) and the scans,
// node and tree tables (shared memory).
template <typename OrderT>
struct Smem {
  uint2* hl; float* w; float* wy; float* f; float* scan;
  float* ng; int* nf; int* nb; float* nsw; float* nswy;
  int* tf; int* tt; float* ti; int* tl; int* tr; float* vg;
  float* tot; float4* best; int* off; const OrderT* order; const uint8_t* bins; uint8_t* cur;
};

// The best split of the left child (rows with node lid) and of the right
// child (node rid) from the rows' bins; with lid == rid, of that node alone
// (gr is then meaningless).  Every thread gets (gl, il, gr, ir); il / ir are
// flattened (feature, bin) indices.  mono: (p,) monotone signs or NULL.  Two
// barriers; the caller puts a third before anything reads what this pass
// reads is rewritten.
template <typename OrderT>
__device__ void best_splits(const Smem<OrderT>& s, int n, int p, int nb, int lid, int rid, float tl_w, float tl_wy,
                            float tr_w, float tr_wy, float min_leaf, const float* __restrict__ mono, float& gl,
                            int& il, float& gr, int& ir) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nt = blockDim.x, nwarps = (nt + 31) >> 5;
  const int nbw = padded_bins(nb);
  const int pc = p * nbw;
  // per-bin sums of the bin's segment of sorted rows, then a warp scan
  for (int col = threadIdx.x; col < pc; col += nt) {
    const int fc = col / nbw, bc = col - fc * nbw;
    float v[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // left hw lw hy ly, parent hw lw hy ly
    if (bc < nb) {
      const int* so = s.off + fc * (nb + 1);
      const OrderT* rows = s.order + (size_t)fc * n;
      const int end = so[bc + 1];
#pragma unroll 4
      for (int j = so[bc]; j < end; ++j) {
        const int i = rows[j];
        const int cu = s.cur[i];
        const uint2 hb = s.hl[i];
        const float4 h = make_float4(__uint_as_float(hb.x << 16), __uint_as_float(hb.x & 0xffff0000u),
                                     __uint_as_float(hb.y << 16), __uint_as_float(hb.y & 0xffff0000u));
        const bool in_p = cu == lid || cu == rid, in_l = cu == lid;
        v[4] = __fadd_rn(v[4], in_p ? h.x : 0.0f); v[5] = __fadd_rn(v[5], in_p ? h.y : 0.0f);
        v[6] = __fadd_rn(v[6], in_p ? h.z : 0.0f); v[7] = __fadd_rn(v[7], in_p ? h.w : 0.0f);
        v[0] = __fadd_rn(v[0], in_l ? h.x : 0.0f); v[1] = __fadd_rn(v[1], in_l ? h.y : 0.0f);
        v[2] = __fadd_rn(v[2], in_l ? h.z : 0.0f); v[3] = __fadd_rn(v[3], in_l ? h.w : 0.0f);
      }
    }
    MARK(WALK);
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float o = __shfl_up_sync(0xffffffffu, v[k], d);
        if (lane >= d) v[k] = __fadd_rn(v[k], o);
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) s.scan[k * pc + col] = v[k];
  }
  __syncthreads();
  MARK(SCAN_BARRIER);
  // carries from the feature's earlier warps, gains, per-thread winners
  float bgl = -CUDART_INF_F, bgr = -CUDART_INF_F;
  int bil = INT_MAX, bir = INT_MAX;
  for (int col = threadIdx.x; col < pc; col += nt) {
    const int fc = col / nbw, bc = col - fc * nbw;
    // lane k < 8 sums component k's totals of the feature's earlier warps
    float carry = 0.0f;
    if (lane < 8) {
      for (int b = 31; b < (bc & ~31); b += 32) carry = __fadd_rn(carry, s.scan[lane * pc + fc * nbw + b]);
    }
    float v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = __fadd_rn(__shfl_sync(0xffffffffu, carry, k), s.scan[k * pc + col]);
    if (bc < nb) {
      const int idx = fc * nb + bc;
      const bool last = bc >= nb - 1;
      const float clw = __fadd_rn(v[0], v[1]), clwy = __fadd_rn(v[2], v[3]);
      const float cpw = __fadd_rn(v[4], v[5]), cpwy = __fadd_rn(v[6], v[7]);
      const float sgn = mono != nullptr ? mono[fc] : 0.0f;
      const float g0 = split_gain(clw, clwy, tl_w, tl_wy, last, min_leaf, sgn);
      const float g1 = split_gain(__fsub_rn(cpw, clw), __fsub_rn(cpwy, clwy), tr_w, tr_wy, last, min_leaf, sgn);
      if (better(g0, idx, bgl, bil)) { bgl = g0; bil = idx; }
      if (better(g1, idx, bgr, bir)) { bgr = g1; bir = idx; }
    }
  }
  MARK(GAINS);
  warp_argmax(bgl, bil);
  warp_argmax(bgr, bir);
  if (lane == 0) s.best[warp] = make_float4(bgl, __int_as_float(bil), bgr, __int_as_float(bir));
  __syncthreads();
  const float4 b = lane < nwarps ? s.best[lane]
                                 : make_float4(-CUDART_INF_F, __int_as_float(INT_MAX), -CUDART_INF_F, __int_as_float(INT_MAX));
  gl = b.x; il = __float_as_int(b.y); gr = b.z; ir = __float_as_int(b.w);
  warp_argmax(gl, il);
  warp_argmax(gr, ir);
  MARK(ARGMAX_BARRIER);
}

template <bool GLOBAL_ROWS, typename OrderT>
__global__ void tree_grow_kernel(const uint8_t* __restrict__ xbt, const OrderT* __restrict__ order,
                                 const int* __restrict__ offsets, int per_chain_tables,
                                 const float* __restrict__ mono, const float* __restrict__ y,
                                 const float* __restrict__ f_in, const float* __restrict__ bags,
                                 const float* __restrict__ scale, const float* __restrict__ dev_w,
                                 unsigned char* __restrict__ scratch,
                                 float* __restrict__ f_out, int* __restrict__ o_feat, int* __restrict__ o_thr,
                                 float* __restrict__ o_int, int* __restrict__ o_left, int* __restrict__ o_right,
                                 float* __restrict__ o_value, float* __restrict__ o_vg, float* __restrict__ dev_out,
                                 int n_trees, int n_chains, int n, int p, int nb, int n_splits, float min_leaf,
                                 float lr) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_total = 2 * n_splits + 1;
  const Layout lay = make_layout(n, p, nb, n_total, GLOBAL_ROWS);
  const int c = blockIdx.x;
  const size_t row0 = (size_t)c * n;
  const size_t tab = per_chain_tables ? (size_t)c : 0;   // this chain's bin table
  const uint8_t* xbt_c = xbt + tab * p * n;
  const OrderT* order_c = order + tab * p * n;
  const int* offsets_c = offsets + tab * p * (nb + 1);
  Smem<OrderT> s;
  if (GLOBAL_ROWS) {
    const ScratchLayout g = scratch_layout(n);
    unsigned char* base = scratch + (size_t)c * g.total;
    s.hl = reinterpret_cast<uint2*>(base + g.hl);
    s.w = reinterpret_cast<float*>(base + g.w);
    s.wy = reinterpret_cast<float*>(base + g.wy);
    s.cur = base + g.cur;
    s.f = f_out + row0;
    s.order = order_c;
    s.bins = xbt_c;
  } else {
    s.hl = reinterpret_cast<uint2*>(smem + lay.hl);
    s.w = reinterpret_cast<float*>(smem + lay.w);
    s.wy = reinterpret_cast<float*>(smem + lay.wy);
    s.cur = smem + lay.cur;
    s.f = reinterpret_cast<float*>(smem + lay.f);
    s.order = reinterpret_cast<const OrderT*>(smem + lay.order);
    s.bins = smem + lay.bins;
  }
  s.scan = reinterpret_cast<float*>(smem + lay.scan);
  s.ng = reinterpret_cast<float*>(smem + lay.ng);
  s.nf = reinterpret_cast<int*>(smem + lay.nf);
  s.nb = reinterpret_cast<int*>(smem + lay.nbin);
  s.nsw = reinterpret_cast<float*>(smem + lay.nsw);
  s.nswy = reinterpret_cast<float*>(smem + lay.nswy);
  s.tf = reinterpret_cast<int*>(smem + lay.tf);
  s.tt = reinterpret_cast<int*>(smem + lay.tt);
  s.ti = reinterpret_cast<float*>(smem + lay.ti);
  s.tl = reinterpret_cast<int*>(smem + lay.tl);
  s.tr = reinterpret_cast<int*>(smem + lay.tr);
  s.vg = reinterpret_cast<float*>(smem + lay.vg);
  s.tot = reinterpret_cast<float*>(smem + lay.tot);
  s.best = reinterpret_cast<float4*>(smem + lay.best);
  s.off = reinterpret_cast<int*>(smem + lay.off);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;

  for (int i = tid; i < n; i += nt) s.f[i] = f_in[row0 + i];
  if (!GLOBAL_ROWS) {
    uint8_t* bins = smem + lay.bins;
    OrderT* ord = reinterpret_cast<OrderT*>(smem + lay.order);
    for (int j = tid; j < p * n; j += nt) { bins[j] = xbt_c[j]; ord[j] = order_c[j]; }
  }
  for (int j = tid; j < p * (nb + 1); j += nt) s.off[j] = offsets_c[j];
  MARK_START();

  for (int t = 0; t < n_trees; ++t) {
    const float* w = bags + ((size_t)t * n_chains + c) * n;
    for (int i = tid; i < n; i += nt) {
      const float wi = w[i];
      const float wyi = __fmul_rn(wi, __fsub_rn(y[row0 + i], s.f[i]));
      const __nv_bfloat16 wh = __float2bfloat16_rn(wi);
      const __nv_bfloat16 yh = __float2bfloat16_rn(wyi);
      const __nv_bfloat16 wl = __float2bfloat16_rn(__fsub_rn(wi, __bfloat162float(wh)));
      const __nv_bfloat16 yl = __float2bfloat16_rn(__fsub_rn(wyi, __bfloat162float(yh)));
      s.hl[i] = make_uint2((unsigned)__bfloat16_as_ushort(wh) | ((unsigned)__bfloat16_as_ushort(wl) << 16),
                           (unsigned)__bfloat16_as_ushort(yh) | ((unsigned)__bfloat16_as_ushort(yl) << 16));
      s.w[i] = wi;
      s.wy[i] = wyi;
      s.cur[i] = 0;
    }
    for (int k = tid; k < n_total; k += nt) {
      s.ng[k] = -CUDART_INF_F;
      s.nf[k] = 0; s.nb[k] = 0; s.nsw[k] = 0.0f; s.nswy[k] = 0.0f;
      s.tf[k] = 0; s.tt[k] = 0; s.ti[k] = 0.0f; s.tl[k] = 0; s.tr[k] = 0;
    }
    for (int j = tid; j < p; j += nt) s.vg[j] = 0.0f;
    __syncthreads();
    MARK(INIT);

    // ---- root: exact totals, cumulative stats of every row, best split ----
    {
      float tot[2] = {0.0f, 0.0f};
      for (int i = tid; i < n; i += nt) {
        tot[0] = __fadd_rn(tot[0], s.w[i]);
        tot[1] = __fadd_rn(tot[1], s.wy[i]);
      }
      block_sum<2>(tot, s.tot);
      MARK(ROUTE_TOTALS);
      float g, gr; int idx, ir;
      best_splits(s, n, p, nb, 0, 0, tot[0], tot[1], 0.0f, 0.0f, min_leaf, mono, g, idx, gr, ir);
      if (tid == 0) {
        s.ng[0] = g; s.nf[0] = idx / nb; s.nb[0] = idx - (idx / nb) * nb;
        s.nsw[0] = tot[0]; s.nswy[0] = tot[1];
      }
      __syncthreads();
      MARK(NODE_WRITE);
    }

    // ---- best-first splits ----
    for (int k = 0; k < n_splits; ++k) {
      float gq = -CUDART_INF_F;
      int q = INT_MAX;
      for (int j = lane; j < n_total; j += 32) {
        if (better(s.ng[j], j, gq, q)) { gq = s.ng[j]; q = j; }
      }
      warp_argmax(gq, q);
      MARK(NODE_PICK);
      if (!(gq > 1e-9f)) break;  // no node left to split: every later step is a no-op
      const int bfq = s.nf[q], bbq = s.nb[q];
      const int lid = 2 * k + 1, rid = 2 * k + 2;
      const uint8_t* bq = s.bins + (size_t)bfq * n;
      float t4[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // left w, left wy, parent w, parent wy
      for (int i = tid; i < n; i += nt) {
        if (s.cur[i] == q) {
          const bool left = bq[i] <= bbq;
          s.cur[i] = (uint8_t)(left ? lid : rid);
          if (left) { t4[0] = __fadd_rn(t4[0], s.w[i]); t4[1] = __fadd_rn(t4[1], s.wy[i]); }
          t4[2] = __fadd_rn(t4[2], s.w[i]); t4[3] = __fadd_rn(t4[3], s.wy[i]);
        }
      }
      block_sum<4>(t4, s.tot);
      MARK(ROUTE_TOTALS);
      const float tl_w = t4[0], tl_wy = t4[1];
      const float tr_w = __fsub_rn(t4[2], tl_w), tr_wy = __fsub_rn(t4[3], tl_wy);
      float gl, gr; int il, ir;
      best_splits(s, n, p, nb, lid, rid, tl_w, tl_wy, tr_w, tr_wy, min_leaf, mono, gl, il, gr, ir);
      if (tid == 0) {
        s.ng[q] = -CUDART_INF_F;
        s.ng[lid] = gl; s.nf[lid] = il / nb; s.nb[lid] = il - (il / nb) * nb;
        s.ng[rid] = gr; s.nf[rid] = ir / nb; s.nb[rid] = ir - (ir / nb) * nb;
        s.nsw[lid] = tl_w; s.nswy[lid] = tl_wy;
        s.nsw[rid] = tr_w; s.nswy[rid] = tr_wy;
        s.tf[q] = bfq; s.tt[q] = bbq; s.ti[q] = 1.0f; s.tl[q] = lid; s.tr[q] = rid;
        s.vg[bfq] = __fadd_rn(s.vg[bfq], gq);
      }
      __syncthreads();
      MARK(NODE_WRITE);
    }

    // ---- leaf values and the boosting update ----
    __syncthreads();  // every warp has read the node gains (a step may have broken out)
    MARK(TO_LEAF);
    for (int k = tid; k < n_total; k += nt) s.ng[k] = __fdiv_rn(s.nswy[k], fmaxf(s.nsw[k], EPS));
    __syncthreads();
    const float sc = scale != nullptr ? scale[(size_t)t * n_chains + c] : 0.0f;
    float dev[2] = {0.0f, 0.0f};
    for (int i = tid; i < n; i += nt) {
      const float fo = s.f[i];
      const float fn = __fadd_rn(fo, __fmul_rn(lr, s.ng[s.cur[i]]));
      const float fi = scale != nullptr ? __fadd_rn(fo, __fmul_rn(sc, __fsub_rn(fn, fo))) : fn;
      s.f[i] = fi;
      if (dev_out != nullptr) {
        const float r = __fsub_rn(y[row0 + i], fi);
        const float r2 = __fmul_rn(r, r);
        dev[0] = __fadd_rn(dev[0], __fmul_rn(dev_w[row0 + i], r2));
        dev[1] = __fadd_rn(dev[1], __fmul_rn(dev_w[(size_t)n_chains * n + row0 + i], r2));
      }
    }
    if (o_feat != nullptr) {
      const size_t t0 = ((size_t)t * n_chains + c) * n_total;
      for (int k = tid; k < n_total; k += nt) {
        o_feat[t0 + k] = s.tf[k]; o_thr[t0 + k] = s.tt[k]; o_int[t0 + k] = s.ti[k];
        o_left[t0 + k] = s.tl[k]; o_right[t0 + k] = s.tr[k]; o_value[t0 + k] = s.ng[k];
      }
      for (int j = tid; j < p; j += nt) o_vg[((size_t)t * n_chains + c) * p + j] = s.vg[j];
    }
    if (dev_out != nullptr) {
      block_sum<2>(dev, s.tot);
      if (tid == 0) {
        dev_out[((size_t)t * n_chains + c) * 2] = dev[0];
        dev_out[((size_t)t * n_chains + c) * 2 + 1] = dev[1];
      }
    }
    __syncthreads();
    MARK(LEAF_UPDATE);
  }
  if (!GLOBAL_ROWS) {
    for (int i = tid; i < n; i += nt) f_out[row0 + i] = s.f[i];
  }
}

}  // namespace

// Dynamic shared memory a launch of these sizes takes, in bytes, with the
// rows in shared memory (rows_global 0) or in global memory (1).
extern "C" long long tree_grow_smem_bytes(int n, int p, int nb, int n_splits, int rows_global) {
  return (long long)make_layout(n, p, nb, 2 * n_splits + 1, rows_global != 0).total;
}

// Bytes of global scratch a chain takes with the rows in global memory.
extern "C" long long tree_grow_scratch_bytes(int n) { return (long long)scratch_layout(n).total; }

// Whether the rows of a launch of these sizes must live in global memory:
// 1 when the shared layout exceeds the current device's opt-in shared
// memory a block, else 0; negative: a cudaError_t.
extern "C" int tree_grow_rows_global(int n, int p, int nb, int n_splits) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
  return make_layout(n, p, nb, 2 * n_splits + 1, false).total > (size_t)optin ? 1 : 0;
}

#ifdef K2_PROBE
// The cycles of each section since the last read (N_SECTIONS of them, in
// the order of enum Section), then zeroed.  Returns a cudaError_t.
extern "C" int tree_grow_read_sections(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_section_cycles, sizeof(unsigned long long) * N_SECTIONS);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long zero[N_SECTIONS] = {};
  return (int)cudaMemcpyToSymbol(g_section_cycles, zero, sizeof(zero));
}
#endif

namespace {

// The largest block any instance of the kernel can take, in whole warps: every
// layout launches the same threads, so it sums in the same order.
cudaError_t block_cap(int& cap) {
  const void* fns[] = {reinterpret_cast<const void*>(tree_grow_kernel<false, int16_t>),
                       reinterpret_cast<const void*>(tree_grow_kernel<true, int16_t>),
                       reinterpret_cast<const void*>(tree_grow_kernel<true, int>)};
  cap = 1 << 30;
  for (const void* fn : fns) {
    cudaFuncAttributes attr;
    const cudaError_t e = cudaFuncGetAttributes(&attr, fn);
    if (e != cudaSuccess) return e;
    cap = attr.maxThreadsPerBlock < cap ? attr.maxThreadsPerBlock : cap;
  }
  cap = cap / 32 * 32;
  return cudaSuccess;
}

template <bool GLOBAL_ROWS, typename OrderT>
cudaError_t launch(const void* xbt, const void* order, const void* offsets, int per_chain_tables, const void* mono,
                   const void* y, const void* f_in, const void* bags, const void* scale, const void* dev_w,
                   void* scratch, void* f_out, void* feat, void* thr, void* internal, void* left, void* right,
                   void* value, void* var_gain, void* dev_out, int n_trees, int n_chains, int n, int p, int nb,
                   int n_splits, float min_leaf, float lr, int threads, size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(reinterpret_cast<const void*>(tree_grow_kernel<GLOBAL_ROWS, OrderT>),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  tree_grow_kernel<GLOBAL_ROWS, OrderT><<<n_chains, threads, smem, stream>>>(
      static_cast<const uint8_t*>(xbt), static_cast<const OrderT*>(order), static_cast<const int*>(offsets),
      per_chain_tables, static_cast<const float*>(mono), static_cast<const float*>(y),
      static_cast<const float*>(f_in), static_cast<const float*>(bags), static_cast<const float*>(scale),
      static_cast<const float*>(dev_w), static_cast<unsigned char*>(scratch), static_cast<float*>(f_out),
      static_cast<int*>(feat), static_cast<int*>(thr), static_cast<float*>(internal), static_cast<int*>(left),
      static_cast<int*>(right), static_cast<float*>(value), static_cast<float*>(var_gain),
      static_cast<float*>(dev_out), n_trees, n_chains, n, p, nb, n_splits, min_leaf, lr);
  return cudaGetLastError();
}

}  // namespace

// xbt (n_tables, p, n) uint8 bins < nb; order (n_tables, p, n) int16
// (order_bytes 2, n <= 32767) or int32 (order_bytes 4) each feature's rows
// sorted by bin (stable); offsets (n_tables, p, nb + 1) int32 each bin's
// start in order; n_tables 1 (every chain reads the one table) or n_chains
// (chain c reads table c); mono (p,) float32 monotone signs in {-1, 0, 1}
// or NULL; y, f_in, f_out (n_chains, n) float32; bags (n_trees, n_chains, n)
// float32 row weights of each tree; scale (n_trees, n_chains) float32 or
// NULL; with the tree outputs (all non-NULL or all NULL): feat, thr, left,
// right int32 and internal, value float32 (n_trees, n_chains, 2 n_splits +
// 1), var_gain float32 (n_trees, n_chains, p); dev_w (2, n_chains, n)
// float32 and dev_out (n_trees, n_chains, 2) float32, both or neither.
// rows_global 0: the rows in shared memory (int16 order only); 1: in global
// memory, with scratch n_chains * tree_grow_scratch_bytes(n) bytes (16-byte
// aligned; NULL with rows_global 0).  Contiguous, on the device of
// `stream`.  Returns the launch's cudaError_t (cudaErrorInvalidValue for
// unsupported sizes).
extern "C" int tree_grow_launch(const void* xbt, const void* order, const void* offsets, const void* mono,
                                const void* y, const void* f_in, const void* bags, const void* scale,
                                const void* dev_w, void* scratch, void* f_out, void* feat, void* thr,
                                void* internal, void* left, void* right, void* value, void* var_gain,
                                void* dev_out, int n_trees, int n_chains, int n_tables, int n, int p, int nb,
                                int n_splits, int order_bytes, int rows_global, float min_leaf, float lr,
                                void* stream) {
  if (n_trees <= 0 || n_chains <= 0 || n <= 0 || p <= 0 || (long long)p * n > INT_MAX || nb < 2 || nb > 256 ||
      n_splits < 1 || n_splits > MAX_SPLITS || (dev_w == nullptr) != (dev_out == nullptr) ||
      (n_tables != 1 && n_tables != n_chains) || (order_bytes != 2 && order_bytes != 4) ||
      (order_bytes == 2 && n > 32767) || (rows_global != 0 && rows_global != 1) ||
      (rows_global == 1) != (scratch != nullptr) || (rows_global == 0 && order_bytes != 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const int n_total = 2 * n_splits + 1;
  const size_t smem = make_layout(n, p, nb, n_total, rows_global != 0).total;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // one thread per (feature, padded bin), at most as many as the kernel's
  // registers allow in one block, in whole warps (the column loops need them)
  int cap = 0;
  const cudaError_t ea = block_cap(cap);
  if (ea != cudaSuccess) return (int)ea;
  const int cols = p * padded_bins(nb), threads = cols < cap ? cols : cap;
  const int per_chain = n_tables > 1 ? 1 : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define K2_ARGS xbt, order, offsets, per_chain, mono, y, f_in, bags, scale, dev_w, scratch, f_out, feat, thr, \
    internal, left, right, value, var_gain, dev_out, n_trees, n_chains, n, p, nb, n_splits, min_leaf, lr, threads, \
    smem, st
  cudaError_t e;
  if (rows_global == 0) {
    e = launch<false, int16_t>(K2_ARGS);
  } else if (order_bytes == 2) {
    e = launch<true, int16_t>(K2_ARGS);
  } else {
    e = launch<true, int>(K2_ARGS);
  }
#undef K2_ARGS
  return (int)e;
}
