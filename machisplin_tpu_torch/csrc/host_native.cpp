// host_native — the port's host library: the C++ pieces of the pipeline
// that run on the CPU, bound with ctypes by io/native.py.
//
//   * a GeoTIFF strip/tile decoder (none / deflate / LZW, predictor 2) for
//     multi-hundred-MB rasters, with a multi-threaded strip pool;
//   * a tile-plan scheduler: given grid geometry and a tile budget it emits
//     the overlap windows (fit + mosaic extents), the same arithmetic as
//     pipeline/mltps._tps_tiles;
//   * float32 raster helpers (NaN-aware mosaic accumulate);
//   * a threaded host forest predictor.
//
// A plain C ABI for ctypes.  kernels/build.py compiles it with g++ at first
// use into the build directory of the CUDA kernels
// (-O3 -fPIC -std=c++17 -shared -lz -lpthread).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------------------
// LZW (TIFF variant: MSB-first codes, early change)
// ---------------------------------------------------------------------------
// Returns decoded byte count, or -1 on malformed input / overflow of out_cap.
int64_t tiff_lzw_decode(const uint8_t* in, int64_t in_len, uint8_t* out,
                        int64_t out_cap) {
  constexpr int kClear = 256, kEoi = 257;
  struct Entry { int32_t prev; uint8_t byte; uint16_t len; };
  std::vector<Entry> table(4096);
  auto reset = [&]() {
    for (int i = 0; i < 256; ++i) table[i] = {-1, (uint8_t)i, 1};
  };
  reset();
  int table_size = 258;
  int nbits = 9;
  int64_t bitpos = 0;
  const int64_t total_bits = in_len * 8;
  int32_t prev_code = -1;
  int64_t out_pos = 0;

  auto emit = [&](int code) -> int64_t {  // writes entry bytes, returns length
    int64_t len = table[code].len;
    if (out_pos + len > out_cap) return -1;
    int64_t p = out_pos + len;
    for (int c = code; c >= 0; c = table[c].prev) out[--p] = table[c].byte;
    out_pos += len;
    return len;
  };
  auto first_byte = [&](int code) -> uint8_t {
    int c = code;
    while (table[c].prev >= 0) c = table[c].prev;
    return table[c].byte;
  };

  while (bitpos + nbits <= total_bits) {
    int64_t byte0 = bitpos >> 3;
    uint32_t window = 0;
    for (int i = 0; i < 4; ++i)
      window = (window << 8) | (byte0 + i < in_len ? in[byte0 + i] : 0);
    int code = (window >> (32 - (bitpos & 7) - nbits)) & ((1 << nbits) - 1);
    bitpos += nbits;
    if (code == kEoi) break;
    if (code == kClear) {
      reset();
      table_size = 258;
      nbits = 9;
      prev_code = -1;
      continue;
    }
    if (prev_code < 0) {
      if (code >= 256) return -1;
      if (emit(code) < 0) return -1;
      prev_code = code;
    } else {
      if (code > table_size) return -1;
      int new_code = table_size;
      if (new_code < 4096) {
        table[new_code].prev = prev_code;
        table[new_code].byte =
            (code == table_size) ? first_byte(prev_code) : first_byte(code);
        table[new_code].len = (uint16_t)(table[prev_code].len + 1);
        ++table_size;
      }
      if (emit(code == new_code ? new_code : code) < 0) return -1;
      prev_code = code;
    }
    if (table_size + 1 >= (1 << nbits) && nbits < 12) ++nbits;
  }
  return out_pos;
}

// ---------------------------------------------------------------------------
// Strip/tile decode pool
// ---------------------------------------------------------------------------
// compression: 1 = none, 5 = LZW, 8/32946 = deflate.  predictor: 1 or 2.
// Each chunk i decodes in[offsets[i] .. offsets[i]+counts[i]) into
// out + out_offsets[i] with expected decoded size out_sizes[i].
// bytes_per_pixel handles predictor-2 differencing over interleaved samples.
// Returns 0 on success, else the (1-based) index of the first failing chunk.
int64_t tiff_decode_chunks(const uint8_t* file, const int64_t* offsets,
                           const int64_t* counts, const int64_t* out_offsets,
                           const int64_t* out_sizes, int64_t n_chunks,
                           int32_t compression, int32_t predictor,
                           int32_t row_bytes, int32_t sample_bytes,
                           uint8_t* out, int32_t n_threads) {
  std::atomic<int64_t> next(0), failed(0);
  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n_chunks || failed.load() != 0) return;
      const uint8_t* src = file + offsets[i];
      uint8_t* dst = out + out_offsets[i];
      int64_t want = out_sizes[i];
      int64_t got = -1;
      if (compression == 1) {
        got = std::min<int64_t>(counts[i], want);
        std::memcpy(dst, src, got);
      } else if (compression == 8 || compression == 32946) {
        uLongf dlen = (uLongf)want;
        if (uncompress(dst, &dlen, src, (uLong)counts[i]) == Z_OK)
          got = (int64_t)dlen;
      } else if (compression == 5) {
        got = tiff_lzw_decode(src, counts[i], dst, want);
      }
      if (got < 0) { failed.store(i + 1); return; }
      if (predictor == 2 && sample_bytes == 1) {
        for (int64_t r = 0; r + row_bytes <= got; r += row_bytes)
          for (int64_t c = 1; c < row_bytes; ++c) dst[r + c] += dst[r + c - 1];
      }
    }
  };
  int nt = std::max(1, n_threads);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
  return failed.load();
}

// ---------------------------------------------------------------------------
// Tile plan (the reference's auto-tiling math, V73:650-681)
// ---------------------------------------------------------------------------
// Writes 8 doubles per tile: fit xmin/xmax/ymin/ymax, mosaic xmin/xmax/ymin/
// ymax, row-major from the bottom-left.  Returns tile count.
int64_t tps_tile_plan(double xmin, double xmax, double ymin, double ymax,
                      int64_t nrows, int64_t ncols, int64_t tile_px,
                      double fit_overlap, double mosaic_overlap,
                      double* out /* (nrx*ncx) x 8 */) {
  int64_t nrx = (nrows + tile_px - 1) / tile_px;
  int64_t ncx = (ncols + tile_px - 1) / tile_px;
  double long_d = (xmax - xmin) / (double)ncx;
  double lat_d = (ymax - ymin) / (double)nrx;
  int64_t m = 0;
  for (int64_t j = 1; j <= nrx; ++j) {
    for (int64_t h = 1; h <= ncx; ++h, ++m) {
      double* row = out + m * 8;
      row[0] = xmin + long_d * (double)(h - 1) - long_d * fit_overlap;
      row[1] = xmin + long_d * (double)h + long_d * fit_overlap;
      row[2] = ymin + lat_d * (double)(j - 1) - lat_d * fit_overlap;
      row[3] = ymin + lat_d * (double)j + lat_d * fit_overlap;
      row[4] = xmin + long_d * (double)(h - 1) - long_d * mosaic_overlap;
      row[5] = xmin + long_d * (double)h + long_d * mosaic_overlap;
      row[6] = ymin + lat_d * (double)(j - 1) - lat_d * mosaic_overlap;
      row[7] = ymin + lat_d * (double)j + lat_d * mosaic_overlap;
    }
  }
  return nrx * ncx;
}

// ---------------------------------------------------------------------------
// NaN-aware mosaic accumulate: acc += tile (where finite), cnt += finite.
// ---------------------------------------------------------------------------
void mosaic_accumulate(float* acc, float* cnt, const float* tile,
                       int64_t tile_rows, int64_t tile_cols, int64_t acc_cols,
                       int64_t row0, int64_t col0) {
  for (int64_t r = 0; r < tile_rows; ++r) {
    float* arow = acc + (row0 + r) * acc_cols + col0;
    float* crow = cnt + (row0 + r) * acc_cols + col0;
    const float* trow = tile + r * tile_cols;
    for (int64_t c = 0; c < tile_cols; ++c) {
      float v = trow[c];
      if (!std::isnan(v)) { arow[c] += v; crow[c] += 1.0f; }
    }
  }
}

void mosaic_finalize(float* acc, const float* cnt, int64_t n) {
  for (int64_t i = 0; i < n; ++i)
    acc[i] = cnt[i] > 0.f ? acc[i] / cnt[i] : NAN;
}

// ---------------------------------------------------------------------------
// Forest prediction (host path)
// ---------------------------------------------------------------------------
// randomForest's own Fortran/C core is the precedent for walking trees on
// the host.  Trees are flat
// arrays in the models/trees.py layout: per tree, node arrays of length
// n_nodes (feat int32, thr f32, internal f32>0, left/right int32, value f32).
// Prediction = weighted sum over trees, multi-threaded over cells.
// x is row-major (m, p).  weights length n_trees.
struct PackedNode {      // one cache line serves a whole node visit
  int32_t feat;          // -1 marks a leaf
  float thr;
  int32_t left;
  int32_t right;
  float value;
};

void forest_predict_f32(const int32_t* feat, const float* thr,
                        const float* internal, const int32_t* left,
                        const int32_t* right, const float* value,
                        int64_t n_trees, int64_t n_nodes, int64_t max_depth,
                        const float* x, int64_t m, int64_t p,
                        const float* weights, float* out, int32_t n_threads) {
  // pack field-of-arrays into interleaved records once (tiny vs. m)
  std::vector<PackedNode> packed((size_t)n_trees * n_nodes);
  std::vector<int32_t> live;   // trees with non-zero weight
  live.reserve(n_trees);
  for (int64_t t = 0; t < n_trees; ++t) {
    if (weights[t] != 0.f) live.push_back((int32_t)t);
    const int64_t base = t * n_nodes;
    for (int64_t q = 0; q < n_nodes; ++q) {
      PackedNode& nd = packed[base + q];
      nd.feat = internal[base + q] > 0.f ? feat[base + q] : -1;
      nd.thr = thr[base + q];
      nd.left = left[base + q];
      nd.right = right[base + q];
      nd.value = value[base + q];
    }
  }

  std::atomic<int64_t> next(0);
  const int64_t block = 2048;
  auto worker = [&]() {
    for (;;) {
      int64_t b = next.fetch_add(1);
      int64_t i0 = b * block;
      if (i0 >= m) return;
      int64_t i1 = std::min(i0 + block, m);
      // iterate trees outer, cells inner: the tree's nodes stay hot in L1/L2
      std::vector<float> acc(i1 - i0, 0.f);
      for (int32_t t : live) {
        const float w = weights[t];
        const PackedNode* nodes = packed.data() + (size_t)t * n_nodes;
        for (int64_t i = i0; i < i1; ++i) {
          const float* xi = x + i * p;
          int32_t cur = 0;
          int32_t f = nodes[0].feat;
          for (int64_t d = 0; d < max_depth && f >= 0; ++d) {
            cur = (xi[f] <= nodes[cur].thr) ? nodes[cur].left : nodes[cur].right;
            f = nodes[cur].feat;
          }
          acc[i - i0] += w * nodes[cur].value;
        }
      }
      for (int64_t i = i0; i < i1; ++i) out[i] = acc[i - i0];
    }
  };
  int nt = std::max(1, n_threads);
  std::vector<std::thread> pool;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
