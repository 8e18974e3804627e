"""ctypes bridge to the port's host library (``csrc/host_native.cpp``).

Counterpart of ``machisplin_tpu/io/native.py``.  The library is compiled by
``kernels/build.py`` with the C++ compiler into the build directory at first
use.  ``load_native`` returns None only where no C++ compiler is on ``PATH``
or the compiler finds no ``zlib.h`` (logged once); any other compile error
raises.  Callers then keep their pure-Python path: ``io/geotiff.read_geotiff`` decodes strips with ``decode_chunks``, and
a decode error raises.  Forests are predicted by kernel K3 (``ops/forest``);
``forest_predict_native`` is the host walk of the same trees.
"""
from __future__ import annotations

import ctypes
import logging
import os

import numpy as np

__all__ = ["load_native", "decode_chunks", "forest_predict_native", "tile_plan"]

log = logging.getLogger("machisplin_tpu_torch.native")

_LIB = None
_TRIED = False


def load_native():
    """The bound library, or None where no C++ compiler is on ``PATH`` or
    the compiler finds no ``zlib.h``."""
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    from ..kernels.build import host_compiler, host_finds_header, load_host_library

    missing = "no C++ compiler on PATH" if host_compiler() is None else \
        None if host_finds_header("zlib.h") else "the C++ compiler finds no zlib.h"
    if missing is not None:
        _TRIED = True
        log.warning("%s: the host library (csrc/host_native.cpp) is not built; GeoTIFF strips decode in Python",
                    missing)
        return None
    lib = load_host_library("host_native")
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.tiff_decode_chunks.restype = ctypes.c_int64
    lib.tiff_decode_chunks.argtypes = [
        u8p, i64p, i64p, i64p, i64p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        u8p, ctypes.c_int32,
    ]
    lib.tiff_lzw_decode.restype = ctypes.c_int64
    lib.tiff_lzw_decode.argtypes = [u8p, ctypes.c_int64, u8p, ctypes.c_int64]
    lib.tps_tile_plan.restype = ctypes.c_int64
    lib.tps_tile_plan.argtypes = [
        ctypes.c_double, ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, f64p,
    ]
    lib.mosaic_accumulate.restype = None
    lib.mosaic_accumulate.argtypes = [f32p, f32p, f32p] + [ctypes.c_int64] * 5
    lib.mosaic_finalize.restype = None
    lib.mosaic_finalize.argtypes = [f32p, f32p, ctypes.c_int64]
    lib.forest_predict_f32.restype = None
    lib.forest_predict_f32.argtypes = [
        i32p, f32p, f32p, i32p, i32p, f32p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        f32p, ctypes.c_int64, ctypes.c_int64,
        f32p, f32p, ctypes.c_int32,
    ]
    _LIB, _TRIED = lib, True
    return lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _threads(n_threads: int) -> int:
    return n_threads if n_threads > 0 else min(os.cpu_count() or 1, 16)


def decode_chunks(file_bytes, offsets, counts, out_offsets, out_sizes, compression: int, predictor: int,
                  row_bytes: int, sample_bytes: int, total_out: int, n_threads: int = 0) -> np.ndarray | None:
    """Decode TIFF strips or tiles in parallel into one (total_out,) byte
    array; None if the library is absent.  A chunk that fails to decode
    raises ValueError."""
    lib = load_native()
    if lib is None:
        return None
    src = np.frombuffer(file_bytes, np.uint8)
    out = np.zeros(total_out, np.uint8)
    offs, cnts, oofs, osz = (np.ascontiguousarray(a, np.int64) for a in (offsets, counts, out_offsets, out_sizes))
    rc = lib.tiff_decode_chunks(
        _ptr(src, ctypes.c_uint8), _ptr(offs, ctypes.c_int64), _ptr(cnts, ctypes.c_int64),
        _ptr(oofs, ctypes.c_int64), _ptr(osz, ctypes.c_int64), len(offs),
        compression, predictor, row_bytes, sample_bytes, _ptr(out, ctypes.c_uint8), _threads(n_threads),
    )
    if rc != 0:
        raise ValueError(f"native TIFF decode failed at chunk {rc - 1}")
    return out


def forest_predict_native(trees, x, max_depth: int, weights, n_threads: int = 0) -> np.ndarray | None:
    """Weighted forest prediction at the (m, p) points ``x`` on the host,
    threaded over cells, float32; None if the library is absent.  ``trees``
    is a ``models.trees.Tree`` of (T, N) arrays (tensors or numpy)."""
    lib = load_native()
    if lib is None:
        return None
    host = lambda a, dt: np.ascontiguousarray(a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a), dt)
    feat, left, right = (host(a, np.int32) for a in (trees.feat, trees.left, trees.right))
    thr, internal, value = (host(a, np.float32) for a in (trees.thr, trees.internal, trees.value))
    xq, w = host(x, np.float32), host(weights, np.float32)
    t, n_nodes = feat.shape
    m, p = xq.shape
    out = np.zeros(m, np.float32)
    lib.forest_predict_f32(
        _ptr(feat, ctypes.c_int32), _ptr(thr, ctypes.c_float), _ptr(internal, ctypes.c_float),
        _ptr(left, ctypes.c_int32), _ptr(right, ctypes.c_int32), _ptr(value, ctypes.c_float),
        t, n_nodes, max_depth, _ptr(xq, ctypes.c_float), m, p,
        _ptr(w, ctypes.c_float), _ptr(out, ctypes.c_float), _threads(n_threads),
    )
    return out


def tile_plan(grid_extent, nrows, ncols, tile_px, fit_overlap, mosaic_overlap) -> np.ndarray | None:
    """The TPS tile plan, (tiles, 8) float64: each tile's fit extent (xmin,
    xmax, ymin, ymax) and mosaic extent; None if the library is absent."""
    lib = load_native()
    if lib is None:
        return None
    xmin, xmax, ymin, ymax = grid_extent
    nrx = -(-nrows // tile_px)
    ncx = -(-ncols // tile_px)
    out = np.zeros((nrx * ncx, 8), np.float64)
    n = lib.tps_tile_plan(xmin, xmax, ymin, ymax, nrows, ncols, tile_px, fit_overlap, mosaic_overlap,
                          _ptr(out, ctypes.c_double))
    return out[:n]
