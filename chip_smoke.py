#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

From the root of a checkout, on a machine with a CUDA device and nvcc:

* ``build``: compiles every CUDA kernel of ``machisplin_tpu_torch/csrc`` with
  nvcc (one process per source) and loads it with ctypes;
* ``kernel_k1``: runs the TPS grid kernel on a full-resolution tile of the
  main path's tiling (real knots from a spline fit on ``sampling.csv``, two
  responses) and holds it against its plain PyTorch version to
  2e-4 * max|surface|, with CUDA-event times for both and the kernel's bound;
* ``mltps_gm``: the main path, ``mltps(load_sampling(),
  synthetic_covariates(downsample=1), tps=True,
  config=MLTPSConfig(letters_pool="gm"))`` on the full 2476 x 3264 grid with
  the covariates as built (float32) and numpy-drawn folds, counting the
  kernel's launches and holding every r^2 to the JAX package's float32 value
  for the same run (``tools/record_jax_gm_r2.py 1``) within 0.02;
* ``mltps_gm_f64``: the same run with the covariates cast to float64, held
  to the JAX package's float64 values (``tools/record_jax_gm_r2.py
  --float64 1``) within 2e-3, with the same kept letters.

Each phase prints one JSON line; then the kernel table, the card's name and
power limit, and last ``{"ok": true, "device": {...}}``.  Any failed check
exits non-zero; so does a run without a CUDA device, or outside a checkout.
"""
from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import time

log = logging.getLogger("chip_smoke")

# The JAX package's values for these runs (folds from numpy_folds(813, 10, 2,
# seed=0)), from CPU runs of
# `PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_gm_r2.py [--float64] 1`.
JAX_REFERENCE = {
    "float64": {
        "bio_1": {"kept": "gm", "r2_ensemble": 0.8147260152130515, "r2_final": 0.9967941103902852},
        "bio_12": {"kept": "m", "r2_ensemble": 0.7416836371554276, "r2_final": 0.9068688548689734},
    },
    "float32": {
        "bio_1": {"kept": "gm", "r2_ensemble": 0.8151210302054405, "r2_final": 0.9979223054672883},
        "bio_12": {"kept": "m", "r2_ensemble": 0.7352740566202252, "r2_final": 0.9094304814818496},
    },
}
# float64 runs agree to round-off.  In float32 the JAX package's own r² moves
# by up to 0.0174 with the BLAS summation order alone (bio_12 r² ensemble at
# downsample 4, multi- vs single-threaded), and the kept letters sit near the
# 5 % weight cut, so float32 runs are held to a band, not to the letters.
R2_TOL = {"float64": 2e-3, "float32": 2e-2}
K1_TOL = 2e-4

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_OPS = 67e12
PEAK_BYTES = 3.35e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Median CUDA-event time of ``fn`` over ``reps`` runs after a warm-up."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def phase_build():
    from machisplin_tpu_torch.kernels import build

    t0 = time.perf_counter()
    libs = build.build_all()
    for name, text in build.ptxas_info().items():
        log.info("nvcc %s:\n%s", name, text)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "libraries": sorted(os.path.relpath(p) for p in libs.values())})


def _largest_tile():
    """The largest fit tile of the main path's tiling, the stations in it,
    and their knot budget (as _batched_tile_surfaces packs them)."""
    import numpy as np

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig, _tps_tiles

    grid = mtt.example_grid(1)
    _, _, fit_exts, _ = _tps_tiles(grid, MLTPSConfig())
    tiles = [grid.subgrid(*grid.window_from_extent(e)) for e in fit_exts]
    g = max(tiles, key=lambda t: t.ncell)
    s = mtt.load_sampling()
    row, col = g.rowcol_from_xy(s["long"], s["lat"])
    sel = (row >= 0) & (row < g.nrows) & (col >= 0) & (col < g.ncols)
    coords = np.stack([s["long"], s["lat"]], 1)[sel]
    ys = np.stack([s["bio_1"], s["bio_12"]], 1)[sel]
    return g, coords, ys, -(-int(sel.sum()) // 64) * 64


def phase_kernel_k1():
    import torch

    from machisplin_tpu_torch.ops import tps_grid
    from machisplin_tpu_torch.parallel.tiles import batched_tile_solve, pack_tiles

    t0 = time.perf_counter()
    g, coords, ys, budget = _largest_tile()
    ct, yt, mt_ = pack_tiles([coords], [ys], pad_to=budget, dtype=torch.float64, device="cuda")
    model = batched_tile_solve(ct, yt, mt_)
    model = type(model)(*(a[0] for a in model))
    tab = tps_grid.grid_tables(model, g, torch.float32)
    # the function needs only the live stations; the budget's padded knots
    # have c = 0 and are evaluated but add nothing
    n_knots, n_resp = len(coords), model.c.shape[1]
    n_pad = tab.c.shape[1]

    got = tps_grid.tps_grid_cuda(tab, g)
    want = tps_grid.tps_grid_plain(tab, g, block_rows=64)
    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise RuntimeError("K1 produced non-finite values")
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    ms = cuda_ms(lambda: tps_grid.tps_grid_cuda(tab, g), reps=10)
    plain_ms = cuda_ms(lambda: tps_grid.tps_grid_plain(tab, g, block_rows=64), reps=5)

    cells = g.ncell
    pairs = cells * n_knots
    ops = pairs * (8 + 2 * n_resp)  # 2 sub, 3 for r2, max, log, mul, 2R accumulate
    nbytes = 4 * (n_resp * cells + 2 * n_knots + n_resp * n_knots + 3 * n_resp)
    t_ops, t_bytes = ops / PEAK_F32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    res = {
        "phase": "kernel_k1", "seconds": time.perf_counter() - t0,
        "tile": [g.nrows, g.ncols], "cells": cells, "knots": n_knots, "knots_padded": n_pad,
        "responses": n_resp, "phi_pairs": pairs, "phi_evaluated": cells * n_pad,
        "max_abs_err": err, "max_abs_surface": scale, "tolerance": K1_TOL * scale,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
    }
    emit(res)
    if not err <= K1_TOL * scale:
        raise RuntimeError(f"K1 disagrees with its plain version: {err} > {K1_TOL} * {scale}")
    return res


def phase_mltps_gm(dtype: str):
    """The main path with the covariates in ``dtype`` ("float32" as built,
    or "float64"), held to the JAX package's values for that dtype."""
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.ops import tps_grid
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    cov = mtt.Raster(cov.data.to(getattr(torch, dtype)), cov.grid, cov.names)
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    t_setup = time.perf_counter() - t0

    timer = mtt.PhaseTimer()
    for k in tps_grid.LAUNCHES:
        tps_grid.LAUNCHES[k] = 0
    t1 = time.perf_counter()
    out = mtt.mltps(s, cov, tps=True, config=MLTPSConfig(letters_pool="gm"), folds=folds,
                    device="cuda", timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = dict(tps_grid.LAUNCHES)

    mask = torch.isfinite(cov.data).all(0)
    layers, failures = {}, []
    for r in out:
        for attr in ("final", "ensemble", "tps_surface"):
            d = getattr(r, attr).data
            if tuple(d.shape) != cov.grid.shape or not torch.isfinite(d[mask]).all():
                failures.append(f"{r.name}.{attr} is not finite over the covariate mask")
        ref = JAX_REFERENCE[dtype][r.name]
        got = {
            "kept": r.summary["best model(s):"], "weights": r.weights.weights.tolist(),
            "percent": r.summary["ensemble weights:"],
            "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"],
        }
        layers[r.name] = got
        if dtype == "float64" and got["kept"] != ref["kept"]:
            failures.append(f"{r.name} kept {got['kept']!r}, the JAX package keeps {ref['kept']!r}")
        for key in ("r2_ensemble", "r2_final"):
            if not abs(got[key] - ref[key]) <= R2_TOL[dtype]:
                failures.append(f"{r.name} {key} {got[key]} vs the JAX package's {ref[key]}")
    emit({
        "phase": "mltps_gm" if dtype == "float32" else "mltps_gm_f64",
        "seconds": time.perf_counter() - t0, "setup_s": t_setup,
        "mltps_wall_s": wall, "grid": list(cov.grid.shape), "stations": n,
        "dtype": str(cov.data.dtype), "phases_s": timer.as_dict(),
        "launches": launches, "layers": layers, "jax_reference": JAX_REFERENCE[dtype],
        "r2_tol": R2_TOL[dtype],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    })
    if launches["tps_grid"] < 6:
        failures.append(f"K1 launched {launches['tps_grid']} times on the main path, expected one per live tile (6)")
    if failures:
        raise RuntimeError("; ".join(failures))
    return launches


def main() -> int:
    logging.basicConfig(stream=sys.stderr, level=logging.INFO, format="%(name)s: %(message)s")
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    os.chdir(root)
    sys.path.insert(0, root)
    import machisplin_tpu_torch  # noqa: F401  (fails outside a checkout)

    phase_build()
    k1 = phase_kernel_k1()
    launches = phase_mltps_gm("float32")
    phase_mltps_gm("float64")
    emit({"kernels": [{
        "name": "tps_grid", "route": "cuda", "source": "machisplin_tpu_torch/csrc/tps_grid.cu",
        "replaces": "machisplin_tpu/ops/pallas_tps.py:56", "launches": launches["tps_grid"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
    }]})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output", flush=True)
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }})
    return 0


if __name__ == "__main__":
    sys.exit(main())
