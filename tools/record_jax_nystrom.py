"""Record the JAX package's large-station TPS fits for ``chip_smoke.py``.

Runs, on the CPU in float32 (the coordinates' dtype of BASELINE configs 3
and 4, ``benchmarks/run_configs.py``), with landmarks drawn by numpy
(``default_rng(1).choice(n, m, replace=False)``) instead of JAX's threefry
subsample, so that the PyTorch port can be given the same landmarks:

* ``config4``: 100,000 stations, ``y = sin(6x) cos(5y) + 0.1 N`` (numpy
  ``default_rng(0)``), ``nystrom_tps_fit`` at 4,096 landmarks: lambda, GCV,
  effective df, the fitted values at 2,000 fixed stations and the surface at
  4,096 fixed cells of the 10,000 x 10,000 grid over the unit square;
* ``config3``: 10,000 stations x 19 responses (``default_rng(0)``, as
  ``run_configs.config3`` draws them), ``nystrom_tps_fit`` at 2,048
  landmarks: lambda per response and the fitted values at 200 fixed
  stations; and the float64 host fit (``tps_fit_host``) of the first 3,000
  stations: lambda and GCV per response.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_nystrom.py > tools/record_jax_nystrom.json

(~5 min on an 8-core CPU.)  ``chip_smoke.py`` reads the JSON file.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

CHUNK = 16384


def config4_data():
    """(coords (n, 2), y (n,)) float32, as run_configs.config4 draws them."""
    rng = np.random.default_rng(0)
    n = 100_000
    coords = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    y = (np.sin(6 * coords[:, 0]) * np.cos(5 * coords[:, 1]) + 0.1 * rng.standard_normal(n)).astype(np.float32)
    return coords, y


def config3_data():
    """(coords (n, 2), ys (n, 19)) float32, as run_configs.config3 draws them."""
    rng = np.random.default_rng(0)
    n, r = 10_000, 19
    coords = rng.uniform(0, 1, (n, 2)).astype(np.float32)
    ys = np.stack([
        np.sin((3 + 0.2 * j) * coords[:, 0]) * np.cos((2 + 0.1 * j) * coords[:, 1]) + 0.05 * rng.standard_normal(n)
        for j in range(r)
    ], axis=1).astype(np.float32)
    return coords, ys


def landmark_idx(n: int, m: int) -> np.ndarray:
    return np.random.default_rng(1).choice(n, m, replace=False)


def fixed_stations(n: int, k: int) -> np.ndarray:
    return np.sort(np.random.default_rng(2).choice(n, k, replace=False))


def fixed_cells(side: int, k: int) -> np.ndarray:
    """(k, 2) row, col of fixed cells of a side x side grid."""
    return np.random.default_rng(3).integers(0, side, (k, 2))


def cell_centres(rc: np.ndarray, side: int) -> np.ndarray:
    """Cell centres of the unit-square grid (xmin 0, ymax 1, cell 1/side) in
    float32, as the grid kernel computes them."""
    d = np.float32(1.0 / side)
    x = (rc[:, 1].astype(np.float32) + np.float32(0.5)) * d
    y = np.float32(1.0) - (rc[:, 0].astype(np.float32) + np.float32(0.5)) * d
    return np.stack([x, y], axis=1)


def record() -> dict:
    import jax.numpy as jnp

    from machisplin_tpu.ops.host_tps import tps_fit_host
    from machisplin_tpu.ops.nystrom import nystrom_tps_fit
    from machisplin_tpu.ops.tps import tps_predict

    out = {}
    t0 = time.perf_counter()
    coords, y = config4_data()
    idx = landmark_idx(len(coords), 4096)
    model = nystrom_tps_fit(jnp.asarray(coords), jnp.asarray(y), landmarks=jnp.asarray(coords[idx]), chunk=CHUNK)
    st = fixed_stations(len(coords), 2000)
    rc = fixed_cells(10_000, 4096)
    surf = np.asarray(tps_predict(model, jnp.asarray(cell_centres(rc, 10_000))))
    out["config4"] = {
        "lam": float(model.lam), "gcv": float(model.gcv), "eff_df": float(model.eff_df),
        "fitted": [float(v) for v in np.asarray(model.fitted)[st]], "surface": [float(v) for v in surf],
        "seconds": time.perf_counter() - t0,
    }
    t0 = time.perf_counter()
    coords, ys = config3_data()
    idx = landmark_idx(len(coords), 2048)
    model = nystrom_tps_fit(jnp.asarray(coords), jnp.asarray(ys), landmarks=jnp.asarray(coords[idx]), chunk=CHUNK)
    st = fixed_stations(len(coords), 200)
    host = tps_fit_host(coords[:3000], ys[:3000])
    out["config3"] = {
        "lam": [float(v) for v in np.asarray(model.lam)], "gcv": [float(v) for v in np.asarray(model.gcv)],
        "fitted": np.asarray(model.fitted)[st].astype(float).tolist(),
        "host_lam": [float(v) for v in np.asarray(host.lam)], "host_gcv": [float(v) for v in np.asarray(host.gcv)],
        "seconds": time.perf_counter() - t0,
    }
    return out


if __name__ == "__main__":
    import jax

    if jax.config.jax_enable_x64:
        sys.exit("run with float32 defaults (jax_enable_x64 off)")
    json.dump(record(), sys.stdout)
    print()
