"""Record the JAX package's mltps r² values for the GAM + MARS pool.

Runs ``machisplin_tpu.mltps(load_sampling(), synthetic_covariates(ds),
tps=True, config=MLTPSConfig(letters_pool="gm"))`` on the CPU with fold ids
drawn by numpy (seed 0, one draw per response) instead of JAX's threefry
draws (``machisplin_tpu_torch.ensemble.kfold.numpy_folds``, the draw the
port is given), so that the PyTorch port can be run on the same folds and
held to these values.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_gm_r2.py [--float64] 1 4

runs the covariates in float32 (as built) or float64 and prints one JSON
line per downsample factor: kept letters, weights, r²
ensemble and r² final per response, and the wall time.
"""
from __future__ import annotations

import json
import sys
import time
from unittest import mock

from machisplin_tpu_torch.ensemble.kfold import numpy_folds


def record(downsample: int, dtype: str = "float32") -> dict:
    import jax
    import jax.numpy as jnp

    import machisplin_tpu as mt
    from machisplin_tpu.data import load_sampling, synthetic_covariates
    from machisplin_tpu.pipeline.mltps import MLTPSConfig

    calls = []

    def injected_kfold(key, n, k=5, by=None):
        r = len(calls)
        calls.append(r)
        return jnp.asarray(numpy_folds(n, k, r + 1)[r])

    cov = synthetic_covariates(downsample=downsample)
    cov = mt.Raster(cov.data.astype(dtype), cov.grid, cov.names)
    t0 = time.perf_counter()
    with mock.patch("machisplin_tpu.ensemble.cv.kfold", injected_kfold):
        out = mt.mltps(load_sampling(), cov, tps=True, config=MLTPSConfig(letters_pool="gm"))
    wall = time.perf_counter() - t0
    return {
        "downsample": downsample,
        "dtype": dtype,
        "x64": bool(jax.config.jax_enable_x64),
        "wall_s": wall,
        "layers": {
            r.name: {
                "kept": r.summary["best model(s):"],
                "weights": [float(w) for w in r.weights.weights],
                "r2_ensemble": r.summary["r2 ensemble:"],
                "r2_final": r.summary["r2 final:"],
            }
            for r in out
        },
    }


if __name__ == "__main__":
    import jax

    # station extraction in float64, as the port does it (cell-edge stations)
    jax.config.update("jax_enable_x64", True)
    dtype = "float64" if "--float64" in sys.argv else "float32"
    for arg in [a for a in sys.argv[1:] if not a.startswith("--")] or ["1"]:
        print(json.dumps(record(int(arg), dtype)), flush=True)
