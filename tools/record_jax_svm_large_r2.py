"""Record the JAX package's r² for the SVM letter alone past K4's old row limits.

Builds config 3's world (``benchmarks/run_configs.py:276-297``: the smooth
"alt" covariate on the 4000 x 4000 grid of the unit square, uniform
stations, the first response ``bio_1 = 8 sin(3 lon) cos(2 lat) - 0.004 alt
+ 0.3 N(0, 1)``) for one of two cases, and runs
``machisplin_tpu.mltps(dat, covars, tps=True,
config=MLTPSConfig(letters_pool="v"), key=PRNGKey(k))`` on the CPU with the
fold ids the port is given (``numpy_folds(n, 10, 1, seed=0)``):

- ``f64_10k``: 10,000 stations (numpy seed 3, config 3's stations), the
  covariates cast to float64, x64 on;
- ``f32_24k``: 24,000 stations (numpy seed 16), float32 as built, x64 off.

With the SVM the only letter, the final fit runs on every station: 10,000
rows in float64 and 24,000 in float32, past the 8,000 / 21,152 rows the
port's kernel K4 once refused.  The SVM's sigest pairs come from the key's
threefry chain, which the port's torch generators cannot reproduce, so the
spread across keys is the JAX package's own spread across that draw.

    JAX_PLATFORMS=cpu python tools/record_jax_svm_large_r2.py --case f64_10k --keys 0,1

Part 3's TPS surfaces are evaluated on the CPU in TPS_BLOCK_ROWS-row blocks
(``tps_predict_grid``'s default 256 rows hold a (cells x knots) matrix of
~10 GB at 24,000 stations, several at once); each cell's value is the same
sum.  One process a key, ~5.5 GB at most: 3,436-9,356 s a key (float64)
and 6,247-10,340 s (float32) with four to eight at once on an 8-core CPU,
most of it part 3's surfaces on the CPU.

prints one JSON line per key: the kept letters, r² ensemble, r² final, the
seconds of each phase and the wall.  ``chip_smoke.py``'s
phases ``mltps_v_f64_10k`` and ``mltps_v_24k`` hold the port to these keys.
"""
from __future__ import annotations

import json
import os
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from machisplin_tpu_torch.ensemble.kfold import numpy_folds

SIDE = 4000
TPS_BLOCK_ROWS = 16
CASES = {"f64_10k": (10000, 3, "float64"), "f32_24k": (24000, 16, "float32")}


def world(n_stations: int, seed: int, dtype: str):
    """(station table long, lat, bio_1; covariate raster in ``dtype``)."""
    import machisplin_tpu as mt
    from machisplin_tpu.grid import GridSpec, Raster, extract

    rng = np.random.default_rng(seed)
    g = GridSpec(nrows=SIDE, ncols=SIDE, xmin=0.0, ymax=1.0, dx=1.0 / SIDE, dy=1.0 / SIDE)
    xs = np.linspace(0, 1, SIDE, dtype=np.float32)
    alt_grid = (
        1000.0
        + 2500.0 * np.exp(-(((xs[None, :] - 0.4) ** 2) + (xs[:, None] - 0.6) ** 2) / 0.05)
        + 300.0 * np.sin(9 * xs[None, :]) * np.cos(7 * xs[:, None])
    ).astype(np.float32)
    covars = Raster.host(alt_grid[None], g, ("alt",))
    lon = rng.uniform(0.001, 0.999, n_stations)
    lat = rng.uniform(0.001, 0.999, n_stations)
    alt = np.asarray(extract(covars, lon, lat))[:, 0]
    bio_1 = (8.0 * np.sin(3 * lon) * np.cos(2 * lat) - 0.004 * alt
             + 0.3 * rng.standard_normal(n_stations)).astype(np.float32)
    dat = np.rec.fromarrays([lon, lat, bio_1], names="long,lat,bio_1")
    if dtype != "float32":
        covars = mt.Raster(covars.data.astype(dtype), covars.grid, covars.names)
    return dat, covars


def record(case: str, key: int) -> dict:
    import jax
    import jax.numpy as jnp

    import machisplin_tpu as mt
    import machisplin_tpu.pipeline.mltps  # noqa: F401

    n_stations, seed, dtype = CASES[case]
    dat, covars = world(n_stations, seed, dtype)
    folds = numpy_folds(n_stations, 10, 1, seed=0)[0]

    def injected_kfold(key_, n, k=5, by=None):
        assert n == len(folds), (n, len(folds))
        return jnp.asarray(folds)

    from machisplin_tpu.utils import PhaseTimer

    jm = sys.modules["machisplin_tpu.pipeline.mltps"]     # the package re-exports the function under this name
    grid_fn = jm.tps_predict_grid

    def tps_grid_in_blocks(model, grid, **kw):
        return grid_fn(model, grid, block_rows=TPS_BLOCK_ROWS, **kw)

    timer = PhaseTimer()
    t0 = time.perf_counter()
    with mock.patch("machisplin_tpu.ensemble.cv.kfold", injected_kfold), \
            mock.patch.object(jm, "tps_predict_grid", tps_grid_in_blocks):
        r = mt.mltps(dat, covars, tps=True, config=mt.MLTPSConfig(letters_pool="v"),
                     key=jax.random.PRNGKey(key), timer=timer)[0]
    return {"case": case, "key": key, "stations": n_stations, "dtype": dtype, "x64": bool(jax.config.jax_enable_x64),
            "kept": r.summary["best model(s):"], "r2_ensemble": r.summary["r2 ensemble:"],
            "r2_final": r.summary["r2 final:"], "phases_s": {k: round(v, 2) for k, v in timer.phases.items()},
            "seconds": time.perf_counter() - t0}


if __name__ == "__main__":
    args = sys.argv[1:]
    case = args[args.index("--case") + 1]
    keys = [int(k) for k in args[args.index("--keys") + 1].split(",")] if "--keys" in args else [0]
    import jax

    jax.config.update("jax_enable_x64", CASES[case][2] == "float64")
    for k in keys:
        print(json.dumps(record(case, k)), flush=True)
