"""Record the JAX package's mltps r² values for one response (bio_1 alone).

Runs ``machisplin_tpu.mltps(<long, lat, bio_1 of load_sampling()>,
synthetic_covariates(ds), tps=True, key=PRNGKey(k))`` with no
``letters_pool`` on the CPU, with fold ids drawn by numpy (seed 0, one
draw), the draw the port is given
(``machisplin_tpu_torch.ensemble.kfold.numpy_folds``), once per JAX key.
With one response a kept BRT takes the serial gbm.step (``gbm_step.fit``)
for its final fit.  The bag draws, the NN's initial weights, the SVM's
sigest pairs and the RF's bootstrap rows and feature draws come from the
key's threefry chains, which the port's torch generators cannot reproduce,
so the spread across keys is the JAX package's own spread across those
draws: the band the port's r² is held to rests on it.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_one_r2.py --keys 0,1,2,3 1

prints one JSON line per (downsample factor, key): kept letters, weights,
r² ensemble and r² final, the BRT final's best trees where it is kept, the
seconds of each CV letter and the wall time.
"""
from __future__ import annotations

import json
import logging
import re
import sys
import time
from unittest import mock

import numpy as np

from machisplin_tpu_torch.ensemble.kfold import numpy_folds


def one_response(sampling, name: str = "bio_1"):
    """The station table with one response column: long, lat, ``name``."""
    return np.rec.fromarrays([sampling["long"], sampling["lat"], sampling[name]], names=f"long,lat,{name}")


def record(downsample: int, key: int, dtype: str = "float32") -> dict:
    import jax
    import jax.numpy as jnp

    import machisplin_tpu as mt
    from machisplin_tpu.data import load_sampling, synthetic_covariates
    from machisplin_tpu.models import gbm_step

    def injected_kfold(key_, n, k=5, by=None):
        return jnp.asarray(numpy_folds(n, k, 1)[0])

    letter_s = {}

    class LetterTimes(logging.Handler):
        def emit(self, record):
            m = re.match(r"cv letter (\w) done in ([0-9.]+) s", record.getMessage())
            if m:
                letter_s[m.group(1)] = float(m.group(2))

    best = []
    serial_fit = gbm_step.fit

    def fit_seen(*a, **kw):
        res = serial_fit(*a, **kw)
        best.append({"best_trees": int(res.best_trees), "restarts": int(res.restarts),
                     "trees_fitted": int(res.trees_fitted)})
        return res

    cv_log = logging.getLogger("machisplin_tpu.cv")
    handler = LetterTimes()
    cv_log.addHandler(handler)
    cv_log.setLevel(logging.INFO)
    cov = synthetic_covariates(downsample=downsample)
    cov = mt.Raster(cov.data.astype(dtype), cov.grid, cov.names)
    t0 = time.perf_counter()
    with mock.patch("machisplin_tpu.ensemble.cv.kfold", injected_kfold), \
            mock.patch.object(gbm_step, "fit", fit_seen):
        out = mt.mltps(one_response(load_sampling()), cov, tps=True, key=jax.random.PRNGKey(key))
    cv_log.removeHandler(handler)
    wall = time.perf_counter() - t0
    layers = {
        r.name: {
            "kept": r.summary["best model(s):"],
            "weights": [float(w) for w in r.weights.weights],
            "r2_ensemble": r.summary["r2 ensemble:"],
            "r2_final": r.summary["r2 final:"],
        }
        for r in out
    }
    return {
        "downsample": downsample,
        "key": key,
        "dtype": dtype,
        "x64": bool(jax.config.jax_enable_x64),
        "wall_s": wall,
        "cv_letter_s": letter_s,
        "brt_final": best,
        "layers": layers,
    }


if __name__ == "__main__":
    import jax

    # station extraction in float64, as the port does it (cell-edge stations)
    jax.config.update("jax_enable_x64", True)
    dtype = "float64" if "--float64" in sys.argv else "float32"
    keys = [0, 1]
    args = sys.argv[1:]
    if "--keys" in args:
        keys = [int(k) for k in args[args.index("--keys") + 1].split(",")]
        del args[args.index("--keys") : args.index("--keys") + 2]
    for arg in [a for a in args if not a.startswith("--")] or ["1"]:
        for k in keys:
            print(json.dumps(record(int(arg), k, dtype)), flush=True)
