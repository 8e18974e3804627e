"""Record the JAX package's mltps r² values with the extension options.

Runs ``machisplin_tpu.mltps(load_sampling(), synthetic_covariates(ds),
tps=True)`` on the CPU with the covariates in float64 over the GAM + MARS
pool with the smooth GAM and MARS at degree 2 (penalty 3) in the CV and the
finals, the sweep weight search and the tile-by-tile TPS
(``EXT_CONFIG``), with fold ids drawn by numpy (seed 0, one draw per
response: ``machisplin_tpu_torch.ensemble.kfold.numpy_folds``, the draw the
port is given).  Each response's CV residual matrix, as the weight search
sees it, also goes through ``optimize_weights_aicc`` and
``optimize_weights_lbfgsb``, and its rows' sums of squares are recorded (the
CV of both letters, whatever the search then picks).

The JAX package's sweep keeps the all-zero weight vector whenever a
perturbation clips every weight to 0 (its objective is 0/0, scored 0); that
response's ensemble is then NaN.  At downsample 1 this happens to bio_12.

The sweep's draws (its default key, the same for every response: the
candidates (4096, A) and the zoom rounds' Gaussian perturbations (20, 256,
A)) are written to ``SWEEP_DRAWS``, so the port's sweep can be given them.
Each response's sweep is replayed round by round with the JAX package's
``ensemble_objective`` on those draws, and the replay must end at the
package's own weights; it gives the round in which the search collapsed to
the all-zero vector (None if it did not) and the weights before that round.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_ext_r2.py 1

prints one JSON line per downsample factor: per response the kept letters,
the sweep's weights, r² ensemble, r² final, the AICc and L-BFGS-B subsets,
the CV residuals' sums of squares per letter and the replay's collapse round
and weights before it, and the wall time (~4 min at downsample 1 on an
8-core CPU).
"""
from __future__ import annotations

import json
import os
import sys
import time
from unittest import mock

import numpy as np

from machisplin_tpu_torch.ensemble.kfold import numpy_folds

SMOOTH = dict(smooth=True)
MARS2 = dict(degree=2, penalty=3.0)
EXT_CONFIG = dict(letters_pool="gm", final_gam=SMOOTH, final_mars=MARS2, weight_optimizer="sweep",
                  tps_batch_tiles=False)
SWEEP_DRAWS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "record_jax_ext_sweep_draws.npz")
N_CANDIDATES, N_ZOOM, N_LOCAL = 4096, 20, 256     # optimize_weights_sweep's defaults


def sweep_draws(a: int) -> dict:
    """The draws of the JAX package's ``optimize_weights_sweep`` at its
    default key for A algorithms in float64, as it makes them."""
    import jax

    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    cands = jax.random.uniform(k0, (N_CANDIDATES, a), "float64")
    noise = [jax.random.normal(kk, (N_LOCAL, a), "float64") for kk in jax.random.split(k1, N_ZOOM)]
    return {"cands": np.asarray(cands), "noise": np.stack([np.asarray(v) for v in noise])}


def replay_sweep(rmat, draws: dict, want) -> dict:
    """The JAX package's sweep round by round on ``draws`` with its own
    ``ensemble_objective``; the replay must end at ``want`` (the package's
    weights).  Returns the round in which the best became the all-zero
    vector (None if never) and the weights before that round."""
    from machisplin_tpu.ensemble.weights import ensemble_objective

    obj = lambda k: np.asarray(ensemble_objective(k, rmat))
    a = draws["cands"].shape[1]
    cands = np.concatenate([draws["cands"], np.full((1, a), 0.5)])
    best = cands[np.argmin(obj(cands))]
    best_val = float(obj(best))
    sigmas = 0.3 * 0.7 ** np.arange(N_ZOOM, dtype=np.float64)
    collapse, before = None, best
    for z in range(N_ZOOM):
        local = np.clip(best[None, :] + sigmas[z] * draws["noise"][z], 0.0, 1.0)
        vals = obj(local)
        i = int(np.argmin(vals))
        if vals[i] < best_val:
            best, best_val = local[i], float(vals[i])
        if collapse is None and best.sum() == 0:
            collapse = z
        if collapse is None:
            before = best
    np.testing.assert_allclose(best, want, rtol=0, atol=1e-12)
    return {"sweep_collapse_round": collapse, "sweep_before_collapse": [float(v) for v in before]}


def record(downsample: int) -> dict:
    import jax
    import jax.numpy as jnp

    import machisplin_tpu as mt
    from machisplin_tpu.data import load_sampling, synthetic_covariates
    from machisplin_tpu.ensemble import CVConfig
    from machisplin_tpu.ensemble import weights as jweights
    from machisplin_tpu.pipeline.mltps import MLTPSConfig

    calls, seen, rmats = [], [], []

    def injected_kfold(key, n, k=5, by=None):
        r = len(calls)
        calls.append(r)
        return jnp.asarray(numpy_folds(n, k, r + 1)[r])

    sweep = jweights.optimize_weights_sweep

    def capture(rmat, letters, **kw):
        rmats.append(np.asarray(rmat))
        seen.append({
            "aicc": jweights.optimize_weights_aicc(rmat, letters).letters,
            "lbfgsb": jweights.optimize_weights_lbfgsb(rmat, letters).letters,
            "cv_rss": [float(v) for v in (np.asarray(rmat) ** 2).sum(1)],
        })
        return sweep(rmat, letters, **kw)

    cov = synthetic_covariates(downsample=downsample)
    cov = mt.Raster(cov.data.astype("float64"), cov.grid, cov.names)
    config = MLTPSConfig(cv=CVConfig(gam=SMOOTH, mars=MARS2), **EXT_CONFIG)
    t0 = time.perf_counter()
    with mock.patch("machisplin_tpu.ensemble.cv.kfold", injected_kfold), \
            mock.patch("machisplin_tpu.pipeline.mltps.optimize_weights_sweep", capture):
        out = mt.mltps(load_sampling(), cov, tps=True, config=config)
    wall = time.perf_counter() - t0
    draws = sweep_draws(rmats[0].shape[0])
    np.savez(SWEEP_DRAWS, **draws)
    for r, rmat, extra in zip(out, rmats, seen):
        extra.update(replay_sweep(rmat, draws, np.asarray(r.weights.weights)))
    return {
        "downsample": downsample,
        "x64": bool(jax.config.jax_enable_x64),
        "wall_s": wall,
        "layers": {
            r.name: {
                "kept": r.summary["best model(s):"],
                "weights": [float(w) for w in r.weights.weights],
                "r2_ensemble": r.summary["r2 ensemble:"],
                "r2_final": r.summary["r2 final:"],
                **extra,
            }
            for r, extra in zip(out, seen)
        },
    }


if __name__ == "__main__":
    import jax

    jax.config.update("jax_enable_x64", True)
    for arg in [a for a in sys.argv[1:] if not a.startswith("--")] or ["1"]:
        print(json.dumps(record(int(arg))), flush=True)
