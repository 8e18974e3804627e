"""Record the JAX package's tiled-landscape r² values (README Example 2).

Runs ``machisplin_tpu.tiles_create(synthetic_covariates(ds), load_sampling(),
out_ncol=2, out_nrow=2, feather_d=50)`` and then, per tile t,
``machisplin_tpu.mltps(dat_t, rast_t, tps=True, key=PRNGKey(k))`` with no
``letters_pool`` on the CPU, with fold ids drawn by numpy
(``numpy_folds(n_t, 10, 2, seed=t)``, one permutation per response), the
draw the port is given, once per JAX key.  The bag draws, the NN's initial
weights, the SVM's sigest pairs and the RF's bootstrap rows come from the
key's threefry chains, which the port's torch generators cannot reproduce,
so the spread across keys is the JAX package's own spread across those
draws: the band the port's per-tile r² is held to rests on it.

    PYTHONPATH=. JAX_PLATFORMS=cpu python tools/record_jax_tiles_r2.py --keys 0,1,2,3,4,5,6,7 1

prints one JSON line for the layout (each tile's extent and station count,
from ``tiles_create``) and then one per (downsample factor, key): per tile
the stations used, and per response the kept letters, weights, r² ensemble
and r² final, with each tile's seconds.  At downsample 1 a key took
2,868-3,119 s (442-1,008 s a tile; every tile compiles its own programs)
on an 8-core CPU with four keys running at once; start it in the
background.  On tiles of ~200 stations the keys part widely (a letter near
the 5 % weight cut is kept by some keys and not others), so record eight:
``--keys 0,1,2,3,4,5,6,7``.
"""
from __future__ import annotations

import json
import sys
import time
from unittest import mock

from machisplin_tpu_torch.ensemble.kfold import numpy_folds

TILES = {"out_ncol": 2, "out_nrow": 2, "feather_d": 50}


def layout(downsample: int) -> dict:
    import machisplin_tpu as mt
    from machisplin_tpu.data import load_sampling, synthetic_covariates

    ts = mt.tiles_create(synthetic_covariates(downsample=downsample), load_sampling(), **TILES)
    return {"downsample": downsample, "tiles": TILES, "extents": [list(e) for e in ts.extents],
            "stations": [len(d) for d in ts.dat], "shapes": [list(r.grid.shape) for r in ts.rast]}


def record(downsample: int, key: int) -> dict:
    import jax
    import jax.numpy as jnp

    import machisplin_tpu as mt
    from machisplin_tpu.data import load_sampling, synthetic_covariates

    ts = mt.tiles_create(synthetic_covariates(downsample=downsample), load_sampling(), **TILES)
    tiles = []
    t_all = time.perf_counter()
    for t, (rast, dat) in enumerate(zip(ts.rast, ts.dat)):
        calls = []

        def injected_kfold(key_, n, k=5, by=None, t=t, calls=calls):
            r = len(calls)
            calls.append(n)
            return jnp.asarray(numpy_folds(n, k, r + 1, seed=t)[r])

        t0 = time.perf_counter()
        with mock.patch("machisplin_tpu.ensemble.cv.kfold", injected_kfold):
            out = mt.mltps(dat, rast, tps=True, key=jax.random.PRNGKey(key))
        tiles.append({
            "tile": t, "stations": calls[0] if calls else None, "seconds": time.perf_counter() - t0,
            "layers": {r.name: {
                "kept": r.summary["best model(s):"],
                "weights": [float(w) for w in r.weights.weights],
                "r2_ensemble": r.summary["r2 ensemble:"],
                "r2_final": r.summary["r2 final:"],
            } for r in out},
        })
    return {"downsample": downsample, "key": key, "x64": bool(jax.config.jax_enable_x64),
            "wall_s": time.perf_counter() - t_all, "tiles": tiles}


if __name__ == "__main__":
    import jax

    # station extraction in float64, as the port does it (cell-edge stations)
    jax.config.update("jax_enable_x64", True)
    keys = [0, 1]
    args = sys.argv[1:]
    if "--keys" in args:
        keys = [int(k) for k in args[args.index("--keys") + 1].split(",")]
        del args[args.index("--keys") : args.index("--keys") + 2]
    for arg in [a for a in args if not a.startswith("--")] or ["1"]:
        print(json.dumps(layout(int(arg))), flush=True)
        for k in keys:
            print(json.dumps(record(int(arg), k)), flush=True)
