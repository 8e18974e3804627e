"""Record the JAX package's r² on the tiles of its config4_pipeline_full.

Builds the world of ``benchmarks/run_configs.py:180-208`` (numpy seed 7,
4,000 uniform stations, response ``bio_1``) on the published 10,000 x
10,000 grid and, for the rasters, on a ``--side`` x ``--side`` one (1,000
by default, ``feather_d`` scaled to keep the published 0.005 of the
square; every tile keeps its published stations), runs
``machisplin_tpu.tiles_create(out_ncol=2, out_nrow=2)`` and then, per
requested tile t (0-based) and JAX key k,
``machisplin_tpu.mltps(dat_t, rast_t, tps=True, config=MLTPSConfig(),
key=PRNGKey(k))`` on the CPU with the fold ids the port is given
(``numpy_folds(n_t, 10, 1, seed=t)``).  mltps's station inputs
(coordinates, covariates, responses) are the published grid's (its
``_prepare_inputs`` patched), so that the CV, the weights and f see the
published inputs; its final fits predict, and part 3 fits, on the smaller
grid.  The bag draws, the NN's initial weights, the SVM's sigest pairs and
the RF's bootstrap rows come from the key's threefry chains, which the
port's torch generators cannot reproduce, so the spread across keys is the
JAX package's own spread across those draws.

    JAX_PLATFORMS=cpu python tools/record_jax_config4_r2.py --tiles 0,1 --keys 0,1

prints one JSON line for the layout (each tile's station count) and then
one per (tile, key): the kept letters, the weights, f = sum of the kept
rounded weights / the unrounded total (the ensemble-total scale of
V73:619-620), r² ensemble and r² final, and the seconds (666-1,157 s a tile
with four keys at once on an 8-core CPU; one process a key).

x64 stays off, as in the published run (``--x64`` turns it on: the JAX
package's NN then keeps L-BFGS state in float64).  ``--station`` stops
after the CV and the weight search (part 1: no final fit, no raster) and
adds the GAM's and MARS's CV residuals beside the port's
``run_cv(algorithms="gm")`` on the CPU with the same folds, in float32 and,
with ``--x64``, in float64 (neither letter draws anything).

``--port SEEDS`` runs the port's part 1 instead, without JAX, on the card
(``--device``, default ``cuda``): per tile and torch generator seed the
same line as ``--station`` (the chip phase ``pipeline_config4_full`` gives
tile t the seed t).

    python3 tools/record_jax_config4_r2.py --port 0,1,2,3 --tiles 0,1
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

PUBLISHED_SIDE = 10000
PUBLISHED_FEATHER = 50
N_STATIONS = 4000


def _alt(side: int) -> np.ndarray:
    """run_configs.py:192-197's "alt" covariate on a side x side grid."""
    xs = np.linspace(0, 1, side, dtype=np.float32)
    return (
        1000.0
        + 2500.0 * np.exp(-(((xs[None, :] - 0.4) ** 2) + (xs[:, None] - 0.6) ** 2) / 0.05)
        + 300.0 * np.sin(9 * xs[None, :]) * np.cos(7 * xs[:, None])
    ).astype(np.float32)


def _stations(extract_alt):
    """run_configs.py:199-208's stations and response, the covariate at the
    stations from ``extract_alt(lon, lat)``."""
    rng = np.random.default_rng(7)
    lon = rng.uniform(0.001, 0.999, N_STATIONS)
    lat = rng.uniform(0.001, 0.999, N_STATIONS)
    resp = 0.004 * extract_alt(lon, lat) - 8.0 * np.cos(4 * lon) + 3.0 * lat + 0.2 * rng.standard_normal(N_STATIONS)
    return np.rec.fromarrays([lon, lat, resp], names="long,lat,bio_1")


def jax_tiles(side: int):
    """(published tiles, tiles of the side x side rasters with the published
    stations): the JAX package's tiles_create on host rasters."""
    import machisplin_tpu as mt
    from machisplin_tpu.grid import GridSpec, Raster, extract

    def covars(s):
        g = GridSpec(nrows=s, ncols=s, xmin=0.0, ymax=1.0, dx=1.0 / s, dy=1.0 / s)
        return Raster.host(_alt(s)[None], g, ("alt",))

    pub_covars = covars(PUBLISHED_SIDE)
    dat = _stations(lambda lon, lat: np.asarray(extract(pub_covars, lon, lat))[:, 0])
    pub = mt.tiles_create(pub_covars, dat, out_ncol=2, out_nrow=2, feather_d=PUBLISHED_FEATHER)
    del pub_covars
    feather = max(1, round(PUBLISHED_FEATHER * side / PUBLISHED_SIDE))
    small = mt.tiles_create(covars(side), dat, out_ncol=2, out_nrow=2, feather_d=feather)
    assert [len(d) for d in small.dat] == [len(d) for d in pub.dat]
    return pub, small, feather


def _folds_patch(t: int):
    import jax.numpy as jnp

    def injected_kfold(key_, n, k=5, by=None):
        return jnp.asarray(numpy_folds(n, k, 1, seed=t)[0])

    return mock.patch("machisplin_tpu.ensemble.cv.kfold", injected_kfold)


def _published_inputs_patch(pub_rast, pub_dat):
    """mltps's station inputs from the published grid's tile, its rasters
    from the one it is given."""
    import machisplin_tpu.pipeline.mltps  # noqa: F401  (the package re-exports the function under this name)

    jm = sys.modules["machisplin_tpu.pipeline.mltps"]
    orig = jm._prepare_inputs
    _, _, coords, x, responses = orig(pub_dat, pub_rast)

    def prepare(int_values, covar_ras):
        stack_, names, _, _, _ = orig(int_values, covar_ras)
        return stack_, names, coords, x, responses

    return mock.patch.object(jm, "_prepare_inputs", prepare)


def _weights(wres) -> dict:
    kept = [float(w) for w in wres.kept_weights]
    return {"kept": wres.letters, "weights": [float(w) for w in wres.weights], "percent": wres.percent_text,
            "f": sum(kept) / float(wres.weight_total)}


def record_full(pub, small, t: int, key: int) -> dict:
    import jax

    import machisplin_tpu as mt

    t0 = time.perf_counter()
    with _folds_patch(t), _published_inputs_patch(pub.rast[t], pub.dat[t]):
        r = mt.mltps(small.dat[t], small.rast[t], tps=True, config=mt.MLTPSConfig(), key=jax.random.PRNGKey(key))[0]
    return {"tile": t, "key": key, "stations": len(small.dat[t]), **_weights(r.weights),
            "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"],
            "seconds": time.perf_counter() - t0}


def record_station(pub, t: int, key: int) -> dict:
    import jax
    import jax.numpy as jnp
    import torch

    import machisplin_tpu as mt
    from machisplin_tpu.ensemble.cv import residual_matrix, run_cv
    from machisplin_tpu.ensemble.weights import optimize_weights_lbfgsb
    from machisplin_tpu.pipeline.mltps import _prepare_inputs
    from machisplin_tpu_torch.ensemble.cv import run_cv as torch_run_cv

    t0 = time.perf_counter()
    _, _, _, x_host, responses = _prepare_inputs(pub.dat[t], pub.rast[t])
    y = np.asarray(responses["bio_1"])
    cfg = mt.MLTPSConfig()

    def jax_cv(dtype, letters):
        with _folds_patch(t):
            cv = run_cv(jax.random.fold_in(jax.random.PRNGKey(key), 777), jnp.asarray(x_host, dtype),
                        jnp.asarray(y[:, None], dtype), config=cfg.cv, algorithms=letters)
        return {k: np.asarray(v[0] if v.ndim == 2 else v).astype(np.float64) for k, v in cv.items()}

    cv = jax_cv(np.float32, "bgnmrv")
    wres = optimize_weights_lbfgsb(residual_matrix(cv, "bgnmrv"), "bgnmrv")
    out = {"tile": t, "key": key, "stations": len(y), **_weights(wres),
           "cv_rss": {k: float(np.sum(v ** 2)) for k, v in cv.items()}, "gm_vs_port": {}}
    folds = numpy_folds(len(y), 10, 1, seed=t)
    for dtype in [np.float32, np.float64] if jax.config.jax_enable_x64 else [np.float32]:
        want = cv if dtype == np.float32 else jax_cv(dtype, "gm")
        mine = torch_run_cv(torch.from_numpy(np.asarray(x_host, dtype)), torch.from_numpy(y.astype(dtype)),
                            algorithms="gm", folds=folds, generator=torch.Generator().manual_seed(0))
        for k in "gm":
            got = np.asarray(mine[k]).astype(np.float64)
            out["gm_vs_port"][f"{k}_{np.dtype(dtype).name}"] = {
                "jax_rss": float(np.sum(want[k] ** 2)), "port_rss": float(np.sum(got ** 2)),
                "max_abs_diff": float(np.max(np.abs(got - want[k]))), "scale": float(np.max(np.abs(want[k])))}
    out["seconds"] = time.perf_counter() - t0
    return out


def record_port(want, seeds, device: str):
    """The port's CV and weight search, as mltps runs them, per tile and
    torch seed, on the published grid."""
    import torch

    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.cv import residual_matrix, run_cv
    from machisplin_tpu_torch.ensemble.weights import optimize_weights_lbfgsb
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig, _prepare_inputs

    side = PUBLISHED_SIDE
    g = mtt.GridSpec(nrows=side, ncols=side, xmin=0.0, ymax=1.0, dx=1.0 / side, dy=1.0 / side)
    covars = mtt.Raster(torch.from_numpy(_alt(side)[None]).to(device), g, ("alt",))
    dat = _stations(lambda lon, lat: mtt.extract(covars, lon, lat)[:, 0].cpu().numpy())
    ts = mtt.tiles_create(covars, dat, out_ncol=2, out_nrow=2, feather_d=PUBLISHED_FEATHER)
    print(json.dumps({"side": side, "stations": [len(d) for d in ts.dat], "port": True}), flush=True)
    cfg = MLTPSConfig()
    for t in want:
        _, _, _, x, responses = _prepare_inputs(ts.dat[t], ts.rast[t])
        x = torch.as_tensor(x, dtype=ts.rast[t].data.dtype, device=device)
        y = torch.as_tensor(responses["bio_1"], dtype=x.dtype, device=device)
        folds = numpy_folds(len(y), 10, 1, seed=t)
        for seed in seeds:
            t0 = time.perf_counter()
            cv = run_cv(x, y[:, None], config=cfg.cv, algorithms="bgnmrv", folds=folds,
                        generator=torch.Generator().manual_seed(seed))
            cv = {k: np.asarray(v[0]) for k, v in cv.items()}
            wres = optimize_weights_lbfgsb(residual_matrix(cv, "bgnmrv"), "bgnmrv")
            print(json.dumps({"tile": t, "seed": seed, "stations": len(y), **_weights(wres),
                              "cv_rss": {k: float(np.sum(v.astype(np.float64) ** 2)) for k, v in cv.items()},
                              "seconds": time.perf_counter() - t0}), flush=True)


def _arg(args, name, default):
    if name in args:
        i = args.index(name)
        val = args[i + 1]
        del args[i : i + 2]
        return val
    return default


if __name__ == "__main__":
    args = sys.argv[1:]
    want = [int(t) for t in _arg(args, "--tiles", "0,1").split(",")]
    port_seeds = _arg(args, "--port", None)
    if port_seeds is not None:
        record_port(want, [int(s) for s in port_seeds.split(",")], _arg(args, "--device", "cuda"))
        sys.exit(0)
    import jax

    x64 = "--x64" in args
    jax.config.update("jax_enable_x64", x64)
    side = int(_arg(args, "--side", "1000"))
    keys = [int(k) for k in _arg(args, "--keys", "0,1").split(",")]
    station = "--station" in args
    pub, small, feather = jax_tiles(side)
    print(json.dumps({"side": side, "feather_d": feather, "stations": [len(d) for d in pub.dat],
                      "shapes": [list(r.grid.shape) for r in small.rast], "station_only": station, "x64": x64}),
          flush=True)
    for t in want:
        for k in keys:
            line = record_station(pub, t, k) if station else record_full(pub, small, t, k)
            print(json.dumps({**line, "x64": x64}), flush=True)
