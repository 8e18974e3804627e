"""The remaining ``MLTPSConfig`` options of the PyTorch port against the JAX
package and against each other, on the CPU in float64:

* ``tps_batch_tiles=False`` (each tile fitted alone, the reference's tile
  loop) against the batched masked solves and against the JAX package's
  tile loop on a small grid, one tile below ``min_tile_points``;
* ``batch_final_rf=False`` (each response's forest grown, rated and
  predicted alone) against the merged pass, from the same draws;
* the slice's large-station path as a whole: ``nystrom_tps_fit`` on the JAX
  package's landmarks, then the grid prediction (K1's plain version here),
  against the JAX package's fit and ``tps_predict_grid``;
* ``mltps`` over the GAM + MARS pool with the smooth GAM, MARS at degree 2,
  the sweep weight search and the tile loop together.
"""
import importlib
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import machisplin_tpu as mt
import machisplin_tpu_torch as mtt
from machisplin_tpu.ops import nystrom as jnys, tps as jtps
from machisplin_tpu_torch.ensemble.cv import CVConfig as TCVConfig
from machisplin_tpu_torch.ensemble.kfold import numpy_folds
from machisplin_tpu_torch.grid import GridSpec, Raster
from machisplin_tpu_torch.ops import nystrom as tnys, tps as ttps
from machisplin_tpu_torch.utils.timing import PhaseTimer
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

# the pipeline packages re-export the mltps function under the module's name
jmltps = importlib.import_module("machisplin_tpu.pipeline.mltps")
tmltps = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")

SMOOTH = dict(smooth=True, k=6, ngrid=8)
MARS2 = dict(degree=2, penalty=3.0, n_pairs=4, n_knots=16)
SURF_TOL = 2e-8     # float64 surfaces, of their range (the JAX fits compiled whole round differently)


def _tile_world():
    """A 10 x 30 grid split into 1 x 3 tiles of 10 px; 30 stations in each
    of the first two tiles' cores (outside every other tile's fit extent)
    and 5 in the third's, which makes it a zero surface."""
    rng = np.random.default_rng(4)
    grid = GridSpec(nrows=10, ncols=30, xmin=0.0, ymax=1.0, dx=0.1, dy=0.1)
    xs = np.concatenate([rng.uniform(0.25, 0.75, 30), rng.uniform(1.25, 1.75, 30), rng.uniform(2.25, 2.75, 5)])
    coords = np.stack([xs, rng.uniform(0.05, 0.95, len(xs))], axis=1)
    res = np.stack([np.sin(2 * coords[:, 0]) + 0.1 * rng.standard_normal(len(coords)),
                    np.cos(3 * coords[:, 1]) * coords[:, 0]], axis=1)
    cov = rng.uniform(0, 1, (1,) + grid.shape)
    return grid, coords, res, cov


def test_tile_loop_matches_batched_and_jax():
    grid, coords, res, cov = _tile_world()
    cfg = dict(tps_tile_px=10, predict_block_rows=8)
    stack = Raster(torch.as_tensor(cov), grid)
    loop, n_tiles = tmltps._tps_error_surface(coords, res, stack, tmltps.MLTPSConfig(tps_batch_tiles=False, **cfg))
    batched, _ = tmltps._tps_error_surface(coords, res, stack, tmltps.MLTPSConfig(**cfg))
    jstack = mt.Raster(jnp.asarray(cov), mt.GridSpec(**grid.__dict__))
    # the JAX package's tile loop with its per-tile tps_fit compiled once
    # (eager, its first call takes ~5 s of op-by-op compiles)
    with mock.patch.object(jmltps, "tps_fit", jax.jit(jtps.tps_fit, static_argnames=("ngrid", "refine"))):
        want, _ = jmltps._tps_error_surface(coords, res, jstack, jmltps.MLTPSConfig(tps_batch_tiles=False, **cfg))
    assert n_tiles == 3 and loop.data.shape == (2,) + grid.shape
    want = np.asarray(want.data)
    span = np.ptp(want)
    assert (np.abs(want[:, :, 25:]) == 0).all()                    # the third tile's zero surface
    np.testing.assert_allclose(loop.data.numpy(), want, rtol=0, atol=SURF_TOL * span)
    # the batched masked solve is the per-tile fit, up to round-off
    np.testing.assert_allclose(batched.data.numpy(), loop.data.numpy(), rtol=0, atol=1e-7 * span)


@pytest.mark.parametrize("mtry", [None, 3])
def test_rf_finals_serial_equal_merged(mtry):
    """One forest per response, each predicted in its own raster pass,
    against the merged pass: the same draws (``rf.draw``, from one
    generator seed) give the same forests, so the surfaces and station
    predictions agree (both through the forest predictor in float32).  With
    mtry = p no node scores are drawn."""
    rng = np.random.default_rng(3)
    x = rng.uniform(0, 1, (90, 3))
    y = np.stack([np.sin(4 * x[:, 0]) + x[:, 1], x[:, 2] ** 2 - x[:, 0]], axis=1)
    cells = rng.uniform(0, 1, (3, 5, 6))
    cells[0, 1, 2] = np.nan
    stack = Raster(torch.as_tensor(cells), GridSpec(nrows=5, ncols=6, xmin=0.0, ymax=1.0, dx=0.1, dy=0.1))
    cfg = tmltps.MLTPSConfig(final_rf=dict(ntree=12, max_depth=4, n_bins=16, mtry=mtry), predict_block_rows=2)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    timers = PhaseTimer(), PhaseTimer()
    merged = tmltps._final_rf_batched(xt, yt, list("abc"), stack, cfg, torch.Generator().manual_seed(9), timers[0])
    serial = tmltps._final_rf_serial(xt, yt, list("abc"), stack, cfg, torch.Generator().manual_seed(9), timers[1])
    assert {"raster_predict_r_0", "raster_predict_r_1"} <= set(timers[1].phases)
    assert "raster_predict_r_x2" in timers[0].phases
    for a, b in zip(merged[:2], serial[:2]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a.numpy()), np.isnan(b.numpy()))
        ok = ~np.isnan(a.numpy())
        np.testing.assert_allclose(b.numpy()[ok], a.numpy()[ok], rtol=0, atol=1e-6 * np.ptp(y))
    for ia, ib in zip(merged[2], serial[2]):
        assert ia == ib


@pytest.mark.parametrize("n_resp", [1, 3])
def test_nystrom_surface_matches_jax(n_resp):
    """The slice's path as a whole at a small size: landmarks drawn by numpy
    and given to both packages, the reduced-basis fit, then the surface over
    a grid (the port's K1 plain version, the JAX package's jnp path).  The
    shapes are test_torch_nystrom.py's (3,000 stations, 128 landmarks,
    chunks of 777), so one process compiles the JAX fit once for both."""
    rng = np.random.default_rng(5)
    n, m = 3000, 128
    coords = rng.uniform(0, 1, (n, 2))
    y = np.stack([np.sin(6 * coords[:, 0]) * np.cos(5 * coords[:, 1]), coords[:, 0] * coords[:, 1],
                  np.cos(4 * coords[:, 1])], axis=1)
    y = (y + 0.1 * rng.standard_normal(y.shape))[:, :n_resp].squeeze()
    lm = coords[np.random.default_rng(1).choice(n, m, replace=False)]
    grid = GridSpec(nrows=40, ncols=50, xmin=0.0, ymax=1.0, dx=0.02, dy=0.025)
    jm = jnys.nystrom_tps_fit(jnp.asarray(coords), jnp.asarray(y), landmarks=jnp.asarray(lm), chunk=777)
    want = np.asarray(jtps.tps_predict_grid(jm, mt.GridSpec(**grid.__dict__), use_pallas=False))
    tm_ = tnys.nystrom_tps_fit(torch.as_tensor(coords), torch.as_tensor(y), landmarks=lm, chunk=777, device="cpu")
    got = ttps.tps_predict_grid(tm_, grid, block_rows=16)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-8 * np.ptp(want))


def test_mltps_options_run_together():
    """``mltps`` over "gm" at downsample 48 (2 x 3 TPS tiles) with the smooth
    GAM and MARS at degree 2 in the CV and the finals, the sweep weight
    search and the tile loop: each response's weights are the sweep's over
    its CV residuals (the matrix captured as the search sees it), the GAM's
    importance is the smooth report, surfaces finite.  (Each option is held
    to the JAX package above and in test_torch_smooth_models.py and
    test_torch_weights_rdata.py; ``chip_smoke.py`` holds this run at full
    size to the JAX package's.)"""
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    cov = Raster(cov.data.to(torch.float64), cov.grid, cov.names)
    seen = []
    sweep = tmltps.optimize_weights_sweep

    def capture(rmat, letters):
        seen.append(rmat.clone())
        return sweep(rmat, letters)

    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    cfg = tmltps.MLTPSConfig(cv=TCVConfig(n_folds=3, gam=SMOOTH, mars=MARS2), letters_pool="gm", tps_tile_px=30,
                             final_gam=SMOOTH, final_mars=MARS2, weight_optimizer="sweep", tps_batch_tiles=False)
    tmltps.optimize_weights_sweep = capture
    try:
        out = mtt.mltps(s, cov, tps=True, config=cfg, folds=numpy_folds(n, 3, 2, seed=0), device="cpu")
    finally:
        tmltps.optimize_weights_sweep = sweep
    assert len(seen) == 2
    for r, rmat in zip(out, seen):
        want = sweep(rmat, "gm")
        np.testing.assert_array_equal(r.weights.weights, want.weights)
        assert r.summary["ensemble weights:"] == want.percent_text
        assert np.isfinite(r.tps_surface.data.numpy()).all() and r.tps_surface.data.shape == cov.grid.shape
        if "gam" in r.var_imp:
            assert {"edf", "lambda"} <= set(r.var_imp["gam"])
    with pytest.raises(ValueError, match="weight_optimizer"):
        mtt.mltps(s, cov, config=tmltps.MLTPSConfig(weight_optimizer="grid"), device="cpu")
