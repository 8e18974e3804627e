"""The slice as a whole: the PyTorch port's ``mltps`` over the GAM + MARS pool
against the JAX package's, on the CPU in float64.

``synthetic_covariates(downsample=48)`` with ``tps_tile_px=30`` gives 2 x 3
TPS tiles, so the batched masked tile solve, the grid prediction (the plain
version of kernel K1 on the CPU) and the seam feathering all run.  The port
is given the JAX package's own CV folds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import machisplin_tpu as mt
import machisplin_tpu_torch as mtt
from machisplin_tpu.ensemble.kfold import kfold as jax_kfold
from machisplin_tpu.pipeline.mltps import MLTPSConfig as JConfig
from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig as TConfig
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)


@pytest.fixture(scope="module")
def both_runs():
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    data = cov.data.numpy().astype(np.float64)
    sampling = mtt.load_sampling()
    jres = mt.mltps(
        sampling, mt.Raster(jnp.asarray(data), mt.GridSpec(**cov.grid.__dict__), cov.names),
        tps=True, config=JConfig(letters_pool="gm", tps_tile_px=30),
    )
    n = len(jres[0].residuals)
    # mltps's CV key: fold_in(PRNGKey(0), 777), then run_cv's first split
    kf = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 777), 5)[0]
    folds = np.stack([np.asarray(jax_kfold(jax.random.fold_in(kf, r), n, 10)) for r in range(2)])
    tres = mtt.mltps(
        sampling, mtt.Raster(torch.as_tensor(data), cov.grid, cov.names), tps=True,
        config=TConfig(letters_pool="gm", tps_tile_px=30), folds=folds, device="cpu",
    )
    return jres, tres


def test_mltps_gm_matches_jax(both_runs):
    jres, tres = both_runs
    assert [r.name for r in tres] == [r.name for r in jres] == ["bio_1", "bio_12"]
    for j, t in zip(jres, tres):
        assert t.summary["best model(s):"] == j.summary["best model(s):"]
        assert t.summary["ensemble weights:"] == j.summary["ensemble weights:"]
        np.testing.assert_allclose(t.weights.weights, j.weights.weights, atol=1e-6)
        np.testing.assert_allclose(t.summary["r2 ensemble:"], j.summary["r2 ensemble:"], atol=1e-5)
        np.testing.assert_allclose(t.summary["r2 final:"], j.summary["r2 final:"], atol=1e-5)
        for attr in ("final", "ensemble", "tps_surface"):
            want = np.asarray(getattr(j, attr).data)
            got = getattr(t, attr).data.numpy()
            assert got.shape == want.shape and np.isfinite(got).all(), attr
            span = float(np.nanmax(want) - np.nanmin(want))
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * span, err_msg=attr)
        np.testing.assert_allclose(t.residuals, j.residuals, rtol=0, atol=1e-4 * np.ptp(j.residuals[:, 0]))
        assert list(t.var_imp) == list(j.var_imp)


def test_mltps_tps_kept_only_if_r2_improves(both_runs):
    _, tres = both_runs
    for t in tres:
        improved = t.summary["r2 final:"] > t.summary["r2 ensemble:"]
        want = t.ensemble.data + t.tps_surface.data if improved else t.ensemble.data
        np.testing.assert_array_equal(t.final.data.numpy(), want.numpy())


def test_mltps_unported_pool_raises():
    """The default pool is ported whole, and the serial gbm.step with it:
    ``batch_final_brt=False`` (once refused) runs each response's BRT final
    through ``gbm_step.fit`` and agrees with the JAX package's run within the
    BRT band (``test_torch_brt.R2_BAND``: the bags are torch draws here).
    The batched drivers' ``global_bins=False`` (the shared- and
    per-fold-bins branches, once refused) runs now, and so does MARS at
    degree 2 (once refused too), with the JAX package's picks, parents and
    predictions."""
    from machisplin_tpu.ensemble import CVConfig as JCVConfig
    from machisplin_tpu_torch.ensemble.cv import CVConfig as TCVConfig
    from machisplin_tpu_torch.models import gbm_step as tgbm, mars as tmars
    from test_torch_brt import R2_BAND

    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    data = cov.data.numpy()
    brt = dict(tree_complexity=2, learning_rate=0.1, bag_fraction=0.5, n_folds=3, step_size=10, max_trees=20,
               n_bins=16)
    jcfg = JConfig(letters_pool="b", batch_final_brt=False, cv=JCVConfig(n_folds=3, brt=brt), final_brt=brt)
    jres = mt.mltps(mtt.load_sampling(), mt.Raster(jnp.asarray(data), mt.GridSpec(**cov.grid.__dict__), cov.names),
                    tps=False, trouble=True, config=jcfg)
    cfg = TConfig(letters_pool="b", batch_final_brt=False, cv=TCVConfig(n_folds=3, brt=brt), final_brt=brt)
    tres = mtt.mltps(mtt.load_sampling(), mtt.Raster(torch.as_tensor(data), cov.grid, cov.names), tps=False,
                     trouble=True, config=cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for j, t in zip(jres, tres):
        assert t.summary["best model(s):"] == j.summary["best model(s):"] == "b"
        assert abs(t.summary["r2 ensemble:"] - j.summary["r2 ensemble:"]) <= R2_BAND, t.name
        assert np.isfinite(t.ensemble.data.numpy()).all()
    x = torch.rand((40, 3), dtype=torch.float64)
    for shared in (True, False):
        res = tgbm.fit_multi(x, torch.rand((40, 2), dtype=torch.float64), global_bins=False, shared_bins=shared,
                             generator=torch.Generator().manual_seed(0), **brt)
        assert [r.best_trees % brt["step_size"] for r in res] == [0, 0]
        assert all(torch.isfinite(r.final.train_fit).all() for r in res)
    from machisplin_tpu.models import mars as jmars

    y2 = torch.rand(40, dtype=torch.float64)
    kw = dict(degree=2, penalty=3.0, n_pairs=3, n_knots=8)
    want = jmars.fit(None, jnp.asarray(x.numpy()), jnp.asarray(y2.numpy()), **kw)
    got = tmars.fit(x, y2, **kw)
    for f in ("vars", "parent", "pair_active", "active"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    np.testing.assert_allclose(tmars.predict(got, x).numpy(), np.asarray(jmars.predict(want, jnp.asarray(x.numpy()))),
                               rtol=0, atol=1e-9)
