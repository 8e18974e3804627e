"""The GAM's smooth extension and MARS at degree 2 in the PyTorch port
against the JAX package, on the CPU in float64: ``_bspline_basis``,
``fit_smooth`` (weighted, batched over lanes), predict beyond the training
range, importance, the converters, and the CV letters with these options.

Station covariates come from ``sampling.csv`` on the synthetic covariate
stack at downsample 48; both packages get the same numpy arrays.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machisplin_tpu.ensemble import cv as jcv
from machisplin_tpu.models import gam as jgam, mars as jmars
from machisplin_tpu_torch import convert, data as tdata, grid as tgrid
from machisplin_tpu_torch.ensemble import cv as tcv
from machisplin_tpu_torch.models import gam as tgam, mars as tmars
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

# the ensemble package re-exports the kfold function under the module's name
jkfold = importlib.import_module("machisplin_tpu.ensemble.kfold")

NAMES = ["alt", "slope", "TWI", "LONG", "LAT"]
SMOOTH = dict(smooth=True, k=8, ngrid=12)
MARS2 = dict(degree=2, penalty=3.0, n_pairs=5, n_knots=16)
# predictions: float64 round-off (the penalised systems carry a 1e-8 ridge)
PRED_TOL = 1e-9
# coefficients of the smooth GAM: its spline blocks hold the linear terms'
# direction too, so the 1e-8-ridged system leaves ~1e-7 relative freedom
COEF_RTOL = 1e-5


# the JAX package's fits, compiled once for the file (eager, each takes ~10 s)
jgam_fit = jax.jit(lambda x, y, w: jgam.fit(None, x, y, sample_weight=w, **SMOOTH))
jmars_fit = jax.jit(lambda x, y, w: jmars.fit(None, x, y, sample_weight=w, **MARS2))


@pytest.fixture(scope="module")
def stations():
    """(x (n, 5) station covariates, ys (n, 2), a CV-like 0/1 train mask
    (3, n)) in float64."""
    cov = tdata.synthetic_covariates(downsample=48, device="cpu")
    s = tdata.load_sampling()
    stk = tgrid.stack([cov, tgrid.lonlat_rasters(cov.grid, device="cpu")])
    x = tgrid.extract(stk, s["long"], s["lat"]).numpy().astype(np.float64)
    ok = np.isfinite(x).all(1)
    ys = np.stack([s["bio_1"], s["bio_12"]], 1)[ok]
    x = x[ok]
    w = np.stack([(np.arange(len(x)) % 5 != r).astype(np.float64) for r in range(3)])
    return x, ys, w


def test_bspline_basis_matches_jax(stations):
    x = stations[0]
    xs = (x[:, 0] - x[:, 0].mean()) / x[:, 0].std()
    inner = np.quantile(xs, np.linspace(0, 1, 7)[1:-1])
    knots = np.concatenate([np.full(4, xs.min() - 1e-3), inner, np.full(4, xs.max() + 1e-3)])
    want = np.asarray(jgam._bspline_basis(jnp.asarray(xs), jnp.asarray(knots)))
    got = tgam._bspline_basis(torch.as_tensor(xs), torch.as_tensor(knots))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-15)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-12)     # a partition of unity
    # batched knot vectors: one per lane
    both = tgam._bspline_basis(torch.as_tensor(np.stack([xs, xs])), torch.as_tensor(np.stack([knots, knots])))
    np.testing.assert_array_equal(both[1].numpy(), got.numpy())


def test_gam_smooth_matches_jax(stations):
    """Three weighted lanes in one batched fit, each against the JAX
    package's single fit: coefficients, knots, centres, lambda, GCV, edf;
    predictions inside and beyond the training range (clipped to the
    boundary knots); importance; the JAX state carried over."""
    x, ys, w = stations
    y = ys[:, 0]
    got = tgam.fit(torch.as_tensor(x), torch.as_tensor(np.stack([y] * 3)), sample_weight=torch.as_tensor(w), **SMOOTH)
    assert isinstance(got, tgam.GAMSmoothState) and got.coef.shape == (3, 1 + 5 + 5 * SMOOTH["k"])
    xq = np.concatenate([x[:40], x[:20] * 1.3])
    for j in range(3):
        want = jgam_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w[j]))
        one = tgam.lane(got, j)
        assert float(one.lam) == pytest.approx(float(want.lam), rel=1e-12)
        for f in ("knots", "centers", "x_mean", "x_scale"):
            np.testing.assert_allclose(getattr(one, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=1e-12,
                                       err_msg=f)
        for f in ("coef", "gcv", "eff_df"):
            np.testing.assert_allclose(getattr(one, f).numpy(), np.asarray(getattr(want, f)), rtol=COEF_RTOL,
                                       atol=COEF_RTOL * np.abs(np.asarray(want.coef)).max(), err_msg=f)
        pw = np.asarray(jgam.predict(want, jnp.asarray(xq)))
        span = np.ptp(y)
        np.testing.assert_allclose(tgam.predict(one, torch.as_tensor(xq)).numpy(), pw, rtol=0, atol=PRED_TOL * span)
        np.testing.assert_allclose(tgam.predict(got, torch.as_tensor(xq))[j].numpy(), pw, rtol=0, atol=PRED_TOL * span)
        wi, gi = jgam.importance(want, NAMES), tgam.importance(one, NAMES)
        assert list(gi) == list(wi)
        for k in ("(Intercept)", "edf", "lambda"):
            assert gi[k] == pytest.approx(wi[k], rel=COEF_RTOL)
        for k in NAMES:
            assert gi[k]["s_norm"] == pytest.approx(wi[k]["s_norm"], rel=COEF_RTOL)
            assert gi[k]["linear"] == pytest.approx(wi[k]["linear"], rel=COEF_RTOL, abs=COEF_RTOL)
        carried = convert.gam_smooth_state_from_numpy(want._asdict(), device="cpu")
        assert carried.k == SMOOTH["k"] == one.k
        np.testing.assert_allclose(tgam.predict(carried, torch.as_tensor(xq)).numpy(), pw, rtol=0, atol=1e-12 * span)


def test_gam_default_stays_ols(stations):
    """``smooth=False`` (the reference's no-s() GAM) is the OLS state."""
    x, ys, _ = stations
    assert isinstance(tgam.fit(torch.as_tensor(x), torch.as_tensor(ys[:, 0])), tgam.GAMState)


@pytest.mark.parametrize("resp", [0, 1])
def test_mars_degree2_matches_jax(stations, resp):
    """The same picks, parents and pruning as the JAX package's degree-2
    fit, predictions within PRED_TOL of the range; evimp's term accounting
    over factor chains; the JAX state carried over."""
    x, ys, w = stations
    y = ys[:, resp]
    want = jmars_fit(jnp.asarray(x), jnp.asarray(y), jnp.asarray(w[0]))
    got = tmars.fit(torch.as_tensor(x), torch.as_tensor(y), sample_weight=torch.as_tensor(w[0]), **MARS2)
    for f in ("vars", "parent", "knots", "pair_active", "active"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)), err_msg=f)
    assert (got.parent.numpy() > 0).any()                          # interaction terms were chosen
    span = np.ptp(y)
    pw = np.asarray(jmars.predict(want, jnp.asarray(x)))
    np.testing.assert_allclose(tmars.predict(got, torch.as_tensor(x)).numpy(), pw, rtol=0, atol=PRED_TOL * span)
    wi = jmars.importance(want, jnp.asarray(x), jnp.asarray(y), NAMES)
    gi = tmars.importance(got, torch.as_tensor(x), torch.as_tensor(y), NAMES)
    for k in NAMES:
        assert gi[k]["nsubsets"] == wi[k]["nsubsets"]
        np.testing.assert_allclose(gi[k]["rss"], wi[k]["rss"], rtol=1e-6, atol=1e-8)
    carried = convert.mars_state_from_numpy(want._asdict(), device="cpu")
    np.testing.assert_array_equal(carried.parent.numpy(), np.asarray(want.parent))
    np.testing.assert_allclose(tmars.predict(carried, torch.as_tensor(x)).numpy(), pw, rtol=0, atol=1e-12 * span)


def test_mars_degree2_batch_equals_single_fits(stations):
    x, ys, w = stations
    xt = torch.as_tensor(x)
    batch = tmars.fit(xt, torch.as_tensor(np.stack([ys[:, 0]] * 3)), sample_weight=torch.as_tensor(w), **MARS2)
    for j in range(3):
        one = tmars.fit(xt, torch.as_tensor(ys[:, 0]), sample_weight=torch.as_tensor(w[j]), **MARS2)
        np.testing.assert_array_equal(batch.parent[j].numpy(), one.parent.numpy())
        np.testing.assert_allclose(batch.coef[j].numpy(), one.coef.numpy(), rtol=1e-9, atol=1e-12)


def test_run_cv_with_smooth_gam_and_mars2_matches_jax(stations):
    """``CVConfig(gam=dict(smooth=True), mars=dict(degree=2))`` through
    ``run_cv`` on the JAX package's folds: the test residuals of both
    letters."""
    x, ys, _ = stations
    key = jax.random.PRNGKey(7)
    jcfg = jcv.CVConfig(n_folds=3, gam=SMOOTH, mars=MARS2)
    want = jcv.run_cv(key, jnp.asarray(x), jnp.asarray(ys), config=jcfg, algorithms="gm")
    kf = jax.random.split(key, 5)[0]
    folds = np.stack([np.asarray(jkfold.kfold(jax.random.fold_in(kf, r), len(x), 3)) for r in range(2)])
    got = tcv.run_cv(torch.as_tensor(x), torch.as_tensor(ys), config=tcv.CVConfig(n_folds=3, gam=SMOOTH, mars=MARS2),
                     algorithms="gm", folds=folds)
    for letter in "gm":
        np.testing.assert_allclose(got[letter], want[letter], rtol=0, atol=PRED_TOL * np.abs(want[letter]).max(),
                                   err_msg=letter)
