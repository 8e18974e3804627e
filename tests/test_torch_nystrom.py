"""The large-station TPS path of the PyTorch port against the JAX package, on
the CPU in float64: ``select_landmarks`` (the JAX package's subsample
injected), ``nystrom_tps_fit`` (numpy landmarks given to both; a chunk size
that does not divide n), ``tps_fit_host``, ``gcv_curve`` and every route of
``tps_fit_auto``.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machisplin_tpu.ops import host_tps as jhost, nystrom as jnys, tps as jtps
from machisplin_tpu_torch.ops import host_tps as thost, nystrom as tnys, tps as ttps

N, M = 3000, 128
CHUNK = 777          # does not divide N: the JAX package pads, the port runs a short last chunk
# the Nystrom fit's float64 tail and the streamed sums agree to round-off;
# fitted values within FIT_TOL of the response range, coefficients within
# COEF_TOL of their largest magnitude (the whitened system is ill-conditioned)
FIT_TOL = 1e-8
COEF_TOL = 1e-6


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(0)
    coords = rng.uniform(0, 1, (N, 2)) * np.array([2.0, 1.0]) + np.array([-77.5, -6.5])
    ys = np.stack([
        np.sin((6 + j) * coords[:, 0]) * np.cos((5 - j) * coords[:, 1]) + 0.1 * rng.standard_normal(N)
        for j in range(3)
    ], axis=1)
    landmarks = coords[np.random.default_rng(1).choice(N, M, replace=False)]
    return coords, ys, landmarks


def _close(got, want, tol, name):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-300), err_msg=name)


def test_select_landmarks_matches_jax(problem, monkeypatch):
    """The JAX package's threefry subsample injected as ``init_idx``; the
    port's k-means sweeps run in chunks of 700 stations (not a divisor of
    N): each row's nearest centre is the same, the centre sums in another
    order."""
    coords = problem[0]
    key = jax.random.PRNGKey(3)
    idx = np.array(jax.random.choice(key, N, (M,), replace=False))
    want = np.asarray(jnys.select_landmarks(key, jnp.asarray(coords), M))
    monkeypatch.setattr(tnys, "_KMEANS_CHUNK", 700)
    got = tnys.select_landmarks(torch.as_tensor(coords), M, init_idx=idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    # no sweeps: the subsample itself
    np.testing.assert_array_equal(
        tnys.select_landmarks(torch.as_tensor(coords), M, kmeans_iters=0, init_idx=idx).numpy(), coords[idx])


@pytest.mark.parametrize("n_resp", [1, 3])
def test_nystrom_fit_matches_jax(problem, n_resp):
    coords, ys, landmarks = problem
    y = ys[:, 0] if n_resp == 1 else ys
    want = jnys.nystrom_tps_fit(jnp.asarray(coords), jnp.asarray(y), landmarks=jnp.asarray(landmarks), chunk=CHUNK)
    got = tnys.nystrom_tps_fit(torch.as_tensor(coords), torch.as_tensor(y), landmarks=landmarks, chunk=CHUNK,
                               device="cpu")
    # the same point of the GCV grid (the grids differ in the last bit)
    np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam), rtol=1e-13)
    for f in ("knots", "shift", "scale", "gcv", "eff_df"):
        _close(getattr(got, f), getattr(want, f), 1e-9, f)
    for f in ("c", "d"):
        _close(getattr(got, f), getattr(want, f), COEF_TOL, f)
    span = np.ptp(y, axis=0)
    np.testing.assert_allclose(got.fitted.numpy(), np.asarray(want.fitted), rtol=0, atol=FIT_TOL * np.max(span))
    np.testing.assert_allclose(got.residuals.numpy(), np.asarray(want.residuals), rtol=0, atol=FIT_TOL * np.max(span))


def test_nystrom_fixed_lambda_and_chunking(problem):
    """A given lambda reproduces the JAX package's GCV value and fit; the
    chunk size changes only the summation order."""
    coords, ys, landmarks = problem
    want = jnys.nystrom_tps_fit(jnp.asarray(coords), jnp.asarray(ys[:, 1]), landmarks=jnp.asarray(landmarks),
                                lam=1e-4, chunk=CHUNK)
    got = tnys.nystrom_tps_fit(torch.as_tensor(coords), torch.as_tensor(ys[:, 1]), landmarks=landmarks, lam=1e-4,
                               chunk=CHUNK, device="cpu")
    _close(got.gcv, want.gcv, 1e-9, "gcv")
    _close(got.fitted, want.fitted, FIT_TOL, "fitted")
    whole = tnys.nystrom_tps_fit(torch.as_tensor(coords), torch.as_tensor(ys[:, 1]), landmarks=landmarks, lam=1e-4,
                                 chunk=N, device="cpu")
    np.testing.assert_allclose(whole.fitted.numpy(), got.fitted.numpy(), rtol=0, atol=FIT_TOL * np.ptp(ys[:, 1]))


def test_nystrom_own_landmarks_fit_the_signal(problem):
    """Without injected landmarks the port draws its own from a generator:
    the same seed gives the same model, and the fit recovers the signal."""
    coords, ys, _ = problem
    signal = np.sin(6 * coords[:, 0]) * np.cos(5 * coords[:, 1])
    fits = [tnys.nystrom_tps_fit(torch.as_tensor(coords), torch.as_tensor(ys[:, 0]), m=M,
                                 generator=torch.Generator().manual_seed(5), device="cpu") for _ in range(2)]
    np.testing.assert_array_equal(fits[0].c.numpy(), fits[1].c.numpy())
    fitted = fits[0].fitted.numpy()
    r2 = 1 - np.sum((fitted - signal) ** 2) / np.sum((signal - signal.mean()) ** 2)
    assert fits[0].knots.shape == (M, 2) and r2 > 0.99


def test_tps_fit_host_matches_jax_and_device_exact(problem):
    """The host float64 fit equals the JAX package's (the same numpy and
    LAPACK calls) and agrees with the port's exact device path."""
    coords, ys, _ = problem
    c, y = coords[:400], ys[:400, :2]
    want = jhost.tps_fit_host(c, y)
    got = thost.tps_fit_host(c, y, device="cpu")
    dev = ttps.tps_fit(torch.as_tensor(c), torch.as_tensor(y))
    assert got.c.device.type == "cpu" and got.c.dtype == torch.float64
    for f in ttps.TPSModel._fields:
        _close(getattr(got, f), getattr(want, f), 1e-12, f)
    for f in ("lam", "gcv", "eff_df", "fitted"):
        _close(getattr(dev, f), np.asarray(getattr(want, f)), 1e-6, f)
    # float32 coordinates give a float32 model, fitted in float64
    f32 = thost.tps_fit_host(torch.as_tensor(c, dtype=torch.float32), torch.as_tensor(y), device="cpu")
    assert f32.c.dtype == torch.float32


@pytest.mark.parametrize("n_resp", [1, 2])
def test_gcv_curve_matches_jax(problem, n_resp):
    coords, ys, _ = problem
    c = coords[:300]
    y = ys[:300, 0] if n_resp == 1 else ys[:300, :2]
    rho = np.logspace(-8, 2, 17)
    want = np.asarray(jtps.gcv_curve(jax.jit(jtps.tps_factor)(jnp.asarray(c)), jnp.asarray(y), jnp.asarray(rho)))
    got = ttps.gcv_curve(ttps.tps_factor(torch.as_tensor(c)), torch.as_tensor(y), torch.as_tensor(rho))
    assert got.shape == want.shape == ((17,) if n_resp == 1 else (2, 17))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)


@pytest.mark.parametrize("method,n,limit,route", [
    ("auto", 300, 400, "exact"),
    ("auto", 500, 400, "nystrom"),
    ("exact", 500, 400, "host"),
    ("nystrom", 300, 400, "nystrom"),
])
def test_tps_fit_auto_routes(problem, method, n, limit, route):
    """Each route at a small ``max_device_knots`` against the JAX package's
    ``tps_fit_auto``: the exact and host fits as they are; the Nystrom
    route with 64 landmarks, the JAX package's subsample at its default key
    (PRNGKey(0)) injected into the port's ``select_landmarks`` as
    ``init_idx``.  The landmark default, min(2048, n), is ``_auto_route``'s."""
    coords, ys, _ = problem
    c, y = coords[:n], ys[:n, :2]
    assert ttps._auto_route(n, method, limit) == (route, min(2048, n) if route == "nystrom" else None)
    m = 64 if route == "nystrom" else None
    with mock.patch.object(tnys, "select_landmarks", _jax_subsample(tnys.select_landmarks, n, m)):
        got = ttps.tps_fit_auto(torch.as_tensor(c), torch.as_tensor(y), method=method, max_device_knots=limit,
                                landmarks=m)
    # the JAX package's routing, its exact fit compiled once (~3 s eager)
    with mock.patch.object(jtps, "tps_fit", jax.jit(jtps.tps_fit, static_argnames=("ngrid", "refine"))):
        want = jtps.tps_fit_auto(jnp.asarray(c), jnp.asarray(y), method=method, max_device_knots=limit,
                                 landmarks=m)
    if route == "nystrom":
        assert got.knots.shape == (m, 2)
        _close(got.knots, want.knots, 1e-12, "knots")
        np.testing.assert_allclose(got.lam.numpy(), np.asarray(want.lam), rtol=1e-9)
        for f in ("gcv", "eff_df", "fitted", "d"):
            _close(getattr(got, f), getattr(want, f), FIT_TOL, f)
        return
    for f in ("lam", "gcv", "eff_df", "fitted", "d"):
        _close(getattr(got, f), getattr(want, f), 1e-6 if route == "exact" else 1e-12, f)


def _jax_subsample(select, n, m):
    """``select`` with the JAX package's subsample of m of n stations at its
    default key (``jax.random.choice(PRNGKey(0), n, (m,), replace=False)``)
    as ``init_idx``."""
    if m is None:
        return select
    idx = np.array(jax.random.choice(jax.random.PRNGKey(0), n, (m,), replace=False))
    return lambda xs, m_, **kw: select(xs, m_, init_idx=idx)


def test_tps_fit_auto_refuses_mask_and_bad_method(problem):
    coords, ys, _ = problem
    c = torch.as_tensor(coords[:50])
    with pytest.raises(ValueError, match="dense rows only"):
        ttps.tps_fit_auto(c, torch.as_tensor(ys[:50, 0]), mask=torch.ones(50))
    with pytest.raises(ValueError, match="unknown method"):
        ttps.tps_fit_auto(c, torch.as_tensor(ys[:50, 0]), method="dense")
    assert ttps.MAX_DEVICE_EIGH_KNOTS == jtps.MAX_DEVICE_EIGH_KNOTS == 8192
    assert ttps._auto_route(65536) == ("nystrom", 2048) and ttps._auto_route(100_000) == ("nystrom", 4096)
