"""The port's remaining weight searches and its RData reader against the
JAX package, on the CPU in float64: ``ensemble_objective``,
``optimize_weights_aicc`` (every subset in one matmul: the same pick) and
``optimize_weights_sweep`` with the JAX package's draws injected (the same
weights); ``read_rdata`` on both bundled files, ``load_sampling(source=
"rdata")`` equal to the CSV, and ``load_example_dat``.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machisplin_tpu.ensemble import weights as jweights
from machisplin_tpu.io import rdata as jrdata
from machisplin_tpu_torch import data as tdata
from machisplin_tpu_torch.ensemble import weights as tweights
from machisplin_tpu_torch.io import rdata as trdata
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def residuals():
    """Six algorithms' CV residuals (A, n), two of them correlated."""
    rng = np.random.default_rng(0)
    res = rng.normal(size=(6, 300)) * np.array([1.0, 0.5, 0.7, 2.0, 0.6, 1.2])[:, None]
    res[1] += 0.3 * res[2]
    return res


def test_ensemble_objective_matches_jax(residuals):
    w = np.random.default_rng(1).uniform(size=(4, 7, 6))
    w[0, 0] = 0.0                                   # an all-zero weight vector: the 1e-12 floor
    want = np.asarray(jweights.ensemble_objective(w, residuals))
    got = tweights.ensemble_objective(torch.as_tensor(w), torch.as_tensor(residuals))
    assert got.shape == want.shape == (4, 7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13)


@pytest.mark.parametrize("letters", ["bgnmrv", "gm"])
def test_aicc_matches_jax(residuals, letters):
    res = residuals[: len(letters)]
    want = jweights.optimize_weights_aicc(res, letters)
    got = tweights.optimize_weights_aicc(torch.as_tensor(res), letters)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert (got.letters, got.percent_text, got.weight_total) == (want.letters, want.percent_text, want.weight_total)
    np.testing.assert_array_equal(got.kept_weights, want.kept_weights)
    assert got.objective == pytest.approx(want.objective, rel=1e-13)


def test_sweep_with_jax_draws_matches_jax(residuals):
    """The JAX package's default draws (key 0: its uniform candidates and
    its zoom's normals, rebuilt here) give the same search, bit for bit
    up to the float64 round-off of the objective's matmuls."""
    n_cand, n_zoom = 4096, 20
    k0, k1 = jax.random.split(jax.random.PRNGKey(0))
    cands = np.array(jax.random.uniform(k0, (n_cand, 6), jnp.float64))
    noise = np.stack([np.array(jax.random.normal(k, (256, 6), jnp.float64)) for k in jax.random.split(k1, n_zoom)])
    want = jweights.optimize_weights_sweep(residuals, "bgnmrv")
    got = tweights.optimize_weights_sweep(torch.as_tensor(residuals), "bgnmrv", cands=cands, noise=noise)
    np.testing.assert_allclose(got.weights, want.weights, rtol=0, atol=1e-12)
    assert (got.letters, got.percent_text) == (want.letters, want.percent_text)
    assert got.objective == pytest.approx(want.objective, rel=1e-12)
    # its own draws: deterministic (seeded 0), and no worse than k = 0.5
    a = tweights.optimize_weights_sweep(torch.as_tensor(residuals), "bgnmrv")
    b = tweights.optimize_weights_sweep(torch.as_tensor(residuals), "bgnmrv")
    np.testing.assert_array_equal(a.weights, b.weights)
    assert a.objective <= float(tweights.ensemble_objective(torch.full((6,), 0.5, dtype=torch.float64),
                                                             torch.as_tensor(residuals)))


def test_sweep_never_takes_the_zero_weights():
    """With two algorithms the JAX package's zoom clips some perturbation to
    k = (0, 0), whose objective is 0/0 scored 0, and keeps it (its ensemble
    is then NaN); the port scores it as no weighting and keeps searching.
    With the JAX package's own draws for key 2, which collapse there."""
    rng = np.random.default_rng(0)
    res = rng.normal(size=(2, 500)) + rng.normal(size=(1, 500))
    key = jax.random.PRNGKey(2)
    want = jweights.optimize_weights_sweep(res, "gm", key=key)
    k0, k1 = jax.random.split(key)
    cands = np.array(jax.random.uniform(k0, (4096, 2), jnp.float64))
    noise = np.stack([np.array(jax.random.normal(k, (256, 2), jnp.float64)) for k in jax.random.split(k1, 20)])
    got = tweights.optimize_weights_sweep(torch.as_tensor(res), "gm", cands=cands, noise=noise)
    assert want.weights.sum() == 0.0 and want.percent_text == "nan"
    assert got.weights.sum() > 0 and got.percent_text != "nan"
    lb = tweights.optimize_weights_lbfgsb(res, "gm")
    assert got.objective <= lb.objective * 1.001


@pytest.mark.parametrize("name,obj", [("sampling.RData", "sampling"), ("example.dat.Rdata", "example.dat")])
def test_read_rdata_matches_jax(name, obj):
    want = jrdata.read_rdata(os.path.join(ROOT, "machisplin_tpu", "data", name))
    got = trdata.read_rdata(os.path.join(ROOT, "machisplin_tpu_torch", "data", name))
    assert list(got) == list(want) == [obj]
    assert got[obj].dtype == want[obj].dtype and len(got[obj]) == 813
    for f in want[obj].dtype.names:
        np.testing.assert_array_equal(got[obj][f], want[obj][f])


def test_load_sampling_rdata_equals_csv():
    csv, rd, ex = tdata.load_sampling(), tdata.load_sampling(source="rdata"), tdata.load_example_dat()
    assert csv.dtype.names == rd.dtype.names == ex.dtype.names == ("long", "lat", "bio_1", "bio_12")
    for f in csv.dtype.names:
        np.testing.assert_array_equal(rd[f], csv[f])
        np.testing.assert_array_equal(ex[f], csv[f])
    with pytest.raises(ValueError, match="source"):
        tdata.load_sampling(source="xlsx")
    with pytest.raises(ValueError, match="RDX2"):
        trdata.read_rdata(os.path.join(ROOT, "machisplin_tpu_torch", "data", "sampling.csv"))
