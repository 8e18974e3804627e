"""The SVM letter: the port's ``models/svm.py`` (with the plain version of
kernel K4, the coordinate sweep), its CV letter, its final fits and the
breakDown importance, against the JAX package's, on the CPU in float64.

The JAX side draws sigest's row pairs with ``jax.random``; the test draws
the same ones from the same keys and injects them into the port.  Data are
made from numpy seeds.
"""
import importlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machisplin_tpu.ensemble import cv as jcv
from machisplin_tpu.ensemble.kfold import kfold as jax_kfold
from machisplin_tpu.models import svm as jsvm
from machisplin_tpu.pipeline.importance import breakdown_importance as jbreakdown
from machisplin_tpu_torch import convert
from machisplin_tpu_torch.ensemble import cv as tcv
from machisplin_tpu_torch.models import svm as tsvm
from machisplin_tpu_torch.ops import svm_sweep
from machisplin_tpu_torch.pipeline.importance import breakdown_importance as tbreakdown
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

jmltps = importlib.import_module("machisplin_tpu.pipeline.mltps")
tmltps = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")

SVM_TOL = 1e-8      # of the response range


def _data(n=60, p=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, p)) * [1.0, 20.0, 3.0] + [0.0, 100.0, -1.0]
    y = np.stack([np.sin(3 * x[:, 0]) + 0.05 * x[:, 1], 50 * np.cos(x[:, 2]) - x[:, 1]], 1)
    return x, y + 0.1 * rng.normal(size=y.shape)


def _pairs(keys, n):
    """sigest's (i, j) draws for each key, as ``svm._sigest`` makes them
    (svm.py:70-72): (L, m) each."""
    m = min(2 * n, 2000)
    i = np.stack([np.asarray(jax.random.randint(k, (m,), 0, n)) for k in keys])
    j = np.stack([np.asarray(jax.random.randint(jax.random.fold_in(k, 1), (m,), 0, n)) for k in keys])
    return torch.as_tensor(i), torch.as_tensor(j)


def test_sigest_matches_jax():
    x, _ = _data(n=80)
    w = (np.arange(80) % 5 != 2).astype(np.float64)
    key = jax.random.PRNGKey(4)
    want = float(jsvm._sigest(jnp.asarray(x), jnp.asarray(w), key))
    i, j = _pairs([key], 80)
    got = float(tsvm._sigest(torch.as_tensor(x)[None], torch.as_tensor(w)[None], i, j)[0])
    assert got == pytest.approx(want, rel=1e-14, abs=0)


@pytest.mark.parametrize("weighted", [False, True], ids=["all_rows", "masked"])
def test_svm_fit_predict_matches_jax(weighted):
    x, y = _data()
    n = len(x)
    w = (np.arange(n) % 4 != 1).astype(np.float64) if weighted else None
    key = jax.random.PRNGKey(9)
    js = jsvm.fit(key, jnp.asarray(x), jnp.asarray(y[:, 1]), sample_weight=None if w is None else jnp.asarray(w))
    ts = tsvm.fit(torch.as_tensor(x), torch.as_tensor(y[:, 1]), sample_weight=None if w is None else torch.as_tensor(w),
                  pairs=_pairs([key], n))
    span = np.ptp(y[:, 1])
    np.testing.assert_allclose(ts.sigma.numpy(), np.asarray(js.sigma), rtol=1e-14)
    np.testing.assert_allclose(ts.theta.numpy(), np.asarray(js.theta), rtol=0, atol=SVM_TOL)
    q = x[::2] * 1.05
    want = np.asarray(jsvm.predict(js, jnp.asarray(q)))
    got = tsvm.predict(ts, torch.as_tensor(q)).numpy()
    assert np.abs(got - want).max() <= SVM_TOL * span
    assert np.mean((tsvm.predict(ts, torch.as_tensor(x)).numpy() - y[:, 1]) ** 2) < 0.2 * np.var(y[:, 1])
    # the JAX state carried over predicts the same, also in query blocks
    carried = convert.svm_state_from_jax({k: np.asarray(v) for k, v in js._asdict().items()}, device="cpu")
    np.testing.assert_allclose(tsvm.predict(carried, torch.as_tensor(q), query_block=7).numpy(), want,
                               rtol=0, atol=1e-12 * span)


def test_svm_lanes_equal_their_single_fits():
    """A batch of lanes with their own masks and sigmas gives each lane's
    single fit, and the plain sweep's lanes do not interact."""
    x, y = _data(n=40, seed=3)
    w = (np.random.default_rng(1).uniform(size=(3, 40)) > 0.3).astype(np.float64)
    keys = jax.random.split(jax.random.PRNGKey(2), 3)
    i, j = _pairs(keys, 40)
    yb = torch.as_tensor(y[:, 0]).expand(3, -1)
    batch = tsvm.fit(torch.as_tensor(x), yb, sample_weight=torch.as_tensor(w), pairs=(i, j), epochs=40)
    for lane in range(3):
        one = tsvm.fit(torch.as_tensor(x), torch.as_tensor(y[:, 0]), sample_weight=torch.as_tensor(w[lane]),
                       pairs=(i[lane], j[lane]), epochs=40)
        for a, b in zip(tsvm.lane(batch, lane), one):
            torch.testing.assert_close(a, b, rtol=1e-13, atol=1e-13)


def test_sweep_refuses_what_the_kernel_cannot_take():
    q = torch.zeros((1, 4, 4))
    v = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        svm_sweep.svm_sweep_cuda(q, v, v, v)
    with pytest.raises(TypeError, match="float32 or float64"):
        svm_sweep.svm_sweep_cuda(q.half(), v.half(), v.half(), v.half())
    with pytest.raises(ValueError, match="theta must be"):
        svm_sweep.svm_sweep_cuda(q, v, v, v, theta="registers")
    # the rows the shared layout takes (theta in the block's shared memory)
    assert svm_sweep.max_rows(torch.float64) == 8000 and svm_sweep.max_rows(torch.float32) == 21152


def _kernel_constants() -> dict:
    """The block's shape and shared memory, csrc/svm_sweep.cu's constexprs."""
    src = (Path(svm_sweep.__file__).resolve().parent.parent / "csrc" / "svm_sweep.cu").read_text()
    consts = {}
    for name in ("THREADS", "CH", "UPD", "ROW_BYTES", "SMEM_LIMIT"):
        expr = re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)
        consts[name] = eval(expr, {}, dict(consts))      # e.g. UPD = THREADS / 32 - 1
    return consts


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_max_rows_by_the_kernels_shared_memory(dtype):
    """max_rows and max_rows_global are the largest n for which the kernel's
    smem_bytes<T, GLOBAL_THETA>(n) (two Stages, the row buffers, and per
    chunk of 32 rows a mask word and, in the shared layout, 32 values of
    theta) fits SMEM_LIMIT, with the constants read from the source."""
    c = _kernel_constants()
    size = torch.finfo(dtype).bits // 8
    coord = -(-8 * size // 16) * 16                                       # Coord<T>, __align__(16)
    stage = c["CH"] * coord + size * (2 * c["CH"] * c["CH"] + c["UPD"] * c["CH"])
    fixed = 2 * stage + c["UPD"] * c["ROW_BYTES"]

    def smem(n, global_theta):
        return fixed + ((0 if global_theta else c["CH"] * size) + 4) * -(-n // c["CH"])

    for global_theta, limit in ((False, svm_sweep.max_rows(dtype)), (True, svm_sweep.max_rows_global(dtype))):
        assert smem(limit, global_theta) <= c["SMEM_LIMIT"] < smem(limit + 1, global_theta)
    assert svm_sweep.max_rows_global(dtype) > 500_000
    assert svm_sweep.max_rows_global(dtype) == (698_368 if dtype == torch.float32 else 520_192)


def test_svm_fit_past_the_old_float64_rows_matches_jax():
    """At 8,200 stations in float64, past the 8,000 rows K4 once took in
    shared memory, the port's fit (the plain sweep on the CPU) is the JAX
    package's: sigma given, so no draw enters; 2 sweeps."""
    n, sigma = 8200, 0.7
    x, y = _data(n=n, seed=11)
    js = jsvm.fit(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y[:, 0]), sigma=sigma, epochs=2)
    ts = tsvm.fit(torch.as_tensor(x), torch.as_tensor(y[:, 0]), sigma=sigma, epochs=2)
    assert ts.theta.dtype == torch.float64 and ts.theta.shape == (n,)
    assert int((ts.theta != 0).sum()) > n // 10
    np.testing.assert_allclose(ts.theta.numpy(), np.asarray(js.theta), rtol=0, atol=SVM_TOL)
    span = np.ptp(y[:, 0])
    q = x[::41] * 1.02
    want = np.asarray(jsvm.predict(js, jnp.asarray(q)))
    assert np.abs(tsvm.predict(ts, torch.as_tensor(q)).numpy() - want).max() <= SVM_TOL * span


@pytest.mark.parametrize("invert_threshold", [4000, 50])     # 50: train on one fold (V73:227-232)
def test_run_cv_v_matches_jax(invert_threshold):
    x, y = _data(n=75, seed=5)
    n, k = len(x), 3
    key = jax.random.PRNGKey(13)
    cfg = dict(n_folds=k, invert_threshold=invert_threshold)
    want = jcv.run_cv(key, jnp.asarray(x), jnp.asarray(y), algorithms="v", config=jcv.CVConfig(**cfg))["v"]
    kf, _, _, _, ks = jax.random.split(key, 5)           # run_cv's keys (cv.py:172)
    folds = np.stack([np.asarray(jax_kfold(jax.random.fold_in(kf, r), n, k)) for r in range(2)])
    # rows each lane fits on: all n, or the gathered rows of its largest fold
    n_fit = max(np.bincount(f, minlength=k).max() for f in folds) if n > invert_threshold else n
    got = tcv.run_cv(torch.as_tensor(x), torch.as_tensor(y), algorithms="v", folds=folds,
                     svm_pairs=_pairs(jax.random.split(ks, 2 * k), n_fit), config=tcv.CVConfig(**cfg))["v"]
    assert got.shape == want.shape == (2, n * (k - 1) if n > invert_threshold else n)
    for r in range(2):
        assert np.abs(got[r] - want[r]).max() <= SVM_TOL * np.ptp(y[:, r])


def test_fit_final_batched_v_matches_jax():
    x, y = _data(n=50, seed=7)
    names = ["a", "b", "c"]
    keys = jax.random.split(jax.random.PRNGKey(12), 2)
    jfn, jimps = jmltps._fit_final_batched(
        "v", keys, jnp.asarray(x), jnp.asarray(y), names, jmltps.MLTPSConfig(svm_importance_sample=30))
    tfn, timps = tmltps._fit_final_batched(
        "v", torch.as_tensor(x), torch.as_tensor(y), names, tmltps.MLTPSConfig(svm_importance_sample=30),
        svm_pairs=_pairs(keys, len(x)))
    q = x[::3] * 1.1
    want = np.asarray(jfn(jnp.asarray(q)))
    got = tfn(torch.as_tensor(q)).numpy()
    assert got.shape == want.shape == (len(q), 2)
    for r in range(2):
        assert np.abs(got[:, r] - want[:, r]).max() <= SVM_TOL * np.ptp(y[:, r])
        assert list(timps[r]) == names
        for nm in names:
            assert timps[r][nm]["contributions to SVM"] == pytest.approx(
                jimps[r][nm]["contributions to SVM"], rel=1e-8, abs=SVM_TOL * np.ptp(y[:, r]))


@pytest.mark.parametrize("n", [60, 250])      # 250 > 200: the seeded sample is drawn
def test_breakdown_importance_matches_jax(n):
    """Given the same predictions (an elementwise function both packages
    evaluate bit for bit), the two importances are equal."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(n, 3))
    names = ["u", "v", "w"]
    want = jbreakdown(lambda q: 2.0 * q[:, 0] + q[:, 1] * q[:, 2] - q[:, 0] * q[:, 0], x, names)
    got = tbreakdown(lambda q: 2.0 * q[:, 0] + q[:, 1] * q[:, 2] - q[:, 0] * q[:, 0], torch.as_tensor(x), names)
    assert got == want
