"""The NN letter: the port's L-BFGS (``optim/lbfgs.py``) against optax 0.2.6's
``lbfgs(memory_size=20)``, ``models/nn.py`` against the JAX package's
``nn``, and the NN's CV letter and final fits against the JAX package's,
on the CPU in float64.

The JAX side draws its inits and folds with ``jax.random``; the test draws
the same ones and injects them into the port.  Problems and data are made
from numpy seeds.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import machisplin_tpu_torch as mtt
from machisplin_tpu.ensemble import cv as jcv
from machisplin_tpu.ensemble.kfold import kfold as jax_kfold
from machisplin_tpu.models import nn as jnn
from machisplin_tpu_torch import convert
from machisplin_tpu_torch.ensemble import cv as tcv
from machisplin_tpu_torch.ensemble.kfold import numpy_folds
from machisplin_tpu_torch.models import nn as tnn
from machisplin_tpu_torch.optim import lbfgs
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

jmltps = importlib.import_module("machisplin_tpu.pipeline.mltps")
tmltps = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")

STEPS = 40
OPTAX_RTOL = 1e-9      # per-step params and values against optax, relative
NN_TOL = 1e-6          # of the response range, nn.fit against the JAX package
GARSON_TOL = 1e-12


# ---------------------------------------------------------------- L-BFGS

def _problem(kind, p=30, seed=1):
    """(A, c, b, x0) of f(x) = x'Ax / 2 + c sum(x^4) / 4 - b'x: a rotated
    quadratic with eigenvalues from 1 to 1e3 plus a quartic ("quartic": its
    line searches often zoom), or a linear function ("linear": every line
    search doubles its stepsize 20 times and takes the safe step)."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(p, p)))
    a = (q * np.logspace(0, 3, p)) @ q.T
    b = rng.normal(size=p) * 10
    x0 = rng.normal(size=p)
    if kind == "linear":
        return np.zeros((p, p)), 0.0, b, x0
    return a, 5.0, b, x0


def _optax_run(a, c, b, x0, steps):
    """optax's own lbfgs, one jitted step at a time: params, values at them,
    line-search iterations and stepsizes after each step."""
    def f(x):
        return 0.5 * x @ (a @ x) + 0.25 * c * jnp.sum(x ** 4) - b @ x

    opt = optax.lbfgs(memory_size=20)
    vg = optax.value_and_grad_from_state(f)

    @jax.jit
    def step(x, st):
        v, g = vg(x, state=st)
        u, st = opt.update(g, st, x, value=v, grad=g, value_fn=f)
        return optax.apply_updates(x, u), st

    x = jnp.asarray(x0)
    st = opt.init(x)
    out = {"params": [], "value": [], "ls_steps": [], "lr": []}
    for _ in range(steps):
        x, st = step(x, st)
        ls = st[2]
        out["params"].append(np.asarray(x))
        out["value"].append(float(ls.value))
        out["ls_steps"].append(int(ls.info.num_linesearch_steps))
        out["lr"].append(float(ls.learning_rate))
    return {k: np.asarray(v) for k, v in out.items()}


def _torch_fun(a, c, b):
    at, bt = torch.as_tensor(a), torch.as_tensor(b)

    def fun(x):
        ax = x @ at
        return 0.5 * (x * ax).sum(-1) + 0.25 * c * (x ** 4).sum(-1) - x @ bt, ax + c * x ** 3 - bt

    return fun


@pytest.mark.parametrize("kind", ["quartic", "linear"])
def test_lbfgs_matches_optax(kind):
    a, c, b, x0 = _problem(kind)
    want = _optax_run(a, c, b, x0, STEPS)
    fun = _torch_fun(a, c, b)
    x = torch.as_tensor(x0)[None]
    state = lbfgs.init(x)
    got = {"params": [], "value": [], "ls_steps": [], "lr": []}
    for _ in range(STEPS):
        x, state = lbfgs.run(fun, x, state, 1)
        got["params"].append(x[0].numpy())
        got["value"].append(float(state.value[0]))
        got["ls_steps"].append(int(state.ls_steps[0]))
        got["lr"].append(float(state.learning_rate[0]))
    np.testing.assert_array_equal(got["ls_steps"], want["ls_steps"])
    for key in ("params", "value", "lr"):
        g, w = np.asarray(got[key]), want[key]
        scale = np.abs(w).max(axis=-1, keepdims=True) if key == "params" else np.abs(w)
        assert np.all(np.abs(g - w) <= OPTAX_RTOL * scale), (key, np.max(np.abs(g - w) / scale))
    if kind == "quartic":
        grad_norm = float(np.linalg.norm(a @ want["params"][-1] + c * want["params"][-1] ** 3 - b))
        assert grad_norm > 1e-2              # not converged at step 40
        zoomed = want["ls_steps"] >= 2
        dyadic = np.isclose(np.log2(want["lr"]), np.round(np.log2(want["lr"])), rtol=0, atol=1e-12)
        assert np.any(zoomed & ~dyadic)      # a zoom interpolated the stepsize
    else:
        assert np.all(want["ls_steps"] == 20)           # every search ran out
        assert np.all(want["lr"] == 2.0 ** 19)          # and took the safe step


def _lane_fun(coef):
    """Per lane: d x^2 / 2 + c x^4 / 4 - b x summed, plus r times the
    Rosenbrock chain; elementwise, so each row's arithmetic is the same
    whatever the number of rows."""
    d, c, b, r = (torch.as_tensor(v) for v in coef)

    def fun(x):
        t = x[:, 1:] - x[:, :-1] ** 2
        e = 1.0 - x[:, :-1]
        value = (0.5 * d * x * x + 0.25 * c[:, None] * x ** 4 - b * x).sum(-1) + r * (100.0 * t * t + e * e).sum(-1)
        grad = d * x + c[:, None] * x ** 3 - b
        grad = grad + r[:, None] * torch.cat([-400.0 * t * x[:, :-1] - 2.0 * e, torch.zeros_like(x[:, :1])], 1)
        grad = grad + r[:, None] * torch.cat([torch.zeros_like(x[:, :1]), 200.0 * t], 1)
        return value, grad

    return fun


def test_lbfgs_lanes_equal_their_unbatched_runs():
    """Lanes whose line searches end at different iterations (1-2 for the
    quadratics and the Rosenbrock chain, 20 for the linear lane) each equal
    their own unbatched run, whole or one step at a time."""
    rng = np.random.default_rng(4)
    p, steps = 12, 25
    d = np.stack([np.logspace(0, 2, p), np.logspace(0, 3, p), np.zeros(p), np.zeros(p)])
    coef = (d, np.array([1.0, 5.0, 0.0, 0.0]), rng.normal(size=(4, p)), np.array([0.0, 0.0, 1.0, 0.0]))
    x0 = torch.as_tensor(rng.uniform(-1, 1, size=(4, p)))
    stats = {}
    x_all, st_all = lbfgs.run(_lane_fun(coef), x0, lbfgs.init(x0), steps, stats=stats)
    for lane in range(4):
        one = tuple(v[lane : lane + 1] for v in coef)
        x1, st1 = lbfgs.run(_lane_fun(one), x0[lane : lane + 1], lbfgs.init(x0[lane : lane + 1]), steps)
        assert torch.equal(x_all[lane], x1[0]), lane
        assert torch.equal(st_all.s_mem[:, lane], st1.s_mem[:, 0]), lane
    x, st, ls_steps = x0, lbfgs.init(x0), []
    for _ in range(steps):
        x, st = lbfgs.run(_lane_fun(coef), x, st, 1)
        ls_steps.append(st.ls_steps.tolist())
    assert torch.equal(x, x_all)
    ls_steps = np.array(ls_steps)
    assert np.all(ls_steps[:, 3] == 20) and ls_steps[:, :3].max() < 20
    assert len(set(ls_steps[:, 0]) | set(ls_steps[:, 2])) >= 2
    assert stats["evaluations"] < 4 * stats["passes"]     # lanes did not wait for each other


def test_lbfgs_fixed_points_skip_exactly():
    """A float32 quadratic converges to lanes whose steps change nothing;
    skipping the rest of their steps gives the state of making them all,
    bit for bit (memory, counts and all), in fewer passes."""
    rng = np.random.default_rng(0)
    d = torch.as_tensor(np.logspace(0, 1, 10), dtype=torch.float32)
    b = torch.as_tensor(rng.normal(size=(4, 10)), dtype=torch.float32)
    fun = lambda x: ((0.5 * d * x * x - b * x).sum(-1), d * x - b)
    x0 = torch.as_tensor(rng.normal(size=(4, 10)), dtype=torch.float32)
    skip, full = {}, {}
    xa, sa = lbfgs.run(fun, x0, lbfgs.init(x0), 60, stats=skip)
    xb, sb = lbfgs.run(fun, x0, lbfgs.init(x0), 60, skip_fixed_points=False, stats=full)
    assert torch.equal(xa, xb)
    for a, b_ in zip(sa, sb):
        assert torch.equal(a, b_)
    assert skip["fixed_lanes"] == 4 and full["fixed_lanes"] == 0
    assert skip["skipped_steps"] > 0 and skip["passes"] < full["passes"]


# ---------------------------------------------------------------- NN

def _nn_data(n=80, p=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) * [1.0, 10.0, 100.0] + [0.0, 5.0, 1000.0]
    y = np.sin(x[:, 0]) + 0.01 * x[:, 1] + 0.1 * rng.normal(size=n)
    return x, (y - y.min()) / (y.max() - y.min())


def _jax_init(key, p, h):
    """The uniforms nn.fit draws from ``key`` (nn.py:69-75), as numpy."""
    ks = jax.random.split(key, 4)
    shapes = [(p, h), (h,), (h,), ()]
    return [np.array(jax.random.uniform(k, s, jnp.float64, -0.7, 0.7)) for k, s in zip(ks, shapes)]


@pytest.fixture(scope="module")
def nn_fits():
    x, y = _nn_data()
    h, maxit = 4, 50
    key = jax.random.PRNGKey(3)
    js = jnn.fit(key, jnp.asarray(x), jnp.asarray(y), hidden=h, maxit=maxit)
    ts = tnn.fit(torch.as_tensor(x), torch.as_tensor(y), hidden=h, maxit=maxit,
                 init=[torch.as_tensor(a) for a in _jax_init(key, x.shape[1], h)])
    return x, y, js, ts


def test_nn_fit_matches_jax(nn_fits):
    x, y, js, ts = nn_fits
    want = np.asarray(jnn.predict(js, jnp.asarray(x)))
    got = tnn.predict(ts, torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= NN_TOL * np.ptp(y)
    assert np.mean((want - y) ** 2) < 0.1 * np.var(y)     # it learned


def test_nn_fit_batched_weighted_matches_jax():
    x, y = _nn_data(seed=1)
    h, maxit, lanes = 4, 50, 3
    w = (np.random.default_rng(2).uniform(size=(lanes, len(y))) > 0.3).astype(np.float64)
    keys = jax.random.split(jax.random.PRNGKey(5), lanes)
    want = np.asarray(jax.vmap(lambda kk, ww: jnn.predict(
        jnn.fit(kk, jnp.asarray(x), jnp.asarray(y), sample_weight=ww, hidden=h, maxit=maxit), jnp.asarray(x)
    ))(keys, jnp.asarray(w)))
    inits = [_jax_init(k, x.shape[1], h) for k in keys]
    init = [torch.as_tensor(np.stack([i[j] for i in inits])) for j in range(4)]
    yb = torch.as_tensor(y).expand(lanes, -1)
    got = tnn.predict(tnn.fit(torch.as_tensor(x), yb, sample_weight=torch.as_tensor(w), hidden=h, maxit=maxit,
                              init=init), torch.as_tensor(x)).numpy()
    assert np.abs(got - want).max() <= NN_TOL * np.ptp(y)


def test_nn_segmented_equals_whole():
    x, y = _nn_data(seed=2)
    xt, yt = torch.as_tensor(x), torch.as_tensor(y)
    gen = lambda: torch.Generator().manual_seed(9)
    stats = {}
    whole = tnn.fit(xt, yt, hidden=4, maxit=40, generator=gen(), stats=stats)
    assert stats["syncs"] <= 10 and stats["passes"] < 80       # a handful of host reads a fit
    carry = tnn.fit_carry_init(xt, yt, hidden=4, generator=gen())
    for _ in range(4):
        carry = tnn.fit_carry_steps(carry, xt, yt, steps=10)
    seg = tnn.carry_to_state(carry)
    for a, b in zip(seg, whole):
        assert torch.equal(a[0], b)


def test_nn_importance_matches_jax(nn_fits):
    _, _, js, ts = nn_fits
    names = ["alt", "slope", "twi"]
    want = jnn.importance(js, names)
    got = tnn.importance(convert.nn_state_from_jax(js, device="cpu"), names)
    assert list(got) == names
    assert all(abs(got[k] - want[k]) <= GARSON_TOL for k in names)
    assert abs(sum(tnn.importance(ts, names).values()) - 1.0) <= 1e-12
    flat = convert.nn_params_to_flat(js.w1, js.b1, js.w2, js.b2, device="cpu")
    assert flat.shape == (1, 3 * 4 + 2 * 4 + 1)
    back = convert.nn_params_from_flat(flat, 3, 4)
    for a, b in zip(back, (js.w1, js.b1, js.w2, js.b2)):
        np.testing.assert_array_equal(a[0], np.asarray(b))


def _cv_data(n=90, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, size=(n, 3)) * [1.0, 50.0, 3.0]
    y = np.stack([np.sin(3 * x[:, 0]) + 0.02 * x[:, 1], 100 * np.cos(2 * x[:, 2]) + x[:, 1]], 1)
    return x, y + 0.05 * rng.normal(size=y.shape)


def test_run_cv_n_matches_jax():
    x, y = _cv_data()
    n, k, h, maxit = len(y), 3, 4, 30
    key = jax.random.PRNGKey(11)
    want = jcv.run_cv(key, jnp.asarray(x), jnp.asarray(y), algorithms="n",
                      config=jcv.CVConfig(n_folds=k, nn=dict(hidden=h, maxit=maxit)))["n"]
    kf, _, _, kn, _ = jax.random.split(key, 5)           # run_cv's keys (cv.py:172)
    folds = np.stack([np.asarray(jax_kfold(jax.random.fold_in(kf, r), n, k)) for r in range(2)])
    inits = [_jax_init(kk, 3, h) for kk in jax.random.split(kn, 2 * k)]     # cv.py:227
    nn_init = [torch.as_tensor(np.stack([i[j] for i in inits])) for j in range(4)]
    got = tcv.run_cv(torch.as_tensor(x), torch.as_tensor(y), algorithms="n", folds=folds, nn_init=nn_init,
                     config=tcv.CVConfig(n_folds=k, nn=dict(hidden=h, maxit=maxit)))["n"]
    assert got.shape == want.shape == (2, n)
    for r in range(2):
        assert np.abs(got[r] - want[r]).max() <= NN_TOL * np.ptp(y[:, r])


def test_fit_final_batched_n_matches_jax():
    x, y = _cv_data(seed=4)
    h, maxit = 4, 30
    names = ["a", "b", "c"]
    keys = jax.random.split(jax.random.PRNGKey(12), 2)
    jfn, jimps = jmltps._fit_final_batched(
        "n", keys, jnp.asarray(x), jnp.asarray(y), names, jmltps.MLTPSConfig(final_nn=dict(hidden=h, maxit=maxit)))
    inits = [_jax_init(kk, 3, h) for kk in keys]
    nn_init = [torch.as_tensor(np.stack([i[j] for i in inits])) for j in range(4)]
    tfn, timps = tmltps._fit_final_batched(
        "n", torch.as_tensor(x), torch.as_tensor(y), names,
        tmltps.MLTPSConfig(final_nn=dict(hidden=h, maxit=maxit)), nn_init=nn_init)
    q = x[::3] * 1.1
    want = np.asarray(jfn(jnp.asarray(q)))
    got = tfn(torch.as_tensor(q)).numpy()
    assert got.shape == want.shape == (len(q), 2)
    for r in range(2):
        assert np.abs(got[:, r] - want[:, r]).max() <= NN_TOL * np.ptp(y[:, r])
        assert all(abs(timps[r][k] - jimps[r][k]) <= 1e-6 for k in names)


def test_mltps_gn_cpu_smoke():
    """The NN letter inside mltps on the CPU (GAM + NN pool, downsample 48,
    few L-BFGS steps): it runs, keeps letters of the pool, finite r²."""
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    nn_cfg = dict(hidden=10, maxit=20)
    cfg = tmltps.MLTPSConfig(letters_pool="gn", tps_tile_px=30, cv=tcv.CVConfig(nn=nn_cfg), final_nn=nn_cfg)
    timer = mtt.PhaseTimer()
    out = mtt.mltps(s, cov, tps=True, config=cfg, folds=numpy_folds(n, 10, 2, seed=0),
                    generator=torch.Generator().manual_seed(0), device="cpu", timer=timer)
    assert "cv_n" in timer.phases and "cv_g" in timer.phases
    for r in out:
        kept = r.summary["best model(s):"]
        assert kept and set(kept) <= set("gn")
        assert np.isfinite(r.summary["r2 ensemble:"]) and np.isfinite(r.summary["r2 final:"])
        if "n" in kept:
            assert set(r.var_imp["nn"]) == set(cov.names) | {"LONG", "LAT"}
