"""Parity of the port's serial gbm.step slice with the JAX package, on the CPU:
the gbm loss families and deviance, the per-fold bins, gbm's monotone check
in the plain version of kernel K2, ``brt.fit`` for each family (with
``offset`` and ``var_monotone``), ``gbm_step.fit`` and
``fit_multi(statistics=True)``.

Shapes are tiny (n <= 150, p = 3, 16 bins, 3 folds, tree complexity 2,
cycles of 2 trees, at most 60 trees).  The JAX package's own fold selectors
and threefry bag draws are rebuilt here from its key chains and injected,
so both packages grow the same chains.  Chains are float32 on both sides (K2
is float32; ``tests/conftest.py`` turns on x64, so every input is cast
explicitly).  Trees may part only where ``near_tie_gap`` finds a near-tie
(float64 gain gap <= 1e-5): float32 sums in another order break exact ties
either way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machisplin_tpu.models import brt as jbrt, deviance as jdev, families as jfam, gbm_step as jgbm, trees as jtrees
from machisplin_tpu_torch import convert
from machisplin_tpu_torch.models import brt as tbrt, deviance as tdev, families as tfam, gbm_step as tgbm
from machisplin_tpu_torch.models import trees as ttrees
from machisplin_tpu_torch.ops import tree_grow as ttg
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

NB = 16
FAMILIES = ["gaussian", "laplace", "poisson", "bernoulli"]
GBM = dict(tree_complexity=2, learning_rate=0.1, bag_fraction=0.5, n_folds=3, step_size=2, max_trees=60,
           n_bins=NB, min_leaf=5.0)


def _data(family, seed=0, n=150, p=3):
    """float32 (x, y) with a response of the family's kind."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, p))
    eta = 2.0 * x[:, 0] + np.sin(4 * x[:, 1]) - 1.0
    if family == "poisson":
        y = rng.poisson(np.exp(eta)).astype(float)
    elif family == "bernoulli":
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-2 * eta))).astype(float)
    else:
        y = eta + 0.2 * rng.standard_normal(n)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("family", FAMILIES)
def test_families_and_deviance_match_jax(family):
    """f0 (with and without an offset), gradient, response, leaf_adjust and
    calc_deviance (mean and total) in float64, to 1e-12 relative."""
    rng = np.random.default_rng(1)
    n, n_total = 60, 7
    _, y = _data(family, n=n)
    y = y.astype(np.float64)
    w = (rng.uniform(size=n) < 0.8).astype(np.float64) * rng.uniform(0.5, 1.5, n)
    f = 0.3 * rng.standard_normal(n)
    off = 0.2 * rng.standard_normal(n)
    cur = rng.choice([1, 3, 4, 5, 6], n)
    vals = rng.standard_normal(n_total)
    t = torch.as_tensor
    close = lambda got, want: np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-12, atol=1e-12)
    for o in (None, off):
        close(tfam.f0_init(t(y), t(w), family, None if o is None else t(o)),
              jfam.f0_init(jnp.asarray(y), jnp.asarray(w), family, None if o is None else jnp.asarray(o)))
    close(tfam.gradient(t(y), t(f), family), jfam.gradient(jnp.asarray(y), jnp.asarray(f), family))
    close(tfam.response(t(f), family), jfam.response(jnp.asarray(f), family))
    close(tfam.leaf_adjust(t(vals)[None], t(cur)[None], n_total, t(y), t(f)[None], t(w)[None], family)[0],
          jfam.leaf_adjust(jnp.asarray(vals), jnp.asarray(cur), n_total, jnp.asarray(y), jnp.asarray(f),
                           jnp.asarray(w), family))
    u = np.asarray(jfam.response(jnp.asarray(f), family))
    for mean in (True, False):
        close(tdev.calc_deviance(t(y), t(u), t(w), family, calc_mean=mean),
              jdev.calc_deviance(jnp.asarray(y), jnp.asarray(u), jnp.asarray(w), family, calc_mean=mean))
    assert tfam.check_family("binomial") == "bernoulli"
    with pytest.raises(ValueError, match="unknown family"):
        tfam.gradient(t(y), t(f), "gamma")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_make_bins_masked_matches_jax(dtype):
    """Each fold's edges over its own active rows: one float64 rounding (XLA
    fuses the interpolation's multiply-add), identical bins; a fold with no
    active rows too."""
    rng = np.random.default_rng(2)
    x = rng.uniform(0, 1, (97, 3)).astype(dtype)
    w = (rng.uniform(size=(4, 97)) < 0.6).astype(dtype)
    w[3] = 0.0
    want = np.stack([np.asarray(jtrees.make_bins_masked(jnp.asarray(x), jnp.asarray(wk), NB)) for wk in w])
    got = ttrees.make_bins_masked(torch.as_tensor(x), torch.as_tensor(w), NB).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-16 if dtype == "float64" else 0, atol=0)
    np.testing.assert_array_equal(ttrees.make_bins_masked(torch.as_tensor(x), torch.as_tensor(w[0]), NB).numpy(),
                                  got[0])
    for k in range(3):
        np.testing.assert_array_equal(ttrees.bin_data(torch.as_tensor(x), torch.as_tensor(want[k])).numpy(),
                                      np.asarray(jtrees.bin_data(jnp.asarray(x), jnp.asarray(want[k]))))


def test_best_splits_monotone_matches_jax():
    """The plain version's candidate scan with monotone signs against the
    JAX package's ``_best_splits`` on the same per-bin statistics (float64,
    each feature's histogram with its own total): the same (feature, bin)
    and gain, with every sign pattern."""
    rng = np.random.default_rng(3)
    hw = rng.integers(0, 6, (5, 3, NB)).astype(np.float64)
    hwy = hw * rng.standard_normal((5, 3, NB))
    cw, cwy = np.cumsum(hw, 2), np.cumsum(hwy, 2)
    for mono in ([1, 0, -1], [-1, -1, -1], [1, 1, 1], [0, 0, 0]):
        jg, jf, jb = jtrees._best_splits(jnp.asarray(hw), jnp.asarray(hwy), 3.0, monotone=jnp.asarray(mono, float))
        tg, tf, tb = ttrees._best_splits_cum(torch.as_tensor(cw), torch.as_tensor(cwy), torch.as_tensor(cw[:, :, -1:]),
                                             torch.as_tensor(cwy[:, :, -1:]), 3.0, monotone=torch.tensor(mono))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=1e-12)


def test_plain_k2_per_chain_tables_equal_one_table_each():
    """A launch of the plain version over per-chain tables grows each chain's
    tree as a launch with that chain's table alone; monotone signs keep
    every split's child means in order."""
    rng = np.random.default_rng(4)
    c, n, p = 3, 80, 3
    xb = torch.as_tensor(rng.integers(0, NB, (c, n, p)))
    y = torch.as_tensor(rng.standard_normal((c, n)).astype(np.float32))
    f = torch.zeros((c, n))
    w = torch.as_tensor((rng.uniform(size=(c, n)) < 0.7).astype(np.float32))
    mono = torch.tensor([1.0, -1.0, 0.0])
    kw = dict(n_splits=4, nb=NB, min_leaf=3.0, lr=0.5, emit_tree=True, monotone=mono)
    tables = ttg.prepare_bins(xb, NB)
    assert tables.xbt.shape == (c, p, n) and tables.cum1h.shape == (c, n, p * NB)
    got = ttg.gbm_tree_cycle(tables, y, f, w[None], **kw)
    for ch in range(c):
        one = ttg.gbm_tree_cycle(ttg.prepare_bins(xb[ch], NB), y[ch : ch + 1], f[ch : ch + 1], w[None, ch : ch + 1],
                                 **kw)
        for a, b in zip(got.trees, one.trees):
            torch.testing.assert_close(a[:, ch], b[:, 0], rtol=1e-6, atol=1e-6)
        feat, internal, left, right, value = (got.trees[k][0, ch] for k in (0, 2, 3, 4, 5))
        for q in np.nonzero(internal.numpy())[0]:
            sgn = float(mono[feat[q]])
            assert sgn * float(value[right[q]] - value[left[q]]) >= -1e-5


def _final_bags(kfinal, budget, n, bag_fraction):
    """The JAX package's ``brt.fit`` bag stream: split(key, n_trees), one
    (n,) uniform draw each."""
    keys = jax.random.split(kfinal, budget)

    def bags(t):
        return torch.as_tensor(np.asarray(jax.random.uniform(keys[t], (n,)) < bag_fraction, np.float32))

    return bags


def _curve_bags(kcv, restarts, step, n_folds, n, bag_fraction):
    """The JAX package's serial CV bag stream (``_cv_deviance_curve``): the
    cycle keys split off fold_in(kcv, restarts), split(key_c, step) per
    cycle, then split(key_t, n_folds) and an (n,) uniform draw per fold."""
    state = {"key": jax.random.fold_in(kcv, restarts), "cycles": []}

    def bags(t):
        cyc = t // step
        while len(state["cycles"]) <= cyc:
            state["key"], key_c = jax.random.split(state["key"])
            state["cycles"].append(jax.random.split(key_c, step))
        kf = jax.random.split(state["cycles"][cyc][t % step], n_folds)
        u = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(kf)
        return torch.as_tensor(np.asarray(u < bag_fraction, np.float32))

    return bags


def _leaf_node(tree_arrays, xb, depth):
    """Node of every row in each of T trees ((T, N) arrays, JAX or port),
    by bins and thresholds given as bin indices."""
    feat, thr_bin, internal, left, right = (torch.as_tensor(np.asarray(a)) for a in tree_arrays)
    return ttrees.route_bins(torch.as_tensor(xb), feat, thr_bin, internal, left, right, depth)


def _trees_part_only_at_ties(x32, y32, w, state_j, state_t, bags, lr, family, offset=None, mono=None):
    """Walk both packages' trees of one ``brt.fit`` in order, tracking the
    port's boosted score; where they first part, the state must sit at a
    near-tie (the gradient's gain gap <= 1e-5).  Returns whether they parted."""
    edges = state_t.edges.numpy()
    xb = ttrees.bin_data(torch.as_tensor(x32), torch.as_tensor(edges)).numpy()
    thr_bin = lambda st: np.vectorize(lambda f_, v: np.searchsorted(edges[f_], v))(
        np.asarray(st.trees.feat), np.asarray(st.trees.thr))
    tj, tt = thr_bin(state_j), thr_bin(state_t)
    n_trees = tt.shape[0]
    f = np.full(len(y32), float(state_t.f0), np.float64) + (0.0 if offset is None else offset)
    act = state_t.tree_active.numpy()
    for t in range(n_trees):
        a = [np.asarray(state_j.trees.feat[t]), tj[t], np.asarray(state_j.trees.internal[t]),
             np.asarray(state_j.trees.left[t])]
        b = [state_t.trees.feat[t].numpy(), tt[t], state_t.trees.internal[t].numpy(), state_t.trees.left[t].numpy()]
        z = np.asarray(jfam.gradient(jnp.asarray(y32, jnp.float64), jnp.asarray(f), family))
        gap = ttg.near_tie_gap(xb, z, np.asarray(bags(t)) * w, a, b, nb=NB, min_leaf=GBM["min_leaf"], monotone=mono)
        if gap is not None:
            assert gap <= 1e-5, (t, gap)
            return True
        arrs = [b[0], b[1], b[2], b[3], state_t.trees.right[t].numpy()]
        cur = _leaf_node([v[None] for v in arrs], xb, GBM["tree_complexity"])[0].numpy()
        f = f + lr * state_t.trees.value[t].numpy()[cur] * act[t]
    return False


BRT_CASES = [("gaussian", None), ("laplace", None), ("poisson", None), ("bernoulli", None),
             ("gaussian", "offset"), ("poisson", "offset"), ("gaussian", "monotone"), ("bernoulli", "monotone")]


@pytest.mark.parametrize("family,extra", BRT_CASES, ids=[f"{f}-{e}" if e else f for f, e in BRT_CASES])
def test_brt_fit_matches_jax(family, extra):
    """``brt.fit`` with the JAX package's bags injected: the same trees but
    where they part at a near-tie; if they never part, ``train_fit`` within
    1e-4 of the response's range, the leaf values and both deviance paths
    within 1e-4 relative of their scale, and ``predict`` as the JAX
    package's on new points."""
    x32, y32 = _data(family, seed=5)
    n = len(y32)
    rng = np.random.default_rng(6)
    w = (rng.uniform(size=n) < 0.85).astype(np.float32)
    kw = dict(n_trees=24, n_splits=GBM["tree_complexity"], lr=0.3, bag_fraction=0.5, min_leaf=GBM["min_leaf"],
              n_bins=NB, n_trees_active=20, family=family)
    offset = (0.2 * rng.standard_normal(n)).astype(np.float32) if extra == "offset" else None
    mono = np.asarray([1.0, -1.0, 0.0], np.float32) if extra == "monotone" else None
    key = jax.random.PRNGKey(11)
    js = jbrt.fit(key, jnp.asarray(x32), jnp.asarray(y32), sample_weight=jnp.asarray(w),
                  offset=None if offset is None else jnp.asarray(offset),
                  var_monotone=None if mono is None else jnp.asarray(mono), **kw)
    bags = _final_bags(key, kw["n_trees"], n, 0.5)
    ts = tbrt.fit(torch.as_tensor(x32), torch.as_tensor(y32), sample_weight=torch.as_tensor(w),
                  offset=None if offset is None else torch.as_tensor(offset),
                  var_monotone=None if mono is None else torch.as_tensor(mono), bags=bags, **kw)
    np.testing.assert_allclose(ts.f0.numpy(), np.asarray(js.f0), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ts.tree_active.numpy(), np.asarray(js.tree_active))
    if _trees_part_only_at_ties(x32, y32, w, js, ts, bags, kw["lr"], family, offset, mono):
        return
    tol = 1e-4 * np.ptp(y32)
    np.testing.assert_allclose(ts.train_fit.numpy(), np.asarray(js.train_fit), rtol=0, atol=tol)
    leaf = np.asarray(js.trees.internal) == 0
    np.testing.assert_allclose(ts.trees.value.numpy()[leaf], np.asarray(js.trees.value)[leaf], rtol=0,
                               atol=1e-4 * np.abs(np.asarray(js.trees.value)).max())
    for name in ("train_deviance", "holdout_deviance"):
        want = np.asarray(getattr(js, name))
        np.testing.assert_allclose(getattr(ts, name).numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    q = np.random.default_rng(7).uniform(-0.1, 1.1, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(tbrt.predict(ts, torch.as_tensor(q)).numpy(), np.asarray(jbrt.predict(js, jnp.asarray(q))),
                               rtol=0, atol=tol)


def _serial_draws(key, y32, w, family, n_folds=GBM["n_folds"], prev_stratify=True):
    """The JAX package's fold selector and bag streams of ``gbm_step.fit``."""
    ksel, kcv, kfinal = jax.random.split(jax.random.fold_in(key, 7), 3)
    selector = jgbm._make_selector(ksel, y32, w, n_folds, family=family, prev_stratify=prev_stratify)
    n = len(y32)

    def bags(stage):
        if stage[0] == "curve":
            return _curve_bags(kcv, stage[1], GBM["step_size"], n_folds, n, GBM["bag_fraction"])
        return _final_bags(kfinal, stage[1], n, GBM["bag_fraction"])

    return selector, bags


@pytest.fixture(scope="module")
def serial_runs():
    """``gbm_step.fit`` in both packages, gaussian and bernoulli, with the
    JAX package's draws injected into the port; gaussian at a learning rate
    that restarts once."""
    runs = {}
    for family, lr in (("gaussian", 0.9), ("bernoulli", 0.3)):
        x32, y32 = _data(family, seed=8)
        w = np.ones(len(y32), np.float32)
        kw = dict(GBM, learning_rate=lr, family=family, max_restarts=1)
        key = jax.random.PRNGKey(21)
        jres = jgbm.fit(key, jnp.asarray(x32), jnp.asarray(y32), **kw)
        selector, bags = _serial_draws(key, y32, w, family)
        tres = tgbm.fit(torch.as_tensor(x32), torch.as_tensor(y32), selector=selector, bags=bags, **kw)
        runs[family] = (x32, y32, jres, tres, bags)
    return runs


@pytest.mark.parametrize("family", ["gaussian", "bernoulli"])
def test_gbm_step_fit_matches_jax(serial_runs, family):
    """Same best_trees, trees_fitted, restarts and learning rate; the CV
    curve within 1e-5 relative; the final trees the same but where they part
    at a near-tie; if they never part, the statistics blocks and
    fitted/residuals within 1e-4 of their scale."""
    x32, y32, jres, tres, bags = serial_runs[family]
    assert (tres.best_trees, tres.trees_fitted, tres.restarts, tres.learning_rate, tres.family) == (
        jres.best_trees, jres.trees_fitted, jres.restarts, jres.learning_rate, jres.family)
    np.testing.assert_array_equal(tres.selector, jres.selector)
    j = jres.trees_fitted // GBM["step_size"]
    for name in ("cv_deviance", "cv_deviance_se", "training_deviance"):
        want = np.asarray(getattr(jres, name))
        got = getattr(tres, name).numpy()
        assert np.isinf(got[j:]).all() and np.isinf(want[j:]).all()
        np.testing.assert_allclose(got[:j], want[:j], rtol=1e-5, atol=1e-7, err_msg=name)
    if family == "gaussian":
        assert jres.restarts == 1
    budget = tres.final.tree_active.shape[0]
    w = np.ones(len(y32), np.float32)
    if _trees_part_only_at_ties(x32, y32, w, jres.final, tres.final, bags(("final", budget)), tres.learning_rate,
                                family):
        return
    for name in ("fitted", "residuals", "fitted_vars", "fold_fit"):
        want = np.asarray(getattr(jres, name))
        np.testing.assert_allclose(getattr(tres, name), want, rtol=0, atol=1e-4 * max(np.abs(want).max(), 1e-3),
                                   err_msg=name)
    for block in ("self_statistics", "cv_statistics"):
        a, b = getattr(jres, block), getattr(tres, block)
        assert list(a) == list(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-4, atol=1e-6, err_msg=f"{block}[{k}]")
    carried = convert.gbm_result_from_numpy(jres, device="cpu")
    assert carried.self_statistics == pytest.approx(jres.self_statistics)
    np.testing.assert_array_equal(carried.fitted, np.asarray(jres.fitted))
    q = np.random.default_rng(9).uniform(0, 1, (40, 3)).astype(np.float32)
    np.testing.assert_allclose(tgbm.predict(tres, torch.as_tensor(q), type="response").numpy(),
                               np.asarray(jgbm.predict(jres, jnp.asarray(q), type="response")), rtol=0,
                               atol=1e-4 * np.ptp(y32))


def test_gbm_step_fit_offset_and_monotone_match_jax():
    """gaussian with an offset and monotone signs: the same selection, the
    CV curve within 1e-5 relative; the final trees the same but where they
    part at a near-tie, and then ``fitted`` (offset included) within 1e-4
    of the range."""
    x32, y32 = _data("gaussian", seed=10, n=120)
    rng = np.random.default_rng(12)
    offset = (0.3 * rng.standard_normal(len(y32))).astype(np.float32)
    mono = np.asarray([1.0, 0.0, -1.0], np.float32)
    kw = dict(GBM, max_trees=40)
    key = jax.random.PRNGKey(31)
    jres = jgbm.fit(key, jnp.asarray(x32), jnp.asarray(y32), offset=jnp.asarray(offset),
                    var_monotone=jnp.asarray(mono), **kw)
    selector, bags = _serial_draws(key, y32, np.ones(len(y32)), "gaussian")
    tres = tgbm.fit(torch.as_tensor(x32), torch.as_tensor(y32), offset=torch.as_tensor(offset),
                    var_monotone=torch.as_tensor(mono), selector=selector, bags=bags, **kw)
    assert (tres.best_trees, tres.trees_fitted, tres.restarts) == (jres.best_trees, jres.trees_fitted, jres.restarts)
    j = jres.trees_fitted // GBM["step_size"]
    np.testing.assert_allclose(tres.cv_deviance.numpy()[:j], np.asarray(jres.cv_deviance)[:j], rtol=1e-5)
    budget = tres.final.tree_active.shape[0]
    if not _trees_part_only_at_ties(x32, y32, np.ones(len(y32), np.float32), jres.final, tres.final,
                                    bags(("final", budget)), tres.learning_rate, "gaussian", offset, mono):
        np.testing.assert_allclose(tres.fitted, np.asarray(jres.fitted), rtol=0, atol=1e-4 * np.ptp(y32))


def test_fold_vector_labels_and_length():
    """R's 1-based labels and 0-based ones give the same selector (the JAX
    package's 1-based guess: min >= 1 and max == n_folds); a vector of the
    wrong length raises the reference's error; labels out of range raise."""
    x32, y32 = _data("gaussian", n=60)
    folds0 = np.arange(60) % 3
    kw = dict(GBM, max_trees=8, generator=torch.Generator().manual_seed(0))
    a = tgbm.fit(torch.as_tensor(x32), torch.as_tensor(y32), fold_vector=folds0 + 1, **kw)
    b = tgbm.fit(torch.as_tensor(x32), torch.as_tensor(y32), fold_vector=folds0, **kw)
    np.testing.assert_array_equal(a.selector, folds0)
    np.testing.assert_array_equal(b.selector, folds0)
    np.testing.assert_array_equal(a.selector, jgbm.fit(jax.random.PRNGKey(0), jnp.asarray(x32), jnp.asarray(y32),
                                                       fold_vector=folds0 + 1, **dict(GBM, max_trees=8)).selector)
    with pytest.raises(ValueError, match="supplied fold vector is of wrong length"):
        tgbm.fit(torch.as_tensor(x32), torch.as_tensor(y32), fold_vector=folds0[:-1], **kw)
    with pytest.raises(ValueError, match="fold_vector labels"):
        tgbm.fit(torch.as_tensor(x32), torch.as_tensor(y32), fold_vector=folds0 + 2, **kw)


def test_fit_multi_statistics_match_jax():
    """``fit_multi(statistics=True)`` with the JAX package's draws: the same
    selection per response, and every statistics field within 1e-4 of its
    scale for responses whose final trees never part."""
    from test_torch_brt import _final_bags as multi_final_bags, _outer_bags

    x32, y = _data("gaussian", seed=13)
    n = len(y)
    ycols = np.stack([y, 0.5 * y + np.random.default_rng(14).standard_normal(n)], 1).astype(np.float32)
    kw = dict(GBM, learning_rate=0.3, max_restarts=1)
    keys = jnp.stack([jax.random.PRNGKey(41), jax.random.PRNGKey(42)])
    jres = jgbm.fit_multi(keys, jnp.asarray(x32), jnp.asarray(ycols), statistics=True, **kw)
    split = [jax.random.split(jax.random.fold_in(keys[j], 7), 3) for j in range(2)]
    selectors = np.stack([jgbm._make_selector(split[j][0], ycols[:, j], np.ones(n), kw["n_folds"]) for j in range(2)])

    def bags(stage):
        if stage[0] == "curve":
            kcv = jax.random.fold_in(split[stage[1][0]][1], stage[2])
            cb = _outer_bags(jax.random.split(kcv)[1], len(stage[1]), kw["n_folds"], n, kw["bag_fraction"])
            return lambda t: cb(t, kw["step_size"])
        return multi_final_bags(jnp.stack([s[2] for s in split]), stage[1], n, kw["bag_fraction"])

    tres = tgbm.fit_multi(torch.as_tensor(x32), torch.as_tensor(ycols), statistics=True, selectors=selectors,
                          bags=bags, **kw)
    for j, (a, b) in enumerate(zip(jres, tres)):
        assert (b.best_trees, b.trees_fitted, b.restarts) == (a.best_trees, a.trees_fitted, a.restarts)
        jj = a.trees_fitted // kw["step_size"]
        np.testing.assert_allclose(b.training_deviance.numpy()[:jj], np.asarray(a.training_deviance)[:jj],
                                   rtol=1e-5)
        np.testing.assert_allclose(b.fold_fit, np.asarray(a.fold_fit), rtol=0, atol=1e-5 * np.ptp(ycols[:, j]))
        np.testing.assert_allclose(b.fitted_vars, np.asarray(a.fitted_vars), rtol=1e-4, atol=1e-6)
        for k in a.cv_statistics:
            np.testing.assert_allclose(b.cv_statistics[k], a.cv_statistics[k], rtol=1e-4, atol=1e-6)
        if np.abs(b.fitted - np.asarray(a.fitted)).max() <= 1e-4 * np.ptp(ycols[:, j]):
            for k in a.self_statistics:
                np.testing.assert_allclose(b.self_statistics[k], a.self_statistics[k], rtol=1e-4)
            np.testing.assert_allclose(b.residuals, np.asarray(a.residuals), rtol=0, atol=1e-4 * np.ptp(ycols[:, j]))
