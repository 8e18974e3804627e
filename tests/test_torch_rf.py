"""The RF letter: the port's level-wise tree grower
(``models/trees.grow_level_trees``), ``models/rf.py``, its CV letter and its
merged final fits, against the JAX package's, on the CPU in float64, and a
CPU ``mltps`` over the default six-letter pool.

The JAX side draws each tree's bootstrap rows and per-node feature scores
from its threefry keys; the test draws the same ones and injects them into
the port.  Split statistics are float32 sums in both packages (the bf16
hi + lo histogram class), summed in another order, so two trees may part
where two candidate splits are within round-off of each other: a parting is
accepted when the two choices' gains, recomputed exactly in float64 from
the rows of the node where the trees first differ, are within TIE_GAP
(relative) of each other.  Where the trees agree, leaf values and the
predictions built from them match to 1e-8 of the response range.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import machisplin_tpu_torch as mtt
from machisplin_tpu.ensemble import cv as jcv
from machisplin_tpu.ensemble.kfold import kfold as jax_kfold
from machisplin_tpu.models import rf as jrf, trees as jtrees
from machisplin_tpu_torch import convert
from machisplin_tpu_torch.ensemble import cv as tcv
from machisplin_tpu_torch.ensemble.kfold import numpy_folds
from machisplin_tpu_torch.grid import GridSpec, Raster
from machisplin_tpu_torch.models import rf as trf, trees as ttrees
from machisplin_tpu_torch.utils.timing import PhaseTimer
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

tmltps = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")

NB, DEPTH, NTREE, MIN_LEAF = 16, 4, 6, 5.0
TIE_GAP = 1e-5
RF_TOL = 1e-8          # of the response range, where the trees agree
F32_TOL = 1e-6         # of the response range: the forest predictor computes in float32
PURITY_RTOL = 1e-5     # IncNodePurity sums the float32-histogram split gains


def _data(n=120, p=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, p)) * [1.0, 20.0, 3.0]
    y = np.stack([2.0 * x[:, 0] + np.sin(x[:, 2]), 10 * np.cos(x[:, 2]) + 0.2 * x[:, 1]], 1)
    return x, y + 0.1 * rng.normal(size=y.shape)


def _jax_draws(key, w, ntree, max_depth, p, mtry):
    """Each tree's raw bootstrap counts (ntree, n) and node scores (ntree,
    2^max_depth - 1, p), as ``rf.fit`` and ``grow_level_tree`` draw them
    from ``key`` (rf.py:72-85, trees.py:279-283)."""
    n = len(w)
    counts, scores = [], []
    for k in jax.random.split(key, ntree):
        kboot, kgrow = jax.random.split(k)
        logits = jnp.where(jnp.asarray(w) > 0, 0.0, -jnp.inf)
        draws = np.asarray(jax.random.categorical(kboot, logits, shape=(n,)))
        counts.append(np.bincount(draws, minlength=n).astype(np.float64))
        levels = []
        for level in range(max_depth):
            if mtry < p:
                kgrow, sub = jax.random.split(kgrow)
                levels.append(np.asarray(jax.random.uniform(sub, (2**level, p))))
        scores.append(np.concatenate(levels) if levels else np.zeros((2**max_depth - 1, p)))
    return np.stack(counts), np.stack(scores)


def _node_gain(xb, y, w, rows, choice, nb, min_leaf):
    """A node choice's gain, exactly in float64 from its rows: 1e-9 (the
    split threshold) for no split, -inf for an invalid split."""
    if choice is None:
        return 1e-9
    f, b = choice
    cw = np.cumsum(np.bincount(xb[rows, f], w[rows], minlength=nb))
    cwy = np.cumsum(np.bincount(xb[rows, f], w[rows] * y[rows], minlength=nb))
    tw, twy = cw[-1], cwy[-1]
    lw, lwy, rw, rwy = cw[b], cwy[b], tw - cw[b], twy - cwy[b]
    if lw < min_leaf or rw < min_leaf or b >= nb - 1:
        return -np.inf
    return lwy * lwy / max(lw, 1e-12) + rwy * rwy / max(rw, 1e-12) - twy * twy / max(tw, 1e-12)


def _choices(tree, edges):
    """Per node: None (leaf) or (feature, bin threshold): the nearest edge
    (edges of the two packages may differ in the last bit)."""
    feat, thr, internal = (np.asarray(a) for a in (tree.feat, tree.thr, tree.internal))
    return [None if internal[q] <= 0 else (int(feat[q]), int(np.argmin(np.abs(edges[feat[q]] - thr[q]))))
            for q in range(len(feat))]


def tree_gap(jtree, ttree, xb, edges, y, w, nb=NB, min_leaf=MIN_LEAF):
    """None for the same tree; else the relative float64 gain gap between
    the two trees' choices at their first differing node.  Heap order is
    level order, so the node's ancestors, and the rows they route to it,
    are the same in both trees."""
    cj, ct = _choices(jtree, edges), _choices(ttree, edges)
    diff = [q for q in range(len(cj)) if cj[q] != ct[q]]
    if not diff:
        return None
    q = diff[0]
    node = np.zeros(len(xb), np.int64)
    for _ in range(int(np.log2(q + 1))):
        for i, u in enumerate(node):
            if cj[u] is not None:
                f, b = cj[u]
                node[i] = 2 * u + 1 if xb[i, f] <= b else 2 * u + 2
    rows = np.flatnonzero(node == q)
    ga = _node_gain(xb, y, w, rows, cj[q], nb, min_leaf)
    gb = _node_gain(xb, y, w, rows, ct[q], nb, min_leaf)
    if not (np.isfinite(ga) and np.isfinite(gb)):
        return np.inf
    return abs(ga - gb) / max(abs(ga), abs(gb))


def _tree(t, i):
    return type(t)(*(np.asarray(a)[i] for a in t))


def _compare_forest(js, ts, x, y, w, counts):
    """Tree by tree: same trees or a near-tie parting; returns the agreeing
    trees' mask and the largest gap."""
    edges = np.asarray(js.edges)
    xb = np.asarray(jtrees.bin_data(jnp.asarray(x), js.edges))
    n_active = max((w > 0).sum(), 1.0)
    agree, gaps = [], []
    for t in range(np.asarray(js.trees.feat).shape[0]):
        jt, tt = _tree(js.trees, t), _tree(ts.trees, t)
        gap = tree_gap(jt, tt, xb, edges, y, counts[t] * (n_active / len(x)))
        agree.append(gap is None)
        if gap is not None:
            gaps.append(gap)
            assert gap <= TIE_GAP, f"tree {t} parts at a gain gap of {gap}"
        else:
            np.testing.assert_allclose(tt.thr, jt.thr, rtol=1e-14, atol=0)
            np.testing.assert_allclose(tt.value, jt.value, rtol=0, atol=RF_TOL * np.ptp(y))
            np.testing.assert_allclose(tt.var_gain, jt.var_gain, rtol=PURITY_RTOL, atol=1e-9)
    return np.asarray(agree), max(gaps, default=0.0)


def test_grow_level_tree_and_tree_predict_match_jax():
    """The JAX package's one-tree names, ``grow_level_tree`` (its key's node
    scores injected) and ``tree_predict``, against the port's counterparts
    over ``grow_level_trees`` and ``tree_assign``: the same tree (or a
    near-tie parting) and, where the same, the same predictions."""
    x, y = _data(seed=4)
    n, p = x.shape
    w = np.random.default_rng(4).integers(0, 3, n).astype(np.float64)
    key = jax.random.PRNGKey(8)
    jedges = jtrees.make_bins(jnp.asarray(x), NB)
    jxb = jtrees.bin_data(jnp.asarray(x), jedges)
    grow = jax.jit(jtrees.grow_level_tree, static_argnames=("max_depth", "min_leaf", "mtry"))   # eager: ~20 s
    jt = grow(key, jxb, jedges, jnp.asarray(y[:, 0]), jnp.asarray(w), max_depth=DEPTH, min_leaf=MIN_LEAF, mtry=2)
    levels, k = [], key
    for level in range(DEPTH):              # grow_level_tree's draws (trees.py:283-285)
        k, sub = jax.random.split(k)
        levels.append(np.asarray(jax.random.uniform(sub, (2**level, p))))
    tt, cur = ttrees.grow_level_tree(torch.as_tensor(np.array(jxb)), torch.as_tensor(np.array(jedges)),
                                     torch.as_tensor(y[:, 0]), torch.as_tensor(w), max_depth=DEPTH,
                                     min_leaf=MIN_LEAF, mtry=2, scores=np.concatenate(levels), return_assign=True)
    assert tt.feat.shape == (2 ** (DEPTH + 1) - 1,) and cur.shape == (n,)
    assert int(tt.internal.sum()) >= 3
    gap = tree_gap(jt, tt, np.asarray(jxb), np.asarray(jedges), y[:, 0], w)
    assert gap is None, f"the trees part at a gain gap of {gap}"
    q = x * 1.01
    want = np.asarray(jtrees.tree_predict(jt, jnp.asarray(q), DEPTH))
    got = ttrees.tree_predict(tt, torch.as_tensor(q), DEPTH).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=RF_TOL * np.ptp(y[:, 0]))
    np.testing.assert_array_equal(ttrees.tree_predict(tt, torch.as_tensor(x), DEPTH).numpy(),
                                  tt.value[cur].numpy())


@pytest.fixture(scope="module")
def rf_fits():
    """One weighted forest per package, from the same draws."""
    x, y = _data()
    w = (np.arange(len(x)) % 6 != 4).astype(np.float64)
    key = jax.random.PRNGKey(21)
    kw = dict(ntree=NTREE, max_depth=DEPTH, n_bins=NB)
    js = jrf.fit(key, jnp.asarray(x), jnp.asarray(y[:, 0]), sample_weight=jnp.asarray(w), **kw)
    counts, scores = _jax_draws(key, w, NTREE, DEPTH, 3, 1)
    ts = trf.fit(torch.as_tensor(x), torch.as_tensor(y[:, 0]), sample_weight=torch.as_tensor(w),
                 boot_counts=torch.as_tensor(counts), scores=torch.as_tensor(scores), **kw)
    return x, y[:, 0], w, counts, js, ts


def test_bootstrap_counts_match_jax(rf_fits):
    _, _, w, counts, js, ts = rf_fits
    np.testing.assert_array_equal(ts.oob_count.numpy(), np.asarray(js.oob_count))
    assert (counts[:, w == 0] == 0).all() and (counts.sum(1) == len(w)).all()


def test_level_trees_match_jax(rf_fits):
    x, y, w, counts, js, ts = rf_fits
    agree, _ = _compare_forest(js, ts, x, y, w, counts)
    assert agree.sum() >= len(agree) - 1
    cur_rows = np.asarray(ts.trees.internal).sum(1)
    assert (cur_rows >= 3).all()          # every tree split beyond the root


def test_rf_train_pred_and_predict_match_jax(rf_fits):
    x, y, w, counts, js, ts = rf_fits
    agree, _ = _compare_forest(js, ts, x, y, w, counts)
    span = np.ptp(y)
    q = x[::2] * 1.02
    # per tree, the gather walk over each package's own trees
    jpt = np.stack([np.asarray(jtrees.tree_predict(jax.tree.map(lambda a, i=i: a[i], js.trees), jnp.asarray(q), DEPTH))
                    for i in range(NTREE)])
    tpt = np.stack([ttrees.forest_predict(ttrees.Tree(*(a[i : i + 1] for a in ts.trees)), torch.as_tensor(q), DEPTH,
                                          weights=torch.ones(1)).numpy() for i in range(NTREE)])
    assert np.abs(tpt[agree] - jpt[agree]).max() <= RF_TOL * span
    if agree.all():
        np.testing.assert_allclose(ts.train_pred.numpy(), np.asarray(js.train_pred), rtol=0, atol=RF_TOL * span)
        # rf.predict: the forest predictor (K3's plain version), float32
        got = trf.predict(ts, torch.as_tensor(q)).numpy()
        assert np.abs(got - np.asarray(jrf.predict(js, jnp.asarray(q)))).max() <= F32_TOL * span
    # the JAX forest carried over predicts as the JAX package does
    carried = convert.rf_state_from_jax({k: getattr(js, k) for k in js._fields}, dtype=torch.float64, device="cpu")
    got = trf.predict(carried, torch.as_tensor(q)).numpy()
    assert np.abs(got - np.asarray(jrf.predict(js, jnp.asarray(q)))).max() <= F32_TOL * span


def test_rf_importance_matches_jax(rf_fits):
    x, y, w, counts, js, ts = rf_fits
    names = ["a", "b", "c"]
    want = jrf.importance(js, jnp.asarray(x), jnp.asarray(y), names)
    perms = np.stack([np.asarray(jax.random.permutation(k, len(x)))
                      for k in jax.random.split(jax.random.PRNGKey(1313), 3)])     # rf.py:162-171
    carried = convert.rf_state_from_jax({k: getattr(js, k) for k in js._fields}, dtype=torch.float64, device="cpu")
    agree, _ = _compare_forest(js, ts, x, y, w, counts)
    states = [carried] + ([ts] if agree.all() else [])
    for st in states:
        got = trf.importance(st, torch.as_tensor(x), torch.as_tensor(y), names, perms=torch.as_tensor(perms))
        assert list(got) == names
        for nm in names:
            assert got[nm]["%IncMSE"] == pytest.approx(want[nm]["%IncMSE"], rel=1e-10, abs=1e-10)
            assert got[nm]["IncNodePurity"] == pytest.approx(want[nm]["IncNodePurity"], rel=PURITY_RTOL)


def test_run_cv_r_matches_jax():
    x, y = _data(n=90, seed=3)
    n, k = len(x), 3
    key = jax.random.PRNGKey(17)
    rf_cfg = dict(ntree=4, max_depth=3, n_bins=NB)
    want = jcv.run_cv(key, jnp.asarray(x), jnp.asarray(y), algorithms="r",
                      config=jcv.CVConfig(n_folds=k, rf=rf_cfg))["r"]
    kf, _, kr, _, _ = jax.random.split(key, 5)           # run_cv's keys (cv.py:172)
    folds = np.stack([np.asarray(jax_kfold(jax.random.fold_in(kf, r), n, k)) for r in range(2)])
    flat_w = np.concatenate([(f[None, :] != np.arange(k)[:, None]).astype(np.float64) for f in folds])
    lane_keys = [jax.random.fold_in(kr, i) for i in range(2 * k)]                # cv.py:303
    draws = [_jax_draws(kk, flat_w[i], 4, 3, 3, 1) for i, kk in enumerate(lane_keys)]
    counts = np.stack([d[0] for d in draws])
    scores = np.stack([d[1] for d in draws])
    got = tcv.run_cv(torch.as_tensor(x), torch.as_tensor(y), algorithms="r", folds=folds,
                     rf_draws=(torch.as_tensor(counts), torch.as_tensor(scores)),
                     config=tcv.CVConfig(n_folds=k, rf=rf_cfg))["r"]
    assert got.shape == want.shape == (2, n)
    # which lanes' forests agree tree for tree
    flat_y = np.repeat(y.T, k, axis=0)
    jstates = jax.vmap(lambda kk, yy, ww: jrf.fit(kk, jnp.asarray(x), yy, sample_weight=ww, **rf_cfg)
                       ._replace(max_depth=None))(jnp.stack(lane_keys), jnp.asarray(flat_y), jnp.asarray(flat_w))
    tstates = trf.fit(torch.as_tensor(x), torch.as_tensor(flat_y), sample_weight=torch.as_tensor(flat_w),
                      boot_counts=torch.as_tensor(counts), scores=torch.as_tensor(scores), **rf_cfg)
    lane_ok = np.ones(2 * k, bool)
    for i in range(2 * k):
        js = jax.tree.map(lambda a, i=i: a[i], jstates)
        agree, _ = _compare_forest(js, trf.lane(tstates, i), x, flat_y[i], flat_w[i], counts[i])
        lane_ok[i] = agree.all()
    assert lane_ok.sum() >= len(lane_ok) - 1
    # residuals are fold-major per response: fold v's test rows in order
    for r in range(2):
        off = 0
        for v in range(k):
            te = folds[r] == v
            if lane_ok[r * k + v]:
                np.testing.assert_allclose(got[r, off : off + te.sum()], want[r, off : off + te.sum()],
                                           rtol=0, atol=RF_TOL * np.ptp(y[:, r]))
            off += te.sum()


def test_final_rf_merged_pass_matches_jax():
    """``_final_rf_batched``: every response's forest from the same draws as
    the JAX package's per-response ``rf.fit``, one merged raster pass equal
    to each JAX forest's own prediction (float32), station predictions
    through the same call, and each response's importance."""
    x, y = _data(n=100, seed=8)
    names = ["a", "b", "c"]
    cfg = tmltps.MLTPSConfig(final_rf=dict(ntree=NTREE, max_depth=DEPTH, n_bins=NB), predict_block_rows=4)
    keys = jax.random.split(jax.random.PRNGKey(30), 2)
    draws = [_jax_draws(kk, np.ones(len(x)), NTREE, DEPTH, 3, 1) for kk in keys]
    jstates = [jrf.fit(kk, jnp.asarray(x), jnp.asarray(y[:, j]), **cfg.final_rf) for j, kk in enumerate(keys)]
    rng = np.random.default_rng(2)
    cells = rng.uniform(0, 1, (3, 6, 7)) * np.array([1.0, 20.0, 3.0])[:, None, None]
    cells[1, 2, 3] = np.nan
    stack = Raster(torch.as_tensor(cells), GridSpec(nrows=6, ncols=7, xmin=0.0, ymax=1.0, dx=0.1, dy=0.1))
    timer = PhaseTimer()
    surf, pt, imps = tmltps._final_rf_batched(
        torch.as_tensor(x), torch.as_tensor(y), names, stack, cfg, None, timer,
        rf_draws=(torch.as_tensor(np.stack([d[0] for d in draws])), torch.as_tensor(np.stack([d[1] for d in draws]))))
    assert {"final_fit_r_x2", "importance_r", "forest_tables_r", "raster_predict_r_x2"} <= set(timer.phases)
    assert surf.shape == (6, 7, 2) and pt.shape == (len(x), 2)
    flat = cells.reshape(3, -1).T
    for j, js in enumerate(jstates):
        span = np.ptp(y[:, j])
        ok = np.isfinite(flat).all(1)
        want = np.asarray(jrf.predict(js, jnp.asarray(np.where(ok[:, None], flat, 0.0))))
        got = surf[..., j].reshape(-1).numpy()
        assert np.isnan(got[~ok]).all()
        assert np.abs(got[ok] - want[ok]).max() <= F32_TOL * span
        assert np.abs(pt[:, j].numpy() - np.asarray(jrf.predict(js, jnp.asarray(x)))).max() <= F32_TOL * span
        jimp = jrf.importance(js, jnp.asarray(x), jnp.asarray(y[:, j]), names)
        for nm in names:
            assert imps[j][nm]["IncNodePurity"] == pytest.approx(jimp[nm]["IncNodePurity"], rel=PURITY_RTOL)


def test_mltps_default_pool_cpu_smoke():
    """The north-star call's pool ("bgnmrv", no ``letters_pool``) through
    mltps on the CPU at downsample 48 with shrunken configs: every letter's
    CV runs (one phase each), each response keeps letters of the pool, r²
    finite; then the RF and SVM finals through mltps ("rv")."""
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    brt = dict(tree_complexity=2, learning_rate=0.1, bag_fraction=0.5, n_folds=3, step_size=10, max_trees=20,
               n_bins=NB)
    nn_cfg, rf_cfg, svm_cfg = dict(hidden=4, maxit=10), dict(ntree=8, max_depth=4, n_bins=NB), dict(epochs=3)
    mars_cfg = dict(n_pairs=3, n_knots=8)
    cv = tcv.CVConfig(n_folds=3, brt=brt, nn=nn_cfg, rf=rf_cfg, svm=svm_cfg, mars=mars_cfg)
    folds = numpy_folds(n, 3, 2, seed=0)
    for pool in (None, "rv"):
        cfg = tmltps.MLTPSConfig(cv=cv, final_brt=brt, final_nn=nn_cfg, final_rf=rf_cfg, final_svm=svm_cfg,
                                 final_mars=mars_cfg, svm_importance_sample=20, letters_pool=pool)
        timer = PhaseTimer()
        out = mtt.mltps(s, cov, tps=True, config=cfg, folds=folds, generator=torch.Generator().manual_seed(0),
                        device="cpu", timer=timer)
        pool = pool or "bgnmrv"
        assert {f"cv_{letter}" for letter in pool} <= set(timer.phases)
        for r in out:
            kept = r.summary["best model(s):"]
            assert kept and set(kept) <= set(pool)
            assert np.isfinite(r.summary["r2 ensemble:"]) and np.isfinite(r.summary["r2 final:"])
            assert np.isfinite(r.final.data.numpy()[np.isfinite(cov.data.numpy()).all(0)]).all()
            if "v" in kept:
                assert set(r.var_imp["svm"]) == set(cov.names) | {"LONG", "LAT"}
            if "r" in kept:
                assert set(r.var_imp["rf"]) == set(cov.names) | {"LONG", "LAT"}
    assert any(k.startswith(("final_fit_r", "final_fit_v")) for k in timer.phases)
