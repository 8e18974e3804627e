"""Parity of the port's per-fold and shared bins (the batched gbm.step with
``global_bins=False``) with the JAX package, on the CPU.

``_cv_deviance_curve_multi``, ``fit_outer_batched`` and ``fit_multi`` run in
both packages with ``global_bins=False`` and both ``shared_bins`` values,
the port given the JAX package's own fold selectors and threefry bag draws
(rebuilt here from its key chains), so both grow the same chains: the
port on K2's plain version with one bin table per chain, the JAX package
with its own growers.  Trees may part only at near-ties (relative gain gap
<= 1e-5, ``ops/tree_grow.near_tie_gap``); curves, stopping checkpoints and
best trees must match, and the fits of chains whose trees never part agree
to 1e-4 of the response's spread.  Also the JAX package's shared-bins
grower and ``assigned_predict_batched`` against their plain copies in the
port.  Shapes are tiny (n = 150, p = 3, nb = 16); chains are float32 on
both sides.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machisplin_tpu.models import brt as jbrt, gbm_step as jgbm, trees as jtrees
from machisplin_tpu_torch.models import gbm_step as tgbm, trees as ttrees
from machisplin_tpu_torch.ops import tree_grow as ttg
from test_torch_brt import GBM as GBM_BRT, NB, _data, _final_bags, _outer_bags
from test_torch_io import one_torch_thread  # noqa: F401  (autouse: one torch thread here too)
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)


BRANCHES = {"shared": True, "per_fold": False}
# test_torch_brt's gbm.step settings with one tree a checkpoint: 30
# checkpoints, so the stopping rule (armed at 20) can fire
GBM = dict(GBM_BRT, step_size=1, max_trees=30)


def _perfold_bags(key, n_chains, n, bag_fraction):
    """The JAX package's CV bag stream of the per-fold branch: cycle keys
    split off ``key``, then per tree split(key_t, F * K) and an (n,)
    uniform draw per chain."""
    cache, state = {}, {"key": key}

    def bags(t, step):
        cyc = t // step
        while cyc not in cache:
            state["key"], key_c = jax.random.split(state["key"])
            cache[len(cache)] = jax.random.split(key_c, step)
        kc = jax.random.split(cache[cyc][t % step], n_chains)
        u = jax.vmap(lambda k: jax.random.uniform(k, (n,)))(kc)
        return torch.as_tensor(np.asarray(u < bag_fraction, np.float32))

    return bags


def _curve_bags(kboost, shared, f_outer, n, kw):
    if shared:
        cb = _outer_bags(kboost, f_outer, kw["n_folds"], n, kw["bag_fraction"])
    else:
        cb = _perfold_bags(kboost, f_outer * kw["n_folds"], n, kw["bag_fraction"])
    return lambda t: cb(t, kw["step_size"])


def _selectors(kfold, w_outer, n_folds):
    """The JAX package's on-device inner-fold selectors (argsort of uniforms)."""
    n = w_outer.shape[1]

    def selector_for(kf, w):
        order = jnp.argsort(jax.random.uniform(kf, (n,)) + (w <= 0) * 10.0)
        seq = (jnp.arange(n) % n_folds).astype(jnp.int32)
        return jnp.zeros((n,), jnp.int32).at[order].set(seq)

    return np.asarray(jax.vmap(selector_for)(jax.random.split(kfold, w_outer.shape[0]), jnp.asarray(w_outer)))


def _route(xb, feat, thr_bin, internal, left, right, depth):
    cur = np.zeros(xb.shape[0], np.int64)
    rows = np.arange(xb.shape[0])
    for _ in range(depth):
        nxt = np.where(xb[rows, feat[cur]] <= thr_bin[cur], left[cur], right[cur])
        cur = np.where(internal[cur] > 0, nxt, cur)
    return cur


def _chain_parts_only_at_ties(xb, y, w, f0, lr, act, bag_t, jt, tt, depth):
    """Walk one chain's refit trees in both packages ((T, N) arrays feat,
    thr_bin, internal, left, right, value) on the chain's own bins, tracking
    the port's fit; where they first part the state must sit at a near-tie.
    Returns whether they parted."""
    f = np.full(xb.shape[0], float(f0))
    for t in range(jt[0].shape[0]):
        a = [np.asarray(v[t]) for v in jt[:4]]
        b = [np.asarray(v[t]) for v in tt[:4]]
        gap = ttg.near_tie_gap(xb, y - f, bag_t(t) * w, b, a, nb=NB, min_leaf=GBM["min_leaf"])
        if gap is not None:
            assert gap <= 1e-5, (t, gap)
            return True
        f = f + lr * act[t] * np.asarray(tt[5][t])[_route(xb, *[np.asarray(v[t]) for v in tt[:5]], depth)]
    return False


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_shared_grower_and_assigned_predict_match_jax(dtype):
    """``grow_bestfirst_trees_shared`` (per-bin histograms, leaves from the
    final rows) on one table for K chains: the same node of every row and
    leaf values to 2e-6 (float32) / 1e-12 (float64) of their scale;
    ``assigned_predict_batched`` exactly the JAX package's."""
    rng, x, y = _data(seed=21)
    n, k = x.shape[0], 6
    edges = jtrees.make_bins(jnp.asarray(x, dtype), NB)
    xb = np.asarray(jtrees.bin_data(jnp.asarray(x, dtype), edges))
    ys = (np.tile(y, (k, 1)) + 0.3 * rng.standard_normal((k, n))).astype(dtype)
    ws = (rng.uniform(size=(k, n)) < 0.6).astype(dtype)
    jv, jc = jtrees.grow_bestfirst_trees_shared(jnp.asarray(xb), jnp.asarray(ys), jnp.asarray(ws), n_splits=4,
                                                 min_leaf=5.0, bin1h=jtrees.flat_bin_onehot(jnp.asarray(xb), NB))
    xbt = torch.as_tensor(xb).long()
    tv, tc = ttrees.grow_bestfirst_trees_shared(xbt, torch.as_tensor(ys), torch.as_tensor(ws), n_splits=4,
                                                min_leaf=5.0, bin1h=ttrees.flat_bin_onehot(xbt, NB))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    tol = 2e-6 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=tol * np.abs(np.asarray(jv)).max())
    want = np.asarray(jtrees.assigned_predict_batched(jv, jc, jv.shape[1]))
    np.testing.assert_array_equal(ttrees.assigned_predict_batched(torch.as_tensor(np.asarray(jv)), tc).numpy(), want)


# the JAX package's grower, one tree per chain on the chain's own table
_jax_grow = jax.jit(jax.vmap(lambda xb_c, e_c, r_c, w_c: jtrees.grow_bestfirst_tree(
    xb_c, e_c, r_c, w_c, n_splits=GBM["tree_complexity"], min_leaf=GBM["min_leaf"])))


def _curve_partings(x32, y, w_outer, selectors, shared, bags, lr, n_trees):
    """Replay a batched CV curve tree by tree: each chain's next tree grown
    by the port's plain K2 (on the chain's own table) and by the JAX
    package's ``grow_bestfirst_tree`` on the same table, residuals and bag,
    the port's fit carried on.  Where a chain's two trees first part, the
    state must sit at a near-tie.  Returns the outer chains one of whose
    inner chains parted within ``n_trees`` trees."""
    f_outer, n = y.shape
    k = GBM["n_folds"]
    train_w = (selectors[:, None, :] != np.arange(k)[None, :, None]) * w_outer[:, None, :]     # (F, K, n)
    tw = torch.as_tensor(train_w.reshape(f_outer * k, n), dtype=torch.float32)
    x_t = torch.as_tensor(x32)
    edges = ttrees.make_bins_masked(x_t, torch.as_tensor(w_outer) if shared else tw, NB)
    if shared:
        edges = edges.repeat_interleave(k, 0)
    xb = ttrees.bin_data(x_t, edges)                                                           # (C, n, p)
    yc = torch.as_tensor(np.repeat(y, k, 0), dtype=torch.float32)
    f = ((tw * yc).sum(1) / tw.sum(1).clamp_min(1.0))[:, None].expand(-1, n).contiguous()
    grow = _jax_grow
    first = {}
    for t in range(n_trees):
        bag = bags(t).reshape(f_outer * k, n) * tw
        out = ttg.gbm_tree_update_plain(xb.transpose(1, 2).contiguous(), None, yc, f, bag,
                                        n_splits=GBM["tree_complexity"], nb=NB, min_leaf=GBM["min_leaf"], lr=lr,
                                        emit_tree=True)
        r = (yc - f).numpy()
        jt = grow(jnp.asarray(xb.numpy()), jnp.asarray(edges.numpy()), jnp.asarray(r), jnp.asarray(bag.numpy()))
        for c in range(f_outer * k):
            if c in first:
                continue
            e = edges[c].numpy()
            feat = np.asarray(jt.feat[c])
            jthr = np.vectorize(lambda f_, v: np.searchsorted(e[f_], v))(feat, np.asarray(jt.thr[c]))
            a = [feat, jthr, np.asarray(jt.internal[c]), np.asarray(jt.left[c])]
            b = [v[c].numpy() for v in out[1:5]]
            gap = ttg.near_tie_gap(xb[c].numpy(), r[c], bag[c].numpy(), b, a, nb=NB, min_leaf=GBM["min_leaf"])
            if gap is not None:
                assert gap <= 1e-5, (c, t, gap)
                first[c] = t
        f = out[0]
    return {c // k for c in first}


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_cv_curve_multi_matches_jax(branch):
    """The batched CV curve with per-fold or shared bins: every chain's bin
    edges (to one rounding of the interpolation) and bins and the stopping
    checkpoints; trees that part only at near-ties, and the holdout
    deviances of outer chains whose trees never part to 1e-4 relative."""
    shared = BRANCHES[branch]
    rng, x, y = _data(seed=4)
    n = x.shape[0]
    x32, y32 = x.astype(np.float32), y.astype(np.float32)
    w_outer = np.stack([(rng.uniform(size=n) < 0.8) for _ in range(2)]).astype(np.float32)
    key = jax.random.PRNGKey(8)
    kw = dict(n_folds=GBM["n_folds"], n_splits=GBM["tree_complexity"], lr=GBM["learning_rate"],
              bag_fraction=GBM["bag_fraction"], min_leaf=GBM["min_leaf"], step_size=GBM["step_size"],
              max_trees=GBM["max_trees"], n_bins=NB, tolerance=np.full(2, 1e-3))
    kfold, kboost = jax.random.split(key)
    selectors = _selectors(kfold, w_outer, GBM["n_folds"])
    want = jgbm._cv_deviance_curve_multi(key, jnp.asarray(x32), jnp.asarray(y32), jnp.asarray(w_outer),
                                         selectors=selectors, shared_bins=shared, global_bins=False, **kw)
    got = tgbm._cv_deviance_curve_multi(torch.as_tensor(x32), torch.as_tensor(y32), torch.as_tensor(w_outer),
                                        selectors=selectors, global_bins=False, shared_bins=shared,
                                        bags=_curve_bags(kboost, shared, 2, n, GBM), **kw)
    assert got.edges.shape == want.edges.shape and got.xb.shape == want.xb.shape
    np.testing.assert_allclose(got.edges.numpy(), np.asarray(want.edges), rtol=1e-6, atol=0)
    np.testing.assert_array_equal(got.xb.numpy(), np.asarray(want.xb))
    j = int(got.stopped.max())
    parted = _curve_partings(x32, np.stack([y32, y32]), w_outer, selectors, shared,
                             _curve_bags(kboost, shared, 2, n, GBM), GBM["learning_rate"], j * GBM["step_size"])
    for fo in set(range(2)) - parted:
        assert got.stopped[fo] == int(want.stopped[fo])
        np.testing.assert_allclose(got.dev[:j, fo], np.asarray(want.dev, np.float64)[:j, fo], rtol=1e-4)


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_fit_outer_batched_bins_match_jax(branch):
    """``fit_outer_batched(global_bins=False)``: the same best trees per
    outer chain; each outer fold's refit, binned on its own training rows,
    grows the JAX package's trees but where they part at a near-tie, and
    the predictions of chains that never part agree to 1e-4 of the spread."""
    shared = BRANCHES[branch]
    rng, x, y = _data(seed=1)
    n = x.shape[0]
    x32 = x.astype(np.float32)
    w_outer = np.stack([(rng.uniform(size=n) < 0.8) for _ in range(2)]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jpred, jbest = jgbm.fit_outer_batched(key, jnp.asarray(x32), jnp.asarray(y, jnp.float32), jnp.asarray(w_outer),
                                         global_bins=False, shared_bins=shared, **GBM)
    kcv, kfinal = jax.random.split(jax.random.fold_in(key, 11))
    kfold, kboost = jax.random.split(jax.random.fold_in(kcv, 0))
    selectors = _selectors(kfold, w_outer, GBM["n_folds"])

    def bags(stage):
        if stage[0] == "curve":
            return _curve_bags(kboost, shared, 2, n, GBM)
        return _final_bags(jax.random.split(kfinal, 2), stage[1], n, GBM["bag_fraction"])

    tpred, tbest = tgbm.fit_outer_batched(torch.as_tensor(x32), torch.as_tensor(y, dtype=torch.float32),
                                         torch.as_tensor(w_outer), global_bins=False, shared_bins=shared,
                                         selectors=selectors, bags=bags, **GBM)
    np.testing.assert_array_equal(tbest, np.asarray(jbest))
    # the refits again, with their trees: the JAX package's vmapped brt.fit
    # on each outer fold's own bins, the port's K2 chains on the same tables
    budget = int(-(-tbest.max() // GBM["step_size"]) * GBM["step_size"])
    y2 = np.stack([y, y]).astype(np.float32)
    edges_f = jax.vmap(lambda wf: jtrees.make_bins_masked(jnp.asarray(x32), wf, NB))(jnp.asarray(w_outer))
    xb_f = jax.vmap(lambda e: jtrees.bin_data(jnp.asarray(x32), e))(edges_f)
    fit_one = lambda k, yf, w, nt, e, xbk: jbrt.fit(
        k, jnp.asarray(x32), yf, sample_weight=w, n_trees=budget, n_splits=GBM["tree_complexity"],
        lr=GBM["learning_rate"], bag_fraction=GBM["bag_fraction"], min_leaf=GBM["min_leaf"], n_bins=NB,
        n_trees_active=nt, edges=e, xb=xbk)
    jst = jax.jit(jax.vmap(fit_one))(jax.random.split(kfinal, 2), jnp.asarray(y2), jnp.asarray(w_outer),
                                     jnp.asarray(jbest), edges_f, xb_f)
    np.testing.assert_array_equal(np.asarray(jst.train_fit), np.asarray(jpred))
    final_bags = bags(("final", budget))
    tr = tgbm._final_fits(torch.as_tensor(x32), torch.as_tensor(y2), tbest, budget=budget,
                          n_splits=GBM["tree_complexity"], lr_vec=np.full(2, GBM["learning_rate"]),
                          bag_fraction=GBM["bag_fraction"], min_leaf=GBM["min_leaf"], n_bins=NB,
                          sample_w=torch.as_tensor(w_outer), own_bins=True, emit_trees=True, bags=final_bags)
    np.testing.assert_array_equal(tr["train_fit"].numpy(), tpred.numpy())
    np.testing.assert_allclose(tr["edges"].numpy(), np.asarray(edges_f), rtol=1e-6, atol=0)
    for c in range(2):
        e = np.asarray(edges_f[c])
        xb = np.asarray(xb_f[c])
        feat = np.asarray(jst.trees.feat[c])
        jthr = np.vectorize(lambda f_, v: np.searchsorted(e[f_], v))(feat, np.asarray(jst.trees.thr[c]))
        jt = [feat, jthr, np.asarray(jst.trees.internal[c]), np.asarray(jst.trees.left[c]),
              np.asarray(jst.trees.right[c]), np.asarray(jst.trees.value[c])]
        tt = [tr[k][:, c].numpy() for k in ("feat", "thr_bin", "internal", "left", "right", "value")]
        parted = _chain_parts_only_at_ties(
            xb, y2[c], w_outer[c], float(tr["f0"][c]), GBM["learning_rate"], tr["tree_active"][c].numpy(),
            lambda t: final_bags(t).numpy()[c], jt, tt, GBM["tree_complexity"])
        if not parted:
            np.testing.assert_allclose(tpred[c].numpy(), np.asarray(jpred)[c], rtol=0, atol=1e-4 * np.ptp(y))


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_fit_multi_bins_match_jax(branch):
    """``fit_multi(global_bins=False)`` on two responses, one noise with a
    rate that restarts it at lr/2: the same restarts, rates, stopping
    checkpoints and best trees per response; the trees of each response's
    last curve part only at near-ties, and where none parts its CV curve
    agrees to 1e-4 relative; the refits (one full-data table: every row
    trains) part only at near-ties, and the fits of responses whose trees
    never part agree to 1e-4 of the spread."""
    from test_torch_brt import _refits_part_only_at_ties

    shared = BRANCHES[branch]
    rng, x, y = _data(seed=2)
    n = x.shape[0]
    ycols = np.stack([y, rng.standard_normal(n)], 1).astype(np.float32)
    x32 = x.astype(np.float32)
    kw = dict(GBM, max_restarts=1)
    keys = jnp.stack([jax.random.PRNGKey(5), jax.random.PRNGKey(6)])
    jres = jgbm.fit_multi(keys, jnp.asarray(x32), jnp.asarray(ycols), global_bins=False, shared_bins=shared, **kw)
    split = [jax.random.split(jax.random.fold_in(keys[j], 7), 3) for j in range(2)]
    selectors = np.stack([jgbm._make_selector(split[j][0], ycols[:, j], np.ones(n), kw["n_folds"]) for j in range(2)])
    last_curve = {}

    def bags(stage):
        if stage[0] == "curve":
            group, restarts = stage[1], stage[2]
            for gi, j in enumerate(group):
                last_curve[j] = (group, restarts, gi)
            kcv = jax.random.fold_in(split[group[0]][1], restarts)
            return _curve_bags(jax.random.split(kcv)[1], shared, len(group), n, kw)
        return _final_bags(jnp.stack([s[2] for s in split]), stage[1], n, kw["bag_fraction"])

    tres = tgbm.fit_multi(torch.as_tensor(x32), torch.as_tensor(ycols), global_bins=False, shared_bins=shared,
                          selectors=selectors, bags=bags, **kw)
    assert sum(r.restarts for r in jres) >= 1
    for j, (a, b) in enumerate(zip(jres, tres)):
        assert (b.restarts, b.learning_rate, b.best_trees, b.trees_fitted) == (
            a.restarts, a.learning_rate, a.best_trees, a.trees_fitted)
        group, restarts, gi = last_curve[j]
        kcv = jax.random.fold_in(split[group[0]][1], restarts)
        yg = ycols.T[list(group)]
        parted = _curve_partings(x32, yg, np.ones_like(yg), selectors[list(group)], shared,
                                 _curve_bags(jax.random.split(kcv)[1], shared, len(group), n, kw),
                                 b.learning_rate, b.trees_fitted)
        if gi not in parted:
            jj = a.trees_fitted // kw["step_size"]
            np.testing.assert_allclose(b.cv_deviance.numpy()[:jj], np.asarray(a.cv_deviance)[:jj], rtol=1e-4)
    edges = tres[0].final.edges.numpy()
    xb = ttrees.bin_data(torch.as_tensor(x32), torch.as_tensor(edges)).numpy()

    def stacked(res):
        out = {k: np.stack([np.asarray(getattr(r.final.trees, k)) for r in res], 1)
               for k in ("feat", "internal", "left", "right", "value")}
        thr = np.stack([np.asarray(r.final.trees.thr) for r in res], 1)
        out["thr_bin"] = np.vectorize(lambda f_, v: np.searchsorted(edges[f_], v))(out["feat"], thr)
        return out

    act = np.stack([np.asarray(r.final.tree_active) for r in tres])
    budget = tres[0].final.tree_active.shape[0]
    parted = _refits_part_only_at_ties(
        xb, ycols.T, np.ones_like(ycols.T), [float(r.final.f0) for r in tres], [r.learning_rate for r in tres],
        act, bags(("final", budget)), stacked(jres), stacked(tres), GBM["tree_complexity"])
    for j, (a, b) in enumerate(zip(jres, tres)):
        if j not in parted:
            np.testing.assert_allclose(b.final.train_fit.numpy(), np.asarray(a.final.train_fit), rtol=0,
                                       atol=1e-4 * np.ptp(ycols[:, j]))
