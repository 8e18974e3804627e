"""Parity of the PyTorch port's BRT slice with the JAX package, on the CPU:
the plain version of kernel K2 (tree grower), the leaf bin-interval tables
and the plain version of kernel K3 (forest predictor), the batched gbm.step
functions, and ``mltps`` over the BRT pool.

Shapes are tiny (n <= 200, p <= 3, nb <= 16 for the kernels and gbm.step).
The gbm.step functions are given the JAX package's own fold selectors and threefry bag
draws, rebuilt here from its key chains, so both packages grow the same
chains.  Chains are float32 on both sides (K2 is float32).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import machisplin_tpu as mt
import machisplin_tpu_torch as mtt
from machisplin_tpu.ensemble import CVConfig as JCVConfig
from machisplin_tpu.models import brt as jbrt, gbm_step as jgbm, trees as jtrees
from machisplin_tpu.ops import pallas_forest as jforest
from machisplin_tpu.ops.pallas_grow import gbm_tree_update_ref
from machisplin_tpu.pipeline.mltps import MLTPSConfig as JConfig
from machisplin_tpu_torch import convert
from machisplin_tpu_torch.ensemble.cv import CVConfig as TCVConfig
from machisplin_tpu_torch.models import brt as tbrt, gbm_step as tgbm, trees as ttrees
from machisplin_tpu_torch.ops import forest as tforest, tree_grow as ttg
from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig as TConfig
from test_torch_forest_tables import outcome_mirror
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

NB = 16


def _data(seed=0, n=150, p=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, p))
    y = 2.0 * x[:, 0] + np.sin(4 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    return rng, x, y


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_bins_match_jax(dtype):
    """Edges agree to one float64 rounding (XLA fuses the interpolation's
    multiply-add, torch does not); the bins they give are identical."""
    _, x, _ = _data()
    x = x.astype(dtype)
    want = np.asarray(jtrees.make_bins(jnp.asarray(x), NB))
    got = ttrees.make_bins(torch.as_tensor(x), NB).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-16 if dtype == "float64" else 0, atol=0)
    np.testing.assert_array_equal(
        ttrees.bin_data(torch.as_tensor(x), torch.as_tensor(want)).numpy(),
        np.asarray(jtrees.bin_data(jnp.asarray(x), jnp.asarray(want))),
    )


@pytest.mark.parametrize("emit", [False, True], ids=["update", "emit_tree"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k2_plain_matches_jax_ref(dtype, emit):
    """The K2 plain version against ``gbm_tree_update_ref``: the same trees
    (identical feat/thr_bin/internal/left/right); f, leaf values and gains
    to 2e-6 relative in float32 (summation order) and 1e-12 in float64."""
    rng, x, y = _data()
    n, c = x.shape[0], 5
    edges = jtrees.make_bins(jnp.asarray(x, dtype), NB)
    xb = np.asarray(jtrees.bin_data(jnp.asarray(x, dtype), edges))
    ys = np.tile(y, (c, 1)).astype(dtype)
    fs = (0.3 * rng.standard_normal((c, n))).astype(dtype)
    ws = (rng.uniform(size=(c, n)) < 0.7).astype(dtype)
    kw = dict(n_splits=4, nb=NB, min_leaf=5.0, lr=0.1, emit_tree=emit)
    want = jax.jit(functools.partial(gbm_tree_update_ref, **kw))(
        jnp.asarray(xb.T, dtype), jtrees.flat_bin_cum_onehot(jnp.asarray(xb), NB),
        jnp.asarray(ys), jnp.asarray(fs), jnp.asarray(ws),
    )
    got = ttg.gbm_tree_update_plain(
        torch.as_tensor(xb.T.copy()), None, torch.as_tensor(ys), torch.as_tensor(fs), torch.as_tensor(ws), **kw,
    )
    want = [np.asarray(want)] if not emit else [np.asarray(a) for a in want]
    got = [got.numpy()] if not emit else [a.numpy() for a in got]
    rtol = 2e-6 if dtype == "float32" else 1e-12
    for k, (a, b) in enumerate(zip(want, got)):
        if k in (1, 2, 3, 4, 5):      # feat, thr_bin, internal, left, right
            np.testing.assert_array_equal(b, a)
        else:                          # f, value, var_gain
            np.testing.assert_allclose(b, a, rtol=0, atol=rtol * max(np.abs(a).max(), 1.0))


def test_k2_wrapper_takes_float32_only():
    x = torch.zeros((2, 10), dtype=torch.float64)
    with pytest.raises(TypeError):
        ttg.gbm_tree_update(torch.zeros((3, 10)), None, x, x, x, n_splits=2, nb=4, min_leaf=1.0, lr=0.1)


def test_prepare_bins_gives_the_plain_version_its_table():
    xb = torch.as_tensor(np.random.default_rng(3).integers(0, 4, (10, 2)))
    tables = ttg.prepare_bins(xb, 4)
    assert torch.equal(tables.xbt, xb.T)
    assert torch.equal(tables.cum1h, ttrees.flat_bin_cum_onehot(xb, 4))


def _outer_bags(key, f_outer, n_folds, n, bag_fraction):
    """The JAX package's CV-curve bag stream (``_cycle_program``'s
    global-bins branch): cycle keys split off ``key``, then per tree
    split(key_t, F) and a (K, n) uniform draw per outer chain."""
    cache, state = {}, {"key": key}

    def bags(t, step):
        cyc = t // step
        while cyc not in cache:
            state["key"], key_c = jax.random.split(state["key"])
            cache[len(cache)] = jax.random.split(key_c, step)
        kf = jax.random.split(cache[cyc][t % step], f_outer)
        u = jax.vmap(lambda k: jax.random.uniform(k, (n_folds, n)))(kf)
        return torch.as_tensor(np.asarray(u < bag_fraction, np.float32))

    return bags


def _final_bags(keys, budget, n, bag_fraction):
    """The JAX package's refit bag stream: split(chain key, budget)."""
    keys_ct = jax.vmap(lambda k: jax.random.split(k, budget))(keys)

    def bags(t):
        u = jax.vmap(lambda kk: jax.random.uniform(kk, (n,)))(keys_ct[:, t])
        return torch.as_tensor(np.asarray(u < bag_fraction, np.float32))

    return bags


def _route_bins(xb, tree, depth):
    """Node of every row in one emitted tree (feat, thr_bin, internal, left,
    right), routing by bins."""
    feat, thr, internal, left, right = tree
    rows = np.arange(xb.shape[0])
    cur = np.zeros(xb.shape[0], np.int64)
    for _ in range(depth):
        nxt = np.where(xb[rows, feat[cur]] <= thr[cur], left[cur], right[cur])
        cur = np.where(internal[cur] > 0, nxt, cur)
    return cur


def _refits_part_only_at_ties(xb, y, w, f0, lr, act, bags, jt, tt, n_splits):
    """Walk both packages' refit forests tree by tree ((budget, C, N) arrays
    feat/thr_bin/internal/left/right/value); where a chain's trees first
    part, its state (rebuilt from the port's trees) must sit at a near-tie:
    relative gain gap <= 1e-5 (float32 sums in another order, or right-child
    stats taken as parent - left, break exact ties either way).  Returns the
    chains whose trees parted."""
    names = ("feat", "thr_bin", "internal", "left", "right")
    parted = []
    for c in range(y.shape[0]):
        f = np.full(xb.shape[0], float(f0[c]))
        for t in range(jt["feat"].shape[0]):
            a = [np.asarray(jt[k][t, c]) for k in names]
            b = [np.asarray(tt[k][t, c]) for k in names]
            gap = ttg.near_tie_gap(xb, y[c] - f, np.asarray(bags(t))[c] * w[c], b[:4], a[:4],
                                   nb=NB, min_leaf=GBM["min_leaf"])
            if gap is not None:
                assert gap <= 1e-5, (c, t, gap)
                parted.append(c)
                break
            f = f + lr[c] * act[c, t] * np.asarray(tt["value"][t, c])[_route_bins(xb, b, n_splits)]
    return parted


# shared by both gbm.step tests, so the JAX package compiles one curve program
GBM = dict(tree_complexity=2, learning_rate=0.8, bag_fraction=0.5, n_folds=3, step_size=2,
           max_trees=60, n_bins=NB, min_leaf=5.0)


def test_fit_outer_batched_matches_jax():
    """The CV path: same best_trees per outer chain; the refits' trees the
    same but where they part at a near-tie, and the predictions of chains
    whose trees never part to 1e-4 of the response's spread."""
    rng, x, y = _data(seed=1)
    n = x.shape[0]
    x32 = x.astype(np.float32)
    w_outer = np.stack([(rng.uniform(size=n) < 0.8) for _ in range(2)]).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jpred, jbest = jgbm.fit_outer_batched(key, jnp.asarray(x32), jnp.asarray(y, jnp.float32),
                                         jnp.asarray(w_outer), **GBM)

    kcv, kfinal = jax.random.split(jax.random.fold_in(key, 11))
    kfold, kboost = jax.random.split(jax.random.fold_in(kcv, 0))

    def selector_for(kf, w):
        order = jnp.argsort(jax.random.uniform(kf, (n,)) + (w <= 0) * 10.0)
        seq = (jnp.arange(n) % GBM["n_folds"]).astype(jnp.int32)
        return jnp.zeros((n,), jnp.int32).at[order].set(seq)

    selectors = np.asarray(jax.vmap(selector_for)(jax.random.split(kfold, 2), jnp.asarray(w_outer)))
    curve_bags = _outer_bags(kboost, 2, GBM["n_folds"], n, GBM["bag_fraction"])

    def bags(stage):
        if stage[0] == "curve":
            return lambda t: curve_bags(t, GBM["step_size"])
        return _final_bags(jax.random.split(kfinal, 2), stage[1], n, GBM["bag_fraction"])

    tpred, tbest = tgbm.fit_outer_batched(torch.as_tensor(x32), torch.as_tensor(y, dtype=torch.float32),
                                         torch.as_tensor(w_outer), selectors=selectors, bags=bags, **GBM)
    np.testing.assert_array_equal(tbest, np.asarray(jbest))
    # the same refits again, with their trees
    budget = int(-(-tbest.max() // GBM["step_size"]) * GBM["step_size"])
    kw = dict(budget=budget, n_splits=GBM["tree_complexity"], lr_vec=np.full(2, GBM["learning_rate"]),
              bag_fraction=GBM["bag_fraction"], min_leaf=GBM["min_leaf"], n_bins=NB, emit_trees=True)
    y2 = np.stack([y, y]).astype(np.float32)
    jr = jgbm._final_fits_global(jax.random.split(kfinal, 2), jnp.asarray(x32), jnp.asarray(y2), jnp.asarray(jbest),
                                 sample_w=jnp.asarray(w_outer), **kw)
    tr = tgbm._final_fits(torch.as_tensor(x32), torch.as_tensor(y2), tbest, sample_w=torch.as_tensor(w_outer),
                                 bags=bags(("final", budget)), **kw)
    np.testing.assert_array_equal(np.asarray(jr["train_fit"]), np.asarray(jpred))
    np.testing.assert_array_equal(tr["train_fit"].numpy(), tpred.numpy())
    xb = ttrees.bin_data(torch.as_tensor(x32), tr["edges"]).numpy()
    parted = _refits_part_only_at_ties(
        xb, y2, w_outer, tr["f0"].numpy(), kw["lr_vec"], tr["tree_active"].numpy(), bags(("final", budget)),
        {k: np.asarray(v) for k, v in jr.items()}, {k: v.numpy() for k, v in tr.items()}, GBM["tree_complexity"],
    )
    for c in set(range(2)) - set(parted):
        np.testing.assert_allclose(tpred[c].numpy(), np.asarray(jpred)[c], rtol=0, atol=1e-4 * np.ptp(y))


@pytest.fixture(scope="module")
def multi_runs():
    """fit_multi in both packages on two responses, one of them noise, with
    a learning rate high enough that the noise response restarts at lr/2."""
    rng, x, y = _data(seed=2)
    n = x.shape[0]
    ycols = np.stack([y, rng.standard_normal(n)], 1).astype(np.float32)
    x32 = x.astype(np.float32)
    kw = dict(GBM, max_restarts=1)
    keys = jnp.stack([jax.random.PRNGKey(5), jax.random.PRNGKey(6)])
    jres = jgbm.fit_multi(keys, jnp.asarray(x32), jnp.asarray(ycols), **kw)

    split = [jax.random.split(jax.random.fold_in(keys[j], 7), 3) for j in range(2)]
    selectors = np.stack([jgbm._make_selector(split[j][0], ycols[:, j], np.ones(n), kw["n_folds"]) for j in range(2)])

    def bags(stage):
        if stage[0] == "curve":
            group, restarts = stage[1], stage[2]
            kcv = jax.random.fold_in(split[group[0]][1], restarts)
            cb = _outer_bags(jax.random.split(kcv)[1], len(group), kw["n_folds"], n, kw["bag_fraction"])
            return lambda t: cb(t, kw["step_size"])
        return _final_bags(jnp.stack([s[2] for s in split]), stage[1], n, kw["bag_fraction"])

    tres = tgbm.fit_multi(torch.as_tensor(x32), torch.as_tensor(ycols), selectors=selectors, bags=bags, **kw)
    budget = jres[0].final.tree_active.shape[0]
    return x32, ycols, jres, tres, bags(("final", budget))


def test_fit_multi_matches_jax(multi_runs):
    """Same restarts, learning rates, stopping checkpoints and best_trees per
    response; the refits' trees the same but where they part at a near-tie;
    fits and predictions of responses whose trees never part to 1e-4 of the
    response's spread.  (The CV curves are not compared point by point: a
    fold tree that parts at a near-tie moves every later checkpoint.)"""
    x32, ycols, jres, tres, final_bags = multi_runs
    assert sum(r.restarts for r in jres) >= 1            # the restart rule ran
    for j, (a, b) in enumerate(zip(jres, tres)):
        assert (b.restarts, b.learning_rate, b.best_trees, b.trees_fitted) == (
            a.restarts, a.learning_rate, a.best_trees, a.trees_fitted)
        np.testing.assert_array_equal(b.selector, a.selector)
        assert list(tgbm.importance(b, ["a", "b", "c"])) == list(jgbm.importance(a, ["a", "b", "c"]))
    edges = tres[0].final.edges.numpy()
    xb = ttrees.bin_data(torch.as_tensor(x32), torch.as_tensor(edges)).numpy()

    def stacked(res):
        out = {}
        for k in ("feat", "internal", "left", "right", "value"):
            out[k] = np.stack([np.asarray(getattr(r.final.trees, k)) for r in res], 1)   # (budget, R, N)
        thr = np.stack([np.asarray(r.final.trees.thr) for r in res], 1)
        out["thr_bin"] = np.vectorize(lambda f, v: np.searchsorted(edges[f], v))(out["feat"], thr)
        return out

    act = np.stack([np.asarray(r.final.tree_active) for r in tres])
    parted = _refits_part_only_at_ties(
        xb, ycols.T, np.ones_like(ycols.T), [float(r.final.f0) for r in tres],
        [r.learning_rate for r in tres], act, final_bags, stacked(jres), stacked(tres),
        GBM["tree_complexity"],
    )
    for j, (a, b) in enumerate(zip(jres, tres)):
        if j in parted:
            continue
        tol = 1e-4 * np.ptp(ycols[:, j])
        np.testing.assert_allclose(b.final.train_fit.numpy(), np.asarray(a.final.train_fit), rtol=0, atol=tol)
        want = np.asarray(jgbm.predict(a, jnp.asarray(x32)))
        np.testing.assert_allclose(tgbm.predict(b, torch.as_tensor(x32)).numpy(), want, rtol=0, atol=tol)
        # the JAX result carried across predicts the same through the port
        carried = convert.gbm_result_from_numpy(a, device="cpu")
        np.testing.assert_allclose(tgbm.predict(carried, torch.as_tensor(x32)).numpy(), want, rtol=0, atol=tol)


def _jax_state(multi_runs, j=0):
    jres = multi_runs[2]
    return jax.tree_util.tree_map(np.asarray, jres[j].final)


def test_build_leaf_bins_matches_jax(multi_runs):
    """The copied table walk gives identical tables for a JAX-grown forest."""
    st = _jax_state(multi_runs)
    want = jforest.build_leaf_bins(st.trees, n_feat=3)
    got = tforest.build_leaf_bins(convert.tree_from_numpy(st.trees, device="cpu"), n_feat=3)
    for name in ("etab", "lo", "hi", "leaf_tree", "leaf_node", "drop_node"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert (got.n_feat, got.n_bins) == (want.n_feat, want.n_bins)


@pytest.mark.parametrize("n_cols", [None, 2], ids=["weights_T", "weights_TR"])
def test_forest_predict_bins_matches_jax(multi_runs, n_cols):
    """The K3 plain version against the JAX package's plain ``_predict_impl``
    and against routing points through the trees, for a JAX BRTState carried
    across by ``convert``, with (T,) and (T, R) weights; 1e-5 of sum |w v|."""
    st = _jax_state(multi_runs)
    rng = np.random.default_rng(7)
    q = rng.uniform(-0.1, 1.1, (300, 3)).astype(np.float32)
    w = np.asarray(st.tree_active) * np.asarray(st.lr)
    if n_cols:
        w = np.stack([w, rng.uniform(size=w.shape[0]) * w], 1).astype(np.float32)
    want = np.asarray(jforest.forest_predict_bins(st.trees, jnp.asarray(q), jnp.asarray(w), use_pallas=False))
    tstate = convert.brt_state_from_numpy(st, device="cpu")
    got = tforest.forest_predict_bins(tstate.trees, torch.as_tensor(q), torch.as_tensor(w)).numpy()
    scale = float(np.abs(w).sum(0).max() * np.abs(np.asarray(st.trees.value)).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * scale)
    routed = np.stack([
        ttrees.forest_predict(tstate.trees, torch.as_tensor(q), 2, weights=torch.as_tensor(wc)).numpy()
        for wc in (w.T if n_cols else [w])
    ], 1)
    np.testing.assert_allclose(got.reshape(routed.shape), routed, rtol=0, atol=1e-5 * scale)
    if not n_cols:
        jpred = np.asarray(jbrt.predict(st, jnp.asarray(q)))
        np.testing.assert_allclose(tbrt.predict(tstate, torch.as_tensor(q)).numpy(), jpred, rtol=0,
                                   atol=1e-5 * scale)


@pytest.mark.parametrize("n_cols", [None, 2], ids=["weights_T", "weights_TR"])
def test_outcome_tables_match_jax(multi_runs, n_cols):
    """K3's evaluation through outcome tables (the kernel's arithmetic,
    mirrored in torch by ``outcome_mirror``) on a JAX-grown forest against
    the JAX package's plain ``forest_predict_bins``; 1e-5 of sum |w v|."""
    st = _jax_state(multi_runs)
    rng = np.random.default_rng(8)
    q = rng.uniform(-0.1, 1.1, (2000, 3)).astype(np.float32)
    w = np.asarray(st.tree_active) * np.asarray(st.lr)
    if n_cols:
        w = np.stack([w, rng.uniform(size=w.shape[0]) * w], 1).astype(np.float32)
    want = np.asarray(jforest.forest_predict_bins(st.trees, jnp.asarray(q), jnp.asarray(w), use_pallas=False))
    trees = convert.brt_state_from_numpy(st, device="cpu").trees
    ft = tforest.prepare_forest(trees, torch.as_tensor(w), tforest.build_leaf_bins(trees, n_feat=3), "cpu")
    assert ft.desc.shape[0] == trees.feat.shape[0] and ft.loop_slot.numel() == 0
    got = (outcome_mirror(ft, torch.as_tensor(q)) + ft.offset).numpy()
    scale = float(np.abs(w).sum(0).max() * np.abs(np.asarray(st.trees.value)).max())
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=0, atol=1e-5 * scale)


def test_predict_prepared_never_moves_cells():
    """Cells on another device than the tables raise; they are not copied
    to the tables' device (``meta`` stands in for a card here)."""
    _, x, _ = _data(n=20)
    tree = ttrees.Tree(feat=torch.zeros((1, 3), dtype=torch.long), thr=torch.tensor([[0.5, 0.0, 0.0]]),
                       internal=torch.tensor([[1.0, 0.0, 0.0]]), left=torch.tensor([[1, 0, 0]]),
                       right=torch.tensor([[2, 0, 0]]), value=torch.tensor([[0.0, -1.0, 1.0]]),
                       var_gain=torch.zeros((1, 3)))
    ft = tforest.prepare_forest(tree, torch.ones(1), tforest.build_leaf_bins(tree, n_feat=3), "cpu")
    xt = torch.as_tensor(x, dtype=torch.float32)
    np.testing.assert_array_equal(tforest.predict_prepared(ft, xt).numpy(), np.where(x[:, 0] <= 0.5, -1.0, 1.0))
    with pytest.raises(ValueError, match="tables on cpu"):
        tforest.predict_prepared(ft, xt.to("meta"))


FAST_BRT = dict(tree_complexity=2, learning_rate=0.1, bag_fraction=0.5, n_folds=3, step_size=10,
                max_trees=60, n_bins=NB)


@pytest.fixture(scope="module")
def mltps_runs():
    """mltps over the BRT pool in both packages at downsample 48 (one TPS
    tile), with the JAX package's CV folds and a shrunken BRT config."""
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    data = cov.data.numpy()
    sampling = mtt.load_sampling()
    jcfg = JConfig(letters_pool="b", cv=JCVConfig(n_folds=3, brt=FAST_BRT), final_brt=FAST_BRT)
    jgrid = mt.GridSpec(**cov.grid.__dict__)
    jres = mt.mltps(sampling, mt.Raster(jnp.asarray(data), jgrid, cov.names), tps=True, config=jcfg)
    n = len(jres[0].residuals)
    from machisplin_tpu.ensemble.kfold import kfold as jax_kfold

    kf = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 777), 5)[0]
    folds = np.stack([np.asarray(jax_kfold(jax.random.fold_in(kf, r), n, 3)) for r in range(2)])
    tcfg = TConfig(letters_pool="b", cv=TCVConfig(n_folds=3, brt=FAST_BRT), final_brt=FAST_BRT)
    tres = mtt.mltps(sampling, mtt.Raster(torch.as_tensor(data), cov.grid, cov.names), tps=True, config=tcfg,
                     folds=folds, generator=torch.Generator().manual_seed(0), device="cpu")
    return jres, tres


# The port's bag draws come from torch, the JAX package's from threefry: the
# r² of the two runs differ by what the bags alone move.  Over PRNG keys 0-2
# the JAX package's own r² at this configuration spans up to 0.0062 (bio_12
# r² ensemble 0.7285-0.7347); the band is about three times that.
R2_BAND = 0.02


def test_mltps_b_matches_jax(mltps_runs):
    jres, tres = mltps_runs
    assert [r.name for r in tres] == [r.name for r in jres] == ["bio_1", "bio_12"]
    for j, t in zip(jres, tres):
        assert t.summary["best model(s):"] == j.summary["best model(s):"] == "b"
        assert list(t.var_imp) == list(j.var_imp) == ["brt"]
        for key in ("r2 ensemble:", "r2 final:"):
            assert abs(t.summary[key] - j.summary[key]) <= R2_BAND, (t.name, key)
        for attr in ("final", "ensemble", "tps_surface"):
            got = getattr(t, attr).data.numpy()
            assert got.shape == np.asarray(getattr(j, attr).data).shape and np.isfinite(got).all(), attr


def test_mltps_b_tps_kept_only_if_r2_improves(mltps_runs):
    _, tres = mltps_runs
    for t in tres:
        improved = t.summary["r2 final:"] > t.summary["r2 ensemble:"]
        want = t.ensemble.data + t.tps_surface.data if improved else t.ensemble.data
        np.testing.assert_array_equal(t.final.data.numpy(), want.numpy())


def test_mltps_trouble_keeps_brt_only():
    """trouble=True: every response keeps "b" at weight 1 in both packages,
    whatever the weight search over "bg" finds."""
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    data = cov.data.numpy()
    sampling = mtt.load_sampling()
    jcfg = JConfig(letters_pool="bg", cv=JCVConfig(n_folds=3, brt=FAST_BRT), final_brt=FAST_BRT)
    jres = mt.mltps(sampling, mt.Raster(jnp.asarray(data), mt.GridSpec(**cov.grid.__dict__), cov.names),
                    tps=False, trouble=True, config=jcfg)
    tcfg = TConfig(letters_pool="bg", cv=TCVConfig(n_folds=3, brt=FAST_BRT), final_brt=FAST_BRT)
    tres = mtt.mltps(sampling, mtt.Raster(torch.as_tensor(data), cov.grid, cov.names), tps=False, trouble=True,
                     config=tcfg, generator=torch.Generator().manual_seed(0), device="cpu")
    for j, t in zip(jres, tres):
        assert t.summary["best model(s):"] == j.summary["best model(s):"] == "b"
        assert list(t.var_imp) == list(j.var_imp) == ["brt"]
        np.testing.assert_allclose(t.summary["r2 ensemble:"], j.summary["r2 ensemble:"], atol=R2_BAND)


def test_single_response_brt_raises():
    """A single response that keeps "b" used to raise; its final fit is now
    the serial gbm.step (``gbm_step.fit``), as in the JAX package.  Both
    packages' mltps over "b" for bio_1 alone at downsample 48, with the JAX
    package's CV folds: "b" kept, r² within R2_BAND, finite surfaces."""
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    data = cov.data.numpy()
    s = mtt.load_sampling()
    one = np.rec.fromarrays([s["long"], s["lat"], s["bio_1"]], names="long,lat,bio_1")
    jcfg = JConfig(letters_pool="b", cv=JCVConfig(n_folds=3, brt=FAST_BRT), final_brt=FAST_BRT)
    jres = mt.mltps(one, mt.Raster(jnp.asarray(data), mt.GridSpec(**cov.grid.__dict__), cov.names), tps=True,
                    config=jcfg)
    n = len(jres[0].residuals)
    from machisplin_tpu.ensemble.kfold import kfold as jax_kfold

    kf = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(0), 777), 5)[0]
    folds = np.asarray(jax_kfold(jax.random.fold_in(kf, 0), n, 3))[None]
    cfg = TConfig(letters_pool="b", cv=TCVConfig(n_folds=3, brt=FAST_BRT), final_brt=FAST_BRT)
    tres = mtt.mltps(one, mtt.Raster(torch.as_tensor(data), cov.grid, cov.names), tps=True, config=cfg, folds=folds,
                     generator=torch.Generator().manual_seed(0), device="cpu")
    assert [r.name for r in tres] == [r.name for r in jres] == ["bio_1"]
    t, j = tres[0], jres[0]
    assert t.summary["best model(s):"] == j.summary["best model(s):"] == "b"
    assert list(t.var_imp) == list(j.var_imp) == ["brt"]
    for key in ("r2 ensemble:", "r2 final:"):
        assert abs(t.summary[key] - j.summary[key]) <= R2_BAND, key
    for attr in ("final", "ensemble", "tps_surface"):
        got = getattr(t, attr).data.numpy()
        assert got.shape == np.asarray(getattr(j, attr).data).shape and np.isfinite(got).all(), attr
