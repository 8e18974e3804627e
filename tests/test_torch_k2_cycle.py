"""What surrounds kernel K2's cycle launch, on the CPU: the sorted-row and
bin-offset tables of ``prepare_bins`` against their definition, the plain
cycle against one-tree updates, ``cycle_agreement`` (which holds the
kernel's cycles to the plain version on the card), the wrappers' guards, and
the gbm.step drivers through ``gbm_tree_cycle`` bit-identical to the
per-tree loops they replace (written out here as the reference), with the
bags injected.

Shapes are tiny (n <= 120, p <= 3, nb <= 16).
"""
import numpy as np
import pytest
import torch

from machisplin_tpu_torch.models import gbm_step as tgbm, trees as ttrees
from machisplin_tpu_torch.ops import tree_grow as ttg
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

NB = 16


def _tables_by_definition(xb, nb):
    """Each feature's rows sorted by bin (ties by row index) and bin b's
    first position in that order, by numpy."""
    order = np.stack([np.argsort(col, kind="stable") for col in xb.T])
    offsets = np.stack([np.searchsorted(np.sort(col), np.arange(nb + 1), side="left") for col in xb.T])
    return order, offsets


def _tied_bins(seed=0, n=120):
    """Bins from data with heavy ties (so some bins hold many rows and
    others none), one feature of distinct values, and one constant."""
    rng = np.random.default_rng(seed)
    x = np.stack([
        rng.integers(0, 4, n).astype(np.float64),     # four distinct values: most bins empty
        rng.uniform(0, 1, n),                         # distinct values
        np.full(n, 0.5),                              # one value: every row in bin 0
    ], 1)
    xt = torch.as_tensor(x)
    return ttrees.bin_data(xt, ttrees.make_bins(xt, NB))


@pytest.mark.parametrize("case", ["ties", "uniform", "skewed"])
def test_prepare_bins_tables_match_definition(case):
    rng = np.random.default_rng(1)
    if case == "ties":
        xb = _tied_bins()
    elif case == "uniform":
        xb = torch.as_tensor(rng.integers(0, NB, (97, 3)))
    else:                                             # two bins hold nearly every row
        xb = torch.as_tensor(np.where(rng.uniform(size=(97, 2)) < 0.9, 3, rng.integers(0, NB, (97, 2))))
    tables = ttg.prepare_bins(xb, NB)
    want_order, want_off = _tables_by_definition(xb.numpy(), NB)
    assert tables.order.dtype == torch.int16 and tables.offsets.dtype == torch.int32
    np.testing.assert_array_equal(tables.order.numpy(), want_order)
    np.testing.assert_array_equal(tables.offsets.numpy(), want_off)
    seg = np.diff(tables.offsets.numpy(), axis=1)
    if case == "ties":
        assert (seg == 0).any() and seg.max() >= 30   # empty bins and long segments both present
        assert seg[2, 0] == xb.shape[0]
    # every bin's segment holds exactly its rows, in increasing row order
    for f in range(xb.shape[1]):
        for b in range(NB):
            rows = tables.order[f, tables.offsets[f, b] : tables.offsets[f, b + 1]].long().numpy()
            np.testing.assert_array_equal(rows, np.nonzero(xb[:, f].numpy() == b)[0])


def test_prepare_bins_rejects_bins_out_of_range():
    with pytest.raises(ValueError, match="bins must lie"):
        ttg.prepare_bins(torch.tensor([[0, 4], [1, 2]]), 4)


def _chains(seed=0, c=6, n=90, p=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, p))
    y = 2.0 * x[:, 0] + np.sin(4 * x[:, 1]) + 0.1 * rng.standard_normal(n)
    xt = torch.as_tensor(x)
    xb = ttrees.bin_data(xt, ttrees.make_bins(xt, NB))
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32))
    return rng, xb, t(np.tile(y, (c, 1))), t(0.3 * rng.standard_normal((c, n)))


@pytest.mark.parametrize("emit,scaled,dev", [(False, False, False), (True, True, True), (True, False, False)],
                         ids=["cv", "finals", "emit_only"])
def test_cycle_plain_matches_one_tree_updates(emit, scaled, dev):
    """The plain cycle is T one-tree updates with the cycle's update
    expression, bit for bit; on CPU tensors no kernel is launched."""
    rng, xb, ys, fs = _chains()
    c, n = ys.shape
    bags = torch.as_tensor((rng.uniform(size=(5, c, n)) < 0.5).astype(np.float32))
    scale = torch.as_tensor(rng.uniform(0.0, 0.2, (5, c)).astype(np.float32)) if scaled else None
    dw = torch.stack([torch.ones(c, n), (bags[0] <= 0).float()]) if dev else None
    kw = dict(n_splits=3, nb=NB, min_leaf=5.0, lr=0.7 if not scaled else 1.0)
    before = dict(ttg.LAUNCHES)
    got = ttg.gbm_tree_cycle(ttg.prepare_bins(xb, NB), ys, fs, bags, scale=scale, emit_tree=emit, deviance_w=dw,
                             **kw)
    assert ttg.LAUNCHES == before
    f, trees, devs = fs, [], []
    for t in range(5):
        out = ttg.gbm_tree_update_plain(xb.T, None, ys, f, bags[t], emit_tree=emit, **kw)
        f_new = out[0] if emit else out
        f = f_new if scale is None else f + scale[t][:, None] * (f_new - f)
        trees.append(out[1:] if emit else None)
        if dev:
            r2 = (ys - f) ** 2
            devs.append([(dw[0] * r2).sum(1), (dw[1] * r2).sum(1)])
    torch.testing.assert_close(got.f, f, rtol=0, atol=0)
    assert (got.trees is None) == (not emit) and (got.deviance is None) == (not dev)
    if emit:
        for k in range(7):
            torch.testing.assert_close(got.trees[k], torch.stack([tr[k] for tr in trees]), rtol=0, atol=0)
    if dev:
        torch.testing.assert_close(got.deviance, torch.stack([torch.stack(d, 1) for d in devs]), rtol=0, atol=0)


def test_cycle_agreement_holds_a_cycle_to_the_plain_version():
    """The plain cycle agrees with itself in every chain, tree, f and
    deviance sum; a tree whose split differs is found as that chain's first
    difference (the chain is compared no further), and f is compared on the
    chains that agree."""
    rng, xb, ys, fs = _chains(seed=2)
    c, n = ys.shape
    bags = torch.as_tensor((rng.uniform(size=(4, c, n)) < 0.5).astype(np.float32))
    scale = torch.as_tensor(rng.uniform(0.05, 0.2, (4, c)).astype(np.float32))
    dw = torch.stack([torch.ones(c, n), (bags[0] <= 0).float()])
    kw = dict(n_splits=3, nb=NB, min_leaf=5.0, lr=1.0, scale=scale, deviance_w=dw)
    got = ttg.gbm_tree_cycle(ttg.prepare_bins(xb, NB), ys, fs, bags, emit_tree=True, **kw)
    agree = ttg.cycle_agreement(xb, ys, fs, bags, got, **kw)
    assert (agree["identical_chains"], agree["chains"], agree["trees"]) == (c, c, 4)
    assert agree["gaps"] == [] and agree["max_abs_err"] == 0.0 and agree["max_rel_err_deviance"] == 0.0
    assert agree["resid_scale"] >= float((ys - fs).abs().max())
    # chain 1's third tree splits its root at another bin; chain 0's f is off by 1e-3
    feat, thr, internal = got.trees[:3]
    assert float(internal[2, 1, 0]) == 1.0
    thr = thr.clone()
    thr[2, 1, 0] = (thr[2, 1, 0] + 1) % (NB - 1)
    f = got.f.clone()
    f[0] += 1e-3
    agree = ttg.cycle_agreement(xb, ys, fs, bags, got._replace(f=f, trees=(feat, thr) + got.trees[2:]), **kw)
    assert agree["identical_chains"] == c - 1
    assert [g[:2] for g in agree["gaps"]] == [(1, 2)] and agree["gaps"][0][2] > 0.0
    np.testing.assert_allclose(agree["max_abs_err"], 1e-3, rtol=1e-3)
    assert agree["max_rel_err_deviance"] == 0.0


def test_near_tie_gap_of_a_split_that_is_no_valid_split_is_inf():
    """A tree that chose a split no valid candidate allows parts from the
    other far from any tie: the gap is inf, never NaN."""
    xb = np.array([[0], [0], [1], [1], [2], [2]])
    r = np.array([2.0, 2.0, 0.0, 0.0, -1.0, -1.0])
    w = np.ones(6)
    node = lambda b: (np.array([0, 0, 0]), np.array([b, 0, 0]), np.array([1.0, 0, 0]), np.array([1, 0, 0]))
    assert ttg.near_tie_gap(xb, r, w, node(0), node(0), nb=4, min_leaf=1.0) is None
    assert 0.0 < ttg.near_tie_gap(xb, r, w, node(0), node(1), nb=4, min_leaf=1.0) < np.inf
    assert ttg.near_tie_gap(xb, r, w, node(0), node(3), nb=4, min_leaf=1.0) == np.inf   # the last bin


def test_cycle_wrappers_refuse_what_the_kernel_does_not_take():
    _, xb, ys, fs = _chains(c=2, n=30)
    tables = ttg.prepare_bins(xb, NB)
    bags = torch.ones((2, 2, 30))
    kw = dict(n_splits=2, nb=NB, min_leaf=1.0, lr=0.1)
    with pytest.raises(TypeError, match="float32"):
        ttg.gbm_tree_cycle(tables, ys.double(), fs.double(), bags.double(), **kw)
    # the kernel's entry takes CUDA tensors only: CPU ones raise before any build
    with pytest.raises(ValueError, match="CUDA device"):
        ttg.gbm_tree_cycle_cuda(tables, ys, fs, bags, **kw)


def _bag_stream(seed, shape):
    """Injected bags: tree t's 0/1 draw, the same for every call with t."""
    def bags(t):
        return torch.as_tensor((np.random.default_rng([seed, t]).uniform(size=shape) < 0.5).astype(np.float32))
    return bags


def _cv_curve_per_tree(x, y, w_outer, selectors, bags, *, n_folds, n_splits, lr, min_leaf, step_size, max_trees,
                       tolerance, n_bins):
    """The CV curve as it ran before cycles: one tree per call (reference)."""
    f32 = torch.float32
    n = x.shape[0]
    f_outer = w_outer.shape[0]
    y = y[None, :].expand(f_outer, n)
    fold_ids = torch.arange(n_folds)
    selectors = torch.as_tensor(selectors).long()
    train_w = (selectors[:, None, :] != fold_ids[None, :, None]).to(x.dtype) * w_outer[:, None, :]
    test_w = (selectors[:, None, :] == fold_ids[None, :, None]).to(x.dtype) * w_outer[:, None, :]
    xb = ttrees.bin_data(x, ttrees.make_bins(x, n_bins))
    xbt, cum1h = xb.T.contiguous(), ttrees.flat_bin_cum_onehot(xb, n_bins)
    test_sum = test_w.sum(2).clamp_min(1.0)
    f0 = (train_w * y[:, None, :]).sum(2) / train_w.sum(2).clamp_min(1.0)
    c = f_outer * n_folds
    y_flat = y[:, None, :].expand(f_outer, n_folds, n).reshape(c, n).to(f32).contiguous()
    tw_flat = train_w.reshape(c, n).to(f32)
    fm = f0[:, :, None].expand(f_outer, n_folds, n).reshape(c, n).to(f32).contiguous()
    max_cp = max_trees // step_size
    dev = np.full((max_cp, f_outer, n_folds), np.inf, np.float64)
    stopped = np.full((f_outer,), max_cp + 1, np.int64)
    j = t = 0
    while j < max_cp and np.any(stopped > max_cp):
        for _ in range(step_size):
            bag = torch.as_tensor(bags(t)).reshape(c, n).to(f32) * tw_flat
            fm = ttg.gbm_tree_update_plain(xbt, cum1h, y_flat, fm, bag, n_splits=n_splits, nb=n_bins,
                                           min_leaf=min_leaf, lr=lr)
            t += 1
        resid = y.to(f32)[:, None, :] - fm.reshape(f_outer, n_folds, n)
        dev[j] = ((test_w.to(f32) * resid**2).sum(2) / test_sum.to(f32)).numpy()
        fire = tgbm.stopping_fired(dev[: j + 1].mean(axis=2), tolerance, win=min(10, max_cp)) & (stopped > max_cp)
        stopped[fire] = j + 1
        j += 1
    return np.minimum(stopped, j), dev


def test_cv_curve_cycles_match_the_per_tree_loop():
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.uniform(0, 1, (100, 3)), dtype=torch.float32)
    y = 2.0 * x[:, 0] + torch.sin(4 * x[:, 1]) + 0.1 * torch.as_tensor(rng.standard_normal(100), dtype=torch.float32)
    w_outer = torch.as_tensor((rng.uniform(size=(2, 100)) < 0.8).astype(np.float32))
    selectors = np.stack([rng.permutation(np.arange(100) % 3) for _ in range(2)])
    kw = dict(n_folds=3, n_splits=2, lr=0.5, min_leaf=5.0, step_size=3, max_trees=30, tolerance=np.full(2, 1e-3),
              n_bins=NB)
    bags = _bag_stream(4, (6, 100))
    want_stop, want_dev = _cv_curve_per_tree(x, y, w_outer, selectors, bags, **kw)
    before = dict(ttg.LAUNCHES)
    got = tgbm._cv_deviance_curve_multi(x, y, w_outer, selectors=selectors, bags=bags, bag_fraction=0.5, **kw)
    assert ttg.LAUNCHES == before
    np.testing.assert_array_equal(got.dev, want_dev)
    np.testing.assert_array_equal(got.stopped, want_stop)


def _finals_per_tree(x, ycols, best_trees, bags, *, budget, n_splits, lr_vec, min_leaf, n_bins, sample_w):
    """The refits as they ran before cycles: one tree per call (reference)."""
    f32 = torch.float32
    c, n = ycols.shape
    w = sample_w
    xb = ttrees.bin_data(x, ttrees.make_bins(x, n_bins))
    xbt, cum1h = xb.T.contiguous(), ttrees.flat_bin_cum_onehot(xb, n_bins)
    lr_col = torch.as_tensor(np.asarray(lr_vec)).to(f32)[:, None]
    act = (torch.arange(budget)[None, :] < torch.as_tensor(best_trees)[:, None]).to(f32)
    wsum = w.sum(1).clamp_min(1.0)
    f0 = (w * ycols).sum(1) / wsum
    test_w = (w <= 0).to(f32)
    test_sum = test_w.sum(1).clamp_min(1.0)
    f = f0[:, None].expand(c, n).contiguous()
    trees, tdev, hdev = [], [], []
    for t in range(budget):
        bag = torch.as_tensor(bags(t)).reshape(c, n).to(f32) * w
        out = ttg.gbm_tree_update_plain(xbt, cum1h, ycols, f, bag, n_splits=n_splits, nb=n_bins,
                                        min_leaf=min_leaf, lr=1.0, emit_tree=True)
        f = f + (lr_col * act[:, t : t + 1]) * (out[0] - f)
        trees.append(out[1:])
        r2 = (ycols - f) ** 2
        tdev.append((w * r2).sum(1) / wsum)
        hdev.append((test_w * r2).sum(1) / test_sum)
    names = ("feat", "thr_bin", "internal", "left", "right", "value", "var_gain")
    res = dict(train_fit=f, f0=f0, train_deviance=torch.stack(tdev), holdout_deviance=torch.stack(hdev))
    res.update({name: torch.stack([tr[k] for tr in trees]) for k, name in enumerate(names)})
    return res


@pytest.mark.parametrize("step_size", [4, 3], ids=["whole_cycles", "ragged_last_cycle"])
def test_final_fits_cycles_match_the_per_tree_loop(step_size):
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.uniform(0, 1, (80, 3)), dtype=torch.float32)
    ycols = torch.as_tensor(np.stack([2 * x[:, 0].numpy(), rng.standard_normal(80)]).astype(np.float32))
    sample_w = torch.as_tensor((rng.uniform(size=(2, 80)) < 0.8).astype(np.float32))
    kw = dict(budget=8, n_splits=3, lr_vec=np.array([0.3, 0.1]), min_leaf=4.0, n_bins=NB)
    bags = _bag_stream(6, (2, 80))
    want = _finals_per_tree(x, ycols, np.array([8, 5]), bags, sample_w=sample_w, **kw)
    got = tgbm._final_fits(x, ycols, np.array([8, 5]), bag_fraction=0.5, sample_w=sample_w,
                           with_deviance=True, emit_trees=True, bags=bags, step_size=step_size, **kw)
    for key, val in want.items():
        torch.testing.assert_close(got[key], val, rtol=0, atol=0, msg=key)
