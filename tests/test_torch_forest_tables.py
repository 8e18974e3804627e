"""Kernel K3's outcome tables (``ops/forest.outcome_tables``) on the CPU.

``outcome_mirror`` evaluates a prepared forest the way ``csrc/forest_predict.cu``
does, in torch integers: the cells' bins as bytes 0x80 | bin, each tabled
tree's split nodes gathered by their byte selectors, the k + 1 bytes
subtracted, the top bits folded into the row u, the row's values summed in
tree order; then the membership test on the packed bytes of the other trees'
slots.  It must give the plain version's function (``forest_predict_plain``,
the slot formulation): membership counts (every slot value 1) exactly, sums
within 1e-5 of sum |w v| (float32 sums in another order).

Forests are random best-first trees (children of the k-th split in slots
2k+1 and 2k+2) with thresholds drawn from per-feature edge sets, so paths
test a feature more than once and some leaves are empty boxes.
"""
import numpy as np
import pytest
import torch

from machisplin_tpu_torch.models import trees as ttrees
from machisplin_tpu_torch.ops import forest as tforest
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

TOL = 1e-5  # of sum |w v| per response


def outcome_mirror(ft: tforest.ForestTables, x) -> torch.Tensor:
    """The kernel's two loops in plain torch on the kernel's own tables:
    (m, R) float32 without the offset."""
    x = torch.as_tensor(x, dtype=torch.float32)
    p = ft.etab.shape[0]
    bins = (x[:, :p, None] > ft.etab[None]).sum(2)                          # (m, p)
    m, n_resp = x.shape[0], ft.wv.shape[1]
    wv_ext = torch.cat([ft.wv, torch.zeros((1, n_resp))])
    out = torch.zeros((m, n_resp), dtype=torch.float32)
    n_tab = ft.desc.shape[0]
    if n_tab:
        byte = torch.full((m, 8), 0x80, dtype=torch.int64)
        byte[:, :p] |= bins
        d = ft.desc.long() & 0xFFFFFFFF
        four = torch.arange(4)
        sel = torch.cat([(d[:, 0:1] >> 4 * four) & 0xF, (d[:, 1:2] >> 4 * four) & 0xF], 1)    # (Tt, 8)
        kb = torch.cat([(d[:, 2:3] >> 8 * four) & 0xFF, (d[:, 3:4] >> 8 * four) & 0xFF], 1)
        g = byte[:, sel] - kb[None]                                          # (m, Tt, 8)
        assert bool(((g >= 0) & (g <= 255)).all()), "a borrow crosses a byte"
        u = ((g >> 7) << torch.arange(8)).sum(-1)                            # (m, Tt)
        rows = wv_ext[ft.row_slot]                                           # (Tt, 2^S, R)
        vals = rows[torch.arange(n_tab)[None, :], u]                         # (m, Tt, R)
        for t in range(n_tab):
            out += vals[:, t]
    if ft.loop_slot.numel():
        w = ft.lo_w.shape[1]
        shifts = 8 * torch.arange(4)
        lo = ((ft.lo_w.long()[:, :, None] & 0xFFFFFFFF) >> shifts & 0xFF).reshape(-1, 4 * w)   # (Ls, 4W)
        hi = ((ft.hi_w.long()[:, :, None] & 0xFFFFFFFF) >> shifts & 0xFF).reshape(-1, 4 * w)
        bn = torch.zeros((m, 4 * w), dtype=torch.int64)
        bn[:, :p] = bins
        a = (bn | 0x80)[:, None, :] - lo[None]                               # (m, Ls, 4W)
        b = hi[None] - bn[:, None, :]
        assert bool(((a >= 0) & (a <= 255) & (b >= 0) & (b <= 255)).all()), "a borrow crosses a byte"
        match = ((a & b & 0x80) > 0).all(-1).to(torch.float32)                # (m, Ls)
        for j, s in enumerate(ft.loop_slot.tolist()):
            out += match[:, j : j + 1] * wv_ext[s]
    return out


def random_forest(rng, splits, p, n_edges=40):
    """Best-first trees, tree t with ``splits[t]`` split nodes on random
    features, thresholds drawn from ``n_edges`` float32 edges per feature."""
    n_trees, n_nodes = len(splits), 2 * max(max(splits), 1) + 1
    edges = [np.sort(rng.uniform(0, 1, n_edges)).astype(np.float32) for _ in range(p)]
    feat = np.zeros((n_trees, n_nodes), np.int64)
    thr = np.zeros((n_trees, n_nodes), np.float32)
    internal = np.zeros((n_trees, n_nodes), np.float32)
    left = np.zeros((n_trees, n_nodes), np.int64)
    right = np.zeros((n_trees, n_nodes), np.int64)
    for t, s in enumerate(splits):
        leaves = [0]
        for k in range(s):
            q = leaves.pop(int(rng.integers(len(leaves))))
            f = int(rng.integers(p))
            feat[t, q], thr[t, q], internal[t, q] = f, rng.choice(edges[f]), 1.0
            left[t, q], right[t, q] = 2 * k + 1, 2 * k + 2
            leaves += [2 * k + 1, 2 * k + 2]
    value = rng.standard_normal((n_trees, n_nodes)).astype(np.float32)
    t = torch.as_tensor
    tree = ttrees.Tree(feat=t(feat), thr=t(thr), internal=t(internal), left=t(left), right=t(right),
                       value=t(value), var_gain=torch.zeros((n_trees, p)))
    return tree, edges


def _cells(rng, edges, m=3000):
    """Uniform cells, a tenth of their values set exactly on an edge."""
    p = len(edges)
    x = rng.uniform(-0.05, 1.05, (m, p)).astype(np.float32)
    on = rng.uniform(size=(m, p)) < 0.1
    for f in range(p):
        x[on[:, f], f] = rng.choice(edges[f], int(on[:, f].sum()))
    return torch.as_tensor(x)


def check_against_plain(ft, x):
    """Counts exact, sums within TOL of sum |w v|; returns the mirror's sums."""
    got, want = outcome_mirror(ft, x), tforest.forest_predict_plain(ft, x)
    scale = ft.wv.abs().sum(0)
    assert bool(((got - want).abs() <= TOL * scale).all()), float((got - want).abs().max())
    ones = ft._replace(wv=torch.ones_like(ft.wv[:, :1]))
    torch.testing.assert_close(outcome_mirror(ones, x), tforest.forest_predict_plain(ones, x), rtol=0, atol=0)
    return got


@pytest.mark.parametrize("n_splits", [1, 3, 5])
@pytest.mark.parametrize("n_cols", [None, 3], ids=["weights_T", "weights_TR"])
def test_outcome_tables_match_plain(n_splits, n_cols):
    """Every tree tabled (p = 5, S <= S_MAX): one lookup per tree."""
    rng = np.random.default_rng(n_splits)
    tree, edges = random_forest(rng, [n_splits] * 150, p=5)
    w = rng.uniform(size=150) if n_cols is None else rng.uniform(size=(150, n_cols))
    ft = tforest.prepare_forest(tree, torch.as_tensor(w), tforest.build_leaf_bins(tree, n_feat=5), "cpu")
    assert ft.desc.shape == (150, 4) and ft.row_slot.shape == (150, 1 << n_splits)
    assert ft.loop_slot.numel() == 0 and ft.lo_w.shape[0] == 0
    check_against_plain(ft, _cells(rng, edges))


def test_outcome_tables_mixed_depths():
    """Trees of 0-9 splits: those above S_MAX keep the slot loop, in the
    same evaluation; the tabled trees' rows pad to the deepest tabled tree."""
    rng = np.random.default_rng(11)
    splits = list(rng.integers(0, 10, 120)) + [tforest.S_MAX, tforest.S_MAX + 1]
    tree, edges = random_forest(rng, splits, p=6)
    tabs = tforest.build_leaf_bins(tree, n_feat=6)
    ft = tforest.prepare_forest(tree, torch.as_tensor(rng.uniform(size=(122, 2))), tabs, "cpu")
    splits = np.asarray(splits)
    deep = splits > tforest.S_MAX
    assert ft.desc.shape[0] == int((~deep).sum()) and ft.row_slot.shape[1] == 1 << tforest.S_MAX
    loop_trees = np.unique(tabs.leaf_tree[ft.loop_slot.numpy()])
    np.testing.assert_array_equal(loop_trees, np.flatnonzero(deep))
    check_against_plain(ft, _cells(rng, edges))


def test_outcome_tables_wide_stack_takes_the_slot_loop():
    """p = 10 (more than two packed words): every tree in the slot loop."""
    rng = np.random.default_rng(12)
    tree, edges = random_forest(rng, list(rng.integers(1, 6, 80)), p=10)
    tabs = tforest.build_leaf_bins(tree, n_feat=10)
    ft = tforest.prepare_forest(tree, torch.as_tensor(rng.uniform(size=80)), tabs, "cpu")
    assert ft.desc.shape[0] == 0 and ft.lo_w.shape[1] == 3
    np.testing.assert_array_equal(ft.loop_slot.numpy(), np.flatnonzero(tabs.leaf_tree >= 0))
    check_against_plain(ft, _cells(rng, edges, m=2000))


def test_s_max_moves_trees_between_the_loops_only():
    """The same forest with every S_MAX from 0 to 6 gives the same sums
    (within TOL) and the same counts."""
    rng = np.random.default_rng(13)
    tree, edges = random_forest(rng, list(rng.integers(0, 7, 60)), p=4)
    tabs = tforest.build_leaf_bins(tree, n_feat=4)
    x = _cells(rng, edges, m=1500)
    w = torch.as_tensor(rng.uniform(size=60))
    sums = []
    for s_max in range(tforest.S_MAX + 1):
        ft = tforest.prepare_forest(tree, w, tabs, "cpu", s_max=s_max)
        assert ft.desc.shape[0] == int((tree.internal.sum(1) <= s_max).sum())
        sums.append(check_against_plain(ft, x))
    scale = float(ft.wv.abs().sum())
    for s in sums[1:]:
        assert float((s - sums[0]).abs().max()) <= TOL * scale


def test_outcome_rows_are_the_routed_leaves():
    """Row u of a tabled tree is the slot of the leaf that routing reaches
    for a cell whose bits are u (``models/trees.tree_assign``), or the zero
    row for the dropped leaf."""
    rng = np.random.default_rng(14)
    tree, edges = random_forest(rng, [5] * 40, p=5)
    tabs = tforest.build_leaf_bins(tree, n_feat=5)
    ft = tforest.prepare_forest(tree, torch.ones(40), tabs, "cpu")
    x = _cells(rng, edges, m=1000)
    leaf = ttrees.tree_assign(tree, x, 5)                                    # (T, m)
    bins = (x[:, :, None] > ft.etab[None]).sum(2)
    d = ft.desc.long() & 0xFFFFFFFF
    for t in range(40):
        nodes = torch.nonzero(tree.internal[t] > 0).flatten()
        feats = [(int(d[t, j // 4]) >> 4 * (j % 4)) & 0xF for j in range(len(nodes))]
        ks = [((int(d[t, 2 + j // 4]) >> 8 * (j % 4)) & 0xFF) - 1 for j in range(len(nodes))]
        assert feats == tree.feat[t, nodes].tolist()
        u = sum((bins[:, f] > k).long() << j for j, (f, k) in enumerate(zip(feats, ks)))
        slot = ft.row_slot[t, u]
        want = torch.full_like(slot, ft.wv.shape[0])                         # the zero row
        for s in np.flatnonzero(tabs.leaf_tree == t).tolist():
            want[leaf[t] == int(tabs.leaf_node[s])] = s
        assert torch.equal(slot, want)
        assert bool((leaf[t][slot == ft.wv.shape[0]] == int(tabs.drop_node[t])).all())
