"""The CUDA kernels against their plain PyTorch versions: K1 (TPS grid, also
on a Nystrom model fitted on the card, whose float64 tail runs there), K2
(tree grower, one tree and a 50-tree cycle per launch; one bin table or one
per chain, monotone signs, rows in shared or in device memory), K3 (forest
predictor, also on a random forest in its slot loop) and K4 (the SVM's
coordinate sweep, theta in shared or in device memory); and the NN letter's L-BFGS on the card against the CPU.

These tests need a CUDA device and nvcc; they skip without them.  They import
nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from machisplin_tpu_torch import grid as tgrid
from machisplin_tpu_torch.models import nn as tnn, rf as trf, svm as tsvm, trees as ttrees
from machisplin_tpu_torch.models.base import chunk_elems
from machisplin_tpu_torch.ops import (
    forest as ttforest, svm_sweep as ttsvm, tps as ttps, tps_grid as ttg, tree_grow as ttgrow,
)
from test_torch_forest_tables import random_forest
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _model(n_knots, n_resp, device, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 2, size=(n_knots, 2))
    ys = np.stack([np.sin(2 * pts[:, 0] + j) * np.cos(pts[:, 1]) for j in range(n_resp)], 1)
    y = ys[:, 0] if n_resp == 1 else ys
    return ttps.tps_fit(torch.as_tensor(pts, device=device), torch.as_tensor(y, device=device), lam=1e-6)


@pytest.mark.parametrize("n_knots,n_resp,shape", [
    (50, 1, (37, 53)),        # one response, ragged last block
    (300, 2, (129, 260)),     # the main path's response count
    (200, 9, (20, 31)),       # the fewest responses of the wide block shape
    (813, 3, (64, 64)),       # every station in one model, a ragged last chunk
    (4096, 1, (24, 200)),     # the large-station path's landmark count
    (300, 19, (20, 31)),      # BASELINE config 3's responses: one launch
    (300, 24, (21, 100)),     # the most one launch holds
    (300, 25, (21, 100)),     # one more: two launches, 24 + 1
])
def test_k1_matches_plain(cuda, n_knots, n_resp, shape):
    model = _model(n_knots, n_resp, cuda)
    g = tgrid.GridSpec(nrows=shape[0], ncols=shape[1], xmin=-3.1, ymax=2.2, dx=5.3 / shape[1], dy=5.4 / shape[0])
    tab = ttg.grid_tables(model, g, torch.float32)
    before = ttg.LAUNCHES["tps_grid"]
    got = ttg.tps_grid_cuda(tab, g)
    torch.cuda.synchronize()
    assert ttg.LAUNCHES["tps_grid"] - before == -(-n_resp // ttg._MAX_RESP)
    want = ttg.tps_grid_plain(tab, g)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-4 * scale
    out = ttps.tps_predict_grid(model, g)
    assert out.shape == (shape if n_resp == 1 else shape + (n_resp,))


def test_k1_one_launch_equals_slices(cuda):
    """19 responses in one launch (the wide block shape, phi once a pair)
    give the same bits as the same tables launched as the slices 0:8, 8:16
    and 16:19 (the 8-response block shape): every output sums its knots in
    the same order with the same arithmetic.  The grid's rows and columns
    are ragged for both block shapes."""
    model = _model(300, 19, cuda, seed=3)
    g = tgrid.GridSpec(nrows=203, ncols=700, xmin=-3.1, ymax=2.2, dx=5.3 / 700, dy=5.4 / 203)
    tab = ttg.grid_tables(model, g, torch.float32)
    before = ttg.LAUNCHES["tps_grid"]
    one = ttg.tps_grid_cuda(tab, g)
    assert ttg.LAUNCHES["tps_grid"] - before == 1
    fn = ttg._launcher()
    sliced = torch.full_like(one, float("nan"))
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for r0, r1 in ((0, 8), (8, 16), (16, 19)):
        cs, ds, os_ = tab.c[r0:r1], tab.d[r0:r1], sliced[r0:r1]
        assert fn(tab.kxy.data_ptr(), cs.data_ptr(), ds.data_ptr(), os_.data_ptr(), tab.c.shape[1], r1 - r0,
                  g.nrows, g.ncols, *tab.geo, stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(one, sliced)


@pytest.mark.parametrize("live", [37, 50])
def test_k1_skips_a_knot_budgets_padding(cuda, live):
    """A tile packed to a 64-knot budget: K1 evaluates its live knots only
    (padded to the unroll width 4) and agrees with the plain version, and
    with the plain version of every budget knot, to 2e-4 of max|surface|."""
    from machisplin_tpu_torch.parallel import sharded as tsharded

    rng = np.random.default_rng(live)
    pts = [rng.uniform(-3, 2, size=(live, 2)), rng.uniform(-3, 2, size=(64, 2))]
    ys = [np.stack([np.sin(2 * p[:, 0]) * np.cos(p[:, 1]), p[:, 0] ** 2], 1) for p in pts]
    ct, yt, mt = tsharded.pack_tiles(pts, ys, pad_to=64, dtype=torch.float64, device=cuda)
    model = ttps.TPSModel(*(a[0] for a in tsharded.batched_tile_solve(ct, yt, mt)))
    g = tgrid.GridSpec(nrows=97, ncols=613, xmin=-3.1, ymax=2.2, dx=5.3 / 613, dy=5.4 / 97)
    tab = ttg.grid_tables(model, g, torch.float32)
    assert tab.c.shape == (2, -(-live // 4) * 4)
    got = ttg.tps_grid_cuda(tab, g)
    torch.cuda.synchronize()
    want = ttg.tps_grid_plain(tab, g)
    every = tab._replace(kxy=model.knots.T.float().contiguous(), c=(0.5 * model.c.T).float().contiguous())
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-4 * scale
    assert float((got - ttg.tps_grid_plain(every, g)).abs().max()) <= 2e-4 * scale


def test_k1_wrapper_checks_inputs(cuda):
    model = _model(40, 2, cuda)
    g = tgrid.GridSpec(8, 8, -3.0, 2.0, 0.5, 0.5)
    tab = ttg.grid_tables(model, g, torch.float64)
    with pytest.raises(TypeError):
        ttg.tps_grid_cuda(tab, g)


def _k2_inputs(c, n, p, nb, device, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, p))
    y = 2.0 * x[:, 0] + np.sin(4 * x[:, 1 % p]) + 0.1 * rng.standard_normal(n)
    xt = torch.as_tensor(x, device=device)
    xb = ttrees.bin_data(xt, ttrees.make_bins(xt, nb))
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device).contiguous()
    ys = t(np.tile(y, (c, 1)))
    fs = t(0.3 * rng.standard_normal((c, n)))
    ws = t(rng.uniform(size=(c, n)) < 0.5)
    return xb, ys, fs, ws


@pytest.mark.parametrize("c,n,p,nb,n_splits", [
    (7, 150, 3, 16, 4),       # a few chains, tiny
    (200, 813, 5, 64, 25),    # the CV shape of the main path
    (20, 813, 5, 64, 5),      # the finals' shape
    (5, 300, 20, 64, 6),      # more columns than a block has threads: two passes over them
    (4, 500, 2, 256, 4),      # eight warps a feature: the scan carries across seven
])
def test_k2_matches_plain(cuda, c, n, p, nb, n_splits):
    """Same trees as the plain version, except at near-ties of float32
    summation order (relative gain gap <= 1e-5); f to 1e-5 of the residuals.
    Prepared tables and raw bins launch the same kernel with the same result."""
    xb, ys, fs, ws = _k2_inputs(c, n, p, nb, cuda)
    kw = dict(n_splits=n_splits, nb=nb, min_leaf=10.0, lr=0.05)
    tables = ttgrow.prepare_bins(xb, nb)
    before = dict(ttgrow.LAUNCHES)
    out = ttgrow.gbm_tree_cycle(tables, ys, fs, ws[None], emit_tree=True, **kw)
    torch.cuda.synchronize()
    assert {k: ttgrow.LAUNCHES[k] - before[k] for k in before} == {"tree_grow": 1, "tree_grow_trees": 1}
    got = (out.f,) + tuple(a[0] for a in out.trees)
    want = ttgrow.gbm_tree_update_plain(xb.T, None, ys, fs, ws, emit_tree=True, **kw)
    raw = ttgrow.gbm_tree_update(xb.T, None, ys, fs, ws, emit_tree=True, **kw)
    for a, b in zip(got, raw):
        assert torch.equal(a, b)
    got = [a.cpu().numpy() for a in got]
    want = [a.cpu().numpy() for a in want]
    r = (ys - fs).cpu().numpy()
    scale = float(np.abs(r).max())
    for ch in range(c):
        tree_g = [got[k][ch] for k in (1, 2, 3, 4)]
        tree_w = [want[k][ch] for k in (1, 2, 3, 4)]
        gap = ttgrow.near_tie_gap(xb.cpu().numpy(), r[ch], ws[ch].cpu().numpy(), tree_w, tree_g,
                                  nb=nb, min_leaf=10.0)
        assert gap is None or gap <= 1e-5, (ch, gap)
        if gap is None:
            np.testing.assert_allclose(got[0][ch], want[0][ch], rtol=0, atol=1e-5 * scale)
    f_only = ttgrow.gbm_tree_cycle(tables, ys, fs, ws[None], **kw).f
    np.testing.assert_array_equal(f_only.cpu().numpy(), got[0])


@pytest.mark.parametrize("finals_update", [False, True], ids=["f_only", "emit_scale_deviance"])
@pytest.mark.parametrize("c,n_splits", [(200, 25), (20, 5)], ids=["cv_shape", "finals_shape"])
def test_k2_cycle_matches_single(cuda, c, n_splits, finals_update):
    """A 50-tree cycle in one launch is bit-identical to 50 one-tree
    launches of the same kernel: f, and with the finals' update the trees
    and deviance sums; the counts say 1 launch of 50 trees, then 50 of 1.
    Against the plain version grown from the same inputs, each chain's trees
    part only at near-ties (relative gain gap <= 1e-5); where a chain's 50
    trees all agree, f is within 1e-5 of the residuals and the deviance sums
    within 1e-4 (relative)."""
    n, p, nb = 813, 5, 64
    xb, ys, fs, ws = _k2_inputs(c, n, p, nb, cuda, seed=3)
    tables = ttgrow.prepare_bins(xb, nb)
    rng = np.random.default_rng(4)
    bags = torch.as_tensor((rng.uniform(size=(50, c, n)) < 0.5).astype(np.float32), device=cuda) * ws
    kw = dict(n_splits=n_splits, nb=nb, min_leaf=10.0, lr=0.05)
    if finals_update:
        kw.update(lr=1.0, emit_tree=True, deviance_w=torch.stack([ws, (ws <= 0).float()]).contiguous(),
                  scale=torch.as_tensor(rng.uniform(0, 0.01, (50, c)).astype(np.float32), device=cuda))
    before = dict(ttgrow.LAUNCHES)
    cyc = ttgrow.gbm_tree_cycle(tables, ys, fs, bags, **kw)
    torch.cuda.synchronize()
    assert {k: ttgrow.LAUNCHES[k] - before[k] for k in before} == {"tree_grow": 1, "tree_grow_trees": 50}
    f, outs = fs, []
    for t in range(50):
        one = dict(kw, scale=kw["scale"][t : t + 1]) if finals_update else kw
        out = ttgrow.gbm_tree_cycle(tables, ys, f, bags[t : t + 1], **one)
        f = out.f
        outs.append(out)
    torch.cuda.synchronize()
    assert {k: ttgrow.LAUNCHES[k] - before[k] for k in before} == {"tree_grow": 51, "tree_grow_trees": 100}
    assert torch.equal(cyc.f, f)
    assert bool(torch.isfinite(cyc.f).all())
    if finals_update:
        for k in range(7):
            assert torch.equal(cyc.trees[k], torch.cat([o.trees[k] for o in outs])), k
        assert torch.equal(cyc.deviance, torch.cat([o.deviance for o in outs]))
        assert int(cyc.trees[2].sum()) > 0                 # the trees split
    grown = cyc if finals_update else ttgrow.gbm_tree_cycle(tables, ys, fs, bags, emit_tree=True, **kw)
    assert torch.equal(grown.f, cyc.f)
    agree = ttgrow.cycle_agreement(xb, ys, fs, bags, grown, **{k: v for k, v in kw.items() if k != "emit_tree"})
    assert all(g[2] <= 1e-5 for g in agree["gaps"]), agree["gaps"]
    assert agree["identical_chains"] > 0
    assert agree["max_abs_err"] <= 1e-5 * agree["resid_scale"]
    if finals_update:
        assert agree["max_rel_err_deviance"] <= 1e-4


def test_k2_wrapper_checks_inputs(cuda):
    xb, ys, fs, ws = _k2_inputs(3, 100, 2, 16, cuda)
    kw = dict(n_splits=3, nb=16, min_leaf=5.0, lr=0.1)
    tables = ttgrow.prepare_bins(xb, 16)
    before = dict(ttgrow.LAUNCHES)
    with pytest.raises(ValueError, match="bags"):
        ttgrow.gbm_tree_cycle(tables, ys, fs, ws[None, :2], **kw)
    with pytest.raises(ValueError, match="xbt must be on"):
        ttgrow.gbm_tree_cycle(ttgrow.prepare_bins(xb.cpu(), 16), ys, fs, ws[None], **kw)
    with pytest.raises(ValueError, match="offsets"):
        ttgrow.gbm_tree_cycle(tables, ys, fs, ws[None], **dict(kw, nb=8))
    assert ttgrow.LAUNCHES == before


def _k2_fold_tables(xb_raw, c, nb, device, seed=5):
    """(xb (C, n, p), tables) of C CV folds, each binned on its own training
    rows (``make_bins_masked``), as the serial gbm.step bins them; and the
    folds' training masks (C, n) float32."""
    x, _ = xb_raw
    n = x.shape[0]
    folds = torch.as_tensor(np.random.default_rng(seed).permutation(n) % c, device=device)
    train = (folds[None, :] != torch.arange(c, device=device)[:, None]).float()
    edges = ttrees.make_bins_masked(x, train, nb)
    xb = torch.stack([ttrees.bin_data(x, e) for e in edges])
    return xb, ttgrow.prepare_bins(xb, nb), train


def _k2_raw(n, p, device, seed=0):
    rng = np.random.default_rng(seed)
    x = torch.as_tensor(rng.uniform(0, 1, (n, p)), device=device)
    y = 2.0 * x[:, 0] + torch.sin(4 * x[:, 1 % p]) + 0.1 * torch.as_tensor(rng.standard_normal(n), device=device)
    return x, y.float()


def _agree(agree):
    assert all(g[2] <= 1e-5 for g in agree["gaps"]), agree["gaps"]
    assert agree["identical_chains"] > 0
    assert agree["max_abs_err"] <= 1e-5 * agree["resid_scale"]


@pytest.mark.parametrize("monotone", [False, True], ids=["free", "monotone"])
def test_k2_per_chain_tables_match_plain(cuda, monotone):
    """10 CV folds, each on a bin table of its own training rows, one launch
    of a 20-tree cycle (tree complexity 5, with monotone signs or without):
    against the plain version grown tree by tree from the same inputs, trees
    part only at near-ties; f of the chains that never part within 1e-5 of
    the residuals."""
    c, n, p, nb = 10, 813, 5, 64
    raw = _k2_raw(n, p, cuda, seed=6)
    xb, tables, train = _k2_fold_tables(raw, c, nb, cuda)
    assert tables.xbt.shape == (c, p, n) and tables.offsets.shape == (c, p, nb + 1)
    y = raw[1][None].expand(c, n).contiguous()
    f = torch.zeros_like(y)
    rng = np.random.default_rng(7)
    bags = torch.as_tensor((rng.uniform(size=(20, c, n)) < 0.5).astype(np.float32), device=cuda) * train
    mono = torch.tensor([1.0, -1.0, 0.0, 1.0, 0.0], device=cuda) if monotone else None
    kw = dict(n_splits=5, nb=nb, min_leaf=10.0, lr=0.1, monotone=mono)
    got = ttgrow.gbm_tree_cycle(tables, y, f, bags, emit_tree=True, **kw)
    torch.cuda.synchronize()
    assert int(got.trees[2].sum()) > 0
    _agree(ttgrow.cycle_agreement(xb, y, f, bags, got, **kw))
    for ch in range(c):   # each chain as a launch of its own table alone
        one = ttgrow.prepare_bins(xb[ch], nb)
        alone = ttgrow.gbm_tree_cycle(one, y[ch : ch + 1].contiguous(), f[ch : ch + 1].contiguous(),
                                      bags[:, ch : ch + 1].contiguous(), emit_tree=True, **kw)
        assert torch.equal(alone.f[0], got.f[ch])
        for a, b in zip(alone.trees, got.trees):
            assert torch.equal(a[:, 0], b[:, ch])


def test_k2_monotone_zero_and_none_bit_identical(cuda):
    """All-zero monotone signs constrain nothing: bit-identical to no
    monotone vector (the parent's call), with trees, scale and deviance
    sums; real signs change the trees and keep every split's child means in
    the signs' order."""
    xb, ys, fs, ws = _k2_inputs(20, 813, 5, 64, cuda, seed=8)
    tables = ttgrow.prepare_bins(xb, 64)
    rng = np.random.default_rng(9)
    bags = torch.as_tensor((rng.uniform(size=(10, 20, 813)) < 0.5).astype(np.float32), device=cuda) * ws
    kw = dict(n_splits=5, nb=64, min_leaf=10.0, lr=1.0, emit_tree=True,
              scale=torch.full((10, 20), 0.01, device=cuda), deviance_w=torch.stack([ws, (ws <= 0).float()]).contiguous())
    none = ttgrow.gbm_tree_cycle(tables, ys, fs, bags, **kw)
    zero = ttgrow.gbm_tree_cycle(tables, ys, fs, bags, monotone=torch.zeros(5, device=cuda), **kw)
    assert torch.equal(none.f, zero.f) and torch.equal(none.deviance, zero.deviance)
    assert all(torch.equal(a, b) for a, b in zip(none.trees, zero.trees))
    mono = torch.tensor([1.0, -1.0, 1.0, -1.0, 1.0], device=cuda)
    signed = ttgrow.gbm_tree_cycle(tables, ys, fs, bags, monotone=mono, **kw)
    feat, internal, left, right, value = (signed.trees[k].cpu() for k in (0, 2, 3, 4, 5))
    q = internal > 0
    sgn = mono.cpu()[feat.long()]
    d = value.gather(2, right.long()) - value.gather(2, left.long())
    assert bool(((sgn * d)[q] >= -1e-5 * value.abs().max()).all())
    assert not all(torch.equal(a, b) for a, b in zip(none.trees, signed.trees))


@pytest.mark.parametrize("case", ["cv", "finals", "per_chain_monotone"])
def test_k2_global_rows_bit_identical_to_shared(cuda, case):
    """At n = 813 both layouts fit; rows in device memory give the same bits
    as rows in shared memory: f, trees and deviance sums."""
    n, p, nb = 813, 5, 64
    if case == "per_chain_monotone":
        raw = _k2_raw(n, p, cuda, seed=10)
        xb, tables, ws = _k2_fold_tables(raw, 10, nb, cuda)
        ys = raw[1][None].expand(10, n).contiguous()
        fs = torch.zeros_like(ys)
        kw = dict(n_splits=5, monotone=torch.tensor([0.0, 1.0, -1.0, 0.0, 1.0], device=cuda))
    else:
        c = 200 if case == "cv" else 20
        xb, ys, fs, ws = _k2_inputs(c, n, p, nb, cuda, seed=11)
        tables = ttgrow.prepare_bins(xb, nb)
        kw = dict(n_splits=25 if case == "cv" else 5)
    c = ys.shape[0]
    rng = np.random.default_rng(12)
    bags = torch.as_tensor((rng.uniform(size=(10, c, n)) < 0.5).astype(np.float32), device=cuda) * ws
    kw.update(nb=nb, min_leaf=10.0, lr=0.05, emit_tree=True)
    if case == "finals":
        kw.update(lr=1.0, scale=torch.full((10, c), 0.001, device=cuda),
                  deviance_w=torch.stack([ws, (ws <= 0).float()]).contiguous())
    shared = ttgrow.gbm_tree_cycle_cuda(tables, ys, fs, bags, rows="shared", **kw)
    glob = ttgrow.gbm_tree_cycle_cuda(tables, ys, fs, bags, rows="global", **kw)
    auto = ttgrow.gbm_tree_cycle_cuda(tables, ys, fs, bags, **kw)
    torch.cuda.synchronize()
    for out in (glob, auto):
        assert torch.equal(out.f, shared.f)
        assert all(torch.equal(a, b) for a, b in zip(out.trees, shared.trees))
        if case == "finals":
            assert torch.equal(out.deviance, shared.deviance)


@pytest.mark.parametrize("c,n,n_splits", [(20, 8000, 25), (4, 40000, 5)], ids=["n8000", "n40000"])
def test_k2_beyond_shared_memory_matches_plain(cuda, c, n, n_splits):
    """Station counts whose rows do not fit a block's shared memory (the
    parent refused them): the rows go to device memory (int32 sorted rows
    past 32,767), and a 5-tree cycle agrees with the plain version."""
    p, nb = 5, 64
    assert ttgrow._library().tree_grow_rows_global(n, p, nb, n_splits) == 1
    xb, ys, fs, ws = _k2_inputs(c, n, p, nb, cuda, seed=13)
    tables = ttgrow.prepare_bins(xb, nb)
    assert tables.order.dtype == (torch.int16 if n <= 32767 else torch.int32)
    rng = np.random.default_rng(14)
    bags = torch.as_tensor((rng.uniform(size=(5, c, n)) < 0.5).astype(np.float32), device=cuda) * ws
    kw = dict(n_splits=n_splits, nb=nb, min_leaf=10.0, lr=0.05)
    with pytest.raises(ValueError, match="do not fit"):
        ttgrow.gbm_tree_cycle_cuda(tables, ys, fs, bags, rows="shared", **kw)
    got = ttgrow.gbm_tree_cycle(tables, ys, fs, bags, emit_tree=True, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got.f).all()) and int(got.trees[2].sum()) > 0
    _agree(ttgrow.cycle_agreement(xb, ys, fs, bags, got, **kw))


def test_k2_wrapper_checks_new_inputs(cuda):
    """Monotone signs, per-chain tables and the rows layout are checked
    before any launch."""
    xb, ys, fs, ws = _k2_inputs(3, 100, 2, 16, cuda)
    kw = dict(n_splits=3, nb=16, min_leaf=5.0, lr=0.1)
    tables = ttgrow.prepare_bins(xb, 16)
    chains = ttgrow.prepare_bins(xb[None].expand(2, -1, -1), 16)
    before = dict(ttgrow.LAUNCHES)
    with pytest.raises(ValueError, match="monotone"):
        ttgrow.gbm_tree_cycle(tables, ys, fs, ws[None], monotone=torch.zeros(3, device=cuda), **kw)
    with pytest.raises(TypeError, match="monotone"):
        ttgrow.gbm_tree_cycle(tables, ys, fs, ws[None], monotone=torch.zeros(2, device=cuda, dtype=torch.float64), **kw)
    with pytest.raises(ValueError, match="xbt"):
        ttgrow.gbm_tree_cycle(chains, ys, fs, ws[None], **kw)
    with pytest.raises(ValueError, match="rows"):
        ttgrow.gbm_tree_cycle_cuda(tables, ys, fs, ws[None], rows="l2", **kw)
    assert ttgrow.LAUNCHES == before


def _k3_forest(kind, cuda):
    """(tree, p, depth): "k2" 30 x 2 trees of 5 splits grown by K2 (all
    tabled); "deep" random trees of 0-9 splits, those above S_MAX in the
    slot loop; "wide" p = 10, every tree in the slot loop."""
    if kind == "k2":
        xb, ys, fs, ws = _k2_inputs(2, 400, 5, 64, cuda, seed=1)
        kw = dict(n_splits=5, nb=64, min_leaf=10.0, lr=1.0, emit_tree=True)
        cyc = ttgrow.gbm_tree_cycle(ttgrow.prepare_bins(xb, 64), ys, fs, ws.expand(30, *ws.shape).contiguous(),
                                    scale=torch.full((30, ws.shape[0]), 0.1, device=cuda), **kw)
        stack = [a.reshape(-1, a.shape[-1]).cpu() for a in cyc.trees]
        edges = ttrees.make_bins(torch.rand(400, 5, dtype=torch.float64), 64)
        tree = ttrees.Tree(feat=stack[0].long(), thr=ttrees.edges_lookup(edges, stack[0], stack[1]).float(),
                           internal=stack[2], left=stack[3].long(), right=stack[4].long(), value=stack[5],
                           var_gain=stack[6])
        return tree, 5, 5
    rng = np.random.default_rng(3)
    if kind == "deep":
        return random_forest(rng, list(rng.integers(0, 10, 300)), p=6, n_edges=100)[0], 6, 9
    return random_forest(rng, list(rng.integers(1, 6, 200)), p=10, n_edges=60)[0], 10, 5


# n_cols 9: the 9 responses of a config-3-shaped run, 3 launches of 4 columns
@pytest.mark.parametrize("kind,n_cols", [("k2", None), ("k2", 2), ("k2", 5), ("k2", 9), ("deep", 2), ("wide", None)])
def test_k3_matches_plain(cuda, kind, n_cols):
    """Exact leaf membership counts, weighted sums to 1e-5 of sum |w v|,
    with every tree tabled, trees above S_MAX in the slot loop of the same
    launch, and a p > 8 stack in the slot loop alone."""
    tree, p, depth = _k3_forest(kind, cuda)
    n_t = tree.feat.shape[0]
    rng = np.random.default_rng(2)
    w = rng.uniform(size=n_t) if n_cols is None else rng.uniform(size=(n_t, n_cols))
    tabs = ttforest.build_leaf_bins(tree, n_feat=p)
    x = torch.rand((70_001, p), dtype=torch.float32, device=cuda) * 1.2 - 0.1
    ft = ttforest.prepare_forest(tree, torch.as_tensor(w), tabs, cuda)
    deep = (tree.internal.sum(1) > ttforest.S_MAX) | (p > 8)
    assert ft.desc.shape[0] == int((~deep).sum())
    assert ft.loop_slot.numel() == int(np.isin(tabs.leaf_tree, np.flatnonzero(deep.numpy())).sum())
    before = ttforest.LAUNCHES["forest_predict"]
    got = ttforest.forest_predict_cuda(ft, x)
    torch.cuda.synchronize()
    assert ttforest.LAUNCHES["forest_predict"] - before == -(-(n_cols or 1) // 4)
    want = ttforest.forest_predict_plain(ft, x)
    scale = ft.wv.abs().sum(0)
    assert bool(((got - want).abs() <= 1e-5 * scale).all())
    ones = ft._replace(wv=torch.ones_like(ft.wv[:, :1]), offset=ft.offset[:1])
    torch.testing.assert_close(ttforest.forest_predict_cuda(ones, x), ttforest.forest_predict_plain(ones, x),
                               rtol=0, atol=0)
    routed = ttrees.forest_predict(ttrees.Tree(*(a.to(cuda) for a in tree)), x[:2000], depth,
                                   weights=torch.as_tensor(w if n_cols is None else w[:, 0], device=cuda).float())
    full = ttforest.predict_prepared(ft, x[:2000])
    full = full if n_cols is None else full[:, 0]
    assert float((full - routed).abs().max()) <= 1e-5 * float(scale[0])


def test_k3_refuses_cells_off_the_tables_device(cuda):
    """predict_prepared never moves cells between the card and the host."""
    tree = ttrees.Tree(feat=torch.zeros((1, 3), dtype=torch.long), thr=torch.tensor([[0.5, 0.0, 0.0]]),
                       internal=torch.tensor([[1.0, 0.0, 0.0]]), left=torch.tensor([[1, 0, 0]]),
                       right=torch.tensor([[2, 0, 0]]), value=torch.tensor([[0.0, -1.0, 1.0]]),
                       var_gain=torch.zeros((1, 3)))
    tabs = ttforest.build_leaf_bins(tree, n_feat=3)
    x = torch.rand((64, 3))
    before = ttforest.LAUNCHES["forest_predict"]
    with pytest.raises(ValueError, match="tables on cpu"):
        ttforest.predict_prepared(ttforest.prepare_forest(tree, torch.ones(1), tabs, "cpu"), x.to(cuda))
    with pytest.raises(ValueError, match="tables on cuda"):
        ttforest.predict_prepared(ttforest.prepare_forest(tree, torch.ones(1), tabs, cuda), x)
    assert ttforest.LAUNCHES["forest_predict"] == before


def _nn_lanes(dtype, device, lanes=6, n=300, p=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) * np.array([1.0, 30.0, 2.0, 5.0, 0.5]) + 100.0
    y = np.tanh(x[:, 0] - 100.0) + 0.01 * x[:, 1] + 0.05 * rng.normal(size=n)
    y = (y - y.min()) / np.ptp(y)
    w = (rng.uniform(size=(lanes, n)) > 0.1).astype(np.float64)
    init = tnn.draw_init(lanes, p, 10, generator=torch.Generator().manual_seed(seed + 1), dtype=dtype, device=device)
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    return t(x), t(y).expand(lanes, n).contiguous(), t(w), init


@pytest.mark.parametrize("steps,tol", [(10, 1e-9), (50, 1e-5)])
def test_nn_lbfgs_card_matches_cpu(cuda, steps, tol):
    """float64 L-BFGS steps of 6 NN lanes from the same inits: the card's
    predictions (through the CUDA graph) against the CPU's, of the response
    range, with chip_smoke's tolerances (the 50-step one widened for the
    training's amplification of rounding-order differences)."""
    preds = {}
    for dev in ("cpu", "cuda"):
        x, y, w, init = _nn_lanes(torch.float64, dev)
        state = tnn.fit(x, y, sample_weight=w, hidden=10, maxit=steps, init=init)
        preds[dev] = tnn.predict(state, x).cpu()
    assert float((preds["cuda"] - preds["cpu"]).abs().max()) <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_nn_lbfgs_graph_equals_eager(cuda, dtype):
    """The CUDA graph replays the eager pass's kernels: bit-identical params,
    and a handful of host syncs for the whole fit."""
    x, y, w, init = _nn_lanes(dtype, cuda)
    stats = {}
    graph = tnn.fit(x, y, sample_weight=w, hidden=10, maxit=60, init=init, graph=True, stats=stats)
    eager = tnn.fit(x, y, sample_weight=w, hidden=10, maxit=60, init=init, graph=False)
    for a, b in zip(graph, eager):
        assert torch.equal(a, b)
    assert stats["syncs"] <= 10 and stats["capture_s"] > 0


def _svm_lanes(dtype, device, lanes=5, n=300, p=5, seed=0, edge=False):
    """The sweep's operands for ``lanes`` CV-like lanes on random stations.
    ``edge``: lane 0's responses scaled below epsilon = 0.1 (its theta never
    leaves 0) and lane 1 weighted 0 on every tenth row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) * np.array([1.0, 30.0, 2.0, 5.0, 0.5])
    y = np.sin(x[:, 0]) + 0.02 * x[:, 1] + 0.1 * rng.normal(size=n)
    w = (rng.uniform(size=(lanes, n)) > 0.1).astype(np.float64)
    if edge:
        w[1] = 1.0
        w[1, ::10] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    pairs = tuple(a.to(device) for a in tsvm.draw_sigest_pairs(lanes, n, torch.Generator().manual_seed(seed)))
    _, ys, q, diag = tsvm.sweep_inputs(t(x).expand(lanes, n, p), t(y).expand(lanes, n), t(w), pairs)
    if edge:
        ys = ys.clone()
        ys[0] = ys[0] * (0.09 / ys[0].abs().max())
    return q, ys, t(w), diag


def _k4_vs_plain(q, ys, w, diag, tol):
    before = ttsvm.LAUNCHES["svm_sweep"]
    theta, lam = ttsvm.svm_sweep_cuda(q, ys, w, diag, epochs=40)
    torch.cuda.synchronize()
    assert ttsvm.LAUNCHES["svm_sweep"] - before == 1
    ptheta, plam = ttsvm.svm_sweep_plain(q, ys, w, diag, epochs=40)
    assert float((theta - ptheta).abs().max()) <= tol and float((lam - plam).abs().max()) <= tol
    assert bool((theta.abs() <= 1.0).all()) and bool((theta[w == 0] == 0).all())
    return theta


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-9)], ids=["float32", "float64"])
@pytest.mark.parametrize("n", [300, 813, 1100])     # 10, 26 and 35 chunks of 32 rows, the last one ragged
@pytest.mark.parametrize("lanes", [5, 1, 2])        # CV-like lanes; the finals' one or two responses
def test_k4_matches_plain(cuda, dtype, tol, n, lanes):
    """K4's theta and multiplier against the plain sweep's on the same
    operands, of C (chip_smoke's SVM_TOL: the dot products are summed in
    another order), 40 sweeps."""
    _k4_vs_plain(*_svm_lanes(dtype, cuda, lanes=lanes, n=n), tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-9)], ids=["float32", "float64"])
def test_k4_edge_lanes(cuda, dtype, tol):
    """A lane whose theta never leaves 0 (responses below epsilon) stays at
    exactly 0, and a lane weighted 0 on every tenth row keeps those rows at
    0, both within the tolerance of the plain sweep."""
    q, ys, w, diag = _svm_lanes(dtype, cuda, lanes=4, n=813, edge=True)
    theta = _k4_vs_plain(q, ys, w, diag, tol)
    assert bool((theta[0] == 0).all()) and bool((theta[1, ::10] == 0).all()) and bool((theta[1] != 0).any())


def test_k4_wrapper_checks_inputs(cuda):
    q, ys, w, diag = _svm_lanes(torch.float32, cuda, lanes=2, n=64)
    with pytest.raises(TypeError, match="float64"):
        ttsvm.svm_sweep_cuda(q, ys.double(), w, diag)
    with pytest.raises(ValueError, match="shapes"):
        ttsvm.svm_sweep_cuda(q[:, :32], ys, w, diag)
    # one row beyond the shared layout's rows, and beyond the device-memory
    # layout's (expanded views: the wrapper refuses them before it copies
    # anything)
    for layout, big in (("shared", ttsvm.max_rows(torch.float32) + 1),
                        ("global", ttsvm.max_rows_global(torch.float32) + 1),
                        ("auto", ttsvm.max_rows_global(torch.float32) + 1)):
        row = torch.zeros((1, 1), device=cuda).expand(1, big)
        with pytest.raises(ValueError, match="exceed"):
            ttsvm.svm_sweep_cuda(torch.zeros((1, 1, 1), device=cuda).expand(1, big, big), row, row, row,
                                 theta=layout)
    with pytest.raises(ValueError, match="theta must be"):
        ttsvm.svm_sweep_cuda(q, ys, w, diag, theta="registers")
    assert ttsvm.svm_sweep(q, ys, w, diag, epochs=3)[0].device.type == "cuda"


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_plain_sweep_graph_equals_eager(cuda, dtype):
    """The plain sweep replayed from one captured sweep (``graph=True``)
    gives the eager plain sweep's theta and multiplier bit for bit."""
    q, ys, w, diag = _svm_lanes(dtype, cuda, lanes=3, n=200)
    eager = ttsvm.svm_sweep_plain(q, ys, w, diag, epochs=6)
    graphed = ttsvm.svm_sweep_plain(q, ys, w, diag, epochs=6, graph=True)
    for a, b in zip(eager, graphed):
        assert torch.equal(a, b)
    assert bool((eager[0] != 0).any())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_k4_global_theta_bit_identical_to_shared(cuda, dtype):
    """At the CV shape (20 lanes x 813 stations, 120 sweeps) theta in device
    memory gives the shared layout's theta and multiplier bit for bit: only
    theta's address changes."""
    q, ys, w, diag = _svm_lanes(dtype, cuda, lanes=20, n=813)
    before = ttsvm.LAUNCHES["svm_sweep"]
    shared = ttsvm.svm_sweep_cuda(q, ys, w, diag, theta="shared")
    glob = ttsvm.svm_sweep_cuda(q, ys, w, diag, theta="global")
    auto = ttsvm.svm_sweep_cuda(q, ys, w, diag)
    assert ttsvm.LAUNCHES["svm_sweep"] - before == 3
    name = str(dtype).replace("torch.", "")
    assert ttsvm.LAUNCH_LOG[-3:] == [(20, 813, name, "shared"), (20, 813, name, "global"), (20, 813, name, "shared")]
    for a, b, c in zip(shared, glob, auto):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-9)], ids=["float32", "float64"])
def test_k4_past_shared_memory_matches_plain(cuda, dtype, tol):
    """Past the shared layout's rows (and a ragged last chunk) "auto" puts
    theta in device memory, and K4 agrees with the plain sweep, 2 sweeps."""
    n = ttsvm.max_rows(dtype) + 100
    q, ys, w, diag = _svm_lanes(dtype, cuda, lanes=1, n=n)
    theta, lam = ttsvm.svm_sweep_cuda(q, ys, w, diag, epochs=2)
    assert ttsvm.LAUNCH_LOG[-1] == (1, n, str(dtype).replace("torch.", ""), "global")
    with pytest.raises(ValueError, match="exceed"):
        ttsvm.svm_sweep_cuda(q, ys, w, diag, epochs=2, theta="shared")
    ptheta, plam = ttsvm.svm_sweep_plain(q, ys, w, diag, epochs=2)
    assert float((theta - ptheta).abs().max()) <= tol and float((lam - plam).abs().max()) <= tol
    assert bool((theta != 0).any()) and bool((theta[w == 0] == 0).all())


def test_k3_on_a_random_forest_slot_loop(cuda):
    """K3 on a small 2-response random forest (heap trees of depth 6, more
    than S_MAX splits: every tree in the slot loop) against its plain
    version and against the per-tree routing of rf.predict's trees."""
    rng = np.random.default_rng(4)
    n, p = 400, 5
    x = torch.as_tensor(rng.uniform(size=(n, p)), dtype=torch.float32, device=cuda)
    y = torch.stack([x[:, 0] + torch.sin(3 * x[:, 1]), x[:, 2] * x[:, 3]])
    st = trf.fit(x, y, ntree=40, max_depth=6, generator=torch.Generator().manual_seed(1))
    trees = ttrees.Tree(*(a.reshape((80,) + a.shape[2:]).cpu() for a in st.trees))
    assert int(trees.internal.sum(1).min()) > ttforest.S_MAX
    wmat = torch.kron(torch.eye(2), torch.full((40, 1), 1.0 / 40))
    ft = ttforest.prepare_forest(trees, wmat, ttforest.build_leaf_bins(trees, n_feat=p), cuda)
    assert ft.desc.shape[0] == 0 and ft.loop_slot.numel() > 0
    cells = torch.rand((50_000, p), device=cuda) * 1.2 - 0.1
    got = ttforest.forest_predict_cuda(ft, cells)
    want = ttforest.forest_predict_plain(ft, cells)
    assert bool(((got - want).abs() <= 1e-5 * ft.wv.abs().sum(0)).all())
    batched = trf.predict(st, cells[:3000])                          # (2, m) through K3
    for j in range(2):
        routed = ttrees.forest_predict(ttrees.Tree(*(a[j] for a in st.trees)), cells[:3000], 6)
        assert float((batched[j] - routed).abs().max()) <= 1e-5 * float(y[j].abs().max())


def test_geotiff_round_trip_of_a_cuda_raster(cuda, tmp_path):
    """A float32 raster on the card written (deflate) and read back onto the
    card: bit for bit, NaN included, on the same grid."""
    import machisplin_tpu_torch as mtt

    rng = np.random.default_rng(7)
    a = torch.as_tensor((rng.standard_normal((2, 301, 517)) * 50).astype(np.float32), device=cuda)
    a[:, 10:20, 30:40] = float("nan")
    g = tgrid.GridSpec(nrows=301, ncols=517, xmin=-77.7, ymax=-5.8, dx=0.00083, dy=0.00083)
    for data in (a[0], a):
        path = str(tmp_path / f"r{data.ndim}.tif")
        mtt.write_geotiff_file(path, tgrid.Raster(data, g))
        back = mtt.read_geotiff(path, device="cuda")
        assert back.data.device.type == "cuda" and vars(back.grid) == vars(g)
        assert torch.equal(back.data.view(torch.int32), data.view(torch.int32))


def test_tiles_merge_on_the_card_matches_cpu(cuda):
    """Feathered 2 x 2 and 3 x 2 merges of float32 tiles on the card against
    the same merge of their CPU copies: within 1e-6 of max |surface|, NaN
    where NaN."""
    import machisplin_tpu_torch as mtt

    cov = mtt.synthetic_covariates(downsample=4, device="cuda")
    for ncol, nrow in ((2, 2), (3, 2)):
        ts = mtt.tiles_create(cov, mtt.load_sampling(), out_ncol=ncol, out_nrow=nrow)
        tiles = [tgrid.Raster(torch.sin(r.data[0] / 500.0) + 0.1 * i, r.grid) for i, r in enumerate(ts.rast)]
        got = mtt.tiles_merge(tiles, ts.full_grid, in_ncol=ncol, in_nrow=nrow)
        want = mtt.tiles_merge([t.to("cpu") for t in tiles], ts.full_grid, in_ncol=ncol, in_nrow=nrow)
        assert got.data.device.type == "cuda"
        g, w = got.data.cpu().numpy(), want.data.numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6 * np.nanmax(np.abs(w)), equal_nan=True)


def test_k2_cycle_with_shared_bins_tables_matches_plain(cuda):
    """The shared-bins layout of the batched gbm.step: 4 outer folds' tables
    (each binned on its training rows) repeated over their 5 inner chains,
    one 50-tree cycle against the plain version on the same tables: trees
    part only at near-ties (relative gain gap <= 1e-5), and f of chains
    whose trees all agree within 1e-5 of the residuals."""
    from machisplin_tpu_torch.models import gbm_step

    rng = np.random.default_rng(11)
    n, p, nb, f_outer, k = 813, 5, 64, 4, 5
    x = torch.as_tensor(rng.uniform(0, 1, (n, p)).astype(np.float32), device=cuda)
    y1 = (2 * x[:, 0] + torch.sin(4 * x[:, 1]) + 0.1 * torch.randn(n, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))).float()
    outer = torch.as_tensor((rng.uniform(size=(f_outer, n)) < 0.9).astype(np.float32), device=cuda)
    sel = torch.as_tensor(rng.integers(0, k, (f_outer, n)), device=cuda)
    w = ((sel[:, None, :] != torch.arange(k, device=cuda)[None, :, None]).float() * outer[:, None, :]).reshape(-1, n)
    edges, xb, tables = gbm_step._grow_inputs(x, nb, outer, repeat=k)
    assert tuple(xb.shape) == (f_outer, n, p) and tuple(tables.xbt.shape) == (f_outer * k, p, n)
    xb_c = xb.repeat_interleave(k, 0)
    y = y1[None].expand(f_outer * k, n).contiguous()
    f = ((w * y).sum(1) / w.sum(1))[:, None].expand(-1, n).contiguous()
    bags = torch.as_tensor((rng.uniform(size=(50, f_outer * k, n)) < 0.5).astype(np.float32), device=cuda) * w
    kw = dict(n_splits=25, nb=nb, min_leaf=10.0, lr=0.01)
    before = dict(ttgrow.LAUNCHES)
    got = ttgrow.gbm_tree_cycle(tables, y, f, bags, emit_tree=True, **kw)
    torch.cuda.synchronize()
    assert {k_: ttgrow.LAUNCHES[k_] - before[k_] for k_ in before} == {"tree_grow": 1, "tree_grow_trees": 50}
    agree = ttgrow.cycle_agreement(xb_c, y, f, bags, got, **kw)
    assert all(gap <= 1e-5 for _, _, gap in agree["gaps"]), agree["gaps"]
    assert agree["identical_chains"] > 0
    assert agree["max_abs_err"] <= 1e-5 * agree["resid_scale"]


def test_nystrom_on_card_matches_cpu(cuda):
    """The reduced-basis fit on the card (float64 tail by cholesky_ex, eigh
    and triangular solves there) against the same fit on the CPU: float64
    within 1e-9 of the range.  Float32 inputs at a fixed lambda against the
    port's float32 fit of the same inputs on the CPU: the streamed sums
    G = B'B, B'y and y'y within 1e-6 of their largest entry (float32
    round-off, 1.2e-7 measured on an H100), and the fitted values within
    2e-2 of the range.  B'B squares the basis' conditioning, so on this
    problem the float32 fit moves by about 1e-2 of the range with the order
    of the float32 sums alone (chunk 777 against 500: 1.1e-2 on the CPU,
    4.9e-3 on an H100; the card against the CPU 9.5e-3), as the JAX
    package's float32 fit does; its surface through K1 against the plain
    version."""
    from machisplin_tpu_torch.ops import nystrom as tnys

    rng = np.random.default_rng(0)
    n, m = 3000, 128
    coords = rng.uniform(0, 1, (n, 2))
    y = np.stack([np.sin(6 * coords[:, 0]) * np.cos(5 * coords[:, 1]), coords[:, 0]], 1) + 0.1 * rng.normal(size=(n, 2))
    lm = coords[np.random.default_rng(1).choice(n, m, replace=False)]
    cpu = tnys.nystrom_tps_fit(torch.as_tensor(coords), torch.as_tensor(y), landmarks=lm, chunk=777, device="cpu")
    gpu = tnys.nystrom_tps_fit(torch.as_tensor(coords, device=cuda), torch.as_tensor(y, device=cuda),
                               landmarks=lm, chunk=777)
    span = float(np.ptp(y))
    assert torch.allclose(gpu.lam.cpu(), cpu.lam, rtol=1e-12)
    assert float((gpu.fitted.cpu() - cpu.fitted).abs().max()) <= 1e-9 * span
    c32, y32 = torch.as_tensor(coords, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    cpu32 = tnys.nystrom_tps_fit(c32, y32, landmarks=lm, lam=1e-4, chunk=777, device="cpu")
    f32 = tnys.nystrom_tps_fit(c32.to(cuda), y32.to(cuda), landmarks=lm, lam=1e-4, chunk=777)
    assert f32.fitted.dtype == cpu32.fitted.dtype == torch.float32
    xs = (c32 - c32.amin(0)) / (c32.amax(0) - c32.amin(0))
    want = tnys._stream_stats(xs, y32, cpu32.knots, 777)
    got = tnys._stream_stats(xs.to(cuda), y32.to(cuda), cpu32.knots.to(cuda), 777)
    for a, b in zip(got, want):
        assert float((a.cpu() - b).abs().max()) <= 1e-6 * float(b.abs().max())
    assert float((f32.fitted.cpu() - cpu32.fitted).abs().max()) <= 2e-2 * span
    g = tgrid.GridSpec(nrows=50, ncols=70, xmin=0.0, ymax=1.0, dx=1 / 70, dy=1 / 50)
    tab = ttg.grid_tables(gpu, g, torch.float32)
    got, want = ttg.tps_grid_cuda(tab, g), ttg.tps_grid_plain(tab, g)
    assert float((got - want).abs().max()) <= 2e-4 * float(want.abs().max())


def test_rf_forests_do_not_depend_on_the_lane_count(cuda):
    """The RF's (response x fold) forests at the north-star CV's shape (813
    stations, 3 covariates, 10 lanes of 500 trees) grown in one call, five
    lanes a call (a rank's share of two) and one a call: bit for bit."""
    gen = torch.Generator().manual_seed(0)
    n, p, lanes, ntree = 813, 3, 10, 500
    x = torch.rand((n, p), generator=gen).to(cuda)
    y = (torch.sin(4 * x[:, 0]) + x[:, 1] * x[:, 2])[None] + 0.1 * torch.randn((lanes, n), generator=gen).to(cuda)
    w = (torch.rand((lanes, n), generator=gen) > 0.1).float().to(cuda)
    counts, scores = trf.draw(w, p, ntree=ntree, generator=gen)

    def grow(a, b):
        st = trf.fit(x, y[a:b], sample_weight=w[a:b], boot_counts=counts[a:b], scores=scores[a:b], ntree=ntree)
        return [st.train_pred, *st.trees]

    whole = grow(0, lanes)
    for step in (5, 1):
        parts = [grow(a, a + step) for a in range(0, lanes, step)]
        for k, want in enumerate(whole):
            got = torch.cat([part[k] for part in parts])
            assert torch.equal(got.view(-1).view(torch.uint8), want.view(-1).view(torch.uint8)), (step, k)


def test_mesh_on_the_card_matches_unsharded(cuda, tmp_path):
    """Two gloo ranks on the card (``tests/torch_mesh_cases.py``): K2 over
    9 boosting chains (3 outer x 3 inner folds), K3 over a raster's cells,
    K4 over the SVM's 8 lanes and the RF's 8 forests, each rank's share
    gathered, bit for bit against the same calls without a mesh; every
    rank the same."""
    import torch_mesh_cases as cases

    from machisplin_tpu_torch.kernels.build import build_all

    build_all()                         # once, before the ranks start
    names = ["gbm_outer", "forest_cells", "cv_v", "cv_r"]
    (tmp_path / "ranks").mkdir()
    ranks = cases.ranks_done(cases.start_ranks(2, names, tmp_path / "ranks", device="cuda"))
    ref = cases.unsharded_done(cases.start_unsharded(names, tmp_path, device="cuda"))
    for name in names:
        for key, want in ref[name].items():
            for r, got in enumerate(ranks):
                a, b = torch.as_tensor(got[name][key]).cpu(), torch.as_tensor(want).cpu()
                assert a.dtype == b.dtype and torch.equal(a.view(-1).view(torch.uint8), b.view(-1).view(torch.uint8)), \
                    f"{name}/{key} on rank {r}"


def test_native_decoder_reads_onto_the_card(cuda, tmp_path, monkeypatch):
    """A GeoTIFF read onto the card through the host library's decoder is
    the pure-Python codec's read, bit for bit."""
    from machisplin_tpu_torch.io import geotiff, native

    assert native.load_native() is not None
    g = tgrid.GridSpec(nrows=300, ncols=200, xmin=0.0, ymax=1.0, dx=0.01, dy=0.01)
    data = torch.randn(300, 200, generator=torch.Generator().manual_seed(0))
    path = str(tmp_path / "a.tif")
    geotiff.write_geotiff_file(path, tgrid.Raster(data.to(cuda), g))
    got = geotiff.read_geotiff(path, device="cuda")
    monkeypatch.setattr(native, "load_native", lambda: None)        # the pure-Python codec
    want = geotiff.read_geotiff(path, device="cuda")
    assert got.data.is_cuda and torch.equal(got.data.view(torch.int32), want.data.view(torch.int32))
    assert torch.equal(got.data.cpu(), data)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.float64, 1e-9)], ids=["float32", "float64"])
def test_svm_lanes_at_the_card_bound_equal_one_lane_fits(cuda, dtype, tol):
    """``svm.fit`` bounds a chunk of lanes by its CUDA constant
    (``base.chunk_elems``): 8 lanes of 3,000 stations, 2 chunks under the
    CPU's bound, sweep in one K4 launch, and each lane equals its own
    one-lane fit (theta and bias within the K4 tolerance of C, predictions
    within what those differences allow; the lanes' operands are computed
    at another batch width)."""
    gen = torch.Generator().manual_seed(0)
    n, p, lanes = 3000, 3, 8
    assert tsvm._LANE_ELEMS // (n * n) < lanes <= chunk_elems(tsvm._LANE_ELEMS, dtype, cuda, tsvm._LANE_BYTES_CUDA) // (n * n)
    x = torch.rand((n, p), generator=gen, dtype=torch.float64)
    y = torch.sin(4 * x[:, 0])[None] + x[:, 1] * x[:, 2] + 0.1 * torch.randn((lanes, n), generator=gen,
                                                                                dtype=torch.float64)
    w = (torch.rand((lanes, n), generator=gen) > 0.1).double()
    pairs = tsvm.draw_sigest_pairs(lanes, n, gen)
    x, y, w = (a.to(cuda, dtype) for a in (x, y, w))
    before = ttsvm.LAUNCHES["svm_sweep"]
    whole = tsvm.fit(x, y, sample_weight=w, pairs=pairs, epochs=40)
    assert ttsvm.LAUNCHES["svm_sweep"] - before == 1
    q = x[:500]
    pw = tsvm.predict(whole, q)
    for j in range(lanes):
        one = tsvm.fit(x, y[j], sample_weight=w[j], pairs=tuple(a[j] for a in pairs), epochs=40)
        assert float((whole.theta[j] - one.theta).abs().max()) <= tol
        assert abs(float(whole.bias[j] - one.bias)) <= tol
        # |K| <= 1, so a prediction moves by at most sum |d theta| + |d bias| (scaled)
        moved = float((whole.theta[j] - one.theta).abs().sum() + (whole.bias[j] - one.bias).abs())
        assert float((pw[j] - tsvm.predict(one, q)).abs().max()) <= (moved + tol) * float(one.y_scale)


def test_rf_chunks_at_the_card_bound_grow_the_forests_of_the_cpu_bound(cuda, monkeypatch):
    """``trees.grow_level_trees`` chunks its trees by its CUDA constant
    (``base.chunk_elems``): 2 forests of 500 trees on 3,000 rows grown
    with it and with the CPU's bound.  The histograms are summed in other
    matrix shapes, so a tree may part at a near-tie: at least 99 % of the
    trees route every row alike, and the training predictions agree within
    1e-3 of the response range."""
    gen = torch.Generator().manual_seed(1)
    n, p, lanes, ntree = 3000, 3, 2, 500
    x = torch.rand((n, p), generator=gen).to(cuda)
    y = (torch.sin(4 * x[:, 0]) + x[:, 1] * x[:, 2])[None] + 0.1 * torch.randn((lanes, n), generator=gen).to(cuda)
    w = (torch.rand((lanes, n), generator=gen) > 0.9).float().to(cuda)       # an inverted CV's one fold
    counts, scores = trf.draw(w, p, ntree=ntree, generator=gen)
    assert chunk_elems(ttrees._LEVEL_ELEMS, torch.float32, cuda, ttrees._LEVEL_BYTES_CUDA) > ttrees._LEVEL_ELEMS

    def grow():
        return trf.fit(x, y, sample_weight=w, boot_counts=counts, scores=scores, ntree=ntree)

    card = grow()
    monkeypatch.setattr(ttrees, "chunk_elems", lambda cpu_elems, dtype, device, cuda_bytes: cpu_elems)
    cpu_bound = grow()
    leaves = lambda st: ttrees.tree_assign(ttrees.Tree(*(a.reshape((-1,) + a.shape[2:]) for a in st.trees)), x, 9)
    same = (leaves(card) == leaves(cpu_bound)).all(1).float().mean()
    assert float(same) >= 0.99
    span = float(y.max() - y.min())
    assert float((card.train_pred - cpu_bound.train_pred).abs().max()) <= 1e-3 * span
