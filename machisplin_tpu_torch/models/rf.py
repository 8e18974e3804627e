"""Random forest regression (counterpart of ``machisplin_tpu/models/rf.py``).

Mirrors the reference's ``randomForest::randomForest(mod.form, data)``
(V73:248 CV; V73:517 final with ``importance=TRUE``) as the JAX package
does: ntree = 500, mtry = max(floor(p/3), 1), nodesize 5, bootstrap
sampling with replacement, trees grown level-wise to ``max_depth`` on global
64-bin histograms (``models/trees.grow_level_trees``); the importance matrix
has %IncMSE (out-of-bag permutation) and IncNodePurity (summed split gain)
(V73:519).

Forests are batched over a leading lane axis: ``y`` and ``sample_weight``
(n,) for one forest or (L, n) for L forests on the same ``x`` (CV folds,
responses); all L x ntree trees grow in one call.  The bootstrap counts and
the per-node feature scores are injectable (``boot_counts``, ``scores``),
else drawn on the CPU from a ``torch.Generator``.

``predict`` averages the trees through ``ops/forest`` (kernel K3 on the
card, its plain version on the CPU); the port has no host tree predictor.
The CV reads ``RFState.train_pred``, the training rows' predictions from the
growers' own node assignments.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.forest import forest_predict_bins
from .base import as_weight
from .trees import (
    Tree, assigned_predict, bin_data, draw_mtry_scores, flat_bin_cum_onehot, grow_level_trees, make_bins,
    tree_assign,
)

__all__ = ["RFState", "fit", "predict", "importance", "draw_bootstrap", "draw", "lane"]

NTREE = 500
MAX_DEPTH = 9


class RFState(NamedTuple):
    trees: Tree               # (..., T, N) arrays, heap layout
    edges: torch.Tensor       # (p, n_bins - 1)
    max_depth: int
    oob_count: torch.Tensor   # (..., T, n) scaled bootstrap counts (0 => out of bag)
    train_pred: torch.Tensor  # (..., n) all-tree mean prediction at the training rows


def lane(state: RFState, j: int) -> RFState:
    """Lane ``j`` of a batched state."""
    return RFState(Tree(*(a[j] for a in state.trees)), state.edges, state.max_depth, state.oob_count[j],
                   state.train_pred[j])


def draw_bootstrap(w, ntree: int, generator: torch.Generator | None = None) -> torch.Tensor:
    """Bootstrap counts (L, ntree, n), float64 on the CPU: each tree draws n
    rows with replacement, uniformly from its lane's rows with w > 0."""
    w = torch.as_tensor(w).cpu()
    n_lanes, n = w.shape
    counts = torch.zeros((n_lanes, ntree, n), dtype=torch.float64)
    for j in range(n_lanes):
        active = torch.nonzero(w[j] > 0).flatten()
        if active.numel() == 0:
            continue
        draws = active[torch.randint(0, active.numel(), (ntree, n), generator=generator)]
        counts[j].scatter_add_(1, draws, torch.ones((ntree, n), dtype=torch.float64))
    return counts


def draw(w, p: int, *, ntree: int = NTREE, mtry: int | None = None, max_depth: int = MAX_DEPTH,
         boot_counts=None, scores=None, generator: torch.Generator | None = None, **fit_kw):
    """The draws of ``fit`` for L forests with row weights ``w`` (L, n) over
    p features, in its order: bootstrap counts (L, ntree, n), then node
    feature scores (L, ntree, 2^max_depth - 1, p) where mtry < p (else
    None).  A draw passed in is kept and not made.  ``fit``'s other
    keywords are accepted and ignored, so its keywords pass as they are."""
    n_lanes = w.shape[0]
    mtry = max(p // 3, 1) if mtry is None else mtry
    if boot_counts is None:
        boot_counts = draw_bootstrap(w, ntree, generator)
    if scores is None and mtry < p:
        scores = draw_mtry_scores(n_lanes * ntree, max_depth, p, generator).reshape(n_lanes, ntree, -1, p)
    return boot_counts, scores


def fit(x, y, *, sample_weight=None, ntree: int = NTREE, mtry: int | None = None, max_depth: int = MAX_DEPTH,
        min_leaf: float = 5.0, n_bins: int = 64, boot_counts=None, scores=None,
        generator: torch.Generator | None = None) -> RFState:
    """Grow ``ntree`` trees per lane; a lane's forest does not depend on
    how many lanes grow with it.  ``boot_counts`` (L, ntree, n) raw
    bootstrap counts and ``scores`` (L, ntree, 2^max_depth - 1, p) node
    feature scores (for one forest without the L axis) inject the draws,
    else ``draw`` makes them; the counts are scaled by n_active / n.  A single forest's state has no
    lane axis."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    single = y.dim() == 1
    if single:
        y = y[None]
    n_lanes, n = y.shape
    p = x.shape[1]
    dev, dtype = x.device, x.dtype
    w = as_weight(sample_weight, (n_lanes, n), dtype, dev)
    w = w.expand(n_lanes, n) if w.dim() == 1 else w
    if mtry is None:
        mtry = max(p // 3, 1)
    edges = make_bins(x, n_bins)
    xb = bin_data(x, edges)
    c1h = flat_bin_cum_onehot(xb, n_bins)          # shared by all trees
    n_active = (w > 0).sum(-1).to(dtype).clamp_min(1.0)
    boot_counts, scores = draw(w, p, ntree=ntree, mtry=mtry, max_depth=max_depth, boot_counts=boot_counts,
                               scores=scores, generator=generator)
    counts = torch.as_tensor(boot_counts).to(device=dev, dtype=dtype).reshape(n_lanes, ntree, n)
    # keep the expected sample count equal to the active-row count
    counts = counts * (n_active / n)[:, None, None]
    if scores is not None:
        scores = torch.as_tensor(scores).reshape(n_lanes * ntree, 2**max_depth - 1, p)
    tree, cur = grow_level_trees(
        xb, edges, y.repeat_interleave(ntree, dim=0), counts.reshape(n_lanes * ntree, n), max_depth=max_depth,
        min_leaf=min_leaf, mtry=mtry, scores=scores, generator=generator, bin_cum1h=c1h, block=ntree,
    )
    # a forest at a time, so a lane's mean does not depend on the lane count
    assigned = assigned_predict(tree.value, cur).reshape(n_lanes, ntree, n)
    train_pred = torch.stack([a.mean(0) for a in assigned])
    trees = Tree(*(a.reshape((n_lanes, ntree) + a.shape[1:]) for a in tree))
    state = RFState(trees=trees, edges=edges, max_depth=max_depth, oob_count=counts, train_pred=train_pred)
    return lane(state, 0) if single else state


def predict(state: RFState, x, tables=None) -> torch.Tensor:
    """Mean tree prediction at the (m, p) points ``x``: (m,) for one forest,
    (L, m) for a batch, through the forest predictor (K3 on the card) with
    weights 1/T; ``tables`` (``ops.forest.build_leaf_bins`` of the trees)
    reuses one table walk.  Computed in float32, K3's type."""
    single = state.trees.feat.dim() == 2
    trees = state.trees if single else Tree(*(a.reshape((-1,) + a.shape[2:]) for a in state.trees))
    t = state.trees.feat.shape[-2]
    if single:
        weights = torch.full((t,), 1.0 / t, dtype=torch.float32)
    else:
        n_lanes = state.trees.feat.shape[0]
        weights = torch.kron(torch.eye(n_lanes), torch.full((t, 1), 1.0 / t))     # (L T, L)
    out = forest_predict_bins(trees, x, weights, tables=tables)
    return out if single else out.T


def importance(state: RFState, x, y, names, perms=None, generator: torch.Generator | None = None,
               sample_weight=None) -> dict:
    """randomForest's importance matrix for one forest: %IncMSE (each
    feature's rows permuted, the trees' out-of-bag MSE increase over its
    mean out-of-bag MSE, in %) and IncNodePurity (summed split gain).
    ``perms`` (p, n) injects the permutations, else drawn from ``generator``
    (default: seeded 1313)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    n, p = x.shape
    w = as_weight(sample_weight, n, x.dtype, x.device)
    trees = state.trees
    purity = trees.var_gain.sum(0)
    oob_w = (state.oob_count == 0).to(x.dtype) * w                    # (T, n)
    oob_n = oob_w.sum(1).clamp_min(1e-12)
    value = trees.value.to(x.dtype)

    def tree_oob_mse(xs):
        pred = value.gather(1, tree_assign(trees, xs, state.max_depth))
        return (oob_w * (pred - y) ** 2).sum(1) / oob_n

    base = tree_oob_mse(x)
    if perms is None:
        g = generator if generator is not None else torch.Generator().manual_seed(1313)
        perms = torch.stack([torch.randperm(n, generator=g) for _ in range(p)])
    perms = torch.as_tensor(perms, device=x.device).long()
    inc = []
    for j in range(p):
        xp = x.clone()
        xp[:, j] = x[perms[j], j]
        inc.append((tree_oob_mse(xp) - base).mean())
    denom = base.mean().clamp_min(1e-12)
    return {nme: {"%IncMSE": float(100.0 * inc[j] / denom), "IncNodePurity": float(purity[j])}
            for j, nme in enumerate(names)}
