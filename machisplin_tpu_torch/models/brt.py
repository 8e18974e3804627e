"""Boosted regression trees: fit, the fitted state, prediction and importance
(counterpart of ``machisplin_tpu/models/brt.py``).

A BRT is gbm boosting: F0 = the family's intercept-only fit, then trees of a
fixed split budget (interaction.depth) fitted to the negative gradient on
bagged rows and added with shrinkage (V73:247/493).  ``fit`` grows one
model's trees on kernel K2 (``ops/tree_grow.gbm_tree_cycle``; its plain
version on the CPU): gaussian chains in cycles of up to ``STEP_SIZE`` trees
a launch, other families one tree a launch, with the leaves re-estimated
for the family (``families.leaf_adjust``).  The batched gbm.step
(``models/gbm_step.py``) grows many states at once on the same kernel.
Chains are float32, as K2's are.

Randomness can be injected: ``bags`` gives each tree's 0/1 bag draw (the JAX
package's threefry draws cannot be made in torch; the parity tests rebuild
them and pass them in).  Otherwise the draws come from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.forest import forest_predict_bins
from ..ops.tree_grow import gbm_tree_cycle, prepare_bins
from .base import as_weight
from .deviance import calc_deviance
from .families import check_family, f0_init, gradient, leaf_adjust, response
from .trees import Tree, bin_data, edges_lookup, forest_predict, make_bins, route_bins

__all__ = ["BRTState", "STEP_SIZE", "fit", "predict", "importance"]

# trees a K2 launch grows (gbm.step's step.size)
STEP_SIZE = 50


class BRTState(NamedTuple):
    trees: Tree           # stacked, leading axis = n_trees (budget)
    edges: torch.Tensor   # (p, nb - 1) bin edges
    f0: torch.Tensor      # () initial prediction
    lr: torch.Tensor      # ()
    n_splits: int
    tree_active: torch.Tensor  # (n_trees,) 1.0 for trees inside best.trees
    train_deviance: torch.Tensor  # (n_trees,) in-bag gaussian deviance path
    holdout_deviance: torch.Tensor  # (n_trees,) deviance on sample_weight == 0 rows
    train_fit: torch.Tensor  # (n,) boosted fit at the training rows (active trees only)


def _seed(generator: torch.Generator | None) -> int:
    return int(torch.randint(0, 2**62, (1,), generator=generator))


def _random_bags(generator, bag_fraction: float, shape, device, block: int):
    """The default ``bags``: tree t's 0/1 bag mask of ``shape``, drawn
    ``block`` trees at a time on ``device`` from a generator seeded by
    ``generator``.  Trees are asked for in order."""
    g = torch.Generator(device=device)
    g.manual_seed(_seed(generator))
    state = {"t0": None, "draw": None}

    def bags(t: int) -> torch.Tensor:
        t0 = t - t % block
        if state["t0"] != t0:
            state["t0"] = t0
            state["draw"] = torch.rand((block,) + tuple(shape), generator=g, device=device) < bag_fraction
        return state["draw"][t - t0]

    return bags


def _stack_bags(bags, t0: int, count: int, shape, device, weights) -> torch.Tensor:
    """(count, C, n) row weights of trees t0 .. t0 + count - 1: each tree's
    bag draw ``bags(t)`` as float32 times ``weights``."""
    draws = torch.stack([torch.as_tensor(bags(t0 + i), device=device).reshape(shape).to(torch.float32)
                         for i in range(count)])
    return draws * weights


def family_tree(tables, xb, y, f, bag, *, family: str, n_splits: int, nb: int, min_leaf: float, monotone=None):
    """One tree of every chain for a non-gaussian family: K2 (its plain
    version on the CPU) grows the least-squares tree of the gradient, with f
    = 0 and its f_out unused; each training row is routed to its node by its
    bins, and the leaves are re-estimated for the family.  y/f/bag (C, n)
    float32, ``tables`` and ``xb`` the chains' bins.  Returns the tree
    arrays (feat, thr_bin, internal, left, right, value, var_gain), each
    (C, .), and cur (C, n)."""
    z = gradient(y, f, family).contiguous()
    out = gbm_tree_cycle(tables, z, torch.zeros_like(z), bag[None].contiguous(), n_splits=n_splits, nb=nb,
                         min_leaf=min_leaf, lr=1.0, emit_tree=True, monotone=monotone)
    feat, thr, internal, left, right, value, vg = (a[0] for a in out.trees)
    cur = route_bins(xb, feat, thr, internal, left, right, n_splits)
    value = leaf_adjust(value.to(f.dtype), cur, 2 * n_splits + 1, y, f, bag, family)
    return (feat, thr, internal, left, right, value, vg), cur


def fit(
    x, y, *, sample_weight=None, n_trees: int = 1000, n_splits: int = 5, lr: float = 0.01,
    bag_fraction: float = 0.5, min_leaf: float = 10.0, n_bins: int = 64, n_trees_active=None, edges=None, xb=None,
    family: str = "gaussian", offset=None, var_monotone=None, bags: Callable | None = None,
    generator: torch.Generator | None = None,
) -> BRTState:
    """Train one BRT of ``n_trees`` trees; with ``n_trees_active``, later
    trees still train but add nothing (gbm_step's refit budget).

    ``family``: gaussian / laplace / poisson / bernoulli (gbm's
    distribution, V73:1773); the deviance paths are on the response scale.
    ``offset``: (n,) fixed link-scale term per row (V73:1664/1774), carried
    by the boosted score (``train_fit`` and the deviance paths include it)
    but not added by ``predict``, as ``predict.gbm``.  ``var_monotone``: (p,)
    in {-1, 0, +1}, gbm's monotone constraint per predictor (V73:1670/1772).
    ``bags(t)`` gives tree t's (n,) 0/1 bag draw (drawn from ``generator``
    when None), multiplied by ``sample_weight``.  Bins default to full-data
    quantiles (``make_bins``) whatever the weights, as the JAX package's."""
    family = check_family(family)
    x = torch.as_tensor(x)
    dev_, dt, f32 = x.device, x.dtype, torch.float32
    n = x.shape[0]
    y32 = torch.as_tensor(y, device=dev_).to(f32)[None].contiguous()           # (1, n)
    w = as_weight(sample_weight, (n,), f32, dev_)[None]
    if edges is None:
        edges = make_bins(x, n_bins)
    if xb is None:
        xb = bin_data(x, edges)
    nb = edges.shape[1] + 1
    off = None if offset is None else torch.as_tensor(offset, device=dev_).to(f32)
    mono = None if var_monotone is None else torch.as_tensor(var_monotone, device=dev_).to(f32).contiguous()
    f0 = f0_init(y32[0], w[0], family, offset=off)
    if n_trees_active is None:
        n_trees_active = n_trees
    act = (torch.arange(n_trees, device=dev_) < int(n_trees_active)).to(f32)
    test_w = (w <= 0).to(f32)
    if bags is None:
        bags = _random_bags(generator, bag_fraction, (n,), dev_, STEP_SIZE)
    tables = prepare_bins(xb, nb)
    kw = dict(n_splits=n_splits, nb=nb, min_leaf=min_leaf, monotone=mono)
    f = (f0.expand(1, n) if off is None else f0 + off[None]).contiguous()
    parts = []
    if family == "gaussian":
        dev_w = torch.stack([w, test_w]).contiguous()
        for t0 in range(0, n_trees, STEP_SIZE):
            count = min(STEP_SIZE, n_trees - t0)
            a = act[t0 : t0 + count]
            out = gbm_tree_cycle(tables, y32, f, _stack_bags(bags, t0, count, (1, n), dev_, w), lr=lr,
                                 scale=None if bool(a.all()) else a[:, None].contiguous(), emit_tree=True,
                                 deviance_w=dev_w, **kw)
            f = out.f
            parts.append(out.trees + (out.deviance[:, 0, 0], out.deviance[:, 0, 1]))
        arrs = [torch.cat([pt[k] for pt in parts]) for k in range(9)]
        trees = [a[:, 0] for a in arrs[:7]]
        train_dev = arrs[7] / w.sum().clamp_min(1e-12)
        hold_dev = arrs[8] / test_w.sum().clamp_min(1e-12)
    else:
        devs = []
        for t in range(n_trees):
            bag = torch.as_tensor(bags(t), device=dev_).reshape(1, n).to(f32) * w
            tree, cur = family_tree(tables, xb, y32, f, bag, family=family, **kw)
            f = f + lr * tree[5].gather(1, cur) * act[t]
            u = response(f, family)
            devs.append(torch.cat([calc_deviance(y32, u, w, family), calc_deviance(y32, u, test_w, family)]))
            parts.append(tree)
        trees = [torch.cat([pt[k] for pt in parts]) for k in range(7)]
        train_dev, hold_dev = torch.stack(devs).T
    feat, thr_bin, internal, left, right, value, vg = trees
    return BRTState(
        trees=Tree(feat=feat.long(), thr=edges_lookup(edges, feat, thr_bin).to(dt), internal=internal.to(dt),
                   left=left.long(), right=right.long(), value=value.to(dt), var_gain=vg.to(dt)),
        edges=edges, f0=f0.to(dt), lr=torch.tensor(lr, dtype=dt, device=dev_), n_splits=n_splits,
        tree_active=act.to(dt), train_deviance=train_dev.to(dt), holdout_deviance=hold_dev.to(dt),
        train_fit=f[0].to(dt),
    )


def predict(state: BRTState, x, n_trees=None, tables=None) -> torch.Tensor:
    """F0 + lr * sum of the active trees (optionally only the first
    ``n_trees``).  With ``tables`` (``ops.forest.build_leaf_bins`` of the
    state's trees) the forest predictor runs: kernel K3 on CUDA inputs, its
    plain version on CPU inputs; so do CUDA inputs without tables, after a
    table walk.  CPU inputs without tables route through the trees."""
    x = torch.as_tensor(x)
    act = state.tree_active.to(x.device)
    if n_trees is not None:
        act = act * (torch.arange(act.shape[0], device=x.device) < n_trees)
    weights = act * state.lr.to(x.device)
    f0 = state.f0.to(x.device)
    if tables is not None or x.device.type == "cuda":
        return f0 + forest_predict_bins(state.trees, x, weights, tables=tables).to(x.dtype)
    trees = Tree(*(a.to(x.device) for a in state.trees))
    return f0 + forest_predict(trees, x, int(state.n_splits), weights=weights)


def importance(state: BRTState, names) -> dict:
    """gbm relative influence: split-gain totals per variable scaled to sum
    to 100 (``summary.gbm`` / gbm.step ``$contributions``, V73:495/2115)."""
    gains = (state.trees.var_gain * state.tree_active[:, None]).sum(0)
    rel = 100.0 * gains / gains.sum().clamp_min(1e-12)
    order = torch.argsort(-rel, stable=True)
    return {names[int(j)]: float(rel[int(j)]) for j in order}
