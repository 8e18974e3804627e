"""Boosted regression trees: the fitted state, prediction and importance
(counterpart of ``machisplin_tpu/models/brt.py``).

A BRT is gaussian gbm boosting: F0 = weighted mean, then trees of a fixed
split budget (interaction.depth) fitted to the residuals of bagged rows and
added with shrinkage (V73:247/493).  The states here are grown by the
batched gbm.step (``models/gbm_step.py``) on kernel K2; the vmapped
single-model ``fit`` of the JAX package is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.forest import forest_predict_bins
from .trees import Tree, forest_predict

__all__ = ["BRTState", "predict", "importance"]


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
