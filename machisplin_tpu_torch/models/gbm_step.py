"""gbm.step: CV-based selection of the boosted-tree count (counterpart of
``machisplin_tpu/models/gbm_step.py``).

The selection rules are those of the vendored Elith/Leathwick gbm.step
(machisplin.gbm.step, V73:1660-2239):

* k-fold selector: rep(1..n_folds) over the rows, randomly shuffled
  (V73:1749-1751), prevalence-stratified for bernoulli (V73:1736-1748);
* boosting grown in ``step_size``-tree cycles, recording the mean holdout
  deviance of the fold models at each checkpoint (V73:1884-1967);
* the "restart with a smaller learning rate" rule when holdout deviance
  rises within the first 4 cycles (V73:1948-1955), automated at lr/2;
* stop when the mean of the last 10 checkpoints improves on the
  overlapping 11 before them by no more than ``tolerance`` (auto = 0.001 x
  the mean total deviance, V73:1957-1961), or at ``max_trees``;
* best.trees = the first checkpoint at the minimum (V73:1978-1983), then a
  refit on the training rows with best.trees trees (V73:2100-2124), and the
  CV and self statistics blocks (V73:2014-2096, 2115-2152).

Two drivers, both on kernel K2 (``ops/tree_grow.gbm_tree_cycle``):

* ``fit``, the serial gbm.step of one response: families gaussian /
  laplace / poisson / bernoulli, ``offset``, ``fold_vector`` and
  ``var_monotone``.  Its K fold models are K2 chains, each on a bin table
  of its own training rows (the reference's per-fold ``gbm::gbm`` calls);
  gaussian chains grow a cycle of ``step_size`` trees a launch, other
  families one tree a launch with their leaves re-estimated.  The final
  model is ``brt.fit`` on full-data bins.
* the batched ones, ``fit_outer_batched`` (run_cv's letter b) and
  ``fit_multi`` (mltps's finals for several responses), gaussian: one K2
  launch advances every chain (outer fold x inner fold, or response x inner
  fold) by a cycle.  By default every chain grows on ONE table of full-data
  quantile bins, the JAX package's ``global_bins`` deviation.  With
  ``global_bins=False`` the chains take the reference's per-fold binning:
  ``shared_bins=True`` bins each outer chain on its own training rows and
  its K inner chains share that table; ``shared_bins=False`` bins every
  chain on its own inner training rows.  K2 reads one table per chain, so
  the shared tables are repeated over their inner chains (C x n x p bytes).
  The final refits of ``fit_outer_batched`` then bin each outer fold on its
  training rows; ``fit_multi``'s rows all train, so its refits keep the one
  full-data table.

Chains are float32, as K2's are.  Randomness can be injected: ``selector=``
/ ``selectors=`` fix the fold memberships and ``bags=`` the bag draws (the
JAX package's threefry streams cannot be drawn in torch; the parity tests
rebuild them and pass them in).  Otherwise both come from a
``torch.Generator``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple

import numpy as np
import torch

from ..ops.tree_grow import gbm_tree_cycle, prepare_bins
from . import brt
from .brt import STEP_SIZE, _random_bags, _seed, _stack_bags, family_tree
from .deviance import calc_deviance
from .families import check_family, f0_init, response
from .trees import Tree, bin_data, edges_lookup, make_bins, make_bins_masked

__all__ = [
    "GBMStepResult", "MultiCurve", "stopping_fired", "best_trees_from_curve",
    "fit_outer_batched", "fit_multi", "fit", "predict", "importance",
]

class GBMStepResult(NamedTuple):
    final: brt.BRTState
    best_trees: int
    trees_fitted: int            # how many trees the CV loop actually grew
    cv_deviance: torch.Tensor    # (max_checkpoints,) mean holdout deviance (inf = not reached)
    cv_deviance_se: torch.Tensor  # (max_checkpoints,) between-fold standard errors
    family: str = "gaussian"
    learning_rate: float | None = None   # rate actually used (after restarts)
    restarts: int = 0                    # automated lr/2 restarts (V73:1948-1955)
    selector: np.ndarray | None = None   # (n,) fold membership (keep.fold.vector)
    training_deviance: Any = None        # (max_checkpoints,) mean train deviance
    fitted: Any = None                   # (n,) final-model fitted values (response scale)
    residuals: Any = None                # (n,) family-correct residuals (V73:2134-2151)
    fitted_vars: Any = None              # (n,) between-fold variance of fitted values
    fold_fit: Any = None                 # (n,) held-out linear predictor at best.trees
    self_statistics: Any = None          # V73:2190-2192
    cv_statistics: Any = None            # V73:2194-2197
    # fit and fit_multi(statistics=True) fill the last seven


class MultiCurve(NamedTuple):
    stopped: np.ndarray           # (F,) stopping checkpoint per outer chain
    dev: np.ndarray               # (max_cp, F, K) holdout deviance (inf pad), float64
    edges: torch.Tensor           # (p, nb - 1) global bins; (F, p, nb - 1) shared; (F, K, p, nb - 1) per fold
    xb: torch.Tensor              # (n, p) binned data; (F, n, p) shared; (F, K, n, p) per fold
    tdev: np.ndarray | None = None   # with keep_fhist: (cycles, F, K) train deviance, float32
    fhist: np.ndarray | None = None  # with keep_fhist: (cycles, F, K, n) link-scale fits, float32


def stopping_fired(mean_curve, tolerance, win: int = 10):
    """The reference's stopping test at the LAST checkpoint of ``mean_curve``
    (V73:1957-1961): with j checkpoints, test1 = mean of the last ``win``,
    test2 = mean of the ``win + 1`` before and overlapping them; fires when
    test2 - test1 <= tolerance, armed once 2 * win checkpoints exist.
    ``mean_curve`` (ncp, ...); returns (...) bool."""
    mean_curve = np.asarray(mean_curve)
    ncp = mean_curve.shape[0]
    if ncp < 2 * win:
        return np.zeros(mean_curve.shape[1:], bool)
    test1 = mean_curve[ncp - win :].mean(axis=0)
    test2 = mean_curve[ncp - 2 * win : ncp - win + 1].mean(axis=0)
    return (test2 - test1) <= tolerance


def best_trees_from_curve(mean_curve, stopped, step_size: int) -> int:
    """best.trees: the first checkpoint at the minimum mean holdout deviance
    among those grown before stopping (V73:1978-1983)."""
    j_f = max(int(stopped), 1)
    return (int(np.argmin(np.asarray(mean_curve)[:j_f])) + 1) * step_size


def _make_selector(generator, y, w, n_folds, *, family="gaussian", prev_stratify=True):
    """Fold membership, host-side: rep(0..k-1) shuffled over the active rows
    (V73:1749-1751), within the presence and the absence rows apart for
    bernoulli (prevalence stratification, V73:1736-1748), then over the
    inactive ones.  The shuffle is numpy's, seeded from ``generator``."""
    y = np.asarray(y)
    w = np.asarray(w)
    rng = np.random.default_rng(_seed(generator))
    selector = np.zeros(y.shape[0], np.int32)

    def assign(mask):
        m = int(mask.sum())
        if m:
            selector[mask] = (np.arange(m) % n_folds).astype(np.int32)[rng.permutation(m)]

    active = w > 0
    if prev_stratify and family == "bernoulli":
        assign(active & (y == 1))
        assign(active & (y == 0))
    else:
        assign(active)
    assign(~active)
    return selector


def _draw_selectors(generator, w_outer, n_folds):
    """(F, n) fold memberships, one per outer chain: rep(0..k-1) over the
    rows ordered by a uniform draw, inactive rows last."""
    f_outer, n = w_outer.shape
    g = torch.Generator(device=w_outer.device)
    g.manual_seed(_seed(generator))
    u = torch.rand((f_outer, n), generator=g, device=w_outer.device, dtype=torch.float64)
    order = torch.argsort(u + (w_outer <= 0).to(torch.float64) * 10.0, dim=1)
    seq = (torch.arange(n, device=w_outer.device) % n_folds).expand(f_outer, n)
    return torch.zeros((f_outer, n), dtype=torch.int64, device=w_outer.device).scatter_(1, order, seq)


def _grow_inputs(x, n_bins, w=None, repeat: int = 1):
    """Bins and K2's inputs made from them (``prepare_bins``): the global
    full-data bins for ``w`` None; else one table per row of ``w`` (C, n),
    each binned on its rows with w > 0 (``make_bins_masked``), every table
    repeated ``repeat`` times in K2's inputs (one per chain).  Returns
    (edges, xb, tables): edges (p, nb - 1) or (C, p, nb - 1), xb (n, p) or
    (C, n, p)."""
    if w is None:
        edges = make_bins(x, n_bins)                          # (p, nb - 1)
        xb = bin_data(x, edges)                               # (n, p)
        return edges, xb, prepare_bins(xb, n_bins)
    edges = make_bins_masked(x, w, n_bins)                    # (C, p, nb - 1)
    xb = bin_data(x, edges)                                   # (C, n, p)
    return edges, xb, prepare_bins(xb.repeat_interleave(repeat, 0) if repeat > 1 else xb, n_bins)


def _cv_deviance_curve_multi(
    x, y, w_outer, *, n_folds, n_splits, lr, bag_fraction, min_leaf, step_size, max_trees,
    tolerance, n_bins, selectors=None, global_bins=True, shared_bins=False, bags: Callable | None = None,
    generator: torch.Generator | None = None, keep_fhist: bool = False,
) -> MultiCurve:
    """All OUTER chains' gbm.step CV curves, batched: F x K boosting chains
    advance one K2 launch per ``step_size``-tree cycle, with the
    checkpoint/stop bookkeeping on the host; each outer chain freezes at its
    own stopping checkpoint.

    w_outer (F, n) training masks; ``y`` (n,) or (F, n); ``selectors``
    (F, n) inner-fold ids (drawn from ``generator`` when None); ``bags(t)``
    the (F, K, n) or (F * K, n) 0/1 bag draw of tree t (t counts from 0
    over the whole curve), multiplied by the inner training masks.
    Bins: global (one full-data table) by default; with ``global_bins=False``
    one table per outer chain from its training rows, shared by its K inner
    chains (``shared_bins``), or one per chain from its inner training rows.
    ``keep_fhist``: also the train deviances and link-scale fits at every
    checkpoint (the CV statistics' inputs)."""
    x = torch.as_tensor(x)
    dev_ = x.device
    n, p = x.shape
    w_outer = torch.as_tensor(w_outer, device=dev_).to(x.dtype)
    f_outer = w_outer.shape[0]
    y = torch.as_tensor(y, device=dev_).to(x.dtype)
    if y.ndim == 1:
        y = y[None, :].expand(f_outer, n)
    if selectors is None:
        selectors = _draw_selectors(generator, w_outer, n_folds)
    selectors = torch.as_tensor(selectors, device=dev_).long()
    fold_ids = torch.arange(n_folds, device=dev_)
    train_w = (selectors[:, None, :] != fold_ids[None, :, None]).to(x.dtype) * w_outer[:, None, :]
    test_w = (selectors[:, None, :] == fold_ids[None, :, None]).to(x.dtype) * w_outer[:, None, :]
    if global_bins:
        edges, xb, tables = _grow_inputs(x, n_bins)
    elif shared_bins:
        edges, xb, tables = _grow_inputs(x, n_bins, w_outer, repeat=n_folds)
    else:
        edges, xb, tables = _grow_inputs(x, n_bins, train_w.reshape(f_outer * n_folds, n))
        edges = edges.reshape((f_outer, n_folds) + edges.shape[1:])
        xb = xb.reshape((f_outer, n_folds) + xb.shape[1:])
    test_sum = test_w.sum(2).clamp_min(1.0)
    train_sum = train_w.sum(2).clamp_min(1.0)
    f0 = (train_w * y[:, None, :]).sum(2) / train_sum          # (F, K)

    c = f_outer * n_folds
    f32 = torch.float32
    y_flat = y[:, None, :].expand(f_outer, n_folds, n).reshape(c, n).to(f32).contiguous()
    tw_flat = train_w.reshape(c, n).to(f32)
    fm = f0[:, :, None].expand(f_outer, n_folds, n).reshape(c, n).to(f32).contiguous()
    y32, test_w32, test_sum32 = y.to(f32), test_w.to(f32), test_sum.to(f32)
    if bags is None:
        bags = _random_bags(generator, bag_fraction, (c, n), dev_, step_size)

    max_cp = max_trees // step_size
    win = min(10, max_cp)
    dev = np.full((max_cp, f_outer, n_folds), np.inf, np.float64)
    stopped = np.full((f_outer,), max_cp + 1, np.int64)
    j = t = 0
    tdev, fhist = [], []
    while j < max_cp and np.any(stopped > max_cp):
        cycle = _stack_bags(bags, t, step_size, (c, n), dev_, tw_flat)
        fm = gbm_tree_cycle(tables, y_flat, fm, cycle, n_splits=n_splits, nb=n_bins, min_leaf=min_leaf, lr=lr).f
        t += step_size
        resid = y32[:, None, :] - fm.reshape(f_outer, n_folds, n)
        dev[j] = ((test_w32 * resid**2).sum(2) / test_sum32).cpu().numpy()
        if keep_fhist:
            tdev.append(((train_w.to(f32) * resid**2).sum(2) / train_sum.to(f32)).cpu().numpy())
            fhist.append(fm.reshape(f_outer, n_folds, n).cpu().numpy())
        fire = stopping_fired(dev[: j + 1].mean(axis=2), tolerance, win=win) & (stopped > max_cp)
        stopped[fire] = j + 1
        j += 1
    return MultiCurve(np.minimum(stopped, j), dev, edges, xb, np.stack(tdev) if keep_fhist else None,
                      np.stack(fhist) if keep_fhist else None)


def _final_fits(
    x, ycols, best_trees, *, budget, n_splits, lr_vec, bag_fraction, min_leaf, n_bins,
    sample_w=None, own_bins=False, with_deviance=False, emit_trees=False, bags: Callable | None = None,
    generator: torch.Generator | None = None, step_size: int = STEP_SIZE,
) -> dict:
    """All chains' gaussian final refits, one K2 launch per
    ``step_size``-tree cycle, under the global bins, or with ``own_bins``
    each chain binned on its rows with ``sample_w`` > 0 (one table each).
    K2 grows at lr = 1 and updates
    ``f += lr_c * act_c * (f_new - f)`` after each tree, which applies
    per-chain learning rates (fit_multi's restarts) and the best.trees cut
    (trees past it still grow on the frozen residuals and add nothing).
    ``bags(t)`` gives the (C, n) 0/1 bag draw of tree t, multiplied by
    ``sample_w``.

    Returns a dict: f0 (C,), train_fit (C, n), tree_active (C, budget),
    edges ((p, nb - 1), or (C, p, nb - 1) with ``own_bins``); with
    ``emit_trees`` the trees' arrays (budget, C, .) feat,
    thr_bin, internal, left, right, value, var_gain; with ``with_deviance``
    train_deviance and holdout_deviance (budget, C)."""
    x = torch.as_tensor(x)
    dev_ = x.device
    n, p = x.shape
    f32 = torch.float32
    ycols = torch.as_tensor(ycols, device=dev_).to(f32).contiguous()
    c = ycols.shape[0]
    w = torch.ones((c, n), dtype=f32, device=dev_) if sample_w is None else \
        torch.as_tensor(sample_w, device=dev_).to(f32)
    edges, xb, tables = _grow_inputs(x, n_bins, w if own_bins else None)
    lr_col = torch.as_tensor(np.asarray(lr_vec), device=dev_).to(f32)[:, None]
    bt = torch.as_tensor(np.asarray(best_trees), device=dev_)
    act = (torch.arange(budget, device=dev_)[None, :] < bt[:, None]).to(f32)   # (C, budget)
    wsum = w.sum(1).clamp_min(1.0)
    f0 = (w * ycols).sum(1) / wsum                                             # gaussian f0
    test_w = (w <= 0).to(f32)
    test_sum = test_w.sum(1).clamp_min(1.0)
    if bags is None:
        bags = _random_bags(generator, bag_fraction, (c, n), dev_, 50)
    scale = (lr_col * act).T                                                   # (budget, C)
    dev_w = torch.stack([w, test_w]).contiguous() if with_deviance else None

    f = f0[:, None].expand(c, n).contiguous()
    cycles = []
    for t0 in range(0, budget, step_size):
        count = min(step_size, budget - t0)
        out = gbm_tree_cycle(tables, ycols, f, _stack_bags(bags, t0, count, (c, n), dev_, w), n_splits=n_splits,
                             nb=n_bins, min_leaf=min_leaf, lr=1.0, scale=scale[t0 : t0 + count].contiguous(),
                             emit_tree=emit_trees, deviance_w=dev_w)
        f = out.f
        cycles.append(out)
    res = dict(f0=f0, train_fit=f, tree_active=act, edges=edges)
    if emit_trees:
        names = ("feat", "thr_bin", "internal", "left", "right", "value", "var_gain")
        for k, name in enumerate(names):
            res[name] = torch.cat([cy.trees[k] for cy in cycles])              # (budget, C, .)
    if with_deviance:
        sums = torch.cat([cy.deviance for cy in cycles])                        # (budget, C, 2)
        res["train_deviance"] = sums[:, :, 0] / wsum
        res["holdout_deviance"] = sums[:, :, 1] / test_sum
    return res


def _stage_bags(bags, stage):
    return None if bags is None else bags(stage)


def fit_outer_batched(
    x, y, outer_train_w, *, tree_complexity: int = 25, learning_rate: float = 0.01,
    bag_fraction: float = 0.5, n_folds: int = 10, step_size: int = STEP_SIZE, max_trees: int = 10000,
    tolerance=None, min_leaf: float = 10.0, n_bins: int = 64, global_bins: bool = True,
    shared_bins: bool = True, selectors=None, bags: Callable | None = None,
    generator: torch.Generator | None = None,
):
    """gbm.step for ALL outer CV folds at once (the run_cv path; gaussian).

    outer_train_w (F, n) per-outer-fold training masks; ``y`` (n,) or (F, n)
    (several responses' runs batch as further chains), all F chains in one
    curve.  With ``global_bins`` every chain's split candidates come from
    ONE table of full-data quantiles (the JAX package's deviation); with
    ``global_bins=False`` the curve bins per outer fold (``shared_bins``)
    or per inner fold, and each outer fold's refit bins on its own training
    rows.  Returns (predictions (F, n) float32 of each fold's best.trees
    refit at every row, best_trees (F,) numpy).

    Injection: ``selectors`` (F, n) inner-fold ids; ``bags(stage)`` returns
    the per-tree bag callable of a stage, ``("curve", 0)`` for the CV curve
    (see ``_cv_deviance_curve_multi``) and ``("final", budget)`` for the
    refits of ``budget`` trees each (``_final_fits``)."""
    x = torch.as_tensor(x)
    dev_ = x.device
    y = torch.as_tensor(y, device=dev_).to(x.dtype)
    outer_train_w = torch.as_tensor(outer_train_w, device=dev_).to(x.dtype)
    f_outer = outer_train_w.shape[0]
    if y.ndim == 1:
        y = y[None, :].expand(f_outer, y.shape[0])
    if tolerance is None:
        # 0.001 x each outer fold's total mean deviance (V73 "auto")
        wsum = outer_train_w.sum(1).clamp_min(1.0)
        ybar = (outer_train_w * y).sum(1) / wsum
        tolerance = 0.001 * ((outer_train_w * (y - ybar[:, None]) ** 2).sum(1) / wsum).cpu().numpy()
    curve = _cv_deviance_curve_multi(
        x, y, outer_train_w, n_folds=n_folds, n_splits=tree_complexity, lr=learning_rate,
        bag_fraction=bag_fraction, min_leaf=min_leaf, step_size=step_size, max_trees=max_trees,
        tolerance=tolerance, n_bins=n_bins, selectors=selectors, global_bins=global_bins,
        shared_bins=shared_bins, bags=_stage_bags(bags, ("curve", 0)), generator=generator,
    )
    np_dtype = np.float32 if x.dtype == torch.float32 else np.float64
    cv_mean = curve.dev.astype(np_dtype).mean(axis=2)          # (max_cp, F)
    best_trees = np.asarray(
        [best_trees_from_curve(cv_mean[:, f], curve.stopped[f], step_size) for f in range(f_outer)],
        np.int64,
    )
    budget = int(-(-best_trees.max() // step_size) * step_size)
    res = _final_fits(
        x, y, best_trees, budget=budget, n_splits=tree_complexity,
        lr_vec=np.full(f_outer, learning_rate), bag_fraction=bag_fraction, min_leaf=min_leaf,
        n_bins=n_bins, sample_w=outer_train_w, own_bins=not global_bins, bags=_stage_bags(bags, ("final", budget)),
        generator=generator, step_size=step_size,
    )
    return res["train_fit"], best_trees


def fit_multi(
    x, ycols, *, tree_complexity: int = 5, learning_rate: float = 0.001, bag_fraction: float = 0.5,
    n_folds: int = 10, step_size: int = STEP_SIZE, max_trees: int = 10000, tolerance=None,
    min_leaf: float = 10.0, n_bins: int = 64, max_restarts: int = 3, statistics: bool = False,
    global_bins: bool = True, shared_bins: bool = True, selectors=None, bags: Callable | None = None,
    generator: torch.Generator | None = None,
) -> list:
    """gbm.step final fits for SEVERAL responses (ycols (n, R); gaussian,
    unweighted rows — mltps's final-fit case, V73:447/493), batched: every
    response's K inner-fold chains advance in the same K2 launches, stopping
    and the lr/2 restart rule resolve per response on the host (restarted
    responses re-enter a later curve, grouped by their current rate), and
    the refits of all responses run as one batch with ``emit_trees``.

    ``selectors`` (R, n) fold ids (drawn per response with
    ``_make_selector`` when None); ``bags(stage)`` as in
    ``fit_outer_batched`` with stages ``("curve", group, restarts)`` —
    ``group`` the tuple of response indices in that curve, ``restarts`` the
    restart count of its first — and ``("final", budget)``.

    ``statistics=True`` also fills the CV and self statistics fields of
    every result, as ``fit`` does.

    Bins: the global full-data table by default; with ``global_bins=False``
    the curve's chains bin per response on its (all) rows, shared by its K
    inner chains (``shared_bins``), or per inner fold on its own training
    rows.  The refits keep the full-data table either way: every row
    trains.

    Returns R GBMStepResult; each ``final`` carries its trees with raw
    thresholds ``edges[feat, thr_bin]``."""
    x = torch.as_tensor(x)
    dev_ = x.device
    n, p = x.shape
    ycols = torch.as_tensor(ycols, device=dev_).to(x.dtype)
    n_resp = int(ycols.shape[1])
    y_np_all = ycols.cpu().numpy()
    w_np = np.ones(n)
    if selectors is None:
        selectors = np.stack([_make_selector(generator, y_np_all[:, j], w_np, n_folds) for j in range(n_resp)])
    selectors = np.asarray(selectors, np.int32)
    total_dev = np.asarray([float(np.sum((y_np_all[:, j] - y_np_all[:, j].mean()) ** 2)) for j in range(n_resp)])
    tol = 0.001 * total_dev / n if tolerance is None else np.full(n_resp, tolerance)
    np_dtype = y_np_all.dtype

    max_cp = max_trees // step_size
    lr_used = np.full(n_resp, float(learning_rate))
    restarts = np.zeros(n_resp, np.int64)
    done: dict[int, dict] = {}
    pending = list(range(n_resp))
    while pending:
        lr_g = lr_used[pending[0]]
        group = [j for j in pending if lr_used[j] == lr_g]
        curve = _cv_deviance_curve_multi(
            x, ycols.T[group], torch.ones((len(group), n), dtype=x.dtype, device=dev_),
            n_folds=n_folds, n_splits=tree_complexity, lr=float(lr_g), bag_fraction=bag_fraction,
            min_leaf=min_leaf, step_size=step_size, max_trees=max_trees, tolerance=tol[group],
            n_bins=n_bins, selectors=selectors[group], global_bins=global_bins, shared_bins=shared_bins,
            bags=_stage_bags(bags, ("curve", tuple(group), int(restarts[group[0]]))), generator=generator,
            keep_fhist=statistics,
        )
        dev32 = curve.dev.astype(np_dtype)
        cv_mean = dev32.mean(axis=2)                            # (max_cp, group)
        finished = []
        for gi, j in enumerate(group):
            j_stop = max(int(curve.stopped[gi]), 1)
            cm = cv_mean[:j_stop, gi]
            rose_early = any(jj < j_stop and cm[jj] > cm[jj - 1] for jj in (1, 2, 3))
            if rose_early and restarts[j] < max_restarts:
                restarts[j] += 1
                lr_used[j] *= 0.5
                continue
            best_cp = int(np.argmin(cm))
            done[j] = dict(best_cp=best_cp, j_stop=j_stop, dev=dev32[:j_stop, gi])
            if statistics:
                done[j].update(tdev=curve.tdev[:j_stop, gi], fbest=curve.fhist[best_cp, gi])
            finished.append(j)
        pending = [j for j in pending if j not in finished]

    best_trees = np.asarray([(done[j]["best_cp"] + 1) * step_size for j in range(n_resp)], np.int64)
    budget = int(max(step_size, -(-best_trees.max() // step_size) * step_size))
    res = _final_fits(
        x, ycols.T, best_trees, budget=budget, n_splits=tree_complexity, lr_vec=lr_used,
        bag_fraction=bag_fraction, min_leaf=min_leaf, n_bins=n_bins, with_deviance=True,
        emit_trees=True, bags=_stage_bags(bags, ("final", budget)), generator=generator, step_size=step_size,
    )
    edges = res["edges"]                                        # (p, nb - 1)
    tr = lambda key: res[key].transpose(0, 1)                    # (R, budget, .)
    feat = tr("feat").long()
    dt = x.dtype
    trees = Tree(
        feat=feat, thr=edges_lookup(edges, feat, tr("thr_bin")).to(dt),
        internal=tr("internal").to(dt), left=tr("left").long(), right=tr("right").long(),
        value=tr("value").to(dt), var_gain=tr("var_gain").to(dt),
    )
    lr_t = torch.as_tensor(lr_used, device=dev_).to(dt)
    results = []
    for j in range(n_resp):
        d = done[j]
        state = brt.BRTState(
            trees=Tree(*(a[j] for a in trees)), edges=edges, f0=res["f0"][j].to(dt), lr=lr_t[j],
            n_splits=tree_complexity, tree_active=res["tree_active"][j].to(dt),
            train_deviance=res["train_deviance"][:, j].to(dt),
            holdout_deviance=res["holdout_deviance"][:, j].to(dt), train_fit=res["train_fit"][j].to(dt),
        )
        pad = np.full((max_cp,), np.inf, np_dtype)
        cv_mean_j, cv_se_j = pad.copy(), pad.copy()
        cv_mean_j[: d["j_stop"]] = d["dev"].mean(axis=1)
        cv_se_j[: d["j_stop"]] = d["dev"].std(axis=1, ddof=1) / math.sqrt(n_folds)
        kw: dict[str, Any] = {}
        if statistics:
            y_np = y_np_all[:, j]
            cv_statistics, fitted_vars, fold_fit = _cv_statistics_at_best(
                d["fbest"], y_np, w_np, selectors[j], n_folds, "gaussian")
            fitted, residuals, self_statistics = _self_statistics(
                state.train_fit.cpu().numpy(), y_np, w_np, "gaussian", total_dev[j], float(n))
            t_mean = pad.copy()
            t_mean[: d["j_stop"]] = d["tdev"].mean(axis=1)
            kw = dict(training_deviance=torch.as_tensor(t_mean), fitted=fitted, residuals=residuals,
                      fitted_vars=fitted_vars, fold_fit=fold_fit, self_statistics=self_statistics,
                      cv_statistics=cv_statistics)
        results.append(GBMStepResult(
            final=state, best_trees=int(best_trees[j]), trees_fitted=d["j_stop"] * step_size,
            cv_deviance=torch.as_tensor(cv_mean_j), cv_deviance_se=torch.as_tensor(cv_se_j),
            family="gaussian", learning_rate=float(lr_used[j]), restarts=int(restarts[j]),
            selector=selectors[j], **kw,
        ))
    return results


class Curve(NamedTuple):
    """The serial CV curve: checkpoints grown and, per checkpoint and fold,
    the holdout and train deviances (inf past ``j``) and link-scale fits."""
    j: int
    dev: np.ndarray               # (max_cp, K) float32
    tdev: np.ndarray              # (max_cp, K) float32
    fhist: list                   # j tensors (K, n) float32


def _cv_deviance_curve(
    x, y, w, selector, *, n_folds, n_splits, lr, bag_fraction, min_leaf, step_size, max_trees, tolerance, n_bins,
    family="gaussian", offset=None, monotone=None, bags: Callable | None = None,
    generator: torch.Generator | None = None,
) -> Curve:
    """One response's gbm.step CV curve: the K fold models are K chains of
    K2, each on the bin table of its own training rows (``make_bins_masked``),
    grown a ``step_size``-tree cycle at a time until the stopping rule fires
    or ``max_trees``; after each cycle the folds' holdout and train
    deviances and fits are kept.  Gaussian chains grow a cycle in one
    launch; other families one tree a launch (``brt.family_tree``).

    x (n, p), y and w (n,), selector (n,) fold ids; ``offset`` (n,) and
    ``monotone`` (p,) float32 or None; ``bags(t)`` the (K, n) 0/1 bag draw
    of tree t (t counts from 0 over the whole curve), multiplied by the
    folds' training masks."""
    x = torch.as_tensor(x)
    dev_, f32 = x.device, torch.float32
    n = x.shape[0]
    sel = torch.as_tensor(np.asarray(selector), device=dev_).long()
    fold_ids = torch.arange(n_folds, device=dev_)
    train_w = (sel[None, :] != fold_ids[:, None]).to(f32) * w[None, :]
    test_w = (sel[None, :] == fold_ids[:, None]).to(f32) * w[None, :]
    edges_k = make_bins_masked(x, train_w, n_bins)                             # (K, p, nb - 1)
    xb_k = bin_data(x, edges_k)                                                # (K, n, p)
    tables = prepare_bins(xb_k, n_bins)
    y_rep = y[None, :].expand(n_folds, n).contiguous()
    f0 = f0_init(y_rep, train_w, family, offset=offset)                        # (K,)
    f = (f0[:, None] + (0.0 if offset is None else offset[None, :])).expand(n_folds, n).contiguous()
    if bags is None:
        bags = _random_bags(generator, bag_fraction, (n_folds, n), dev_, step_size)
    kw = dict(n_splits=n_splits, nb=n_bins, min_leaf=min_leaf, monotone=monotone)

    max_cp = max_trees // step_size
    win = min(10, max_cp)
    dev = np.full((max_cp, n_folds), np.inf, np.float32)
    tdev = np.full((max_cp, n_folds), np.inf, np.float32)
    fhist = []
    j = 0
    while j < max_cp:
        t0 = j * step_size
        if family == "gaussian":
            f = gbm_tree_cycle(tables, y_rep, f, _stack_bags(bags, t0, step_size, (n_folds, n), dev_, train_w),
                               lr=lr, **kw).f
        else:
            for t in range(t0, t0 + step_size):
                bag = torch.as_tensor(bags(t), device=dev_).reshape(n_folds, n).to(f32) * train_w
                tree, cur = family_tree(tables, xb_k, y_rep, f, bag, family=family, **kw)
                f = f + lr * tree[5].gather(1, cur)
        u = response(f, family)
        dev[j] = calc_deviance(y_rep, u, test_w, family).cpu().numpy()
        tdev[j] = calc_deviance(y_rep, u, train_w, family).cpu().numpy()
        fhist.append(f)
        j += 1
        if stopping_fired(dev[:j].mean(axis=1), tolerance, win=win):
            break
    return Curve(j, dev, tdev, fhist)


def _cv_statistics_at_best(fbest, y_np, w_np, selector_np, n_folds, family):
    """The reference's cv.statistics block at best.trees (V73:2014-2096):
    per-fold heldout deviance and correlation with means and SEs, the
    between-fold variances of the fitted values, and the heldout linear
    predictors.  Host numpy; shared by ``fit`` and ``fit_multi``."""
    ubest = response(torch.as_tensor(fbest), family).numpy()                  # response scale
    n = y_np.shape[0]
    cv_dev_stats = np.zeros(n_folds)
    cv_cor_stats = np.zeros(n_folds)
    fold_fit = np.zeros(n)
    for i in range(n_folds):
        held = (selector_np == i) & (w_np > 0)
        yi, ui = y_np[held], ubest[i, held]
        cv_dev_stats[i] = float(calc_deviance(torch.as_tensor(yi), torch.as_tensor(ui),
                                              torch.as_tensor(w_np[held]), family))
        cv_cor_stats[i] = float(np.corrcoef(yi, ui)[0, 1]) if held.sum() > 1 and np.std(ui) > 0 else np.nan
        fold_fit[held] = fbest[i, held]
    fitted_vars = np.var(ubest, axis=0, ddof=1)
    cv_statistics = {
        "deviance.mean": float(np.nanmean(cv_dev_stats)),
        "deviance.se": float(np.nanstd(cv_dev_stats, ddof=1) / math.sqrt(n_folds)),
        "correlation.mean": float(np.nanmean(cv_cor_stats)),
        "correlation.se": float(np.nanstd(cv_cor_stats, ddof=1) / math.sqrt(n_folds)),
        "deviance.stats": cv_dev_stats,
        "correlation.stats": cv_cor_stats,
    }
    return cv_statistics, fitted_vars, fold_fit


def _self_statistics(fitted_link, y_np, w_np, family, total_deviance, n_active):
    """The reference's self.statistics block and family-correct residuals of
    the final model (V73:2115-2152, 2190-2192).  Host numpy; shared by
    ``fit`` and ``fit_multi``."""
    fitted = response(torch.as_tensor(fitted_link), family).numpy()
    resid_deviance = float(calc_deviance(torch.as_tensor(y_np), torch.as_tensor(fitted), torch.as_tensor(w_np),
                                         family, calc_mean=False))
    if family == "bernoulli":
        contribs = y_np * np.log(np.maximum(fitted, 1e-12)) + (1 - y_np) * np.log(np.maximum(1 - fitted, 1e-12))
        residuals = np.sqrt(np.abs(contribs * 2.0))
        residuals = np.where(y_np - fitted < 0, -residuals, residuals)
    elif family == "poisson":
        contribs = np.where(
            y_np == 0, 0.0, y_np * np.log(np.maximum(y_np, 1e-12) / np.maximum(fitted, 1e-12))
        ) - (y_np - fitted)
        residuals = np.sqrt(np.abs(contribs * 2.0))
        residuals = np.where(y_np - fitted < 0, -residuals, residuals)
    else:  # gaussian | laplace
        residuals = y_np - fitted
    with np.errstate(invalid="ignore"):
        self_cor = float(np.corrcoef(y_np[w_np > 0], fitted[w_np > 0])[0, 1])
    self_statistics = {
        "null": total_deviance,
        "mean.null": total_deviance / n_active,
        "resid": resid_deviance,
        "mean.resid": resid_deviance / n_active,
        "correlation": self_cor,
    }
    return fitted, residuals, self_statistics


def fit(
    x, y, *, sample_weight=None, tree_complexity: int = 5, learning_rate: float = 0.001, bag_fraction: float = 0.5,
    n_folds: int = 10, step_size: int = STEP_SIZE, max_trees: int = 10000, tolerance=None, min_leaf: float = 10.0,
    n_bins: int = 64, family: str = "gaussian", prev_stratify: bool = True, max_restarts: int = 3, offset=None,
    fold_vector=None, var_monotone=None, selector=None, bags: Callable | None = None,
    generator: torch.Generator | None = None,
) -> GBMStepResult:
    """The serial gbm.step of one response (see the module docstring).

    The reference arguments mltps itself never passes (V73:247/493):

    * ``offset``: (n,) fixed per-row link-scale term (V73:1664/1774).  The
      CV fold fits, deviance curves, CV and self statistics and the final
      model's ``fitted``/``residuals`` include it; ``predict`` does not add
      it, as ``predict.gbm``.  The intercept-only total deviance stays
      offset-free, as in the reference (V73:1786-1796).
    * ``fold_vector``: (n,) fold membership (V73:1665/1752-1756); R's
      1..n_folds labels (guessed from min >= 1 and max == n_folds, as the
      JAX package does) or 0-based ones; the reference's wrong-length error.
    * ``var_monotone``: (p,) in {-1, 0, +1} per predictor (V73:1670/1772).

    Injection: ``selector`` (n,) fold ids (else drawn with ``_make_selector``
    from ``generator``); ``bags(stage)`` returns the bag callable of a stage,
    ``("curve", restarts)`` for the CV curve (see ``_cv_deviance_curve``)
    and ``("final", budget)`` for the refit (tree t's (n,) draw)."""
    family = check_family(family)
    x = torch.as_tensor(x)
    dev_, f32 = x.device, torch.float32
    n, p = x.shape
    y32 = torch.as_tensor(y, device=dev_).to(f32)
    w = torch.ones((n,), dtype=f32, device=dev_) if sample_weight is None else \
        torch.as_tensor(sample_weight, device=dev_).to(f32)
    if offset is not None:
        offset = torch.as_tensor(offset, device=dev_).to(f32)
        if tuple(offset.shape) != (n,):
            raise ValueError(f"offset must have shape ({n},), got {tuple(offset.shape)}")
    if var_monotone is not None:
        var_monotone = torch.as_tensor(var_monotone, device=dev_).to(f32).contiguous()
        if tuple(var_monotone.shape) != (p,):
            raise ValueError(f"var_monotone must have shape ({p},), got {tuple(var_monotone.shape)}")
    n_active = float(max(int((w > 0).sum()), 1))
    # total deviance of the intercept-only model (V73:1786-1796)
    u0 = response(f0_init(y32, w, family).expand(n), family)
    total_deviance = float(calc_deviance(y32, u0, w, family, calc_mean=False))
    if tolerance is None:
        tolerance = 0.001 * total_deviance / n_active   # tolerance.method "auto"
    y_np, w_np = y32.cpu().numpy(), w.cpu().numpy()
    if fold_vector is not None:
        fold_vector = np.asarray(fold_vector)
        if fold_vector.shape != (n,):
            raise ValueError("supplied fold vector is of wrong length")   # the reference's complaint (V73:1752-1753)
        selector_np = fold_vector.astype(np.int32)
        if selector_np.min() >= 1 and selector_np.max() == n_folds:
            selector_np = selector_np - 1                                  # R's 1..n_folds labels
        if selector_np.min() < 0 or selector_np.max() >= n_folds:
            raise ValueError(f"fold_vector labels must lie in 1..{n_folds} (R) or 0..{n_folds - 1}")
    elif selector is not None:
        selector_np = np.asarray(selector, np.int32)
    else:
        selector_np = _make_selector(generator, y_np, w_np, n_folds, family=family, prev_stratify=prev_stratify)

    # the CV curve with the reference's restart rule (V73:1948-1955), automated at lr/2
    lr_used, restarts = float(learning_rate), 0
    while True:
        curve = _cv_deviance_curve(
            x, y32, w, selector_np, n_folds=n_folds, n_splits=tree_complexity, lr=lr_used,
            bag_fraction=bag_fraction, min_leaf=min_leaf, step_size=step_size, max_trees=max_trees,
            tolerance=tolerance, n_bins=n_bins, family=family, offset=offset, monotone=var_monotone,
            bags=_stage_bags(bags, ("curve", restarts)), generator=generator,
        )
        j = curve.j
        cv_mean = curve.dev[:j].mean(axis=1)
        rose_early = any(jj < j and cv_mean[jj] > cv_mean[jj - 1] for jj in (1, 2, 3))
        if not rose_early or restarts >= max_restarts:
            break
        restarts += 1
        lr_used *= 0.5

    dev = curve.dev[:j]
    best_cp = int(np.argmin(cv_mean))               # the first checkpoint at the minimum
    best_trees = (best_cp + 1) * step_size
    cv_statistics, fitted_vars, fold_fit = _cv_statistics_at_best(
        curve.fhist[best_cp].cpu().numpy(), y_np, w_np, selector_np, n_folds, family)

    budget = max(step_size, -(-best_trees // step_size) * step_size)
    final = brt.fit(
        x, y32, sample_weight=w, n_trees=budget, n_splits=tree_complexity, lr=lr_used, bag_fraction=bag_fraction,
        min_leaf=min_leaf, n_bins=n_bins, n_trees_active=best_trees, family=family, offset=offset,
        var_monotone=var_monotone, bags=_stage_bags(bags, ("final", budget)), generator=generator,
    )
    fitted, residuals, self_statistics = _self_statistics(
        final.train_fit.to(f32).cpu().numpy(), y_np, w_np, family, total_deviance, n_active)

    pad = np.full((max_trees // step_size,), np.inf, np.float32)
    filled = lambda v: torch.as_tensor(np.concatenate([v, pad[j:]]))
    return GBMStepResult(
        final=final, best_trees=best_trees, trees_fitted=j * step_size, cv_deviance=filled(cv_mean),
        cv_deviance_se=filled(dev.std(axis=1, ddof=1) / math.sqrt(n_folds)), family=family,
        learning_rate=lr_used, restarts=restarts, selector=selector_np,
        training_deviance=filled(curve.tdev[:j].mean(axis=1)), fitted=fitted, residuals=residuals,
        fitted_vars=fitted_vars, fold_fit=fold_fit, self_statistics=self_statistics, cv_statistics=cv_statistics,
    )


def predict(result: GBMStepResult, x, type: str = "link", tables=None) -> torch.Tensor:
    """Boosted score at ``x``; ``type='response'`` applies the inverse link
    (predict.gbm returns the link scale; the reference applies exp/logistic
    by hand, V73:1837-1851).  For gaussian the two coincide."""
    out = brt.predict(result.final, x, tables=tables)
    return response(out, result.family) if type == "response" else out


def importance(result: GBMStepResult, names) -> dict:
    return brt.importance(result.final, names)
