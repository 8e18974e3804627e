"""Carry fitted parameters from the JAX package's model states into the port.

Each function takes the JAX state's fields as numpy arrays (a NamedTuple of
arrays, or a dict) and returns the port's state on ``device``, so that the
same fitted model can be fed to both packages' predict paths.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.brt import BRTState
from .models.gam import GAMSmoothState, GAMState
from .models.gbm_step import GBMStepResult
from .models.mars import MARSState
from .models.nn import NNState, flat_to_params, params_to_flat
from .models.rf import RFState
from .models.svm import SVMState
from .models.trees import Tree
from .ops.tps import TPSModel
from .utils import resolve_device

__all__ = [
    "tps_model_from_numpy", "gam_state_from_numpy", "gam_smooth_state_from_numpy", "mars_state_from_numpy",
    "tree_from_numpy", "brt_state_from_numpy", "gbm_result_from_numpy",
    "nn_state_from_jax", "nn_params_to_flat", "nn_params_from_flat",
    "svm_state_from_jax", "rf_state_from_jax",
]


def _fields(d) -> dict:
    return dict(d._asdict()) if hasattr(d, "_asdict") else dict(d)


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=resolve_device(device))


def tps_model_from_numpy(d, dtype=torch.float64, device="cuda") -> TPSModel:
    """TPSModel from the JAX ``TPSModel`` fields (knots, c, d, shift, scale,
    lam, gcv, fitted, residuals, eff_df)."""
    f = _fields(d)
    return TPSModel(**{k: _t(f[k], dtype, device) for k in TPSModel._fields})


def gam_state_from_numpy(d, dtype=torch.float64, device="cuda") -> GAMState:
    """GAMState from the JAX ``GAMState`` fields (coef, x_mean, x_scale)."""
    f = _fields(d)
    return GAMState(**{k: _t(f[k], dtype, device) for k in GAMState._fields})


def gam_smooth_state_from_numpy(d, dtype=torch.float64, device="cuda") -> GAMSmoothState:
    """GAMSmoothState from the JAX ``GAMSmoothState`` fields (coef, knots,
    centers, x_mean, x_scale, lam, gcv, eff_df, and the int ``k``)."""
    f = _fields(d)
    out = {k: _t(f[k], dtype, device) for k in GAMSmoothState._fields if k != "k"}
    return GAMSmoothState(k=int(np.asarray(f["k"])), **out)


def mars_state_from_numpy(d, dtype=torch.float64, device="cuda") -> MARSState:
    """MARSState from the JAX ``MARSState`` fields; ``vars`` and ``parent``
    (all zero for a degree-1 fit, or when absent) as int64."""
    f = _fields(d)
    dev = resolve_device(device)
    ints = ("vars", "parent")
    out = {k: _t(f[k], dtype, device) for k in MARSState._fields if k not in ints}
    out["vars"] = torch.as_tensor(np.array(f["vars"]), dtype=torch.int64, device=dev)
    parent = f.get("parent")
    out["parent"] = (torch.zeros_like(out["vars"]) if parent is None
                     else torch.as_tensor(np.array(parent), dtype=torch.int64, device=dev))
    return MARSState(**out)


def tree_from_numpy(d, dtype=torch.float32, device="cuda") -> Tree:
    """Tree from the JAX ``Tree`` fields: feat/left/right as int64, the rest
    (thr, internal, value, var_gain) in ``dtype``."""
    f = _fields(d)
    dev = resolve_device(device)
    ints = ("feat", "left", "right")
    return Tree(**{
        k: torch.as_tensor(np.array(f[k]), dtype=torch.int64 if k in ints else dtype, device=dev)
        for k in Tree._fields
    })


def brt_state_from_numpy(d, dtype=torch.float32, device="cuda") -> BRTState:
    """BRTState from the JAX ``BRTState`` fields (its ``trees`` a Tree of
    arrays, ``n_splits`` an int or a 0-d array)."""
    f = _fields(d)
    out = {k: _t(f[k], dtype, device) for k in BRTState._fields if k not in ("trees", "n_splits")}
    return BRTState(trees=tree_from_numpy(f["trees"], dtype, device), n_splits=int(np.asarray(f["n_splits"])), **out)


def gbm_result_from_numpy(d, dtype=torch.float32, device="cuda") -> GBMStepResult:
    """GBMStepResult from the JAX ``GBMStepResult`` fields: the CV curves
    (and the training-deviance curve, where filled) as tensors, the
    statistics fields (fitted values, residuals, their variances, the
    held-out fits and the two statistics blocks) as numpy, as the port's
    ``fit`` returns them."""
    f = _fields(d)
    out = dict(f)
    out["final"] = brt_state_from_numpy(f["final"], dtype, device)
    out["best_trees"] = int(np.asarray(f["best_trees"]))
    out["trees_fitted"] = int(np.asarray(f["trees_fitted"]))
    for k in ("cv_deviance", "cv_deviance_se", "training_deviance"):
        if out.get(k) is not None:
            out[k] = _t(f[k], dtype, device)
    for k in ("selector", "fitted", "residuals", "fitted_vars", "fold_fit"):
        if out.get(k) is not None:
            out[k] = np.asarray(f[k])
    for k in ("self_statistics", "cv_statistics"):
        if out.get(k) is not None:
            out[k] = {name: np.asarray(v) if np.ndim(v) else float(v) for name, v in f[k].items()}
    return GBMStepResult(**{k: out[k] for k in GBMStepResult._fields if k in out})


def nn_state_from_jax(d, dtype=torch.float64, device="cuda") -> NNState:
    """NNState from the JAX ``NNState`` fields (w1, b1, w2, b2, x_mean,
    x_scale), with or without a leading lane axis."""
    f = _fields(d)
    return NNState(**{k: _t(f[k], dtype, device) for k in NNState._fields})


def nn_params_to_flat(w1, b1, w2, b2, dtype=torch.float64, device="cuda") -> torch.Tensor:
    """The L-BFGS layout of the JAX package's NN params tuple: (L, P) rows
    [w1 (p, h) row-major, b1, w2, b2], P = p*h + 2h + 1, from params with a
    leading lane axis (w1 (L, p, h)) or without one (one row)."""
    parts = [_t(a, dtype, device) for a in (w1, b1, w2, b2)]
    if parts[0].dim() == 2:
        parts = [a[None] for a in parts]
    return params_to_flat(*parts)


def nn_params_from_flat(flat, p: int, hidden: int):
    """Back from the L-BFGS layout: numpy (w1 (L, p, h), b1 (L, h), w2 (L, h),
    b2 (L,)), the JAX package's params tuple with a lane axis."""
    return tuple(a.detach().cpu().numpy() for a in flat_to_params(torch.as_tensor(flat), p, hidden))


def svm_state_from_jax(d, dtype=torch.float64, device="cuda") -> SVMState:
    """SVMState from the JAX ``SVMState`` fields (sv_x, theta, bias, sigma,
    x_mean, x_scale, y_mean, y_scale), with or without a leading lane axis."""
    f = _fields(d)
    return SVMState(**{k: _t(f[k], dtype, device) for k in SVMState._fields})


def rf_state_from_jax(d, dtype=torch.float32, device="cuda") -> RFState:
    """RFState from the JAX ``RFState`` fields: its ``trees`` a Tree of (T, N)
    arrays, ``max_depth`` an int, edges, oob_count and train_pred in ``dtype``."""
    f = _fields(d)
    return RFState(trees=tree_from_numpy(f["trees"], dtype, device), edges=_t(f["edges"], dtype, device),
                   max_depth=int(np.asarray(f["max_depth"])), oob_count=_t(f["oob_count"], dtype, device),
                   train_pred=_t(f["train_pred"], dtype, device))
