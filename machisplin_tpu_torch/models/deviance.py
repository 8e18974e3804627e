"""Deviance: the counterpart of ``machisplin_tpu/models/deviance.py``
(machisplin.calc.deviance, V73:2250-2284).

Families as in the vendored gbm.step: bernoulli (binomial), poisson,
laplace, gaussian (the weighted RSS).  ``calc_mean=True`` returns the
weight-normalised mean deviance, as the driver's holdout curves use it.
"""
from __future__ import annotations

import torch

from .families import check_family

__all__ = ["calc_deviance"]


def calc_deviance(obs, pred, weights=None, family: str = "gaussian", calc_mean: bool = True):
    """Deviance of ``pred`` (response scale) against ``obs`` over the last
    axis: (n,) inputs give a scalar, (K, n) predictions or weights one value
    per row."""
    obs = torch.as_tensor(obs)
    pred = torch.as_tensor(pred, device=obs.device)
    weights = torch.ones_like(obs) if weights is None else torch.as_tensor(weights, device=obs.device).to(obs.dtype)
    family = check_family(family)
    eps = 1e-12
    if family == "gaussian":
        dev = (obs - pred) ** 2
    elif family == "bernoulli":
        p = pred.clamp(eps, 1 - eps)
        dev = -2.0 * (obs * torch.log(p) + (1 - obs) * torch.log(1 - p))
    elif family == "poisson":
        mu = pred.clamp_min(eps)
        term = torch.where(obs > 0, obs * torch.log(obs.clamp_min(eps) / mu), torch.zeros((), dtype=mu.dtype,
                                                                                        device=mu.device))
        dev = 2.0 * (term - (obs - mu))
    else:
        dev = (obs - pred).abs()
    total = (dev * weights).sum(-1)
    if calc_mean:
        return total / weights.sum(-1).clamp_min(eps)
    return total
