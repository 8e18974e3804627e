"""'GAM' model — ordinary least squares (counterpart of
``machisplin_tpu/models/gam.py``'s default fit).

The reference calls ``mgcv::gam(resp ~ covar1+...+LONG+LAT)`` with no s()
smooth terms (V73:195/252/600), so its "GAM" is a plain linear model;
importance is the raw-scale coefficient vector (``mod.GAM$coefficients``,
V73:602).  The ``smooth=True`` P-spline extension is not ported yet.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .base import as_weight


class GAMState(NamedTuple):
    coef: torch.Tensor     # (..., p + 1) [intercept, covariates...]
    x_mean: torch.Tensor   # (..., p) centring used for conditioning
    x_scale: torch.Tensor  # (..., p)


def fit(x, y, *, sample_weight=None, ridge: float = 1e-8) -> GAMState:
    """Weighted OLS on standardised covariates; y (n,) or (B, n)."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    w = as_weight(sample_weight, y.shape, x.dtype, x.device)
    wsum = w.sum(-1, keepdim=True).clamp_min(1.0)
    x_mean = (x * w[..., None]).sum(-2) / wsum
    xc = x - x_mean[..., None, :]
    x_scale = torch.sqrt((w[..., None] * xc * xc).sum(-2) / wsum)
    x_scale = torch.where(x_scale > 0, x_scale, torch.ones((), dtype=x.dtype, device=x.device))
    xs = xc / x_scale[..., None, :]
    z = torch.cat([torch.ones_like(y)[..., None], xs], dim=-1)
    zw = z * w[..., None]
    g = z.transpose(-1, -2) @ zw + ridge * torch.eye(z.shape[-1], dtype=x.dtype, device=x.device)
    b = (zw.transpose(-1, -2) @ y[..., None])[..., 0]
    coef = torch.linalg.solve(g, b)
    return GAMState(coef=coef, x_mean=x_mean, x_scale=x_scale)


def predict(state: GAMState, x) -> torch.Tensor:
    """(m,) for one model, (B, m) for a batch."""
    x = torch.as_tensor(x)
    xs = (x - state.x_mean[..., None, :]) / state.x_scale[..., None, :]
    return state.coef[..., :1] + (xs @ state.coef[..., 1:, None])[..., 0]


def importance(state: GAMState, names) -> dict:
    """Raw-scale coefficients keyed by term, like mgcv's coefficient report
    (one unbatched model)."""
    raw = state.coef[1:] / state.x_scale
    intercept = state.coef[0] - torch.sum(raw * state.x_mean)
    out = {"(Intercept)": float(intercept)}
    for n, c in zip(names, raw.tolist()):
        out[n] = float(c)
    return out
