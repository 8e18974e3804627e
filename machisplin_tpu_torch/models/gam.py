"""'GAM' model — ordinary least squares, plus optional true smooths
(counterpart of ``machisplin_tpu/models/gam.py``).

The reference calls ``mgcv::gam(resp ~ covar1+...+LONG+LAT)`` with no s()
smooth terms (V73:195/252/600), so its "GAM" is a plain linear model;
importance is the raw-scale coefficient vector (``mod.GAM$coefficients``,
V73:602).  That is ``fit``'s default.

``fit(..., smooth=True)`` is the JAX package's extension: an additive model
with a penalised P-spline term per covariate (cubic B-spline basis on ``k``
quantile knots, second-order difference penalty, Eilers-Marx), the linear
terms kept explicit, and one smoothing parameter chosen by GCV over a log
grid, every grid point's (q x q) penalised system solved in one batched
call (q = 1 + p (k + 1)).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .base import as_weight


class GAMState(NamedTuple):
    coef: torch.Tensor     # (..., p + 1) [intercept, covariates...]
    x_mean: torch.Tensor   # (..., p) centring used for conditioning
    x_scale: torch.Tensor  # (..., p)


class GAMSmoothState(NamedTuple):
    """Additive P-spline model: intercept + per-feature linear + spline."""

    coef: torch.Tensor     # (..., 1 + p + p k) [intercept, linear..., spline...]
    knots: torch.Tensor    # (..., p, k + 4) padded B-spline knot vectors (scaled x)
    centers: torch.Tensor  # (..., p, k) training-time spline-block column means
    x_mean: torch.Tensor   # (..., p)
    x_scale: torch.Tensor  # (..., p)
    lam: torch.Tensor      # (...) GCV-selected smoothing parameter
    gcv: torch.Tensor      # (...) minimised GCV score
    eff_df: torch.Tensor   # (...) tr(A)
    k: int                 # spline basis size per feature


def _standardise(x, w):
    """Weighted mean and scale over the rows with w > 0: x (n, p), w (..., n)
    -> (xs (..., n, p), x_mean (..., p), x_scale (..., p))."""
    wsum = w.sum(-1, keepdim=True).clamp_min(1.0)
    x_mean = (x * w[..., None]).sum(-2) / wsum
    xc = x - x_mean[..., None, :]
    x_scale = torch.sqrt((w[..., None] * xc * xc).sum(-2) / wsum)
    x_scale = torch.where(x_scale > 0, x_scale, torch.ones((), dtype=x.dtype, device=x.device))
    return xc / x_scale[..., None, :], x_mean, x_scale


def fit(x, y, *, sample_weight=None, ridge: float = 1e-8, smooth: bool = False, k: int = 10,
        ngrid: int = 40):
    """Weighted OLS on standardised covariates (the reference's no-s() GAM);
    with ``smooth=True``, the penalised additive P-spline extension
    (``fit_smooth``).  y (n,) or (B, n)."""
    if smooth:
        return fit_smooth(x, y, sample_weight=sample_weight, k=k, ngrid=ngrid)
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    w = as_weight(sample_weight, y.shape, x.dtype, x.device)
    xs, x_mean, x_scale = _standardise(x, w)
    z = torch.cat([torch.ones_like(y)[..., None], xs], dim=-1)
    zw = z * w[..., None]
    g = z.transpose(-1, -2) @ zw + ridge * torch.eye(z.shape[-1], dtype=x.dtype, device=x.device)
    b = (zw.transpose(-1, -2) @ y[..., None])[..., 0]
    coef = torch.linalg.solve(g, b)
    return GAMState(coef=coef, x_mean=x_mean, x_scale=x_scale)


def _bspline_basis(xs, knots):
    """Cubic B-spline design for one feature: xs (..., n) standardised
    values, knots (..., k + 4) padded knot vector (k - 4 interior quantile
    knots with 4-fold boundary padding) -> (..., n, k), by the Cox-de Boor
    recursion."""
    t = knots[..., None, :]                                # (..., 1, m)
    m = knots.shape[-1]
    x = xs[..., :, None]
    b = ((x >= t[..., :-1]) & (x < t[..., 1:])).to(xs.dtype)   # (..., n, m-1)
    # the last non-degenerate interval is closed on the right
    iota = torch.arange(m - 1, device=xs.device)
    last = torch.where(knots[..., 1:] > knots[..., :-1], iota, -1).argmax(-1, keepdim=True)  # (..., 1)
    t_last = knots.gather(-1, last)                        # (..., 1)
    is_last = (iota == last)[..., None, :]
    b = torch.where(is_last & (x >= t_last[..., None, :]), torch.ones((), dtype=xs.dtype, device=xs.device), b)
    for order in range(2, 5):                              # orders 2..4 (cubic)
        tl = t[..., : m - order]
        tr = t[..., order:]
        denom1 = (t[..., order - 1 : m - 1] - tl).clamp_min(1e-12)
        denom2 = (tr - t[..., 1 : m - order + 1]).clamp_min(1e-12)
        w1 = (x - tl) / denom1
        w2 = (tr - x) / denom2
        b = w1 * b[..., : m - order] + w2 * b[..., 1 : m - order + 1]
    return b                                               # (..., n, m-4)


def _smooth_design(xs, knots, centers=None):
    """Full design [1, linear..., splines...] for standardised xs (..., n, p)
    and knots (..., p, k + 4).  Each spline block is centred on its training
    column means: ``centers=None`` at fit (computed and returned), the stored
    (..., p, k) centres at predict.  Returns ((..., n, q), (..., p, k))."""
    p = xs.shape[-1]
    cols = [torch.ones(xs.shape[:-1] + (1,), dtype=xs.dtype, device=xs.device), xs]
    cents = []
    for f in range(p):
        bf = _bspline_basis(xs[..., f], knots[..., f, :])
        c = bf.mean(-2) if centers is None else centers[..., f, :]
        cents.append(c)
        cols.append(bf - c[..., None, :])
    return torch.cat(cols, dim=-1), torch.stack(cents, dim=-2)


def fit_smooth(x, y, *, sample_weight=None, k: int = 10, ngrid: int = 40) -> GAMSmoothState:
    """Additive penalised P-spline GAM with one GCV-selected lambda per
    model; y (n,) or (B, n)."""
    from .trees import make_bins_masked

    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    dt, dev = x.dtype, x.device
    single = y.ndim == 1
    if single:
        y = y[None]
        sample_weight = None if sample_weight is None else torch.as_tensor(sample_weight)[None]
    n, p = x.shape
    w = as_weight(sample_weight, y.shape, dt, dev)                        # (B, n)
    xs, x_mean, x_scale = _standardise(x, w)                              # (B, n, p)

    # per-feature padded knot vectors: 4-fold boundary + k-4 interior
    # quantiles, all from the active (w > 0) rows only (knots from held-out
    # rows would leak covariate information into the CV folds)
    active = (w > 0)[..., None]
    big = torch.finfo(dt).max
    lo = torch.where(active, xs, big).amin(-2) - 1e-3                     # (B, p)
    hi = torch.where(active, xs, -big).amax(-2) + 1e-3
    # quantiles linspace(0, 1, k-2)[1:-1] over the active rows: the masked
    # bin edges at n_bins = k - 3
    interior = make_bins_masked(xs, w, k - 3)                             # (B, p, k-4)
    knots = torch.cat([lo[..., None].expand(-1, -1, 4), interior, hi[..., None].expand(-1, -1, 4)], dim=-1)

    z, centers = _smooth_design(xs, knots)                                # (B, n, q)
    q = z.shape[-1]
    # block-diagonal 2nd-difference penalty over each spline block
    dmat = torch.diff(torch.eye(k, dtype=dt, device=dev), n=2, dim=0)   # rows e_i - 2 e_{i+1} + e_{i+2}
    s_pen = torch.zeros((q, q), dtype=dt, device=dev)
    for f in range(p):
        i0 = 1 + p + f * k
        s_pen[i0 : i0 + k, i0 : i0 + k] = dmat.T @ dmat

    zw = z * w[..., None]
    g = z.transpose(-1, -2) @ zw                                          # (B, q, q)
    b = (zw.transpose(-1, -2) @ y[..., None])[..., 0]                     # (B, q)
    yy = (w * y * y).sum(-1)
    n_a = (w > 0).to(dt).sum(-1)
    eye_q = torch.eye(q, dtype=dt, device=dev)

    def gcv_of(lam):
        """lam (B, L) -> gcv, coef (B, L, q), tr(A) (B, L)."""
        mmat = g[:, None] + lam[..., None, None] * s_pen + 1e-8 * eye_q
        coef = torch.linalg.solve(mmat, b[:, None, :].expand(-1, lam.shape[1], -1))
        gc = (g[:, None] @ coef[..., None])[..., 0]
        rss = yy[:, None] - 2 * (coef * b[:, None]).sum(-1) + (coef * gc).sum(-1)
        tr_a = torch.diagonal(torch.linalg.solve(mmat, g[:, None].expand_as(mmat)), dim1=-2, dim2=-1).sum(-1)
        na = n_a[:, None]
        return na * rss.clamp_min(0.0) / (na - tr_a).clamp_min(1.0) ** 2, coef, tr_a

    s = torch.arange(ngrid - 1, dtype=dt, device=dev) / (ngrid - 1)
    grid = 10.0 ** torch.cat([-6.0 * (1 - s) + 6.0 * s, torch.full((1,), 6.0, dtype=dt, device=dev)])
    scores, _, _ = gcv_of(grid[None].expand(y.shape[0], -1))              # (B, G): one batched solve
    lam = grid[torch.argmin(scores, dim=-1)]                              # (B,)
    gcv, coef, tr_a = gcv_of(lam[:, None])
    st = GAMSmoothState(coef=coef[:, 0], knots=knots, centers=centers, x_mean=x_mean, x_scale=x_scale,
                        lam=lam, gcv=gcv[:, 0], eff_df=tr_a[:, 0], k=k)
    return lane(st, 0) if single else st


def lane(state, j: int):
    """Model ``j`` of a batched state."""
    if isinstance(state, GAMSmoothState):
        return GAMSmoothState(*(a[j] for a in state[:-1]), k=state.k)
    return GAMState(*(a[j] for a in state))


def predict(state, x) -> torch.Tensor:
    """(m,) for one model, (B, m) for a batch."""
    x = torch.as_tensor(x)
    xs = (x - state.x_mean[..., None, :]) / state.x_scale[..., None, :]
    if isinstance(state, GAMSmoothState):
        xs = torch.maximum(torch.minimum(xs, state.knots[..., None, :, -1]), state.knots[..., None, :, 0])
        z, _ = _smooth_design(xs, state.knots, centers=state.centers)
        return (z @ state.coef[..., None])[..., 0]
    return state.coef[..., :1] + (xs @ state.coef[..., 1:, None])[..., 0]


def importance(state, names) -> dict:
    """Raw-scale coefficients keyed by term, like mgcv's coefficient report
    (one unbatched model).  For a smooth fit, each term reports its linear
    slope and the L2 norm of its spline coefficients."""
    if isinstance(state, GAMSmoothState):
        p = len(names)
        lin = (state.coef[1 : 1 + p] / state.x_scale).tolist()
        out = {"(Intercept)": float(state.coef[0]), "edf": float(state.eff_df), "lambda": float(state.lam)}
        for f, n in enumerate(names):
            spl = state.coef[1 + p + f * state.k : 1 + p + (f + 1) * state.k]
            out[n] = {"linear": lin[f], "s_norm": float(torch.linalg.norm(spl))}
        return out
    raw = state.coef[1:] / state.x_scale
    intercept = state.coef[0] - torch.sum(raw * state.x_mean)
    out = {"(Intercept)": float(intercept)}
    for n, c in zip(names, raw.tolist()):
        out[n] = float(c)
    return out
