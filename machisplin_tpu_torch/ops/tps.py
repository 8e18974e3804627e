"""Thin-plate smoothing spline solver with GCV smoothing selection.

Counterpart of ``machisplin_tpu/ops/tps.py`` (``fields::Tps`` as the reference
uses it, V73:722/751; prediction ``terra::interpolate``, V73:726/753):

* radial basis phi(r) = r^2 log r with the {1, x, y} null space; coordinates
  range-scaled per dimension (fields ``scale.type='range'``);
* the smoothing parameter minimises ``V(lam) = n RSS / tr(I - A)^2`` through
  the Demmler-Reinsch eigendecomposition of the null-space-projected kernel;
* masked knots: a 0/1 mask lets tiles with different point counts pad to one
  shape; padded knots are spliced in as exact eigenpairs with eigenvalue
  ``kappa`` and subtracted from tr(I - A) in closed form, so the fit is exactly
  the fit on the active subset.

Every function takes an optional leading batch axis (one factorisation per
tile), where the JAX package used ``vmap``.  Pairwise distances are explicit
differences, never the |a|^2 + |b|^2 - 2ab' expansion.

``tps_fit_auto`` is the scale policy of BASELINE configs 3-5: the exact
factorisation up to ``MAX_DEVICE_EIGH_KNOTS`` stations, the Nystrom
reduced-basis fit (``ops/nystrom.py``) above it, and the float64 host fit
(``ops/host_tps.py``) for ``method="exact"`` above it.
"""
from __future__ import annotations

from typing import NamedTuple

import logging

import torch

from ..grid import GridSpec
from ..utils import resolve_device
from ..utils.timing import span

log = logging.getLogger("machisplin_tpu_torch.tps")

__all__ = [
    "TPSFactor",
    "TPSModel",
    "tps_factor",
    "tps_solve",
    "tps_fit",
    "tps_fit_auto",
    "tps_predict",
    "tps_predict_grid",
    "gcv_curve",
    "MAX_DEVICE_EIGH_KNOTS",
]


def _phi(r2):
    """phi(r) = r^2 log r = 0.5 * r^2 * log(r^2), with phi(0) = 0."""
    safe = r2.clamp_min(torch.finfo(r2.dtype).tiny)
    return torch.where(r2 > 0, 0.5 * r2 * torch.log(safe), torch.zeros((), dtype=r2.dtype, device=r2.device))


def _pairwise_r2(a, b):
    """Squared distances between (..., n, 2) and (..., m, 2) by explicit
    differences (the matmul expansion cancels catastrophically near r=0)."""
    dx = a[..., :, 0, None] - b[..., None, :, 0]
    dy = a[..., :, 1, None] - b[..., None, :, 1]
    return dx * dx + dy * dy


class TPSFactor(NamedTuple):
    """Reusable factorisation of the TPS system for one knot set (or a batch
    of them along a leading axis)."""

    knots: torch.Tensor     # (..., n, 2) scaled coords (masked rows at 0.5)
    mask: torch.Tensor      # (..., n) 1.0 active / 0.0 padded
    shift: torch.Tensor     # (..., 2) range-scaling offset
    scale: torch.Tensor     # (..., 2) range-scaling divisor
    q2u: torch.Tensor       # (..., n, n-3) Q2 @ U
    evals: torch.Tensor     # (..., n-3) eigenvalues of the projected kernel
    q1: torch.Tensor        # (..., n, 3)
    rmat: torch.Tensor      # (..., 3, 3) upper-triangular from QR of T
    bmat: torch.Tensor      # (..., 3, n-3) = Q1' K Q2U
    kappa: torch.Tensor     # (...) masked-direction eigenvalue
    n_active: torch.Tensor  # (...) number of active knots
    n_masked: torch.Tensor  # (...) number of padded knots


class TPSModel(NamedTuple):
    """Fitted spline: everything needed to predict at new points."""

    knots: torch.Tensor     # (n, 2) scaled coords
    c: torch.Tensor         # (n,) or (n, R) radial coefficients
    d: torch.Tensor         # (3,) or (3, R) polynomial coefficients [1, x, y]
    shift: torch.Tensor     # (2,)
    scale: torch.Tensor     # (2,)
    lam: torch.Tensor       # () or (R,) smoothing parameter (rho / n_active)
    gcv: torch.Tensor       # () or (R,) minimised GCV value
    fitted: torch.Tensor    # (n,) or (n, R) fitted values at knots (0 at padded)
    residuals: torch.Tensor  # (n,) or (n, R) y - fitted (0 at padded)
    eff_df: torch.Tensor    # () or (R,) tr(A)


def _mT(a):
    return a.transpose(-1, -2)


def tps_factor(coords, mask=None) -> TPSFactor:
    """Factorise the TPS system for one set of knots, or a batch of them.

    coords: (n, 2) or (T, n, 2) raw coordinates (e.g. LONG, LAT).
    mask:   optional (n,) or (T, n) 0/1; padded rows are excluded exactly.

    Spans: ``tps.factor`` holding ``tps.kernel_matrix``, ``tps.qr``,
    ``tps.eigh`` (the projection GEMMs and the eigendecomposition) and
    ``tps.basis``.
    """
    with span("tps.factor"):
        return _factor(coords, mask)


def _factor(coords, mask) -> TPSFactor:
    coords = torch.as_tensor(coords)
    batched = coords.ndim == 3
    if not batched:
        coords = coords[None]
        mask = None if mask is None else torch.as_tensor(mask)[None]
    dtype, dev = coords.dtype, coords.device
    b, n, _ = coords.shape
    mask = (
        torch.ones((b, n), dtype=dtype, device=dev) if mask is None
        else torch.as_tensor(mask, device=dev).to(dtype)
    )
    n_active = mask.sum(-1)
    n_masked = n - n_active
    on = mask[..., None] > 0

    with span("tps.kernel_matrix"):
        big = torch.finfo(dtype).max
        cmin = torch.where(on, coords, big).amin(dim=1)
        cmax = torch.where(on, coords, -big).amax(dim=1)
        scale = torch.where(cmax > cmin, cmax - cmin, torch.ones((), dtype=dtype, device=dev))
        x = (coords - cmin[:, None, :]) / scale[:, None, :]
        x = torch.where(on, x, torch.full((), 0.5, dtype=dtype, device=dev))

        k = _phi(_pairwise_r2(x, x))
        m_out = mask[:, :, None] * mask[:, None, :]
        kappa = 2.0 * torch.abs(k * m_out).sum(-1).amax(-1)  # Gershgorin bound
        kappa = kappa.clamp_min(1.0)
        k_t = k * m_out + kappa[:, None, None] * torch.diag_embed(1.0 - mask)

    with span("tps.qr"):
        t = torch.cat([mask[..., None], x * mask[..., None]], dim=-1)  # (b, n, 3)
        q, r = torch.linalg.qr(t, mode="complete")
        q1, q2 = q[..., :3], q[..., 3:]
    with span("tps.eigh"):
        m_proj = _mT(q2) @ k_t @ q2
        evals, u = torch.linalg.eigh(0.5 * (m_proj + _mT(m_proj)))
    with span("tps.basis"):
        evals = evals.clamp_min(0.0)  # c.p.d. of order 2 on this subspace
        q2u = q2 @ u
        bmat = _mT(q1) @ (k_t @ q2u)
    f = TPSFactor(
        knots=x, mask=mask, shift=cmin, scale=scale, q2u=q2u, evals=evals,
        q1=q1, rmat=r[..., :3, :3], bmat=bmat, kappa=kappa,
        n_active=n_active, n_masked=n_masked,
    )
    return f if batched else TPSFactor(*(a[0] for a in f))


def _gcv_terms(evals, n_masked, kappa, u_coef, rho):
    """RSS(rho) and active tr(I - A)(rho).

    evals (B, m); n_masked, kappa (B,); u_coef (B, R, m) or (B, R, G, m) with
    rho (B, R) or (B, R, G) matching u_coef's leading dims."""
    extra = u_coef.ndim - 2  # 1 for (B, R, m), 2 for (B, R, G, m)
    ev = evals.reshape(evals.shape[:1] + (1,) * extra + evals.shape[1:])
    shrink = rho[..., None] / (ev + rho[..., None])
    rss = ((u_coef * shrink) ** 2).sum(-1)
    nm = n_masked.reshape((-1,) + (1,) * extra)
    kp = kappa.reshape((-1,) + (1,) * extra)
    tr = shrink.sum(-1) - nm * rho / (kp + rho)
    return rss, tr


def _gcv_value(f, u_coef, rho):
    rss, tr = _gcv_terms(f.evals, f.n_masked, f.kappa, u_coef, rho)
    n_a = f.n_active.reshape((-1,) + (1,) * (rss.ndim - 1))
    return n_a * rss / tr.clamp_min(torch.finfo(rss.dtype).tiny) ** 2


def _gcv_search(f: TPSFactor, u_coef, ngrid: int, refine: int):
    """Minimise V(rho) per response: log-space grid + golden-section refine.

    u_coef: (B, R, m).  Returns rho (B, R)."""
    dtype, dev = u_coef.dtype, u_coef.device
    dmax = f.evals.amax(-1).clamp_min(1.0)                            # (B,)
    lo = torch.log(dmax * 1e-12 + torch.finfo(dtype).tiny)
    hi = torch.log(dmax * 1e4)
    # jnp.linspace's arithmetic: start * (1 - s) + stop * s, exact endpoint
    s = (torch.arange(ngrid - 1, dtype=dtype, device=dev) / (ngrid - 1))
    lin = torch.cat([lo[:, None] * (1 - s) + hi[:, None] * s, hi[:, None]], dim=1)
    grid = torch.exp(lin)                                              # (B, G)
    b, r_, _ = u_coef.shape
    v = _gcv_value(f, u_coef[:, :, None, :], grid[:, None, :].expand(b, r_, ngrid))
    idx = torch.argmin(v, dim=-1)                                      # (B, R)
    log_grid = torch.log(grid)
    a = torch.gather(log_grid, 1, (idx - 1).clamp_min(0))
    bb = torch.gather(log_grid, 1, (idx + 1).clamp_max(ngrid - 1))
    invphi = (torch.sqrt(torch.tensor(5.0, dtype=dtype, device=dev)) - 1.0) / 2.0
    for _ in range(refine):
        c = bb - invphi * (bb - a)
        d = a + invphi * (bb - a)
        vc = _gcv_value(f, u_coef, torch.exp(c))
        vd = _gcv_value(f, u_coef, torch.exp(d))
        smaller = vc < vd
        a, bb = torch.where(smaller, a, c), torch.where(smaller, d, bb)
    return torch.exp((a + bb) / 2.0)


def tps_solve(f: TPSFactor, y, lam=None, ngrid: int = 200, refine: int = 40) -> TPSModel:
    """Solve for spline coefficients; GCV-select smoothing if lam is None.

    y: (n,) or (n, R) for a single factor; (T, n) or (T, n, R) for a batched
    one.  lam: fixed smoothing parameter(s) (fields' lambda = rho / n_active).

    Spans: ``tps.solve`` holding ``tps.gcv_search`` (when lam is None) and
    ``tps.coef``; the projection of y onto the eigenbasis is its own time.
    """
    with span("tps.solve"):
        return _solve(f, y, lam, ngrid, refine)


def _solve(f: TPSFactor, y, lam, ngrid: int, refine: int) -> TPSModel:
    batched = f.mask.ndim == 2
    if not batched:
        f = TPSFactor(*(a[None] for a in f))
        y = torch.as_tensor(y)[None]
    y = torch.as_tensor(y, device=f.mask.device)
    single = y.ndim == 2
    ycols = y[..., None] if single else y                         # (B, n, R)
    ym = ycols * f.mask[..., None]
    u_coef = _mT(_mT(f.q2u) @ ym)                                  # (B, R, m)

    if lam is None:
        with span("tps.gcv_search"):
            rho = _gcv_search(f, u_coef, ngrid, refine)           # (B, R)
    else:
        lam_t = torch.as_tensor(lam, dtype=y.dtype, device=y.device)
        rho = (lam_t * f.n_active[:, None]).expand(ycols.shape[0], ycols.shape[2])
    with span("tps.coef"):
        gcv = _gcv_value(f, u_coef, rho)
        _, tr = _gcv_terms(f.evals, f.n_masked, f.kappa, u_coef, rho)
        eff_df = f.n_active[:, None] - tr

        gamma = _mT(u_coef / (f.evals[:, None, :] + rho[..., None]))  # (B, m, R)
        c = f.q2u @ gamma                                              # (B, n, R)
        rhs = _mT(f.q1) @ ym - f.bmat @ gamma                          # (B, 3, R)
        d = torch.linalg.solve_triangular(f.rmat, rhs, upper=True)
        residuals = rho[:, None, :] * c * f.mask[..., None]
        fitted = (ym - residuals) * f.mask[..., None]
        lam_out = rho / f.n_active[:, None]

    if single:
        c, d, fitted, residuals = c[..., 0], d[..., 0], fitted[..., 0], residuals[..., 0]
        lam_out, gcv, eff_df = lam_out[:, 0], gcv[:, 0], eff_df[:, 0]
    m = TPSModel(
        knots=f.knots, c=c, d=d, shift=f.shift, scale=f.scale, lam=lam_out,
        gcv=gcv, fitted=fitted, residuals=residuals, eff_df=eff_df,
    )
    return m if batched else TPSModel(*(a[0] for a in m))


def tps_fit(coords, y, mask=None, lam=None, ngrid: int = 200, refine: int = 40) -> TPSModel:
    """Factor + solve (the ``fields::Tps(xy, y)`` call shape)."""
    return tps_solve(tps_factor(coords, mask), y, lam=lam, ngrid=ngrid, refine=refine)


def gcv_curve(f: TPSFactor, y, rho) -> torch.Tensor:
    """GCV values V(rho) over a rho grid for one factor: y (n,) or (n, R),
    rho (G,).  Returns (G,) for a single response or (R, G) for a stack."""
    y = torch.as_tensor(y, device=f.mask.device)
    single = y.ndim == 1
    fb = TPSFactor(*(a[None] for a in f))
    ycols = (y[:, None] if single else y) * f.mask[:, None]
    u_coef = _mT(f.q2u.T @ ycols)[None]                           # (1, R, m)
    rho = torch.as_tensor(rho, dtype=u_coef.dtype, device=u_coef.device)
    g = rho.shape[0]
    v = _gcv_value(fb, u_coef[:, :, None, :], rho[None, None, :].expand(1, u_coef.shape[1], g))[0]
    return v[0] if single else v


# The JAX package's exact-fit ceiling: past ~9k knots XLA's eigh workspace
# exceeds one v5e chip's 16 GB.  It is kept as the port's default so that a
# given n takes the same fit in both packages (the card's own eigh ceiling is
# an open question in PERF.md).
MAX_DEVICE_EIGH_KNOTS = 8192


def _auto_route(n: int, method: str = "auto", max_device_knots: int | None = None,
                landmarks: int | None = None):
    """The fit ``tps_fit_auto`` takes for n stations: ("exact", None),
    ("host", None) or ("nystrom", m)."""
    limit = MAX_DEVICE_EIGH_KNOTS if max_device_knots is None else max_device_knots
    if method == "auto":
        method = "exact" if n <= limit else "nystrom"
    if method == "nystrom":
        m = landmarks if landmarks is not None else (2048 if n <= 65536 else 4096)
        return "nystrom", min(m, n)
    if method != "exact":
        raise ValueError(f"unknown method {method!r}")
    return ("exact", None) if n <= limit else ("host", None)


def tps_fit_auto(coords, y, lam=None, ngrid: int = 200, refine: int = 40,
                 max_device_knots: int | None = None, method: str = "auto",
                 landmarks: int | None = None, generator: torch.Generator | None = None,
                 mask=None, device=None) -> TPSModel:
    """``tps_fit`` with the scale policy of BASELINE configs 3-5.

    ``method="auto"``: the exact factorisation for n <= ``max_device_knots``
    (default ``MAX_DEVICE_EIGH_KNOTS``), else the Nystrom reduced-basis fit
    with ``landmarks`` centres (default 2048 up to 65,536 stations, 4096
    beyond; drawn from ``generator``).  ``method="exact"`` forces the dense
    fit: on the device up to the limit, else the float64 host path
    (``ops/host_tps.py``); ``method="nystrom"`` forces the reduced basis.
    Dense rows only: ``mask`` raises (the masked tile path is
    ``tps_factor(coords, mask)`` + ``tps_solve``).

    The fit runs on ``device``: by default the device of ``coords`` when it
    is a tensor, else the GPU.  Span: ``tps.fit``, holding the route's own
    (``tps.factor`` and ``tps.solve``, ``tps.host_fit``, or the Nystrom
    fit's ``nystrom.*``)."""
    if mask is not None:
        raise ValueError(
            "tps_fit_auto fits dense rows only; use tps_factor(coords, mask) "
            "+ tps_solve for the masked/padded-tile path"
        )
    if device is None:
        device = coords.device if isinstance(coords, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    n = coords.shape[0]
    route, m = _auto_route(n, method, max_device_knots, landmarks)
    log.info("tps_fit_auto: %d stations -> %s%s", n, route, f" ({m} landmarks)" if m else "")
    with span("tps.fit"):
        if route == "nystrom":
            from .nystrom import nystrom_tps_fit

            return nystrom_tps_fit(coords, y, m=m, lam=lam, generator=generator, device=dev)
        if route == "host":
            from .host_tps import tps_fit_host

            with span("tps.host_fit"):
                return tps_fit_host(coords, y, lam=lam, ngrid=ngrid, refine=refine, device=dev)
        coords = torch.as_tensor(coords, device=dev)
        return tps_fit(coords, torch.as_tensor(y, device=dev).to(coords.dtype), lam=lam, ngrid=ngrid,
                       refine=refine)


def _predict_block(model: TPSModel, pts_scaled):
    """Spline evaluation at (m, 2) scaled points -> (m,) or (m, R)."""
    phi = _phi(_pairwise_r2(pts_scaled, model.knots))
    ones = torch.ones(pts_scaled.shape[0], 1, dtype=pts_scaled.dtype, device=pts_scaled.device)
    poly = torch.cat([ones, pts_scaled], dim=1)
    return phi @ model.c + poly @ model.d


def tps_predict(model: TPSModel, points) -> torch.Tensor:
    """Evaluate the spline at raw-coordinate points (m, 2)."""
    pts = (torch.as_tensor(points, device=model.c.device) - model.shift) / model.scale
    return _predict_block(model, pts)


def tps_predict_grid(model: TPSModel, grid: GridSpec, block_rows: int = 256) -> torch.Tensor:
    """Evaluate the spline at every cell centre of ``grid``.

    On a CUDA model this launches the hand-written grid kernel (K1, in
    float32); on a CPU model it runs the kernel's plain version in the
    model's dtype, streamed over ``block_rows`` rows.  Returns (H, W) or
    (H, W, R).  Span: ``tps.surface``, holding ``k1.tables`` and
    ``k1.launch``."""
    from .tps_grid import tps_grid

    with span("tps.surface"):
        return tps_grid(model, grid, block_rows=block_rows)
