"""Low-rank (Nystrom / reduced-basis) thin-plate splines for large n.

Counterpart of ``machisplin_tpu/ops/nystrom.py``.  The dense fit is O(n^3);
for BASELINE configs 3-5 (10k-500k stations) this module fits the penalised
reduced-basis spline

    f(x) = sum_j c_j phi(|x - z_j|) + d . [1, x, y]
    min  |y - K_nz c - T d|^2  +  lam * c' K_zz c

with m << n landmark knots z_j (a random subsample refined by a few k-means
sweeps).  GCV over lam costs one (m+3) eigendecomposition of the whitened
penalty (Cholesky of B'B, eigh of R^-T P R^-1); RSS(lam) and the effective
df tr((I + lam M)^-1) are then closed-form in the eigenvalues, vectorised
over a lambda grid.

Every O(n m) pass streams over the stations in chunks: the k-means sweeps,
the cross-products G = B'B, B'y, y'y, and the fitted values, so memory holds
O(chunk m), never (n, m).  They are float32 matmuls with TF32 off in the
coordinates' dtype.  The (m+3) solve tail runs in float64 on the device the
model lives on, as the JAX package's concrete branch does on the host, then
the GCV and the coefficients return to the coordinates' dtype as there.
Prediction is ``tps_predict_grid`` with the landmarks as knots (K1 on the
card).
"""
from __future__ import annotations

import torch

from ..utils import resolve_device
from ..utils.timing import PhaseTimer
from .tps import TPSModel, _pairwise_r2, _phi

__all__ = ["select_landmarks", "nystrom_tps_fit"]

# stations per k-means chunk: (chunk, m) distances and one-hot, 134 MB each
# in float32 at m = 4096
_KMEANS_CHUNK = 8192


def select_landmarks(coords, m: int, kmeans_iters: int = 5, *, init_idx=None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """m landmark points of ``coords`` (n, 2): a subsample without
    replacement (``init_idx`` (m,) injects it, else drawn on the CPU from
    ``generator``) refined by ``kmeans_iters`` k-means sweeps; an empty
    cluster keeps its centre.

    Each sweep assigns the stations chunk by chunk: every row's nearest
    centre is the one the whole (n, m) distance matrix gives; only the order
    in which the new centres' sums are accumulated differs from one matmul
    over all stations."""
    coords = torch.as_tensor(coords)
    n = coords.shape[0]
    m = min(m, n)
    if init_idx is None:
        init_idx = torch.randperm(n, generator=generator)[:m]
    centers = coords[torch.as_tensor(init_idx, device=coords.device).long()]
    if kmeans_iters <= 0 or n <= m:
        return centers
    iota = torch.arange(m, device=coords.device)
    for _ in range(kmeans_iters):
        sums = torch.zeros((m, coords.shape[1]), dtype=coords.dtype, device=coords.device)
        counts = torch.zeros((m,), dtype=coords.dtype, device=coords.device)
        for s in range(0, n, _KMEANS_CHUNK):
            xi = coords[s : s + _KMEANS_CHUNK]
            assign = torch.argmin(_pairwise_r2(xi, centers), dim=1)
            one_hot = (assign[:, None] == iota[None, :]).to(coords.dtype)
            sums += one_hot.T @ xi
            counts += one_hot.sum(0)
        new = sums / counts.clamp_min(1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, centers)
    return centers


def _basis(xi, z):
    """B = [1, x, y, phi(|x - z_j|)] for the stations ``xi`` (c, 2)."""
    ones = torch.ones((xi.shape[0], 1), dtype=xi.dtype, device=xi.device)
    return torch.cat([ones, xi, _phi(_pairwise_r2(xi, z))], dim=1)


def _stream_stats(xs, ycols, z, chunk):
    """G = B'B, B'y and y'y over the stations, in chunks of ``chunk`` rows.
    The JAX package pads the last chunk with weight-0 rows, which add
    exact zeros; here it is just shorter."""
    p_dim = 3 + z.shape[0]
    dt, dev = xs.dtype, xs.device
    g = torch.zeros((p_dim, p_dim), dtype=dt, device=dev)
    bty = torch.zeros((p_dim, ycols.shape[1]), dtype=dt, device=dev)
    yy = torch.zeros((ycols.shape[1],), dtype=dt, device=dev)
    for s in range(0, xs.shape[0], chunk):
        b_i = _basis(xs[s : s + chunk], z)
        yi = ycols[s : s + chunk]
        g += b_i.T @ b_i
        bty += b_i.T @ yi
        yy += (yi * yi).sum(0)
    return g, bty, yy


def _stream_fitted(xs, z, d, c, chunk):
    """Fitted values (n, R), in chunks of ``chunk`` stations."""
    beta = torch.cat([d, c], dim=0)
    return torch.cat([_basis(xs[s : s + chunk], z) @ beta for s in range(0, xs.shape[0], chunk)], dim=0)


def _whitened_eigh(g, bty, kzz):
    """The float64 tail (JAX ``nystrom.py:216-246``): scale G to unit
    diagonal, Cholesky with a ridge escalated from 1e-10 by x100 up to 1e-2
    (k-means can collapse centres into duplicate columns), the penalty
    whitened by R, and its eigendecomposition.  Returns (evals, u, uu, r,
    scale), all float64."""
    p_dim = g.shape[0]
    g64 = g.double()
    scale = torch.sqrt(torch.diagonal(g64).clamp_min(1e-300))
    eye = torch.eye(p_dim, dtype=torch.float64, device=g.device)
    gs = g64 / torch.outer(scale, scale)
    rr = 1e-10
    while True:
        low, info = torch.linalg.cholesky_ex(gs + rr * eye)
        if int(info) == 0:
            break
        rr *= 100.0
        if rr > 1e-2:
            raise RuntimeError("nystrom_tps_fit: the normal equations are not positive definite")
    r = low.T
    pen = torch.zeros((p_dim, p_dim), dtype=torch.float64, device=g.device)
    pen[3:, 3:] = kzz.double() / torch.outer(scale[3:], scale[3:])
    rinv = torch.linalg.solve_triangular(r, eye, upper=True)
    mmat = rinv.T @ pen @ rinv
    evals, u = torch.linalg.eigh(0.5 * (mmat + mmat.T))
    un = bty.double() / scale[:, None]
    uu = u.T @ torch.linalg.solve_triangular(r.T, un, upper=False)
    return evals.clamp_min(0.0), u, uu, r, scale


def _logspace(lo: float, hi: float, num: int, dtype, device):
    """jnp.logspace's arithmetic: 10 ** (lo (1 - s) + hi s), exact endpoint."""
    s = torch.arange(num - 1, dtype=dtype, device=device) / (num - 1)
    lin = torch.cat([lo * (1 - s) + hi * s, torch.full((1,), hi, dtype=dtype, device=device)])
    return torch.pow(torch.tensor(10.0, dtype=dtype, device=device), lin)


def nystrom_tps_fit(coords, y, landmarks=None, m: int = 2048, lam=None,
                    generator: torch.Generator | None = None, chunk: int = 65536, ngrid: int = 128,
                    device=None, timer: PhaseTimer | None = None) -> TPSModel:
    """Fit the reduced-basis smoothing spline; returns a TPSModel whose knots
    are the (range-scaled) landmarks, so every TPS prediction path applies.

    ``coords`` (n, 2), ``y`` (n,) or (n, R); lambda is GCV-selected per
    response on ``logspace(-10, 6, ngrid)`` when None.  ``landmarks`` (m, 2)
    in raw coordinates injects the centres; else ``select_landmarks`` draws
    m of them from ``generator``.  The fit runs on ``device``: by default the
    device of ``coords`` when it is a tensor, else the GPU.  ``timer``
    collects the seconds of its steps ("landmarks", "stream_stats",
    "f64_tail", "gcv_coef", "fitted"), each synchronised on a GPU."""
    timer = timer or PhaseTimer()
    if device is None:
        device = coords.device if isinstance(coords, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    coords = torch.as_tensor(coords, device=dev)
    dtype = coords.dtype
    y = torch.as_tensor(y, device=dev).to(dtype)
    single = y.ndim == 1
    ycols = y[:, None] if single else y
    n = ycols.shape[0]

    cmin = coords.amin(0)
    crange = (coords.amax(0) - cmin).clamp_min(1e-30)
    xs = (coords - cmin) / crange
    with timer.phase("landmarks"):
        if landmarks is None:
            z = select_landmarks(xs, m, generator=generator)
        else:
            z = (torch.as_tensor(landmarks, device=dev).to(dtype) - cmin) / crange
    with timer.phase("stream_stats"):
        kzz = _phi(_pairwise_r2(z, z))
        g, bty, yy = _stream_stats(xs, ycols, z, chunk)
    with timer.phase("f64_tail"):
        evals, u, uu, r, scale = (a.to(dtype) for a in _whitened_eigh(g, bty, kzz))

    with timer.phase("gcv_coef"):
        lam_sel, gcv_min, s, c, d = _gcv_and_coef(evals, u, uu, r, scale, yy, n, lam, ngrid)
    with timer.phase("fitted"):
        fitted = _stream_fitted(xs, z, d, c, chunk)
    residuals = ycols - fitted
    eff_df = s.sum(0)
    if single:
        c, d, fitted, residuals = c[:, 0], d[:, 0], fitted[:, 0], residuals[:, 0]
        lam_sel, gcv_min, eff_df = lam_sel[0], gcv_min[0], eff_df[0]
    return TPSModel(
        knots=z, c=c, d=d, shift=cmin, scale=crange, lam=lam_sel, gcv=gcv_min,
        fitted=fitted, residuals=residuals, eff_df=eff_df,
    )


def _gcv_and_coef(evals, u, uu, r, scale, yy, n: int, lam, ngrid: int):
    """lambda by GCV on ``logspace(-10, 6, ngrid)`` per response (or the
    given one), in the coordinates' dtype as the JAX package computes it;
    returns (lambda (R,), GCV (R,), shrinkage s (p, R), c (m, R), d (3, R))."""
    dtype, dev = uu.dtype, uu.device
    if lam is None:
        grid = _logspace(-10.0, 6.0, ngrid, dtype, dev)                      # (G,)
        s = 1.0 / (1.0 + grid[:, None, None] * evals[None, :, None])         # (G, p, 1)
        fit_term = (uu[None] ** 2 * s * (2.0 - s)).sum(1)                     # (G, R)
        rss = (yy[None, :] - fit_term).clamp_min(0.0)
        df = s.sum(1)                                                         # (G, 1)
        gcv = n * rss / (n - df).clamp_min(1.0) ** 2
        lam_sel = grid[torch.argmin(gcv, dim=0)]                              # (R,)
        gcv_min = gcv.amin(0)
    else:
        lam_sel = torch.as_tensor(lam, dtype=dtype, device=dev).expand(uu.shape[1])
        s = 1.0 / (1.0 + lam_sel[None, :] * evals[:, None])
        fit_term = (uu**2 * s * (2.0 - s)).sum(0)
        gcv_min = n * (yy - fit_term).clamp_min(0.0) / (n - s.sum(0)).clamp_min(1.0) ** 2

    s = 1.0 / (1.0 + lam_sel[None, :] * evals[:, None])                      # (p, R)
    gamma = u @ (s * uu)
    beta = torch.linalg.solve_triangular(r, gamma, upper=True) / scale[:, None]
    return lam_sel, gcv_min, s, beta[3:], beta[:3]
