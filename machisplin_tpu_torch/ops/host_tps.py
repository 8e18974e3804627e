"""Host (NumPy/LAPACK, float64) TPS factorisation — same math as ops/tps.py.

Counterpart of ``machisplin_tpu/ops/host_tps.py``.  The dense fit is O(n^3)
in the station count and O(n^2) in memory; ``tps_fit_auto(method="exact")``
sends it here above the exact device path's knot limit.  The fitted model is
returned on the requested device, so its surface goes through the grid
kernel (K1) like every other spline.

The null-space projection never materialises Q: the complete (n, n)
orthogonal factor of the (n, 3) polynomial basis is only applied (LAPACK
ormqr with its three Householder reflectors, O(n^2)), so the eigh is the one
cubic step.  Pairwise distances accumulate per dimension in place, which
bounds the peak memory at ~3 (n, n) float64 buffers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import resolve_device
from .tps import TPSModel

__all__ = ["tps_fit_host"]


def _phi_np(r2):
    """phi(r) = 0.5 r^2 log r^2 elementwise, phi(0) = 0, in place of r2's
    copy (no mask gathers: they would copy the (n, n) matrix twice)."""
    with np.errstate(divide="ignore"):
        lg = np.log(np.maximum(r2, np.finfo(np.float64).tiny))
    out = 0.5 * r2 * lg
    out[r2 <= 0] = 0.0
    return out


def _pairwise_r2_np(x):
    """Squared pairwise distances, per-dimension in-place accumulation."""
    d2 = np.subtract.outer(x[:, 0], x[:, 0])
    np.multiply(d2, d2, out=d2)
    for j in range(1, x.shape[1]):
        dj = np.subtract.outer(x[:, j], x[:, j])
        np.multiply(dj, dj, out=dj)
        d2 += dj
    return d2


class _ImplicitQ:
    """The complete orthogonal factor of a thin (n, k) basis, held as its
    Householder reflectors and applied via LAPACK ormqr (O(k n) a column),
    never materialised."""

    def __init__(self, t):
        from scipy.linalg import get_lapack_funcs

        t = np.asfortranarray(np.asarray(t, np.float64))
        geqrf, ormqr = get_lapack_funcs(("geqrf", "ormqr"), (t,))
        self._ormqr = ormqr
        self.qr_raw, self.tau, _, info = geqrf(t)
        if info != 0:
            raise RuntimeError(f"geqrf failed: {info}")
        self.k = t.shape[1]
        self.r = np.triu(self.qr_raw[: self.k, : self.k])

    def apply(self, c, side="L", trans="N"):
        """Q @ c ('L','N'), Q' @ c ('L','T'), c @ Q ('R','N'), ..."""
        c = np.asfortranarray(np.asarray(c, np.float64))
        _, work, info = self._ormqr(side, trans, self.qr_raw, self.tau, c, lwork=-1)
        out, _, info = self._ormqr(side, trans, self.qr_raw, self.tau, c, lwork=int(work[0]))
        if info != 0:
            raise RuntimeError(f"ormqr failed: {info}")
        return out


def tps_fit_host(coords, y, lam=None, ngrid: int = 200, refine: int = 40, device=None) -> TPSModel:
    """GCV thin-plate smoothing spline factorised on the host in float64.

    ``coords`` (n, 2) and ``y`` (n,) or (n, R), numpy or tensors.  Returns a
    TPSModel on ``device`` (by default the device of ``coords`` when it is a
    tensor, else the GPU), in the dtype of ``coords`` when it is floating
    (float64 otherwise)."""
    if device is None:
        device = coords.device if isinstance(coords, torch.Tensor) else "cuda"
    dev = resolve_device(device)
    as_np = lambda a: a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    src = as_np(coords)
    out_dtype = torch.from_numpy(src[:0]).dtype if src.dtype.kind == "f" else torch.float64
    coords = src.astype(np.float64)
    ycols = as_np(y).astype(np.float64)
    single = ycols.ndim == 1
    if single:
        ycols = ycols[:, None]
    n, n_resp = ycols.shape

    cmin = coords.min(axis=0)
    crange = np.where(coords.max(axis=0) > cmin, coords.max(axis=0) - cmin, 1.0)
    x = (coords - cmin) / crange

    k = _phi_np(_pairwise_r2_np(x))
    t = np.concatenate([np.ones((n, 1)), x], axis=1)
    q = _ImplicitQ(t)
    # Q' K Q by two reflector applications (O(n^2) each, K symmetric); the
    # row/column blocks of the result replace every use of Q1/Q2 below
    qkq = q.apply(q.apply(k, "L", "T"), "R", "N")
    del k
    m = qkq[3:, 3:]
    evals, u = np.linalg.eigh(0.5 * (m + m.T))
    evals = np.maximum(evals, 0.0)
    qty = q.apply(ycols, "L", "T")                 # (n, R): [Q1'y; Q2'y]
    u_coef = u.T @ qty[3:]                         # (n-3, R)

    if lam is None:
        dmax = max(evals.max(), 1.0)
        grid = np.exp(np.linspace(np.log(dmax * 1e-12 + 1e-300), np.log(dmax * 1e4), ngrid))
        shrink = grid[None, :, None] / (evals[:, None, None] + grid[None, :, None])
        rss = np.sum((u_coef[:, None, :] * shrink) ** 2, axis=0)     # (G, R)
        tr = np.sum(shrink[:, :, 0], axis=0)                          # (G,)
        v = n * rss / np.maximum(tr[:, None], 1e-300) ** 2
        idx = np.argmin(v, axis=0)
        lo = np.log(grid[np.maximum(idx - 1, 0)])
        hi = np.log(grid[np.minimum(idx + 1, ngrid - 1)])
        invphi = (np.sqrt(5.0) - 1) / 2

        def vval(rho):                                # rho (R,)
            sh = rho[None, :] / (evals[:, None] + rho[None, :])
            rss = np.sum((u_coef * sh) ** 2, axis=0)
            tr = np.sum(sh, axis=0)
            return n * rss / np.maximum(tr, 1e-300) ** 2

        for _ in range(refine):
            c1 = hi - invphi * (hi - lo)
            c2 = lo + invphi * (hi - lo)
            smaller = vval(np.exp(c1)) < vval(np.exp(c2))
            lo = np.where(smaller, lo, c1)
            hi = np.where(smaller, c2, hi)
        rho = np.exp((lo + hi) / 2)
    else:
        rho = np.broadcast_to(np.asarray(lam, np.float64) * n, (n_resp,)).copy()

    gamma = u_coef / (evals[:, None] + rho[None, :])
    ug = u @ gamma                                 # (n-3, R) eigen -> Q2 basis
    pad = np.zeros((n, n_resp))
    pad[3:] = ug
    c = q.apply(pad, "L", "N")                     # Q2 @ (U gamma)
    # bmat @ gamma = (Q1' K Q2 U) gamma = qkq[:3, 3:] @ ug
    rhs = qty[:3] - qkq[:3, 3:] @ ug
    d = np.linalg.solve(q.r, rhs)
    residuals = rho[None, :] * c
    fitted = ycols - residuals
    sh = rho[None, :] / (evals[:, None] + rho[None, :])
    gcv = n * np.sum((u_coef * sh) ** 2, axis=0) / np.maximum(np.sum(sh, axis=0), 1e-300) ** 2
    eff_df = n - np.sum(sh, axis=0)

    if single:
        c, d, fitted, residuals = c[:, 0], d[:, 0], fitted[:, 0], residuals[:, 0]
        rho, gcv, eff_df = rho[0], gcv[0], eff_df[0]
    t_ = lambda a: torch.as_tensor(np.asarray(a), dtype=out_dtype, device=dev)
    return TPSModel(
        knots=t_(x), c=t_(c), d=t_(d), shift=t_(cmin), scale=t_(crange), lam=t_(rho / n),
        gcv=t_(gcv), fitted=t_(fitted), residuals=t_(residuals), eff_df=t_(eff_df),
    )
