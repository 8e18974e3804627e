"""Plain reference of the exact thin-plate smoothing spline (``fields::Tps``
as MACHISPLIN calls it), every station a knot.  Plain PyTorch; imports
nothing of the port.

For stations x_i range-scaled to the unit square per axis:

    f(x) = d . [1, x, y] + sum_i c_i phi(|x - x_i|),   phi(r) = r^2 log r
    min  |y - f(x)|^2 + rho c' K c  with  T'c = 0,    rho = n lam

solved through the Demmler-Reinsch basis: the QR of T = [1, x, y] gives
Q1 (n, 3), Q2 (n, n-3) and R; U diag(e) U' = Q2' K Q2.  With u = (Q2 U)' y,
RSS(rho) = |rho / (e + rho) u|^2 and tr(I - A) = sum rho / (e + rho), and
rho minimises GCV(rho) = n RSS / tr(I - A)^2: the least of 200 points
spaced evenly in log rho from log(1e-12 max e) to log(1e4 max e), then 40
golden-section steps between that point's neighbours.

``Precision`` is ``tps_nystrom``'s: float64 for the reference, and the
control one step below the configuration (matrix products' operands in
TF32, other float32 arithmetic in bfloat16; the QR and eigh in float32).
"""
from __future__ import annotations

import math

import torch

from .tps_nystrom import F64, Precision, _phi, _r2

GRID, REFINE = 200, 40


def fit(coords, ys, prec: Precision = F64) -> dict:
    """The spline of ``ys`` (n, R) at ``coords`` (n, 2): a spline dict as
    ``tps_nystrom``'s (``z`` the scaled stations), with ``gcv(rho)``, GCV at
    rho (..., R) in float64."""
    dt = prec.dtype
    coords, ys = coords.to(dt), ys.to(dt)
    n = coords.shape[0]
    shift = coords.amin(0)
    scale = (coords.amax(0) - shift).clamp_min(1e-30)
    x = prec.ew((coords - shift) / scale)
    k = prec.ew(_phi(prec.ew(_r2(x, x))))
    t = torch.cat([torch.ones_like(x[:, :1]), x], 1)
    q, r = torch.linalg.qr(t, mode="complete")
    q1, q2 = q[:, :3], q[:, 3:]
    m = prec.mm(q2.T, prec.mm(k, q2))
    e, u = torch.linalg.eigh(0.5 * (m + m.T))
    e = e.clamp_min(0.0)
    q2u = prec.mm(q2, u)
    ucoef = prec.mm(q2u.T, ys).double()                                   # (n - 3, R)
    e64 = e.double()

    def gcv(rho):
        shrink = rho[..., None, :] / (e64[:, None] + rho[..., None, :])    # (..., n - 3, R)
        rss = ((shrink * ucoef) ** 2).sum(-2)
        return n * rss / shrink.sum(-2).clamp_min(1e-300) ** 2

    emax = float(e64.max().clamp_min(1.0))
    lo, hi = math.log(emax * 1e-12 + torch.finfo(dt).tiny), math.log(emax * 1e4)
    logs = torch.linspace(lo, hi, GRID, dtype=torch.float64, device=ucoef.device)
    v = gcv(torch.exp(logs)[:, None].expand(-1, ys.shape[1]))
    idx = torch.argmin(v, dim=0)
    a, b = logs[(idx - 1).clamp_min(0)], logs[(idx + 1).clamp_max(GRID - 1)]
    invphi = (math.sqrt(5.0) - 1.0) / 2.0
    for _ in range(REFINE):
        c_, d_ = b - invphi * (b - a), a + invphi * (b - a)
        smaller = gcv(torch.exp(c_)) < gcv(torch.exp(d_))
        a, b = torch.where(smaller, a, c_), torch.where(smaller, d_, b)
    rho = torch.exp((a + b) / 2.0)
    gamma = (ucoef / (e64[:, None] + rho[None, :])).to(dt)
    c = prec.mm(q2u, gamma)
    rhs = prec.mm(q1.T, ys) - prec.mm(q1.T, prec.mm(k, c))
    d = torch.linalg.solve_triangular(r[:3, :3], rhs, upper=True)
    fitted = ys.double() - rho[None, :] * c.double()
    return {"lam": rho / n, "fitted": fitted, "c": c.double(), "d": d.double(), "z": x, "shift": shift,
            "scale": scale, "gcv": gcv}
