"""Plain reference of the reduced-basis (Nystrom) thin-plate smoothing spline
and of its surface over a grid.  Plain PyTorch; imports nothing of the port.

The spline, for stations x_i (range-scaled to the unit square per axis) and
m landmark knots z_j:

    f(x) = d . [1, x, y] + sum_j c_j phi(|x - z_j|),   phi(r) = r^2 log r
    min  J(beta) = |y - B beta|^2 + lam * c' K_zz c,     B = [1, x, y, phi(|x_i - z_j|)]

* knots: m stations drawn without replacement (the first m of
  ``torch.randperm(n)`` from the call's landmark seed), moved by 5 k-means
  sweeps over all stations; an empty cluster keeps its centre;
* lam: the minimum of GCV(lam) = n RSS / (n - df)^2 over
  ``10 ** linspace(-10, 6, 128)``, RSS and df = tr(hat) from the
  eigendecomposition of the penalty whitened by the Cholesky factor of
  B'B (scaled to a unit diagonal, with a ridge of 1e-10, raised x100 while
  the factorisation fails, as duplicate centres make B'B singular);
* the surface at a cell centre is f there.

A spline is a dict: ``z`` (m, 2) knots in scaled coordinates, ``c`` (m, R),
``d`` (3, R) over [1, x, y] in scaled coordinates, ``shift`` and ``scale``
(2,), ``lam`` (R,) and ``fitted`` (n, R).

``Precision("float64")`` is the reference.  ``Precision("control")`` is its
control, the reference one step below what the configuration states: each
matrix product's operands rounded to TF32 (10 mantissa bits; the
configuration states float32 with TF32 off) and accumulated in float32, and
the other float32 arithmetic (scaled coordinates, distances, phi, the GCV's
inputs) rounded to bfloat16; the whitened solve stays in float64, as stated.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

LAM_GRID = (-10.0, 6.0, 128)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32's 10 mantissa bits (to nearest)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@dataclass(frozen=True)
class Precision:
    name: str = "float64"

    @property
    def dtype(self):
        return torch.float64 if self.name == "float64" else torch.float32

    def mm(self, a, b):
        if self.name == "control":
            return tf32_round(a.float()) @ tf32_round(b.float())
        return a @ b

    def ew(self, x):
        """Elementwise float32 results, at this precision."""
        return x.to(torch.bfloat16).to(x.dtype) if self.name == "control" else x


F64 = Precision()


def _phi(r2):
    return torch.where(r2 > 0, 0.5 * r2 * torch.log(r2.clamp_min(torch.finfo(r2.dtype).tiny)), torch.zeros_like(r2))


def _r2(a, b):
    dx = a[:, None, 0] - b[None, :, 0]
    dy = a[:, None, 1] - b[None, :, 1]
    return dx * dx + dy * dy


def landmarks(xs, init_idx, iters: int, prec: Precision = F64, block: int = 8192):
    """k-means from the stations ``init_idx``, over every station."""
    z = xs[init_idx]
    m = z.shape[0]
    ids = torch.arange(m, device=xs.device)
    for _ in range(iters):
        sums = torch.zeros_like(z)
        counts = torch.zeros(m, dtype=xs.dtype, device=xs.device)
        for s in range(0, xs.shape[0], block):
            xi = xs[s : s + block]
            near = torch.argmin(prec.ew(_r2(xi, z)), dim=1)
            onehot = (near[:, None] == ids[None, :]).to(xs.dtype)
            sums += prec.mm(onehot.T, xi)
            counts += onehot.sum(0)
        z = torch.where((counts > 0)[:, None], sums / counts.clamp_min(1.0)[:, None], z)
    return z


def basis(xs, z, prec: Precision = F64):
    return torch.cat([torch.ones_like(xs[:, :1]), xs, prec.ew(_phi(prec.ew(_r2(xs, z))))], dim=1)


def fit(coords, ys, init_idx=None, iters: int = 5, prec: Precision = F64, knots=None) -> dict:
    """The spline of ``ys`` (n, R) at ``coords`` (n, 2): knots by k-means from
    the stations ``init_idx``, or ``knots`` (m, 2) in raw coordinates.
    Besides the spline, the dict holds ``gcv(lam)``, GCV at lam (..., R),
    and ``backward_error(lam, beta)``, both in float64."""
    dt = prec.dtype
    coords, ys = coords.to(dt), ys.to(dt)
    n = coords.shape[0]
    shift = coords.amin(0)
    scale = (coords.amax(0) - shift).clamp_min(1e-30)
    xs = prec.ew((coords - shift) / scale)
    z = landmarks(xs, init_idx, iters, prec) if knots is None else (knots.to(dt) - shift) / scale
    b = basis(xs, z, prec)
    g = prec.mm(b.T, b).double()
    bty = prec.mm(b.T, ys).double()
    yy = (ys.double() ** 2).sum(0)
    p = g.shape[0]
    eye = torch.eye(p, dtype=torch.float64, device=g.device)
    sc = torch.sqrt(torch.diagonal(g).clamp_min(1e-300))
    ridge = 1e-10
    while True:
        low, info = torch.linalg.cholesky_ex(g / torch.outer(sc, sc) + ridge * eye)
        if int(info) == 0:
            break
        ridge *= 100.0
        if ridge > 1e-2:
            raise RuntimeError("the normal equations are not positive definite")
    kzz = prec.ew(_phi(prec.ew(_r2(z, z)))).double()
    pen = torch.zeros_like(g)
    pen[3:, 3:] = kzz / torch.outer(sc[3:], sc[3:])
    linv = torch.linalg.solve_triangular(low, eye, upper=False)            # R^-T
    mmat = linv @ pen @ linv.T
    evals, u = torch.linalg.eigh(0.5 * (mmat + mmat.T))
    evals = evals.clamp_min(0.0)
    uu = u.T @ (linv @ (bty / sc[:, None]))                                 # (p, R)
    ev_g, uu_g, yy_g = (prec.ew(a.to(dt)).double() for a in (evals, uu, yy))

    def gcv(lams):
        s = 1.0 / (1.0 + lams[..., None, :] * ev_g[:, None])
        rss = (yy_g - (uu_g**2 * s * (2.0 - s)).sum(-2)).clamp_min(0.0)
        return n * rss / (n - s.sum(-2)).clamp_min(1.0) ** 2

    def solve(lam):
        s = 1.0 / (1.0 + lam[None, :] * evals[:, None])
        return torch.linalg.solve_triangular(low.T, u @ (s * uu), upper=True) / sc[:, None]

    def backward_error(lam, beta):
        """The backward error of ``beta`` (p, R) in the system the fit
        solves at ``lam`` (R,), in G's unit-diagonal scaling:
        A beta = r with A = R'(I + lam M+)R, R'R = G + ridge and M+ the
        whitened penalty with its eigenvalues clamped at 0:
        |A b - r| / (|R|_F^2 (1 + lam max M+) |b| + |r|), a response."""
        bs = beta.double() * sc[:, None]
        rhs = bty / sc[:, None]
        rb = low.T @ bs
        ab = low @ (rb + lam[None, :] * (u @ (evals[:, None] * (u.T @ rb))))
        norm_a = torch.linalg.matrix_norm(low) ** 2 * (1.0 + lam * evals.max())
        return (ab - rhs).norm(dim=0) / (norm_a * bs.norm(dim=0) + rhs.norm(dim=0))

    lo, hi, num = LAM_GRID
    grid = 10.0 ** torch.linspace(lo, hi, num, dtype=torch.float64, device=g.device)
    lam = grid[torch.argmin(gcv(grid[:, None].expand(-1, ys.shape[1])), dim=0)]
    beta = solve(lam)
    fitted = b.double() @ beta if prec.name == "float64" else prec.mm(b, beta).double()
    return {"lam": lam, "fitted": fitted, "c": beta[3:], "d": beta[:3], "z": z, "shift": shift, "scale": scale,
            "gcv": gcv, "backward_error": backward_error}


def evaluate(spline: dict, pts, prec: Precision = F64, block: int = 4096):
    """f at the raw points ``pts`` (k, 2): (k, R)."""
    dt = prec.dtype
    q_all = prec.ew((pts.to(dt) - spline["shift"].to(dt)) / spline["scale"].to(dt))
    z, c, d = spline["z"].to(dt), spline["c"].to(dt), spline["d"].to(dt)
    out = []
    for s in range(0, q_all.shape[0], block):
        q = q_all[s : s + block]
        poly = torch.cat([torch.ones_like(q[:, :1]), q], 1)
        out.append(prec.mm(prec.ew(_phi(prec.ew(_r2(q, z)))), c) + prec.mm(poly, d))
    return torch.cat(out).double()


def cell_centres(grid: dict, rows, device) -> torch.Tensor:
    """Raw float64 centres of every cell of the grid rows ``rows``, row by
    row: (len(rows) * ncols, 2).  ``grid``: nrows, ncols, xmin, ymax, dx, dy."""
    cols = torch.arange(grid["ncols"], dtype=torch.float64, device=device)
    r = torch.as_tensor(rows, device=device).to(torch.float64)
    x = (grid["xmin"] + (cols + 0.5) * grid["dx"])[None, :].expand(len(r), -1)
    y = (grid["ymax"] - (r + 0.5) * grid["dy"])[:, None].expand(-1, grid["ncols"])
    return torch.stack([x.reshape(-1), y.reshape(-1)], 1)


def surface_rows(spline: dict, grid: dict, rows, prec: Precision = F64):
    """f at every cell of the grid rows ``rows``: (len(rows), ncols, R)."""
    pts = cell_centres(grid, rows, spline["c"].device)
    return evaluate(spline, pts, prec).reshape(len(rows), grid["ncols"], -1)
