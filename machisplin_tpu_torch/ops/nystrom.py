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

With a device mesh (``parallel/sharded.py``) the station axis splits across
the ranks by whole chunks: each rank streams the cross-products of its
chunks, and every rank sums all chunks' in the unsharded order, so the fit
is the unsharded one bit for bit (an all-reduce of per-rank sums moved
config 4's float64 coefficients by 3e-4 of their scale: the whitened
system is that ill-conditioned).  The landmarks (k-means over all
stations), the float64 tail and the GCV run on every rank, with rank 0's
lambda and coefficients broadcast; the fitted pass splits by chunks too.
"""
from __future__ import annotations

import contextlib

import torch

from ..parallel.sharded import broadcast_tensor, gather_rows, rank_world
from ..utils import resolve_device
from ..utils.timing import PhaseTimer, span
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


def _chunk_stats(xi, yi, z):
    """One chunk's B'B, B'y and y'y."""
    b_i = _basis(xi, z)
    return b_i.T @ b_i, b_i.T @ yi, (yi * yi).sum(0)


def _chunk_share(n: int, chunk: int, mesh):
    """This rank's chunks [c0, c1) of the stations in chunks of ``chunk``
    rows, the chunk count and the chunks a rank."""
    n_chunks = -(-n // chunk)
    rank, world = rank_world(mesh)
    per = -(-n_chunks // world)
    return min(rank * per, n_chunks), min((rank + 1) * per, n_chunks), n_chunks, per


def _stream_stats(xs, ycols, z, chunk, mesh=None):
    """G = B'B, B'y and y'y over the stations, in chunks of ``chunk`` rows,
    summed in chunk order.  The JAX package pads the last chunk with
    weight-0 rows, which add exact zeros; here it is just shorter.  With a
    ``mesh`` each rank computes its chunks' terms and every rank sums all
    of them, gathered, in the same order."""
    p_dim = 3 + z.shape[0]
    dt, dev = xs.dtype, xs.device
    n = xs.shape[0]
    sums = [torch.zeros((p_dim, p_dim), dtype=dt, device=dev), torch.zeros((p_dim, ycols.shape[1]), dtype=dt,
            device=dev), torch.zeros((ycols.shape[1],), dtype=dt, device=dev)]
    if mesh is None:
        terms = (_chunk_stats(xs[s : s + chunk], ycols[s : s + chunk], z) for s in range(0, n, chunk))
    else:
        c0, c1, n_chunks, per = _chunk_share(n, chunk, mesh)
        mine = [_chunk_stats(xs[i * chunk : (i + 1) * chunk], ycols[i * chunk : (i + 1) * chunk], z)
                for i in range(c0, c1)]
        stacked = [torch.stack([t[k] for t in mine] + [torch.zeros_like(sums[k])] * (per - len(mine)))
                   for k in range(3)]
        terms = zip(*(gather_rows(a, n_chunks, mesh) for a in stacked))
    for term in terms:
        for acc, t in zip(sums, term):
            acc += t
    return tuple(sums)


def _stream_fitted(xs, z, d, c, chunk, mesh=None):
    """Fitted values (n, R), in chunks of ``chunk`` stations; with a
    ``mesh`` each rank computes its chunks' and they are gathered."""
    beta = torch.cat([d, c], dim=0)
    n = xs.shape[0]
    if mesh is None:
        return torch.cat([_basis(xs[s : s + chunk], z) @ beta for s in range(0, n, chunk)], dim=0)
    c0, c1, _, per = _chunk_share(n, chunk, mesh)
    mine = [_basis(xs[i * chunk : (i + 1) * chunk], z) @ beta for i in range(c0, c1)]
    rows = sum(len(f) for f in mine)
    pad = beta.new_zeros((per * chunk - rows, beta.shape[1]))
    return gather_rows(torch.cat(mine + [pad]), n, mesh)


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
                    device=None, timer: PhaseTimer | None = None, mesh=None) -> TPSModel:
    """Fit the reduced-basis smoothing spline; returns a TPSModel whose knots
    are the (range-scaled) landmarks, so every TPS prediction path applies.

    ``coords`` (n, 2), ``y`` (n,) or (n, R); lambda is GCV-selected per
    response on ``logspace(-10, 6, ngrid)`` when None.  ``landmarks`` (m, 2)
    in raw coordinates injects the centres; else ``select_landmarks`` draws
    m of them from ``generator``.  The fit runs on ``device``: by default the
    device of ``coords`` when it is a tensor, else the GPU.  Its steps
    ("landmarks", "stream_stats", "f64_tail", "gcv_coef", "fitted") are
    spans ``nystrom.<step>``; a ``timer`` also collects their seconds, each
    step then synchronised on a GPU.
    ``mesh``: every rank calls with the same inputs; the two streamed passes
    split over the stations by whole chunks and every rank returns the
    unsharded model."""
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
    with _step("landmarks", timer):
        if landmarks is None:
            z = select_landmarks(xs, m, generator=generator)
        else:
            z = (torch.as_tensor(landmarks, device=dev).to(dtype) - cmin) / crange
    with _step("stream_stats", timer):
        kzz = _phi(_pairwise_r2(z, z))
        g, bty, yy = _stream_stats(xs, ycols, z, chunk, mesh)
    with _step("f64_tail", timer):
        evals, u, uu, r, scale = (a.to(dtype) for a in _whitened_eigh(g, bty, kzz))

    with _step("gcv_coef", timer):
        lam_sel, gcv_min, s, c, d = _gcv_and_coef(evals, u, uu, r, scale, yy, n, lam, ngrid)
        lam_sel, gcv_min, s, c, d = (broadcast_tensor(a, mesh) for a in (lam_sel, gcv_min, s, c, d))
    with _step("fitted", timer):
        fitted = _stream_fitted(xs, z, d, c, chunk, mesh)
    residuals = ycols - fitted
    eff_df = s.sum(0)
    if single:
        c, d, fitted, residuals = c[:, 0], d[:, 0], fitted[:, 0], residuals[:, 0]
        lam_sel, gcv_min, eff_df = lam_sel[0], gcv_min[0], eff_df[0]
    return TPSModel(
        knots=z, c=c, d=d, shift=cmin, scale=crange, lam=lam_sel, gcv=gcv_min,
        fitted=fitted, residuals=residuals, eff_df=eff_df,
    )


@contextlib.contextmanager
def _step(name: str, timer: PhaseTimer | None):
    """Span ``nystrom.<name>``, and the phase ``name`` of ``timer`` if any."""
    with span("nystrom." + name), (timer.phase(name) if timer is not None else contextlib.nullcontext()):
        yield


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
