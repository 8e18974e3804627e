"""SVM model: epsilon-SVR with an RBF kernel (counterpart of
``machisplin_tpu/models/svm.py``).

Mirrors the reference's ``kernlab::ksvm(form, data)`` defaults (V73:251 CV,
V73:560 final) as the JAX package does: eps-SVR, C = 1, epsilon = 0.1, the
Gaussian kernel k(x, z) = exp(-sigma |x - z|^2) with sigma from kernlab's
``sigest`` heuristic, inputs and response standardised with the weighted
moments.

The solver is the JAX package's: the SVR dual in theta = alpha - alpha*,

    min_theta  1/2 theta' K theta - y' theta + eps |theta|_1,
    |theta_i| <= C,   sum_i theta_i = 0,

by cyclic soft-threshold coordinate descent on K + mu 11' with the
multiplier step lam += mu sum(theta) after each of ``epochs`` sweeps; the
sweep is kernel K4 on the card (``ops/svm_sweep.py``: a block a lane, one
warp running the coordinates in order while the others sum each next
chunk's residual q . theta from q).  The bias comes from the free support
vectors, with the multiplier as the fallback.

Models are batched over a leading lane axis, where the JAX package used
``vmap``: ``y`` and ``sample_weight`` are (n,) for one model or (L, n) for L
models; ``x`` is (n, p) shared by the lanes or (L, n, p), one row set per
lane (the CV's inverted-fold gather).  Each lane has its own sigma and
weight mask.  ``sigest``'s pair draws are injectable (``pairs``), else drawn
on the CPU from a ``torch.Generator``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.svm_sweep import svm_sweep
from ..parallel.sharded import gather_rows, share_rows
from .base import as_weight

__all__ = ["SVMState", "fit", "predict", "draw_sigest_pairs", "lane", "sweep_inputs"]

# (lanes x n x n) values of q fitted at once: lane chunks bound the kernel
# matrices and their temporaries (~0.25 GB a chunk in float32)
_LANE_ELEMS = 1 << 26
_MU = 1.0            # the augmented-Lagrangian weight


class SVMState(NamedTuple):
    sv_x: torch.Tensor      # (..., n, p) standardised training inputs
    theta: torch.Tensor     # (..., n) dual coefficients (0 for non-SVs and masked rows)
    bias: torch.Tensor      # (...)
    sigma: torch.Tensor     # (...) RBF inverse width
    x_mean: torch.Tensor    # (..., p)
    x_scale: torch.Tensor   # (..., p)
    y_mean: torch.Tensor    # (...)
    y_scale: torch.Tensor   # (...)


def lane(state: SVMState, j: int) -> SVMState:
    """Lane ``j`` of a batched state."""
    return SVMState(*(a[j] for a in state))


def _rbf(a, b, sigma):
    """exp(-sigma |a_i - b_j|^2) for a (L, m, p), b (L, n, p), sigma (L,):
    (L, m, n).  Explicit per-feature differences, accumulated feature by
    feature (no |a|^2 + |b|^2 - 2ab' expansion)."""
    r2 = torch.zeros((a.shape[0], a.shape[1], b.shape[1]), dtype=a.dtype, device=a.device)
    for f in range(a.shape[2]):
        d = a[:, :, f, None] - b[:, None, :, f]
        r2 = r2 + d * d
    return torch.exp(-sigma[:, None, None] * r2)


def draw_sigest_pairs(n_lanes: int, n: int, generator: torch.Generator | None = None):
    """sigest's (i, j) row pairs, (L, min(2n, 2000)) each, uniform on
    [0, n), drawn on the CPU from ``generator``."""
    m = min(2 * n, 2000)
    i = torch.randint(0, n, (n_lanes, m), generator=generator)
    j = torch.randint(0, n, (n_lanes, m), generator=generator)
    return i, j


def _sigest(xs, w, i, j):
    """kernlab sigest: the mean of the inverse 0.9 and 0.1 quantiles of
    |x_i - x_j|^2 over the sampled pairs with both rows active and i != j.
    xs (L, n, p), w (L, n), i and j (L, m) -> (L,)."""
    p = xs.shape[2]
    xi = xs.gather(1, i[:, :, None].expand(-1, -1, p))
    xj = xs.gather(1, j[:, :, None].expand(-1, -1, p))
    valid = (w.gather(1, i) > 0) & (w.gather(1, j) > 0) & (i != j)
    d2 = ((xi - xj) ** 2).sum(-1)
    d2 = torch.where(valid, d2, torch.full((), float("nan"), dtype=xs.dtype, device=xs.device))
    q = torch.nanquantile(d2, torch.tensor([0.9, 0.1], dtype=xs.dtype, device=xs.device), dim=1)   # (2, L)
    return (1.0 / q.clamp_min(1e-12)).mean(0)


def sweep_inputs(x, y, w, pairs=None, sigma: float | None = None):
    """The standardised lanes and the sweep's operands for x (L, n, p), y
    and w (L, n): (SVMState with theta and bias left None, ys (L, n),
    q (L, n, n), diag (L, n)).  ``pairs`` (i, j) each (L, m) when ``sigma``
    is None."""
    n_lanes, n = y.shape
    one = torch.ones((), dtype=x.dtype, device=x.device)
    wsum = w.sum(-1).clamp_min(1.0)
    x_mean = (x * w[:, :, None]).sum(1) / wsum[:, None]
    xc = x - x_mean[:, None, :]
    x_scale = torch.sqrt((w[:, :, None] * xc * xc).sum(1) / (wsum - 1.0)[:, None])
    x_scale = torch.where(x_scale > 0, x_scale, one)
    xs = xc / x_scale[:, None, :]
    y_mean = (y * w).sum(-1) / wsum
    y_scale = torch.sqrt((w * (y - y_mean[:, None]) ** 2).sum(-1) / (wsum - 1.0))
    y_scale = torch.where(y_scale > 0, y_scale, one)
    ys = (y - y_mean[:, None]) / y_scale[:, None]
    if sigma is None:
        sig = _sigest(xs, w, *pairs)
    else:
        sig = torch.full((n_lanes,), float(sigma), dtype=x.dtype, device=x.device)
    q = _rbf(xs, xs, sig)
    q = q * (w[:, :, None] * w[:, None, :])                # masked rows decouple entirely
    q = q + torch.diag_embed(1.0 - w)
    diag = torch.diagonal(q, dim1=1, dim2=2) + _MU * w     # A_ii of A = K + mu 11' (active rows)
    state = SVMState(sv_x=xs, theta=None, bias=None, sigma=sig, x_mean=x_mean, x_scale=x_scale,
                     y_mean=y_mean, y_scale=y_scale)
    return state, ys.contiguous(), q.contiguous(), diag.contiguous()


def _fit_lanes(x, y, w, pairs, *, c_reg, epsilon, sigma, epochs, mesh=None):
    """One chunk of lanes: x (L, n, p), y and w (L, n).  With a ``mesh``
    each rank sweeps its share of the lanes (K4) and the multipliers are
    gathered; the operands and the bias are computed for every lane."""
    state, ys, q, diag = sweep_inputs(x, y, w, pairs, sigma)
    w = w.contiguous()
    if mesh is None:
        theta, lam = svm_sweep(q, ys, w, diag, c_reg=c_reg, epsilon=epsilon, mu=_MU, epochs=epochs)
    else:
        n_lanes = ys.shape[0]
        k = share_rows(n_lanes, mesh).to(ys.device)
        theta, lam = (gather_rows(a, n_lanes, mesh) for a in svm_sweep(
            q[k].contiguous(), ys[k].contiguous(), w[k].contiguous(), diag[k].contiguous(), c_reg=c_reg,
            epsilon=epsilon, mu=_MU, epochs=epochs))
    # bias from the free support vectors' KKT conditions (libsvm/kernlab);
    # the converged multiplier is the fallback when none is strictly free
    free = (theta.abs() > 1e-6) & (theta.abs() < 0.999 * c_reg) & (w > 0)
    b_i = ys - (q @ theta[:, :, None])[:, :, 0] - epsilon * torch.sign(theta)
    n_free = free.sum(-1)
    b_free = torch.where(free, b_i, torch.zeros((), dtype=x.dtype, device=x.device)).sum(-1) / n_free.clamp_min(1)
    return state._replace(theta=theta, bias=torch.where(n_free > 0, b_free, lam))


def fit(x, y, *, sample_weight=None, c_reg: float = 1.0, epsilon: float = 0.1, sigma: float | None = None,
        epochs: int = 120, pairs=None, generator: torch.Generator | None = None, mesh=None) -> SVMState:
    """Fit one SVR per lane.  ``y`` (n,) or (L, n); ``x`` (n, p) or (L, n, p);
    ``pairs`` the sigest draws (i, j), each (L, m) (or (m,) for one model),
    else drawn from ``generator``.  A single model's state has no lane axis.
    ``mesh``: the sweep's lanes split across the ranks (``_fit_lanes``);
    every rank returns every lane."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    single = y.dim() == 1
    if single:
        y = y[None]
    n_lanes, n = y.shape
    w = as_weight(sample_weight, (n_lanes, n), x.dtype, x.device)
    w = w.expand(n_lanes, n) if w.dim() == 1 else w
    xl = x.expand(n_lanes, n, x.shape[-1]) if x.dim() == 2 else x
    if sigma is None:
        if pairs is None:
            pairs = draw_sigest_pairs(n_lanes, n, generator)
        pairs = tuple(torch.as_tensor(a, device=x.device).long().reshape(n_lanes, -1) for a in pairs)
    chunk = max(1, _LANE_ELEMS // (n * n))
    parts = [
        _fit_lanes(xl[s : s + chunk], y[s : s + chunk], w[s : s + chunk],
                   None if sigma is not None else tuple(a[s : s + chunk] for a in pairs),
                   c_reg=c_reg, epsilon=epsilon, sigma=sigma, epochs=epochs, mesh=mesh)
        for s in range(0, n_lanes, chunk)
    ]
    state = SVMState(*(torch.cat(a, dim=0) for a in zip(*parts)))
    return lane(state, 0) if single else state


def predict(state: SVMState, x, query_block: int = 0) -> torch.Tensor:
    """SVR decision function of every lane at the (m, p) points ``x``:
    (L, m), or (m,) for a single model.  Queries go in blocks of
    ``query_block`` rows (default max(128, 16e6 // n_sv)), so at most
    (L, query_block, n_sv) kernel values exist at once."""
    single = state.theta.dim() == 1
    st = SVMState(*(a[None] for a in state)) if single else state
    x = torch.as_tensor(x, device=st.theta.device).to(st.theta.dtype)
    n_sv = st.theta.shape[1]
    xs = (x[None] - st.x_mean[:, None, :]) / st.x_scale[:, None, :]      # (L, m, p)
    if query_block <= 0:
        query_block = max(128, int(16e6) // max(n_sv, 1))
    m = x.shape[0]
    out = torch.empty((st.theta.shape[0], m), dtype=x.dtype, device=x.device)
    for c0 in range(0, m, query_block):
        k = _rbf(xs[:, c0 : c0 + query_block], st.sv_x, st.sigma)
        f = (k @ st.theta[:, :, None])[:, :, 0] + st.bias[:, None]
        out[:, c0 : c0 + query_block] = f * st.y_scale[:, None] + st.y_mean[:, None]
    return out[0] if single else out
