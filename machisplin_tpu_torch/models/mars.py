"""MARS — multivariate adaptive regression splines (degree 1 or 2).

Counterpart of ``machisplin_tpu/models/mars.py`` (``earth::earth(form, data,
nfold=10)``, V73:250/539): forward selection of reflected hinge pairs
(max(x_v - t, 0), max(t - x_v, 0)), then backward pruning by
GCV(M) = RSS/n / (1 - C(M)/n)^2 with C(M) = terms + penalty*(terms-1)/2.
Importance follows ``earth::evimp`` (V73:541).

Forward pass as earth's (Friedman 1991 eqs. 43/45): candidate knots at
training observations spaced ``minspan`` apart and ``endspan`` from either end
(automatic spans from alpha = 0.05); the pass stops before a pair whose best
RSq gain is below ``thresh``, or once RSq >= 1 - thresh.

Every model of a batch (CV folds, responses) shares ``x`` and differs by its
``y`` and 0/1 ``sample_weight`` rows: the batch is a leading tensor axis.
``degree=2`` (earth's ``degree``) adds product terms: each forward step picks
the best (parent term, variable, knot) triple, the parent being the
intercept or an earlier degree-1 column on other variables.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .base import as_weight


class MARSState(NamedTuple):
    vars: torch.Tensor         # (..., T) int64 variable per hinge pair
    knots: torch.Tensor        # (..., T) knot location (raw scale)
    coef: torch.Tensor         # (..., 2T + 1) coefficients, 0 where pruned
    active: torch.Tensor       # (..., 2T + 1) 0/1 column mask after pruning
    gcv: torch.Tensor          # (...) best GCV
    rss: torch.Tensor          # (...) RSS of the pruned model
    pair_active: torch.Tensor  # (..., T) 0/1 pairs the forward pass added
    parent: torch.Tensor       # (..., T) int64 design column of each pair's parent
    #                            term (0 = intercept: a plain degree-1 pair;
    #                            2i+1 / 2i+2: a product with an earlier hinge)


def _design(x, vars_, knots, parent=None):
    """Design [1, t1+, t1-, t2+, t2-, ...]: (..., n, 2T+1) for vars_/knots
    (..., T).  With ``parent`` (..., T), pair i's columns are its parent
    column (an earlier one; 0 = the intercept) times its hinges, built in
    order; all-zero parents give the degree-1 design bit for bit."""
    xv = x[:, vars_].movedim(0, -2) if vars_.ndim == 2 else x[:, vars_]  # (..., n, T)
    kn = knots[..., None, :]
    plus = (xv - kn).clamp_min(0.0)
    minus = (kn - xv).clamp_min(0.0)
    cols = torch.stack([plus, minus], dim=-1).flatten(-2)
    ones = torch.ones(cols.shape[:-1] + (1,), dtype=x.dtype, device=x.device)
    cols = torch.cat([ones, cols], dim=-1)
    if parent is None:
        return cols
    for i in range(vars_.shape[-1]):
        pcol = cols.gather(-1, parent[..., i, None, None].expand(cols.shape[:-1] + (1,)))
        cols[..., 2 * i + 1 : 2 * i + 3] = pcol * cols[..., 2 * i + 1 : 2 * i + 3]
    return cols


def _interacts(parent) -> bool:
    return bool((parent != 0).any())


def _masked_rss(bmat, ysw, mask, ridge=None):
    """RSS and coefficients of the OLS fit restricted to the 0/1 columns of
    ``mask``: bmat (..., n, C), ysw (..., n), mask (..., C), batch dims
    broadcasting.  Columns are scale-normalised and the RSS comes from the
    residual vector: hinge pairs are exactly collinear with the intercept,
    so the Gram system is rank-deficient and yy - b'coef is meaningless."""
    if ridge is None:
        ridge = max(100.0 * float(torch.finfo(bmat.dtype).eps), 1e-8)
    s = torch.sqrt((bmat * bmat).sum(-2).clamp_min(1e-30))
    bn = bmat / s[..., None, :]
    m = mask
    eye = torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)
    gram = bn.transpose(-1, -2) @ bn
    gm = gram * (m[..., :, None] * m[..., None, :]) + eye * (1.0 - m)[..., None, :] + ridge * eye * m[..., None, :]
    rhs = (bn.transpose(-1, -2) @ ysw[..., None])[..., 0] * m
    coef_n = torch.linalg.solve(gm, rhs)
    resid = ysw - (bn @ (coef_n * m)[..., None])[..., 0]
    return (resid * resid).sum(-1), coef_n * m / s


def _in_span(u, cand, zero):
    """``u`` (B, n), the part of candidate column ``cand`` left after
    projecting out the basis, set to zero where it is rounding noise
    (norm <= 1e3 eps * |cand|).

    The JAX package normalises by sqrt(max(|u|^2, 1e-10)) >= 1e-5 and keeps
    the column whenever that exceeds 1e-6, so a pair column that lies in the
    span of the basis (the reflected partner of a hinge on a variable that
    already has a pair is always one: plus - minus = x - t) enters the basis
    as its rounding noise divided by 1e-5.  That vector differs with the
    summation order of the matmuls, and later picks follow it: the JAX
    package's own float32 r^2 moves by up to 0.017 between single- and
    multi-threaded runs of XLA on the CPU.  In exact arithmetic the column is zero, which is
    what this port computes, and what the JAX package's float64 runs agree
    with wherever they are reproducible."""
    tol = 1e3 * torch.finfo(u.dtype).eps
    noise = u.norm(dim=-1, keepdim=True) <= tol * cand.norm(dim=-1, keepdim=True)
    return torch.where(noise, zero, u)


def fit(
    x, y, *, sample_weight=None, n_pairs: int = 10, n_knots: int = 64,
    penalty: float = 2.0, ridge: float | None = None, thresh: float = 1e-3,
    minspan: int = 0, endspan: int = 0, degree: int = 1,
) -> MARSState:
    """y (n,) or (B, n).  ``minspan``/``endspan`` = 0 selects earth's
    automatic spans from the weighted training count; ``thresh`` = 0 spends
    the full ``n_pairs`` budget.  ``degree`` = 2 allows product terms
    (earth's penalty for interaction models is 3: pass ``penalty=3``); as in
    the JAX package, interaction knots come from the global span-filtered
    grid, not re-filtered within the parent's support."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    single = y.ndim == 1
    if single:
        y = y[None]
        sample_weight = None if sample_weight is None else torch.as_tensor(sample_weight)[None]
    dt, dev = x.dtype, x.device
    n, p = x.shape
    b = y.shape[0]
    w = as_weight(sample_weight, y.shape, dt, dev)                # (B, n)
    n_eff = w.sum(-1).clamp_min(1.0)                              # (B,)
    sw = torch.sqrt(w)

    alpha = 0.05
    if minspan > 0:
        ms = torch.full((b,), float(minspan), dtype=dt, device=dev)
    else:
        ms = torch.floor(-torch.log2(-(1.0 / (n_eff * p)) * math.log1p(-alpha)) / 2.5).clamp_min(1.0)
    if endspan > 0:
        es = torch.tensor(float(endspan), dtype=dt, device=dev)
    else:
        es = torch.tensor(max(math.floor(3.0 - math.log2(alpha / p)), 1.0), dtype=dt, device=dev)

    # knot candidates: training observations at sorted ranks es, es+step, ...
    # (earth's span-filtered knot set) on one (p, K) grid per model; the
    # stride covers the whole eligible range, ranks past it are masked out
    order = torch.argsort(x, dim=0, stable=True)                  # (n, p)
    xs_sorted = torch.take_along_dim(x, order, dim=0)
    w_sorted = w[:, order]                                        # (B, n, p)
    cw = torch.cumsum(w_sorted, dim=1)
    step = torch.maximum(ms, (n_eff - 2.0 * es) / n_knots)        # (B,)
    ranks = es + step[:, None] * torch.arange(n_knots, dtype=dt, device=dev)  # (B, K)
    rank_valid = ranks <= (n_eff - es - 1.0)[:, None]
    rank_valid[:, 0] = True  # never an empty candidate set
    # first sorted index whose cumulative train count reaches rank + 1
    idx = (cw[:, None, :, :] < (ranks + 1.0)[:, :, None, None]).sum(2)  # (B, K, p)
    idx = idx.clamp(0, n - 1)
    knot_grid = torch.take_along_dim(xs_sorted[None], idx, dim=1).transpose(1, 2)  # (B, p, K)
    cand_valid = rank_valid[:, None, :].expand(b, p, n_knots).reshape(b, -1)

    xv = x.T[None, :, None, :]                                    # (1, p, 1, n)
    kg = knot_grid[..., None]                                     # (B, p, K, 1)
    raw_plus = (xv - kg).clamp_min(0.0).reshape(b, p * n_knots, n)
    raw_minus = (kg - xv).clamp_min(0.0).reshape(b, p * n_knots, n)
    cand_plus = raw_plus * sw[:, None, :]
    cand_minus = raw_minus * sw[:, None, :]

    ysw = y * sw
    q0 = sw / torch.sqrt(n_eff)[:, None]
    tiny = torch.tensor(1e-10, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    one = torch.ones((), dtype=dt, device=dev)

    resid = ysw - (ysw * q0).sum(-1, keepdim=True) * q0
    tss = (resid * resid).sum(-1).clamp_min(tiny)
    q_basis = q0[..., None]                                       # (B, n, M)
    stopped = torch.zeros(b, dtype=torch.bool, device=dev)
    rows = torch.arange(b, device=dev)

    def gains(ca, cb):
        """Joint 2x2 RSS gain of each candidate pair (B, C, n) against the
        basis, or the better single column when the pair is (near) collinear
        with it; also the projected pairs."""
        qt = q_basis.transpose(1, 2)
        pa = ca - (ca @ q_basis) @ qt                             # (B, C, n)
        pb = cb - (cb @ q_basis) @ qt
        aa = (pa * pa).sum(-1)
        bb = (pb * pb).sum(-1)
        ab = (pa * pb).sum(-1)
        ar = (pa @ resid[..., None])[..., 0]
        br = (pb @ resid[..., None])[..., 0]
        det = aa * bb - ab * ab
        gain2 = torch.where(
            det > tiny * torch.maximum(aa * bb, tiny),
            (bb * ar * ar - 2 * ab * ar * br + aa * br * br) / torch.maximum(det, tiny),
            zero,
        )
        gain1 = torch.maximum(
            torch.where(aa > tiny, ar * ar / torch.maximum(aa, tiny), zero),
            torch.where(bb > tiny, br * br / torch.maximum(bb, tiny), zero),
        )
        return torch.maximum(gain2, gain1), pa, pb

    def add_pair(best_gain, pa1, ca1, pb1, cb1):
        """earth's stopping rule, then the chosen pair orthonormalised into
        the basis (zeroed once stopped); a column left with only rounding
        noise after the projection is exactly zero, as in exact arithmetic
        (see _in_span).  Returns the 0/1 ``add`` of each model."""
        nonlocal stopped, resid, q_basis
        rsq_cur = 1.0 - (resid * resid).sum(-1) / tss
        delta_rsq = best_gain.clamp_min(0.0) / tss
        stopped = stopped | (delta_rsq < thresh) | (rsq_cur >= 1.0 - thresh)
        add = torch.where(stopped, zero, one)
        u1 = _in_span(pa1, ca1, zero)
        n1 = torch.sqrt(torch.maximum((u1 * u1).sum(-1), tiny))[:, None]
        e1 = torch.where(n1 > 1e-6, u1 / n1, zero) * add[:, None]
        u2 = _in_span(pb1 - (pb1 * e1).sum(-1, keepdim=True) * e1, cb1, zero)
        n2 = torch.sqrt(torch.maximum((u2 * u2).sum(-1), tiny))[:, None]
        e2 = torch.where(n2 > 1e-6, u2 / n2, zero) * add[:, None]
        resid = resid - (resid * e1).sum(-1, keepdim=True) * e1 - (resid * e2).sum(-1, keepdim=True) * e2
        q_basis = torch.cat([q_basis, e1[..., None], e2[..., None]], dim=-1)
        return add

    picks, adds, parents = [], [], []
    if degree <= 1:
        for _ in range(n_pairs):
            gain, pa, pb = gains(cand_plus, cand_minus)
            gain = torch.where(cand_valid, gain, -one)
            best = torch.argmax(gain, dim=-1)                     # (B,)
            adds.append(add_pair(gain[rows, best], pa[rows, best], cand_plus[rows, best], pb[rows, best],
                                 cand_minus[rows, best]))
            picks.append(best)
            parents.append(torch.zeros_like(best))
    else:
        # candidates are (parent term, hinge pair) products; parent columns
        # are carried raw (no sqrt-weight), so a product with the weighted
        # hinge candidates is weighted once; the intercept's row of ones
        # gives the degree-1 candidates bit for bit
        n_cand = p * n_knots
        p_max = 2 * n_pairs + 1
        cand_var = torch.arange(n_cand, device=dev) // n_knots
        parent_raw = torch.zeros((b, p_max, n), dtype=dt, device=dev)
        parent_raw[:, 0] = 1.0
        parent_ok = torch.zeros((b, p_max), dtype=dt, device=dev)
        parent_ok[:, 0] = 1.0
        used_vars = torch.zeros((b, p_max, p), dtype=dt, device=dev)
        col_deg = torch.zeros((b, p_max), dtype=dt, device=dev)
        for i in range(n_pairs):
            # columns past 2i are not built yet: their gains stay -1
            all_gains = torch.full((b, p_max, n_cand), -1.0, dtype=dt, device=dev)
            for par in range(2 * i + 1):
                pr = parent_raw[:, par, None, :]
                gain, _, _ = gains(pr * cand_plus, pr * cand_minus)
                valid = cand_valid & (parent_ok[:, par, None] > 0) & (used_vars[:, par][:, cand_var] == 0)
                all_gains[:, par] = torch.where(valid, gain, -one)
            flat = all_gains.reshape(b, -1)
            best = torch.argmax(flat, dim=-1)                     # parent-major (P x C)
            bp, bc = best // n_cand, best % n_cand
            prow = parent_raw[rows, bp]
            ca1 = prow * cand_plus[rows, bc]
            cb1 = prow * cand_minus[rows, bc]
            proj = lambda v: v - (q_basis @ (q_basis.transpose(1, 2) @ v[..., None]))[..., 0]
            add = add_pair(flat[rows, best], proj(ca1), ca1, proj(cb1), cb1)
            # bookkeeping for the later steps' parent set
            c_plus, c_minus = 2 * i + 1, 2 * i + 2
            parent_raw[:, c_plus] = prow * raw_plus[rows, bc] * add[:, None]
            parent_raw[:, c_minus] = prow * raw_minus[rows, bc] * add[:, None]
            nd = col_deg[rows, bp] + 1.0
            col_deg[:, c_plus] = nd
            col_deg[:, c_minus] = nd
            elig = add * (nd < degree).to(dt)
            parent_ok[:, c_plus] = elig
            parent_ok[:, c_minus] = elig
            uvn = used_vars[rows, bp].clone()
            uvn[rows, cand_var[bc]] = 1.0
            used_vars[:, c_plus] = uvn * add[:, None]
            used_vars[:, c_minus] = uvn * add[:, None]
            picks.append(bc)
            adds.append(add)
            parents.append(bp)
    picks = torch.stack(picks, dim=-1)                            # (B, T)
    pair_active = torch.stack(adds, dim=-1)
    parent = torch.stack(parents, dim=-1)
    vars_ = picks // n_knots
    knots = torch.gather(knot_grid.reshape(b, -1), 1, picks)

    # ---- backward pruning by GCV --------------------------------------
    b_full = _design(x, vars_, knots, parent if degree > 1 else None) * sw[..., None]  # (B, n, C)
    ncols = b_full.shape[-1]

    def gcv_of(rss, m_count):
        c = m_count + penalty * (m_count - 1.0) / 2.0
        denom = torch.maximum(1.0 - c / n_eff, 1.0 / n_eff) ** 2
        return rss / n_eff / denom

    col_ids = torch.arange(ncols, device=dev)
    drop = (col_ids[:, None] != col_ids[None, :]).to(dt)          # (J, C): row j drops column j
    full_mask = torch.cat([torch.ones((b, 1), dtype=dt, device=dev), pair_active.repeat_interleave(2, dim=-1)], dim=-1)
    rss_full, _ = _masked_rss(b_full, ysw, full_mask, ridge)
    best_gcv = gcv_of(rss_full, full_mask.sum(-1))
    mask, best_mask = full_mask, full_mask
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    for _ in range(ncols - 1):
        cand_rss, _ = _masked_rss(
            b_full[:, None], ysw[:, None], mask[:, None, :] * drop[None], ridge
        )                                                         # (B, J)
        removable = (mask > 0) & (col_ids > 0)[None]
        cand_rss = torch.where(removable, cand_rss, inf)
        j = torch.argmin(cand_rss, dim=-1)
        new_mask = mask * drop[j]
        gcv = gcv_of(cand_rss[rows, j], new_mask.sum(-1))
        better = gcv < best_gcv
        best_gcv = torch.where(better, gcv, best_gcv)
        best_mask = torch.where(better[:, None], new_mask, best_mask)
        mask = new_mask
    rss_best, coef = _masked_rss(b_full, ysw, best_mask, ridge)
    st = MARSState(
        vars=vars_, knots=knots, coef=coef, active=best_mask, gcv=best_gcv,
        rss=rss_best, pair_active=pair_active, parent=parent,
    )
    return MARSState(*(a[0] for a in st)) if single else st


def predict(state: MARSState, x) -> torch.Tensor:
    """(m,) for one model, (B, m) for a batch."""
    bm = _design(torch.as_tensor(x), state.vars, state.knots, state.parent if _interacts(state.parent) else None)
    return (bm @ (state.coef * state.active)[..., None])[..., 0]


def importance(state: MARSState, x, y, names, sample_weight=None) -> dict:
    """evimp-style report for one unbatched model: per variable, the number
    of surviving terms and the RSS increase from deleting all its terms
    (normalised to 100 for the worst).  A term involves every variable of
    its factor chain (itself and its parent's), so a degree-2 term counts
    for both of its variables, as in evimp."""
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    w = as_weight(sample_weight, y.shape, x.dtype, x.device)
    sw = torch.sqrt(w)
    bm = _design(x, state.vars, state.knots, state.parent if _interacts(state.parent) else None) * sw[:, None]
    ysw = y * sw
    p = len(names)
    invol = [set()]                                               # column -> variables in its chain
    for v, par in zip(state.vars.tolist(), state.parent.tolist()):
        invol += [invol[par] | {v}] * 2
    deltas, nterms = [], []
    active = state.active.tolist()
    for v in range(p):
        keep = torch.tensor([v not in c for c in invol], dtype=x.dtype, device=x.device)
        rss_v, _ = _masked_rss(bm, ysw, state.active * keep)
        deltas.append(float(rss_v - state.rss))
        nterms.append(int(sum(a for a, c in zip(active, invol) if v in c)))
    dmax = max(max(deltas), 1e-12)
    return {n: {"nsubsets": nterms[i], "rss": 100.0 * deltas[i] / dmax} for i, n in enumerate(names)}
