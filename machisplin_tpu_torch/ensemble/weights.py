"""Ensemble weight selection (counterpart of
``machisplin_tpu/ensemble/weights.py``).

The reference minimises the summed squared weight-normalised CV residual

    fit(k) = sum_i ( sum_a k_a * r_{a,i} / sum_a k_a )^2

over k in [0,1]^A by L-BFGS-B from k=0.5 (V73:329-333 / 369-373), then keeps
algorithms whose ROUNDED weight round(k_a, 2) exceeds 5% of the UNROUNDED
weight total (V73:337-362 — both quirks preserved), with the letter string in
the fixed order b, g, n, m, r, v and per-algorithm percentages of the
kept-weight total (V73:408-428).

* ``optimize_weights_lbfgsb``: the reference's search, float64 numpy + scipy
  on the host (the problem is 2-6 dimensional).
* ``optimize_weights_sweep``: every candidate weight vector of a random set
  scored in one batched matmul, then a zoom of batched Gaussian
  perturbations, on the residuals' device.
* ``optimize_weights_aicc``: the historical V18 selection, every
  equal-weight subset scored by AICc in one batched matmul.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch
from scipy.optimize import minimize

from ..models.base import LETTER_ORDER

__all__ = [
    "WeightResult", "ensemble_objective", "optimize_weights_aicc", "optimize_weights_lbfgsb",
    "optimize_weights_sweep",
]


class WeightResult(NamedTuple):
    weights: np.ndarray        # (A,) raw optimised weights in [0, 1]
    letters: str               # kept algorithms, reference letter order
    kept_weights: np.ndarray   # rounded weights of kept algorithms
    weight_total: float        # UNROUNDED total over all algorithms (V73:337)
    percent_text: str          # "62.5:37.5"-style text (V73:408-428)
    objective: float


def ensemble_objective(weights, residuals) -> torch.Tensor:
    """fit(k) for weights (..., A) against residuals (A, n), on the
    residuals' device and in their dtype."""
    residuals = torch.as_tensor(residuals)
    weights = torch.as_tensor(weights, device=residuals.device).to(residuals.dtype)
    total = weights.sum(-1, keepdim=True)
    mix = (weights / total.clamp_min(1e-12)) @ residuals
    return (mix * mix).sum(-1)


def _fmt_r(x: float) -> str:
    """round(x, 1) printed the way R prints it (no trailing '.0')."""
    s = f"{np.round(float(x), 1):.1f}"
    return s[:-2] if s.endswith(".0") else s


def _select(weights: np.ndarray, letters: Sequence[str], objective: float) -> WeightResult:
    weights = np.asarray(weights, np.float64)
    total = float(np.sum(weights))
    cut = 0.05 * total
    kept_letters, kept = [], []
    for a, letter in enumerate(letters):
        if np.round(weights[a], 2) > cut:
            kept_letters.append(letter)
            kept.append(np.round(weights[a], 2))
    if not kept:  # pathological: keep the single best algorithm
        a = int(np.argmax(weights))
        kept_letters, kept = [letters[a]], [np.round(weights[a], 2)]
    kept = np.asarray(kept)
    # the reference's `if (txt == 1) txt <- "none"` (V73:429) only fires on
    # the literal value 1, which the normal flow never produces
    text = ":".join(_fmt_r(w / kept.sum() * 100) for w in kept)
    if text == "1":
        text = "none"
    return WeightResult(
        weights=weights, letters="".join(kept_letters), kept_weights=kept,
        weight_total=total, percent_text=text, objective=float(objective),
    )


def optimize_weights_lbfgsb(residuals, letters: Sequence[str] = LETTER_ORDER) -> WeightResult:
    """L-BFGS-B from 0.5 per weight (V73:327-333); residuals (A, n)."""
    res = np.asarray(residuals, np.float64)
    a = res.shape[0]

    def f(k):
        s = max(k.sum(), 1e-12)
        mix = (k / s) @ res
        return float(mix @ mix)

    def grad(k):
        s = max(k.sum(), 1e-12)
        mix = (k / s) @ res
        g_mix = 2.0 * res @ mix           # d fit / d (k/s)
        return (g_mix - (k / s) @ g_mix) / s

    out = minimize(f, np.full(a, 0.5), jac=grad, method="L-BFGS-B", bounds=[(0.0, 1.0)] * a)
    return _select(out.x, letters, out.fun)


def optimize_weights_aicc(residuals, letters: Sequence[str] = LETTER_ORDER) -> WeightResult:
    """The historical V18 selection: every equal-weight subset of the
    algorithms, the one of least AICc with the ensemble size as its
    parameter count (old/...V18.R:285-291, 360-366).  All 2^A - 1 subsets
    are scored in one batched matmul, on the residuals' device."""
    res = torch.as_tensor(residuals)
    a, n = res.shape
    bits = torch.arange(1, 2**a, device=res.device)[:, None] >> torch.arange(a, device=res.device)[None, :]
    masks = (bits & 1).to(res.dtype)
    rss = ensemble_objective(masks, res)                     # equal weights = mask / k
    k = masks.sum(1)
    aicc = n * torch.log((rss / n).clamp_min(1e-300)) + 2 * k + 2 * k * (k + 1) / (n - k - 1).clamp_min(1.0)
    i = int(torch.argmin(aicc))
    weights = masks[i].cpu().numpy().astype(np.float64)
    kw = weights[weights > 0]
    return WeightResult(
        weights=weights, letters="".join(letters[j] for j in range(a) if weights[j] > 0), kept_weights=kw,
        weight_total=float(weights.sum()), percent_text=":".join(_fmt_r(100.0 / len(kw)) for _ in kw),
        objective=float(rss[i]),
    )


def optimize_weights_sweep(residuals, letters: Sequence[str] = LETTER_ORDER, n_candidates: int = 4096,
                           refine_steps: int = 200, *, cands=None, noise=None,
                           generator: torch.Generator | None = None) -> WeightResult:
    """Batched candidate sweep, then a derivative-free zoom, on the
    residuals' device: ``n_candidates`` uniform weight vectors and k = 0.5
    scored in one matmul; then max(refine_steps // 10, 12) rounds of 256
    Gaussian perturbations of the best (radius 0.3 x 0.7^round, clipped to
    [0, 1]), each round one matmul.  ``cands`` (n_candidates, A) and
    ``noise`` (rounds, 256, A) inject the draws, else they are drawn on the
    CPU from ``generator`` (default: seeded 0, as the JAX package's default
    key is fixed).

    A weight vector that sums to 0 weights nothing (fit(k) is 0/0 there,
    which ``ensemble_objective`` scores as 0, the least value): it is never
    taken.  The JAX package's sweep takes it whenever a perturbation clips
    every weight to 0, which with two algorithms happens for 6 of 20 keys,
    and its ensemble is then NaN; where it does not, the two searches agree."""
    res = torch.as_tensor(residuals)
    a = res.shape[0]
    dt, dev = res.dtype, res.device
    n_zoom = max(refine_steps // 10, 12)
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    if cands is None:
        cands = torch.rand((n_candidates, a), generator=g, dtype=torch.float64)
    if noise is None:
        noise = torch.randn((n_zoom, 256, a), generator=g, dtype=torch.float64)
    cands = torch.as_tensor(cands, device=dev).to(dt)
    noise = torch.as_tensor(noise, device=dev).to(dt)
    cands = torch.cat([cands, torch.full((1, a), 0.5, dtype=dt, device=dev)], dim=0)
    inf = torch.full((), float("inf"), dtype=dt, device=dev)
    score = lambda k: torch.where(k.sum(-1) > 0, ensemble_objective(k, res), inf)
    best = cands[torch.argmin(score(cands))]
    best_val = score(best)
    sigmas = 0.3 * 0.7 ** torch.arange(n_zoom, dtype=dt, device=dev)
    for z in range(n_zoom):
        local = (best[None, :] + sigmas[z] * noise[z]).clamp(0.0, 1.0)
        vals = score(local)
        i = torch.argmin(vals)
        better = vals[i] < best_val
        best = torch.where(better, local[i], best)
        best_val = torch.where(better, vals[i], best_val)
    return _select(best.cpu().numpy(), letters, float(best_val))
