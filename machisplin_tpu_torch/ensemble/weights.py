"""Ensemble weight selection (host code; counterpart of
``machisplin_tpu/ensemble/weights.py``'s reference-faithful path).

The reference minimises the summed squared weight-normalised CV residual

    fit(k) = sum_i ( sum_a k_a * r_{a,i} / sum_a k_a )^2

over k in [0,1]^A by L-BFGS-B from k=0.5 (V73:329-333 / 369-373), then keeps
algorithms whose ROUNDED weight round(k_a, 2) exceeds 5% of the UNROUNDED
weight total (V73:337-362 — both quirks preserved), with the letter string in
the fixed order b, g, n, m, r, v and per-algorithm percentages of the
kept-weight total (V73:408-428).  The problem is 2-6 dimensional, so it runs
in float64 numpy + scipy on the host.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
from scipy.optimize import minimize

from ..models.base import LETTER_ORDER

__all__ = ["WeightResult", "optimize_weights_lbfgsb"]


class WeightResult(NamedTuple):
    weights: np.ndarray        # (A,) raw optimised weights in [0, 1]
    letters: str               # kept algorithms, reference letter order
    kept_weights: np.ndarray   # rounded weights of kept algorithms
    weight_total: float        # UNROUNDED total over all algorithms (V73:337)
    percent_text: str          # "62.5:37.5"-style text (V73:408-428)
    objective: float


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
