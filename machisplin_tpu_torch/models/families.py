"""gbm loss families: gaussian, laplace, poisson, bernoulli (counterpart of
``machisplin_tpu/models/families.py``).

The reference's vendored gbm.step accepts all four families (V73:1673
``family``; deviance formulas V73:2250-2284) and hands the boosting to the
C++ ``gbm::gbm`` engine.  These are that engine's per-family pieces:

* ``f0_init``     the intercept-only fit on the link scale;
* ``gradient``    the working response a tree is grown on (gbm grows
                  least-squares trees on the negative gradient for every
                  family);
* ``leaf_adjust`` the terminal-node estimate that replaces the raw
                  least-squares leaf mean (a Newton step for bernoulli, a
                  log-ratio for poisson, the node median for laplace);
* ``response``    the inverse link from the boosted score to the response
                  scale (the exp/logistic transforms the driver applies by
                  hand, V73:1837-1851).

Every function works on tensors with leading batch axes (one row per
boosting chain), reducing over the last axis.
"""
from __future__ import annotations

import torch

__all__ = ["FAMILIES", "check_family", "f0_init", "gradient", "leaf_adjust", "response"]

FAMILIES = ("gaussian", "laplace", "poisson", "bernoulli")

_EPS = 1e-12
# gbm clamps poisson node estimates to +-19 on the log scale
_POISSON_CAP = 19.0


def check_family(family: str) -> str:
    """The family's canonical name ("binomial" is bernoulli); raises on an
    unknown one."""
    family = family.lower()
    if family == "binomial":
        family = "bernoulli"
    if family not in FAMILIES:
        raise ValueError(f"unknown family {family!r}; expected one of {FAMILIES}")
    return family


def _masked_median(vals, active):
    """Median over the last axis of ``vals`` where ``active`` > 0 (0 where
    no row is active)."""
    big = torch.finfo(vals.dtype).max
    n = vals.shape[-1]
    v = torch.sort(torch.where(active > 0, vals, big), dim=-1).values
    cnt = (active > 0).sum(-1)
    hi = ((cnt - 1) // 2 + (cnt % 2 == 0).long()).clamp(0, n - 1)
    lo = ((cnt - 1) // 2).clamp(0, n - 1)
    med = 0.5 * (v.gather(-1, lo[..., None])[..., 0] + v.gather(-1, hi[..., None])[..., 0])
    return torch.where(cnt > 0, med, torch.zeros((), dtype=vals.dtype, device=vals.device))


def f0_init(y, w, family: str, offset=None):
    """Intercept-only fit on the link scale (gbm's initF), over the last
    axis of y/w (n,) or (K, n).

    ``offset`` (gbm's per-row fixed term on the link scale, V73:1664/1774):
    the intercept solves the weighted score equation given the offset: the
    mean or median of ``y - offset`` for gaussian or laplace, the log-ratio
    ``log(sum w y / sum w exp(offset))`` for poisson, and a Newton solve of
    ``sum w (y - sigmoid(f0 + offset)) = 0`` for bernoulli."""
    family = check_family(family)
    wsum = w.sum(-1).clamp_min(1.0)
    ybar = (w * y).sum(-1) / wsum
    if offset is None:
        if family == "gaussian":
            return ybar
        if family == "laplace":
            return _masked_median(y.expand_as(w), w)
        if family == "poisson":
            return torch.log(ybar.clamp_min(_EPS))
        p = ybar.clamp(_EPS, 1 - _EPS)          # bernoulli: logit of the weighted prevalence
        return torch.log(p / (1 - p))
    if family == "gaussian":
        return (w * (y - offset)).sum(-1) / wsum
    if family == "laplace":
        return _masked_median((y - offset).expand_as(w), w)
    if family == "poisson":
        num = (w * y).sum(-1).clamp_min(_EPS)
        den = (w * torch.exp(offset)).sum(-1).clamp_min(_EPS)
        return torch.log(num / den)
    p0 = ybar.clamp(_EPS, 1 - _EPS)
    f0 = torch.log(p0 / (1 - p0))
    for _ in range(25):
        p = 1.0 / (1.0 + torch.exp(-(f0[..., None] + offset)))
        num = (w * (y - p)).sum(-1)
        den = (w * p * (1.0 - p)).sum(-1).clamp_min(_EPS)
        f0 = f0 + num / den
    return f0


def gradient(y, f, family: str):
    """Negative gradient of the deviance in f: the tree's working response."""
    family = check_family(family)
    if family == "gaussian":
        return y - f
    if family == "laplace":
        return torch.sign(y - f)
    if family == "poisson":
        return y - torch.exp(f)
    return y - 1.0 / (1.0 + torch.exp(-f))     # bernoulli: y - p


def response(f, family: str):
    """Inverse link (the driver's manual exp/logistic, V73:1837-1851)."""
    family = check_family(family)
    if family in ("gaussian", "laplace"):
        return f
    if family == "poisson":
        return torch.exp(f)
    return 1.0 / (1.0 + torch.exp(-f))


def leaf_adjust(values, cur, n_total: int, y, f, w, family: str):
    """Family-correct terminal-node estimates of K trees.

    values (K, n_total) raw least-squares node means of the gradient (what
    the grower gave), returned as they are for gaussian; cur (K, n) each
    training row's node; y (n,) or (K, n) response, f (K, n) current
    score, w (K, n) in-bag weights (0 = unused row)."""
    family = check_family(family)
    if family == "gaussian":
        return values
    k, n = cur.shape
    y = y.expand(k, n)
    node1h = (cur[:, None, :] == torch.arange(n_total, device=cur.device)[None, :, None]).to(w.dtype)  # (K, N, n)
    if family == "laplace":
        # gbm: the node estimate is the median of the node's residuals
        active = node1h * (w > 0).to(w.dtype)[:, None, :]
        return _masked_median((y - f)[:, None, :].expand(k, n_total, n), active)
    node_sum = lambda a: torch.einsum("kin,kn->ki", node1h, a)
    if family == "poisson":
        num = node_sum(w * y)
        den = node_sum(w * torch.exp(f))
        val = torch.log(num.clamp_min(_EPS) / den.clamp_min(_EPS))
        return torch.where(den > 0, val, torch.zeros((), dtype=val.dtype, device=val.device)).clamp(
            -_POISSON_CAP, _POISSON_CAP)
    # bernoulli: one Newton step, sum w (y - p) / sum w p (1 - p)
    p = 1.0 / (1.0 + torch.exp(-f))
    num = node_sum(w * (y - p))
    den = node_sum(w * p * (1.0 - p))
    return torch.where(den > _EPS, num / den.clamp_min(_EPS), torch.zeros((), dtype=num.dtype, device=num.device))
