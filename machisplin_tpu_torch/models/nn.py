"""Neural-network model — single-hidden-layer MLP, linear output
(counterpart of ``machisplin_tpu/models/nn.py``).

Mirrors the reference's ``nnet::nnet(form, data, size=10, linout=TRUE,
maxit=10000)`` (V73:249 CV / V73:463 final) as the JAX package does: 10
logistic hidden units, linear output, inputs standardised with the weighted
moments, full-batch training by L-BFGS (``optim/lbfgs.py``, the port's copy
of optax's ``lbfgs(memory_size=20)`` and zoom line search) for a fixed
``maxit`` steps with no convergence stop.  The response is min-shifted and
max-scaled by the callers (CV and final fits), as in the JAX package.

Models are batched over a leading lane axis, where the JAX package used
``vmap``: ``y`` and ``sample_weight`` are (n,) for one model or (L, n) for
L models on the same ``x`` (CV folds, responses).  The L-BFGS parameters
are one flat (L, P) row per lane, P = p*h + 2h + 1, in the order of the
JAX package's params tuple: ``w1`` (p, h) row-major, ``b1`` (h), ``w2``
(h), ``b2`` (``params_to_flat`` / ``flat_to_params``).  The loss's
gradient is written out (no autograd), so the CUDA graph of the L-BFGS pass
captures it as plain kernels.

Initial weights are uniform in [-init_range, init_range): pass them as
``init=(w1, b1, w2, b2)`` (the parity tests pass the JAX package's threefry
draws) or draw them from a ``torch.Generator`` (on the CPU, in float64, so
a seed gives the same start on every device).

Variable importance is Garson's algorithm (``NeuralNetTools::garson``,
V73:465).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..optim import lbfgs
from .base import as_weight

__all__ = ["NNState", "fit", "fit_carry_init", "fit_carry_steps", "carry_to_state", "predict", "importance",
           "params_to_flat", "flat_to_params", "draw_init"]


class NNState(NamedTuple):
    w1: torch.Tensor        # (..., p, h)
    b1: torch.Tensor        # (..., h)
    w2: torch.Tensor        # (..., h)
    b2: torch.Tensor        # (...)
    x_mean: torch.Tensor    # (..., p)
    x_scale: torch.Tensor   # (..., p)


def params_to_flat(w1, b1, w2, b2) -> torch.Tensor:
    """(L, P) rows [w1 row-major, b1, w2, b2] from batched (L, ...) params."""
    n = w1.shape[0]
    return torch.cat([w1.reshape(n, -1), b1, w2, b2.reshape(n, 1)], dim=1)


def flat_to_params(flat: torch.Tensor, p: int, h: int):
    """(w1 (L, p, h), b1 (L, h), w2 (L, h), b2 (L,)) views of (L, P) rows."""
    n = flat.shape[0]
    return (flat[:, : p * h].reshape(n, p, h), flat[:, p * h : p * h + h], flat[:, p * h + h : p * h + 2 * h],
            flat[:, p * h + 2 * h])


def _forward(params, xs):
    """MLP output (L, m) for batched params and inputs xs (L, m, p)."""
    w1, b1, w2, b2 = params
    hidden = torch.sigmoid(xs @ w1 + b1[:, None, :])
    return (hidden @ w2[:, :, None])[..., 0] + b2[:, None]


def _loss_fn(xs, y, w, wsum, p: int, h: int, decay: float):
    """``loss(params (L, P)) -> (value (L,), grad (L, P))``: the weighted
    mean squared error (plus ``decay`` times the squared weights) and its
    gradient by the chain rule."""

    def loss(flat):
        w1, b1, w2, b2 = flat_to_params(flat, p, h)
        hidden = torch.sigmoid(xs @ w1 + b1[:, None, :])                # (L, n, h)
        r = (hidden @ w2[:, :, None])[..., 0] + b2[:, None] - y          # (L, n)
        value = (w * (r * r)).sum(-1) / wsum
        g_out = (w / wsum[:, None]) * (2.0 * r)                         # d value / d output
        g_hidden = g_out[:, :, None] * w2[:, None, :] * (hidden * (1.0 - hidden))
        grad = torch.cat([
            (xs.transpose(1, 2) @ g_hidden).reshape(flat.shape[0], -1),
            g_hidden.sum(1), (hidden.transpose(1, 2) @ g_out[:, :, None])[..., 0], g_out.sum(-1, keepdim=True),
        ], dim=1)
        if decay:
            value = value + decay * (flat * flat).sum(-1)
            grad = grad + decay * 2.0 * flat
        return value, grad

    return loss


def _lanes(x, y, sample_weight):
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device).to(x.dtype)
    y = y[None] if y.dim() == 1 else y
    w = as_weight(sample_weight, y.shape, x.dtype, x.device)
    return x, y, w.expand(y.shape)


def _moments(x, w):
    """Weighted mean and scale of each covariate per lane (nn.py:61-67)."""
    wsum = w.sum(-1).clamp_min(1.0)
    x_mean = (x[None] * w[..., None]).sum(-2) / wsum[:, None]
    xc = x[None] - x_mean[:, None, :]
    x_scale = torch.sqrt((w[..., None] * xc * xc).sum(-2) / wsum[:, None])
    x_scale = torch.where(x_scale > 0, x_scale, torch.ones((), dtype=x.dtype, device=x.device))
    return x_mean, x_scale


def draw_init(n_lanes: int, p: int, hidden: int, init_range: float = 0.7, generator=None, dtype=torch.float64,
              device="cpu"):
    """Uniform initial weights in [-init_range, init_range) for ``n_lanes``
    models, drawn on the CPU in float64 from ``generator``."""
    shapes = [(n_lanes, p, hidden), (n_lanes, hidden), (n_lanes, hidden), (n_lanes,)]
    draws = [torch.rand(s, generator=generator, dtype=torch.float64) * (2 * init_range) - init_range for s in shapes]
    return tuple(d.to(dtype=dtype, device=device) for d in draws)


def _init_flat(init, n_lanes, p, hidden, init_range, generator, dtype, device):
    if init is None:
        init = draw_init(n_lanes, p, hidden, init_range, generator, dtype, device)
    parts = [torch.as_tensor(a, device=device).to(dtype) for a in init]
    shapes = [(p, hidden), (hidden,), (hidden,), ()]
    parts = [a.expand((n_lanes,) + s) if a.dim() == len(s) else a for a, s in zip(parts, shapes)]
    return params_to_flat(*parts).contiguous()


def fit_carry_init(x, y, *, sample_weight=None, hidden: int = 10, init_range: float = 0.7, init=None,
                   generator: torch.Generator | None = None):
    """Initial carry (params (L, P), L-BFGS state, x_mean, x_scale) for
    fitting in segments; ``fit_carry_steps`` advances it."""
    x, y, w = _lanes(x, y, sample_weight)
    x_mean, x_scale = _moments(x, w)
    flat = _init_flat(init, y.shape[0], x.shape[1], hidden, init_range, generator, x.dtype, x.device)
    return flat, lbfgs.init(flat), x_mean, x_scale


def fit_carry_steps(carry, x, y, *, sample_weight=None, steps: int, decay: float = 0.0, graph=None,
                    stats: dict | None = None):
    """Advance every lane's L-BFGS loop ``steps`` steps: the same step
    sequence as ``fit``, so K segments of ``fit_carry_steps`` give ``fit``'s
    result bit for bit."""
    flat, state, x_mean, x_scale = carry
    x, y, w = _lanes(x, y, sample_weight)
    wsum = w.sum(-1).clamp_min(1.0)
    xs = (x[None] - x_mean[:, None, :]) / x_scale[:, None, :]
    p = x.shape[1]
    h = (flat.shape[1] - 1) // (p + 2)
    loss = _loss_fn(xs, y, w, wsum, p, h, decay)
    flat, state = lbfgs.run(loss, flat, state, steps, graph=graph, stats=stats)
    return flat, state, x_mean, x_scale


def carry_to_state(carry) -> NNState:
    flat, _, x_mean, x_scale = carry
    p = x_mean.shape[-1]
    h = (flat.shape[1] - 1) // (p + 2)
    w1, b1, w2, b2 = flat_to_params(flat, p, h)
    return NNState(w1=w1, b1=b1, w2=w2, b2=b2, x_mean=x_mean, x_scale=x_scale)


def fit(x, y, *, sample_weight=None, hidden: int = 10, maxit: int = 10000, init_range: float = 0.7,
        decay: float = 0.0, init=None, generator: torch.Generator | None = None, graph=None,
        stats: dict | None = None) -> NNState:
    """Train one MLP per lane for ``maxit`` L-BFGS steps.  ``y`` (n,) or
    (L, n); ``init`` (w1, b1, w2, b2) with or without the lane axis, else
    drawn from ``generator``.  A single model's state has no lane axis."""
    single = torch.as_tensor(y).dim() == 1
    carry = fit_carry_init(x, y, sample_weight=sample_weight, hidden=hidden, init_range=init_range, init=init,
                           generator=generator)
    carry = fit_carry_steps(carry, x, y, sample_weight=sample_weight, steps=maxit, decay=decay, graph=graph,
                            stats=stats)
    state = carry_to_state(carry)
    return NNState(*(a[0] for a in state)) if single else state


def predict(state: NNState, x) -> torch.Tensor:
    """(m,) for one model, (L, m) for a batch."""
    x = torch.as_tensor(x)
    single = state.b2.dim() == 0
    st = NNState(*(a[None] for a in state)) if single else state
    xs = (x[None] - st.x_mean[:, None, :]) / st.x_scale[:, None, :]
    out = _forward((st.w1, st.b1, st.w2, st.b2), xs)
    return out[0] if single else out


def importance(state: NNState, names) -> dict:
    """Garson relative importance from |input-hidden| x |hidden-output|
    weights (NeuralNetTools::garson semantics, V73:465); sums to 1.  One
    unbatched model."""
    contrib = torch.abs(state.w1) * torch.abs(state.w2)[None, :]      # (p, h)
    share = contrib / torch.clamp(contrib.sum(0, keepdim=True), min=1e-12)
    rel = share.sum(1)
    rel = rel / torch.clamp(rel.sum(), min=1e-12)
    return {n: float(v) for n, v in zip(names, rel.tolist())}
