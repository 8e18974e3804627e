"""optax 0.2.6's ``lbfgs(memory_size=20)`` with its zoom line search, batched
over lanes: the optimiser ``machisplin_tpu/models/nn.py`` trains with.

The port does not depend on optax, so it keeps its own copy, written from
``optax/_src``:

* ``alias.lbfgs`` is chain(``transform.scale_by_lbfgs(memory_size,
  scale_init_precond=True)``, ``scale(-1)``,
  ``linesearch.scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy="one")``).  ``max_learning_rate`` stays None, as
  ``lbfgs`` leaves it: the interval search doubles the stepsize unbounded.
* ``scale_by_lbfgs`` keeps the last ``memory_size`` parameter and gradient
  differences with their weights 1 / <dg, dp> (0 where that is 0), scales
  the identity by <dg, dp> / |dg|^2 (min(1, 1 / |g|) at the first step)
  and applies the two-loop recursion (``_precondition_by_lbfgs``).  The
  circular buffer is kept here as a queue, oldest entry first: the same
  entries in the same order, so that every lane iterates the same memory
  slots whatever its step count.  Unwritten entries are zero and leave the
  recursion exactly unchanged, as in optax.
* ``zoom_linesearch``: the interval search (Nocedal and Wright, Algorithm
  3.5) and the zoom (Algorithm 3.6) with cubic, quadratic and bisection
  candidates (``_cubicmin``, ``_quadmin``), the Armijo and approximate
  (Hager-Zhang) decrease errors, the curvature error, the safe step taken
  when the search fails, and every default tolerance.
* ``utils.value_and_grad_from_state``: a step starts from the value and
  gradient the previous line search ended on, and evaluates the function
  at the parameters only where that value is not finite (the first step).

Layout.  Parameters are one flat ``(L, P)`` tensor: one row per lane (an
independent problem: a CV fold, a response).  A caller with a pytree of
leaves flattens them in its own order (``models/nn.py``: ``w1`` row-major,
``b1``, ``w2``, ``b2``); only the order of the dot products' terms depends
on it.  Lane state is a set of ``(L,)`` and ``(L, P)`` tensors; the memory
is ``(M, L, P)``.

Lanes.  Under ``jax.vmap`` each lane's line search is a while loop that
runs while any lane is unfinished and freezes a finished lane, so a lane's
result is that of its own unbatched run.  Here every lane runs its own step
sequence: a *pass* makes one function evaluation for all lanes at once, and
each lane uses it for its own next need (the first evaluation at its
parameters, or its line search's next trial stepsize), then starts its next
step as soon as its line search ends.  A lane that has made its ``steps``
steps is frozen.  So each lane equals its unbatched run, and no lane waits
for another's line search.  Every pass advances a lane by at most one step,
so the host reads the largest number of steps still to make, runs that many
passes without looking, and reads again: a handful of host syncs a run.

Fixed points.  The loop has no convergence stop (the JAX package runs all
``maxit`` steps).  A converged lane's steps often change nothing: its line
search ends at a stepsize too small to move any parameter, and the step
pushes a zero pair (weight 0) into the memory.  Once a step leaves the
parameters, value and gradient unchanged bit for bit, the step before it
did too, and every memory weight is zero, the next step has exactly that
step's inputs (the same parameters, value and gradient, zero differences,
the identity scale 1, a recursion that zero weights leave unchanged), so it
repeats it, and so does every later one.  Such a lane stops there, and its
state is given the skipped steps' effect (their count, and the zero pairs
in the memory): the result is the same bit for bit as making every step
(``skip_fixed_points=False``), at a fraction of the passes.

On a CUDA device the pass is captured once into a CUDA graph (``UNROLL``
passes a graph) and replayed; on the CPU it runs eagerly.  Both run the
same arithmetic (on the GPU a row's dot products are batched matmuls).

The function is the caller's: ``fun(params) -> (value (L,), grad (L, P))``.
``models/nn.py`` gives explicit gradient formulas (no autograd), which a
CUDA graph captures as plain kernels.
"""
from __future__ import annotations

import time
from typing import Callable, NamedTuple

import torch

__all__ = ["LBFGSState", "init", "run"]

MEMORY_SIZE = 20


# scale_by_zoom_linesearch's arguments as optax.lbfgs sets them (tol and
# the others are zoom_linesearch's defaults; max_learning_rate is None, so
# the interval search doubles the stepsize without a cap)
MAX_LINESEARCH_STEPS = 20
TOL = 0.0
INCREASE_FACTOR = 2.0
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
STEPSIZE_PRECISION = 1e-5     # zoom_linesearch's interval_threshold
UNROLL = 4                    # passes a CUDA graph


class LBFGSState(NamedTuple):
    """The optimiser's state between steps, per lane (optax's chained state
    without the stateless ``scale``)."""

    # scale_by_lbfgs
    count: torch.Tensor        # (L,) int64 steps made
    prev_params: torch.Tensor  # (L, P) params at the last step's start
    prev_grad: torch.Tensor    # (L, P) gradient there
    s_mem: torch.Tensor        # (M, L, P) parameter differences, oldest first
    y_mem: torch.Tensor        # (M, L, P) gradient differences
    rho: torch.Tensor          # (M, L) weights 1 / <y, s>
    # scale_by_zoom_linesearch
    learning_rate: torch.Tensor  # (L,) the last line search's stepsize
    value: torch.Tensor          # (L,) value at params (inf before the first step)
    grad: torch.Tensor           # (L, P) gradient at params
    ls_steps: torch.Tensor       # (L,) int64 the last line search's iterations


def init(params: torch.Tensor, memory_size: int = MEMORY_SIZE) -> LBFGSState:
    """``optax.lbfgs(memory_size).init`` for (L, P) params."""
    n_lanes, _ = params.shape
    z = torch.zeros_like(params)
    zl = torch.zeros(n_lanes, dtype=params.dtype, device=params.device)
    zi = torch.zeros(n_lanes, dtype=torch.int64, device=params.device)
    mem = torch.zeros((memory_size,) + tuple(params.shape), dtype=params.dtype, device=params.device)
    return LBFGSState(
        count=zi, prev_params=z, prev_grad=z.clone(), s_mem=mem, y_mem=mem.clone(),
        rho=torch.zeros((memory_size, n_lanes), dtype=params.dtype, device=params.device),
        learning_rate=torch.ones_like(zl), value=torch.full_like(zl, float("inf")), grad=z.clone(),
        ls_steps=zi.clone(),
    )


def _dot(a, b):
    """Row-wise dot products of (L, P) tensors: on a GPU one batched matmul
    (one launch instead of two), on the CPU a product and a sum."""
    if a.is_cuda:
        return torch.bmm(a[:, None, :], b[:, :, None]).view(-1)
    return (a * b).sum(-1)


def _precondition(g, s_mem, y_mem, rho, identity_scale):
    """The two-loop recursion of ``_precondition_by_lbfgs``: H g for the
    memory (M, L, P), oldest first, and the identity's scale (L,)."""
    m = s_mem.shape[0]
    q = g
    alphas = [None] * m
    for i in range(m - 1, -1, -1):      # newest to oldest
        alphas[i] = rho[i] * _dot(s_mem[i], q)
        q = torch.addcmul(q, alphas[i][:, None], y_mem[i], value=-1.0)
    q = identity_scale[:, None] * q
    for i in range(m):                  # oldest to newest
        beta = rho[i] * _dot(y_mem[i], q)
        q = torch.addcmul(q, (alphas[i] - beta)[:, None], s_mem[i])
    return q


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (``linesearch._cubicmin``); NaN where there is none."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    v0 = fb - fa - C * db
    v1 = fc - fa - C * dc
    A = (dc * dc * v0 + -(db * db) * v1) / denom
    B = (-(dc * dc * dc) * v0 + db * db * db * v1) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + torch.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (``linesearch._quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


# a running line search's state per lane: direction u, iterations, the
# current stepsize with its value, gradient and slope, the values at 0, the
# interval (low, high, the cubic's third point) and the safe point
_LS_FIELDS = ("u", "ls_count", "t", "lv", "lg", "lslope", "vi", "si", "found", "low", "vlow", "slow", "high",
              "vhigh", "shigh", "cref", "vcref", "safe_t", "safe_v", "safe_g")


_MEMORY = ("s_mem", "y_mem", "rho")      # leading memory axis, then lanes


def _select(mask, new: dict, old: dict) -> dict:
    """Per lane: ``new``'s fields (tensors or Python scalars) where ``mask``
    (L,), else ``old``'s."""
    out = dict(old)
    for k, v in new.items():
        o = old[k]
        m = mask[None] if k in _MEMORY else mask
        m = m.view(m.shape + (1,) * (o.dim() - m.dim()))
        out[k] = torch.where(m, v, o)
    return out


def _start(S: dict) -> dict:
    """``scale_by_lbfgs.update_fn`` (memory update, identity scale, two-loop
    recursion), ``scale(-1)`` and the zoom line search's ``init_fn`` for
    every lane, from its stored value and gradient."""
    x, g, k = S["params"], S["grad"], S["count"]
    first = k == 0
    dp = x - S["prev_params"]
    dg = g - S["prev_grad"]
    vd = _dot(dg, dp)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    one = torch.ones((), dtype=x.dtype, device=x.device)
    weight = torch.where(vd == 0.0, zero, 1.0 / vd)
    dp = torch.where(first[:, None], zero, dp)
    dg = torch.where(first[:, None], zero, dg)
    weight = torch.where(first, zero, weight)
    s_mem = torch.cat([S["s_mem"][1:], dp[None]])
    y_mem = torch.cat([S["y_mem"][1:], dg[None]])
    rho = torch.cat([S["rho"][1:], weight[None]])
    numerator = _dot(dg, dp)
    denominator = _dot(dg, dg)
    identity_scale = torch.where(denominator > 0.0, numerator / denominator, one)
    capped_inv_norm = torch.minimum(one, 1.0 / torch.sqrt(_dot(g, g)))
    identity_scale = torch.where(first, capped_inv_norm, identity_scale)
    u = -_precondition(g, s_mem, y_mem, rho, identity_scale)
    value = S["value"]
    slope = _dot(u, g)
    return {
        "count": k + 1, "prev_params": x, "prev_grad": g, "s_mem": s_mem, "y_mem": y_mem, "rho": rho,
        "u": u, "ls_count": 0, "t": 0.0, "lv": value, "lg": g, "lslope": slope,
        "vi": value, "si": slope, "found": False, "low": 0.0, "vlow": value, "slow": slope, "high": 0.0, "vhigh": value, "shigh": slope,
        "cref": 0.0, "vcref": value, "safe_t": 0.0, "safe_v": value, "safe_g": g,
    }


def _pass(fun: Callable, S: dict, skip_fixed: bool = True) -> dict:
    """One evaluation for every lane, and what each lane does with it."""
    # a lane between steps starts its next one from its stored value and
    # gradient; where the value is not finite it first spends this pass's
    # evaluation on them (value_and_grad_from_state)
    idle = ~S["in_ls"] & (S["todo"] > 0)
    start = idle & (torch.isfinite(S["value"]) | S["evaluated"])
    S = _select(start, _start(S), S)
    in_ls = S["in_ls"] | start
    eval_only = idle & ~start

    # the trial stepsize: the interval search's next point or the zoom's
    found, n = S["found"], S["ls_count"]
    t_prev = S["t"]
    t_search = torch.where(n == 0, torch.ones_like(t_prev), INCREASE_FACTOR * t_prev)
    low, high = S["low"], S["high"]
    vlow, slow, vhigh, shigh = S["vlow"], S["slow"], S["vhigh"], S["shigh"]
    delta = torch.abs(high - low)
    left = torch.minimum(high, low)
    right = torch.maximum(high, low)
    cubic_chk = 0.2 * delta
    quad_chk = 0.1 * delta
    too_small_int = delta <= STEPSIZE_PRECISION
    m_cubic = _cubicmin(low, vlow, slow, high, vhigh, S["cref"], S["vcref"])
    use_cubic = (m_cubic > left + cubic_chk) & (m_cubic < right - cubic_chk)
    m_quad = _quadmin(low, vlow, slow, high, vhigh)
    use_quad = ~use_cubic & (m_quad > left + quad_chk) & (m_quad < right - quad_chk)
    use_bisection = ~use_cubic & ~use_quad
    middle = torch.where(use_cubic, m_cubic, S["cref"])
    middle = torch.where(use_quad, m_quad, middle)
    middle = torch.where(use_bisection, (low + high) / 2.0, middle)
    t = torch.where(found, middle, t_search)

    # one evaluation for all lanes: at the trial point, or at the params
    x, u = S["params"], S["u"]
    point = torch.where(in_ls[:, None], x + t[:, None] * u, x)
    value, grad = fun(point)
    slope = _dot(grad, u)

    vi, si = S["vi"], S["si"]
    # the Armijo decrease, or the approximate (Hager-Zhang) one near a minimum
    decrease_error = value - vi - SLOPE_RTOL * t * si
    approx = slope - (2 * SLOPE_RTOL - 1.0) * si
    delta_values = value - vi - APPROX_DEC_RTOL * torch.abs(vi)
    decrease_error = torch.minimum(torch.maximum(approx, delta_values), decrease_error)
    zero = torch.zeros_like(value)
    decrease_error = torch.maximum(decrease_error, zero)
    decrease_error = torch.where(torch.isnan(decrease_error), float("inf"), decrease_error)
    curvature_error = torch.maximum(torch.abs(slope) - CURV_RTOL * torch.abs(si), zero)
    curvature_error = torch.where(torch.isnan(curvature_error), float("inf"), curvature_error)
    error = torch.maximum(decrease_error, curvature_error)
    good = error <= TOL
    safe_decrease = decrease_error <= TOL
    last_iter = n + 1 >= MAX_LINESEARCH_STEPS

    # _search_interval
    prev_v, prev_s = S["lv"], S["lslope"]
    set_high = (decrease_error > 0.0) | ((value >= prev_v) & (n > 0))
    set_low = (slope >= 0.0) & ~set_high
    s_low = torch.where(set_low, t, t_prev)
    s_vlow = torch.where(set_low, value, prev_v)
    s_slow = torch.where(set_low, slope, prev_s)
    s_high = torch.where(set_low, t_prev, t)
    s_vhigh = torch.where(set_low, prev_v, value)
    s_shigh = torch.where(set_low, prev_s, slope)
    s_found = set_high | set_low | good

    # _zoom_into_interval
    z_safe = safe_decrease & (value < S["safe_v"])
    high_to_middle = (decrease_error > 0.0) | (value >= vlow)
    high_to_low = (slope * (high - low) >= 0.0) & ~high_to_middle
    z_high = torch.where(high_to_low, low, torch.where(high_to_middle, t, high))
    z_vhigh = torch.where(high_to_low, vlow, torch.where(high_to_middle, value, vhigh))
    z_shigh = torch.where(high_to_low, slow, torch.where(high_to_middle, slope, shigh))
    z_low = torch.where(high_to_middle, low, t)
    z_vlow = torch.where(high_to_middle, vlow, value)
    z_slow = torch.where(high_to_middle, slow, slope)
    moved_high = high_to_middle | high_to_low
    z_cref = torch.where(moved_high, high, low)
    z_vcref = torch.where(moved_high, vhigh, vlow)

    take_safe = torch.where(found, z_safe, safe_decrease)
    safe_t = torch.where(take_safe, t, S["safe_t"])
    safe_v = torch.where(take_safe, value, S["safe_v"])
    safe_g = torch.where(take_safe[:, None], grad, S["safe_g"])
    done = good           # both phases (max_learning_rate None is never reached)
    z_failed = last_iter | (too_small_int & (safe_t > 0.0))
    failed = torch.where(found, z_failed, last_iter) & ~done
    new_low = torch.where(found, z_low, s_low)
    new_vlow = torch.where(found, z_vlow, s_vlow)
    ls = {
        "ls_count": n + 1, "t": t, "lv": value, "lg": grad, "lslope": slope,
        "found": found | s_found,
        "low": new_low, "vlow": new_vlow, "slow": torch.where(found, z_slow, s_slow),
        "high": torch.where(found, z_high, s_high), "vhigh": torch.where(found, z_vhigh, s_vhigh),
        "shigh": torch.where(found, z_shigh, s_shigh),
        "cref": torch.where(found, z_cref, new_low), "vcref": torch.where(found, z_vcref, new_vlow),
        "safe_t": safe_t, "safe_v": safe_v, "safe_g": safe_g,
    }
    # _try_safe_step where the search failed
    use_safe = failed & ((safe_t > 0.0) | torch.isinf(decrease_error))
    ls["t"] = torch.where(use_safe, safe_t, t)
    ls["lv"] = torch.where(use_safe, safe_v, value)
    ls["lg"] = torch.where(use_safe[:, None], safe_g, grad)
    S = _select(in_ls, ls, S)

    # a line search that ended makes the step: params + stepsize * u
    fin = in_ls & (done | failed)
    new_x = x + S["t"][:, None] * u
    # a step that changed nothing, after one that changed nothing, with every
    # memory weight zero, is a fixed point: every later step repeats it
    # exactly, so the lane skips them (applied to its state at the end)
    noop = (new_x == x).all(1) & (S["lv"] == S["value"]) & (S["lg"] == S["grad"]).all(1)
    fixed = noop & S["noop"] & torch.isfinite(S["lv"]) & (S["rho"] == 0.0).all(0)
    if not skip_fixed:
        fixed = torch.zeros_like(fixed)
    todo = S["todo"] - 1
    end = {
        "params": new_x, "value": S["lv"], "grad": S["lg"], "learning_rate": S["t"],
        "ls_steps": S["ls_count"], "todo": torch.where(fixed, 0, todo), "noop": noop,
        "skipped": S["skipped"] + torch.where(fixed, todo, 0),
    }
    S = _select(fin, end, S)
    # the first evaluation of a lane whose stored value is not finite
    S = _select(eval_only, {"value": value, "grad": grad}, S)
    S["evaluated"] = eval_only | (S["evaluated"] & ~start)
    S["in_ls"] = in_ls & ~fin
    S["evals"] = S["evals"] + (in_ls | eval_only).to(S["evals"].dtype)
    return S


def _run_state(params, state: LBFGSState, steps) -> dict:
    n_lanes = params.shape[0]
    dev = params.device
    S = {"params": params, **state._asdict()}
    S["todo"] = torch.as_tensor(steps, dtype=torch.int64, device=dev).expand(n_lanes).clone()
    S["in_ls"] = torch.zeros(n_lanes, dtype=torch.bool, device=dev)
    S["evaluated"] = torch.zeros_like(S["in_ls"])
    S["evals"] = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    S["noop"] = torch.zeros_like(S["in_ls"])
    S["skipped"] = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
    zl = torch.zeros_like(state.value)
    for k in _LS_FIELDS:
        if k in ("u", "lg", "safe_g"):
            S[k] = torch.zeros_like(params)
        elif k == "ls_count":
            S[k] = torch.zeros(n_lanes, dtype=torch.int64, device=dev)
        elif k == "found":
            S[k] = torch.zeros_like(S["in_ls"])
        else:
            S[k] = zl.clone()
    return S


class _GraphPass:
    """UNROLL passes captured into one CUDA graph over static state tensors
    (updated in place by each replay)."""

    def __init__(self, fun, S: dict, skip_fixed: bool):
        self.S = {k: v.clone() for k, v in S.items()}
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):      # warm-up on a throw-away copy
            _pass(fun, {k: v.clone() for k, v in self.S.items()}, skip_fixed)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            new = self.S
            for _ in range(UNROLL):
                new = _pass(fun, new, skip_fixed)
            for k, v in new.items():
                self.S[k].copy_(v)

    def replay(self):
        self.graph.replay()


def _skip(S: dict) -> dict:
    """Apply the steps a lane skipped at a fixed point: each would have
    pushed a zero pair into the memory and counted itself."""
    r = S["skipped"]
    m = S["rho"].shape[0]
    idx = torch.arange(m, device=r.device)[:, None] + r.clamp(max=m)[None, :]        # (M, L)
    keep = idx < m
    idx = idx.clamp(max=m - 1)
    out = dict(S, count=S["count"] + r, rho=torch.where(keep, S["rho"].gather(0, idx), 0.0))
    for k in ("s_mem", "y_mem"):
        g = S[k].gather(0, idx[..., None].expand(S[k].shape))
        out[k] = torch.where(keep[..., None], g, 0.0)
    return out


def run(fun: Callable, params: torch.Tensor, state: LBFGSState, steps, *, graph: bool | None = None,
        skip_fixed_points: bool = True, stats: dict | None = None):
    """Make ``steps`` L-BFGS steps in every lane (an int, or (L,) per lane).

    ``fun(params (L, P)) -> (value (L,), grad (L, P))``.  Returns (params,
    state).  ``graph``: capture the pass into a CUDA graph (default: on
    CUDA tensors).  ``stats``, if given, gains ``passes`` (evaluations of
    all lanes), ``evaluations`` (per lane, summed), ``steps`` (per lane,
    summed), ``syncs`` (host reads of the lanes' progress),
    ``skipped_steps`` and ``fixed_lanes`` (steps skipped at fixed points,
    and lanes that skipped) and, with a graph, ``capture_s`` (seconds to
    capture it).  ``skip_fixed_points=False`` makes every step (the same
    result, bit for bit)."""
    S = _run_state(params, state, steps)
    if graph is None:
        graph = params.is_cuda
    runner = None
    if graph:
        t0 = time.perf_counter()
        runner = _GraphPass(fun, S, skip_fixed_points)
        torch.cuda.synchronize()
        capture_s = time.perf_counter() - t0
    passes = syncs = 0
    while True:
        todo = S["todo"] if runner is None else runner.S["todo"]
        remaining = int(todo.max()) if todo.numel() else 0
        syncs += 1
        if remaining == 0:
            break
        if runner is None:
            for _ in range(remaining):
                S = _pass(fun, S, skip_fixed_points)
            passes += remaining
        else:
            reps = -(-remaining // UNROLL)
            for _ in range(reps):
                runner.replay()
            passes += reps * UNROLL
    if runner is not None:
        S = runner.S
    S = _skip(S)
    if stats is not None:
        stats["passes"] = stats.get("passes", 0) + passes
        stats["syncs"] = stats.get("syncs", 0) + syncs
        stats["evaluations"] = stats.get("evaluations", 0) + int(S["evals"].sum())
        stats["steps"] = stats.get("steps", 0) + int(torch.as_tensor(steps).expand(params.shape[0]).sum())
        stats["skipped_steps"] = stats.get("skipped_steps", 0) + int(S["skipped"].sum())
        stats["fixed_lanes"] = stats.get("fixed_lanes", 0) + int((S["skipped"] > 0).sum())
        if runner is not None:
            stats["capture_s"] = stats.get("capture_s", 0.0) + capture_s
    out = LBFGSState(**{k: S[k] for k in LBFGSState._fields})
    return S["params"], out
