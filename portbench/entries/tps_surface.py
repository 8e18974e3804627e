"""Entry of the TPS surface cells: a station network's responses through the
port's ``tps_fit_auto`` and ``tps_predict_grid`` (kernel K1 on the card).

Set-up draws a pool of station networks on the card from the seed (the
configuration's ``draws``) and keeps it in pinned host memory, where a
user's station table lives; each call copies its own network to the card,
fits every response at once and predicts every response's surface over the
configuration's grid.  Call i takes pool entry i and landmark seed i, so no
two calls of a run share inputs, and a run makes at most as many calls as
the pool holds (``state.capacity``).  The traffic's ``fit_args`` are
``tps_fit_auto``'s keywords; their ``method`` ("exact" or "nystrom") also
names the reference the outputs are compared with.  A reservoir drawn from the seed keeps the
outputs of ``sampled_calls`` calls (lambda, the fitted values, the spline
and ``sampled_rows`` whole grid rows of every surface); once the window
has closed each kept call is compared with the plain float64 reference
(``reference/tps_nystrom.py``) on the same inputs, by the numbers that
``gaps`` lists.  The cell's ``limits`` give each number of its route a
limit: a cell that leaves one out is refused at set-up.
"""
from __future__ import annotations

import contextlib
import math
import time
import types

import numpy as np
import torch

from portbench.reference import tps_exact
from portbench.reference import tps_nystrom as ref
from portbench.roofline import k1


def grid_dict(cfg: dict) -> dict:
    g = cfg["grid"]
    xmin, xmax, ymin, ymax = g["extent"]
    return {"nrows": g["nrows"], "ncols": g["ncols"], "xmin": xmin, "ymax": ymax,
            "dx": (xmax - xmin) / g["ncols"], "dy": (ymax - ymin) / g["nrows"]}


def draw_networks(cfg: dict, count: int, seed: int, device, chunk: int = 64):
    """``count`` station networks of the configuration, drawn on ``device``
    from ``seed`` in chunks: coordinates (count, n, 2) uniform over the
    extent and responses (count, n, R),
    ``sin((fx0 + fx1 j) x) cos((fy0 + fy1 j) y) + noise_sd N(0, 1)`` for
    response j, in float32, returned in pinned host memory where there is
    a card."""
    d = cfg["draws"]
    n, r = cfg["stations"], cfg["responses"]
    xmin, xmax, ymin, ymax = cfg["grid"]["extent"]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    pin = device.type == "cuda"
    coords = torch.empty((count, n, 2), dtype=torch.float32, pin_memory=pin)
    ys = torch.empty((count, n, r), dtype=torch.float32, pin_memory=pin)
    j = torch.arange(r, dtype=torch.float32, device=device)
    fx = d["freq_x"][0] + d["freq_x"][1] * j
    fy = d["freq_y"][0] + d["freq_y"][1] * j
    lo = torch.tensor([xmin, ymin], device=device)
    span = torch.tensor([xmax - xmin, ymax - ymin], device=device)
    for s in range(0, count, chunk):
        k = min(chunk, count - s)
        c = lo + span * torch.rand((k, n, 2), generator=gen, device=device)
        noise = torch.randn((k, n, r), generator=gen, device=device)
        y = torch.sin(fx * c[..., :1]) * torch.cos(fy * c[..., 1:]) + d["noise_sd"] * noise
        coords[s : s + k].copy_(c)
        ys[s : s + k].copy_(y)
    return coords, ys


def call_seeds(seed: int, count: int) -> list:
    """The landmark seed of each pool entry."""
    return [int(v) for v in np.random.SeedSequence([seed % (1 << 63), 1]).generate_state(count, np.uint64) >> 1]


def prepare(cell, seed: int, device):
    """Set-up: the pool of networks, the landmark seeds, the checked rows
    and the reservoir's draws from the seed, then ``warmup_calls`` calls."""
    from machisplin_tpu_torch.grid import GridSpec
    from machisplin_tpu_torch.ops import tps as port_tps

    cfg, tr = cell.config, cell.traffic
    t0 = time.perf_counter()
    st = types.SimpleNamespace(cfg=cfg, traffic=tr, device=device, seed=seed, tps=port_tps, counters={},
                               setup_parts={})
    warm = int(tr["warmup_calls"])
    pool = int(tr["pool"])
    st.coords, st.ys = draw_networks(cfg, pool + warm, seed, device)
    st.setup_parts["inputs"] = time.perf_counter() - t0
    st.seeds = call_seeds(seed, pool + warm)
    st.grid_d = grid_dict(cfg)
    st.grid = GridSpec(**st.grid_d)
    rng = np.random.default_rng([seed % (1 << 63), 2])
    chk = tr["check"]
    st.rows_idx = np.sort(rng.choice(st.grid.nrows, chk["sampled_rows"], replace=False))
    st.rows = torch.as_tensor(st.rows_idx, device=device)
    st.sample_rng = np.random.default_rng([seed % (1 << 63), 3])
    st.kept = {}
    st.fit_kw = dict(tr["fit_args"])
    st.route = st.fit_kw["method"]
    if st.route not in ("exact", "nystrom"):
        raise ValueError(f"fit_args' method must be 'exact' or 'nystrom', not {st.route!r}")
    st.capacity = pool
    st.limits = dict(cell.workload["limits"])
    if set(st.limits) != set(NUMBERS[st.route]):
        raise ValueError(f"the cell's limits name {sorted(st.limits)}; the {st.route} route compares "
                         f"{sorted(NUMBERS[st.route])}")
    nospan = contextlib.nullcontext
    for w in range(warm):
        t1 = time.perf_counter()
        _one(st, pool + w, nospan)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        st.setup_parts[f"warm-up call {w}"] = time.perf_counter() - t1
    return st


def _one(st, idx: int, span):
    dev = st.device
    coords = st.coords[idx].to(dev, non_blocking=True)
    ys = st.ys[idx].to(dev, non_blocking=True)
    with span("fit"):
        model = st.tps.tps_fit_auto(coords, ys, generator=torch.Generator().manual_seed(st.seeds[idx]),
                                    **st.fit_kw)
    with span("surface"):
        surf = st.tps.tps_predict_grid(model, st.grid)
        rows = surf[st.rows]
    return model, rows


def call(st, i: int, span) -> None:
    """Call i of the window, with K1's least time counted for the trace."""
    model, rows = _one(st, i, span)
    cells, knots, r = st.grid.ncell, int(model.knots.shape[0]), int(st.cfg["responses"])
    st.counters["k1_bound_s"] = st.counters.get("k1_bound_s", 0.0) + k1.bound(cells, knots, r)[0]
    # a reservoir of sampled_calls calls' outputs, drawn from the seed
    k = int(st.traffic["check"]["sampled_calls"])
    slot = i if i < k else int(st.sample_rng.integers(0, i + 1))
    if slot < k:
        st.kept[slot] = (i, {"lam": model.lam, "fitted": model.fitted, "rows": rows, "z": model.knots,
                             "c": model.c, "d": model.d, "shift": model.shift, "scale": model.scale})


def release(st) -> None:
    """Move the kept outputs to the host and free the port's device state."""
    st.kept = {s: (i, {k: v.cpu() for k, v in out.items()}) for s, (i, out) in st.kept.items()}
    st.rows = None
    if st.device.type == "cuda":
        torch.cuda.synchronize(st.device)
        torch.cuda.empty_cache()


def _inputs(st, i: int):
    dev = st.device
    n, m = st.cfg["stations"], st.cfg["fit"]["landmarks"]
    init = torch.randperm(n, generator=torch.Generator().manual_seed(st.seeds[i]))[:m]
    return st.coords[i].to(dev).double(), st.ys[i].to(dev).double(), init.to(dev)


def control_outputs(st, i: int) -> dict:
    """The reference one precision step below the configuration's
    (``reference.tps_nystrom.Precision("control")``), in the port's place."""
    prec = ref.Precision("control")
    coords, ys, init = _inputs(st, i)
    if st.route == "exact":
        sp = tps_exact.fit(coords, ys, prec)
    else:
        sp = ref.fit(coords, ys, init, st.cfg["fit"]["kmeans_iters"], prec)
    sp["rows"] = ref.surface_rows(sp, st.grid_d, st.rows_idx, prec)
    return sp


def _sse(coords, spline):
    """The k-means objective of a spline's knots over the stations, in the
    reference's scaled coordinates (float64)."""
    xs = (coords - coords.amin(0)) / (coords.amax(0) - coords.amin(0))
    z = (spline["z"] * spline["scale"] + spline["shift"] - coords.amin(0)) / (coords.amax(0) - coords.amin(0))
    return torch.cat([ref._r2(xs[s : s + 8192], z).amin(1) for s in range(0, xs.shape[0], 8192)]).sum()


# the numbers each route compares; ``knots_gap`` is exact (limit 0) and not
# listed in a cell's limits
NUMBERS = {"exact": ("knots_pos_gap", "gcv_excess", "fit_gap", "surface_gap", "fitted_eval_gap", "k1_gap"),
           "nystrom": ("knots_sse_excess", "gcv_excess", "solve_error", "fit_gap", "surface_gap",
                       "fitted_eval_gap", "k1_gap")}


def gaps(st, i: int, out: dict) -> dict:
    """The compared numbers of call i's outputs ``out`` (lam, fitted, rows of
    the sampled grid rows, and the spline: z, c, d, shift, scale).

    Against the reference's own fit of the call's inputs (Nystrom or exact,
    as the traffic's ``fit_args`` name the ``method``): ``fit_gap`` and ``surface_gap``, the widest
    gap of a fitted value and of a surface cell, as a share of the
    response's range, and ``gcv_excess``, GCV at the port's lambda over
    GCV's least value, less 1 (Nystrom: with the port's landmarks).
    Following the port's state stage by stage, each stage checked alone:
    the knots (Nystrom: ``knots_sse_excess``, the k-means objective of the
    port's landmarks over the reference's, less 1, absolute; exact:
    ``knots_pos_gap``, the widest gap of a knot from its scaled station);
    ``solve_error`` (Nystrom), the backward error of the port's
    coefficients in the reference's system at the port's lambda and knots;
    ``fitted_eval_gap`` and ``k1_gap``, the widest gap of the port's fitted
    values and of its surface cells (K1) from its own spline evaluated in
    float64, as a share of the response's range; ``knots_gap``, the knot
    count against the route's."""
    coords, ys, init = _inputs(st, i)
    rng = ys.amax(0) - ys.amin(0)
    o = {k: v.to(coords.device).double() for k, v in out.items() if isinstance(v, torch.Tensor)}
    lam = o["lam"]
    res = {}
    if st.route == "exact":
        indep = tps_exact.fit(coords, ys)
        gv, n = indep["gcv"], coords.shape[0]
        res["gcv_excess"] = (gv(lam * n) / gv(indep["lam"] * n) - 1.0).max()
        if o["z"].shape[0] == indep["z"].shape[0]:
            res["knots_pos_gap"] = (o["z"] - indep["z"]).abs().max()
        else:
            res["knots_pos_gap"] = torch.tensor(math.inf)
    else:
        indep = ref.fit(coords, ys, init, st.cfg["fit"]["kmeans_iters"])
        follow = ref.fit(coords, ys, knots=o["z"] * o["scale"] + o["shift"])
        gv = follow["gcv"]
        res["gcv_excess"] = (gv(lam) / gv(follow["lam"]) - 1.0).max()
        res["solve_error"] = follow["backward_error"](lam, torch.cat([o["d"], o["c"]])).max()
        res["knots_sse_excess"] = (_sse(coords, o) / _sse(coords, indep) - 1.0).abs()
    res["fit_gap"] = ((o["fitted"] - indep["fitted"]).abs().amax(0) / rng).max()
    res["surface_gap"] = ((o["rows"] - ref.surface_rows(indep, st.grid_d, st.rows_idx)).abs().amax((0, 1)) / rng).max()
    res["fitted_eval_gap"] = ((o["fitted"] - ref.evaluate(o, coords)).abs().amax(0) / rng).max()
    res["k1_gap"] = ((o["rows"] - ref.surface_rows(o, st.grid_d, st.rows_idx)).abs().amax((0, 1)) / rng).max()
    knots = st.cfg["stations"] if st.route == "exact" else st.cfg["fit"]["landmarks"]
    res["knots_gap"] = torch.tensor(float(abs(o["z"].shape[0] - knots)))
    return {k: (float(v) if math.isfinite(float(v)) else math.inf) for k, v in res.items()}


def judge(st) -> list:
    """Each compared number over the kept calls (its worst) beside its
    limit (the cell's ``limits``; ``knots_gap``, the knot count against the
    route's, is exact)."""
    limits = {**st.limits, "knots_gap": 0.0}
    per_call = [gaps(st, i, out) for _, (i, out) in sorted(st.kept.items())]
    run = {k: max(g[k] for g in per_call) for k in per_call[0]} if per_call else {}
    return [(k, run.get(k, math.inf), float(lim)) for k, lim in limits.items()]
