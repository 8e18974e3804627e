"""mltps — the end-to-end ensemble + thin-plate-spline downscaling pipeline.

Counterpart of ``machisplin_tpu/pipeline/mltps.py`` (the reference's
``machisplin.mltps``, V73:114-968):

part 0  LONG/LAT bands appended to the covariate stack, stack values taken at
        the stations, NA rows dropped (V73:123-195);
part 1  10-fold CV of the algorithm pool and the 0-1 weight search with the
        rounded-weight > 5 % keep rule (V73:204-429);
part 2  final fits of the kept algorithms on all rows, weighted raster
        prediction streamed over the grid in row blocks, weighted station
        residuals, variable importance (V73:430-631);
part 3  thin-plate spline of the ensemble residuals on 1500-px tiles with
        +-20 % fit / +-2.5 % mosaic overlaps, <10-point tiles as zero
        surfaces (V73:636-753), all tiles solved in one batched masked
        factorisation and predicted by the TPS grid kernel (K1);
part 4  linear-ramp feathering of the tile seams (V73:756-896);
part 5  final = ensemble + error surface, station R^2, and the keep-the-
        correction-only-if-R^2-improves rule (V73:898-965).

All six letters are ported: BRT (``b``: gbm.step on kernel K2, batched over
responses or serial for one, and a merged-forest raster pass on kernel K3), GAM (``g``), NN (``n``: the batched
L-BFGS of ``models/nn.py``), MARS (``m``), RF (``r``: level-wise trees, and
the same merged-forest raster pass on K3) and SVM (``v``: the coordinate
sweep on kernel K4).
"""
from __future__ import annotations

import dataclasses
import logging
from typing import Any

import numpy as np
import torch

from ..ensemble.cv import CVConfig, residual_matrix, run_cv
from ..ensemble.weights import WeightResult, optimize_weights_lbfgsb, optimize_weights_sweep
from ..grid import GridSpec, Raster, crop, extract, lonlat_rasters, stack
from ..models import gam, gbm_step, mars, nn, rf, svm
from ..models.base import LETTER_TO_NAME
from ..models.trees import Tree
from ..ops.feather import feather_blend
from ..ops.forest import build_leaf_bins, predict_prepared, prepare_forest
from ..ops.tps import TPSModel, tps_fit, tps_predict_grid
from ..parallel.tiles import batched_tile_solve, pack_tiles
from ..utils import resolve_device
from ..utils.timing import PhaseTimer
from .importance import breakdown_importance

log = logging.getLogger("machisplin_tpu_torch")

SMOOTH_LETTERS = "gnmv"  # BRT and RF excluded under smooth.outputs.only (V73:366-393)


@dataclasses.dataclass(frozen=True)
class MLTPSConfig:
    """Pipeline hyperparameters; defaults mirror the reference call sites."""

    cv: CVConfig = dataclasses.field(default_factory=CVConfig)
    final_brt: dict = dataclasses.field(
        default_factory=lambda: dict(
            tree_complexity=5, learning_rate=0.001, bag_fraction=0.5,
            step_size=50, max_trees=10000,
        )
    )
    final_rf: dict = dataclasses.field(default_factory=lambda: dict(ntree=500))
    final_nn: dict = dataclasses.field(default_factory=lambda: dict(hidden=10, maxit=10000))
    final_mars: dict = dataclasses.field(default_factory=dict)
    final_svm: dict = dataclasses.field(default_factory=dict)
    final_gam: dict = dataclasses.field(default_factory=dict)
    tps_tile_px: int = 1500          # V73:656-660
    tps_fit_overlap: float = 0.2     # V73:673
    tps_mosaic_overlap: float = 0.025  # V73:680
    min_tile_points: int = 10        # V73:710
    # all live tiles in batched masked solves; False fits each tile alone
    # (tps_fit on its stations) and predicts it with one K1 launch
    tps_batch_tiles: bool = True
    tps_tile_chunk: int = 16         # tiles factorised per batched solve
    # "lbfgsb" (the reference's search) or "sweep" (the batched candidate
    # sweep, on the device)
    weight_optimizer: str = "lbfgsb"
    # batch gbm.step final fits across responses (fit_multi); False, or a
    # single response, takes the serial gbm.step (gbm_step.fit) per response
    batch_final_brt: bool = True
    # merge the RF finals of all responses into one raster pass; False fits,
    # predicts and rates each response's forest alone (a raster pass each)
    batch_final_rf: bool = True
    letters_pool: str | None = None  # restrict the algorithm pool (extension)
    predict_block_rows: int = 256
    svm_importance_sample: int = 200  # V73:564


@dataclasses.dataclass
class LayerResult:
    """Per-response output, the reference's omega[[i]] contract (V73:955)."""

    name: str
    final: Raster
    residuals: np.ndarray           # (n, 3) residual, long, lat (V73:627/914)
    var_imp: dict[str, Any]
    summary: dict[str, Any]
    n_layers: int
    ensemble: Raster | None = None  # pre-correction ensemble surface
    tps_surface: Raster | None = None
    weights: WeightResult | None = None


def predict_over_stack(predict_fn, rast_stack: Raster, block_rows: int = 256, out_cols: int | None = None):
    """Stream model prediction over the grid in row blocks -> (H, W), or
    (H, W, R) when ``predict_fn`` returns (m, R) (``out_cols`` = R).

    Replaces terra::predict(rast_stack, model) (V73:468/497/521/543/582/604).
    Cells with any NaN covariate predict NaN."""
    c, h, w = rast_stack.data.shape
    data = rast_stack.data
    nan = torch.full((), float("nan"), dtype=data.dtype, device=data.device)
    rows = []
    for r0 in range(0, h, block_rows):
        blk = data[:, r0 : r0 + block_rows, :]
        x = blk.movedim(0, -1).reshape(-1, c)
        ok = torch.isfinite(x).all(dim=1)
        pred = predict_fn(torch.where(ok[:, None], x, torch.zeros((), dtype=x.dtype, device=x.device)))
        pred = torch.where(ok[:, None] if out_cols is not None else ok, pred, nan)
        shape = (blk.shape[1], w) if out_cols is None else (blk.shape[1], w, out_cols)
        rows.append(pred.reshape(shape))
    return torch.cat(rows, dim=0)


def _prepare_inputs(int_values, covar_ras: Raster):
    """Part 0: stack assembly + station extraction (V73:123-195)."""
    arr = np.asarray(int_values)
    if not arr.dtype.names:
        raise ValueError(
            "int_values must be a structured array with named columns (long, lat, <responses...>)"
        )
    names = list(arr.dtype.names)
    cols = np.stack([arr[n] for n in names], axis=1).astype(np.float64)
    if names[0].lower() not in ("long", "lon", "x") or names[1].lower() not in ("lat", "y"):
        log.warning("first two columns expected to be long, lat; got %s", names[:2])
    resp_names = names[2:]
    g = covar_ras.grid
    rast_stack = stack([covar_ras, lonlat_rasters(g, covar_ras.data.dtype, covar_ras.data.device)])
    vals = extract(rast_stack, cols[:, 0], cols[:, 1]).cpu().numpy().astype(np.float64)  # (n, C+2)
    full = np.concatenate([cols, vals], axis=1)
    keep = np.all(np.isfinite(full), axis=1)
    if keep.mean() < 0.75:
        log.warning(
            "Warning! %d points fell outside of input co-variate rasters (of %d total input). "
            "Consider using co-variates that match the full extent of the input data",
            int((~keep).sum()), len(keep),
        )
    full = full[keep]
    x = full[:, len(names):]                 # station covariates (incl LONG, LAT)
    responses = {rn: full[:, 2 + i] for i, rn in enumerate(resp_names)}
    return rast_stack, list(rast_stack.names), full[:, :2], x, responses


def _fit_final_batched(letter, x, ycols, names, config: MLTPSConfig, generator=None, nn_init=None,
                       svm_pairs=None):
    """Final-fit one algorithm for SEVERAL responses (ycols (n, R)) in one
    batched call.  Returns (predict_fn (m, p) -> (m, R), [importance dicts]).
    The NN's initial weights are drawn from ``generator``, or injected as
    ``nn_init`` (w1, b1, w2, b2) with a leading response axis; likewise the
    SVM's sigest pairs, ``svm_pairs`` (i, j) each (R, m)."""
    n_resp = ycols.shape[1]
    y_b = ycols.T.contiguous()
    if letter == "n":
        # the reference's response min-shift/max-scale (V73:454-459), per column
        y_min = ycols.amin(0)
        y_max = (ycols - y_min[None, :]).amax(0).clamp_min(1e-30)
        yn = (ycols - y_min[None, :]) / y_max[None, :]
        states = nn.fit(x, yn.T.contiguous(), init=nn_init, generator=generator, **config.final_nn)
        fn = lambda q: nn.predict(states, q).T * y_max[None, :] + y_min[None, :]
        imps = [nn.importance(nn.NNState(*(a[j] for a in states)), names) for j in range(n_resp)]
        return fn, imps
    if letter == "g":
        states = gam.fit(x, y_b, **config.final_gam)
        fn = lambda q: gam.predict(states, q).T
        imps = [gam.importance(gam.lane(states, j), names) for j in range(n_resp)]
        return fn, imps
    if letter == "m":
        states = mars.fit(x, y_b, **config.final_mars)
        fn = lambda q: mars.predict(states, q).T
        imps = [
            mars.importance(mars.MARSState(*(a[j] for a in states)), x, ycols[:, j], names)
            for j in range(n_resp)
        ]
        return fn, imps
    if letter == "v":
        states = svm.fit(x, y_b, pairs=svm_pairs, generator=generator, **config.final_svm)
        fn = lambda q: svm.predict(states, q).T
        imps = [
            breakdown_importance(lambda q, s=svm.lane(states, j): svm.predict(s, q), x, names,
                                 n_sample=config.svm_importance_sample, seed=1313)
            for j in range(n_resp)
        ]
        return fn, imps
    raise ValueError(letter)


def _forest_tables(trees: Tree, n_feat: int):
    """Bin-interval leaf tables of a forest (``ops.forest.build_leaf_bins``,
    a host walk of the trees).  The port has no host tree predictor, so its
    raster passes always take the forest predictor: K3 on the card, the
    plain version on the CPU."""
    return build_leaf_bins(Tree(*(a.cpu() for a in trees)), n_feat=n_feat)


def _final_brt(x, ycols, names, rast_stack: Raster, config: MLTPSConfig, generator, timer):
    """BRT final fits for one or more responses (ycols (n, R)): batched
    gbm.step (``fit_multi``) for several responses with
    ``batch_final_brt``, else the serial gbm.step (``fit``) per response
    (V73:447/493); then ONE raster pass of all responses' forests merged
    into one leaf table with an (T_total, R) weight matrix that zeroes
    foreign trees (V73:497).  Each forest is trimmed to its best.trees
    prefix first: later trees carry zero weight.  Station predictions are
    the refits' own training fits.  Returns (surfaces (H, W, R), station
    predictions (n, R), [importance dicts])."""
    n_resp = ycols.shape[1]
    with timer.phase(f"final_fit_b_x{n_resp}"):
        if n_resp > 1 and config.batch_final_brt:
            results = gbm_step.fit_multi(x, ycols, generator=generator, **config.final_brt)
        else:
            results = [gbm_step.fit(x, ycols[:, j], generator=generator, **config.final_brt) for j in range(n_resp)]
    with timer.phase("importance_b"):
        imps = [gbm_step.importance(r, names) for r in results]
    nts = [max(int(r.best_trees), 1) for r in results]
    merged = Tree(*(
        torch.cat([a[:nt] for a, nt in zip(arrs, nts)], dim=0)
        for arrs in zip(*[r.final.trees for r in results])
    ))
    wmat = torch.zeros((sum(nts), n_resp), dtype=torch.float32, device=x.device)
    off = 0
    for j, (nt, r) in enumerate(zip(nts, results)):
        wmat[off : off + nt, j] = r.final.tree_active[:nt].to(torch.float32) * float(r.final.lr)
        off += nt
    f0s = torch.as_tensor([float(r.final.f0) for r in results], dtype=torch.float32, device=x.device)
    with timer.phase("forest_tables_b"):
        ftab = prepare_forest(merged, wmat, _forest_tables(merged, x.shape[1]), x.device)
    bfn = lambda q: (predict_prepared(ftab, q) + f0s[None, :]).to(q.dtype)
    with timer.phase(f"raster_predict_b_x{n_resp}"):
        bsurf = predict_over_stack(bfn, rast_stack, config.predict_block_rows, out_cols=n_resp)
    bpt = torch.stack([r.final.train_fit for r in results], dim=1).to(x.dtype)
    return bsurf, bpt, imps


def _final_rf_batched(x, ycols, names, rast_stack: Raster, config: MLTPSConfig, generator, timer, rf_draws=None):
    """RF final fits for one or more responses (ycols (n, R)): every
    response's forest grows in one batched call, then ONE raster pass of all
    forests merged into one leaf table with a (T_total, R) weight matrix of
    1/T on each response's own trees (V73:517/521).  Station predictions
    come through the same merged call.  ``rf_draws`` injects (bootstrap
    counts (R, ntree, n), node scores (R, ntree, 2^max_depth - 1, p)).
    Returns (surfaces (H, W, R), station predictions (n, R), [importance
    dicts])."""
    n_resp = ycols.shape[1]
    counts, scores = rf_draws if rf_draws is not None else (None, None)
    with timer.phase(f"final_fit_r_x{n_resp}"):
        states = rf.fit(x, ycols.T.contiguous(), boot_counts=counts, scores=scores, generator=generator,
                        **config.final_rf)
    with timer.phase("importance_r"):
        imps = [rf.importance(rf.lane(states, j), x, ycols[:, j], names) for j in range(n_resp)]
    ntree = states.trees.feat.shape[1]
    merged = Tree(*(a.reshape((n_resp * ntree,) + a.shape[2:]) for a in states.trees))
    wmat = torch.kron(torch.eye(n_resp), torch.full((ntree, 1), 1.0 / ntree)).to(x.device)
    with timer.phase("forest_tables_r"):
        ftab = prepare_forest(merged, wmat, _forest_tables(merged, x.shape[1]), x.device)
    rfn = lambda q: predict_prepared(ftab, q).to(q.dtype)
    with timer.phase(f"raster_predict_r_x{n_resp}"):
        rsurf = predict_over_stack(rfn, rast_stack, config.predict_block_rows, out_cols=n_resp)
    return rsurf, rfn(x), imps


def _final_rf_serial(x, ycols, names, rast_stack: Raster, config: MLTPSConfig, generator, timer, rf_draws=None):
    """RF final fits one response at a time (``batch_final_rf=False``, the
    JAX package's per-response loop): each forest is grown, rated and
    predicted over the raster alone, one forest-predictor stream per
    response.  ``rf_draws`` as ``_final_rf_batched``'s; without it the
    draws are made as that path makes them, so both grow the same forests.
    Returns (surfaces (H, W, R), station predictions (n, R), [importance
    dicts])."""
    n_resp = ycols.shape[1]
    if rf_draws is None:
        rf_draws = rf.draw(torch.ones((n_resp, x.shape[0])), x.shape[1], generator=generator, **config.final_rf)
    counts, scores = rf_draws
    surfs, pts, imps = [], [], []
    for j in range(n_resp):
        with timer.phase(f"final_fit_r_{j}"):
            state = rf.fit(x, ycols[:, j], boot_counts=counts[j], scores=None if scores is None else scores[j],
                           **config.final_rf)
        with timer.phase(f"importance_r_{j}"):
            imps.append(rf.importance(state, x, ycols[:, j], names))
        ntree = state.trees.feat.shape[0]
        wvec = torch.full((ntree, 1), 1.0 / ntree, device=x.device)
        with timer.phase(f"forest_tables_r_{j}"):
            ftab = prepare_forest(state.trees, wvec, _forest_tables(state.trees, x.shape[1]), x.device)
        rfn = lambda q, ft=ftab: predict_prepared(ft, q).to(q.dtype)
        with timer.phase(f"raster_predict_r_{j}"):
            surfs.append(predict_over_stack(rfn, rast_stack, config.predict_block_rows, out_cols=1))
        pts.append(rfn(x))
    return torch.cat(surfs, dim=-1), torch.cat(pts, dim=1), imps


def _tps_tiles(grid: GridSpec, config: MLTPSConfig):
    """The reference's auto-tiling plan: fit extents (+-20%) and mosaic
    extents (+-2.5%) for ceil(n/1500)-per-axis blocks, row-major from the
    bottom-left (V73:650-681)."""
    n_rx = -(-grid.nrows // config.tps_tile_px)
    n_cx = -(-grid.ncols // config.tps_tile_px)
    xmin, xmax, ymin, ymax = grid.extent
    long_d = (xmax - xmin) / n_cx
    lat_d = (ymax - ymin) / n_rx
    fo, mo = config.tps_fit_overlap, config.tps_mosaic_overlap
    fit_exts, mosaic_exts = [], []
    for j in range(1, n_rx + 1):
        for h in range(1, n_cx + 1):
            fit_exts.append((
                xmin + long_d * (h - 1) - long_d * fo,
                xmin + long_d * h + long_d * fo,
                ymin + lat_d * (j - 1) - lat_d * fo,
                ymin + lat_d * j + lat_d * fo,
            ))
            mosaic_exts.append((
                xmin + long_d * (h - 1) - long_d * mo,
                xmin + long_d * h + long_d * mo,
                ymin + lat_d * (j - 1) - lat_d * mo,
                ymin + lat_d * j + lat_d * mo,
            ))
    return n_rx, n_cx, fit_exts, mosaic_exts


def _tps_error_surface(coords, res_mat, rast_stack: Raster, config: MLTPSConfig):
    """Parts 3+4: tiled TPS of the residuals, feathered into one surface.

    ``res_mat`` is (n, R): every response solves through one factorisation
    per tile (the station coordinates are shared).  Returns (a Raster with
    data (R, H, W), the tile count)."""
    grid = rast_stack.grid
    n_rx, n_cx, fit_exts, mosaic_exts = _tps_tiles(grid, config)
    n_tiles = n_rx * n_cx
    dtype, dev = rast_stack.data.dtype, rast_stack.data.device
    res_mat = np.asarray(res_mat)

    if n_tiles == 1:
        model = tps_fit(
            torch.as_tensor(coords, dtype=dtype, device=dev), torch.as_tensor(res_mat, dtype=dtype, device=dev)
        )
        surf = tps_predict_grid(model, grid).to(dtype)
        return Raster(surf.movedim(-1, 0), grid), n_tiles

    first_layer = rast_stack.band(0)
    crops = [crop(first_layer, fit_exts[h]) for h in range(n_tiles)]
    # stations inside the fit extent with a valid first covariate (V73:701-706)
    sels = [torch.isfinite(extract(rb, coords[:, 0], coords[:, 1])).cpu().numpy() for rb in crops]
    if config.tps_batch_tiles:
        surfs = _batched_tile_surfaces(coords, res_mat, crops, sels, config, dtype, dev)
    else:
        surfs = _serial_tile_surfaces(coords, res_mat, crops, sels, config, dtype, dev)
    tiles = [crop(s, mosaic_exts[h]) for h, s in enumerate(surfs)]
    return feather_blend(tiles, n_rx, n_cx, grid), n_tiles


def _serial_tile_surfaces(coords, res_mat, crops, sels, config, dtype, dev):
    """The reference's tile loop (V73:690-738): each tile with at least
    ``min_tile_points`` stations fitted alone (``tps_fit`` on its stations)
    and predicted over its fit extent (one K1 launch on the card), the rest
    zero surfaces.  Each Raster carries (R, rows, cols)."""
    surfs = []
    for h, (rb, sel) in enumerate(zip(crops, sels)):
        if int(sel.sum()) < config.min_tile_points:
            log.info("tile %d: %d points -> zero surface", h + 1, int(sel.sum()))
            surfs.append(Raster(torch.zeros((res_mat.shape[1],) + rb.grid.shape, dtype=dtype, device=dev), rb.grid))
            continue
        model = tps_fit(torch.as_tensor(coords[sel], dtype=dtype, device=dev),
                        torch.as_tensor(res_mat[sel], dtype=dtype, device=dev))
        surf = tps_predict_grid(model, rb.grid, block_rows=config.predict_block_rows)
        surfs.append(Raster(surf.to(dtype).movedim(-1, 0), rb.grid))
    return surfs


def _batched_tile_surfaces(coords, res_mat, crops, sels, config, dtype, dev):
    """All live TPS tiles as batched masked factorisations (one knot budget)
    and one grid prediction per tile; tiles below the <10-point threshold
    become zero surfaces (V73:710-721).  Each Raster carries (R, rows, cols)."""
    n_resp = res_mat.shape[1]
    n_tiles = len(crops)
    live = [h for h in range(n_tiles) if int(sels[h].sum()) >= config.min_tile_points]
    surfs: list = [None] * n_tiles
    for h in range(n_tiles):
        if h not in live:
            log.info("tile %d: %d points -> zero surface", h + 1, int(sels[h].sum()))
            surfs[h] = Raster(torch.zeros((n_resp,) + crops[h].grid.shape, dtype=dtype, device=dev), crops[h].grid)
    if not live:
        return surfs
    budget = -(-max(int(sels[h].sum()) for h in live) // 64) * 64
    ct, yt, mt_ = pack_tiles(
        [coords[sels[h]] for h in live], [res_mat[sels[h]] for h in live],
        pad_to=budget, dtype=dtype, device=dev,
    )
    chunk = max(config.tps_tile_chunk, 1)
    models = [
        batched_tile_solve(ct[s : s + chunk], yt[s : s + chunk], mt_[s : s + chunk])
        for s in range(0, len(live), chunk)
    ]
    for i, h in enumerate(live):
        model_i = TPSModel(*(a[i % chunk] for a in models[i // chunk]))
        g = crops[h].grid
        surf = tps_predict_grid(model_i, g, block_rows=config.predict_block_rows)
        surfs[h] = Raster(surf.to(dtype).movedim(-1, 0), g)
    return surfs


def mltps(
    int_values,
    covar_ras: Raster,
    tps: bool = True,
    smooth_outputs_only: bool = False,
    trouble: bool = False,
    *,
    config: MLTPSConfig | None = None,
    folds=None,
    generator: torch.Generator | None = None,
    device="cuda",
    log_file: str | None = None,
    timer: PhaseTimer | None = None,
) -> list[LayerResult]:
    """Main entry point; see the module docstring.

    ``folds``: optional (R, n) CV fold ids in [0, k) for the n stations left
    after the NA drop; without them folds are drawn from ``generator``,
    which also seeds gbm.step's fold selectors and bag draws, the NN's
    initial weights, the SVM's sigest pairs and the RF's bootstrap rows and
    node feature draws.
    ``trouble``: the reference's BRT-only switch — every response keeps
    "b" at weight 1 whatever the weight search finds (V73:446).
    ``device``: where the run happens (``"cuda"`` raises without a GPU).
    ``log_file`` tees the run's progress to a log file (the reference's
    MachiSplin.LOG.txt sink, V73:200); ``timer`` collects per-phase
    durations."""
    if log_file is not None:
        from ..utils.logging import run_log

        with run_log(log_file):
            return mltps(int_values, covar_ras, tps, smooth_outputs_only, trouble, config=config, folds=folds,
                         generator=generator, device=device, timer=timer)
    dev = resolve_device(device)
    timer = timer or PhaseTimer()
    config = config or MLTPSConfig()
    letters_pool = SMOOTH_LETTERS if smooth_outputs_only else "bgnmrv"
    if config.letters_pool is not None:
        letters_pool = "".join(l for l in letters_pool if l in config.letters_pool)
        if not letters_pool:
            raise ValueError(f"letters_pool {config.letters_pool!r} excludes every algorithm")
    if trouble and "b" not in letters_pool:
        raise ValueError("trouble=True fits BRT alone: the algorithm pool must include 'b'")
    if config.weight_optimizer not in ("lbfgsb", "sweep"):
        raise ValueError(f"weight_optimizer must be 'lbfgsb' or 'sweep', got {config.weight_optimizer!r}")

    with timer.phase("input_prep"):
        rast_stack, covar_names, coords, x_np, responses = _prepare_inputs(
            int_values, covar_ras.to(dev)
        )
    dtype = rast_stack.data.dtype
    x = torch.as_tensor(x_np, dtype=dtype, device=dev)
    resp_names = list(responses)
    n_resp = len(resp_names)
    ys_all = np.stack([responses[rn] for rn in resp_names], axis=1)

    # part 1 for all responses at once: every (response, fold) model of a
    # letter trains in one batched call
    log.info("=== part 1 — CV of %s over %d response(s) ===", letters_pool, n_resp)
    with timer.phase("cv_all_responses"):
        cv_all = run_cv(
            x, torch.as_tensor(ys_all, dtype=dtype, device=dev), config=config.cv,
            algorithms=letters_pool, folds=folds, generator=generator, timer=timer,
        )

    wres_all, kept_all = [], []
    with timer.phase("ensemble_weights"):
        for i, name in enumerate(resp_names):
            rmat = residual_matrix({l: r[i] for l, r in cv_all.items()}, letters_pool)
            if config.weight_optimizer == "sweep":
                wres = optimize_weights_sweep(torch.as_tensor(rmat, device=dev), letters_pool)
            else:
                wres = optimize_weights_lbfgsb(rmat, letters_pool)
            # trouble: the reference's BRT-only switch keeps b at weight 1
            mods_run = "b" if trouble else wres.letters
            kept = {"b": 1.0} if trouble else dict(zip(wres.letters, wres.kept_weights))
            log.info("layer %s kept: %s weights %s (%s%%)", name, mods_run, wres.kept_weights, wres.percent_text)
            wres_all.append(wres)
            kept_all.append((mods_run, kept))

    # part 2 — final fits, letter-major and batched across the responses
    # that keep the letter; each letter's surfaces go straight into
    # per-response weighted accumulators
    ys_dev = {i: torch.as_tensor(responses[resp_names[i]], dtype=dtype, device=dev) for i in range(n_resp)}
    pred_accs: list = [None] * n_resp
    res_accs: list = [None] * n_resp
    var_imps: list[dict[str, Any]] = [dict() for _ in range(n_resp)]
    log.info("=== part 2 — final fits of %s ===", letters_pool)
    for letter in letters_pool:
        sel = [i for i, (_, kept) in enumerate(kept_all) if letter in kept]
        if not sel:
            continue
        ycols = torch.as_tensor(np.stack([responses[resp_names[i]] for i in sel], axis=1), dtype=dtype, device=dev)
        if letter == "b":
            bsurf, bpt, imps = _final_brt(x, ycols, covar_names, rast_stack, config, generator, timer)
        elif letter == "r":
            final_rf = _final_rf_batched if config.batch_final_rf else _final_rf_serial
            bsurf, bpt, imps = final_rf(x, ycols, covar_names, rast_stack, config, generator, timer)
        else:
            with timer.phase(f"final_fit_{letter}_x{len(sel)}"):
                bfn, imps = _fit_final_batched(letter, x, ycols, covar_names, config, generator)
            with timer.phase(f"raster_predict_{letter}_x{len(sel)}"):
                bsurf = predict_over_stack(bfn, rast_stack, config.predict_block_rows, out_cols=len(sel))
            bpt = bfn(x)
        for j, i in enumerate(sel):
            wgt = float(kept_all[i][1][letter])
            var_imps[i][letter] = imps[j]
            contrib = (ys_dev[i] - bpt[:, j]) * wgt
            surf = bsurf[..., j] * wgt
            pred_accs[i] = surf if pred_accs[i] is None else pred_accs[i] + surf
            res_accs[i] = contrib if res_accs[i] is None else res_accs[i] + contrib
        del bsurf

    ens_rasters, res_finals = [], []
    for i, name in enumerate(resp_names):
        total = wres_all[i].weight_total if not trouble else 1.0
        ens_rasters.append(Raster(pred_accs[i] / total, rast_stack.grid, (name,)))  # V73:619 quirk
        res_finals.append(res_accs[i].cpu().numpy().astype(np.float64) / total)    # V73:620
        pred_accs[i] = None

    tps_multi = None
    if tps:
        log.info("=== part 3/4 — TPS error surfaces (all responses) ===")
        with timer.phase(f"tps_x{n_resp}"):
            tps_multi, n_tiles = _tps_error_surface(coords, np.stack(res_finals, axis=1), rast_stack, config)
        log.info("TPS tiled across %d tile(s)", n_tiles)

    results = []
    with timer.phase("finalize"):
        for i, name in enumerate(resp_names):
            y_np = responses[name]
            wres = wres_all[i]
            mods_run, kept = kept_all[i]
            var_imp = {LETTER_TO_NAME[l]: var_imps[i][l] for l in kept}
            res_final = res_finals[i]
            ens_raster = ens_rasters[i]
            tss = float(np.sum((y_np - y_np.mean()) ** 2))
            rsq_model = 1.0 - float(np.sum(res_final**2)) / tss
            residuals_out = np.stack([res_final, coords[:, 0], coords[:, 1]], axis=1)
            summary = {
                "layer": name,
                "best model(s):": mods_run,
                "ensemble weights:": wres.percent_text,
                "r2 ensemble:": rsq_model,
            }
            final_raster, tps_raster = ens_raster, None
            if tps:
                tps_raster = Raster(tps_multi.data[i], rast_stack.grid, (name,))
                final_c = Raster(ens_raster.data + tps_raster.data, rast_stack.grid, (name,))
                f_at = extract(final_c, coords[:, 0], coords[:, 1]).cpu().numpy().astype(np.float64)
                rsq_final = 1.0 - float(np.nansum((y_np - f_at) ** 2)) / tss
                summary["r2 final:"] = rsq_final
                # the reference overwrites $residuals from the summed raster
                # UNCONDITIONALLY inside the tps==TRUE block (V73:914)
                residuals_out = np.stack([y_np - f_at, coords[:, 0], coords[:, 1]], axis=1)
                # keep the correction only if it improves R^2 (V73:925-930)
                if rsq_final > rsq_model:
                    final_raster = final_c
            results.append(LayerResult(
                name=name, final=final_raster, residuals=residuals_out, var_imp=var_imp,
                summary=summary, n_layers=n_resp, ensemble=ens_raster,
                tps_surface=tps_raster, weights=wres,
            ))
    log.info("timing:\n%s", timer.report())
    return results
