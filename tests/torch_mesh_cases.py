"""Cases of the port's device mesh, each run inside the ranks of a gloo
process group on the CPU and, with ``mesh=None``, in one process.

``run_ranks(world, names, tmp)`` starts ``world`` ranks with
``torch.multiprocessing.spawn`` and a ``file://`` store, runs every named
case on each rank with ``make_mesh(device_type="cpu")`` and returns each
rank's results.  Every input is made from a seed with numpy, so each rank
and the unsharded run see the same data.  This module imports no JAX: the
spawned ranks import it by name.
"""
from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch

from machisplin_tpu_torch import grid as tgrid
from machisplin_tpu_torch.ensemble.cv import CVConfig, run_cv
from machisplin_tpu_torch.models import gbm_step, rf
from machisplin_tpu_torch.models.trees import Tree
from machisplin_tpu_torch.ops import nystrom
from machisplin_tpu_torch.ops.forest import build_leaf_bins, predict_prepared, prepare_forest
from machisplin_tpu_torch.parallel import sharded
from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig, mltps, predict_over_stack

CASES = {}
_THREADS = 1


def case(fn):
    CASES[fn.__name__] = fn
    return fn


def tile_inputs(n_tiles: int, seed: int = 5):
    """Ragged tiles of stations on [0, 1]^2 with two responses: (coords
    list, y list, origins (T, 2), tile_shape, cell)."""
    rng = np.random.default_rng(seed)
    coords, ys = [], []
    for t in range(n_tiles):
        k = 30 - (t % 3) * 4
        c = rng.uniform(0, 1, (k, 2))
        coords.append(c)
        ys.append(np.stack([np.sin(3 * c[:, 0]) + 0.05 * rng.standard_normal(k), c[:, 0] * c[:, 1]], 1))
    origins = np.stack([rng.uniform(-0.1, 0.1, n_tiles), 1.0 + rng.uniform(-0.1, 0.1, n_tiles)], 1)
    return coords, ys, origins, (10, 12), (1 / 12, 1 / 10)


def _tiles(mesh, n_tiles):
    coords, ys, origins, shape, cell = tile_inputs(n_tiles)
    c, y, m = sharded.pack_tiles(coords, ys, pad_to=32, device="cpu")
    surf = sharded.batched_tile_tps(c, y, m, torch.as_tensor(origins), tile_shape=shape, cell=cell,
                                    ngrid=64, refine=12, mesh=mesh)
    model = sharded.batched_tile_solve(c, y, m, ngrid=64, refine=12, mesh=mesh)
    return dict(surf=surf, c=model.c, lam=model.lam)


@case
def tiles3(mesh, extra):
    return _tiles(mesh, 3)


@case
def tiles4(mesh, extra):
    return _tiles(mesh, 4)


def nystrom_inputs(n: int = 500, m: int = 40, seed: int = 6):
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.uniform(-78, -76, n), rng.uniform(-7, -5, n)], 1)
    y = np.stack([np.sin(coords[:, 0] * 3) + 0.1 * rng.standard_normal(n), coords[:, 1] ** 2], 1)
    landmarks = coords[rng.choice(n, m, replace=False)]
    return coords, y, landmarks


@case
def nystrom64(mesh, extra):
    coords, y, landmarks = nystrom_inputs()
    mdl = nystrom.nystrom_tps_fit(torch.as_tensor(coords), torch.as_tensor(y), landmarks=landmarks, chunk=64,
                                  ngrid=64, mesh=mesh)
    return dict(c=mdl.c, d=mdl.d, lam=mdl.lam, fitted=mdl.fitted)


@case
def forest_cells(mesh, extra):
    """K3's plain version over the cells of a 13 x 11 stack with NaN cells,
    in blocks of 5 rows (55 cells: no world size divides them)."""
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (90, 3))
    y = torch.as_tensor(np.stack([x[:, 0] * 2, np.cos(3 * x[:, 1])]), dtype=torch.float32)
    st = rf.fit(torch.as_tensor(x, dtype=torch.float32), y, ntree=6, max_depth=4,
                generator=torch.Generator().manual_seed(3))
    merged = Tree(*(a.reshape((12,) + a.shape[2:]) for a in st.trees))
    wmat = torch.kron(torch.eye(2), torch.full((6, 1), 1 / 6))
    dev = extra.get("device", "cpu")
    ft = prepare_forest(merged, wmat, build_leaf_bins(merged, n_feat=3), dev)
    data = torch.as_tensor(rng.uniform(0, 1, (3, 13, 11)), dtype=torch.float32, device=dev)
    data[1, 2, 3] = float("nan")
    data[0, 12, 10] = float("nan")
    g = tgrid.GridSpec(nrows=13, ncols=11, xmin=0.0, ymax=1.0, dx=0.1, dy=0.1)
    surf = predict_over_stack(lambda q: predict_prepared(ft, q), tgrid.Raster(data, g), block_rows=5, mesh=mesh,
                              out_cols=2)
    return dict(surf=surf)


def gbm_inputs(n: int = 150, seed: int = 8):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 3))
    y = np.stack([np.sin(4 * x[:, 0]) + x[:, 1] + 0.1 * rng.standard_normal(n),
                  x[:, 2] ** 2 - x[:, 0] + 0.1 * rng.standard_normal(n)], 1)
    w = (rng.integers(0, 3, (3, n)) > 0).astype(np.float64)      # 3 outer folds' training rows
    return torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(w)


_GBM = dict(tree_complexity=3, learning_rate=0.05, step_size=25, max_trees=300, n_folds=3, n_bins=16)


def _outer(mesh, extra, **kw):
    x, y, w = (a.to(extra.get("device", "cpu")) for a in gbm_inputs())
    preds, best = gbm_step.fit_outer_batched(x, y[:, 0], w, generator=torch.Generator().manual_seed(11),
                                             mesh=mesh, **_GBM, **kw)
    return dict(preds=preds, best=torch.as_tensor(best))


@case
def gbm_outer(mesh, extra):
    """3 outer x 3 inner = 9 chains: no world size of 2 or 4 divides them."""
    return _outer(mesh, extra)


@case
def gbm_outer_perfold(mesh, extra):
    return _outer(mesh, extra, global_bins=False, shared_bins=False)


@case
def gbm_outer_shared(mesh, extra):
    return _outer(mesh, extra, global_bins=False, shared_bins=True)


@case
def gbm_multi(mesh, extra):
    x, y, _ = gbm_inputs()
    res = gbm_step.fit_multi(x, y, generator=torch.Generator().manual_seed(12), mesh=mesh,
                             **dict(_GBM, learning_rate=0.02))
    return dict(fit=torch.stack([r.final.train_fit for r in res]), best=torch.as_tensor([r.best_trees for r in res]),
                value=torch.stack([r.final.trees.value for r in res]),
                lr=torch.as_tensor([r.learning_rate for r in res]))


def cv_inputs(n: int = 120, seed: int = 9):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 4))
    y = np.stack([2 * x[:, 0] + 0.1 * rng.standard_normal(n), np.cos(3 * x[:, 1]) + 0.1 * rng.standard_normal(n)], 1)
    return x, y


CV_CONFIG = CVConfig(
    n_folds=4,
    brt=dict(tree_complexity=2, learning_rate=0.1, step_size=20, max_trees=80, n_bins=16),
    rf=dict(ntree=8), rf_group=3,
    nn=dict(hidden=3, maxit=30),
    svm=dict(epochs=30),
)


def _cv(mesh, algorithms, folds=None, device="cpu"):
    x, y = cv_inputs()
    out = run_cv(torch.as_tensor(x, device=device), torch.as_tensor(y, device=device), config=CV_CONFIG, algorithms=algorithms, folds=folds,
                 generator=torch.Generator().manual_seed(4), mesh=mesh)
    return {k: torch.as_tensor(v) for k, v in out.items()}


@case
def cv(mesh, extra):
    """All six letters, float64: 8 lanes, 4 x 4 x 4 boosting chains."""
    return _cv(mesh, "bgnmrv")


@case
def cv_v(mesh, extra):
    """K4 (its plain version on the CPU) over the SVM's 8 lanes."""
    return _cv(mesh, "v", device=extra.get("device", "cpu"))


@case
def cv_r(mesh, extra):
    """The RF's 8 forests, rf_group at a time on each rank's share."""
    return _cv(mesh, "r", device=extra.get("device", "cpu"))


@case
def cv_gm(mesh, extra):
    """GAM and MARS on given folds (the JAX package's, in its parity test)."""
    return _cv(mesh, "gm", extra.get("folds"))


def world_inputs(nrows=40, ncols=36, n=220, seed=10):
    """A synthetic landscape: (grid geometry, covariate stack (2, H, W)
    float64, stations as a record array with two responses)."""
    rng = np.random.default_rng(seed)
    xmin, ymax, dx = -77.0, -6.0, 0.02
    xs = xmin + (np.arange(ncols) + 0.5) * dx
    ys = ymax - (np.arange(nrows) + 0.5) * dx
    xx, yy = np.meshgrid(xs, ys)
    alt = 1000 + 2500 * np.exp(-((xx + 76.5) ** 2 + (yy + 6.6) ** 2) / 0.08)
    slope = np.abs(np.gradient(alt)[0])
    lon = rng.uniform(xmin + 0.01, xmin + ncols * dx - 0.01, n)
    lat = rng.uniform(ymax - nrows * dx + 0.01, ymax - 0.01, n)
    col = np.clip(((lon - xmin) / dx).astype(int), 0, ncols - 1)
    row = np.clip(((ymax - lat) / dx).astype(int), 0, nrows - 1)
    resp = 0.006 * alt[row, col] - 10 * np.cos(4 * lon) + 5 * lat + 0.3 * rng.standard_normal(n)
    resp2 = 0.01 * slope[row, col] + 20 * lat + 0.2 * rng.standard_normal(n)
    dat = np.rec.fromarrays([lon, lat, resp, resp2], names="long,lat,bio_1,bio_12")
    return (nrows, ncols, xmin, ymax, dx), np.stack([alt, slope]), dat


MLTPS_CONFIG = MLTPSConfig(
    cv=CVConfig(n_folds=4, brt=dict(tree_complexity=3, learning_rate=0.1, step_size=20, max_trees=100),
                rf=dict(ntree=20), nn=dict(hidden=5, maxit=80)),
    final_brt=dict(tree_complexity=3, learning_rate=0.1, step_size=20, max_trees=100),
    final_rf=dict(ntree=20), final_nn=dict(hidden=5, maxit=80), svm_importance_sample=40,
    tps_tile_px=20,
)


def run_mltps(mesh, out_dir=None, letters_pool=None):
    (nrows, ncols, xmin, ymax, dx), stack, dat = world_inputs()
    g = tgrid.GridSpec(nrows=nrows, ncols=ncols, xmin=xmin, ymax=ymax, dx=dx, dy=dx)
    ras = tgrid.Raster(torch.as_tensor(stack), g, ("alt", "slope"))
    cfg = dataclasses.replace(MLTPS_CONFIG, mesh=mesh, letters_pool=letters_pool)
    log_file = None if out_dir is None else os.path.join(out_dir, "run.log")
    return mltps(dat, ras, tps=True, config=cfg, device="cpu", log_file=log_file,
                 generator=torch.Generator().manual_seed(21))


def layer_arrays(results) -> dict:
    out = {}
    for r in results:
        out[f"{r.name}/final"] = r.final.data
        out[f"{r.name}/residuals"] = torch.as_tensor(r.residuals)
        out[f"{r.name}/r2"] = torch.as_tensor([r.summary["r2 ensemble:"], r.summary.get("r2 final:", np.nan)])
        out[f"{r.name}/kept"] = r.summary["best model(s):"]
        out[f"{r.name}/var_imp"] = repr(r.var_imp)
    return out


@case
def mltps_all(mesh, extra):
    """The default pool over 2 responses on 2 x 2 TPS tiles, float64, with
    its log and GeoTIFFs written (rank 0) where ``extra`` names a folder."""
    from machisplin_tpu_torch.io.writers import write_geotiff

    out_dir = extra.get("out_dir")
    res = run_mltps(mesh, out_dir)
    out = layer_arrays(res)
    if out_dir is not None:
        out["paths"] = write_geotiff(res, os.path.join(out_dir, "tif"), seed=1, mesh=mesh)
    return out


@case
def mltps_gm(mesh, extra):
    return layer_arrays(run_mltps(mesh, letters_pool="gm"))


def _worker(rank, world, store, names, extra):
    import torch.distributed as dist

    torch.set_num_threads(_THREADS)
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))
    try:
        mesh = sharded.make_mesh(device_type=extra.get("device", "cpu"))
        out = {name: CASES[name](mesh, extra) for name in names}
        torch.save(out, os.path.join(extra["out_dir"], f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def start_ranks(world: int, names, tmp, **extra):
    """Start ``names`` on ``world`` gloo ranks; ``ranks_done`` waits for
    them and returns each rank's {case: result}.  Files the cases write go
    to ``tmp``; ``extra`` reaches every case (``device="cuda"``: the ranks'
    tensors and mesh on the card)."""
    import torch.multiprocessing as mp

    extra["out_dir"] = str(tmp)
    ctx = mp.start_processes(_worker, args=(world, os.path.join(str(tmp), "store"), list(names), extra),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, str(tmp), world


def ranks_done(started) -> list[dict]:
    ctx, tmp, world = started
    while not ctx.join():
        pass
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False) for r in range(world)]


def _unsharded_worker(_, names, extra):
    torch.set_num_threads(_THREADS)
    out = {name: CASES[name](None, extra) for name in names}
    torch.save(out, os.path.join(extra["save_dir"], "unsharded.pt"))


def start_unsharded(names, tmp, **extra):
    """Start the same cases without a mesh in one process, on ``_THREADS``
    threads as each rank; ``unsharded_done`` returns {case: result}."""
    import torch.multiprocessing as mp

    extra.update(out_dir=None, save_dir=str(tmp))
    ctx = mp.start_processes(_unsharded_worker, args=(list(names), extra), nprocs=1, join=False,
                             start_method="spawn")
    return ctx, str(tmp)


def unsharded_done(started) -> dict:
    ctx, tmp = started
    while not ctx.join():
        pass
    return torch.load(os.path.join(tmp, "unsharded.pt"), weights_only=False)
