"""Where config 4's TPS correction loses station r²: the tiles of the JAX
package's ``config4_pipeline_full`` (``chip_smoke.phase_pipeline_config4_full``),
their part 3 taken apart.

    python3 tools/config4_tps_probe.py --tiles 1,2,4 [--out config4_tps]

On a machine with a CUDA device, from the root of a checkout: builds the
config-4 world (``chip_smoke._config_world``), cuts it with
``tiles_create(out_ncol=2, out_nrow=2, feather_d=50)`` and runs
``mltps(..., tps=True)`` on each named tile (1-based) with the phase's
folds and generator seed, keeping the residuals part 3 fits.  Then, per
tile, prints one JSON line: r² ensemble and r² final as ``mltps`` reports
them (float32); r² final again with part 3 run in float64 on the same
residuals; and for every internal TPS tile its stations, the smoothing
parameter, the effective degrees of freedom, the GCV value and the sum of
squares of its residuals before and after its own fit, in float32 and in
float64; K1 against its plain version on every internal tile, and r² final
with the plain version in K1's place.  With ``--out`` it also saves each tile's part-3 inputs
(station coordinates, residuals, responses, the ensemble at the stations,
the tile's grid) to ``<out>/tile<k>.npz``, so the same fits can be made on
another machine.  About 30 s a tile on an H100.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _internal_tiles(coords, res, rast_stack, config, dtype):
    """Per internal TPS tile of part 3: stations, lambda, eff_df, GCV and the
    residual sums of squares before and after the tile's own fit."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.grid import crop, extract
    from machisplin_tpu_torch.parallel.sharded import batched_tile_solve, pack_tiles
    from machisplin_tpu_torch.pipeline.mltps import _tps_tiles

    n_rx, n_cx, fit_exts, _ = _tps_tiles(rast_stack.grid, config)
    first = rast_stack.band(0)
    sels = [torch.isfinite(extract(crop(first, e), coords[:, 0], coords[:, 1])).cpu().numpy() for e in fit_exts]
    live = [h for h, s in enumerate(sels) if int(s.sum()) >= config.min_tile_points]
    budget = -(-max(int(sels[h].sum()) for h in live) // 64) * 64
    dev = rast_stack.data.device
    ct, yt, mt_ = pack_tiles([coords[sels[h]] for h in live], [res[sels[h]] for h in live], pad_to=budget,
                             dtype=dtype, device=dev)
    model = batched_tile_solve(ct, yt, mt_)
    out = []
    for i, h in enumerate(live):
        r_in = res[sels[h]]
        r_out = model.residuals[i].double().cpu().numpy()
        out.append({"tile": h + 1, "stations": int(sels[h].sum()), "knots": budget,
                    "lam": float(model.lam[i].reshape(-1)[0]), "eff_df": float(model.eff_df[i].reshape(-1)[0]),
                    "gcv": float(model.gcv[i].reshape(-1)[0]), "ss_before": float(np.sum(r_in ** 2)),
                    "ss_after_fit": float(np.sum(r_out ** 2)),
                    "max_abs_c": float(model.c[i].abs().max())})
    return out


def _k1_against_plain(coords, res, rast_stack, config):
    """Per internal TPS tile of part 3 (float32, on the card): K1's surface
    against its plain version on the same tables and cells (max |diff|, the
    cell and its distance to the nearest knot), and part 3's r² inputs with
    every tile predicted by the plain version instead of K1."""
    import numpy as np
    import torch

    from machisplin_tpu_torch.grid import crop, extract
    from machisplin_tpu_torch.ops import tps_grid as tg
    from machisplin_tpu_torch.parallel.sharded import batched_tile_solve, pack_tiles
    from machisplin_tpu_torch.pipeline.mltps import _tps_tiles

    n_rx, n_cx, fit_exts, _ = _tps_tiles(rast_stack.grid, config)
    first = rast_stack.band(0)
    crops = [crop(first, e) for e in fit_exts]
    sels = [torch.isfinite(extract(c, coords[:, 0], coords[:, 1])).cpu().numpy() for c in crops]
    live = [h for h, s in enumerate(sels) if int(s.sum()) >= config.min_tile_points]
    budget = -(-max(int(sels[h].sum()) for h in live) // 64) * 64
    ct, yt, mt_ = pack_tiles([coords[sels[h]] for h in live], [res[sels[h]] for h in live], pad_to=budget,
                             dtype=torch.float32, device="cuda")
    model = batched_tile_solve(ct, yt, mt_)
    out = []
    for i, h in enumerate(live):
        m = type(model)(*(a[i] for a in model))
        g = crops[h].grid
        tab = tg.grid_tables(m, g, torch.float32)
        k1 = tg.tps_grid_cuda(tab, g)[0]
        plain = tg.tps_grid_plain(tab, g)[0]
        diff = (k1 - plain).abs()
        flat = int(torch.argmax(diff))
        row, col = divmod(flat, g.ncols)
        x = g.xmin + (col + 0.5) * g.dx
        y = g.ymax - (row + 0.5) * g.dy
        kn = coords[sels[h]]
        out.append({"tile": h + 1, "grid": list(g.shape), "live_knots": int(tab.kxy.shape[1]),
                    "max_abs_diff": float(diff.max()), "scale": float(plain.abs().max()),
                    "at": [row, col], "nearest_knot": float(np.sqrt(((kn - [x, y]) ** 2).sum(1)).min()),
                    "k1_at": float(k1[row, col]), "plain_at": float(plain[row, col])})
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", default="1,2,4")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import importlib

    import numpy as np
    import torch

    import chip_smoke
    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.grid import Raster, extract
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    mltps_mod = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")
    g, covars, lon, lat, alt, rng = chip_smoke._config_world(10000, 7, 4000)
    resp = 0.004 * alt - 8.0 * np.cos(4 * lon) + 3.0 * lat + 0.2 * rng.standard_normal(4000)
    dat = np.rec.fromarrays([lon, lat, resp], names="long,lat,bio_1")
    ts = mtt.tiles_create(covars, dat, out_ncol=2, out_nrow=2, feather_d=50)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    for k in (int(v) for v in args.tiles.split(",")):
        t = k - 1
        rast, dt = ts.rast[t], ts.dat[t]
        seen = {}
        orig = mltps_mod._tps_error_surface

        def keep(coords, res_mat, rast_stack, config):
            seen.update(coords=coords, res=np.asarray(res_mat), stack=rast_stack, config=config)
            return orig(coords, res_mat, rast_stack, config)

        mltps_mod._tps_error_surface = keep
        t0 = time.perf_counter()
        try:
            n = int(torch.isfinite(mtt.extract(rast, dt["long"], dt["lat"])).all(1).sum())
            r = mtt.mltps(dt, rast, tps=True, config=MLTPSConfig(), folds=numpy_folds(n, 10, 1, seed=t),
                          generator=torch.Generator().manual_seed(t), device="cuda")[0]
        finally:
            mltps_mod._tps_error_surface = orig
        wall = time.perf_counter() - t0
        coords, res, stack, config = seen["coords"], seen["res"][:, 0], seen["stack"], seen["config"]
        y = np.asarray(dt["bio_1"], np.float64)
        tss = float(np.sum((y - y.mean()) ** 2))
        ens_at = extract(r.ensemble, coords[:, 0], coords[:, 1]).cpu().numpy().astype(np.float64)
        line = {"tile": k, "stations": n, "mltps_s": wall, "kept": r.summary["best model(s):"],
                "r2_ensemble": r.summary["r2 ensemble:"], "r2_final": r.summary["r2 final:"]}
        for name, dtype in (("float32", torch.float32), ("float64", torch.float64)):
            st = Raster(stack.data.to(dtype), stack.grid, stack.names)
            surf, _ = orig(coords, seen["res"].astype(np.float64), st, config)
            f_at = ens_at + extract(Raster(surf.data[0], st.grid), coords[:, 0], coords[:, 1]).cpu().numpy()
            line[f"r2_final_part3_{name}"] = 1.0 - float(np.nansum((y - f_at) ** 2)) / tss
            line[f"internal_{name}"] = _internal_tiles(coords, res, st, config, dtype)
        line["k1_vs_plain"] = _k1_against_plain(coords, res, stack, config)
        # part 3 once more with every tile predicted by K1's plain version
        tps_grid_mod = importlib.import_module("machisplin_tpu_torch.ops.tps_grid")
        k1_fn = tps_grid_mod.tps_grid_cuda
        tps_grid_mod.tps_grid_cuda = lambda tab, grid: tps_grid_mod.tps_grid_plain(tab, grid)
        try:
            surf, _ = orig(coords, seen["res"].astype(np.float32), stack, config)
        finally:
            tps_grid_mod.tps_grid_cuda = k1_fn
        f_at = ens_at + extract(Raster(surf.data[0], stack.grid), coords[:, 0], coords[:, 1]).cpu().numpy()
        line["r2_final_part3_plain_float32"] = 1.0 - float(np.nansum((y - f_at) ** 2)) / tss
        print(json.dumps(line), flush=True)
        if args.out:
            g_t = rast.grid
            np.savez(os.path.join(args.out, f"tile{k}.npz"), coords=coords, res=res, y=y, ens_at=ens_at,
                     grid=np.array([g_t.nrows, g_t.ncols, g_t.xmin, g_t.ymax, g_t.dx, g_t.dy]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
