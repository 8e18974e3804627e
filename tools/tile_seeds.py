"""The port's own spread on one tile of README Example 2, over torch seeds.

    python3 tools/tile_seeds.py --tile 3 --seeds 0,1,2,3,4,5,6,7

On a machine with a CUDA device, from the root of a checkout: cuts the full
grid into ``chip_smoke.TILES`` (2 x 2 tiles) with ``tiles_create`` and runs
``mltps(dat_t, rast_t, tps=True)`` on tile ``--tile`` (1-based) with the
default pool and the folds ``chip_smoke.py``'s ``tiles_main`` gives it
(``numpy_folds(n_t, 10, 2, seed=t - 1)``), once per generator seed.  Prints
one JSON line a seed: kept letters, ensemble percentages, weights, r²
ensemble and r² final per response, and the seconds.  Set beside the JAX
package's keys (``tools/record_jax_tiles_r2.py``), it shows whether the
port's draws spread as the reference's do.  About 20-45 s a seed on an H100.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tile", type=int, default=3)
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    args = ap.parse_args()

    import torch

    import machisplin_tpu_torch as mtt
    from chip_smoke import TILES
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds

    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    ts = mtt.tiles_create(cov, mtt.load_sampling(), **TILES)
    t = args.tile - 1
    rast, dat = ts.rast[t], ts.dat[t]
    n = int(torch.isfinite(mtt.extract(rast, dat["long"], dat["lat"])).all(1).sum())
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = mtt.mltps(dat, rast, tps=True, folds=numpy_folds(n, 10, 2, seed=t),
                        generator=torch.Generator().manual_seed(seed), device="cuda")
        print(json.dumps({"tile": args.tile, "seed": seed, "stations": n, "seconds": time.perf_counter() - t0,
                          "layers": {r.name: {"kept": r.summary["best model(s):"],
                                              "percent": r.summary["ensemble weights:"],
                                              "weights": [float(w) for w in r.weights.weights],
                                              "r2_ensemble": r.summary["r2 ensemble:"],
                                              "r2_final": r.summary["r2 final:"]} for r in out}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
