"""The port's own spread on the north-star call over torch generator seeds.

    python3 tools/port_main_seeds_r2.py [--seeds 0,1,2,3,4,5,6,7] [--out chiprun_out/port_main_seeds.jsonl]

Runs ``mltps(load_sampling(), synthetic_covariates(downsample=1), tps=True)``
as ``chip_smoke.py``'s ``mltps_main`` does (the default pool, float32 as
built, folds ``numpy_folds(813, 10, 2, seed=0)``) on the card, once per
torch generator seed: the seed moves every draw the port makes (the BRT's
bags, the NN's initial weights, the SVM's sigest pairs, the RF's bootstrap
rows and feature draws), as a JAX key moves the JAX package's.  Prints one
JSON line per (seed, layer): the kept letters, the weights, f = sum of the
kept rounded weights / the unrounded total (the ensemble-total scale of
V73:619-620), r² ensemble, r² final and the wall; then one line with each
layer's range of r² final and f over the seeds beside the JAX keys' r²
final (``chip_smoke.JAX_REFERENCE_MAIN``).  ~30 s a seed on an H100.
Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", default="0,1,2,3,4,5,6,7")
    ap.add_argument("--out", help="also write the JSON lines here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("port_main_seeds_r2: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds

    cs.phase_build()
    cov = mtt.synthetic_covariates(downsample=1, device="cuda")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    lines, per = [], {}
    for seed in (int(k) for k in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = mtt.mltps(s, cov, tps=True, folds=folds, generator=torch.Generator().manual_seed(seed), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        for r in out:
            line = {"seed": seed, "layer": r.name, "kept": r.summary["best model(s):"],
                    "weights": [float(v) for v in r.weights.weights], "percent": r.summary["ensemble weights:"],
                    "f": cs._quirk_f(r), "r2_ensemble": r.summary["r2 ensemble:"],
                    "r2_final": r.summary["r2 final:"], "wall_s": wall}
            per.setdefault(r.name, []).append(line)
            lines.append(line)
            print(json.dumps(line), flush=True)
    summary = {"card": torch.cuda.get_device_name(0), "seeds": args.seeds, "layers": {
        name: {"r2_final": [min(l["r2_final"] for l in ls), max(l["r2_final"] for l in ls)],
               "r2_ensemble": [min(l["r2_ensemble"] for l in ls), max(l["r2_ensemble"] for l in ls)],
               "f": [min(l["f"] for l in ls), max(l["f"] for l in ls)],
               "kept": sorted({l["kept"] for l in ls}),
               "jax_keys_r2_final": [min(cs.JAX_REFERENCE_MAIN[name]["r2_final"]),
                                     max(cs.JAX_REFERENCE_MAIN[name]["r2_final"])]}
        for name, ls in per.items()}}
    print(json.dumps(summary), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(x) + "\n" for x in [*lines, summary])
    return 0


if __name__ == "__main__":
    sys.exit(main())
