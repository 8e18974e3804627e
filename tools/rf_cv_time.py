"""Time the RF letter of the north-star call on the card, from a checkout of the port.

    python3 tools/rf_cv_time.py [--root DIR] [--reps 3] [--downsample 1] [--groups all,1] [--profile]

Imports ``machisplin_tpu_torch`` from ``--root`` (default: this checkout; a
``git archive`` of another commit unpacked anywhere works the same) and
runs ``mltps`` over the reference's 813 stations and the synthetic
covariates with the pool ``"r"`` (the RF's 2 x 10 (response x fold) CV
forests, then its finals and raster passes), float32, on the folds and
generator seed of ``chip_smoke.py``'s ``mltps_main``.  ``--groups`` lists
the ``CVConfig.rf_group`` settings to time (``all``: the default, every
forest in one call; a number: that many a call), each after one warm-up
run and then ``--reps`` times in turns; a checkout whose ``CVConfig`` has
no ``rf_group`` runs its default only.  Prints one JSON line with the
card's name and power limit: per setting, the median seconds of every
phase of ``mltps``'s timer (``cv_r`` is the CV letter) and of the whole
call, a digest of the RF's CV residuals of every run, so runs that grew
the same forests show the same digest, and the peak device memory.  Run it for two checkouts in
one call, in turns (parent, change, change, parent), to compare them on
one card.  ``--profile`` adds, per setting, one more call under
``torch.profiler``: its 25 operators of most device time (calls, device
and host milliseconds) and the totals.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--downsample", type=int, default=1)
    ap.add_argument("--groups", default="all,1")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("rf_cv_time: no CUDA device", file=sys.stderr)
        return 2
    import machisplin_tpu_torch as mtt
    from machisplin_tpu_torch.ensemble.cv import CVConfig
    from machisplin_tpu_torch.ensemble.kfold import numpy_folds
    from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig

    pipeline = sys.modules["machisplin_tpu_torch.pipeline.mltps"]

    cov = mtt.synthetic_covariates(downsample=args.downsample, device="cuda")
    s = mtt.load_sampling()
    n = int(torch.isfinite(mtt.extract(cov, s["long"], s["lat"])).all(1).sum())
    folds = numpy_folds(n, 10, 2, seed=0)
    has_group = "rf_group" in {f.name for f in dataclasses.fields(CVConfig)}
    groups = [g for g in args.groups.split(",") if has_group or g == "all"]

    residuals = {}
    run_cv = pipeline.run_cv

    def recorded(*a, **k):
        out = run_cv(*a, **k)
        residuals["r"] = np.asarray(out["r"])
        return out

    pipeline.run_cv = recorded

    def run(group: str) -> tuple[dict, str]:
        cv = CVConfig() if group == "all" else dataclasses.replace(CVConfig(), rf_group=int(group))
        timer = mtt.PhaseTimer()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mtt.mltps(s, cov, tps=False, config=MLTPSConfig(letters_pool="r", cv=cv), folds=folds,
                  generator=torch.Generator().manual_seed(0), device="cuda", timer=timer)
        torch.cuda.synchronize()
        phases = dict(timer.as_dict(), mltps_wall=time.perf_counter() - t0)
        return phases, hashlib.sha256(np.ascontiguousarray(residuals["r"]).tobytes()).hexdigest()[:16]

    for g in groups:
        run(g)                                           # warm-up: cuBLAS, the kernels' build and load
    seen = {g: {"phases": [], "digests": []} for g in groups}
    for _ in range(args.reps):
        for g in groups:
            phases, digest = run(g)
            seen[g]["phases"].append(phases)
            seen[g]["digests"].append(digest)
    out = {"root": root, "stations": n, "grid": list(cov.grid.shape), "reps": args.reps, "has_rf_group": has_group,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    for g, runs in seen.items():
        keys = sorted(set().union(*runs["phases"]))
        out[g] = {"median_s": {k: float(np.median([p.get(k, np.nan) for p in runs["phases"]])) for k in keys},
                  "cv_r_s": [p.get("cv_r") for p in runs["phases"]], "digests": runs["digests"]}
        if args.profile:
            out[g]["profile"] = profile(lambda: run(g))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out["card"] = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


def profile(fn) -> dict:
    """``fn()`` under ``torch.profiler``: the operators of most device time."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
    rows = prof.key_averages()
    dev = lambda e: getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0)
    top = sorted(rows, key=dev, reverse=True)[:25]
    return {"device_ms_total": sum(dev(e) for e in rows) / 1e3,
            "host_ms_total": sum(e.self_cpu_time_total for e in rows) / 1e3,
            "ops": [{"name": e.key, "calls": e.count, "device_ms": dev(e) / 1e3, "host_ms": e.self_cpu_time_total / 1e3}
                    for e in top]}


if __name__ == "__main__":
    sys.exit(main())
