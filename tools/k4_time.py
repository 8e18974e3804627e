"""Time kernel K4 (the SVM sweep) at the CV shape, from a checkout of the port.

    python3 tools/k4_time.py [--root DIR] [--reps 5] [--dtypes float32,float64] [--check]

Imports ``chip_smoke`` and ``machisplin_tpu_torch`` from ``--root`` (default:
this checkout; a ``git archive`` of another commit unpacked anywhere works
the same), builds that checkout's kernels, makes K4's operands as its
``chip_smoke.svm_cv_inputs`` does (20 (response x fold) lanes x 813
stations, 120 sweeps) and times ``svm_sweep_cuda`` with CUDA events: the
first launch, then ``--reps`` launches after a warm-up.  ``--check`` also
holds the result against the plain version (``chip_smoke.SVM_TOL``; ~20 s a
dtype).  Prints one JSON line with the card's name.  Run it for two
checkouts in one call, in turns (parent, change, change, parent), to
compare them on one card.  Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("--check", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("k4_time: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from machisplin_tpu_torch.ops import svm_sweep

    out = {"root": root, "card": torch.cuda.get_device_name(0), "epochs": cs.SVM_EPOCHS}
    for dtype in args.dtypes.split(","):
        q, ys, w, diag = cs.svm_cv_inputs(dtype)
        lanes, n = ys.shape
        run = lambda: svm_sweep.svm_sweep_cuda(q, ys, w, diag, epochs=cs.SVM_EPOCHS)
        (theta, lam), first = cs._event_ms(run)
        times = sorted(cs._event_ms(run)[1] for _ in range(args.reps))      # the first launch warmed up
        res = {"lanes": lanes, "stations": n, "first_launch_ms": first, "ms": times[len(times) // 2],
               "ms_min": times[0], "ms_max": times[-1], "ns_per_step": times[len(times) // 2] * 1e6 / (cs.SVM_EPOCHS * n)}
        if args.check:
            ptheta, plam = svm_sweep.svm_sweep_plain(q, ys, w, diag, epochs=cs.SVM_EPOCHS)
            res["max_abs_err"] = max(float((theta - ptheta).abs().max()), float((lam - plam).abs().max()))
            res["tol"] = cs.SVM_TOL[dtype]
        out[dtype] = res
    from machisplin_tpu_torch.kernels import build

    out["ptxas"] = [ln.strip() for ln in build.ptxas_info().get("svm_sweep", "").splitlines()
                    if "registers" in ln or "spill" in ln]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
