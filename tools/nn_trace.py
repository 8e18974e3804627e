"""Where the NN letter's L-BFGS passes go, on one GPU.

    python3 tools/nn_trace.py [--segment 500] [--out nn_trace.jsonl]

Trains the NN letter's two batched fits of ``mltps_bn`` (float32, h = 10,
10000 steps): the CV's 20 (response x fold) lanes at the stations (folds
from numpy_folds(n, 10, 2, seed=0), seeded inits, ``chip_smoke.nn_cv_inputs``)
and the finals' 2 responses on all rows.  The steps run in segments; after
each, one JSON line: passes (evaluations of all lanes) in the segment,
line-search evaluations per lane-step, the lanes whose parameters moved,
the lanes that reached a fixed point in the segment and the steps they
skipped there (each segment is a new run, which finds a fixed point again
after two steps), the last line search's iterations per lane, and the
seconds so far.  A lane's steps cost as many passes as its line searches'
evaluations, and the slowest lane sets the count, so the lines show which
lanes hold the card.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def trace(x, y, w, init, segment: int, total: int, label: str, out):
    import torch

    from machisplin_tpu_torch.models import nn

    carry = nn.fit_carry_init(x, y, sample_weight=w, hidden=10, init=init)
    prev = carry[0].clone()
    t0 = time.perf_counter()
    for s0 in range(0, total, segment):
        stats = {}
        carry = nn.fit_carry_steps(carry, x, y, sample_weight=w, steps=segment, stats=stats)
        torch.cuda.synchronize()
        flat, st = carry[0], carry[1]
        moved = (flat != prev).any(1)
        row = {"fit": label, "step": s0 + segment, "passes": stats["passes"],
               "evaluations_per_lane_step": stats["evaluations"] / stats["steps"],
               "lanes_moved": int(moved.sum()), "skipped_steps": stats["skipped_steps"],
               "fixed_lanes": stats["fixed_lanes"], "ls_steps": st.ls_steps.tolist(),
               "seconds": time.perf_counter() - t0}
        prev = flat.clone()
        line = json.dumps(row)
        print(line, flush=True)
        out.write(line + "\n")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--segment", type=int, default=500)
    ap.add_argument("--steps", type=int, default=10000)
    ap.add_argument("--out", default=None, help="also write the lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("nn_trace: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke as cs
    from machisplin_tpu_torch.models import nn

    stations = cs._stations()
    x, y, w, init, _, _, _ = cs.nn_cv_inputs(stations, "float32", "cuda")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out or os.devnull, "w") as out:
        trace(x, y, w, init, args.segment, args.steps, "cv", out)
        # the finals: every row, each response min-shifted and max-scaled
        xs, ys = stations
        xt = torch.as_tensor(xs, device="cuda")
        yc = torch.as_tensor(ys, dtype=torch.float32, device="cuda")
        y_min = yc.amin(0)
        yf = ((yc - y_min) / (yc - y_min).amax(0)).T.contiguous()
        init_f = nn.draw_init(2, xt.shape[1], 10, generator=torch.Generator().manual_seed(3), dtype=torch.float32,
                              device="cuda")
        trace(xt, yf, None, init_f, args.segment, args.steps, "finals", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
