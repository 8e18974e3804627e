"""How far a float32 Nystrom fit moves with the order of its float32 sums.

On the problem of ``tests/test_torch_gpu.py::test_nystrom_on_card_matches_cpu``
(3,000 stations, 2 responses, 128 numpy landmarks) at fixed lambdas, prints
one JSON line: for each lambda the largest gap, as a share of the response
range, between the float32 fits with chunks of 777 and 500 stations on the
CPU and on the card, and between the card's and the CPU's fit at chunk 777;
and the streamed sums G = B'B, B'y, y'y on the card against the CPU's
(float32) and the CPU's float32 against float64, each as a share of the
largest entry.

    python tools/nystrom_f32_order.py            # needs a GPU
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from machisplin_tpu_torch.ops import nystrom as tnys  # noqa: E402


def main() -> None:
    rng = np.random.default_rng(0)
    n, m = 3000, 128
    coords = rng.uniform(0, 1, (n, 2))
    y = np.stack([np.sin(6 * coords[:, 0]) * np.cos(5 * coords[:, 1]), coords[:, 0]], 1) + 0.1 * rng.normal(size=(n, 2))
    lm = coords[np.random.default_rng(1).choice(n, m, replace=False)]
    span = float(np.ptp(y))
    c32, y32 = torch.as_tensor(coords, dtype=torch.float32), torch.as_tensor(y, dtype=torch.float32)
    gap = lambda a, b: float((a.fitted.cpu() - b.fitted.cpu()).abs().max()) / span
    out = {"lambdas": {}}
    for lam in (1e-4, 1e-2, 1.0):
        fit = {(dev, chunk): tnys.nystrom_tps_fit(c32.to(dev), y32.to(dev), landmarks=lm, lam=lam, chunk=chunk,
                                                  device=dev)
               for dev in ("cpu", "cuda") for chunk in (777, 500)}
        out["lambdas"][str(lam)] = {
            "cpu_777_vs_500": gap(fit["cpu", 777], fit["cpu", 500]),
            "card_777_vs_500": gap(fit["cuda", 777], fit["cuda", 500]),
            "card_vs_cpu": gap(fit["cuda", 777], fit["cpu", 777]),
        }
    xs = (c32 - c32.amin(0)) / (c32.amax(0) - c32.amin(0))
    z = fit["cpu", 777].knots
    cpu = tnys._stream_stats(xs, y32, z, 777)
    card = tnys._stream_stats(xs.cuda(), y32.cuda(), z.cuda(), 777)
    f64 = tnys._stream_stats(xs.double(), y32.double(), z.double(), 777)
    rel = lambda a, b: float((a.cpu().double() - b.double()).abs().max() / b.abs().max())
    out["stats_card_vs_cpu"] = [rel(a, b) for a, b in zip(card, cpu)]
    out["stats_cpu32_vs_64"] = [rel(a, b) for a, b in zip(cpu, f64)]
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
