"""Digest of kernel K2's outputs on fixed seeded inputs, to show that two
checkouts' kernels give the same bits.

    python3 tools/k2_bits.py [--root DIR]

imports ``machisplin_tpu_torch`` from ``DIR`` (default: this checkout),
builds its kernels, and launches K2 through ``ops/tree_grow.gbm_tree_cycle``
with one bin table and no monotone signs (the call every checkout takes) at
the batched BRT's shapes: the CV curve's (200 chains x 813 stations x p = 5,
tree complexity 25, lr 0.01) and the finals' (20 chains, tree complexity 5,
lr 1 with a scale, emitting trees and deviance sums), a 50-tree cycle each,
on seeded bins, responses and bags.  Prints one JSON line: the card, and per
shape the sha256 of every output tensor's bytes.  Needs a CUDA device; run
it with two roots in one call (unpack the other commit with ``git archive``
into ``checkout/``) and compare the digests.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys


def digests(root: str) -> dict:
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    from machisplin_tpu_torch.models import trees as ttrees
    from machisplin_tpu_torch.ops import tree_grow

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    n, p, nb, t = 813, 5, 64, 50
    x = torch.as_tensor(rng.uniform(0, 1, (n, p)), device=dev)
    y = 2.0 * x[:, 0] + torch.sin(4 * x[:, 1]) + 0.1 * torch.as_tensor(rng.standard_normal(n), device=dev)
    xb = ttrees.bin_data(x, ttrees.make_bins(x, nb))
    tables = tree_grow.prepare_bins(xb, nb)
    out = {}
    for name, c, n_splits in (("cv", 200, 25), ("finals", 20, 5)):
        ys = y.float()[None].expand(c, n).contiguous()
        w = torch.as_tensor((rng.uniform(size=(c, n)) < 0.9).astype(np.float32), device=dev)
        f = ((w * ys).sum(1) / w.sum(1))[:, None].expand(c, n).contiguous()
        bags = torch.as_tensor((rng.uniform(size=(t, c, n)) < 0.5).astype(np.float32), device=dev) * w
        kw = dict(n_splits=n_splits, nb=nb, min_leaf=10.0, lr=0.01)
        if name == "finals":
            kw.update(lr=1.0, scale=torch.full((t, c), 0.001, device=dev), emit_tree=True,
                      deviance_w=torch.stack([w, (w <= 0).float()]).contiguous())
        cyc = tree_grow.gbm_tree_cycle(tables, ys, f, bags, **kw)
        torch.cuda.synchronize()
        tensors = [cyc.f] + list(cyc.trees or ()) + ([cyc.deviance] if cyc.deviance is not None else [])
        out[name] = [hashlib.sha256(a.contiguous().cpu().numpy().tobytes()).hexdigest()[:16] for a in tensors]
    return {"root": root, "card": torch.cuda.get_device_name(0), "digests": out}


if __name__ == "__main__":
    args = sys.argv[1:]
    root = args[args.index("--root") + 1] if "--root" in args else os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    print(json.dumps(digests(root)), flush=True)
