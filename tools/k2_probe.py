"""Where kernel K2's time goes inside a tree, on the card.

Builds ``machisplin_tpu_torch/csrc/tree_grow.cu`` a second time with
``-DK2_PROBE``: thread 0 of block 0 then adds the ``clock64`` cycles since
its previous mark to the section of the tree that a mark closes (the
sections of ``enum Section`` in the source).  At ``chip_smoke.py``'s two K2
shapes it grows a cycle of ``chip_smoke.K2_CYCLE`` trees as the BRT path
launches it, checks that the marked build gives the default build's outputs
bit for bit, and prints one JSON line per shape: cycles per tree of each
section, splits per tree, and ms per tree of both builds (CUDA events), with
the card's name, power limit and SM clocks.

The sections are thread 0's view: WALK is its own walk of its bins' rows,
SCAN_BARRIER its wait for the slowest warp's walk and scan, GAINS its
carries and gains, ARGMAX_BARRIER the winners' reductions and their barrier.

Needs a CUDA device and nvcc.  From the root of the repo:

    python3 tools/k2_probe.py [--out chiprun_out/k2_probe.json]
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ["INIT", "NODE_PICK", "ROUTE_TOTALS", "SCAN_BARRIER", "ARGMAX_BARRIER", "NODE_WRITE", "TO_LEAF",
            "LEAF_UPDATE", "WALK", "GAINS"]


def _build_marked(build) -> ctypes.CDLL:
    out_dir = os.path.join(build.BUILD_ROOT, "k2_probe")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "libtree_grow_probe.so")
    src = os.path.join(ROOT, "machisplin_tpu_torch", "csrc", "tree_grow.cu")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-DK2_PROBE", "-o", so, src],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for the marked build:\n{r.stdout}{r.stderr}")
    print(json.dumps({"marked_build_ptxas": [ln.strip() for ln in (r.stdout + r.stderr).splitlines()
                                             if "registers" in ln or "spill" in ln]}), flush=True)
    lib = ctypes.CDLL(so)
    lib.tree_grow_read_sections.restype = ctypes.c_int
    lib.tree_grow_read_sections.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("k2_probe: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from machisplin_tpu_torch.kernels import build
    from machisplin_tpu_torch.ops import tree_grow

    marked = tree_grow._bind(_build_marked(build))
    library = tree_grow._library
    default = library()
    inp = chip_smoke.k2_inputs()
    tables, nb, n_trees = inp["tables"], inp["nb"], chip_smoke.K2_CYCLE
    g = torch.Generator(device="cuda").manual_seed(3)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    lines = []
    for name, sh in inp["shapes"].items():
        y, w = sh["y"], sh["w"]
        c, n = y.shape
        f = ((w * y).sum(1) / w.sum(1).clamp_min(1.0))[:, None].expand(c, n).contiguous()
        bags = (torch.rand((n_trees, c, n), generator=g, device="cuda") < 0.5).float() * w
        kw = dict(chip_smoke.k2_cycle_kwargs(sh, nb, inp["min_leaf"], n_trees), emit_tree=True)
        run = lambda: tree_grow.gbm_tree_cycle_cuda(tables, y, f, bags, **kw)
        res = {"shape": name, "chains": c, "n_splits": sh["n_splits"], "trees": n_trees}
        outs = {}
        try:
            for which, lib in (("default", default), ("marked", marked)):
                tree_grow._library = lambda lib=lib: lib
                out = run()
                torch.cuda.synchronize()
                outs[which] = [out.f, *out.trees] + ([out.deviance] if out.deviance is not None else [])
                res[f"ms_per_tree_{which}"] = chip_smoke.cuda_ms(run, reps=10) / n_trees
            buf = (ctypes.c_ulonglong * len(SECTIONS))()
            marked.tree_grow_read_sections(buf)               # zero what the timing runs added
            run()
            torch.cuda.synchronize()
            err = marked.tree_grow_read_sections(buf)
            if err != 0:
                raise RuntimeError(f"reading the section counters failed: CUDA error {err}")
        finally:
            tree_grow._library = library
        res["same_outputs"] = all(torch.equal(a, b) for a, b in zip(outs["default"], outs["marked"]))
        cyc = {s: buf[k] / n_trees for k, s in enumerate(SECTIONS)}
        total = sum(cyc.values())
        res["cycles_per_tree"] = cyc
        res["share"] = {s: v / total for s, v in cyc.items()}
        res["total_cycles_per_tree"] = total
        res["splits_per_tree_block0"] = float(outs["default"][3][:, 0].sum(-1).mean())
        res["card"] = smi
        lines.append(res)
        print(json.dumps(res), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if all(r["same_outputs"] for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
