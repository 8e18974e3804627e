"""Block shapes of kernels K1 and K3 on the card: threads a block, cells a thread.

    python3 tools/block_tune.py k1 [--shapes 256x2,128x4] [--out chiprun_out/k1_tune.json]
    python3 tools/block_tune.py k3 [--shapes 256x4,256x5] [--out chiprun_out/k3_tune.json]

Builds the kernel's source (``csrc/tps_grid.cu`` or ``csrc/forest_predict.cu``)
once for each ``-DK1_THREADS=t -DK1_CELLS=c`` (or ``K3_...``) given and times
it on the main path's inputs with CUDA events (median of five after a
warm-up), in the order given and then the default build again: K1 on the
largest TPS tile as ``chip_smoke.py``'s phase ``kernel_k1`` builds it; K3 on
the middle 256-row panel with the merged forest of ``chip_smoke.py``'s phase
``mltps_b`` (which this runs first).  Every build must give the default
build's outputs bit for bit: each cell's sums run in the same order whatever
the block shape.  Prints one JSON line per build (ms, ptxas' registers and
spills of the main path's instance) with the card's name, power limit and
SM clocks.  Needs a CUDA device and nvcc; run from the
root of the repo.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per kernel: source, macro prefix, the main path's template instance, default shape
KERNELS = {
    "k1": ("tps_grid", "K1", "tps_grid_kernelILi2E", (256, 3)),
    "k3": ("forest_predict", "K3", "forest_kernelILi2ELi2E", (256, 5)),
}


def _build(build, kernel: str, threads: int, cells: int):
    name, macro, instance, _ = KERNELS[kernel]
    out_dir = os.path.join(build.BUILD_ROOT, "block_tune")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}_{threads}x{cells}.so")
    src = os.path.join(ROOT, "machisplin_tpu_torch", "csrc", f"{name}.cu")
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, f"-D{macro}_THREADS={threads}",
                        f"-D{macro}_CELLS={cells}", "-o", so, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} {threads}x{cells}:\n{r.stdout}{r.stderr}")
    lines = (r.stdout + r.stderr).splitlines()
    at = next((k for k, ln in enumerate(lines) if instance in ln and "Compiling" in ln), None)
    summary = [] if at is None else [ln.strip() for ln in lines[at : at + 4] if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(so), summary


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--shapes", default="256x2,256x4,128x4", help="threads x cells, comma-separated")
    ap.add_argument("--out", help="also write the lines to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("block_tune: needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from machisplin_tpu_torch.kernels import build
    from machisplin_tpu_torch.ops import forest, tps_grid

    if args.kernel == "k1":
        tab, g, _, _ = chip_smoke.k1_tables()
        module, entry, argtypes = tps_grid, "tps_grid_launch", tps_grid._launcher().argtypes
        run = lambda: tps_grid.tps_grid_cuda(tab, g)
        n_cells = g.ncell
    else:
        captured: dict = {}
        chip_smoke.phase_mltps_b(captured)
        ft = captured["forest"]
        _, x = chip_smoke.k3_panel(captured["stack"])
        module, entry, argtypes = forest, "forest_predict_launch", forest._launcher().argtypes
        run = lambda: forest.forest_predict_cuda(ft, x)
        n_cells = int(x.shape[0])
    want = run()
    torch.cuda.synchronize()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60).stdout.strip()
    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")] + [KERNELS[args.kernel][3]]
    launcher, lines = module._launcher, []
    try:
        for threads, cells in shapes:
            lib, summary = _build(build, args.kernel, threads, cells)
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            module._launcher = lambda fn=fn: fn
            got = run()
            torch.cuda.synchronize()
            res = {"kernel": args.kernel, "threads": threads, "cells": cells, "same_outputs": bool(torch.equal(got, want)),
                   "ms": chip_smoke.cuda_ms(run, reps=5), "ptxas_main_instance": summary, "cells_in_call": n_cells,
                   "card": smi}
            lines.append(res)
            print(json.dumps(res), flush=True)
    finally:
        module._launcher = launcher
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("".join(json.dumps(r) + "\n" for r in lines))
    return 0 if all(r["same_outputs"] for r in lines) else 1


if __name__ == "__main__":
    sys.exit(main())
