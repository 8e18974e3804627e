"""Block shapes of kernels K1 and K3 on the card: threads a block, cells a thread.

    python3 tools/block_tune.py k1 [--shapes 256x2,128x4] [--out chiprun_out/k1_tune.json]
    python3 tools/block_tune.py k1 --resp 19 [--shapes 256x3x8,256x4x8] [--src variant.cu]
    python3 tools/block_tune.py k3 [--shapes 256x4,256x5] [--out chiprun_out/k3_tune.json]

Builds (in parallel) the kernel's source (``csrc/tps_grid.cu`` or ``csrc/forest_predict.cu``,
or ``--src``, a variant with the same C interface) once for each
``-DK1_THREADS=t -DK1_CELLS=c`` (or ``K3_...``) given and times it with CUDA
events (median of five after a warm-up), in the order given and then the
port's default build again.  K1 runs on the largest TPS tile as
``chip_smoke.py``'s phase ``kernel_k1`` builds it (R = 2); with ``--resp R``
on R responses of a 10,000-station exact fit (``config3_data``, responses
cycled past 19) over 3,163 x 3,163 cells, the benchmark cell's surface.  K1
takes its R <= 8 shape from ``K1_THREADS``/``K1_CELLS`` and its R > 8 shape
from ``K1_WIDE_THREADS``/``K1_WIDE_CELLS``/``K1_WIDE_ROWS``: a shape
``txcxw`` sets w grid rows a block (R > 8 only; default 1).  K3 runs on the
middle 256-row panel with the merged forest of ``chip_smoke.py``'s phase
``mltps_b`` (which this runs first).  Every build must give the default
build's outputs bit for bit: each cell's sums run in the same order whatever
the block shape.  Prints one JSON line per build (ms, ptxas' registers,
spills and shared memory of the instance timed) with the card's name, power
limit and SM clocks.  Needs a CUDA device and nvcc; run from the root of
the repo.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per kernel: source, macro prefix, the main path's template instance
KERNELS = {
    "k1": ("tps_grid", "K1", "tps_grid_kernelILi2E"),
    "k3": ("forest_predict", "K3", "forest_kernelILi2ELi2E"),
}
K1_NARROW = 8               # csrc/tps_grid.cu's NARROW: above it K1 takes its K1_WIDE_* shape


def default_shape(src: str, prefix: str) -> tuple:
    """(threads, cells, grid rows a block) that ``src`` builds without macros."""
    text = open(src).read()
    val = lambda key: int(re.search(rf"#define {prefix}_{key} (\d+)", text).group(1))
    return val("THREADS"), val("CELLS"), val("ROWS") if prefix.endswith("_WIDE") else 1


def _build(build, kernel: str, shape: tuple, src: str, instance: str, wide: bool = False, n: int = 0):
    """Build ``src`` at ``shape`` into the ``n``-th library of this run."""
    name, macro, _ = KERNELS[kernel]
    threads, cells, rows = shape
    out_dir = os.path.join(build.BUILD_ROOT, "block_tune")
    os.makedirs(out_dir, exist_ok=True)
    tag = "x".join(str(v) for v in shape)
    so = os.path.join(out_dir, f"lib{name}_{n}_{tag}.so")
    pre = f"{macro}_WIDE" if wide else macro
    defs = [f"-D{pre}_THREADS={threads}", f"-D{pre}_CELLS={cells}"] + ([f"-D{pre}_ROWS={rows}"] if wide else [])
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defs, "-o", so, src], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src} {tag}:\n{r.stdout}{r.stderr}")
    lines = (r.stdout + r.stderr).splitlines()
    at = next((k for k, ln in enumerate(lines) if instance in ln and "Compiling" in ln), None)
    summary = [] if at is None else [ln.strip() for ln in lines[at : at + 4]
                                     if "registers" in ln or "spill" in ln or "smem" in ln]
    return ctypes.CDLL(so), summary


def k1_cell_tables(n_resp: int):
    """K1's tables for ``n_resp`` responses of config 3's 10,000 stations
    (responses cycled past its 19), fitted exactly on the card as the
    benchmark cell fits them, and the 3,163 x 3,163 unit-square grid."""
    import torch

    from machisplin_tpu_torch.grid import GridSpec
    from machisplin_tpu_torch.ops import tps, tps_grid
    from tools.record_jax_nystrom import config3_data

    coords, ys = config3_data()
    ys = ys[:, [j % ys.shape[1] for j in range(n_resp)]]
    model = tps.tps_fit_auto(torch.as_tensor(coords, device="cuda"), torch.as_tensor(ys, device="cuda"),
                             method="exact", max_device_knots=len(coords))
    side = 3163
    g = GridSpec(nrows=side, ncols=side, xmin=0.0, ymax=1.0, dx=1.0 / side, dy=1.0 / side)
    return tps_grid.grid_tables(model, g, torch.float32), g


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--shapes", default="256x2,256x4,128x4",
                    help="threads x cells (x grid rows a block, K1 at R > 8), comma-separated")
    ap.add_argument("--resp", type=int, help="K1: time R responses of the benchmark cell's surface")
    ap.add_argument("--src", help="build this source instead of the port's (the same C interface)")
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

    name, macro, instance = KERNELS[args.kernel]
    port_src = os.path.join(ROOT, "machisplin_tpu_torch", "csrc", f"{name}.cu")
    wide = False
    if args.kernel == "k1":
        if args.resp:
            tab, g = k1_cell_tables(args.resp)
            instance = f"tps_grid_kernelILi{args.resp}E"
            wide = args.resp > K1_NARROW
        else:
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

    def parse(text):
        v = tuple(int(x) for x in text.split("x"))
        if len(v) == 3 and v[2] != 1 and not wide:
            raise SystemExit(f"block_tune: {text}: grid rows a block only for K1 at R > {K1_NARROW}")
        return v if len(v) == 3 else v + (1,)

    src = os.path.abspath(args.src) if args.src else port_src
    builds = [(src, parse(s)) for s in args.shapes.split(",")]
    builds.append((port_src, default_shape(port_src, f"{macro}_WIDE" if wide else macro)))
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(8, len(builds))) as pool:
        built = list(pool.map(lambda nb: _build(build, args.kernel, nb[1][1], nb[1][0], instance, wide, nb[0]),
                              enumerate(builds)))
    launcher, lines = module._launcher, []
    try:
        for (path, shape), (lib, summary) in zip(builds, built):
            fn = getattr(lib, entry)
            fn.restype, fn.argtypes = ctypes.c_int, argtypes
            module._launcher = lambda fn=fn: fn
            got = run()
            torch.cuda.synchronize()
            threads, cells, rows = shape
            res = {"kernel": args.kernel, "source": os.path.relpath(path, ROOT), "resp": args.resp,
                   "threads": threads, "cells": cells, "rows": rows, "same_outputs": bool(torch.equal(got, want)),
                   "ms": chip_smoke.cuda_ms(run, reps=5), "ptxas_instance": summary, "cells_in_call": n_cells,
                   "card": smi}
            del got
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
