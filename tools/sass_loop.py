"""Instructions a pair in the hot loop of kernel K1, K3 or K4, read from its SASS.

    python3 tools/sass_loop.py k1 [--src machisplin_tpu_torch/csrc/tps_grid.cu] [-D K1_CELLS=2] [--resp 19]
    python3 tools/sass_loop.py k3 [--src ...] [--sass file.sass]
    python3 tools/sass_loop.py k4

Compiles the source with the port's nvcc flags into an object file under
``build/sass_loop/``, disassembles it with ``cuobjdump -sass`` (or reads a
listing given with ``--sass``), takes the main path's template instance (K1:
R = 2, or R with ``--resp``; K3: W = 2 words, R = 2) and the innermost loop
(a backward branch and its target) that holds the pair's marker
instruction: FMNMX for K1, one a (cell, knot) pair; PRMT for K3, two a
(cell, tree) pair.  For K4 (float32) the "pair" is a coordinate step and
the loop is the one densest in FMNMX, four a step: the chain warp's loop
over a chunk's steps, in both instances,
theta in shared memory ("shared") and in device memory ("global"), each with
its count of non-coherent global loads (LDG .CONSTANT, which the global
layout must not have: the updaters read theta after the chain warp wrote
it).  Prints one JSON line: the loop's instructions, pairs an iteration,
instructions a pair and each opcode's count a pair (for K4, per layout).
Compiling needs nvcc and cuobjdump; ``--sass`` needs neither.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# per kernel: source, the main path's instance, marker opcode, markers a pair
KERNELS = {
    "k1": ("tps_grid", "tps_grid_kernelILi2E", "FMNMX", 1),
    "k3": ("forest_predict", "forest_kernelILi2ELi2E", "PRMT", 2),
    "k4": ("svm_sweep", "svm_sweep_kernelIfLb0EE", "FMNMX", 4),
}
# K4's instances (float32) by where a lane's theta lives
K4_LAYOUTS = {"shared": "svm_sweep_kernelIfLb0EE", "global": "svm_sweep_kernelIfLb1EE"}
_INS = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(.*?)\s*;")


def _sass(src: str, defines: list) -> str:
    sys.path.insert(0, ROOT)
    from machisplin_tpu_torch.kernels import build

    out_dir = os.path.join(build.BUILD_ROOT, "sass_loop")
    os.makedirs(out_dir, exist_ok=True)
    obj = os.path.join(out_dir, os.path.basename(src) + ".o")
    flags = [f for f in build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([build._nvcc(), *flags, *(f"-D{d}" for d in defines), "-c", "-o", obj, src],
                   check=True, capture_output=True, text=True)
    cuobjdump = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", obj], check=True, capture_output=True, text=True).stdout


def _function(sass: str, instance: str) -> str:
    return next(f for f in re.split(r"\n\s*Function : ", sass)[1:] if instance in f.split("\n", 1)[0])


def noncoherent_loads(sass: str, instance: str) -> int:
    """Global loads of ``instance`` through the non-coherent path (LDG with
    .CONSTANT: ld.global.nc, __ldg)."""
    return sum(1 for _, op in _INS.findall(_function(sass, instance))
               if re.match(r"^(@!?U?P\w+\s+)?LDG\.\S*CONSTANT", op))


def loop_counts(sass: str, instance: str, marker: str, per_pair: int, densest: bool = False) -> dict:
    """The innermost loop of ``instance`` that holds ``marker`` (with
    ``densest``, the loop densest in it): its size and its opcodes a pair."""
    text = _function(sass, instance)
    ins = [(int(a, 16), op) for a, op in _INS.findall(text)]
    ops = [re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0] for _, op in ins]
    first = next(k for k, op in enumerate(ops) if op == marker)
    at = {a: k for k, (a, _) in enumerate(ins)}
    loops = []
    for k, (a, op) in enumerate(ins):
        m = re.search(r"\bBRA\s+(0x[0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a and int(m.group(1), 16) in at:
            lo = at[int(m.group(1), 16)]
            if densest or lo <= first <= k:
                loops.append((-ops[lo : k + 1].count(marker) / (k + 1 - lo) if densest else 0, k - lo, lo, k + 1))
    *_, lo, hi = min(loops)
    body = collections.Counter(ops[lo:hi])
    pairs = body[marker] / per_pair
    return {"instructions": hi - lo, "pairs": pairs, "per_pair": (hi - lo) / pairs,
            "opcodes_per_pair": {k: v / pairs for k, v in body.most_common()}}


def k4_layouts(sass: str) -> dict:
    """K4's chain loop and non-coherent loads in each layout's instance."""
    _, _, marker, per_step = KERNELS["k4"]
    return {layout: {**loop_counts(sass, inst, marker, per_step, densest=True),
                     "noncoherent_loads": noncoherent_loads(sass, inst)}
            for layout, inst in K4_LAYOUTS.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(KERNELS))
    ap.add_argument("--src", help="the kernel's source (default: the port's)")
    ap.add_argument("-D", dest="defines", action="append", default=[], help="a macro for nvcc, e.g. K1_CELLS=2")
    ap.add_argument("--sass", help="read this cuobjdump -sass listing instead of compiling")
    ap.add_argument("--resp", type=int, help="K1: the instance of R responses (default: the main path's, 2)")
    args = ap.parse_args()
    name, instance, marker, per_pair = KERNELS[args.kernel]
    if args.kernel == "k1" and args.resp:
        instance = f"tps_grid_kernelILi{args.resp}E"
    src = args.src or os.path.join(ROOT, "machisplin_tpu_torch", "csrc", f"{name}.cu")
    sass = open(args.sass).read() if args.sass else _sass(src, args.defines)
    counts = k4_layouts(sass) if args.kernel == "k4" else loop_counts(sass, instance, marker, per_pair)
    res = {"kernel": args.kernel, "source": args.sass or src, "defines": args.defines, "instance": instance, **counts}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
