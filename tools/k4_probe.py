"""Where kernel K4's time goes: cycles a chunk of its chain warp and its updater warps.

    python3 tools/k4_probe.py [--shape cv|finals|many] [--dtypes float32,float64]
                              [-D K4_PROBE_IDLE_UPDATERS] [--out chiprun_out/k4_probe.json]

Builds ``csrc/svm_sweep.cu`` with ``-DK4_PROBE`` (the clock64 marks that the
default build compiles away) into ``build/k4_probe/``, makes the shape's
operands as ``chip_smoke.svm_inputs`` does, launches once to warm up and
once to measure, and reads block 0's counts: per phase (one chunk of 32
coordinates), the chain warp's cycles of work (its 32 steps and the
chunk's set-up) and of waiting for the next stage, and each updater warp's
cycles of work (the next chunk's partial sums, blocks and constants; each
clock is read after a value that the barrier releases).
The launch's CUDA-event ms and block 0's cycles give the SM clock.  With
``-D K4_PROBE_IDLE_UPDATERS`` the updaters stage nothing after the first
chunk: the chain warp's time alone (its results are then wrong).  Prints
one JSON line (and writes it to ``--out``).  Needs nvcc and a CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_probe(defines: list) -> str:
    sys.path.insert(0, ROOT)
    from machisplin_tpu_torch.kernels import build

    src = os.path.join(ROOT, "machisplin_tpu_torch", "csrc", "svm_sweep.cu")
    flags = [*build.NVCC_FLAGS, "-DK4_PROBE", *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(" ".join(flags).encode() + open(src, "rb").read()).hexdigest()[:16]
    out_dir = os.path.join(build.BUILD_ROOT, "k4_probe", h)
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libsvm_sweep.so")
    if not os.path.exists(lib):
        p = subprocess.run([build._nvcc(), *flags, "-o", lib, src], capture_output=True, text=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{p.stdout}{p.stderr}")
        build._ptxas["svm_sweep"] = p.stdout + p.stderr
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shape", default="cv", choices=["cv", "finals", "many"])
    ap.add_argument("--dtypes", default="float32,float64")
    ap.add_argument("-D", dest="defines", action="append", default=[], help="a macro for nvcc, e.g. K4_PROBE_IDLE_UPDATERS")
    ap.add_argument("--out", help="also write the JSON line here")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("k4_probe: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from machisplin_tpu_torch.kernels import build
    from machisplin_tpu_torch.ops import svm_sweep

    lib = ctypes.CDLL(build_probe(args.defines))
    lib.svm_sweep_probe_read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.svm_sweep_probe_read.restype = ctypes.c_int
    lib.svm_sweep_probe_size.argtypes = []
    lib.svm_sweep_probe_size.restype = ctypes.c_int
    build._loaded["svm_sweep"] = lib                # the wrapper launches the probe build
    size = lib.svm_sweep_probe_size()
    counts = (ctypes.c_ulonglong * size)()
    res = {"shape": args.shape, "defines": args.defines, "card": torch.cuda.get_device_name(0),
           "ptxas": [ln.strip() for ln in build.ptxas_info().get("svm_sweep", "").splitlines()
                     if "registers" in ln or "spill" in ln]}
    for dtype in args.dtypes.split(","):
        q, ys, w, diag, epochs = cs.svm_inputs(args.shape, dtype)
        run = lambda: svm_sweep.svm_sweep_cuda(q, ys, w, diag, epochs=epochs)
        run()
        torch.cuda.synchronize()
        if lib.svm_sweep_probe_read(counts) != 0:
            raise RuntimeError("k4_probe: reading the counts failed")
        _, ms = cs._event_ms(run)
        if lib.svm_sweep_probe_read(counts) != 0:
            raise RuntimeError("k4_probe: reading the counts failed")
        work, wait, phases, *upd = list(counts)
        per = lambda v: v / max(phases, 1)
        res[dtype] = {
            "lanes": ys.shape[0], "stations": ys.shape[1], "epochs": epochs, "ms": ms, "phases": phases,
            "chain_work_cycles_per_phase": per(work), "chain_wait_cycles_per_phase": per(wait),
            "chain_work_cycles_per_step": per(work) / 32,
            "updater_work_cycles_per_phase_max": per(max(upd)),
            "updater_work_cycles_per_phase_mean": per(sum(upd) / len(upd)),
            "sm_ghz": (work + wait) / (ms * 1e6),
        }
    line = json.dumps(res)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
