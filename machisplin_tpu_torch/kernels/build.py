"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface, ``build/<hash>/lib<name>.so`` at the root of the checkout, where
``<hash>`` covers the sources and the flags, so an edit rebuilds.  All
sources compile at once, one nvcc process each.  Nothing here includes
PyTorch's headers, which keeps a build to seconds.

A failed build raises with the compiler's output.  Building happens at
first use (``load_library``), never at import.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

__all__ = ["NVCC_FLAGS", "build_all", "load_library", "ptxas_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_loaded: dict[str, ctypes.CDLL] = {}
_ptxas: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources() -> dict[str, str]:
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    }


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name, path in _sources().items():
        h.update(name.encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build_all() -> dict[str, str]:
    """Compile every source that has no library yet; returns {name: path}."""
    out_dir = _build_dir()
    os.makedirs(out_dir, exist_ok=True)
    libs = {name: os.path.join(out_dir, f"lib{name}.so") for name in _sources()}
    todo = {n: p for n, p in _sources().items() if not os.path.exists(libs[n])}
    if not todo:
        return libs
    nvcc = _nvcc()
    procs = {}
    for name, src in todo.items():
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ))
    errors = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        _ptxas[name] = log
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, libs[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def load_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, building all kernels first if needed."""
    if name not in _loaded:
        libs = build_all()
        if name not in libs:
            raise KeyError(f"no kernel source csrc/{name}.cu")
        _loaded[name] = ctypes.CDLL(libs[name])
    return _loaded[name]


def ptxas_info() -> dict[str, str]:
    """The compiler's output (registers, shared memory, spills) of the
    sources built by this process."""
    return dict(_ptxas)
