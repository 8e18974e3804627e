"""Build the port's CUDA kernels with nvcc and its host library with g++,
and load them with ctypes.

Each ``csrc/<name>.cu`` compiles into its own shared library with a plain C
interface, ``build/<hash>/lib<name>.so`` at the root of the checkout, where
``<hash>`` covers the sources and the flags, so an edit rebuilds.  All
sources compile at once, one nvcc process each.  Nothing here includes
PyTorch's headers, which keeps a build to seconds.  Each ``csrc/<name>.cpp``
(the host library, ``io/native.py``) compiles with the C++ compiler into the
same directory (``load_host_library``), where no CUDA toolkit is needed.

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

__all__ = ["NVCC_FLAGS", "HOST_FLAGS", "build_all", "host_compiler", "host_finds_header", "load_host_library", "load_library",
           "ptxas_info"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-O3", "-std=c++17",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# no -march=native: the build directory is keyed by the sources, not the host
HOST_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-shared"]
HOST_LIBS = ["-lz", "-lpthread"]

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


def _sources(ext: str = ".cu") -> dict[str, str]:
    return {
        os.path.splitext(os.path.basename(p))[0]: p
        for p in sorted(glob.glob(os.path.join(_CSRC, "*" + ext)))
    }


def _build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + HOST_FLAGS + HOST_LIBS).encode())
    for name, path in {**_sources(), **_sources(".cpp")}.items():
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


def host_compiler() -> str | None:
    """The C++ compiler on ``PATH`` (``CXX``, else g++ or c++), or None."""
    for cand in (os.environ.get("CXX"), "g++", "c++"):
        if cand and shutil.which(cand):
            return shutil.which(cand)
    return None


def host_finds_header(header: str) -> bool:
    """Whether the C++ compiler on ``PATH`` finds ``<header>``."""
    cxx = host_compiler()
    return cxx is not None and subprocess.run([cxx, "-E", "-x", "c++", "-"], input=f"#include <{header}>\n",
                                              capture_output=True, text=True).returncode == 0


def load_host_library(name: str) -> ctypes.CDLL:
    """The loaded ``lib<name>.so`` of ``csrc/<name>.cpp``, compiled with the
    C++ compiler first if needed; a failed build raises."""
    key = "host:" + name
    if key not in _loaded:
        src = _sources(".cpp").get(name)
        if src is None:
            raise KeyError(f"no host source csrc/{name}.cpp")
        out_dir = _build_dir()
        os.makedirs(out_dir, exist_ok=True)
        lib = os.path.join(out_dir, f"lib{name}.so")
        if not os.path.exists(lib):
            cxx = host_compiler()
            if cxx is None:
                raise RuntimeError("no C++ compiler on PATH")
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
            os.close(fd)
            proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, src, *HOST_LIBS], capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"{os.path.basename(cxx)} failed for {name}.cpp (exit {proc.returncode}):\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, lib)
        _loaded[key] = ctypes.CDLL(lib)
    return _loaded[key]


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
