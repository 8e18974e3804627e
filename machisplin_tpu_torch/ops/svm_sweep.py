"""The SVM's coordinate sweep: kernel K4 and its plain version.

The counterpart of the sweep inside ``machisplin_tpu/models/svm.py::fit``
(``svm.py:121-141``, a ``lax.scan`` of sweeps over a ``lax.fori_loop`` of
coordinates).  Both versions solve every lane's SVR dual by cyclic
soft-threshold coordinate descent on ``q + mu * 11'`` with the multiplier
step ``lam += mu * sum(theta)`` after each sweep, with the reference's
formula and order (``models/svm.py`` describes the method).

``svm_sweep`` launches the CUDA kernel (``csrc/svm_sweep.cu``: one thread
block runs one lane's whole fit; its warp 0 runs the coordinates in chunks
of 32 with the residual q . theta kept current inside a chunk, while the
other warps sum each next chunk's residual afresh from q and theta) for
CUDA tensors and runs ``svm_sweep_plain`` for CPU tensors; there is no
fallback between the two.  The kernel reads q by symmetry (row k for
column k), as the SVM letter builds it: exactly symmetric.  Each lane's
theta lives in the block's shared memory up to ``max_rows`` rows and in
device memory (the lane's slice of the output) above, up to
``max_rows_global``; the two layouts give the same results bit for bit.
``LAUNCHES`` counts kernel launches and ``LAUNCH_LOG`` holds each launch's
lanes, rows, dtype and layout.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["svm_sweep", "svm_sweep_cuda", "svm_sweep_plain", "max_rows", "max_rows_global", "LAUNCHES",
           "LAUNCH_LOG"]

# kernel launches since the last reset: {"svm_sweep": n}
LAUNCHES = {"svm_sweep": 0}
# one (lanes, rows, dtype, layout) per launch since the last clear
LAUNCH_LOG: list = []

_SMEM = 232448           # an H100 block's shared memory
# the kernel's fixed shared memory (csrc/svm_sweep.cu): two stages (32
# coordinates' 8 constants, two 32 x 32 blocks of q, 15 updater warps' 32
# partial sums) in values, and 15 updater warps' row buffers of 8 KB
_STAGE_VALUES = 2 * (32 * 8 + 2 * 32 * 32 + 15 * 32)
_ROW_BUFFERS = 15 * 8192


def _free_smem(dtype: torch.dtype) -> int:
    return _SMEM - torch.finfo(dtype).bits // 8 * _STAGE_VALUES - _ROW_BUFFERS


def max_rows(dtype: torch.dtype) -> int:
    """The largest n the shared layout takes in ``dtype``: theta's 32 values
    and a 4-byte mask word per chunk of 32 rows beside the kernel's fixed
    shared memory."""
    return 32 * (_free_smem(dtype) // (32 * (torch.finfo(dtype).bits // 8) + 4))


def max_rows_global(dtype: torch.dtype) -> int:
    """The largest n the device-memory layout takes in ``dtype``: a 4-byte
    mask word per chunk of 32 rows beside the fixed shared memory (q's n^2
    values a lane are the real limit long before)."""
    return 32 * (_free_smem(dtype) // 4)


def _plain_sweep(q, ys, w, diag, theta, s, lam, floor, c_reg, epsilon, mu):
    """One sweep over the coordinates in order; theta and s in place."""
    for i in range(ys.shape[1]):
        wi, di, th = w[:, i], diag[:, i], theta[:, i]
        r = (q[:, i, :] * theta).sum(-1) + mu * s * wi - di * th
        z = (ys[:, i] - lam) * wi - r
        cand = torch.sign(z) * (z.abs() - epsilon * wi).clamp_min(0.0)
        cand = (cand / torch.maximum(di, floor)).clamp(-c_reg, c_reg) * wi
        s.add_(cand).sub_(th)
        theta[:, i] = cand


def svm_sweep_plain(q, ys, w, diag, *, c_reg: float = 1.0, epsilon: float = 0.1, mu: float = 1.0,
                    epochs: int = 120, graph: bool = False):
    """The sweep in plain PyTorch, vectorised over lanes: q (L, n, n), ys, w
    and diag (L, n) -> (theta (L, n), lam (L,)).  ``graph`` (CUDA tensors):
    one sweep's kernels are captured once in a CUDA graph and replayed
    ``epochs`` times, the same kernels in the same order (the same bits)
    without a launch from the host for each."""
    n_lanes, n = ys.shape
    theta = torch.zeros_like(ys)
    s = torch.zeros((n_lanes,), dtype=ys.dtype, device=ys.device)
    lam = torch.zeros_like(s)
    floor = torch.full((), 1e-12, dtype=ys.dtype, device=ys.device)
    args = (q, ys, w, diag, theta, s, lam, floor, c_reg, epsilon, mu)
    if not graph:
        for _ in range(epochs):
            _plain_sweep(*args)
            lam.add_(mu * s)
        return theta, lam
    side = torch.cuda.Stream(ys.device)
    side.wait_stream(torch.cuda.current_stream(ys.device))
    with torch.cuda.stream(side):                  # a warm-up sweep, then the state reset
        _plain_sweep(*args)
        lam.add_(mu * s)
        for a in (theta, s, lam):
            a.zero_()
    torch.cuda.current_stream(ys.device).wait_stream(side)
    sweep = torch.cuda.CUDAGraph()
    with torch.cuda.graph(sweep):
        _plain_sweep(*args)
        lam.add_(mu * s)
    for _ in range(epochs):
        sweep.replay()
    return theta, lam


def _launcher():
    from ..kernels.build import load_library

    lib = load_library("svm_sweep")
    fn = lib.svm_sweep_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 6                       # q, ys, w, diag, theta, lam
        + [ctypes.c_int] * 3                        # lanes, n, epochs
        + [ctypes.c_double] * 3                     # c_reg, eps, mu
        + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]     # is_double, global_theta, stream
    )
    return fn


def svm_sweep_cuda(q, ys, w, diag, *, c_reg: float = 1.0, epsilon: float = 0.1, mu: float = 1.0,
                   epochs: int = 120, theta: str = "auto"):
    """Launch K4 on the current stream: (theta (L, n), lam (L,)) in the
    inputs' dtype.  ``theta``: where each lane's theta lives, "shared"
    (n <= ``max_rows``), "global" (device memory, n <= ``max_rows_global``)
    or "auto" (shared where n allows, else global).  Raises on a CPU tensor,
    a dtype other than float32 or float64 (or mixed), a bad shape, n beyond
    the layout's limit, and on a launch error."""
    if theta not in ("auto", "shared", "global"):
        raise ValueError(f"svm_sweep_cuda: theta must be 'auto', 'shared' or 'global', got {theta!r}")
    dev, dtype = q.device, q.dtype
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"svm_sweep_cuda: float32 or float64 only, got {dtype}")
    for name, a in (("q", q), ("ys", ys), ("w", w), ("diag", diag)):
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"svm_sweep_cuda: {name} must be on one CUDA device, got {a.device}")
        if a.dtype != dtype:
            raise TypeError(f"svm_sweep_cuda: {name} is {a.dtype}, q is {dtype}")
    n_lanes, n = ys.shape
    if q.shape != (n_lanes, n, n) or w.shape != (n_lanes, n) or diag.shape != (n_lanes, n):
        raise ValueError(f"svm_sweep_cuda: bad shapes q {tuple(q.shape)} ys {tuple(ys.shape)} "
                         f"w {tuple(w.shape)} diag {tuple(diag.shape)}")
    if theta == "auto":
        theta = "shared" if n <= max_rows(dtype) else "global"
    limit = max_rows(dtype) if theta == "shared" else max_rows_global(dtype)
    if n > limit:
        raise ValueError(f"svm_sweep_cuda: n = {n} rows exceed the {theta} layout's {limit} in {dtype}")
    q, ys, w, diag = (a.contiguous() for a in (q, ys, w, diag))
    out = torch.empty((n_lanes, n), dtype=dtype, device=dev)
    lam = torch.empty((n_lanes,), dtype=dtype, device=dev)
    if n_lanes == 0:
        return out, lam
    fn = _launcher()
    err = fn(q.data_ptr(), ys.data_ptr(), w.data_ptr(), diag.data_ptr(), out.data_ptr(), lam.data_ptr(),
             n_lanes, n, epochs, float(c_reg), float(epsilon), float(mu), int(dtype == torch.float64),
             int(theta == "global"), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"svm_sweep kernel launch failed: CUDA error {err}")
    LAUNCHES["svm_sweep"] += 1
    LAUNCH_LOG.append((n_lanes, n, str(dtype).replace("torch.", ""), theta))
    return out, lam


def svm_sweep(q, ys, w, diag, *, c_reg: float = 1.0, epsilon: float = 0.1, mu: float = 1.0, epochs: int = 120):
    """Every lane's sweep: K4 for CUDA tensors (theta's layout chosen by n),
    the plain version for CPU tensors.  q (L, n, n), ys, w, diag (L, n) ->
    (theta (L, n), lam (L,))."""
    kw = dict(c_reg=c_reg, epsilon=epsilon, mu=mu, epochs=epochs)
    if q.device.type == "cuda":
        return svm_sweep_cuda(q, ys, w, diag, **kw)
    return svm_sweep_plain(q, ys, w, diag, **kw)
