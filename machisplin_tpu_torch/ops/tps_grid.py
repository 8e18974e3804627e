"""TPS grid prediction: kernel K1 and its plain PyTorch version.

Counterpart of ``machisplin_tpu/ops/pallas_tps.py``.  Both versions evaluate
a fitted spline at every cell centre of a grid from the same tables, which
``grid_tables`` builds as ``_compiled_grid_eval`` does on the host:

* only the live knots: a knot whose c is 0 in every response (a knot
  budget's padding, ``parallel/sharded.pack_tiles``) adds nothing and is left
  out; the rest are padded to a multiple of the kernel's unroll width (4)
  with coordinate 0.5 and c = 0;
* phi's 1/2 folded into c, so the inner loop computes r2 * log(max(r2, tiny));
* ``d`` reordered from [1, x, y] to [x, y, 1];
* the coordinate shift/scale and the grid affine as eight scalars.

``tps_grid`` launches the CUDA kernel (``csrc/tps_grid.cu``) for a CUDA model
and runs ``tps_grid_plain`` for a CPU model; there is no fallback between the
two.  ``LAUNCHES`` counts kernel launches.  Spans: ``k1.tables`` (the tables,
with their one copy of the geometry to the host) and ``k1.launch`` (K1's
launch loop, or the plain version).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..grid import GridSpec
from ..utils.timing import span

__all__ = ["GridTables", "grid_tables", "tps_grid", "tps_grid_cuda", "tps_grid_plain", "LAUNCHES"]

_KNOT_UNROLL = 4  # the kernel's inner unroll: knots are padded to a multiple of it
_MAX_RESP = 24  # responses a launch holds (csrc/tps_grid.cu's MAX_RESP: register accumulators)

# kernel launches since the last reset: {"tps_grid": n}
LAUNCHES = {"tps_grid": 0}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _launch_slices(n_resp: int) -> list[slice]:
    """The responses of each K1 launch: one launch up to ``_MAX_RESP``
    responses, ceil(n_resp / _MAX_RESP) launches above, in order."""
    return [slice(r0, min(r0 + _MAX_RESP, n_resp)) for r0 in range(0, n_resp, _MAX_RESP)]


class GridTables(NamedTuple):
    kxy: torch.Tensor   # (2, n_pad) scaled x and y of the live knots, padding at 0.5
    c: torch.Tensor     # (R, n_pad) 0.5 * radial coefficients, 0 at padding
    d: torch.Tensor     # (R, 3) polynomial coefficients ordered [x, y, 1]
    geo: tuple          # (sx0, sx1, sy0, sy1, xmin, dx, ymax, dy) floats
    single: bool        # the model had one response (c was 1-D)


def grid_tables(model, grid: GridSpec, dtype=None) -> GridTables:
    """Kernel tables for a TPSModel on ``grid``, in ``dtype`` (default: the
    model's), holding its live knots only.  The eight geometry scalars are rounded to ``dtype`` too, as
    the JAX kernel receives them in float32."""
    dtype = dtype or model.c.dtype
    c = model.c
    single = c.ndim == 1
    ccols = (c[:, None] if single else c).to(dtype)
    dcols = (model.d[:, None] if single else model.d).to(dtype)
    live = torch.nonzero((ccols != 0).any(1)).flatten()
    n = live.numel()
    n_pad = _round_up(max(n, 1), _KNOT_UNROLL)
    dev = c.device
    kxy = torch.full((2, n_pad), 0.5, dtype=dtype, device=dev)
    kxy[:, :n] = model.knots[live].to(dtype).T
    ct = torch.zeros((ccols.shape[1], n_pad), dtype=dtype, device=dev)
    ct[:, :n] = 0.5 * ccols[live].T
    dt = torch.cat([dcols[1:3], dcols[0:1]], dim=0).T.contiguous()
    raw = torch.cat([
        torch.stack([model.shift[0], model.scale[0], model.shift[1], model.scale[1]]).to(dtype),
        torch.tensor([grid.xmin, grid.dx, grid.ymax, grid.dy], dtype=dtype, device=dev),
    ])
    geo = tuple(float(v) for v in raw.cpu())
    return GridTables(kxy, ct, dt, geo, single)


def tps_grid_plain(tab: GridTables, grid: GridSpec, block_rows: int = 256) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (R, H, W), streamed over
    ``block_rows`` rows so at most (block_rows * W, n_pad) distances exist."""
    sx0, sx1, sy0, sy1, xmin, dx, ymax, dy = tab.geo
    dtype, dev = tab.c.dtype, tab.c.device
    t = lambda v: torch.tensor(v, dtype=dtype, device=dev)
    col = torch.arange(grid.ncols, dtype=dtype, device=dev)
    px_row = (t(xmin) + (col + 0.5) * t(dx) - t(sx0)) / t(sx1)        # (W,)
    tiny = torch.finfo(dtype).tiny
    out = torch.empty((tab.c.shape[0], grid.nrows, grid.ncols), dtype=dtype, device=dev)
    for r0 in range(0, grid.nrows, block_rows):
        rows = torch.arange(r0, min(r0 + block_rows, grid.nrows), dtype=dtype, device=dev)
        py_col = (t(ymax) - (rows + 0.5) * t(dy) - t(sy0)) / t(sy1)   # (h,)
        px = px_row[None, :].expand(len(rows), -1).reshape(-1)
        py = py_col[:, None].expand(-1, grid.ncols).reshape(-1)
        ddx = tab.kxy[0][:, None] - px[None, :]                         # (n_pad, cells)
        ddy = tab.kxy[1][:, None] - py[None, :]
        r2 = ddx * ddx + ddy * ddy
        phi = r2 * torch.log(r2.clamp_min(tiny))
        poly = tab.d[:, 0:1] * px[None, :] + tab.d[:, 1:2] * py[None, :] + tab.d[:, 2:3]
        out[:, r0 : r0 + len(rows)] = (tab.c @ phi + poly).reshape(-1, len(rows), grid.ncols)
    return out


def _launcher():
    from ..kernels.build import load_library

    lib = load_library("tps_grid")
    fn = lib.tps_grid_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4                       # kxy, c, d, out
        + [ctypes.c_int] * 4                        # n_pad, n_resp, nrows, ncols
        + [ctypes.c_float] * 8                      # geo
        + [ctypes.c_void_p]                         # stream
    )
    return fn


def tps_grid_cuda(tab: GridTables, grid: GridSpec) -> torch.Tensor:
    """Launch K1 on the current stream: (R, H, W) float32 on the tables'
    device, in ceil(R / 24) launches (``_launch_slices``).  Raises on a
    wrong device, dtype, layout or shape, and on a launch error."""
    kxy, c, d = tab.kxy, tab.c, tab.d
    dev = c.device
    for name, a in (("kxy", kxy), ("c", c), ("d", d)):
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"tps_grid_cuda: {name} must be on {dev}, got {a.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"tps_grid_cuda: {name} must be float32, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"tps_grid_cuda: {name} must be contiguous")
    n_resp, n_pad = c.shape
    if kxy.shape != (2, n_pad) or d.shape != (n_resp, 3) or n_pad % _KNOT_UNROLL:
        raise ValueError(
            f"tps_grid_cuda: bad table shapes kxy {tuple(kxy.shape)} c {tuple(c.shape)} d {tuple(d.shape)}"
        )
    if grid.nrows > 65535 or grid.ncols >= 2**31:
        raise ValueError("tps_grid_cuda: at most 65535 rows (one block row each) and 2^31 - 1 columns")
    fn = _launcher()
    out = torch.empty((n_resp, grid.nrows, grid.ncols), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for sl in _launch_slices(n_resp):
        cs, ds, os_ = c[sl], d[sl], out[sl]
        err = fn(
            kxy.data_ptr(), cs.data_ptr(), ds.data_ptr(), os_.data_ptr(),
            n_pad, sl.stop - sl.start, grid.nrows, grid.ncols, *tab.geo, stream,
        )
        if err != 0:
            raise RuntimeError(f"tps_grid kernel launch failed: CUDA error {err}")
        LAUNCHES["tps_grid"] += 1
    return out


def tps_grid(model, grid: GridSpec, block_rows: int = 256) -> torch.Tensor:
    """Evaluate a TPSModel at every cell of ``grid``: (H, W) for a
    single-response model, (H, W, R) otherwise.  A CUDA model runs K1 in
    float32; a CPU model runs the plain version in its own dtype."""
    on_card = model.c.device.type == "cuda"
    with span("k1.tables"):
        tab = grid_tables(model, grid, torch.float32 if on_card else None)
    with span("k1.launch"):
        out = tps_grid_cuda(tab, grid) if on_card else tps_grid_plain(tab, grid, block_rows)
    return out[0] if tab.single else out.permute(1, 2, 0)
