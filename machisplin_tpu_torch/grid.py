"""Raster/grid substrate: geo-referenced grids as torch tensors + affine metadata.

Counterpart of ``machisplin_tpu/grid.py`` (terra's crop/extend/mosaic/extract/
resample as the reference uses them, V73:123-164, V73:145, V73:699-781).  Grid
*metadata* (``GridSpec``) is plain Python; grid *values* are torch tensors
shaped (H, W) or (C, H, W) on any device.  Coordinates are cell centres; the
grid is north-up (row 0 = ymax edge).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from .utils import resolve_device

__all__ = [
    "GridSpec",
    "Raster",
    "WGS84",
    "crop",
    "extend",
    "extract",
    "lonlat_rasters",
    "map_blocks",
    "mosaic",
    "resample_near",
    "stack",
]

WGS84 = "+proj=longlat +datum=WGS84 +ellps=WGS84"


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Affine metadata of a north-up rectilinear grid.

    ``xmin``/``ymax`` are *edge* coordinates of the top-left corner, ``dx``/
    ``dy`` positive cell sizes.  Cell centres are at ``xmin + (col + 0.5) * dx``
    and ``ymax - (row + 0.5) * dy``.
    """

    nrows: int
    ncols: int
    xmin: float
    ymax: float
    dx: float
    dy: float
    crs: str = WGS84

    @property
    def xmax(self) -> float:
        return self.xmin + self.ncols * self.dx

    @property
    def ymin(self) -> float:
        return self.ymax - self.nrows * self.dy

    @property
    def extent(self) -> tuple[float, float, float, float]:
        """(xmin, xmax, ymin, ymax) — the terra ``ext()`` ordering."""
        return (self.xmin, self.xmax, self.ymin, self.ymax)

    @property
    def shape(self) -> tuple[int, int]:
        return (self.nrows, self.ncols)

    @property
    def ncell(self) -> int:
        return self.nrows * self.ncols

    def x_coords(self, dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Cell-centre x coordinate per column, shape (ncols,), computed in
        ``dtype`` (the scalar edge and cell size are rounded to it first)."""
        device = resolve_device(device)
        i = torch.arange(self.ncols, dtype=dtype, device=device)
        return self.xmin + (i + 0.5) * torch.tensor(self.dx, dtype=dtype, device=device)

    def y_coords(self, dtype=torch.float32, device="cuda") -> torch.Tensor:
        """Cell-centre y coordinate per row, shape (nrows,)."""
        device = resolve_device(device)
        i = torch.arange(self.nrows, dtype=dtype, device=device)
        return self.ymax - (i + 0.5) * torch.tensor(self.dy, dtype=dtype, device=device)

    def rowcol_from_xy(self, x, y) -> tuple[np.ndarray, np.ndarray]:
        """Containing cell of points, in float64 on the host; may be out of
        range (the caller masks)."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        col = np.floor((x - self.xmin) / self.dx).astype(np.int64)
        row = np.floor((self.ymax - y) / self.dy).astype(np.int64)
        return row, col

    def window_from_extent(self, ext, clip: bool = True) -> tuple[int, int, int, int]:
        """(row0, row1, col0, col1) half-open window whose cell edges are the
        nearest grid lines to ``ext`` (terra ``crop(..., snap='near')``)."""
        exmin, exmax, eymin, eymax = ext
        col0 = int(round((exmin - self.xmin) / self.dx))
        col1 = int(round((exmax - self.xmin) / self.dx))
        row0 = int(round((self.ymax - eymax) / self.dy))
        row1 = int(round((self.ymax - eymin) / self.dy))
        if clip:
            col0, col1 = max(col0, 0), min(col1, self.ncols)
            row0, row1 = max(row0, 0), min(row1, self.nrows)
        return row0, row1, col0, col1

    def subgrid(self, row0: int, row1: int, col0: int, col1: int) -> "GridSpec":
        return GridSpec(
            nrows=row1 - row0, ncols=col1 - col0,
            xmin=self.xmin + col0 * self.dx, ymax=self.ymax - row0 * self.dy,
            dx=self.dx, dy=self.dy, crs=self.crs,
        )

    def aligned_with(self, other: "GridSpec") -> bool:
        """True if self's cell lattice is a sub-lattice of other's."""
        if not (
            math.isclose(self.dx, other.dx, rel_tol=1e-9)
            and math.isclose(self.dy, other.dy, rel_tol=1e-9)
        ):
            return False
        fx = (self.xmin - other.xmin) / other.dx
        fy = (other.ymax - self.ymax) / other.dy
        return abs(fx - round(fx)) < 1e-6 and abs(fy - round(fy)) < 1e-6

    def offsets_in(self, other: "GridSpec") -> tuple[int, int]:
        """(row_off, col_off) of self's top-left cell inside other."""
        col = int(round((self.xmin - other.xmin) / other.dx))
        row = int(round((other.ymax - self.ymax) / other.dy))
        return row, col


class Raster:
    """A (possibly multi-band) geo-referenced grid: a tensor + GridSpec.

    ``data`` is (H, W) for a single band or (C, H, W) for a stack."""

    def __init__(self, data, grid: GridSpec, names: Sequence[str] | None = None):
        data = torch.as_tensor(data)
        if data.ndim not in (2, 3):
            raise ValueError(f"Raster data must be 2-D or 3-D, got {tuple(data.shape)}")
        if tuple(data.shape[-2:]) != grid.shape:
            raise ValueError(f"data shape {tuple(data.shape[-2:])} != grid shape {grid.shape}")
        self.data = data
        self.grid = grid
        if names is None:
            names = tuple(f"band_{i}" for i in range(1 if data.ndim == 2 else data.shape[0]))
        self.names = tuple(names)

    @property
    def nbands(self) -> int:
        return 1 if self.data.ndim == 2 else self.data.shape[0]

    def band(self, i: int) -> "Raster":
        if self.data.ndim == 2:
            if i != 0:
                raise IndexError(i)
            return self
        return Raster(self.data[i], self.grid, (self.names[i],))

    def as_stack(self) -> "Raster":
        return self if self.data.ndim == 3 else Raster(self.data[None], self.grid, self.names)

    def to(self, device) -> "Raster":
        return Raster(self.data.to(device), self.grid, self.names)

    def __repr__(self):
        return (
            f"Raster(bands={self.nbands}, shape={self.grid.shape}, "
            f"extent={self.grid.extent}, names={self.names}, device={self.data.device})"
        )


def stack(rasters: Sequence[Raster], names: Sequence[str] | None = None) -> Raster:
    """Concatenate single/multi-band rasters on one grid (terra ``c()``)."""
    g = rasters[0].grid
    arrs, nm = [], []
    for r in rasters:
        if r.grid.shape != g.shape or not r.grid.aligned_with(g):
            raise ValueError("stack: rasters must share one grid")
        arrs.append(r.as_stack().data)
        nm.extend(r.names)
    return Raster(torch.cat(arrs, dim=0), g, tuple(names or nm))


def lonlat_rasters(grid: GridSpec, dtype=torch.float32, device="cuda") -> Raster:
    """LONG/LAT covariate bands from cell centres (V73:127-133)."""
    lon = grid.x_coords(dtype, device)[None, :].expand(grid.shape)
    lat = grid.y_coords(dtype, device)[:, None].expand(grid.shape)
    return Raster(torch.stack([lon, lat]), grid, ("LONG", "LAT"))


def crop(r: Raster, ext) -> Raster:
    """Crop to the grid window nearest ``ext`` (terra ``crop``, V73:699)."""
    row0, row1, col0, col1 = r.grid.window_from_extent(ext)
    if row1 <= row0 or col1 <= col0:
        raise ValueError(f"crop: extent {ext} does not overlap raster")
    return Raster(
        r.data[..., row0:row1, col0:col1], r.grid.subgrid(row0, row1, col0, col1), r.names
    )


def extend(r: Raster, target: GridSpec, fill=float("nan")) -> Raster:
    """Pad ``r`` with ``fill`` out to the aligned grid ``target`` (terra
    ``extend``, V73:719)."""
    if not r.grid.aligned_with(target):
        raise ValueError("extend: grids are not aligned")
    row_off, col_off = r.grid.offsets_in(target)
    bottom = target.nrows - (row_off + r.grid.nrows)
    right = target.ncols - (col_off + r.grid.ncols)
    if min(row_off, col_off, bottom, right) < 0:
        raise ValueError("extend: raster does not fit inside target grid")
    out = torch.full(tuple(r.data.shape[:-2]) + target.shape, fill, dtype=r.data.dtype, device=r.data.device)
    out[..., row_off : row_off + r.grid.nrows, col_off : col_off + r.grid.ncols] = r.data
    return Raster(out, target, r.names)


def resample_near(r: Raster, target: GridSpec) -> Raster:
    """Nearest-neighbour resample onto ``target`` (terra ``resample(method=
    'near')``, V73:781): each target cell takes the source cell holding its
    centre, clamped to the source grid.  Indices are computed in float64 on
    the host, as ``extract``'s are."""
    tx = target.xmin + (np.arange(target.ncols, dtype=np.float64) + 0.5) * target.dx
    ty = target.ymax - (np.arange(target.nrows, dtype=np.float64) + 0.5) * target.dy
    col = np.clip(np.floor((tx - r.grid.xmin) / r.grid.dx).astype(np.int64), 0, r.grid.ncols - 1)
    row = np.clip(np.floor((r.grid.ymax - ty) / r.grid.dy).astype(np.int64), 0, r.grid.nrows - 1)
    dev = r.data.device
    rows = torch.as_tensor(row, device=dev)[:, None]
    cols = torch.as_tensor(col, device=dev)[None, :]
    return Raster(r.data[..., rows, cols], target, r.names)


def map_blocks(fn, r: Raster, block: tuple[int, int]) -> Raster:
    """Apply ``fn(data_block, subgrid) -> block`` over non-overlapping
    ``block`` = (rows, cols) tiles of ``r``, a host loop; the result has
    ``r``'s shape, dtype and device."""
    out = torch.empty_like(r.data)
    for r0 in range(0, r.grid.nrows, block[0]):
        r1 = min(r0 + block[0], r.grid.nrows)
        for c0 in range(0, r.grid.ncols, block[1]):
            c1 = min(c0 + block[1], r.grid.ncols)
            out[..., r0:r1, c0:c1] = fn(r.data[..., r0:r1, c0:c1], r.grid.subgrid(r0, r1, c0, c1))
    return Raster(out, r.grid, r.names)


def _window_in(r: Raster, target: GridSpec) -> tuple[int, int]:
    if not r.grid.aligned_with(target):
        raise ValueError("raster is not aligned with the target grid")
    row_off, col_off = r.grid.offsets_in(target)
    if (
        row_off < 0 or col_off < 0
        or row_off + r.grid.nrows > target.nrows
        or col_off + r.grid.ncols > target.ncols
    ):
        raise ValueError("raster does not fit inside target grid")
    return row_off, col_off


def mosaic(rasters: Sequence[Raster], target: GridSpec, fun: str = "mean") -> Raster:
    """Mosaic aligned rasters onto ``target``; NaN marks no-data.

    ``fun='mean'`` averages overlapping valid cells (terra ``mosaic(fun=
    'mean')``, V73:746); ``fun='first'`` keeps the first valid value.  Each
    raster is added into its window of the target, which gives the same
    values as ``extend``-ing every raster to the target first."""
    r0 = rasters[0]
    shape = tuple(r0.data.shape[:-2]) + target.shape
    dtype, device = r0.data.dtype, r0.data.device
    if fun == "mean":
        acc = torch.zeros(shape, dtype=dtype, device=device)
        cnt = torch.zeros(shape, dtype=dtype, device=device)
        for r in rasters:
            ro, co = _window_in(r, target)
            win = (..., slice(ro, ro + r.grid.nrows), slice(co, co + r.grid.ncols))
            valid = torch.isfinite(r.data)
            acc[win] += torch.where(valid, r.data, torch.zeros((), dtype=dtype, device=device))
            cnt[win] += valid.to(dtype)
        out = torch.where(cnt > 0, acc / cnt.clamp_min(1), torch.full((), float("nan"), dtype=dtype, device=device))
    elif fun == "first":
        out = torch.full(shape, float("nan"), dtype=dtype, device=device)
        for r in rasters:
            ro, co = _window_in(r, target)
            win = (..., slice(ro, ro + r.grid.nrows), slice(co, co + r.grid.ncols))
            out[win] = torch.where(torch.isfinite(out[win]), out[win], r.data)
    else:
        raise ValueError(f"mosaic: unknown fun {fun!r}")
    return Raster(out, target, r0.names)


def extract(r: Raster, x, y, fill=float("nan")) -> torch.Tensor:
    """Values of the cells containing points (terra ``extract``, V73:145).

    Cell indices are computed in float64 on the host.  Returns (n,) for a
    single band or (n, C) for a stack, on the raster's device; out-of-grid
    points yield ``fill``."""
    row, col = r.grid.rowcol_from_xy(x, y)
    g = r.grid
    inside = (row >= 0) & (row < g.nrows) & (col >= 0) & (col < g.ncols)
    dev = r.data.device
    rs = torch.as_tensor(np.clip(row, 0, g.nrows - 1), device=dev)
    cs = torch.as_tensor(np.clip(col, 0, g.ncols - 1), device=dev)
    vals = r.data[..., rs, cs]  # (n,) or (C, n)
    fill_t = torch.full((), fill, dtype=vals.dtype, device=dev)
    vals = torch.where(torch.as_tensor(inside, device=dev), vals, fill_t)
    return vals.T if vals.ndim == 2 else vals
