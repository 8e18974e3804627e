"""Seam feathering: linear crossfade of overlapping tile rasters.

Counterpart of ``machisplin_tpu/ops/feather.py`` (mltps part 4, V73:756-896):
for each adjacent tile pair, crop both to their overlap strip, blend them with
linear 1->0 / 0->1 ramps across the strip built from cell-centre coordinates
(x for vertical seams, y for horizontal seams), then mosaic the strips (mean)
over the plain tile mosaic (mean), the strips taking precedence.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..grid import GridSpec, Raster, crop, mosaic

__all__ = ["crossfade", "feather_blend"]


def _intersection(a: GridSpec, b: GridSpec):
    xmin = max(a.xmin, b.xmin)
    xmax = min(a.xmax, b.xmax)
    ymin = max(a.ymin, b.ymin)
    ymax = min(a.ymax, b.ymax)
    if xmax - xmin <= a.dx / 2 or ymax - ymin <= a.dy / 2:
        return None
    return (xmin, xmax, ymin, ymax)


def crossfade(r1: Raster, r2: Raster, axis: str) -> Raster | None:
    """Linear blend of two overlapping rasters over their overlap strip.

    axis='x': ramp along longitude (vertical seam, V73:787-798); axis='y':
    ramp along latitude (horizontal seam, V73:855-865).  r1 weighs 1 at the
    strip's first column (x) or first row (y).  None when they do not overlap.
    """
    ext = _intersection(r1.grid, r2.grid)
    if ext is None:
        return None
    b1 = crop(r1, ext)
    b2 = crop(r2, ext)
    g = b1.grid
    dtype, dev = b1.data.dtype, b1.data.device
    if axis == "x":
        coord = g.x_coords(dtype, dev)[None, :]
    elif axis == "y":
        coord = g.y_coords(dtype, dev)[:, None]
    else:
        raise ValueError(axis)
    cmin, cmax = coord.min(), coord.max()
    t = (coord - cmin) / (cmax - cmin).clamp_min(1e-30)
    blended = b1.data * (1.0 - t) + b2.data * t
    return Raster(blended, g, r1.names)


def feather_blend(tiles: Sequence[Raster], n_rows: int, n_cols: int, target: GridSpec) -> Raster:
    """Feathered mosaic of a row-major (bottom-up) grid of overlapping tiles:
    vertical seams first, then horizontal seams; feathered strips mosaic
    with 'mean' and take precedence over the mean tile mosaic (V73:880-895)."""
    if len(tiles) != n_rows * n_cols:
        raise ValueError("tile count does not match layout")
    if len(tiles) == 1:
        return mosaic(tiles, target, fun="mean")
    strips = []
    for j in range(n_rows):
        for h in range(n_cols - 1):
            v = j * n_cols + h
            s = crossfade(tiles[v], tiles[v + 1], "x")
            if s is not None:
                strips.append(s)
    for j in range(n_rows - 1):
        for h in range(n_cols):
            v = j * n_cols + h
            # tiles run bottom-up: v + n_cols sits above v (stD1, V73:857)
            s = crossfade(tiles[v], tiles[v + n_cols], "y")
            if s is not None:
                strips.append(s)
    base = mosaic(tiles, target, fun="mean")
    if not strips:
        return base
    blended = mosaic(strips, target, fun="mean")
    out = torch.where(torch.isfinite(blended.data), blended.data, base.data)
    return Raster(out, target, base.names)
