"""Tiling toolkit — machisplin.tiles.{create,id,merge} equivalents
(counterpart of ``machisplin_tpu/pipeline/tiles.py``).

``tiles_create`` (V73:1165-1256) splits a covariate stack into an
out_nrow x out_ncol grid of overlapping tiles (overlap = feather_d/2 pixels
per side) and crops the station table per tile; tiles are ordered row-major
from the bottom-left, exactly like the reference's extent loop.

``tiles_id`` (V73:1289-1292) returns the tile layout (extents + centers +
ids) for plotting/bookkeeping instead of drawing an R plot.

Extents and the station subsets are computed in float64 on the host, as in
the JAX package; each tile's covariates stay on the input's device.

``tiles_merge`` (V73:1392-1548) feathers the per-tile result rasters over
their overlap strips and mosaics them to the full extent (linear crossfade +
mean mosaic + first-precedence overlay, shared with mltps part 4 via
ops/feather), on the tiles' device.  The reference's ``nRx*nCx==2``
branch reads an undefined variable (V73:1542-1543) — here two-tile layouts
just use the general path.

Note: the reference's tiles.create reads the station table from a global
``Mydata`` instead of its argument (V73:1229); this implementation uses the
argument.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from ..grid import GridSpec, Raster, crop
from ..ops.feather import feather_blend
from ..parallel.sharded import on_rank0

__all__ = ["TileSet", "tiles_create", "tiles_id", "tiles_merge"]


@dataclasses.dataclass
class TileSet:
    rast: list[Raster]           # per-tile covariate stacks
    dat: list[np.ndarray]        # per-tile station tables (structured arrays)
    n_cols: int
    n_rows: int
    extents: list[tuple[float, float, float, float]]
    ids: list[int]               # 1-based, row-major from bottom-left
    centers: list[tuple[float, float]]
    full_grid: GridSpec


def tiles_create(
    rast_in: Raster,
    int_values,
    out_ncol: int = 3,
    out_nrow: int = 3,
    feather_d: int = 50,
) -> TileSet:
    g = rast_in.grid
    half = feather_d / 2.0
    xmin, xmax, ymin, ymax = g.extent
    long_dist = (xmax - xmin) / out_ncol
    lat_dist = (ymax - ymin) / out_nrow
    long_pix, lat_pix = g.dx, g.dy

    arr = np.asarray(int_values)
    if not arr.dtype.names:
        raise ValueError("int_values must be a structured array (long, lat, ...)")
    lon = arr[arr.dtype.names[0]]
    lat = arr[arr.dtype.names[1]]

    rasters, dats, extents, ids, centers = [], [], [], [], []
    tid = 0
    for j in range(1, out_nrow + 1):
        for h in range(1, out_ncol + 1):
            tid += 1
            ext = (
                xmin + long_dist * (h - 1) - long_pix * half,
                xmin + long_dist * h + long_pix * half,
                ymin + lat_dist * (j - 1) - lat_pix * half,
                ymin + lat_dist * j + lat_pix * half,
            )
            rasters.append(crop(rast_in, ext))
            inside = (lon >= ext[0]) & (lon <= ext[1]) & (lat >= ext[2]) & (lat <= ext[3])
            dats.append(arr[inside])
            extents.append(ext)
            ids.append(tid)
            centers.append(((ext[0] + ext[1]) / 2, (ext[2] + ext[3]) / 2))
    return TileSet(
        rast=rasters, dat=dats, n_cols=out_ncol, n_rows=out_nrow,
        extents=extents, ids=ids, centers=centers, full_grid=g,
    )


def tiles_id(tiles: TileSet, plot: bool = False, save_path: str | None = None, mesh=None) -> list[dict]:
    """Tile ordering info; the reference plots tile polygons with red id
    numbers (V73:1289-1292) so users order per-tile results for tiles_merge.
    ``plot=True`` (or ``save_path``) draws the same diagram via matplotlib,
    imported here, when it is installed; the layout data is always
    returned.  With a device ``mesh`` rank 0 draws and saves it."""
    if mesh is not None:
        return on_rank0(mesh, tiles_id, tiles, plot, save_path)
    info = [
        {"id": i, "center": c, "extent": e}
        for i, c, e in zip(tiles.ids, tiles.centers, tiles.extents)
    ]
    if plot or save_path:
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:  # pragma: no cover
            return info
        fig, ax = plt.subplots(figsize=(6, 6))
        for t in info:
            xmin, xmax, ymin, ymax = t["extent"]
            ax.add_patch(
                plt.Rectangle((xmin, ymin), xmax - xmin, ymax - ymin,
                              fill=False, edgecolor="black")
            )
            ax.text(*t["center"], str(t["id"]), color="red", fontsize=18,
                    ha="center", va="center")
        g = tiles.full_grid
        ax.set_xlim(g.xmin - g.dx, g.xmax + g.dx)
        ax.set_ylim(g.ymin - g.dy, g.ymax + g.dy)
        ax.set_xlabel("longitude")
        ax.set_ylabel("latitude")
        if save_path:
            fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    return info


def tiles_merge(
    rast_in: Sequence[Raster],
    rast_full_ext: GridSpec | Raster,
    in_ncol: int = 2,
    in_nrow: int = 3,
) -> Raster:
    """Feather + mosaic per-tile finals onto the full grid (V73:1392-1548)."""
    target = rast_full_ext.grid if isinstance(rast_full_ext, Raster) else rast_full_ext
    if len(rast_in) != in_ncol * in_nrow:
        raise ValueError(
            f"expected {in_ncol * in_nrow} tiles (in_ncol={in_ncol} x in_nrow={in_nrow}), "
            f"got {len(rast_in)}"
        )
    return feather_blend(list(rast_in), in_nrow, in_ncol, target)
