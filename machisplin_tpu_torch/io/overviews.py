"""GeoTIFF overview pyramids (``.ovr`` sidecars) without GDAL (counterpart of
``machisplin_tpu/io/overviews.py``, numpy on the host; a raster on a card is
copied to the host first).

The reference's bundled covariates ship with GDAL overview sidecars
(``inst/extdata/alt.tif.ovr`` etc. — reduced-resolution copies GDAL builds
with ``gdaladdo`` so viewers can render 8M-cell rasters instantly).  terra's
writeRaster never emits them, so this is a completeness feature of the raster
substrate, not a parity requirement: :func:`write_overviews` produces a
``<path>.ovr`` that GDAL-based tools (QGIS, terra) pick up next to the ``.tif``
this package writes.

Format: a ``.ovr`` is an ordinary little-endian classic TIFF whose IFD chain
holds one reduced-resolution image per level (NewSubfileType = 1), finest
first — exactly what gdaladdo writes.  Levels are decimation factors relative
to the full raster; the default ladder doubles (2, 4, 8, ...) until the
coarsest level fits within ``min_size`` pixels on its longer side, matching
GDAL's convention.  Resampling is NaN-aware block averaging (GDAL's
``average`` with nodata handling): a coarse cell is the mean of its finite
fine cells, NaN only where the whole block is NaN.

The levels stay float32 + deflate strips so :func:`read_overview` (and GDAL)
round-trip them exactly.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

import torch

from ..grid import GridSpec, Raster
from ..utils import resolve_device
from .geotiff import _host, read_geotiff

__all__ = ["default_levels", "decimate", "write_overviews", "read_overview"]


def default_levels(grid: GridSpec, min_size: int = 256) -> list[int]:
    """GDAL-style ladder: powers of two while the coarser level's longer side
    is still >= ``min_size`` pixels (an 8M-cell 3264x2476 grid -> [2, 4, 8])."""
    levels = []
    f = 2
    while max(grid.nrows, grid.ncols) // f >= min_size:
        levels.append(f)
        f *= 2
    return levels


def decimate(data: np.ndarray, factor: int) -> np.ndarray:
    """NaN-aware ``factor``x``factor`` block mean of (H, W) or (C, H, W).

    Edge blocks average whatever fine cells exist (ceil semantics, like
    gdaladdo); a coarse cell is NaN only when every contributing fine cell
    is NaN.
    """
    a = _host(data)
    squeeze = a.ndim == 2
    if squeeze:
        a = a[None]
    c, h, w = a.shape
    ho, wo = math.ceil(h / factor), math.ceil(w / factor)
    pad_h, pad_w = ho * factor - h, wo * factor - w
    if pad_h or pad_w:
        a = np.pad(a, ((0, 0), (0, pad_h), (0, pad_w)), constant_values=np.nan)
    blocks = a.reshape(c, ho, factor, wo, factor)
    finite = np.isfinite(blocks)
    counts = finite.sum(axis=(2, 4))
    sums = np.where(finite, blocks, 0.0).sum(axis=(2, 4), dtype=np.float64)
    with np.errstate(invalid="ignore"):
        out = np.where(counts > 0, sums / np.maximum(counts, 1), np.nan)
    out = out.astype(np.float32)
    return out[0] if squeeze else out


def _level_ifd(arr: np.ndarray, compress: bool):
    """Serialise one overview level -> (tag list, strip payloads)."""
    if arr.ndim == 2:
        arr = arr[None]
    nbands, h, w = arr.shape
    rows_per_strip = max(1, min(h, (1 << 20) // max(w * 4 * nbands, 1)))
    chunky = np.moveaxis(arr, 0, -1).reshape(h, w * nbands)
    strips = []
    for s in range(0, h, rows_per_strip):
        raw = np.ascontiguousarray(chunky[s : s + rows_per_strip], np.float32).tobytes()
        strips.append(zlib.compress(raw, 6) if compress else raw)
    tags = [
        (254, 4, [1]),                 # NewSubfileType: reduced-resolution image
        (256, 3, [w]),
        (257, 3, [h]),
        (258, 3, [32] * nbands),
        (259, 3, [8 if compress else 1]),
        (262, 3, [1]),
        (277, 3, [nbands]),
        (278, 3, [rows_per_strip]),
        (284, 3, [1]),
        (339, 3, [3] * nbands),
    ]
    return tags, strips


def write_overviews(
    path: str,
    raster: Raster,
    levels: list[int] | None = None,
    compress: bool = True,
    min_size: int = 256,
) -> str | None:
    """Write ``<path>.ovr`` with NaN-aware averaged pyramids of ``raster``.

    ``path`` is the ``.tif`` the sidecar belongs to.  Returns the ``.ovr``
    path, or None when the raster is already at or below ``min_size`` (GDAL
    likewise builds nothing).  Successive levels decimate the PREVIOUS level
    (2x each step) rather than the full raster, so an 8M-cell pyramid costs
    ~1.33x one pass.
    """
    if levels is None:
        levels = default_levels(raster.grid, min_size)
    if not levels:
        return None
    if sorted(levels) != levels or any(f < 2 for f in levels):
        raise ValueError(f"levels must be increasing factors >= 2, got {levels}")

    data = _host(raster.data)
    arrays = []
    prev, prev_f = data, 1
    for f in levels:
        step = f // prev_f if f % prev_f == 0 else 0
        if step >= 2 and prev_f * step == f:
            prev = decimate(prev, step)      # refine from the previous level
        else:
            prev = decimate(data, f)         # non-dyadic ladder: from full res
        prev_f = f
        arrays.append(prev)

    endian = "<"
    ovr_path = path + ".ovr"
    with open(ovr_path, "wb") as fobj:
        fobj.write(struct.pack(f"{endian}2sHI", b"II", 42, 8))
        next_ifd_pos = 4  # file offset of the pointer to the next IFD
        pos = 8
        fobj.seek(pos)
        for arr in arrays:
            tags, strips = _level_ifd(arr, compress)
            # strip tables now that this IFD's layout is computable
            n_entries = len(tags) + 2
            ifd_size = 2 + n_entries * 12 + 4
            ext_base = pos + ifd_size

            all_tags = dict((t, (tt, v)) for t, tt, v in tags)
            n_strips = len(strips)

            def payload_bytes(ttype, vals):
                fmt = {3: "H", 4: "I"}[ttype]
                return struct.pack(f"{endian}{len(vals)}{fmt}", *vals)

            # measure out-of-line payload space so strip offsets are known
            # before the entries are serialised (strip tables included: they
            # go out-of-line whenever n_strips > 1, inline when == 1)
            fixed_ext = 0
            for t in sorted(all_tags):
                ttype, vals = all_tags[t]
                raw = payload_bytes(ttype, vals)
                if len(raw) > 4:
                    fixed_ext += len(raw) + (len(raw) % 2)
            table_bytes = n_strips * 4
            data_base = ext_base + fixed_ext + (2 * table_bytes if n_strips > 1 else 0)

            offsets, counts, acc = [], [], data_base
            for s in strips:
                offsets.append(acc)
                counts.append(len(s))
                acc += len(s) + (len(s) % 2)

            entries = []
            ext = bytearray()
            for t in sorted(list(all_tags) + [273, 279]):
                if t == 273:
                    ttype, vals = 4, offsets
                elif t == 279:
                    ttype, vals = 4, counts
                else:
                    ttype, vals = all_tags[t]
                raw = payload_bytes(ttype, vals)
                head = struct.pack(f"{endian}HHI", t, ttype, len(vals))
                if len(raw) <= 4:
                    entries.append(head + raw + b"\x00" * (4 - len(raw)))
                else:
                    entries.append(head + struct.pack(f"{endian}I", ext_base + len(ext)))
                    ext += raw + (b"\x00" if len(raw) % 2 else b"")

            # patch the previous IFD pointer to this IFD
            fobj.seek(next_ifd_pos)
            fobj.write(struct.pack(f"{endian}I", pos))
            fobj.seek(pos)
            fobj.write(struct.pack(f"{endian}H", n_entries))
            for e in entries:
                fobj.write(e)
            next_ifd_pos = fobj.tell()
            fobj.write(struct.pack(f"{endian}I", 0))
            fobj.write(bytes(ext))
            for s in strips:
                fobj.write(s)
                if len(s) % 2:
                    fobj.write(b"\x00")
            pos = fobj.tell()
        # final next-IFD pointer already zero
    return ovr_path


def read_overview(tif_path: str, level_index: int = 0, device="cuda") -> Raster:
    """Read the ``level_index``-th overview from ``<tif_path>.ovr`` onto
    ``device``.

    Grid georeferencing is reconstructed from the base ``.tif``'s GridSpec
    scaled by the level's decimation factor (the ``.ovr`` itself carries no
    geo tags, per GDAL convention).
    """
    dev = resolve_device(device)
    base = read_geotiff(tif_path, device="cpu")
    ovr_path = tif_path + ".ovr"
    endian_map = {b"II": "<", b"MM": ">"}
    with open(ovr_path, "rb") as f:
        buf = f.read()
    endian = endian_map.get(buf[:2])
    if endian is None or struct.unpack(f"{endian}H", buf[2:4])[0] != 42:
        raise ValueError(f"{ovr_path}: not a classic TIFF")
    (ifd_off,) = struct.unpack(f"{endian}I", buf[4:8])
    for _ in range(level_index):
        (n,) = struct.unpack(f"{endian}H", buf[ifd_off : ifd_off + 2])
        (ifd_off,) = struct.unpack(
            f"{endian}I", buf[ifd_off + 2 + n * 12 : ifd_off + 2 + n * 12 + 4]
        )
        if ifd_off == 0:
            raise IndexError(f"{ovr_path}: no overview level {level_index}")
    (n,) = struct.unpack(f"{endian}H", buf[ifd_off : ifd_off + 2])
    tags = {}
    for i in range(n):
        off = ifd_off + 2 + i * 12
        tag, ttype, count = struct.unpack(f"{endian}HHI", buf[off : off + 8])
        fmt = {3: "H", 4: "I"}[ttype]
        size = count * struct.calcsize(fmt)
        raw = buf[off + 8 : off + 8 + size] if size <= 4 else None
        if raw is None:
            (voff,) = struct.unpack(f"{endian}I", buf[off + 8 : off + 12])
            raw = buf[voff : voff + size]
        tags[tag] = list(struct.unpack(f"{endian}{count}{fmt}", raw))
    w, h = tags[256][0], tags[257][0]
    nbands = tags.get(277, [1])[0]
    rps = tags.get(278, [h])[0]
    compression = tags.get(259, [1])[0]
    out = np.zeros((h, w * nbands), np.float32)
    for s, (o, c) in enumerate(zip(tags[273], tags[279])):
        raw = buf[o : o + c]
        if compression in (8, 32946):
            raw = zlib.decompress(raw)
        rows = min(rps, h - s * rps)
        out[s * rps : s * rps + rows] = np.frombuffer(raw, np.float32).reshape(
            rows, w * nbands
        )
    data = np.moveaxis(out.reshape(h, w, nbands), -1, 0)
    fy = base.grid.nrows / h
    fx = base.grid.ncols / w
    grid = GridSpec(
        nrows=h, ncols=w, xmin=base.grid.xmin, ymax=base.grid.ymax,
        dx=base.grid.dx * fx, dy=base.grid.dy * fy, crs=base.grid.crs,
    )
    data = np.ascontiguousarray(data[0] if nbands == 1 else data)
    return Raster(torch.from_numpy(data).to(dev), grid)
