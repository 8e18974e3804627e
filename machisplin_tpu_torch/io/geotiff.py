"""GeoTIFF read/write without GDAL (counterpart of ``machisplin_tpu/io/geotiff.py``).

The reference leans on terra/GDAL for raster I/O (terra::writeRaster V73:1011,
rast() in every example).  This module is a copy of the JAX package's
pure-Python codec (struct, zlib, numpy), with rasters as torch tensors:

* writer: single- or multi-band float32 GeoTIFF, strip layout, optional
  deflate compression, ModelPixelScale + ModelTiepoint + a WGS84 GeoKey
  directory, GDAL_NODATA tag (NaN encoded as 'nan'); BigTIFF is selected
  automatically once the payload could cross the classic 4 GB offset limit,
  and a streaming variant writes row blocks without materialising the full
  array.  Raster data on a card is copied to the host to be written;
* reader: classic TIFF and BigTIFF (little/big endian), strip or tile layout,
  compression none/deflate/LZW (+ horizontal-differencing predictor), integer
  and float sample formats, GDAL_NODATA mapped to NaN; the Raster comes back
  on the requested device.

For the same array and grid the files are byte for byte the JAX package's.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

from ..grid import GridSpec, Raster, WGS84
from ..utils import resolve_device

__all__ = ["read_geotiff", "write_geotiff_file", "write_geotiff_stream"]

_TYPE_SIZES = {
    1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4, 10: 8, 11: 4, 12: 8,
    16: 8, 17: 8,
}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f", 12: "d", 16: "Q", 17: "q"}

# classic-TIFF offsets are u32; leave headroom for the IFD + tag payloads
_CLASSIC_LIMIT = (1 << 32) - (1 << 16)


def _host(data) -> np.ndarray:
    """float32 numpy copy of raster data (a tensor on any device, or an array)."""
    if torch.is_tensor(data):
        data = data.detach().cpu().numpy()
    return np.asarray(data, np.float32)


def write_geotiff_file(
    path: str,
    raster: Raster,
    compress: bool = True,
    nodata_nan: bool = True,
    bigtiff: bool | None = None,
):
    """Write a Raster as a float32 GeoTIFF (strip layout, optional deflate).

    ``bigtiff=None`` auto-selects BigTIFF when the uncompressed payload could
    exceed the classic format's 4 GB offset space (terra::writeRaster's GDAL
    backend does the same via IF_SAFER)."""
    data = _host(raster.data)
    if data.ndim == 2:
        data = data[None]
    nbands, h, w = data.shape
    rows_per_strip = max(1, min(h, (1 << 20) // max(w * 4 * nbands, 1)))
    chunky = np.moveaxis(data, 0, -1).reshape(h, w * nbands)  # pixel-interleaved

    def blocks():
        for s in range(0, h, rows_per_strip):
            yield chunky[s : s + rows_per_strip]

    write_geotiff_stream(
        path, raster.grid, blocks(), nbands=nbands, compress=compress,
        nodata_nan=nodata_nan, bigtiff=bigtiff, rows_per_strip=rows_per_strip,
    )


def write_geotiff_stream(
    path: str,
    grid: GridSpec,
    row_blocks,
    nbands: int = 1,
    compress: bool = True,
    nodata_nan: bool = True,
    bigtiff: bool | None = None,
    rows_per_strip: int | None = None,
    sparse_ok: bool = False,
):
    """Stream a float32 GeoTIFF strip by strip without holding the array.

    ``row_blocks`` yields consecutive row blocks of exactly
    ``rows_per_strip`` rows each (the last may be short), shaped (rows, W)
    for one band or (rows, W, nbands) / (rows, W*nbands) interleaved.  The
    header and IFD are written up front with placeholder strip tables that
    are patched in place once every strip's offset and byte count is known —
    so a 10^9-cell surface streams straight from the prediction loop to disk.

    ``sparse_ok`` (GDAL's SPARSE_OK analog, uncompressed only): all-zero
    strips are seeked over instead of written, leaving filesystem holes —
    zero-dominated outputs (ocean masks, empty TPS tiles) cost no disk
    bandwidth and read back as zeros through the normal strip tables.
    """
    g = grid
    h, w = g.nrows, g.ncols
    endian = "<"
    if rows_per_strip is None:
        rows_per_strip = max(1, min(h, (1 << 20) // max(w * 4 * nbands, 1)))
    n_strips = math.ceil(h / rows_per_strip)
    if bigtiff is None:
        # auto: compressed strips may legally exceed raw size only by a hair;
        # decide on the raw payload either way
        bigtiff = h * w * nbands * 4 >= _CLASSIC_LIMIT

    geo_keys = [
        (1, 1, 0, 4),        # version, revision, minor, number of keys
        (1024, 0, 1, 2),     # GTModelTypeGeoKey = geographic
        (1025, 0, 1, 1),     # GTRasterTypeGeoKey = PixelIsArea
        (2048, 0, 1, 4326),  # GeographicTypeGeoKey = WGS84
        (2054, 0, 1, 9102),  # GeogAngularUnitsGeoKey = degree
    ]
    tags = [
        (256, 3, w),
        (257, 3, h),
        (258, 3, [32] * nbands),
        (259, 3, 8 if compress else 1),
        (262, 3, 1),
        (277, 3, nbands),
        (278, 3, rows_per_strip),
        (284, 3, 1),
        (339, 3, [3] * nbands),
        (33550, 12, [g.dx, g.dy, 0.0]),
        (33922, 12, [0.0, 0.0, 0.0, g.xmin, g.ymax, 0.0]),
        (34735, 3, [v for row in geo_keys for v in row]),
        (34737, 2, b"WGS 84|\x00"),
    ]
    if nodata_nan:
        tags.append((42113, 2, b"nan\x00"))

    # serialise tag payloads
    payloads = {}
    for tag, ttype, vals in tags:
        if isinstance(vals, (bytes, bytearray)):
            raw, count = bytes(vals), len(vals)
        else:
            v = list(vals) if isinstance(vals, (list, tuple)) else [vals]
            count = len(v)
            raw = struct.pack(f"{endian}{count}{_TYPE_FMT[ttype]}", *v)
        payloads[tag] = (ttype, count, raw)

    # strip tables as placeholders, patched after the strips are written
    off_type = 16 if bigtiff else 4
    off_fmt = "Q" if bigtiff else "I"
    payloads[273] = (off_type, n_strips, b"\x00" * (n_strips * (8 if bigtiff else 4)))
    payloads[279] = (off_type, n_strips, b"\x00" * (n_strips * (8 if bigtiff else 4)))

    inline = 8 if bigtiff else 4
    entry_size = 20 if bigtiff else 12
    header_size = 16 if bigtiff else 8
    n_entries = len(payloads)
    ifd_size = (8 + n_entries * entry_size + 8) if bigtiff else (2 + n_entries * 12 + 4)

    entries = []
    ext = bytearray()
    ext_base = header_size + ifd_size
    ifd_entries_base = header_size + (8 if bigtiff else 2)
    patch_pos = {}  # tag -> absolute file position of its value bytes
    for i, tag in enumerate(sorted(payloads)):
        ttype, count, raw = payloads[tag]
        if bigtiff:
            head = struct.pack(f"{endian}HHQ", tag, ttype, count)
        else:
            head = struct.pack(f"{endian}HHI", tag, ttype, count)
        if len(raw) <= inline:
            entries.append(head + raw + b"\x00" * (inline - len(raw)))
            patch_pos[tag] = ifd_entries_base + i * entry_size + len(head)
        else:
            pos = ext_base + len(ext)
            entries.append(head + struct.pack(f"{endian}{off_fmt}", pos))
            patch_pos[tag] = pos
            ext += raw + (b"\x00" if len(raw) % 2 else b"")

    with open(path, "wb") as f:
        if bigtiff:
            f.write(struct.pack(f"{endian}2sHHHQ", b"II", 43, 8, 0, 16))
            f.write(struct.pack(f"{endian}Q", len(entries)))
        else:
            f.write(struct.pack(f"{endian}2sHI", b"II", 42, 8))
            f.write(struct.pack(f"{endian}H", len(entries)))
        for e in entries:
            f.write(e)
        f.write(struct.pack(f"{endian}{off_fmt}", 0))  # next IFD
        f.write(bytes(ext))

        offsets, counts = [], []
        rows_seen = 0
        for blk in row_blocks:
            blk = _host(blk)
            if blk.ndim == 3:
                blk = blk.reshape(blk.shape[0], -1)
            rows_seen += blk.shape[0]
            offsets.append(f.tell())
            if sparse_ok and not compress and not blk.any():
                size = blk.size * 4
                counts.append(size)
                f.seek(size, 1)  # hole: the filesystem serves zeros
                continue
            raw = blk.tobytes()
            s = zlib.compress(raw, 6) if compress else raw
            counts.append(len(s))
            f.write(s)
        end_pos = f.tell()
        if rows_seen != h or len(offsets) != n_strips:
            raise ValueError(
                f"row_blocks yielded {rows_seen} rows / {len(offsets)} strips; "
                f"expected {h} rows / {n_strips} strips of {rows_per_strip}"
            )
        if not bigtiff and (offsets[-1] + counts[-1] if offsets else 0) > (1 << 32) - 1:
            raise ValueError(
                "output exceeds the classic-TIFF 4 GB offset limit; "
                "pass bigtiff=True (or bigtiff=None for auto-selection)"
            )
        f.seek(patch_pos[273])
        f.write(struct.pack(f"{endian}{n_strips}{off_fmt}", *offsets))
        f.seek(patch_pos[279])
        f.write(struct.pack(f"{endian}{n_strips}{off_fmt}", *counts))
        f.truncate(end_pos)  # extend over a trailing hole strip


def _lzw_decode(data: bytes) -> bytes:
    """TIFF LZW (MSB-first, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = None
    bitpos = 0
    nbits = 9
    prev = None
    total_bits = len(data) * 8

    def read_code():
        nonlocal bitpos
        if bitpos + nbits > total_bits:
            return EOI
        byte0 = bitpos // 8
        chunk = int.from_bytes(data[byte0 : byte0 + 4].ljust(4, b"\x00"), "big")
        code = (chunk >> (32 - (bitpos % 8) - nbits)) & ((1 << nbits) - 1)
        bitpos += nbits
        return code

    while True:
        code = read_code()
        if code == EOI:
            break
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            nbits = 9
            prev = None
            continue
        if table is None:
            raise ValueError("LZW stream missing clear code")
        if prev is None:
            entry = table[code]
        elif code < len(table):
            entry = table[code]
            table.append(prev + entry[:1])
        else:
            entry = prev + prev[:1]
            table.append(entry)
        out += entry
        prev = entry
        if len(table) + 1 >= (1 << nbits) and nbits < 12:
            nbits += 1
    return bytes(out)


def read_geotiff(path: str, band: int | None = None, device="cuda") -> Raster:
    """Read a GeoTIFF into a Raster on ``device`` (``band``: one band of a
    multi-band file).  Strips decode in the host library's threaded decoder
    (``io/native.py``) where it is built, else in Python; both give the
    same bytes, and a strip that fails to decode raises either way."""
    dev = resolve_device(device)
    # mmap, not read(): pages fault in as they are touched, so structural
    # parsing and the uncompressed path never read strips they do not use
    import mmap as _mmap

    with open(path, "rb") as f:
        try:
            # the mapping outlives the fd; frombuffer views keep it alive
            buf = _mmap.mmap(f.fileno(), 0, access=_mmap.ACCESS_READ)
        except (ValueError, OSError):  # empty file / exotic fs: fall back
            buf = f.read()
    endian = {b"II": "<", b"MM": ">"}.get(bytes(buf[:2]))
    magic = struct.unpack(f"{endian}H", buf[2:4])[0] if endian else 0
    if endian is None or magic not in (42, 43):
        raise ValueError(f"{path}: not a TIFF/BigTIFF")
    big = magic == 43
    if big:
        offsize, zero = struct.unpack(f"{endian}HH", buf[4:8])
        if offsize != 8 or zero != 0:
            raise ValueError(f"{path}: unsupported BigTIFF offset size {offsize}")
        (ifd_off,) = struct.unpack(f"{endian}Q", buf[8:16])
        (n_entries,) = struct.unpack(f"{endian}Q", buf[ifd_off : ifd_off + 8])
        entries_base, entry_size, inline, count_fmt = ifd_off + 8, 20, 8, "HHQ"
    else:
        (ifd_off,) = struct.unpack(f"{endian}I", buf[4:8])
        (n_entries,) = struct.unpack(f"{endian}H", buf[ifd_off : ifd_off + 2])
        entries_base, entry_size, inline, count_fmt = ifd_off + 2, 12, 4, "HHI"
    tags = {}
    for i in range(n_entries):
        off = entries_base + i * entry_size
        head = entry_size - inline
        tag, ttype, count = struct.unpack(f"{endian}{count_fmt}", buf[off : off + head])
        size = _TYPE_SIZES.get(ttype, 1) * count
        if size <= inline:
            raw = buf[off + head : off + head + size]
        else:
            (voff,) = struct.unpack(
                f"{endian}{'Q' if big else 'I'}", buf[off + head : off + entry_size]
            )
            raw = buf[voff : voff + size]
        if ttype == 2:
            tags[tag] = raw.rstrip(b"\x00").decode("latin-1")
        elif ttype in _TYPE_FMT:
            tags[tag] = list(struct.unpack(f"{endian}{count}{_TYPE_FMT[ttype]}", raw))
        elif ttype == 5:  # rational
            v = struct.unpack(f"{endian}{2 * count}I", raw)
            tags[tag] = [v[2 * j] / max(v[2 * j + 1], 1) for j in range(count)]
        else:
            tags[tag] = raw

    w = int(tags[256][0])
    h = int(tags[257][0])
    spp = int(tags.get(277, [1])[0])
    bps = tags.get(258, [1] * spp)
    fmt = tags.get(339, [1] * spp)
    compression = int(tags.get(259, [1])[0])
    predictor = int(tags.get(317, [1])[0])
    planar = int(tags.get(284, [1])[0])
    if planar != 1 and spp > 1:
        raise NotImplementedError("planar configuration 2 not supported")

    kind = {1: "u", 2: "i", 3: "f"}[int(fmt[0])]
    dtype = np.dtype(f"{endian}{kind}{int(bps[0]) // 8}")

    def decode(raw):
        if compression == 1:
            return raw
        if compression in (8, 32946):
            return zlib.decompress(raw)
        if compression == 5:
            return _lzw_decode(raw)
        raise NotImplementedError(f"TIFF compression {compression}")

    # uncompressed strips laid out back to back are one contiguous pixel
    # run: view it straight from the mapped file
    if 322 not in tags and compression == 1 and predictor == 1:
        offs = np.asarray(tags[273], np.int64)
        cnts = np.asarray(tags[279], np.int64)
        if len(offs) and np.all(offs[1:] == offs[:-1] + cnts[:-1]):
            out = np.frombuffer(
                buf, dtype, count=h * w * spp, offset=int(offs[0])
            ).reshape(h, w, spp)
            return _finish_read(out, tags, h, w, spp, band, dev)

    # strips through the host library's decoder; its predictor-2 pass runs
    # over the bytes of a row, which is right for one 8-bit sample a pixel
    # and for wider samples (undone below), not for 8-bit interleaved ones
    byte_samples = predictor == 2 and dtype.itemsize == 1 and spp > 1
    if 322 not in tags and compression in (1, 5, 8, 32946) and not byte_samples:
        from .native import decode_chunks

        rps = int(tags.get(278, [h])[0])
        offs = np.asarray(tags[273], np.int64)
        cnts = np.asarray(tags[279], np.int64)
        row_bytes = w * spp * dtype.itemsize
        sizes = np.asarray([min(rps, h - s * rps) * row_bytes for s in range(len(offs))], np.int64)
        oofs = np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64)
        blob = decode_chunks(buf, offs, cnts, oofs, sizes, compression, predictor, row_bytes, dtype.itemsize,
                             int(sizes.sum()))
        if blob is not None:
            out = np.frombuffer(blob, dtype)[: h * w * spp].reshape(h, w, spp)
            if predictor == 2 and dtype.itemsize != 1:
                out = np.cumsum(out, axis=1, dtype=dtype)
            return _finish_read(out, tags, h, w, spp, band, dev)

    out = np.zeros((h, w, spp), dtype)
    if 322 in tags:  # tiled
        tw, th = int(tags[322][0]), int(tags[323][0])
        offs, cnts = tags[324], tags[325]
        tiles_across = math.ceil(w / tw)
        for t, (o, c) in enumerate(zip(offs, cnts)):
            arr = np.frombuffer(decode(buf[int(o) : int(o) + int(c)]), dtype)
            arr = arr.reshape(th, tw, spp)
            if predictor == 2:
                arr = np.cumsum(arr, axis=1, dtype=dtype)
            r0 = (t // tiles_across) * th
            c0 = (t % tiles_across) * tw
            out[r0 : r0 + th, c0 : c0 + tw] = arr[: h - r0, : w - c0]
    else:  # strips
        rps = int(tags.get(278, [h])[0])
        offs, cnts = tags[273], tags[279]
        for s, (o, c) in enumerate(zip(offs, cnts)):
            r0 = s * rps
            rows = min(rps, h - r0)
            arr = np.frombuffer(decode(buf[int(o) : int(o) + int(c)]), dtype)
            arr = arr[: rows * w * spp].reshape(rows, w, spp)
            if predictor == 2:
                arr = np.cumsum(arr, axis=1, dtype=dtype)
            out[r0 : r0 + rows] = arr

    return _finish_read(out, tags, h, w, spp, band, dev)


def _finish_read(out, tags, h, w, spp, band, dev):
    data = np.moveaxis(out, -1, 0)
    if data.dtype != np.float32:
        data = data.astype(np.float32)
    nodata = tags.get(42113)
    if nodata is not None:
        try:
            nd = float(nodata)
            if not math.isnan(nd):
                if not data.flags.writeable:
                    data = data.copy()
                data[data == nd] = np.nan
        except ValueError:
            pass

    scale = tags.get(33550, [1.0, 1.0, 0.0])
    tie = tags.get(33922, [0, 0, 0, 0.0, 0.0, 0.0])
    dx, dy = float(scale[0]), float(scale[1])
    xmin = float(tie[3]) - float(tie[0]) * dx
    ymax = float(tie[4]) + float(tie[1]) * dy
    grid = GridSpec(nrows=h, ncols=w, xmin=xmin, ymax=ymax, dx=dx, dy=abs(dy), crs=WGS84)
    data = data[band] if band is not None else (data[0] if spp == 1 else data)
    if not data.flags.writeable:     # a view into the mapped file
        data = data.copy()
    return Raster(torch.from_numpy(data).to(dev), grid)
