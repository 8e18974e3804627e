"""The port's host library (``csrc/host_native.cpp`` through ``io/native.py``)
against the JAX package's (``native/``) and the port's own plain paths, on
the CPU: strip decoding (deflate, LZW, predictor 2, uncompressed), the tile
plan, the host forest walk, and ``read_geotiff``'s native path bit for bit
against its pure-Python codec, with a corrupt strip raising on both."""
import struct
import zlib

import numpy as np
import pytest
import torch

from machisplin_tpu.io import native as jnative
from machisplin_tpu_torch.grid import GridSpec, Raster
from machisplin_tpu_torch.io import geotiff as tgeotiff, native as tnative
from machisplin_tpu_torch.models import trees as ttrees
from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig, _tps_tiles

from test_torch_forest_tables import random_forest
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)


def lzw_encode(data: bytes) -> bytes:
    """A minimal TIFF-LZW encoder (MSB-first codes; the code width grows
    once the table holds 2^width entries), for fewer than 3,800 bytes."""
    out, nbits, table, next_code = [], 9, {bytes([i]): i for i in range(256)}, 258
    out.append((256, nbits))
    w = b""
    for ch in data:
        wc = w + bytes([ch])
        if wc in table:
            w = wc
            continue
        out.append((table[w], nbits))
        table[wc] = next_code
        next_code += 1
        if next_code == (1 << nbits) and nbits < 12:
            nbits += 1
        w = bytes([ch])
    if w:
        out.append((table[w], nbits))
    out.append((257, nbits))
    bits = "".join(format(c, f"0{n}b") for c, n in out)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i : i + 8], 2) for i in range(0, len(bits), 8))


def _strips(data: np.ndarray, rps: int, encode):
    """(file bytes, offsets, counts, out offsets, out sizes) of ``data``'s
    rows in strips of ``rps``, each passed through ``encode``."""
    offs, cnts, oofs, sizes, pos, out_pos = [], [], [], [], 7, 0
    blob = b"\0" * pos
    for s in range(0, data.shape[0], rps):
        raw = data[s : s + rps].tobytes()
        enc = encode(raw)
        offs.append(pos)
        cnts.append(len(enc))
        oofs.append(out_pos)
        sizes.append(len(raw))
        blob += enc
        pos += len(enc)
        out_pos += len(raw)
    return blob, offs, cnts, oofs, sizes


def _byte_diff(a: np.ndarray) -> np.ndarray:
    """TIFF predictor 2 on one byte a sample: each row's differences."""
    d = a.copy()
    d[:, 1:] = a[:, 1:] - a[:, :-1]
    return d


CODECS = {
    "deflate": (8, zlib.compress),
    "lzw": (5, lzw_encode),
    "none": (1, lambda raw: raw),
}


@pytest.fixture(scope="module")
def libs():
    assert tnative.load_native() is not None, "the port's host library did not build"
    assert jnative.load_native() is not None, "the JAX package's native library is not built"


@pytest.mark.parametrize("codec", list(CODECS))
@pytest.mark.parametrize("predictor", [1, 2])
def test_decode_chunks_matches_jax(libs, codec, predictor):
    rng = np.random.default_rng(0)
    compression, encode = CODECS[codec]
    if predictor == 2:          # one byte a sample: the library undoes the differences
        data = rng.integers(0, 256, (29, 41), dtype=np.uint8)
        stored, sample_bytes = _byte_diff(data), 1
    else:
        data = rng.standard_normal((29, 41)).astype(np.float32)
        stored, sample_bytes = data, 4
    blob, offs, cnts, oofs, sizes = _strips(stored, 6, encode)
    args = (blob, offs, cnts, oofs, sizes, compression, predictor, data.shape[1] * data.itemsize, sample_bytes,
            sum(sizes))
    got = tnative.decode_chunks(*args)
    np.testing.assert_array_equal(got, jnative.decode_chunks(*args))
    np.testing.assert_array_equal(got.view(data.dtype).reshape(data.shape), data)


def test_decode_chunks_raises_on_a_corrupt_chunk(libs):
    data = np.arange(600, dtype=np.float32).reshape(20, 30)
    blob, offs, cnts, oofs, sizes = _strips(data, 5, zlib.compress)
    bad = bytearray(blob)
    bad[offs[2] : offs[2] + 6] = b"\xff" * 6
    with pytest.raises(ValueError, match="chunk 2"):
        tnative.decode_chunks(bytes(bad), offs, cnts, oofs, sizes, 8, 1, 120, 4, sum(sizes))


def test_tile_plan_matches_jax(libs):
    g = GridSpec(nrows=3100, ncols=4200, xmin=-77.7, ymax=-5.8, dx=0.001, dy=0.001)
    cfg = MLTPSConfig()
    args = (g.extent, g.nrows, g.ncols, cfg.tps_tile_px, cfg.tps_fit_overlap, cfg.tps_mosaic_overlap)
    got = tnative.tile_plan(*args)
    np.testing.assert_array_equal(got, jnative.tile_plan(*args))
    n_rx, n_cx, fit_exts, mosaic_exts = _tps_tiles(g, cfg)
    assert got.shape == (n_rx * n_cx, 8)
    np.testing.assert_allclose(got[:, :4], np.asarray(fit_exts), rtol=1e-12)
    np.testing.assert_allclose(got[:, 4:], np.asarray(mosaic_exts), rtol=1e-12)


def test_forest_predict_native_matches_plain(libs):
    """The host walk against the port's plain router (``trees.forest_predict``)
    on random best-first trees of 1-9 splits."""
    rng = np.random.default_rng(1)
    splits = rng.integers(1, 10, 40)
    tree, edges = random_forest(rng, splits, 5)
    x = rng.uniform(0, 1, (777, 5)).astype(np.float32)
    w = rng.uniform(0, 1, 40).astype(np.float32)
    w[3] = 0.0
    depth = int(splits.max())
    got = tnative.forest_predict_native(tree, x, depth, w)
    want = ttrees.forest_predict(tree, torch.as_tensor(x), depth, torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    # the JAX package's library is built with -march=native, which may fuse
    # the weighted sums' multiply-adds (the port's build does not)
    np.testing.assert_allclose(got, jnative.forest_predict_native(tree, x, depth, w), rtol=1e-6, atol=1e-6)


def _write(tmp_path, name, bands, **kw):
    rng = np.random.default_rng(2)
    g = GridSpec(nrows=300, ncols=200, xmin=0.0, ymax=1.0, dx=0.01, dy=0.01)
    data = rng.standard_normal((bands, 300, 200)).astype(np.float32)
    data[0, 5, 7] = np.nan
    path = str(tmp_path / name)
    tgeotiff.write_geotiff_file(path, Raster(torch.as_tensor(data[0] if bands == 1 else data), g), **kw)
    return path, data


def test_load_native_is_none_without_zlib_header(monkeypatch):
    """A compiler that finds no zlib.h is treated as no compiler: no
    library, and read_geotiff keeps its Python codec."""
    from machisplin_tpu_torch.kernels import build

    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setattr(tnative, "_TRIED", False)
    monkeypatch.setattr(build, "host_finds_header", lambda header: False)
    assert tnative.load_native() is None
    assert tnative.decode_chunks(b"", [], [], [], [], 8, 1, 0, 1, 0) is None


@pytest.mark.parametrize("bands,bigtiff", [(1, False), (3, False), (1, True)])
def test_read_geotiff_native_is_bit_identical(libs, tmp_path, monkeypatch, bands, bigtiff):
    path, data = _write(tmp_path, "a.tif", bands, bigtiff=bigtiff)
    calls = []
    decode = tnative.decode_chunks
    monkeypatch.setattr(tnative, "decode_chunks", lambda *a, **k: calls.append(1) or decode(*a, **k))
    native = tgeotiff.read_geotiff(path, device="cpu")
    assert calls, "read_geotiff did not take the native decoder"
    # without the library, read_geotiff decodes in Python
    monkeypatch.setattr(tnative, "load_native", lambda: None)
    plain = tgeotiff.read_geotiff(path, device="cpu")
    np.testing.assert_array_equal(native.data.numpy(), plain.data.numpy())
    np.testing.assert_array_equal(native.data.numpy(), data[0] if bands == 1 else data)
    assert native.grid == plain.grid


def test_read_geotiff_raises_on_a_corrupt_strip(libs, tmp_path, monkeypatch):
    path, _ = _write(tmp_path, "bad.tif", 1)
    with open(path, "rb") as f:
        raw = bytearray(f.read())
    # the first strip begins at the first StripOffsets entry
    (ifd,) = struct.unpack("<I", raw[4:8])
    (n_entries,) = struct.unpack("<H", raw[ifd : ifd + 2])
    offs = None
    for i in range(n_entries):
        tag, _, count, val = struct.unpack("<HHII", raw[ifd + 2 + 12 * i : ifd + 14 + 12 * i])
        if tag == 273:
            offs = val if count == 1 else struct.unpack("<I", raw[val : val + 4])[0]
    raw[offs : offs + 8] = b"\xff" * 8
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(ValueError, match="native TIFF decode failed"):
        tgeotiff.read_geotiff(path, device="cpu")
    monkeypatch.setattr(tnative, "load_native", lambda: None)
    with pytest.raises(zlib.error):
        tgeotiff.read_geotiff(path, device="cpu")
