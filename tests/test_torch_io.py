"""Parity of the port's I/O (``io/``: the GeoTIFF codec, overviews, the
output writers, checkpoints) and run log with the JAX package, on the CPU.

For the same array, grid and results both packages must write the same
files byte for byte: GeoTIFFs (deflate and raw strips, classic and forced
BigTIFF, one band and three), ``.ovr`` overview pyramids, the summary CSV
(the same ``seed``), the residual CSV and the loadings text.  Each
package's reader must read the other's file exactly (NaN where NaN), and a
checkpoint saved by either package must load in the other's
``load_layer`` with every array equal.
"""
import filecmp
import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import machisplin_tpu as mt
import machisplin_tpu_torch as mtt
from machisplin_tpu.io import checkpoint as jck, overviews as jovr
from machisplin_tpu.pipeline.mltps import LayerResult as JLayer
from machisplin_tpu_torch.io import checkpoint as tck, overviews as tovr
from machisplin_tpu_torch.pipeline.mltps import LayerResult as TLayer
from machisplin_tpu_torch.utils.logging import banner, run_log
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """These shapes are tiny: one intra-op thread, so that the CPU's other
    processes do not make torch's thread pool wait on them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


GRID = dict(nrows=37, ncols=53, xmin=-77.7435765934, ymax=-5.8094167820, dx=0.0008333333 * 8,
            dy=0.0008333333 * 8)


def _array(bands, seed=0):
    rng = np.random.default_rng(seed)
    a = (rng.standard_normal((bands, GRID["nrows"], GRID["ncols"])) * 100).astype(np.float32)
    a[:, 3, 5:9] = np.nan
    return a[0] if bands == 1 else a


def _rasters(a):
    return (mt.Raster(jnp.asarray(a), mt.GridSpec(**GRID)),
            mtt.Raster(torch.as_tensor(a), mtt.GridSpec(**GRID)))


def _same_raster(got, want_data, grid):
    np.testing.assert_array_equal(np.asarray(got.data), want_data)     # NaN where NaN
    assert got.grid.shape == (grid["nrows"], grid["ncols"])
    for k in ("xmin", "ymax", "dx", "dy"):
        assert getattr(got.grid, k) == pytest.approx(grid[k], rel=1e-15, abs=1e-15)


@pytest.mark.parametrize("bands", [1, 3])
@pytest.mark.parametrize("kind", ["deflate", "raw", "bigtiff"])
def test_geotiff_bytes_and_cross_reads(tmp_path, kind, bands):
    """Byte-identical files; each package reads the other's exactly."""
    a = _array(bands)
    jr, tr = _rasters(a)
    kw = {"deflate": dict(compress=True), "raw": dict(compress=False), "bigtiff": dict(bigtiff=True)}[kind]
    jp, tp = str(tmp_path / "jax.tif"), str(tmp_path / "torch.tif")
    mt.write_geotiff_file(jp, jr, **kw)
    mtt.write_geotiff_file(tp, tr, **kw)
    assert filecmp.cmp(jp, tp, shallow=False)
    _same_raster(mtt.read_geotiff(jp, device="cpu"), a, GRID)
    _same_raster(mt.read_geotiff(tp), a, GRID)
    if bands == 3:
        _same_raster(mtt.read_geotiff(jp, band=1, device="cpu"), a[1], GRID)


def test_overviews_bytes_and_reads(tmp_path):
    """The .ovr pyramid of the same raster, byte for byte, and each level
    read back by both packages equal."""
    g = dict(GRID, nrows=300, ncols=520)
    a = np.random.default_rng(1).standard_normal((300, 520)).astype(np.float32)
    a[10:40, 100:180] = np.nan
    paths = {}
    for name, pkg, raster in (("jax", mt, mt.Raster(jnp.asarray(a), mt.GridSpec(**g))),
                              ("torch", mtt, mtt.Raster(torch.as_tensor(a), mtt.GridSpec(**g)))):
        p = str(tmp_path / f"{name}.tif")
        pkg.write_geotiff_file(p, raster)
        ovr = (jovr if name == "jax" else tovr).write_overviews(p, raster, levels=[2, 4])
        paths[name] = (p, ovr)
    assert filecmp.cmp(paths["jax"][1], paths["torch"][1], shallow=False)
    for lvl in (0, 1):
        want = np.asarray(jovr.read_overview(paths["jax"][0], lvl).data)
        np.testing.assert_array_equal(tovr.read_overview(paths["jax"][0], lvl, device="cpu").data.numpy(), want)
        np.testing.assert_array_equal(np.asarray(jovr.read_overview(paths["torch"][0], lvl).data), want)


def _layers(seed=2):
    """The same two results as each package's LayerResult."""
    rng = np.random.default_rng(seed)
    out = {"jax": [], "torch": []}
    for i, name in enumerate(("bio_1", "bio_12")):
        final = _array(1, seed + i)
        resid = np.stack([rng.standard_normal(40), rng.uniform(-78, -75, 40), rng.uniform(-8, -5, 40)], 1)
        var_imp = {"brt": {"alt": 61.25, "LONG": 20.5, "LAT": 18.25},
                   "nn": {"alt": {"importance": 0.3125}, "slope": {"importance": 0.6875}}}
        summary = {"layer": name, "best model(s):": "bn", "ensemble weights:": "b:62 n:38",
                   "r2 ensemble:": 0.9374573331419003 - i / 10, "r2 final:": 0.9959510782976777 - i / 10}
        jr, tr = _rasters(final)
        ens = _array(1, seed + 10 + i)
        je, te = _rasters(ens)
        out["jax"].append(JLayer(name=name, final=jr, residuals=resid, var_imp=var_imp, summary=dict(summary),
                                 n_layers=2, ensemble=je, tps_surface=None))
        out["torch"].append(TLayer(name=name, final=tr, residuals=resid, var_imp=var_imp, summary=dict(summary),
                                   n_layers=2, ensemble=te, tps_surface=None))
    return out


def test_writers_bytes(tmp_path):
    """write_geotiff (rasters, overviews and the summary CSV with seed 7),
    write_residuals and write_loadings: the same file names and bytes."""
    layers = _layers()
    written = {}
    for name, pkg in (("jax", mt), ("torch", mtt)):
        d = str(tmp_path / name)
        paths = pkg.write_geotiff(layers[name], d, seed=7, overviews=[2])
        paths += pkg.write_residuals(layers[name], d)
        paths += pkg.write_loadings(layers[name], d)
        written[name] = [os.path.relpath(p, d) for p in paths]
    assert written["jax"] == written["torch"]
    assert any(p.startswith("MACHISPLIN_results_") for p in written["jax"])
    for rel in written["jax"]:
        assert filecmp.cmp(str(tmp_path / "jax" / rel), str(tmp_path / "torch" / rel), shallow=False), rel


def test_checkpoints_load_across_packages(tmp_path):
    """A layer saved by either package loads in the other's load_layer:
    every raster, the residuals, the summary and the importances equal."""
    layers = _layers(seed=5)
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "torch.npz")
    jck.save_layer(jp, layers["jax"][0])
    tck.save_layer(tp, layers["torch"][0])
    for got in (tck.load_layer(jp, device="cpu"), jck.load_layer(tp)):
        want = layers["torch"][0]
        assert got.name == want.name and got.n_layers == want.n_layers
        assert got.summary == want.summary and got.var_imp == want.var_imp
        np.testing.assert_array_equal(np.asarray(got.residuals), want.residuals)
        for attr in ("final", "ensemble"):
            np.testing.assert_array_equal(np.asarray(getattr(got, attr).data), getattr(want, attr).data.numpy())
            assert vars(getattr(got, attr).grid) == vars(getattr(want, attr).grid)
        assert got.tps_surface is None
    assert isinstance(tck.load_layer(jp, device="cpu").final.data, torch.Tensor)


def test_run_log_writes_file(tmp_path):
    path = str(tmp_path / "MachiSplin.LOG.txt")
    with run_log(path, echo=False):
        banner("part 1")
        logging.getLogger("machisplin_tpu_torch.cv").info("hello pipeline")
    text = open(path).read()
    assert "hello pipeline" in text and "### part 1" in text
