"""Parity of the port's grid additions and tiled-landscape workflow
(``grid.extend``/``resample_near``/``map_blocks``, ``pipeline/tiles.py``)
with the JAX package, on the CPU, and the tiled workflow and
``mltps_resumable`` end to end at a small size.

Tolerances: extend, resample_near and map_blocks exactly equal; tile
extents, centers and ids equal to the last bit (both compute them in
float64 on the host), station subsets and per-tile covariates identical;
``tiles_merge`` of the same float64 tiles within 1e-12 of the JAX package's.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import machisplin_tpu as mt
import machisplin_tpu_torch as mtt
from machisplin_tpu import grid as jgrid
from machisplin_tpu.data import synthetic_covariates as jax_covariates
from machisplin_tpu_torch import grid as tgrid
from machisplin_tpu_torch.ensemble.cv import CVConfig
from machisplin_tpu_torch.ensemble.kfold import numpy_folds
from machisplin_tpu_torch.io import checkpoint as tck
from machisplin_tpu_torch.pipeline.mltps import MLTPSConfig
from test_torch_io import one_torch_thread  # noqa: F401  (autouse: one torch thread here too)
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)


G = dict(nrows=24, ncols=30, xmin=-77.0, ymax=-6.0, dx=0.05, dy=0.05)


def _both(a, g=G):
    return mt.Raster(jnp.asarray(a), mt.GridSpec(**g)), mtt.Raster(torch.as_tensor(a), mtt.GridSpec(**g))


@pytest.mark.parametrize("bands", [1, 2])
def test_extend_resample_map_blocks_match_jax(bands):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((bands, 24, 30) if bands > 1 else (24, 30))
    jr, tr = _both(a)
    # extend onto a larger aligned grid (4 rows above, 3 columns left, more beyond)
    big = dict(G, nrows=33, ncols=41, xmin=G["xmin"] - 3 * G["dx"], ymax=G["ymax"] + 4 * G["dy"])
    want = jgrid.extend(jr, mt.GridSpec(**big))
    got = tgrid.extend(tr, mtt.GridSpec(**big))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert vars(got.grid) == vars(want.grid)
    with pytest.raises(ValueError, match="does not fit"):
        tgrid.extend(got, mtt.GridSpec(**G))
    # nearest-cell resample onto a finer, shifted grid reaching past the source
    fine = dict(nrows=61, ncols=70, xmin=G["xmin"] - 0.031, ymax=G["ymax"] + 0.017, dx=0.0237, dy=0.0211)
    want = jgrid.resample_near(jr, mt.GridSpec(**fine))
    got = tgrid.resample_near(tr, mtt.GridSpec(**fine))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    # map_blocks over ragged 7 x 9 blocks, the block's own grid in the function
    fn_j = lambda blk, g: blk * 2.0 + g.xmin
    fn_t = lambda blk, g: blk * 2.0 + g.xmin
    want = jgrid.map_blocks(fn_j, jr, (7, 9))
    got = tgrid.map_blocks(fn_t, tr, (7, 9))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


@pytest.mark.parametrize("layout", [(2, 2), (3, 3), (3, 2)])
def test_tiles_create_matches_jax(layout):
    """Extents, centers, ids and station subsets equal; each tile's covariates
    identical (downsample 8, the bundled stations)."""
    ncol, nrow = layout
    s = mtt.load_sampling()
    want = mt.tiles_create(jax_covariates(downsample=8), s, out_ncol=ncol, out_nrow=nrow, feather_d=50)
    got = mtt.tiles_create(mtt.synthetic_covariates(downsample=8, device="cpu"), s, out_ncol=ncol,
                           out_nrow=nrow, feather_d=50)
    assert (got.n_cols, got.n_rows, got.ids) == (want.n_cols, want.n_rows, want.ids)
    assert got.extents == want.extents and got.centers == want.centers
    assert vars(got.full_grid) == vars(want.full_grid)
    for gd, wd, gr, wr in zip(got.dat, want.dat, got.rast, want.rast):
        np.testing.assert_array_equal(gd, wd)
        assert vars(gr.grid) == vars(wr.grid)
        np.testing.assert_array_equal(gr.data.numpy(), np.asarray(wr.data))
    assert sum(len(d) for d in got.dat) >= len(s)           # overlaps count twice
    assert mtt.tiles_id(got) == mt.tiles_id(want)


def test_tiles_id_plot(tmp_path):
    pytest.importorskip("matplotlib")
    ts = mtt.tiles_create(mtt.synthetic_covariates(downsample=24, device="cpu"), mtt.load_sampling(),
                          out_ncol=2, out_nrow=2)
    path = str(tmp_path / "ids.png")
    info = mtt.tiles_id(ts, save_path=path)
    assert [t["id"] for t in info] == [1, 2, 3, 4] and os.path.getsize(path) > 0


@pytest.mark.parametrize("layout", [(2, 2), (3, 2)])
def test_tiles_merge_matches_jax(layout):
    """The same per-tile float64 surfaces (a smooth field with NaN holes)
    feathered onto the full grid: within 1e-12 of the JAX package's merge,
    NaN where it is NaN."""
    ncol, nrow = layout
    s = mtt.load_sampling()
    jt = mt.tiles_create(jax_covariates(downsample=8), s, out_ncol=ncol, out_nrow=nrow)
    tiles_j, tiles_t = [], []
    for i, r in enumerate(jt.rast):
        g = r.grid
        x = np.asarray(g.x_coords(jnp.float64))[None, :]
        y = np.asarray(g.y_coords(jnp.float64))[:, None]
        a = np.sin(3 * x) * np.cos(2 * y) + 0.1 * i
        a[:3, :5] = np.nan
        tiles_j.append(mt.Raster(jnp.asarray(a), g))
        tiles_t.append(mtt.Raster(torch.as_tensor(a), mtt.GridSpec(**vars(g))))
    want = np.asarray(mt.tiles_merge(tiles_j, jt.full_grid, in_ncol=ncol, in_nrow=nrow).data)
    got = mtt.tiles_merge(tiles_t, mtt.GridSpec(**vars(jt.full_grid)), in_ncol=ncol, in_nrow=nrow)
    assert got.data.dtype == torch.float64
    np.testing.assert_array_equal(np.isnan(got.data.numpy()), np.isnan(want))
    np.testing.assert_allclose(got.data.numpy(), want, rtol=0, atol=1e-12, equal_nan=True)
    with pytest.raises(ValueError, match="expected"):
        mtt.tiles_merge(tiles_t[:-1], jt.full_grid, in_ncol=ncol, in_nrow=nrow)


def _small_config():
    """The shrunken configs of ``test_torch_rf``'s CPU mltps."""
    brt = dict(tree_complexity=2, learning_rate=0.1, bag_fraction=0.5, n_folds=3, step_size=10, max_trees=20,
               n_bins=16)
    nn_cfg, rf_cfg, svm_cfg = dict(hidden=4, maxit=10), dict(ntree=8, max_depth=4, n_bins=16), dict(epochs=3)
    mars_cfg = dict(n_pairs=3, n_knots=8)
    cv = CVConfig(n_folds=3, brt=brt, nn=nn_cfg, rf=rf_cfg, svm=svm_cfg, mars=mars_cfg)
    return MLTPSConfig(cv=cv, final_brt=brt, final_nn=nn_cfg, final_rf=rf_cfg, final_svm=svm_cfg,
                       final_mars=mars_cfg, svm_importance_sample=20)


def test_tiled_mltps_cpu(tmp_path):
    """README Example 2 at downsample 48 on the CPU: tiles_create (2 x 1
    tiles), mltps per tile with the default pool and shrunken configs, the
    writers, each tile's GeoTIFF read back bit for bit, and tiles_merge of
    the read-back finals covering the full grid, finite wherever the
    covariates are."""
    cov = mtt.synthetic_covariates(downsample=48, device="cpu")
    ts = mtt.tiles_create(cov, mtt.load_sampling(), out_ncol=2, out_nrow=1, feather_d=4)
    cfg = _small_config()
    finals = []
    for t, (rast, dat) in enumerate(zip(ts.rast, ts.dat)):
        n = int(torch.isfinite(mtt.extract(rast, dat["long"], dat["lat"])).all(1).sum())
        out = mtt.mltps(dat, rast, tps=True, config=cfg, folds=numpy_folds(n, 3, 2, seed=t),
                        generator=torch.Generator().manual_seed(t), device="cpu")
        d = str(tmp_path / f"tile_{t}")
        paths = mtt.write_geotiff(out, d, seed=t) + mtt.write_residuals(out, d) + mtt.write_loadings(out, d)
        assert all(os.path.getsize(p) > 0 for p in paths)
        back = mtt.read_geotiff(os.path.join(d, "bio_1.tif"), device="cpu")
        np.testing.assert_array_equal(back.data.numpy(), out[0].final.data.numpy().astype(np.float32))
        assert vars(back.grid) == vars(out[0].final.grid)
        finals.append(back)
    merged = mtt.tiles_merge(finals, ts.full_grid, in_ncol=2, in_nrow=1)
    assert merged.grid.shape == cov.grid.shape
    assert torch.isfinite(merged.data[torch.isfinite(cov.data).all(0)]).all()


def test_mltps_resumable_skips_done_layers(tmp_path, monkeypatch):
    """The first run computes both layers and checkpoints them (and tees its
    log to ``log_file``); the second, with ``mltps`` made to raise, loads
    them bit for bit."""
    g = mtt.GridSpec(nrows=24, ncols=20, xmin=-77.0, ymax=-6.0, dx=0.05, dy=0.05)
    xs = g.x_coords(torch.float64, "cpu")[None, :].expand(g.shape)
    ys = g.y_coords(torch.float64, "cpu")[:, None].expand(g.shape)
    stack = mtt.Raster(torch.stack([1000 + 100 * xs, ys * 10]), g, ("alt", "slope"))
    rng = np.random.default_rng(0)
    lon = rng.uniform(g.xmin + 0.02, g.xmax - 0.02, 60)
    lat = rng.uniform(g.ymin + 0.02, g.ymax - 0.02, 60)
    resp = 2.0 * lon + lat + 0.01 * rng.standard_normal(60)
    dat = np.rec.fromarrays([lon, lat, resp, resp * 2], names="long,lat,a,b")
    cfg = _small_config()
    log_file = str(tmp_path / "run.log")
    kw = dict(tps=False, config=cfg, folds=numpy_folds(60, 3, 2, seed=0), device="cpu", log_file=log_file,
              generator=torch.Generator().manual_seed(0))
    out1 = tck.mltps_resumable(dat, stack, str(tmp_path / "ck"), **kw)
    assert [r.name for r in out1] == ["a", "b"] and [r.n_layers for r in out1] == [2, 2]
    assert os.path.exists(str(tmp_path / "ck" / "a.npz")) and os.path.getsize(log_file) > 0

    def boom(*a, **k):
        raise AssertionError("mltps re-ran despite checkpoints")

    import sys

    monkeypatch.setattr(sys.modules["machisplin_tpu_torch.pipeline.mltps"], "mltps", boom)
    out2 = tck.mltps_resumable(dat, stack, str(tmp_path / "ck"), **kw)
    for a, b in zip(out1, out2):
        assert b.summary == a.summary
        np.testing.assert_array_equal(b.final.data.numpy(), a.final.data.numpy())
        np.testing.assert_array_equal(b.residuals, a.residuals)
