"""The port's device mesh (``parallel/sharded.py``) on the CPU: gloo ranks
started with ``torch.multiprocessing.spawn`` and a ``file://`` store.

* Sharded against unsharded, at world sizes 2 and 4, bit for bit where the
  draws are made whole and sliced: the TPS tiles (3 tiles on 2 and 4
  ranks), K3's plain version over raster cells, K2's plain version over
  boosting chains (9 chains on 4 ranks; global, per-fold and shared bins;
  the batched finals), K4's plain version over the SVM's lanes, every CV
  letter and ``mltps`` over the default pool (float64), and the Nystrom fit
  (its per-chunk cross-products summed in the unsharded order).
* Every rank returns the same result; files are written on rank 0.
* Sharded against the JAX package's sharded run on ``make_mesh(2)`` and
  ``make_mesh(4)`` (the virtual CPU devices of ``tests/conftest.py``):
  ``batched_tile_tps`` and ``nystrom_tps_fit`` in float64 (1e-9 relative,
  the same landmarks), ``run_cv`` on the JAX package's folds (GAM and MARS,
  1e-6 relative) and ``mltps``'s r² ensemble within the 0.05 band of
  ``tests/test_pipeline.py``.
* ``CVConfig.rf_group`` of 1, 3, R x K and None (all in one call) grows
  the same forests.
"""
import dataclasses
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as C
from machisplin_tpu import grid as jgrid
from machisplin_tpu.ensemble import cv as jcv
from machisplin_tpu.ops import nystrom as jnystrom
from machisplin_tpu.parallel import batched_tile_tps as jbatched_tile_tps, make_mesh as jmake_mesh
from machisplin_tpu.parallel import pack_tiles as jpack_tiles
from machisplin_tpu.pipeline import mltps as jmltps_mod
from machisplin_tpu_torch.ensemble.cv import run_cv
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

jkfold = importlib.import_module("machisplin_tpu.ensemble.kfold")
jmltps = importlib.import_module("machisplin_tpu.pipeline.mltps")

WORLDS = {
    2: list(C.CASES),
    4: ["tiles3", "tiles4", "nystrom64", "forest_cells", "gbm_outer", "cv_v", "cv_gm"],
}
# relative to the array's largest magnitude.  mltps's raster passes predict
# each rank's panel of cells, matrix products of another height under the
# mesh (last bits: measured 2.8e-14 in 5 of 1,440 cells of a surface of
# ~115); its CV, fits and TPS solves are the unsharded ones bit for bit.  Against the JAX package's mesh,
# whose Nystrom cross-products are summed in another order, the Nystrom
# coefficients (an ill-conditioned whitened system) are held as
# tests/test_torch_nystrom.py holds them (COEF_TOL) and the fitted values
# to 1e-9.
JAX_NYS_TOL = {"c": 1e-6, "d": 1e-6, "fitted": 1e-9}
TOL = {(case, f"{layer}/{key}"): 1e-12 for case in ("mltps_all", "mltps_gm") for layer in ("bio_1", "bio_12")
       for key in ("final", "residuals", "r2")}
JAX_KEY = 3


def _jax_folds():
    """The (R, n) fold ids the JAX package's run_cv draws from JAX_KEY."""
    x, _ = C.cv_inputs()
    kf = jax.random.split(jax.random.PRNGKey(JAX_KEY), 5)[0]
    return np.stack([np.asarray(jkfold.kfold(jax.random.fold_in(kf, r), x.shape[0], C.CV_CONFIG.n_folds))
                     for r in range(2)])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"ref": unsharded results, 2: [rank results], 4: [...], "jax": the
    JAX package's sharded runs}: the ranks of both worlds and the unsharded
    run go in processes of their own while the JAX package runs here."""
    folds = _jax_folds()
    started = {w: C.start_ranks(w, names, tmp_path_factory.mktemp(f"world{w}"), folds=folds)
               for w, names in WORLDS.items()}
    ref = C.start_unsharded(sorted(set(WORLDS[2]) | set(WORLDS[4])), tmp_path_factory.mktemp("ref"), folds=folds)
    out = {"jax": _jax_runs()}
    out["ref"] = C.unsharded_done(ref)
    out.update({w: C.ranks_done(s) for w, s in started.items()})
    out["dirs"] = {w: s[1] for w, s in started.items()}
    return out


def _jax_runs() -> dict:
    out = {}
    coords, ys, origins, shape, cell = C.tile_inputs(4)
    c, y, m = jpack_tiles(coords, ys, pad_to=32)
    ncoords, ny, landmarks = C.nystrom_inputs()
    x, ycv = C.cv_inputs()
    for world in (2, 4):
        mesh = jmake_mesh(world)
        out["tiles4", world] = np.asarray(jbatched_tile_tps(c, y, m, jnp.asarray(origins), tile_shape=shape, cell=cell,
                                                            ngrid=64, refine=12, mesh=mesh))
        out["nystrom64", world] = jnystrom.nystrom_tps_fit(jnp.asarray(ncoords), jnp.asarray(ny),
                                                           landmarks=jnp.asarray(landmarks), chunk=64, ngrid=64,
                                                           mesh=mesh)
        out["cv_gm", world] = jcv.run_cv(jax.random.PRNGKey(JAX_KEY), jnp.asarray(x), jnp.asarray(ycv),
                                         config=jcv.CVConfig(n_folds=C.CV_CONFIG.n_folds), algorithms="gm",
                                         mesh=mesh)
    (nrows, ncols, xmin, ymax, dx), stack, dat = C.world_inputs()
    g = jgrid.GridSpec(nrows=nrows, ncols=ncols, xmin=xmin, ymax=ymax, dx=dx, dy=dx)
    cfg = jmltps.MLTPSConfig(cv=jcv.CVConfig(n_folds=4), use_pallas=False, tps_tile_px=20, letters_pool="gm",
                             mesh=jmake_mesh(2))
    # without the TPS part: its tiles are held above (batched_tile_tps)
    out["mltps_gm"] = jmltps_mod(dat, jgrid.Raster(jnp.asarray(stack), g, ("alt", "slope")), tps=False, config=cfg)
    return out


def _pairs():
    for w, names in WORLDS.items():
        for name in names:
            yield pytest.param(w, name, id=f"world{w}-{name}")


def _assert_same(got, want, tol, what):
    if isinstance(want, (str, list)):
        assert got == want, what
        return
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if not tol:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        scale = max(float(np.nanmax(np.abs(want))), 1e-300)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale, err_msg=what)


@pytest.mark.parametrize("world,name", list(_pairs()))
def test_sharded_matches_unsharded(runs, world, name):
    ref = runs["ref"][name]
    got = runs[world][0][name]
    for key, want in ref.items():
        if key == "paths":
            continue
        _assert_same(got[key], want, TOL.get((name, key)), f"{name}/{key} on {world} ranks")


@pytest.mark.parametrize("world,name", list(_pairs()))
def test_every_rank_returns_the_same(runs, world, name):
    first = runs[world][0][name]
    for r, other in enumerate(runs[world][1:], 1):
        for key, want in first.items():
            _assert_same(other[name][key], want, None, f"{name}/{key}: rank {r} against rank 0")


def test_files_are_written_once(runs):
    """mltps(log_file=) and write_geotiff under the mesh: rank 0 writes,
    every rank returns the paths."""
    d = runs["dirs"][2]
    assert os.path.getsize(os.path.join(d, "run.log")) > 0
    paths = runs[2][0]["mltps_all"]["paths"]
    assert paths == runs[2][1]["mltps_all"]["paths"]
    assert [os.path.basename(p) for p in paths[:2]] == ["bio_1.tif", "bio_12.tif"]
    assert all(os.path.exists(p) for p in paths)


@pytest.mark.parametrize("world", [2, 4])
def test_tiles_match_jax_mesh(runs, world):
    want = runs["jax"]["tiles4", world]
    got = runs[world][0]["tiles4"]["surf"].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9 * np.abs(want).max())


@pytest.mark.parametrize("world", [2, 4])
def test_nystrom_matches_jax_mesh(runs, world):
    want = runs["jax"]["nystrom64", world]
    got = runs[world][0]["nystrom64"]
    np.testing.assert_allclose(got["lam"].numpy(), np.asarray(want.lam), rtol=1e-13)
    for key in ("c", "d", "fitted"):
        w = np.asarray(getattr(want, key))
        np.testing.assert_allclose(got[key].numpy(), w, rtol=0, atol=JAX_NYS_TOL[key] * np.abs(w).max(),
                                   err_msg=key)


@pytest.mark.parametrize("world", [2, 4])
def test_run_cv_matches_jax_mesh(runs, world):
    """GAM and MARS on the JAX package's folds: the same fits up to the
    batched solves' rounding."""
    want = runs["jax"]["cv_gm", world]
    got = runs[world][0]["cv_gm"]
    for letter in "gm":
        w = np.asarray(want[letter])
        np.testing.assert_allclose(got[letter].numpy(), w, rtol=0, atol=1e-6 * np.abs(w).max(), err_msg=letter)


def test_mltps_matches_jax_mesh(runs):
    got = runs[2][0]["mltps_gm"]
    for r in runs["jax"]["mltps_gm"]:
        r2 = got[f"{r.name}/r2"].numpy()
        assert r2[0] == pytest.approx(r.summary["r2 ensemble:"], abs=0.05), r.name


def test_rf_group_grows_the_same_forests():
    x, y = C.cv_inputs()
    x, y = torch.as_tensor(x), torch.as_tensor(y)
    n_lanes = 2 * C.CV_CONFIG.n_folds
    outs = [run_cv(x, y, config=dataclasses.replace(C.CV_CONFIG, rf_group=g), algorithms="r",
                   generator=torch.Generator().manual_seed(4))["r"] for g in (1, 3, n_lanes, None)]
    for o in outs[1:]:
        np.testing.assert_array_equal(o, outs[0])
