"""Parity of the PyTorch port's data, grid, GAM, MARS, k-fold, CV and weight
search with the JAX package, on the CPU in float64.

Station covariates come from ``sampling.csv`` on the synthetic covariate
stack at downsample 48; both packages get the same numpy arrays.
"""
import ast
import importlib
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from machisplin_tpu import data as jdata, grid as jgrid
from machisplin_tpu.ensemble import cv as jcv, weights as jweights
from machisplin_tpu.models import gam as jgam, mars as jmars
from machisplin_tpu_torch import convert, data as tdata, grid as tgrid
from machisplin_tpu_torch.ensemble import cv as tcv, weights as tweights
from machisplin_tpu_torch.models import gam as tgam, mars as tmars
from machisplin_tpu_torch.parallel import sharded as tsharded
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

# the ensemble packages re-export the kfold function under the module's name
jkfold = importlib.import_module("machisplin_tpu.ensemble.kfold")
tkfold = importlib.import_module("machisplin_tpu_torch.ensemble.kfold")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ["alt", "slope", "TWI", "LONG", "LAT"]


@pytest.fixture(scope="module")
def stations():
    """(x (n, 5) station covariates, ys (n, 2)) in float64."""
    cov = tdata.synthetic_covariates(downsample=48, device="cpu")
    s = tdata.load_sampling()
    stk = tgrid.stack([cov, tgrid.lonlat_rasters(cov.grid, device="cpu")])
    x = tgrid.extract(stk, s["long"], s["lat"]).numpy().astype(np.float64)
    ok = np.isfinite(x).all(1)
    ys = np.stack([s["bio_1"], s["bio_12"]], 1)[ok]
    return x[ok], ys


@pytest.mark.parametrize("downsample", [48, 16])
def test_synthetic_covariates_bit_identical(downsample):
    want = np.asarray(jdata.synthetic_covariates(downsample=downsample).data)
    got = tdata.synthetic_covariates(downsample=downsample, device="cpu")
    np.testing.assert_array_equal(got.data.numpy(), want)
    assert got.grid.shape == jdata.example_grid(downsample).shape


def test_entry_points_refuse_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    g = tgrid.GridSpec(nrows=3, ncols=4, xmin=0.0, ymax=1.0, dx=0.25, dy=1 / 3)
    calls = [
        lambda: tdata.synthetic_covariates(downsample=48),
        lambda: tgrid.lonlat_rasters(g),
        lambda: g.x_coords(),
        lambda: g.y_coords(),
        lambda: tsharded.pack_tiles([np.zeros((3, 2))], [np.zeros(3)]),
        lambda: convert.gam_state_from_numpy({"coef": np.zeros(3), "x_mean": np.zeros(2), "x_scale": np.ones(2)}),
        lambda: convert.nn_params_to_flat(np.zeros((2, 3)), np.zeros(3), np.zeros(3), np.zeros(())),
        lambda: convert.nn_state_from_jax({k: np.zeros(2) for k in ("w1", "b1", "w2", "b2", "x_mean", "x_scale")}),
        lambda: convert.svm_state_from_jax({k: np.zeros(2) for k in (
            "sv_x", "theta", "bias", "sigma", "x_mean", "x_scale", "y_mean", "y_scale")}),
        lambda: convert.rf_state_from_jax({"trees": {k: np.zeros((1, 3)) for k in (
            "feat", "thr", "internal", "left", "right", "value", "var_gain")}, "edges": np.zeros((2, 3)),
            "max_depth": 1, "oob_count": np.zeros((1, 4)), "train_pred": np.zeros(4)}),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_grid_ops_match_jax(rng, dtype):
    jg = jgrid.GridSpec(nrows=30, ncols=40, xmin=-1.0, ymax=2.0, dx=0.05, dy=0.04)
    tg = tgrid.GridSpec(nrows=30, ncols=40, xmin=-1.0, ymax=2.0, dx=0.05, dy=0.04)
    np.testing.assert_array_equal(tg.x_coords(torch.float32, "cpu").numpy(), np.asarray(jg.x_coords(jnp.float32)))
    np.testing.assert_array_equal(tg.y_coords(torch.float32, "cpu").numpy(), np.asarray(jg.y_coords(jnp.float32)))
    field = rng.normal(size=(2, 30, 40)).astype(dtype)
    field[0, 3, 4] = np.nan
    jr, tr = jgrid.Raster(jnp.asarray(field), jg), tgrid.Raster(torch.as_tensor(field), tg)
    ext = (-0.93, 0.41, 1.07, 1.71)
    np.testing.assert_array_equal(tgrid.crop(tr, ext).data.numpy(), np.asarray(jgrid.crop(jr, ext).data))
    px = rng.uniform(-1.2, 1.2, 50)
    py = rng.uniform(0.6, 2.1, 50)             # some points fall outside the grid
    want = np.asarray(jgrid.extract(jr, jnp.asarray(px), jnp.asarray(py)))
    got = tgrid.extract(tr, px, py).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_array_equal(got[~np.isnan(got)], want[~np.isnan(want)])
    parts = [(-1.0, 0.2, 1.0, 2.0), (0.0, 1.0, 0.8, 1.6)]
    jm = jgrid.mosaic([jgrid.crop(jr, e) for e in parts], jg)
    tm = tgrid.mosaic([tgrid.crop(tr, e) for e in parts], tg)
    np.testing.assert_allclose(tm.data.numpy(), np.asarray(jm.data), rtol=1e-6, equal_nan=True)
    ll = tgrid.lonlat_rasters(tg, torch.float32, "cpu")
    np.testing.assert_array_equal(ll.data.numpy(), np.asarray(jgrid.lonlat_rasters(jg, jnp.float32).data))


def test_gam_matches_jax(stations):
    x, ys = stations
    want = jgam.fit(None, jnp.asarray(x), jnp.asarray(ys[:, 0]))
    got = tgam.fit(torch.as_tensor(x), torch.as_tensor(ys[:, 0]))
    np.testing.assert_allclose(got.coef.numpy(), np.asarray(want.coef), rtol=1e-9)
    np.testing.assert_allclose(
        tgam.predict(got, torch.as_tensor(x)).numpy(), np.asarray(jgam.predict(want, jnp.asarray(x))), rtol=1e-10
    )
    wi, gi = jgam.importance(want, NAMES), tgam.importance(got, NAMES)
    assert list(gi) == list(wi)
    np.testing.assert_allclose([gi[k] for k in gi], [wi[k] for k in wi], rtol=1e-8)
    # the JAX state carried over predicts the same
    carried = convert.gam_state_from_numpy({k: np.asarray(v) for k, v in want._asdict().items()}, device="cpu")
    np.testing.assert_allclose(tgam.predict(carried, torch.as_tensor(x)).numpy(), np.asarray(jgam.predict(want, jnp.asarray(x))), rtol=1e-12)


@pytest.mark.parametrize("resp", [0, 1])
def test_mars_matches_jax(stations, resp):
    x, ys = stations
    w = (np.arange(len(x)) % 7 != 3).astype(np.float64)      # a CV-like train mask
    want = jmars.fit(None, jnp.asarray(x), jnp.asarray(ys[:, resp]), sample_weight=jnp.asarray(w))
    got = tmars.fit(torch.as_tensor(x), torch.as_tensor(ys[:, resp]), sample_weight=torch.as_tensor(w))
    np.testing.assert_array_equal(got.vars.numpy(), np.asarray(want.vars))
    np.testing.assert_array_equal(got.knots.numpy(), np.asarray(want.knots))
    np.testing.assert_array_equal(got.pair_active.numpy(), np.asarray(want.pair_active))
    np.testing.assert_array_equal(got.active.numpy(), np.asarray(want.active))
    pw = np.asarray(jmars.predict(want, jnp.asarray(x)))
    np.testing.assert_allclose(tmars.predict(got, torch.as_tensor(x)).numpy(), pw, rtol=1e-8, atol=1e-8 * np.abs(pw).max())
    wi = jmars.importance(want, jnp.asarray(x), jnp.asarray(ys[:, resp]), NAMES)
    gi = tmars.importance(got, torch.as_tensor(x), torch.as_tensor(ys[:, resp]), NAMES)
    for k in NAMES:
        assert gi[k]["nsubsets"] == wi[k]["nsubsets"]
        np.testing.assert_allclose(gi[k]["rss"], wi[k]["rss"], rtol=1e-6, atol=1e-8)
    carried = convert.mars_state_from_numpy({k: np.asarray(v) for k, v in want._asdict().items()}, device="cpu")
    np.testing.assert_allclose(tmars.predict(carried, torch.as_tensor(x)).numpy(), pw, rtol=1e-12, atol=1e-12 * np.abs(pw).max())


def test_mars_batch_equals_single_fits(stations):
    x, ys = stations
    xt = torch.as_tensor(x)
    batch = tmars.fit(xt, torch.as_tensor(ys.T.copy()))
    for j in range(2):
        one = tmars.fit(xt, torch.as_tensor(ys[:, j]))
        np.testing.assert_array_equal(batch.knots[j].numpy(), one.knots.numpy())
        np.testing.assert_allclose(batch.coef[j].numpy(), one.coef.numpy(), rtol=1e-9, atol=1e-12)


def test_kfold_sizes_and_masks():
    f = tkfold.kfold(23, 5, torch.Generator().manual_seed(3))
    np.testing.assert_array_equal(np.bincount(f.numpy()), np.bincount(np.asarray(jkfold.kfold(jax.random.PRNGKey(0), 23, 5))))
    for invert in (False, True):
        wtr, wte = jkfold.fold_masks(jnp.asarray(f.numpy()), 5, invert=invert)
        ttr, tte = tkfold.fold_masks(f, 5, invert=invert)
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(wtr))
        np.testing.assert_array_equal(tte.numpy(), np.asarray(wte))
    nf = tkfold.numpy_folds(23, 5, 2, seed=0)
    assert nf.shape == (2, 23) and all(np.bincount(r).tolist() == np.bincount(f.numpy()).tolist() for r in nf)
    with pytest.raises(ValueError):
        tkfold.kfold(3, 5)


@pytest.mark.parametrize("invert_threshold", [4000, 100])   # 100: train on one fold (V73:227-232)
def test_run_cv_and_weights_match_jax(stations, invert_threshold):
    x, ys = stations
    key = jax.random.PRNGKey(7)
    want = jcv.run_cv(
        key, jnp.asarray(x), jnp.asarray(ys), config=jcv.CVConfig(invert_threshold=invert_threshold),
        algorithms="gm",
    )
    kf = jax.random.split(key, 5)[0]
    folds = np.stack([np.asarray(jkfold.kfold(jax.random.fold_in(kf, r), len(x), 10)) for r in range(2)])
    got = tcv.run_cv(
        torch.as_tensor(x), torch.as_tensor(ys), config=tcv.CVConfig(invert_threshold=invert_threshold),
        algorithms="gm", folds=folds,
    )
    assert got["g"].shape == want["g"].shape == (2, len(x) * (9 if invert_threshold < len(x) else 1))
    for letter in "gm":
        np.testing.assert_allclose(got[letter], want[letter], rtol=1e-8, atol=1e-8 * np.abs(want[letter]).max())
    for r in range(2):
        wres = jweights.optimize_weights_lbfgsb(jcv.residual_matrix({l: want[l][r] for l in "gm"}, "gm"), "gm")
        gres = tweights.optimize_weights_lbfgsb(tcv.residual_matrix({l: got[l][r] for l in "gm"}, "gm"), "gm")
        assert gres.letters == wres.letters and gres.percent_text == wres.percent_text
        np.testing.assert_allclose(gres.weights, wres.weights, atol=1e-6)
        np.testing.assert_allclose(gres.weight_total, wres.weight_total, atol=1e-6)


def test_weight_keep_rule_matches_jax(rng):
    res = rng.normal(size=(2, 200)) * np.array([[1.0], [3.0]])
    want = jweights.optimize_weights_lbfgsb(res, "gm")
    got = tweights.optimize_weights_lbfgsb(res, "gm")
    assert got.letters == want.letters and got.percent_text == want.percent_text
    np.testing.assert_allclose(got.weights, want.weights, atol=1e-9)
    for w in ([0.04, 1.0], [0.5, 0.5], [0.0, 0.0]):
        a = jweights._select(np.asarray(w), "gm", 0.0)
        b = tweights._select(np.asarray(w), "gm", 0.0)
        assert (a.letters, a.percent_text) == (b.letters, b.percent_text)
        np.testing.assert_array_equal(a.kept_weights, b.kept_weights)


def test_cv_defaults_match_jax():
    """``run_cv`` and ``residual_matrix`` default to the JAX package's pool."""
    import inspect

    for name, arg in (("run_cv", "algorithms"), ("residual_matrix", "letters")):
        want = inspect.signature(getattr(jcv, name)).parameters[arg].default
        got = inspect.signature(getattr(tcv, name)).parameters[arg].default
        assert got == want == "bgnmrv", name


def test_unported_letters_raise():
    """Every letter of the reference's pool is ported; a letter outside it
    names no algorithm and raises before any fit."""
    assert tcv.PORTED_LETTERS == jcv.residual_matrix.__defaults__[0] == "bgnmrv"
    x = torch.zeros((40, 2), dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown algorithm 'x'"):
        tcv.run_cv(x, torch.zeros(40, dtype=torch.float64), algorithms="vx")


def _port_sources():
    pkg = os.path.join(ROOT, "machisplin_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_port_sources()), ids=lambda p: os.path.relpath(p, ROOT))
def test_port_never_imports_jax(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            top = m.split(".")[0]
            assert top not in ("jax", "jaxlib", "optax", "machisplin_tpu", "tests"), f"{path} imports {m}"


# JAX modules whose counterpart in the port has another name: the Pallas
# kernels' wrappers and the CUDA kernels' (K1-K3)
COUNTERPART_MODULES = {
    "machisplin_tpu.ops.pallas_tps": "machisplin_tpu_torch.ops.tps_grid",
    "machisplin_tpu.ops.pallas_grow": "machisplin_tpu_torch.ops.tree_grow",
    "machisplin_tpu.ops.pallas_forest": "machisplin_tpu_torch.ops.forest",
}
# the JAX package's public names with no counterpart of that name, each with its reason
JAX_ONLY = {
    "machisplin_tpu.models.trees.grow_bestfirst_tree":
        "the serial best-first grower; the port grows on K2's cumulative formulation "
        "(trees.grow_bestfirst_trees_cumshared, ops/tree_grow.py)",
    "machisplin_tpu.models.trees.build_path_matrices":
        "the TPU's path-matrix forest predictor; the port predicts forests with K3 (ops/forest.py)",
    "machisplin_tpu.models.trees.bestfirst_forest_predict_mxu":
        "the TPU's path-matrix forest predictor; the port predicts forests with K3 (ops/forest.py)",
    "machisplin_tpu.ops.pallas_tps.tps_grid_pallas": "K1's Pallas call; the port's K1 wrapper is ops/tps_grid.tps_grid",
    "machisplin_tpu.ops.pallas_grow.gbm_tree_update_ref":
        "K2's jnp twin; the port's plain version is ops/tree_grow.gbm_tree_update_plain",
    "machisplin_tpu.utils.enable_compile_cache":
        "JAX's persistent compile cache; the port's kernels are nvcc builds that kernels/build.py keeps by hash",
    "machisplin_tpu.utils.cache": "the module of enable_compile_cache (above)",
}


def _jax_modules():
    import pkgutil

    import machisplin_tpu

    return sorted(m.name for m in pkgutil.walk_packages(machisplin_tpu.__path__, "machisplin_tpu."))


def test_every_jax_public_name_has_a_counterpart():
    """Every module of the JAX package has its counterpart module in the
    port (or stands in JAX_ONLY), and every name of a JAX module's
    ``__all__`` exists in the counterpart, is in its ``__all__`` where it
    has one, or stands in JAX_ONLY with its reason."""
    missing, checked = [], 0
    for name in _jax_modules():
        port_name = COUNTERPART_MODULES.get(name, "machisplin_tpu_torch" + name[len("machisplin_tpu"):])
        if importlib.util.find_spec(port_name) is None:
            if name not in JAX_ONLY:
                missing.append(f"module {name}")
            continue
        public = getattr(importlib.import_module(name), "__all__", None)
        if public is None:
            continue
        port = importlib.import_module(port_name)
        for attr in public:
            checked += 1
            if f"{name}.{attr}" in JAX_ONLY:
                continue
            if not hasattr(port, attr) or attr not in getattr(port, "__all__", [attr]):
                missing.append(f"{name}.{attr}")
    assert not missing, missing
    assert checked > 100
    # every JAX_ONLY entry names something public in the JAX package
    for key in JAX_ONLY:
        mod, _, attr = key.rpartition(".")
        assert key in _jax_modules() or attr in getattr(importlib.import_module(mod), "__all__", []), key


def test_port_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['optax'] = None; "
        "sys.modules['machisplin_tpu'] = None; "
        "import machisplin_tpu_torch, machisplin_tpu_torch.convert, "
        "machisplin_tpu_torch.kernels.build, machisplin_tpu_torch.ops.tps_grid, "
        "machisplin_tpu_torch.ops.tree_grow, machisplin_tpu_torch.ops.forest, "
        "machisplin_tpu_torch.models.gbm_step, machisplin_tpu_torch.models.brt, "
        "machisplin_tpu_torch.optim.lbfgs, machisplin_tpu_torch.models.nn, "
        "machisplin_tpu_torch.ops.svm_sweep, machisplin_tpu_torch.models.svm, machisplin_tpu_torch.models.rf, "
        "machisplin_tpu_torch.pipeline.importance, machisplin_tpu_torch.models.families, "
        "machisplin_tpu_torch.models.deviance, machisplin_tpu_torch.io.geotiff, "
        "machisplin_tpu_torch.io.overviews, machisplin_tpu_torch.io.writers, machisplin_tpu_torch.io.checkpoint, "
        "machisplin_tpu_torch.pipeline.tiles, machisplin_tpu_torch.utils.logging, machisplin_tpu_torch.utils.timing, "
        "machisplin_tpu_torch.ops.nystrom, machisplin_tpu_torch.ops.host_tps, machisplin_tpu_torch.io.rdata, "
        "machisplin_tpu_torch.ensemble.weights, machisplin_tpu_torch.parallel.sharded, "
        "machisplin_tpu_torch.io.native; "
        "g = machisplin_tpu_torch.synthetic_covariates(48, device='cpu'); print(g.data.shape)"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "torch.Size([3, 51, 68])" in out.stdout
