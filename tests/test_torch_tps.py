"""Parity of the PyTorch port's TPS solver, grid prediction, tiles and
feathering with the JAX package, on the CPU at small sizes.

The same numpy inputs go through both packages with the same explicit dtype.
The port's grid prediction on a CPU tensor is the plain version of kernel
K1; the JAX side runs its Pallas kernel in interpret mode, as
tests/test_pallas_tps.py does.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from machisplin_tpu.grid import GridSpec as JGridSpec, Raster as JRaster, crop as jcrop
from machisplin_tpu.ops import feather as jfeather
from machisplin_tpu.ops import tps as jtps
from machisplin_tpu.ops.pallas_tps import tps_grid_pallas
from machisplin_tpu.parallel import sharded as jsharded
from machisplin_tpu_torch import convert, grid as tgrid
from machisplin_tpu_torch.ops import feather as tfeather, tps as ttps, tps_grid as ttg
from machisplin_tpu_torch.parallel import sharded as tsharded

# the pipeline packages re-export the mltps function under the module's name
jmltps = importlib.import_module("machisplin_tpu.pipeline.mltps")
tmltps = importlib.import_module("machisplin_tpu_torch.pipeline.mltps")


def _fields(model):
    return {k: np.asarray(v) for k, v in model._asdict().items()}


def _sampling_xy(sampling):
    coords = np.stack([sampling["long"], sampling["lat"]], 1).astype(np.float64)
    ys = np.stack([sampling["bio_1"], sampling["bio_12"]], 1).astype(np.float64)
    return coords, ys


@pytest.mark.parametrize("masked", [False, True])
def test_tps_factor_solve_match_jax(sampling, masked):
    coords, ys = _sampling_xy(sampling)
    coords, ys = coords[::3], ys[::3]                    # 271 knots keep it quick
    mask = None
    if masked:
        mask = np.ones(len(coords))
        mask[-40:] = 0.0                                 # padded knots, spliced exactly
    want = jtps.tps_solve(jtps.tps_factor(jnp.asarray(coords), None if mask is None else jnp.asarray(mask)), jnp.asarray(ys))
    got = ttps.tps_solve(ttps.tps_factor(torch.as_tensor(coords), None if mask is None else torch.as_tensor(mask)), torch.as_tensor(ys))
    w, g = _fields(want), {k: v.numpy() for k, v in got._asdict().items()}
    for k in ("lam", "gcv", "eff_df", "c", "d", "fitted"):
        # c is the solution of an ill-conditioned system: on these knots the
        # JAX package's own masked fit and its fit on the active subset
        # (equal in exact arithmetic) differ by 1e-7 of max|c|
        scale = 1e-7 if k == "c" else 1e-9
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, atol=scale * np.abs(w[k]).max(), err_msg=k)


def test_masked_fit_equals_active_subset(sampling):
    coords, ys = _sampling_xy(sampling)
    coords, ys = coords[:120], ys[:120, 0]
    mask = np.r_[np.ones(100), np.zeros(20)]
    full = ttps.tps_fit(torch.as_tensor(coords), torch.as_tensor(ys), torch.as_tensor(mask))
    sub = ttps.tps_fit(torch.as_tensor(coords[:100]), torch.as_tensor(ys[:100]))
    np.testing.assert_allclose(full.lam.numpy(), sub.lam.numpy(), rtol=1e-6)
    np.testing.assert_allclose(full.c[:100].numpy(), sub.c.numpy(), rtol=1e-6, atol=1e-9 * float(sub.c.abs().max()))


@pytest.mark.parametrize("n_resp", [1, 2])
def test_plain_grid_matches_pallas_interpret(rng, n_resp):
    pts = rng.uniform(0, 1, size=(50, 2)).astype(np.float32)
    ys = np.stack([np.sin(3 * pts[:, 0] + j) + np.cos(2 * pts[:, 1]) for j in range(n_resp)], 1).astype(np.float32)
    y = ys[:, 0] if n_resp == 1 else ys
    jmodel = jtps.tps_fit(jnp.asarray(pts), jnp.asarray(y), lam=1e-5)
    jgrid = JGridSpec(nrows=40, ncols=56, xmin=0.0, ymax=1.0, dx=1 / 56, dy=1 / 40)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tps_grid_pallas(jmodel, jgrid))
    model = convert.tps_model_from_numpy(_fields(jmodel), dtype=torch.float32, device="cpu")
    tgrid_ = tgrid.GridSpec(nrows=40, ncols=56, xmin=0.0, ymax=1.0, dx=1 / 56, dy=1 / 40)
    got = ttps.tps_predict_grid(model, tgrid_, block_rows=7).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_grid_tables_match_jax_setup(rng):
    """Padding to the kernel's unroll width (4) with 0.5 / c = 0, the 1/2
    folded into c and d reordered [1, x, y] -> [x, y, 1], as
    _compiled_grid_eval builds them."""
    pts = rng.uniform(0, 1, size=(130, 2))
    y = np.stack([np.sin(4 * pts[:, 0]), pts[:, 1] ** 2], 1)
    model = ttps.tps_fit(torch.as_tensor(pts), torch.as_tensor(y), lam=1e-4)
    tab = ttg.grid_tables(model, tgrid.GridSpec(3, 4, 0.0, 1.0, 0.25, 1 / 3), torch.float32)
    assert tab.kxy.shape == (2, 132) and tab.c.shape == (2, 132)
    np.testing.assert_array_equal(tab.kxy[:, 130:].numpy(), 0.5)
    np.testing.assert_array_equal(tab.c[:, 130:].numpy(), 0.0)
    np.testing.assert_allclose(tab.c[:, :130].numpy(), 0.5 * model.c.T.float().numpy(), rtol=1e-7)
    np.testing.assert_allclose(tab.d.numpy(), model.d[[1, 2, 0]].T.float().numpy(), rtol=1e-7)
    assert not tab.single


@pytest.mark.parametrize("live", [37, 50, 64])
def test_plain_grid_of_a_budget_tile_matches_pallas_interpret(rng, live):
    """A tile packed to a 64-knot budget: the tables keep its live knots
    only (padded to the unroll width), and the plain version matches the
    JAX package's Pallas kernel (interpret mode) on the whole padded model."""
    pts = rng.uniform(0, 1, size=(live, 2)).astype(np.float32)
    ys = np.stack([np.sin(3 * pts[:, 0]) + np.cos(2 * pts[:, 1]), pts[:, 0] * pts[:, 1]], 1).astype(np.float32)
    other = rng.uniform(0, 1, size=(64, 2)).astype(np.float32)
    jc, jy, jm = jsharded.pack_tiles([pts, other], [ys, np.sin(other)], pad_to=64)
    jmodel = jtps.TPSModel(*(a[0] for a in jsharded.batched_tile_solve(jc, jy, jm)))
    jgrid = JGridSpec(nrows=30, ncols=44, xmin=0.0, ymax=1.0, dx=1 / 44, dy=1 / 30)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(tps_grid_pallas(jmodel, jgrid))
    model = convert.tps_model_from_numpy(_fields(jmodel), dtype=torch.float32, device="cpu")
    assert bool((model.c[live:] == 0).all())
    g = tgrid.GridSpec(nrows=30, ncols=44, xmin=0.0, ymax=1.0, dx=1 / 44, dy=1 / 30)
    tab = ttg.grid_tables(model, g, torch.float32)
    assert tab.c.shape == (2, -(-live // 4) * 4)
    np.testing.assert_array_equal(tab.kxy[:, :live].numpy(), model.knots[:live].T.numpy())
    got = ttps.tps_predict_grid(model, g, block_rows=7).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


def test_k1_log_within_two_ulp():
    """K1's log (``log_pos`` in csrc/tps_grid.cu: exponent from the bits,
    m in [2/3, 4/3), degree-7 polynomial), emulated in float32 with its
    constants read from the source, is within 2 ulp of the float64 log on
    every float32 m of [2/3, 4/3) and on 2^20 arguments drawn over
    [FLT_MIN, 8] (each fma rounded once, from a float64 product and sum)."""
    import os
    import re

    src = open(os.path.join(os.path.dirname(ttg.__file__), "..", "csrc", "tps_grid.cu")).read()
    body = src[src.index("float log_pos(float a)"):]
    body = body[: body.index("\n}")]
    coef = [np.float32(v) for v in re.findall(r"q = (?:fmaf\(q, f, )?(-?[0-9.]+)f", body)]
    assert len(coef) == 8 and "0x3f2aaaab" in body and "0.693147182f" in body

    def fma(a, b, c):
        return (a.astype(np.float64) * b.astype(np.float64) + np.asarray(c, np.float64)).astype(np.float32)

    def log_pos(a):
        i = a.view(np.int32)
        e = (i - np.int32(0x3F2AAAAB)) & np.int32(-(1 << 23))
        m = (i - e).view(np.float32)
        k = ((e >> 23) + np.int32(0x4B400000)).view(np.float32) - np.float32(12582912.0)
        f = m - np.float32(1.0)
        q = np.full_like(f, coef[0])
        for c in coef[1:]:
            q = fma(q, f, c)
        return fma(k, np.full_like(f, np.float32(0.693147182)), fma(q, f * f, f))

    lo, hi = np.float32(2 / 3).view(np.int32), np.float32(4 / 3).view(np.int32)
    core = np.arange(lo, hi, dtype=np.int32).view(np.float32)
    wide = np.random.default_rng(0).integers(np.float32(1.1754944e-38).view(np.int32), np.float32(8).view(np.int32),
                                             1 << 20).astype(np.int32).view(np.float32)
    for a in (core, wide):
        want = np.log(a.astype(np.float64))
        ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
        assert float((np.abs(log_pos(a) - want) / ulp).max()) <= 2.0


def test_grid_plain_matches_pointwise_predict(rng):
    """Streaming over row blocks gives the pointwise spline at cell centres."""
    pts = rng.uniform(0, 1, size=(40, 2))
    y = np.sin(3 * pts[:, 0]) * np.cos(2 * pts[:, 1])
    model = ttps.tps_fit(torch.as_tensor(pts), torch.as_tensor(y))
    g = tgrid.GridSpec(nrows=9, ncols=11, xmin=0.0, ymax=1.0, dx=1 / 11, dy=1 / 9)
    surf = ttps.tps_predict_grid(model, g, block_rows=4)
    xx, yy = np.meshgrid(g.x_coords(torch.float64, "cpu").numpy(), g.y_coords(torch.float64, "cpu").numpy())
    pw = ttps.tps_predict(model, torch.as_tensor(np.stack([xx.ravel(), yy.ravel()], 1)))
    np.testing.assert_allclose(surf.numpy().ravel(), pw.numpy(), rtol=1e-9, atol=1e-9)


def test_cuda_wrapper_refuses_cpu_tables(rng):
    """The kernel's wrapper never runs the plain version: CPU tables raise."""
    pts = rng.uniform(0, 1, size=(20, 2))
    model = ttps.tps_fit(torch.as_tensor(pts), torch.as_tensor(pts[:, 0]), lam=1e-3)
    g = tgrid.GridSpec(4, 4, 0.0, 1.0, 0.25, 0.25)
    with pytest.raises(ValueError):
        ttg.tps_grid_cuda(ttg.grid_tables(model, g, torch.float32), g)


def _jax_tiles(g=(40, 60)):
    jg = JGridSpec(nrows=g[0], ncols=g[1], xmin=0.0, ymax=1.0, dx=1 / g[1], dy=1 / g[0])
    tg = tgrid.GridSpec(nrows=g[0], ncols=g[1], xmin=0.0, ymax=1.0, dx=1 / g[1], dy=1 / g[0])
    return jg, tg


def test_tps_tiles_plan_matches_jax():
    jg, tg = _jax_tiles((70, 95))
    want = jmltps._tps_tiles(jg, jmltps.MLTPSConfig(tps_tile_px=30))
    got = tmltps._tps_tiles(tg, tmltps.MLTPSConfig(tps_tile_px=30))
    assert got[:2] == want[:2] == (3, 4)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))
    np.testing.assert_array_equal(np.asarray(got[3]), np.asarray(want[3]))


def test_feather_blend_matches_jax(rng):
    jg, tg = _jax_tiles()
    field = rng.normal(size=(2, 40, 60))
    n_rx, n_cx, fit_exts, mosaic_exts = jmltps._tps_tiles(jg, jmltps.MLTPSConfig(tps_tile_px=25))
    jt, tt = [], []
    for h, e in enumerate(mosaic_exts):
        jc = jcrop(JRaster(jnp.asarray(field + h), jg), e)    # tiles disagree by h
        tc = tgrid.crop(tgrid.Raster(torch.as_tensor(field + h), tg), e)
        jt.append(jc)
        tt.append(tc)
    want = np.asarray(jfeather.feather_blend(jt, n_rx, n_cx, jg).data)
    got = tfeather.feather_blend(tt, n_rx, n_cx, tg).data.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_batched_tile_solve_matches_jax(sampling):
    coords, ys = _sampling_xy(sampling)
    parts = [(coords[i::4][: 30 + 7 * i], ys[i::4][: 30 + 7 * i]) for i in range(3)]
    jc, jy, jm = jsharded.pack_tiles([p[0] for p in parts], [p[1] for p in parts], pad_to=64)
    want = jsharded.batched_tile_solve(jc, jy, jm)
    tc, ty, tm = tsharded.pack_tiles([p[0] for p in parts], [p[1] for p in parts], pad_to=64, device="cpu")
    got = tsharded.batched_tile_solve(tc, ty, tm)
    for k in ("lam", "c", "d", "fitted"):
        w = np.asarray(getattr(want, k))
        np.testing.assert_allclose(getattr(got, k).numpy(), w, rtol=1e-6, atol=1e-9 * np.abs(w).max(), err_msg=k)
