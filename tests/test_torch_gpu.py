"""Kernel K1 (the CUDA TPS grid kernel) against its plain PyTorch version.

These tests need a CUDA device and nvcc; they skip without them.  They import
nothing of JAX, so they also run where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

from machisplin_tpu_torch import grid as tgrid
from machisplin_tpu_torch.ops import tps as ttps, tps_grid as ttg

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _model(n_knots, n_resp, device, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-3, 2, size=(n_knots, 2))
    ys = np.stack([np.sin(2 * pts[:, 0] + j) * np.cos(pts[:, 1]) for j in range(n_resp)], 1)
    y = ys[:, 0] if n_resp == 1 else ys
    return ttps.tps_fit(torch.as_tensor(pts, device=device), torch.as_tensor(y, device=device), lam=1e-6)


@pytest.mark.parametrize("n_knots,n_resp,shape", [
    (50, 1, (37, 53)),        # one response, ragged last block
    (300, 2, (129, 260)),     # the main path's response count
    (200, 9, (20, 31)),       # more responses than one launch holds
    (813, 3, (64, 64)),       # every station in one model, a ragged last chunk
])
def test_k1_matches_plain(cuda, n_knots, n_resp, shape):
    model = _model(n_knots, n_resp, cuda)
    g = tgrid.GridSpec(nrows=shape[0], ncols=shape[1], xmin=-3.1, ymax=2.2, dx=5.3 / shape[1], dy=5.4 / shape[0])
    tab = ttg.grid_tables(model, g, torch.float32)
    before = ttg.LAUNCHES["tps_grid"]
    got = ttg.tps_grid_cuda(tab, g)
    torch.cuda.synchronize()
    assert ttg.LAUNCHES["tps_grid"] - before == -(-n_resp // 8)
    want = ttg.tps_grid_plain(tab, g)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 2e-4 * scale
    out = ttps.tps_predict_grid(model, g)
    assert out.shape == (shape if n_resp == 1 else shape + (n_resp,))


def test_k1_wrapper_checks_inputs(cuda):
    model = _model(40, 2, cuda)
    g = tgrid.GridSpec(8, 8, -3.0, 2.0, 0.5, 0.5)
    tab = ttg.grid_tables(model, g, torch.float64)
    with pytest.raises(TypeError):
        ttg.tps_grid_cuda(tab, g)
