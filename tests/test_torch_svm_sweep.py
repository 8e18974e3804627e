"""Kernel K4's arithmetic, replayed in torch on the CPU.

``replay`` follows ``csrc/svm_sweep.cu`` step by step: coordinates in
chunks of 32; at a chunk's start each coordinate's residual g = q[i] . theta
is summed afresh, as the updater warps sum it (each warp over its own
contiguous range of whole chunks of rows, ascending, leaving out the chunk
that ran before;
the warps' sums in order) plus the previous chunk's rows with their new
theta (the chain warp's sum, ascending); inside the chunk g is kept current
by adding q[k][i] * delta_k after each step k.  The step's own formula is
the kernel's (the soft threshold as z - clamp(z, -eps w, eps w), the
division as a product with w / max(diag, 1e-12)).  ``skip`` leaves out
every term whose factor theta_k, delta_k or the new theta_k is 0, as the
updaters leave out theta_k = 0: such terms add exactly 0.

The replay is held against ``svm_sweep_plain``, the oracle the card's
kernel is held against (``chip_smoke.SVM_TOL``: 1e-3 of C in float32,
1e-9 in float64).
"""
import numpy as np
import pytest
import torch

from machisplin_tpu_torch.models import svm as tsvm
from machisplin_tpu_torch.ops import svm_sweep
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

CH = 32            # coordinates a chunk: the chain warp's lanes
UPD = 15           # updater warps (K4_THREADS = 512)
TOL = {torch.float32: 1e-3, torch.float64: 1e-9}


def replay(q, ys, w, diag, *, c_reg=1.0, epsilon=0.1, mu=1.0, epochs=120, skip=True, upd=UPD):
    n_lanes, n = ys.shape
    dt = ys.dtype
    theta = torch.zeros_like(ys)
    s = torch.zeros((n_lanes,), dtype=dt)
    lam = torch.zeros_like(s)
    invw = (1.0 / torch.maximum(diag, torch.full((), 1e-12, dtype=dt))) * w
    ew, mw, cw = epsilon * w, mu * w, c_reg * w
    chunks = -(-n // CH)
    per = -(-chunks // upd) * CH             # each warp's rows: whole chunks
    b = torch.zeros((n_lanes, CH), dtype=dt)
    prev = (0, 0)                              # rows the updaters leave out: the chunk run before

    def add(acc, a, f):                        # acc + a * f, or acc where f is 0 when skipping
        t = acc + a * f[:, None]
        return torch.where((f != 0)[:, None], t, acc) if skip else t

    for ph in range(epochs * chunks):
        c = ph % chunks
        i0, m = c * CH, min(CH, n - c * CH)
        cols = slice(i0, i0 + m)
        g = None
        for u in range(upd):
            acc = torch.zeros((n_lanes, m), dtype=dt)
            for k in range(u * per, min(n, (u + 1) * per)):
                if not prev[0] <= k < prev[1]:
                    acc = add(acc, q[:, k, cols], theta[:, k])
            g = acc if g is None else g + acc
        g = g + b[:, :m]
        cn = (c + 1) % chunks
        nxt = slice(cn * CH, cn * CH + min(CH, n - cn * CH))
        b = torch.zeros((n_lanes, CH), dtype=dt)
        bn = b[:, : nxt.stop - nxt.start]
        th0 = theta[:, cols].clone()
        for k in range(m):
            i = i0 + k
            thk = th0[:, k]
            a = (ys[:, i] - lam) * w[:, i] + diag[:, i] * thk
            z = a - (g[:, k] + mw[:, i] * s)
            t = torch.minimum(torch.maximum(z, -ew[:, i]), ew[:, i])
            cand = torch.minimum(torch.maximum((z - t) * invw[:, i], -cw[:, i]), cw[:, i])
            dk = cand - thk
            s = s + dk
            theta[:, i] = cand
            g = add(g, q[:, i, cols], dk)
            bn = add(bn, q[:, i, nxt], cand)
        b[:, : bn.shape[1]] = bn
        prev = (i0, i0 + m)
        if c == chunks - 1:
            lam = lam + mu * s
    return theta, lam


def _lanes(dtype, lanes=5, n=300, p=5, seed=0):
    """CV-like lanes on random stations (each row weighted 0 with
    probability 0.1), then the two edge lanes: lane 0's responses scaled
    below epsilon = 0.1 (its theta never leaves 0), lane 1 weighted 0 on
    every tenth row."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, p)) * np.array([1.0, 30.0, 2.0, 5.0, 0.5])
    y = np.sin(x[:, 0]) + 0.02 * x[:, 1] + 0.1 * rng.normal(size=n)
    w = (rng.uniform(size=(lanes, n)) > 0.1).astype(np.float64)
    w[1] = 1.0
    w[1, ::10] = 0.0
    t = lambda a: torch.as_tensor(a, dtype=dtype)
    pairs = tsvm.draw_sigest_pairs(lanes, n, torch.Generator().manual_seed(seed))
    _, ys, q, diag = tsvm.sweep_inputs(t(x).expand(lanes, n, p), t(y).expand(lanes, n), t(w), pairs)
    ys = ys.clone()
    ys[0] = ys[0] * (0.09 / ys[0].abs().max())
    return q, ys, t(w), diag


@pytest.fixture(scope="module")
def runs():
    """The replay (with and without the skip) and the plain sweep, 5 lanes x
    300 rows x 40 sweeps, in both dtypes."""
    out = {}
    for dtype in (torch.float32, torch.float64):
        q, ys, w, diag = _lanes(dtype)
        out[dtype] = {
            "inputs": (q, ys, w, diag),
            "replay": replay(q, ys, w, diag, epochs=40),
            "plain": svm_sweep.svm_sweep_plain(q, ys, w, diag, epochs=40),
        }
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_replay_matches_plain(runs, dtype):
    """The kernel's order of operations gives the plain sweep's theta and
    multiplier within the card's tolerance of C."""
    (theta, lam), (ptheta, plam) = runs[dtype]["replay"], runs[dtype]["plain"]
    gap = max(float((theta - ptheta).abs().max()), float((lam - plam).abs().max()))
    print(f"replay vs plain, {dtype}: {gap:.3g} (tolerance {TOL[dtype]:g})")
    assert gap <= TOL[dtype]
    assert float((ptheta.abs() > 1e-6).sum()) > 100         # the sweep moved: a real comparison


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_replay_edge_lanes(runs, dtype):
    """Lane 0 (responses below epsilon) stays at 0 exactly; lane 1's rows of
    weight 0 stay at 0; both in both versions."""
    q, ys, w, diag = runs[dtype]["inputs"]
    for theta, _ in (runs[dtype]["replay"], runs[dtype]["plain"]):
        assert bool((theta[0] == 0).all())
        assert bool((theta[1, ::10] == 0).all()) and bool((theta[w == 0] == 0).all())
        assert bool((theta[1] != 0).any())


def test_zero_skip_is_bit_exact(runs):
    """Leaving out the terms with a zero factor (as the kernel's updaters
    leave out theta_k = 0) changes no bit of the result."""
    q, ys, w, diag = runs[torch.float32]["inputs"]
    theta, lam = runs[torch.float32]["replay"]
    theta_all, lam_all = replay(q, ys, w, diag, epochs=40, skip=False)
    assert torch.equal(theta, theta_all) and torch.equal(lam, lam_all)
    assert float((theta == 0).float().mean()) > 0.1            # the skip had zeros to leave out


@pytest.mark.parametrize("n,upd", [(32, UPD), (45, 2), (70, 1), (100, 3)])
def test_replay_chunk_edges(n, upd):
    """One chunk (its rows reach it only through the chain warp's sum), two
    chunks, a ragged last chunk, one updater warp, updater warps with
    several chunks of rows: the same theta as the plain sweep in float64."""
    q, ys, w, diag = _lanes(torch.float64, lanes=3, n=n, seed=n)
    theta, lam = replay(q, ys, w, diag, epochs=25, upd=upd)
    ptheta, plam = svm_sweep.svm_sweep_plain(q, ys, w, diag, epochs=25)
    assert float((theta - ptheta).abs().max()) <= 1e-9 and float((lam - plam).abs().max()) <= 1e-9
