"""One best-first boosting tree per chain: kernel K2 and its plain version.

Counterpart of ``machisplin_tpu/ops/pallas_grow.py``.  For every boosting
chain c (rows of y/f/w) both versions grow one best-first tree of
``n_splits`` splits on the residuals ``y - f`` with row weights ``w`` over
bins shared by every chain, and return ``f + lr * value[node of row]``:

* ``gbm_tree_update_cuda`` launches ``csrc/tree_grow.cu`` (one thread block
  per chain); it reads the bins as bytes and builds its split statistics
  from them, so it needs no cumulative one-hot table;
* ``gbm_tree_update_plain`` runs ``trees.grow_bestfirst_trees_cumshared``,
  the JAX package's ``gbm_tree_update_ref``.

``prepare_bins`` turns (n, p) bins into what the route of their device
reads (bytes for the kernel, bins plus the cumulative one-hot table for the
plain version), once per fit; ``gbm_tree_update`` launches the kernel for
CUDA tensors and runs the plain version for CPU tensors; there is no
fallback between the two.  It takes
float32 chains only (the TPU kernel's outputs are float32); callers cast.
``LAUNCHES`` counts kernel launches.  ``near_tie_gap`` says how close to a
tie the first difference between two trees grown for one chain is, for
holding the kernel to its plain version where float32 summation order may
part them.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..models.trees import flat_bin_cum_onehot, grow_bestfirst_trees_cumshared

__all__ = [
    "gbm_tree_update", "gbm_tree_update_cuda", "gbm_tree_update_plain", "near_tie_gap",
    "prepare_bins", "split_sequence", "LAUNCHES",
]

# kernel launches since the last reset: {"tree_grow": n}
LAUNCHES = {"tree_grow": 0}

_MAX_SPLITS = 127   # node ids live in one byte in the kernel


def gbm_tree_update_plain(xbt, cum1h, y, f, w, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                          emit_tree: bool = False):
    """The kernel's function in plain PyTorch, in the chains' dtype.

    xbt (p, n) bins; cum1h (n, p * nb) ``flat_bin_cum_onehot`` (built from
    xbt when None); y/f/w (C, n).  Returns f + lr * value[cur], and with
    ``emit_tree`` also feat, thr_bin, internal, left, right, value (each
    (C, 2J+1)) and var_gain (C, p); thr_bin holds bin indices."""
    xb = xbt.T.long()
    if cum1h is None:
        cum1h = flat_bin_cum_onehot(xb, nb)
    out = grow_bestfirst_trees_cumshared(
        xb, y - f, w, n_splits=n_splits, min_leaf=min_leaf, bin_cum1h=cum1h, return_tree=emit_tree,
    )
    value, cur = out[0], out[1]
    f_new = f + lr * value.gather(1, cur)
    if emit_tree:
        tree = out[2]
        return (f_new,) + tree[:5] + (value, tree[5])
    return f_new


def _launcher():
    from ..kernels.build import load_library

    lib = load_library("tree_grow")
    fn = lib.tree_grow_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 4                       # xbt (uint8), y, f, w
        + [ctypes.c_void_p] * 8                     # out f, feat, thr, internal, left, right, value, var_gain
        + [ctypes.c_int] * 5                        # n_chains, n, p, nb, n_splits
        + [ctypes.c_float] * 2                      # min_leaf, lr
        + [ctypes.c_void_p]                         # stream
    )
    return fn


def smem_bytes(n: int, p: int, nb: int, n_splits: int) -> int:
    """Dynamic shared memory of a K2 launch at these sizes (one block)."""
    from ..kernels.build import load_library

    return int(load_library("tree_grow").tree_grow_smem_bytes(n, p, nb, n_splits))


def gbm_tree_update_cuda(xbt, y, f, w, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                         emit_tree: bool = False):
    """Launch K2 on the current stream.  xbt (p, n) uint8 bins (or any
    integer/float tensor of bins, converted once); y/f/w (C, n) float32
    contiguous CUDA tensors.  Returns what ``gbm_tree_update_plain`` returns,
    with int32 node arrays.  Raises on a wrong device, dtype, layout or shape
    and on a launch error."""
    dev = f.device
    for name, a in (("y", y), ("f", f), ("w", w)):
        if a.device.type != "cuda" or a.device != dev:
            raise ValueError(f"gbm_tree_update_cuda: {name} must be on {dev}, got {a.device}")
        if a.dtype != torch.float32:
            raise TypeError(f"gbm_tree_update_cuda: {name} must be float32, got {a.dtype}")
        if a.shape != f.shape or a.ndim != 2:
            raise ValueError(f"gbm_tree_update_cuda: {name} must be (C, n) like f, got {tuple(a.shape)}")
        if not a.is_contiguous():
            raise ValueError(f"gbm_tree_update_cuda: {name} must be contiguous")
    c, n = f.shape
    p = xbt.shape[0]
    if xbt.shape != (p, n) or xbt.device != dev:
        raise ValueError(f"gbm_tree_update_cuda: xbt must be (p, {n}) on {dev}, got {tuple(xbt.shape)} on {xbt.device}")
    if not 2 <= nb <= 256 or not 1 <= n_splits <= _MAX_SPLITS:
        raise ValueError(f"gbm_tree_update_cuda: needs 2 <= nb <= 256 and 1 <= n_splits <= {_MAX_SPLITS}")
    if xbt.dtype != torch.uint8:
        xbt = xbt.to(torch.uint8)
    xbt = xbt.contiguous()
    n_total = 2 * n_splits + 1
    f_out = torch.empty_like(f)
    if emit_tree:
        outs = [torch.empty((c, n_total), dtype=dt, device=dev) for dt in (
            torch.int32, torch.int32, torch.float32, torch.int32, torch.int32, torch.float32)]
        outs.append(torch.empty((c, p), dtype=torch.float32, device=dev))
        ptrs = [o.data_ptr() for o in outs]
    else:
        outs, ptrs = [], [None] * 7
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _launcher()(
        xbt.data_ptr(), y.data_ptr(), f.data_ptr(), w.data_ptr(), f_out.data_ptr(), *ptrs,
        c, n, p, nb, n_splits, float(min_leaf), float(lr), stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_grow kernel launch failed: CUDA error {err}")
    LAUNCHES["tree_grow"] += 1
    return (f_out, *outs) if emit_tree else f_out


def split_sequence(feat, thr_bin, internal, left) -> list:
    """The splits of one emitted tree in the order they were made:
    [(node, feature, bin)]; step k split the node whose left child is 2k+1."""
    steps = {}
    for q in np.nonzero(np.asarray(internal) > 0)[0]:
        steps[(int(left[q]) - 1) // 2] = (int(q), int(feat[q]), int(thr_bin[q]))
    return [steps[k] for k in sorted(steps)]


def near_tie_gap(xb, r, w, tree_a, tree_b, *, nb: int, min_leaf: float) -> float | None:
    """How close to a tie the first difference of two trees grown for one
    chain is: None for the same splits, else the relative gap
    |g_a - g_b| / max(|g_a|, |g_b|) between the gains of the two trees'
    choices at their first differing split step (a different node, or a
    different (feature, bin) of the same node), computed exactly in float64
    from the rows that step splits.  A tree that stops where the other
    splits counts the split threshold 1e-9 as its gain.

    xb (n, p) bins, r (n,) residuals y - f, w (n,) bag weights (numpy);
    tree_a / tree_b: (feat, thr_bin, internal, left) node arrays."""
    seq_a, seq_b = split_sequence(*tree_a), split_sequence(*tree_b)
    k = 0
    while k < min(len(seq_a), len(seq_b)) and seq_a[k] == seq_b[k]:
        k += 1
    if k == len(seq_a) == len(seq_b):
        return None
    xb = np.asarray(xb)
    r = np.asarray(r, np.float64)
    w = np.asarray(w, np.float64)
    cur = np.zeros(xb.shape[0], np.int64)
    for i, (q, f, b) in enumerate(seq_a[:k]):
        rows = cur == q
        cur[rows] = np.where(xb[rows, f] <= b, 2 * i + 1, 2 * i + 2)

    def gain(step):
        if step is None:
            return 1e-9
        q, f, b = step
        rows = cur == q
        cw = np.cumsum(np.bincount(xb[rows, f], w[rows], minlength=nb))
        cwy = np.cumsum(np.bincount(xb[rows, f], w[rows] * r[rows], minlength=nb))
        tw, twy = cw[-1], cwy[-1]
        lw, lwy, rw, rwy = cw[b], cwy[b], tw - cw[b], twy - cwy[b]
        if lw < min_leaf or rw < min_leaf or b >= nb - 1:
            return -np.inf
        return lwy * lwy / max(lw, 1e-12) + rwy * rwy / max(rw, 1e-12) - twy * twy / max(tw, 1e-12)

    ga = gain(seq_a[k] if k < len(seq_a) else None)
    gb = gain(seq_b[k] if k < len(seq_b) else None)
    return float(abs(ga - gb) / max(abs(ga), abs(gb), 1e-30))


def prepare_bins(xb, nb: int):
    """(xbt, cum1h) for ``gbm_tree_update`` from (n, p) bins: on a card the
    (p, n) bytes K2 reads and no table; on the CPU the (p, n) bins and the
    plain version's (n, p * nb) cumulative one-hot table."""
    if xb.device.type == "cuda":
        return xb.T.to(torch.uint8).contiguous(), None
    return xb.T.contiguous(), flat_bin_cum_onehot(xb, nb)


def gbm_tree_update(xbt, cum1h, y, f, w, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                    emit_tree: bool = False):
    """Advance every boosting chain by one best-first tree: ``f + lr *
    value[cur]``.  CUDA chains launch K2 (``cum1h`` unused, may be None);
    CPU chains run the plain version.  ``xbt, cum1h`` as ``prepare_bins``
    returns them (either route also accepts raw (p, n) bins and None, and
    converts them on every call).  y/f/w must be float32."""
    if f.dtype != torch.float32:
        raise TypeError(f"gbm_tree_update takes float32 chains, got {f.dtype}; cast first")
    kw = dict(n_splits=n_splits, nb=nb, min_leaf=min_leaf, lr=lr, emit_tree=emit_tree)
    if f.device.type == "cuda":
        return gbm_tree_update_cuda(xbt, y, f, w, **kw)
    return gbm_tree_update_plain(xbt, cum1h, y, f, w, **kw)
