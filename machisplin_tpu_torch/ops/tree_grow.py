"""Best-first boosting trees for many chains: kernel K2 and its plain version.

Counterpart of ``machisplin_tpu/ops/pallas_grow.py``, and the grower of the
serial gbm.step (the JAX package's ``trees.grow_bestfirst_tree``).  For
every boosting chain c (rows of y/f) both versions grow T consecutive
best-first trees of ``n_splits`` splits, tree t on the residuals ``y - f``
with row weights ``bags[t, c]`` over the chain's bins (one table that every
chain shares, or one table per chain), each followed by the boosting update
``f_new = f + lr * value[node of row]`` (and, with ``scale``,
``f = f + scale[t, c] * (f_new - f)``); with ``monotone``, gbm's
var.monotone check bars every split whose child means move against the
feature's sign:

* ``gbm_tree_cycle_cuda`` launches ``csrc/tree_grow.cu`` once for the whole
  cycle (one thread block per chain, f kept between trees); it reads the
  bins as bytes and each feature's rows sorted by bin, and sums each bin's
  own rows, so it needs no cumulative one-hot table.  A chain's rows live
  in shared memory where they fit the block's opt-in (about 6,000 rows at
  p = 5) and in a scratch buffer in device memory beyond that
  (``rows="auto"``; ``"shared"`` or ``"global"`` ask for one): the same
  arithmetic in the same order, so the two layouts give the same bits;
* ``gbm_tree_cycle_plain`` loops over the trees with
  ``gbm_tree_update_plain``, which runs
  ``trees.grow_bestfirst_trees_cumshared``, the JAX package's
  ``gbm_tree_update_ref``.

``prepare_bins`` turns (n, p) bins, or (C, n, p) bins of C chains, into the
``BinTables`` both routes read, once per fit, on the bins' device.
``gbm_tree_cycle`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; there is no fallback between the two.
``gbm_tree_update`` is its one-tree case on raw (p, n) bins, whose tables
it builds on the call.  Chains are float32 only (the TPU kernel's outputs
are float32); callers cast.  ``LAUNCHES`` counts kernel launches and the
boosting steps they grew (one tree of every chain each).  ``near_tie_gap``
says how close to a tie the first difference between two trees grown for
one chain is, and ``cycle_agreement`` holds a grown cycle to the plain
version tree by tree with it, for checking the kernel where float32
summation order may part its trees from the plain version's.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..models.trees import flat_bin_cum_onehot, grow_bestfirst_trees_cumshared

__all__ = [
    "BinTables", "Cycle", "cycle_agreement", "gbm_tree_cycle", "gbm_tree_cycle_cuda", "gbm_tree_cycle_plain",
    "gbm_tree_update", "gbm_tree_update_plain", "near_tie_gap", "prepare_bins", "split_sequence", "LAUNCHES",
]

# since the last reset: kernel launches, and boosting steps they grew
LAUNCHES = {"tree_grow": 0, "tree_grow_trees": 0}

_MAX_SPLITS = 127   # node ids live in one byte in the kernel
_INT16_ROWS = 32767  # sorted rows fit int16 up to here, int32 beyond


class BinTables(NamedTuple):
    """The bins as the routes read them, made by ``prepare_bins``: the
    kernel reads xbt, order and offsets, the plain version xbt and cum1h.
    One table that every chain reads has the shapes below; one table per
    chain has a leading chain axis on each."""
    xbt: torch.Tensor              # (p, n) bins: uint8 on a card, the given integers on the CPU
    order: torch.Tensor            # (p, n) each feature's rows sorted by bin, stable by row index (int16, or int32 past 32767 rows)
    offsets: torch.Tensor          # (p, nb + 1) int32: bin b's rows are order[f, offsets[f, b]:offsets[f, b + 1]]
    cum1h: torch.Tensor | None     # the plain version's (n, p * nb) cumulative one-hot; None on a card


class Cycle(NamedTuple):
    """What a cycle of T trees returns."""
    f: torch.Tensor                # (C, n) after the last tree's update
    trees: tuple | None            # with emit_tree: feat, thr_bin, internal, left, right, value (T, C, 2J+1), var_gain (T, C, p)
    deviance: torch.Tensor | None  # with deviance_w: (T, C, 2) sums of deviance_w[k] * (y - f)^2 after each tree


def prepare_bins(xb, nb: int) -> BinTables:
    """The ``BinTables`` of (n, p) bins in [0, nb), or of (C, n, p) bins
    (one table per chain), on the bins' device: the kernel's bytes on a
    card, the bins and the plain version's cumulative one-hot table on the
    CPU, and on both each feature's rows sorted by bin with the bins'
    offsets into them."""
    n, p = xb.shape[-2:]
    xbt = xb.transpose(-1, -2).contiguous()
    if bool(((xbt < 0) | (xbt >= nb)).any()):
        raise ValueError(f"prepare_bins: bins must lie in [0, {nb})")
    idx = xbt.long()
    order = torch.argsort(idx, dim=-1, stable=True).to(torch.int16 if n <= _INT16_ROWS else torch.int32)
    counts = torch.zeros(idx.shape[:-1] + (nb,), dtype=torch.int64, device=xb.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx))
    offsets = torch.cat([counts.new_zeros(counts.shape[:-1] + (1,)), counts.cumsum(-1)], -1).to(torch.int32)
    if xb.device.type == "cuda":
        return BinTables(xbt.to(torch.uint8), order, offsets, None)
    return BinTables(xbt, order, offsets, flat_bin_cum_onehot(xb, nb))


def gbm_tree_update_plain(xbt, cum1h, y, f, w, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                          emit_tree: bool = False, monotone=None):
    """One tree of the kernel's function in plain PyTorch, in the chains' dtype.

    xbt (p, n) bins, or (C, p, n) one table per chain; cum1h the matching
    ``flat_bin_cum_onehot`` (built from xbt when None); y/f/w (C, n);
    monotone (p,) signs or None.  Returns f + lr * value[cur], and with
    ``emit_tree`` also feat, thr_bin, internal, left, right, value (each
    (C, 2J+1)) and var_gain (C, p); thr_bin holds bin indices."""
    xb = xbt.transpose(-1, -2).long()
    if cum1h is None:
        cum1h = flat_bin_cum_onehot(xb, nb)
    out = grow_bestfirst_trees_cumshared(
        xb, y - f, w, n_splits=n_splits, min_leaf=min_leaf, bin_cum1h=cum1h, return_tree=emit_tree,
        monotone=monotone,
    )
    value, cur = out[0], out[1]
    f_new = f + lr * value.gather(1, cur)
    if emit_tree:
        tree = out[2]
        return (f_new,) + tree[:5] + (value, tree[5])
    return f_new


def gbm_tree_cycle_plain(tables: BinTables, y, f, bags, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                         scale=None, emit_tree: bool = False, deviance_w=None, monotone=None) -> Cycle:
    """The kernel's function in plain PyTorch: T = ``bags.shape[0]`` calls of
    ``gbm_tree_update_plain``, each followed by the cycle's update."""
    kw = dict(n_splits=n_splits, nb=nb, min_leaf=min_leaf, lr=lr, emit_tree=emit_tree, monotone=monotone)
    trees, devs = [], []
    for t in range(bags.shape[0]):
        out = gbm_tree_update_plain(tables.xbt, tables.cum1h, y, f, bags[t], **kw)
        f_new = out[0] if emit_tree else out
        f = f_new if scale is None else f + scale[t][:, None] * (f_new - f)
        if emit_tree:
            trees.append(out[1:])
        if deviance_w is not None:
            r2 = (y - f) ** 2
            devs.append(torch.stack([(deviance_w[0] * r2).sum(1), (deviance_w[1] * r2).sum(1)], 1))
    return Cycle(
        f,
        tuple(torch.stack([tr[k] for tr in trees]) for k in range(7)) if emit_tree else None,
        torch.stack(devs) if deviance_w is not None else None,
    )


def _bind(lib):
    """Declare the C interface of a loaded ``tree_grow`` library."""
    fn = lib.tree_grow_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 10                      # xbt, order, offsets, mono, y, f_in, bags, scale, dev_w, scratch
        + [ctypes.c_void_p] * 9                     # f_out, feat, thr, internal, left, right, value, var_gain, dev_out
        + [ctypes.c_int] * 9                        # n_trees, n_chains, n_tables, n, p, nb, n_splits, order_bytes, rows_global
        + [ctypes.c_float] * 2                      # min_leaf, lr
        + [ctypes.c_void_p]                         # stream
    )
    for name in ("tree_grow_smem_bytes", "tree_grow_scratch_bytes"):
        getattr(lib, name).restype = ctypes.c_longlong
    lib.tree_grow_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.tree_grow_scratch_bytes.argtypes = [ctypes.c_int]
    lib.tree_grow_rows_global.restype = ctypes.c_int
    lib.tree_grow_rows_global.argtypes = [ctypes.c_int] * 4
    return lib


@functools.cache
def _library():
    from ..kernels.build import load_library

    return _bind(load_library("tree_grow"))


def smem_bytes(n: int, p: int, nb: int, n_splits: int, rows_global: bool = False) -> int:
    """Dynamic shared memory of a K2 launch at these sizes (one block), with
    the rows in shared memory or, with ``rows_global``, in device memory."""
    return int(_library().tree_grow_smem_bytes(n, p, nb, n_splits, int(rows_global)))


def _check(name, a, shape, dtype, dev):
    if a.device != dev:
        raise ValueError(f"gbm_tree_cycle_cuda: {name} must be on {dev}, got {a.device}")
    if a.dtype != dtype:
        raise TypeError(f"gbm_tree_cycle_cuda: {name} must be {dtype}, got {a.dtype}")
    if tuple(a.shape) != tuple(shape):
        raise ValueError(f"gbm_tree_cycle_cuda: {name} must be {tuple(shape)}, got {tuple(a.shape)}")
    if not a.is_contiguous():
        raise ValueError(f"gbm_tree_cycle_cuda: {name} must be contiguous")


def gbm_tree_cycle_cuda(tables: BinTables, y, f, bags, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                        scale=None, emit_tree: bool = False, deviance_w=None, monotone=None,
                        rows: str = "auto") -> Cycle:
    """Launch K2 once for T = ``bags.shape[0]`` trees on the current stream.
    ``tables`` from ``prepare_bins`` on the chains' card (one table, or one
    per chain); y/f (C, n), bags (T, C, n), scale (T, C), deviance_w
    (2, C, n) and monotone (p,) float32 contiguous CUDA tensors.  ``rows``:
    where a chain's rows live, "shared" memory, "global" memory (a scratch
    buffer allocated here), or "auto": shared where they fit.  Returns what
    ``gbm_tree_cycle_plain`` returns, with int32 node arrays.  Raises on a
    wrong device, dtype, layout or shape and on a launch error."""
    dev = f.device
    if dev.type != "cuda":
        raise ValueError(f"gbm_tree_cycle_cuda: f must be on a CUDA device, got {dev}")
    if f.ndim != 2 or bags.ndim != 3:
        raise ValueError(f"gbm_tree_cycle_cuda: needs f (C, n) and bags (T, C, n), got {tuple(f.shape)}, "
                         f"{tuple(bags.shape)}")
    if rows not in ("auto", "shared", "global"):
        raise ValueError(f"gbm_tree_cycle_cuda: rows must be 'auto', 'shared' or 'global', got {rows!r}")
    c, n = f.shape
    n_trees = bags.shape[0]
    per_chain = tables.xbt.ndim == 3
    lead = (c,) if per_chain else ()
    p = tables.xbt.shape[-2]
    if not 2 <= nb <= 256 or not 1 <= n_splits <= _MAX_SPLITS or n_trees < 1:
        raise ValueError(f"gbm_tree_cycle_cuda: needs 2 <= nb <= 256, 1 <= n_splits <= {_MAX_SPLITS} and T >= 1")
    _check("xbt", tables.xbt, lead + (p, n), torch.uint8, dev)
    order_dt = torch.int16 if tables.order.dtype == torch.int16 and n <= _INT16_ROWS else torch.int32
    _check("order", tables.order, lead + (p, n), order_dt, dev)
    _check("offsets", tables.offsets, lead + (p, nb + 1), torch.int32, dev)
    _check("y", y, (c, n), torch.float32, dev)
    _check("f", f, (c, n), torch.float32, dev)
    _check("bags", bags, (n_trees, c, n), torch.float32, dev)
    if scale is not None:
        _check("scale", scale, (n_trees, c), torch.float32, dev)
    if deviance_w is not None:
        _check("deviance_w", deviance_w, (2, c, n), torch.float32, dev)
    if monotone is not None:
        _check("monotone", monotone, (p,), torch.float32, dev)
    lib = _library()
    need_global = int(lib.tree_grow_rows_global(n, p, nb, n_splits))
    if need_global < 0:
        raise RuntimeError(f"tree_grow: CUDA error {-need_global} reading the device's shared memory")
    if rows == "shared" and (need_global or order_dt != torch.int16):
        raise ValueError(f"gbm_tree_cycle_cuda: {n} rows at p = {p}, nb = {nb} do not fit a block's shared memory")
    rows_global = rows == "global" or (rows == "auto" and (need_global or order_dt != torch.int16))
    scratch = None
    if rows_global:
        scratch = torch.empty((c * int(lib.tree_grow_scratch_bytes(n)),), dtype=torch.uint8, device=dev)
    n_total = 2 * n_splits + 1
    f_out = torch.empty_like(f)
    trees, tree_ptrs = None, [None] * 7
    if emit_tree:
        trees = tuple(torch.empty((n_trees, c, n_total), dtype=dt, device=dev) for dt in (
            torch.int32, torch.int32, torch.float32, torch.int32, torch.int32, torch.float32))
        trees += (torch.empty((n_trees, c, p), dtype=torch.float32, device=dev),)
        tree_ptrs = [a.data_ptr() for a in trees]
    dev_out = None if deviance_w is None else torch.empty((n_trees, c, 2), dtype=torch.float32, device=dev)
    ptr = lambda a: None if a is None else a.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.tree_grow_launch(
        tables.xbt.data_ptr(), tables.order.data_ptr(), tables.offsets.data_ptr(), ptr(monotone), y.data_ptr(),
        f.data_ptr(), bags.data_ptr(), ptr(scale), ptr(deviance_w), ptr(scratch), f_out.data_ptr(), *tree_ptrs,
        ptr(dev_out), n_trees, c, c if per_chain else 1, n, p, nb, n_splits, 2 if order_dt == torch.int16 else 4,
        int(rows_global), float(min_leaf), float(lr), stream,
    )
    if err != 0:
        raise RuntimeError(f"tree_grow kernel launch failed: CUDA error {err}")
    LAUNCHES["tree_grow"] += 1
    LAUNCHES["tree_grow_trees"] += n_trees
    return Cycle(f_out, trees, dev_out)


def gbm_tree_cycle(tables: BinTables, y, f, bags, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                   scale=None, emit_tree: bool = False, deviance_w=None, monotone=None) -> Cycle:
    """Advance every boosting chain by T = ``bags.shape[0]`` best-first trees.
    CUDA chains launch K2 once; CPU chains run the plain version.
    ``tables`` from ``prepare_bins`` (one table, or one per chain); y/f
    (C, n) float32; bags (T, C, n) each tree's row weights; ``scale``
    (T, C) or None: after tree t, ``f = f + scale[t] * (f_new - f)`` in
    place of ``f = f_new``; ``deviance_w`` (2, C, n) or None: the weights
    of the two deviance sums returned after each tree; ``monotone`` (p,)
    float32 signs in {-1, 0, 1} or None (gbm's var.monotone)."""
    if f.dtype != torch.float32:
        raise TypeError(f"gbm_tree_cycle takes float32 chains, got {f.dtype}; cast first")
    kw = dict(n_splits=n_splits, nb=nb, min_leaf=min_leaf, lr=lr, scale=scale, emit_tree=emit_tree,
              deviance_w=deviance_w, monotone=monotone)
    if f.device.type == "cuda":
        return gbm_tree_cycle_cuda(tables, y, f, bags, **kw)
    return gbm_tree_cycle_plain(tables, y, f, bags, **kw)


def gbm_tree_update(xbt, cum1h, y, f, w, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                    emit_tree: bool = False):
    """One tree for every chain, the T = 1 case of ``gbm_tree_cycle``,
    called as ``gbm_tree_update_plain`` is: raw (p, n) bins ``xbt`` whose
    tables are built on this call (``cum1h``, if not None, serves the plain
    version on the CPU); y/f/w (C, n) float32.  Returns
    ``f + lr * value[cur]``, and with ``emit_tree`` the tree's arrays as
    ``gbm_tree_update_plain`` returns them."""
    if f.dtype != torch.float32:
        raise TypeError(f"gbm_tree_update takes float32 chains, got {f.dtype}; cast first")
    tables = prepare_bins(xbt.T, nb)
    if cum1h is not None and tables.cum1h is not None:
        tables = tables._replace(cum1h=cum1h)
    out = gbm_tree_cycle(tables, y, f, w[None], n_splits=n_splits, nb=nb, min_leaf=min_leaf, lr=lr,
                         emit_tree=emit_tree)
    return (out.f,) + tuple(a[0] for a in out.trees) if emit_tree else out.f


def split_sequence(feat, thr_bin, internal, left) -> list:
    """The splits of one emitted tree in the order they were made:
    [(node, feature, bin)]; step k split the node whose left child is 2k+1."""
    steps = {}
    for q in np.nonzero(np.asarray(internal) > 0)[0]:
        steps[(int(left[q]) - 1) // 2] = (int(q), int(feat[q]), int(thr_bin[q]))
    return [steps[k] for k in sorted(steps)]


def near_tie_gap(xb, r, w, tree_a, tree_b, *, nb: int, min_leaf: float, monotone=None) -> float | None:
    """How close to a tie the first difference of two trees grown for one
    chain is: None for the same splits, else the relative gap
    |g_a - g_b| / max(|g_a|, |g_b|) between the gains of the two trees'
    choices at their first differing split step (a different node, or a
    different (feature, bin) of the same node), computed exactly in float64
    from the rows that step splits.  A tree that stops where the other
    splits counts the split threshold 1e-9 as its gain; a choice that is no
    valid split (gain -inf) gives inf.

    xb (n, p) bins, r (n,) residuals y - f, w (n,) bag weights (numpy);
    tree_a / tree_b: (feat, thr_bin, internal, left) node arrays; monotone
    (p,) signs or None: a choice that breaks its feature's sign is no valid
    split."""
    seq_a, seq_b = split_sequence(*tree_a), split_sequence(*tree_b)
    k = 0
    while k < min(len(seq_a), len(seq_b)) and seq_a[k] == seq_b[k]:
        k += 1
    if k == len(seq_a) == len(seq_b):
        return None
    xb = np.asarray(xb)
    mono = None if monotone is None else np.asarray(monotone, np.float64)
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
        if mono is not None and mono[f] * (rwy / max(rw, 1e-12) - lwy / max(lw, 1e-12)) < 0:
            return -np.inf
        return lwy * lwy / max(lw, 1e-12) + rwy * rwy / max(rw, 1e-12) - twy * twy / max(tw, 1e-12)

    ga = gain(seq_a[k] if k < len(seq_a) else None)
    gb = gain(seq_b[k] if k < len(seq_b) else None)
    if not (np.isfinite(ga) and np.isfinite(gb)):
        return float("inf")
    return float(abs(ga - gb) / max(abs(ga), abs(gb), 1e-30))


def cycle_agreement(xb, y, f, bags, got: Cycle, *, n_splits: int, nb: int, min_leaf: float, lr: float,
                    scale=None, deviance_w=None, cum1h=None, monotone=None) -> dict:
    """How a cycle grown with ``emit_tree`` (``got``) agrees with the plain
    version grown tree by tree from the same inputs (y, f, bags, scale,
    deviance_w, monotone as ``gbm_tree_cycle`` takes them; xb the (n, p)
    bins, or (C, n, p) one table per chain, cum1h their plain table or
    None).  Each chain's trees are compared in order up
    to the first whose splits differ; that tree's ``near_tie_gap`` is
    recorded and the chain is compared no further.  Returns
    ``identical_chains`` (chains whose T trees all agree), ``gaps``
    [(chain, tree, gap)], ``max_abs_err`` of f over the identical chains,
    ``resid_scale`` max |y - f| over the cycle's trees, and
    ``max_rel_err_deviance``: over the trees before each chain's first
    difference, |got - plain| / |plain| of the deviance sums (None without
    ``deviance_w``)."""
    n_trees, c, _ = bags.shape
    xb_np = xb.cpu().numpy()
    xb_c = (lambda ch: xb_np[ch]) if xb.ndim == 3 else (lambda ch: xb_np)
    mono = None if monotone is None else monotone.cpu().numpy()
    tables = BinTables(xb.transpose(-1, -2).contiguous(), None, None,
                       flat_bin_cum_onehot(xb, nb) if cum1h is None else cum1h)
    got_trees = [a.cpu().numpy() for a in got.trees[:4]]
    got_dev = None if deviance_w is None else got.deviance.cpu().numpy()
    first_diff = np.full(c, n_trees)
    gaps, dev_err, resid = [], 0.0 if deviance_w is not None else None, 0.0
    for t in range(n_trees):
        want = gbm_tree_cycle_plain(tables, y, f, bags[t : t + 1], n_splits=n_splits, nb=nb, min_leaf=min_leaf,
                                    lr=lr, scale=None if scale is None else scale[t : t + 1], emit_tree=True,
                                    deviance_w=deviance_w, monotone=monotone)
        r = (y - f).cpu().numpy()
        resid = max(resid, float(np.abs(r).max()))
        want_trees = [a[0].cpu().numpy() for a in want.trees[:4]]
        bag = bags[t].cpu().numpy()
        for ch in np.nonzero(first_diff == n_trees)[0]:
            gap = near_tie_gap(xb_c(ch), r[ch], bag[ch], [a[ch] for a in want_trees], [a[t, ch] for a in got_trees],
                               nb=nb, min_leaf=min_leaf, monotone=mono)
            if gap is not None:
                gaps.append((int(ch), t, gap))
                first_diff[ch] = t
            elif got_dev is not None:
                wd = want.deviance[0, ch].cpu().numpy()
                err = np.abs(got_dev[t, ch] - wd) / np.maximum(np.abs(wd), 1e-30)
                dev_err = max(dev_err, float(err.max()))
        f = want.f
    same = first_diff == n_trees
    err = float((got.f - f).abs()[torch.as_tensor(same, device=f.device)].max()) if same.any() else 0.0
    return {"identical_chains": int(same.sum()), "chains": c, "trees": n_trees, "gaps": gaps,
            "max_abs_err": err, "resid_scale": resid, "max_rel_err_deviance": dev_err}
