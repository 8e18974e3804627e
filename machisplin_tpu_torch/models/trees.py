"""Decision-tree infrastructure for the boosted trees and the random forest
(counterpart of ``machisplin_tpu/models/trees.py``, the parts the gbm.step
and random-forest paths run).

Features are binned into per-feature quantile histograms (64 bins), so a
split search is a scan over (feature, bin) statistics; trees are stored as
flat arrays (feat, thr, internal, left, right, value) with the best-first
slot layout of gbm's ``interaction.depth`` split budget: J splits, children
of the k-th split in slots 2k+1 and 2k+2.  ``grow_level_trees`` grows the
random forest's CART trees level-wise in the heap layout instead.

``grow_bestfirst_trees_cumshared`` grows K trees at once from cumulative
split statistics, over one bin table or one per tree, with gbm's monotone
check; it is the plain version of kernel K2 (``ops/tree_grow.py``,
``csrc/tree_grow.cu``).  ``grow_bestfirst_trees_shared`` grows K trees on
one table from per-bin histograms with leaves from the final rows, and
``assigned_predict_batched`` reads their leaves: the JAX package's
shared-bins grower, kept as a plain version to compare with (the port's
gbm.step grows every tree on K2).  ``make_bins_masked`` bins a CV fold on its own
training rows, and ``route_bins`` finds each training row's node in grown
trees by its bins.  ``tree_assign`` and ``forest_predict`` route points
through the trees one level at a time, the plain oracle of kernel K3
(``ops/forest.py``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .base import chunk_elems

__all__ = [
    "Tree", "make_bins", "make_bins_masked", "bin_data", "flat_bin_onehot", "flat_bin_cum_onehot", "edges_lookup",
    "grow_bestfirst_trees_cumshared", "grow_bestfirst_trees_shared", "assigned_predict_batched", "route_bins",
    "grow_level_trees", "grow_level_tree", "draw_mtry_scores", "assigned_predict", "tree_assign", "tree_predict",
    "forest_predict",
]


class Tree(NamedTuple):
    feat: torch.Tensor      # (..., N) int split feature (0 where leaf)
    thr: torch.Tensor       # (..., N) raw-scale threshold; go left iff x <= thr
    internal: torch.Tensor  # (..., N) 1.0 if split node
    left: torch.Tensor      # (..., N) int child ids
    right: torch.Tensor     # (..., N)
    value: torch.Tensor     # (..., N) node value (leaf prediction)
    var_gain: torch.Tensor  # (..., p) summed split gain per feature (importance)


def make_bins(x, n_bins: int = 64) -> torch.Tensor:
    """Per-feature quantile bin edges, (p, n_bins - 1), in ``x``'s dtype.

    Linear interpolation between order statistics with the positions and
    weights in float64, as ``jnp.quantile`` computes them with x64 on."""
    x = torch.as_tensor(x)
    n = x.shape[0]
    qs = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float64, device=x.device)[1:-1]
    pos = qs * float(n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    hw = pos - low
    lw = 1.0 - hw
    low = low.clamp(0, n - 1).long()
    high = high.clamp(0, n - 1).long()
    xs = torch.sort(x, dim=0).values.to(torch.float64)
    out = xs[low] * lw[:, None] + xs[high] * hw[:, None]      # (nb-1, p)
    return out.to(x.dtype).T.contiguous()


def make_bins_masked(x, w, n_bins: int = 64) -> torch.Tensor:
    """Quantile bin edges over the rows with ``w`` > 0: (p, n_bins - 1) for
    w (n,), (K, p, n_bins - 1) for w (K, n), in ``x``'s dtype; ``x`` is
    (n, p), or (K, n, p) for one matrix per table.

    A CV fold's split candidates from its own training rows (the per-fold
    ``gbm::gbm`` calls of the reference, V73:1830/1908): linear
    interpolation between order statistics of the active rows, with the
    positions in ``x``'s dtype, as the JAX package's ``make_bins_masked``
    computes them."""
    x = torch.as_tensor(x)
    w = torch.as_tensor(w, device=x.device)
    single = w.ndim == 1
    w = w[None] if single else w
    n, p = x.shape[-2:]
    big = torch.finfo(x.dtype).max
    active = w > 0
    xk = x if x.ndim == 3 else x[None]
    xs = torch.sort(torch.where(active[:, :, None], xk, big), dim=1).values           # (K, n, p), active first
    na = active.sum(1)                                                               # (K,)
    qs = torch.linspace(0.0, 1.0, n_bins + 1, dtype=torch.float64, device=x.device)[1:-1].to(x.dtype)
    top = (na - 1).clamp_min(0)
    pos = qs[None, :] * top[:, None].to(x.dtype)                                     # (K, nb - 1)
    lo = torch.floor(pos).long()
    hi = torch.minimum(lo + 1, top[:, None])
    frac = (pos - lo.to(x.dtype))[:, None, :]
    take = lambda idx: xs.gather(1, idx[:, :, None].expand(-1, -1, p)).transpose(1, 2)  # (K, p, nb - 1)
    out = take(lo) * (1 - frac) + take(hi) * frac
    return out[0] if single else out


def bin_data(x, edges) -> torch.Tensor:
    """Bin index per (sample, feature): the number of edges strictly below x,
    (n, p) int64 for edges (p, nb - 1), or (C, n, p) for C tables' edges
    (C, p, nb - 1)."""
    x = torch.as_tensor(x)
    if edges.ndim == 3:
        return torch.stack([bin_data(x, e) for e in edges])
    return (x[:, :, None] > edges[None, :, :]).sum(dim=2)


def flat_bin_onehot(xb, nb: int) -> torch.Tensor:
    """(n, p * nb) bfloat16 one-hot of (n, p) bins: 1 iff ``xb[i, f] == b``
    (0/1 is exact in bfloat16)."""
    n, p = xb.shape
    b = torch.arange(nb, dtype=xb.dtype, device=xb.device)
    return (xb[:, :, None] == b).to(torch.bfloat16).reshape(n, p * nb)


def flat_bin_cum_onehot(xb, nb: int) -> torch.Tensor:
    """(n, p * nb) bfloat16 cumulative one-hot: 1 iff ``xb[i, f] <= b``
    (with leading axes, one table each: (..., n, p) bins give (..., n, p * nb)).

    Contracting weights against it gives left-cumulative split statistics:
    ``(w @ cum1h)[f * nb + b]`` is the sum of w over rows with bin_f <= b.
    0/1 is exact in bfloat16."""
    p = xb.shape[-1]
    b = torch.arange(nb, dtype=xb.dtype, device=xb.device)
    return (xb[..., None] <= b).to(torch.bfloat16).reshape(xb.shape[:-1] + (p * nb,))


def edges_lookup(edges, feat, thr_bin) -> torch.Tensor:
    """``edges[feat, clip(thr_bin)]``: the raw threshold of a bin split."""
    nbm1 = edges.shape[1]
    return edges[feat.long(), thr_bin.long().clamp(0, nbm1 - 1)]


def _hist_cum(a, cum1h):
    """(r, n) @ (n, L), or (K, r, n) @ (K, n, L), in the gbm histogram
    accuracy class: ``a`` splits into bfloat16 hi and lo halves, each
    contracts in float32 against the exact 0/1 table, and the two float32
    sums add (~1e-5 relative).  These sums only rank split candidates; node
    totals and leaf values are exact."""
    hi = a.to(torch.bfloat16)
    lo = (a - hi.to(a.dtype)).to(torch.bfloat16)
    c = cum1h.to(torch.float32)
    return (hi.to(torch.float32) @ c + lo.to(torch.float32) @ c).to(a.dtype)


def _best_splits_cum(clw, clwy, tw, twy, min_leaf, feat_mask=None, monotone=None):
    """Best (feature, bin) per row of (R, p, nb) cumulative stats with (R, 1, 1)
    totals: gbm's squared-error gain, candidates with at least ``min_leaf``
    weight on both sides and a non-empty right side (b < nb - 1), on the
    features where ``feat_mask`` (R, p) is > 0 if given, and with
    ``monotone`` (p,) signs in {-1, 0, +1} only where the right child's mean
    minus the left's does not take the opposite sign (gbm's var.monotone,
    V73:1670/1772); the first maximum in flattened (feature, bin) order wins
    a tie."""
    eps = 1e-12
    rw, rwy = tw - clw, twy - clwy
    gain = clwy * clwy / clw.clamp_min(eps) + rwy * rwy / rw.clamp_min(eps) - twy * twy / tw.clamp_min(eps)
    r, p, nb = gain.shape
    pos = torch.arange(nb, device=gain.device)
    ok = (clw >= min_leaf) & (rw >= min_leaf) & (pos < nb - 1)
    if feat_mask is not None:
        ok = ok & (feat_mask[:, :, None] > 0)
    if monotone is not None:
        sgn = torch.as_tensor(monotone, device=gain.device).to(gain.dtype)[None, :, None]
        ok = ok & ~(sgn * (rwy / rw.clamp_min(eps) - clwy / clw.clamp_min(eps)) < 0)
    flat = torch.where(ok, gain, torch.full((), -torch.inf, dtype=gain.dtype, device=gain.device))
    flat = flat.reshape(r, p * nb)
    best = torch.argmax(flat, dim=1)
    return flat.max(dim=1).values, best // nb, best % nb


def _best_splits(hw, hwy, min_leaf):
    """Best (feature, bin) per row of (R, p, nb) per-bin histograms: their
    cumulative sums, with the totals from the last bin, through
    ``_best_splits_cum``."""
    c2 = torch.cumsum(torch.stack([hw, hwy]), dim=3)
    cw, cwy = c2[0], c2[1]
    return _best_splits_cum(cw, cwy, cw[:, :, -1:], cwy[:, :, -1:], min_leaf)


def grow_bestfirst_trees_shared(xb, ys, ws, *, n_splits: int, min_leaf: float, bin1h):
    """K best-first regression trees at once on ONE shared (n, p) bin table
    from per-bin histograms (``bin1h`` its ``flat_bin_onehot``): the JAX
    package's ``grow_bestfirst_trees_shared``.  ``ys`` (K, n) targets, ``ws``
    (K, n) row weights.  Each step splits the node of largest gain (ties:
    lowest slot) if that gain exceeds 1e-9; the left and parent histograms
    come from one ``_hist_cum`` contraction, the right child's by
    subtraction; leaf values are swy / max(sw, 1e-12) over each node's final
    rows.  Returns (value (K, 2J+1), cur (K, n))."""
    n, p = xb.shape
    k_chains = ws.shape[0]
    dtype, dev = ys.dtype, ys.device
    n_total = 2 * n_splits + 1
    nb = bin1h.shape[1] // p
    neg = torch.full((), -torch.inf, dtype=dtype, device=dev)
    iota_nodes = torch.arange(n_total, device=dev)
    rows = torch.arange(k_chains, device=dev)
    wys = ws * ys
    root = _hist_cum(torch.cat([ws, wys], dim=0), bin1h)
    g0, f0, b0 = _best_splits(root[:k_chains].reshape(k_chains, p, nb), root[k_chains:].reshape(k_chains, p, nb),
                              min_leaf)
    node_gain = torch.full((k_chains, n_total), -torch.inf, dtype=dtype, device=dev)
    node_feat = torch.zeros((k_chains, n_total), dtype=torch.int64, device=dev)
    node_bin = torch.zeros((k_chains, n_total), dtype=torch.int64, device=dev)
    node_gain[:, 0], node_feat[:, 0], node_bin[:, 0] = g0, f0, b0
    cur = torch.zeros((k_chains, n), dtype=torch.int64, device=dev)
    xbt = xb.T
    for k in range(n_splits):
        q = torch.argmax(node_gain, dim=1)
        ok = node_gain[rows, q] > 1e-9
        bfq, bbq = node_feat[rows, q], node_bin[rows, q]
        lid, rid = 2 * k + 1, 2 * k + 2
        in_parent = ok[:, None] & (cur == q[:, None])
        go_left = in_parent & (xbt[bfq] <= bbq[:, None])
        lm, pm = go_left.to(dtype), in_parent.to(dtype)
        h = _hist_cum(torch.cat([ws * lm, wys * lm, ws * pm, wys * pm], dim=0), bin1h)
        hl_w, hl_wy = h[:k_chains], h[k_chains : 2 * k_chains]
        hp_w, hp_wy = h[2 * k_chains : 3 * k_chains], h[3 * k_chains :]
        cw = torch.cat([hl_w, hp_w - hl_w], dim=0).reshape(2 * k_chains, p, nb)
        cwy = torch.cat([hl_wy, hp_wy - hl_wy], dim=0).reshape(2 * k_chains, p, nb)
        cg, cf, cb = _best_splits(cw, cwy, min_leaf)
        node_gain = torch.where(iota_nodes[None, :] == q[:, None], neg, node_gain)
        node_gain[:, lid] = torch.where(ok, cg[:k_chains], neg)
        node_gain[:, rid] = torch.where(ok, cg[k_chains:], neg)
        node_feat[:, lid], node_feat[:, rid] = cf[:k_chains], cf[k_chains:]
        node_bin[:, lid], node_bin[:, rid] = cb[:k_chains], cb[k_chains:]
        cur = torch.where(in_parent, torch.where(go_left, lid, rid), cur)
    node1h = (cur[:, :, None] == iota_nodes).to(dtype)                        # (K, n, N)
    sw = torch.einsum("knt,kn->kt", node1h, ws)
    swy = torch.einsum("knt,kn->kt", node1h, wys)
    return swy / sw.clamp_min(1e-12), cur


def grow_bestfirst_trees_cumshared(xb, ys, ws, *, n_splits: int, min_leaf: float, bin_cum1h,
                                   return_tree: bool = False, monotone=None):
    """K best-first regression trees at once from cumulative statistics.

    ``xb`` (n, p) bins shared by every tree, or (K, n, p) one table per
    tree; ``ys`` (K, n) targets (boosting residuals); ``ws`` (K, n) row
    weights (0 = out of bag); ``bin_cum1h`` the ``flat_bin_cum_onehot`` of
    ``xb``, (n, p * nb) or (K, n, p * nb); ``monotone`` (p,) signs or None
    (``_best_splits_cum``).  Each step splits the node of largest gain
    (ties: lowest slot) if that gain exceeds 1e-9, into slots 2k+1
    (bin <= thr) and 2k+2.  Split statistics come from ``_hist_cum``; node
    totals are exact row sums taken when a node is created, and a leaf's
    value is swy / max(sw, 1e-12).

    Returns (value (K, 2J+1), cur (K, n) final node of every row), plus
    (feat, thr_bin, internal, left, right, var_gain) with ``return_tree``.
    """
    n, p = xb.shape[-2:]
    k_chains = ws.shape[0]
    dtype, dev = ys.dtype, ys.device
    n_total = 2 * n_splits + 1
    nb = bin_cum1h.shape[-1] // p
    neg = torch.full((), -torch.inf, dtype=dtype, device=dev)
    iota_nodes = torch.arange(n_total, device=dev)
    p_iota = torch.arange(p, device=dev)
    rows = torch.arange(k_chains, device=dev)
    wys = ws * ys
    if xb.ndim == 3:   # chain k's rows of a (m * K, n) against its own table: (K, m, n) @ (K, n, L)
        hist = lambda a: _hist_cum(a.reshape(-1, k_chains, n).transpose(0, 1), bin_cum1h).transpose(0, 1).reshape(
            a.shape[0], -1)
    else:
        hist = lambda a: _hist_cum(a, bin_cum1h)
    best = functools.partial(_best_splits_cum, min_leaf=min_leaf, monotone=monotone)

    croot = hist(torch.cat([ws, wys], dim=0))
    tw = ws.sum(dim=1)
    twy = wys.sum(dim=1)
    g0, f0, b0 = best(
        croot[:k_chains].reshape(k_chains, p, nb), croot[k_chains:].reshape(k_chains, p, nb),
        tw[:, None, None], twy[:, None, None],
    )
    node_gain = torch.full((k_chains, n_total), -torch.inf, dtype=dtype, device=dev)
    node_feat = torch.zeros((k_chains, n_total), dtype=torch.int64, device=dev)
    node_bin = torch.zeros((k_chains, n_total), dtype=torch.int64, device=dev)
    node_sw = torch.zeros((k_chains, n_total), dtype=dtype, device=dev)
    node_swy = torch.zeros((k_chains, n_total), dtype=dtype, device=dev)
    node_gain[:, 0], node_feat[:, 0], node_bin[:, 0] = g0, f0, b0
    node_sw[:, 0], node_swy[:, 0] = tw, twy
    cur = torch.zeros((k_chains, n), dtype=torch.int64, device=dev)
    xbt = xb.transpose(-1, -2)
    if return_tree:
        t_feat = torch.zeros((k_chains, n_total), dtype=torch.int64, device=dev)
        t_thr = torch.zeros_like(t_feat)
        t_int = torch.zeros((k_chains, n_total), dtype=dtype, device=dev)
        t_left = torch.zeros_like(t_feat)
        t_right = torch.zeros_like(t_feat)
        t_vg = torch.zeros((k_chains, p), dtype=dtype, device=dev)

    zero = torch.zeros((), dtype=dtype, device=dev)
    for k in range(n_splits):
        q = torch.argmax(node_gain, dim=1)                   # (K,) first max
        gq = node_gain[rows, q]
        ok = gq > 1e-9
        bfq = node_feat[rows, q]
        bbq = node_bin[rows, q]
        lid, rid = 2 * k + 1, 2 * k + 2
        sample_bin = xbt[rows, bfq] if xb.ndim == 3 else xbt[bfq]   # (K, n)
        in_parent = ok[:, None] & (cur == q[:, None])
        go_left = in_parent & (sample_bin <= bbq[:, None])
        lm = go_left.to(dtype)
        pm = in_parent.to(dtype)
        # left and parent cumulative stats in one contraction; the right
        # child's by subtraction; totals by exact row sums
        h = hist(torch.cat([ws * lm, wys * lm, ws * pm, wys * pm], dim=0))
        clw, clwy = h[:k_chains], h[k_chains : 2 * k_chains]
        cpw, cpwy = h[2 * k_chains : 3 * k_chains], h[3 * k_chains :]
        tl_w = (ws * lm).sum(dim=1)
        tp_w = (ws * pm).sum(dim=1)
        tl_wy = (wys * lm).sum(dim=1)
        tp_wy = (wys * pm).sum(dim=1)
        cw = torch.cat([clw, cpw - clw], dim=0).reshape(2 * k_chains, p, nb)
        cwy = torch.cat([clwy, cpwy - clwy], dim=0).reshape(2 * k_chains, p, nb)
        tws = torch.cat([tl_w, tp_w - tl_w])
        twys = torch.cat([tl_wy, tp_wy - tl_wy])
        cg, cf, cb = best(cw, cwy, tws[:, None, None], twys[:, None, None])
        node_gain = torch.where(iota_nodes[None, :] == q[:, None], neg, node_gain)
        node_gain[:, lid] = torch.where(ok, cg[:k_chains], neg)
        node_gain[:, rid] = torch.where(ok, cg[k_chains:], neg)
        node_feat[:, lid], node_feat[:, rid] = cf[:k_chains], cf[k_chains:]
        node_bin[:, lid], node_bin[:, rid] = cb[:k_chains], cb[k_chains:]
        node_sw[:, lid] = torch.where(ok, tl_w, zero)
        node_sw[:, rid] = torch.where(ok, tp_w - tl_w, zero)
        node_swy[:, lid] = torch.where(ok, tl_wy, zero)
        node_swy[:, rid] = torch.where(ok, tp_wy - tl_wy, zero)
        cur = torch.where(in_parent, torch.where(go_left, lid, rid), cur)
        if return_tree:
            upd = (iota_nodes[None, :] == q[:, None]) & ok[:, None]
            t_feat = torch.where(upd, bfq[:, None], t_feat)
            t_thr = torch.where(upd, bbq[:, None], t_thr)
            t_int = torch.where(upd, torch.ones((), dtype=dtype, device=dev), t_int)
            t_left = torch.where(upd, lid, t_left)
            t_right = torch.where(upd, rid, t_right)
            t_vg = t_vg + torch.where(ok[:, None] & (p_iota[None, :] == bfq[:, None]), gq[:, None], zero)

    value = node_swy / node_sw.clamp_min(1e-12)
    if return_tree:
        return value, cur, (t_feat, t_thr, t_int, t_left, t_right, t_vg)
    return value, cur


# (trees x 2 n_nodes x rows) weighted node one-hot values contracted at once
# by grow_level_trees: bounds the deep levels' tables (~0.5 GB in float32)
# on the CPU; on a CUDA device 2.5 GiB of them (``base.chunk_elems``: a
# chunk's tables and temporaries then take about 8 GiB a rank).  Each chunk
# is a few dozen launches from the host, so the bound is what keeps the
# grower's launch count near one chunk a forest a level
_LEVEL_ELEMS = 1 << 27
_LEVEL_BYTES_CUDA = 5 << 29


def draw_mtry_scores(n_trees: int, max_depth: int, p: int, generator: torch.Generator | None = None):
    """Uniform per-node feature scores for ``grow_level_trees``: (T,
    2^max_depth - 1, p) float64, drawn on the CPU from ``generator``."""
    return torch.rand((n_trees, 2**max_depth - 1, p), generator=generator, dtype=torch.float64)


def _tree_chunks(n_trees: int, chunk: int, block: int):
    """[t0, t1) runs of at most ``chunk`` trees that start afresh at every
    multiple of ``block``."""
    for b0 in range(0, n_trees, block):
        b1 = min(b0 + block, n_trees)
        for t0 in range(b0, b1, chunk):
            yield t0, min(t0 + chunk, b1)


def grow_level_trees(xb, edges, ys, ws, *, max_depth: int = 9, min_leaf: float = 5.0, mtry: int | None = None,
                     scores=None, generator: torch.Generator | None = None, bin_cum1h=None, block: int | None = None):
    """T CART regression trees grown level-wise to ``max_depth`` (heap
    layout: node q's children are 2q + 1 and 2q + 2), randomForest's
    semantics: SSE-decrease splits over a random ``mtry``-feature subset
    per node, at least ``min_leaf`` weight on each side.

    ``xb`` (n, p) bins shared by every tree (``edges`` (p, nb - 1)); ``ys``
    (T, n) targets; ``ws`` (T, n) row weights (bootstrap counts, 0 out of
    bag).  Split statistics come from ``_hist_cum`` against the cumulative
    one-hot (the gbm histogram accuracy class); a node's totals are its
    table's last bin; a node splits if its best gain exceeds 1e-9.  When
    ``mtry`` < p, node q of tree t draws its features from ``scores[t, q]``
    (T, 2^max_depth - 1, p) uniforms: the ``mtry`` largest (ties
    included).  Leaf values are exact weighted means.  The trees are
    grown a chunk at a time; a chunk never spans two runs of ``block``
    trees (default: all of them), so each forest of ``block`` trees sees
    the same shapes, and its bits, however many forests grow with it.

    Returns (Tree of (T, 2^(max_depth+1) - 1) arrays, cur (T, n) the
    terminal node of every training row)."""
    n, p = xb.shape
    n_trees = ys.shape[0]
    nb = edges.shape[1] + 1
    n_total = 2 ** (max_depth + 1) - 1
    dtype, dev = ys.dtype, ys.device
    if bin_cum1h is None:
        bin_cum1h = flat_bin_cum_onehot(xb, nb)
    use_mask = mtry is not None and mtry < p
    if use_mask and scores is None:
        scores = draw_mtry_scores(n_trees, max_depth, p, generator)
    if use_mask:
        scores = torch.as_tensor(scores, device=dev)
    wys = ws * ys
    xbt = xb.T
    cols = torch.arange(n, device=dev)[None, :]
    p_iota = torch.arange(p, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    feat = torch.zeros((n_trees, n_total), dtype=torch.int64, device=dev)
    thr_bin = torch.zeros_like(feat)
    internal = torch.zeros((n_trees, n_total), dtype=dtype, device=dev)
    var_gain = torch.zeros((n_trees, p), dtype=dtype, device=dev)
    cur = torch.zeros((n_trees, n), dtype=torch.int64, device=dev)
    block = block or n_trees
    elems = chunk_elems(_LEVEL_ELEMS, dtype, dev, _LEVEL_BYTES_CUDA)

    for level in range(max_depth):
        offset, n_nodes = 2**level - 1, 2**level
        nodes = torch.arange(n_nodes, device=dev)
        for t0, t1 in _tree_chunks(n_trees, max(1, elems // (2 * n_nodes * n)), block):
            tc = t1 - t0
            local = cur[t0:t1] - offset                              # valid iff in [0, n_nodes)
            node1h = (local[:, None, :] == nodes[None, :, None]).to(dtype)           # (tc, N, n)
            a = torch.cat([node1h * ws[t0:t1, None, :], node1h * wys[t0:t1, None, :]], dim=1)
            h = _hist_cum(a.reshape(tc * 2 * n_nodes, n), bin_cum1h).reshape(tc, 2, n_nodes, p, nb)
            chw = h[:, 0].reshape(tc * n_nodes, p, nb)
            chwy = h[:, 1].reshape(tc * n_nodes, p, nb)
            feat_mask = None
            if use_mask:
                sc = scores[t0:t1, offset : offset + n_nodes].reshape(tc * n_nodes, p)
                kth = torch.sort(sc, dim=1).values[:, p - mtry]
                feat_mask = (sc >= kth[:, None]).to(dtype)
            gain, bfeat, bbin = _best_splits_cum(chw, chwy, chw[:, :1, -1:], chwy[:, :1, -1:], min_leaf, feat_mask)
            gain, bfeat, bbin = (v.reshape(tc, n_nodes) for v in (gain, bfeat, bbin))
            do_split = gain > 1e-9
            feat[t0:t1, offset : offset + n_nodes] = torch.where(do_split, bfeat, 0)
            thr_bin[t0:t1, offset : offset + n_nodes] = torch.where(do_split, bbin, 0)
            internal[t0:t1, offset : offset + n_nodes] = do_split.to(dtype)
            var_gain[t0:t1] += (torch.where(do_split, gain, zero)[:, :, None]
                                * (bfeat[:, :, None] == p_iota).to(dtype)).sum(1)
            # route the rows of split nodes to their children
            in_level = (local >= 0) & (local < n_nodes)
            lc = local.clamp(0, n_nodes - 1)
            sample_bin = xbt[bfeat.gather(1, lc), cols]
            child = 2 * cur[t0:t1] + 1 + (sample_bin > bbin.gather(1, lc)).long()
            cur[t0:t1] = torch.where(in_level & do_split.gather(1, lc), child, cur[t0:t1])

    # each node's weight and weighted-y sums as one-hot products, a chunk of
    # trees at a time: a scatter-add sums with atomics on the card, in an
    # order (and to last bits) that changes from run to run
    sums = torch.empty((n_trees, 2, n_total), dtype=dtype, device=dev)
    node_iota = torch.arange(n_total, device=dev)
    for t0, t1 in _tree_chunks(n_trees, max(1, elems // (n * n_total)), block):
        sums[t0:t1] = torch.stack([ws[t0:t1], wys[t0:t1]], 1) @ (cur[t0:t1, :, None] == node_iota).to(dtype)
    sw, swy = sums[:, 0], sums[:, 1]
    value = swy / sw.clamp_min(1e-12)
    heap = torch.arange(n_total, device=dev).expand(n_trees, n_total)
    tree = Tree(feat=feat, thr=edges_lookup(edges, feat, thr_bin), internal=internal, left=2 * heap + 1,
                right=2 * heap + 2, value=value, var_gain=var_gain)
    return tree, cur


def grow_level_tree(xb, edges, y, w, *, max_depth: int = 8, min_leaf: float = 5.0, mtry: int | None = None,
                    scores=None, generator: torch.Generator | None = None, bin_cum1h=None,
                    return_assign: bool = False):
    """One tree of ``grow_level_trees`` for (n,) ``y`` and ``w`` (``scores``
    (2^max_depth - 1, p) in place of the JAX package's key): a Tree of (N,)
    arrays, and with ``return_assign`` the training rows' nodes (n,)."""
    trees, cur = grow_level_trees(xb, edges, y[None], w[None], max_depth=max_depth, min_leaf=min_leaf, mtry=mtry,
                                  scores=None if scores is None else torch.as_tensor(scores)[None],
                                  generator=generator, bin_cum1h=bin_cum1h)
    tree = Tree(*(a[0] for a in trees))
    return (tree, cur[0]) if return_assign else tree


def assigned_predict(value, cur) -> torch.Tensor:
    """Leaf values of assigned nodes: ``value[t, cur[t, i]]`` for (T, N)
    values and (T, n) node ids."""
    return value.gather(1, cur)


# the JAX package's name for the K-batched lookup; the same function here
assigned_predict_batched = assigned_predict


def route_bins(xb, feat, thr_bin, internal, left, right, depth: int) -> torch.Tensor:
    """Node of every training row in K grown trees, by the rows' bins (the
    trees' own routing: left iff bin <= thr_bin): node arrays (K, N), xb
    (n, p) shared or (K, n, p) one table per tree; returns (K, n), routed
    one level at a time for ``depth`` levels."""
    k = feat.shape[0]
    n = xb.shape[-2]
    xbk = (xb if xb.ndim == 3 else xb[None].expand(k, -1, -1)).long()
    feat, thr_bin, left, right = (a.long() for a in (feat, thr_bin, left, right))
    cur = torch.zeros((k, n), dtype=torch.int64, device=feat.device)
    for _ in range(depth):
        b = xbk.gather(2, feat.gather(1, cur)[:, :, None])[:, :, 0]
        nxt = torch.where(b <= thr_bin.gather(1, cur), left.gather(1, cur), right.gather(1, cur))
        cur = torch.where(internal.gather(1, cur) > 0, nxt, cur)
    return cur


def tree_assign(trees: Tree, x, depth: int) -> torch.Tensor:
    """Terminal node id of every (m, p) point in each of T stacked trees
    ((T, N) arrays): (T, m), routed one level at a time for ``depth`` levels."""
    x = torch.as_tensor(x)
    t, m = trees.feat.shape[0], x.shape[0]
    cur = torch.zeros((t, m), dtype=torch.int64, device=x.device)
    cols = torch.arange(m, device=x.device)[None, :]
    feat, left, right = trees.feat.long(), trees.left.long(), trees.right.long()
    for _ in range(depth):
        f = feat.gather(1, cur)
        go = trees.internal.gather(1, cur) > 0
        xv = x[cols, f]
        nxt = torch.where(xv <= trees.thr.gather(1, cur).to(x.dtype), left.gather(1, cur), right.gather(1, cur))
        cur = torch.where(go, nxt, cur)
    return cur


def tree_predict(tree: Tree, x, depth: int) -> torch.Tensor:
    """Route (m, p) points through one tree ((N,) arrays): its values, (m,)."""
    return assigned_predict(tree.value[None], tree_assign(Tree(*(a[None] for a in tree)), x, depth))[0]


def forest_predict(trees: Tree, x, depth: int, weights=None, tree_chunk: int = 64,
                   cell_block: int = 65536) -> torch.Tensor:
    """Weighted sum over T stacked trees of each tree's value at (m, p)
    points: (m,).  ``weights=None`` averages (random forest).  Trees and
    cells are blocked so at most (tree_chunk, cell_block) routes exist."""
    x = torch.as_tensor(x)
    m = x.shape[0]
    t_total = trees.feat.shape[0]
    if weights is None:
        w = torch.full((t_total,), 1.0 / t_total, dtype=x.dtype, device=x.device)
    else:
        w = torch.as_tensor(weights, device=x.device).to(x.dtype)
    out = torch.zeros((m,), dtype=x.dtype, device=x.device)
    for c0 in range(0, m, cell_block):
        xb = x[c0 : c0 + cell_block]
        acc = torch.zeros((xb.shape[0],), dtype=x.dtype, device=x.device)
        for t0 in range(0, t_total, tree_chunk):
            part = Tree(*(a[t0 : t0 + tree_chunk] for a in trees))
            cur = tree_assign(part, xb, depth)
            vals = part.value.to(x.dtype).gather(1, cur)          # (tc, mb)
            acc = acc + w[t0 : t0 + tree_chunk] @ vals
        out[c0 : c0 + cell_block] = acc
    return out
