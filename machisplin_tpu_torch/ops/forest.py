"""Weighted forest prediction by leaf bin-intervals: kernel K3 and its plain
version.

Counterpart of ``machisplin_tpu/ops/pallas_forest.py``.  Every leaf of an
axis-aligned tree whose thresholds come from per-feature edge sets is a box
in bin space, so with bin_f(x) = #{edges_f < x}

    x reaches leaf  <=>  lo[f] <= bin_f(x) <= hi[f]  for every feature f,

and a forest's weighted prediction is a sum over leaf slots of
``w_tree * value_leaf`` times that 0/1 membership.  ``build_leaf_bins`` (host
numpy, a copy of the JAX package's) walks the trees once into these tables,
with the drop-leaf trick on: one leaf per tree leaves the tables and its
value enters as a per-response constant.

``prepare_forest`` turns tables + tree values + weights ((T,) or (T, R))
into device tensors once; ``predict_prepared`` then evaluates cell blocks:
CUDA inputs launch ``csrc/forest_predict.cu``, CPU inputs run the plain
version, streamed over cell blocks so no (cells x leaves) mask for a whole
raster ever exists.  ``forest_predict_bins`` does both steps in one call.

The kernel evaluates the same sum in tree order.  ``outcome_tables``
gives every tree with at most ``S_MAX`` split nodes (when p <= 8) a
descriptor (each split node's feature and bin threshold k, left iff
bin <= k) and a table of 2^S rows: row u is the slot of the leaf reached
by going right at the j-th split node iff bit j of u, or the zero row for
the tree's dropped leaf.  A cell then costs one table lookup per such
tree; the other trees' slots keep the membership test.

The JAX package's ``_segments_for`` and ``predicate`` options are
work-arounds for its TPU compiler (Mosaic) that skip feature tiles a leaf
chunk never constrains; K3 needs neither, so they are not ported.
``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

__all__ = [
    "LeafBinTables", "ForestTables", "OutcomeTables", "S_MAX", "build_leaf_bins", "outcome_tables",
    "prepare_forest", "predict_prepared", "forest_predict_bins", "forest_predict_plain", "forest_predict_cuda",
    "LAUNCHES",
]

# kernel launches since the last reset: {"forest_predict": n}
LAUNCHES = {"forest_predict": 0}

_LEAF_CHUNK = 512
_FEAT_GRANULE = 8
_PACK = 4            # features per 32-bit word in the kernel's tables
_MAX_BINS = 128      # bins must fit in 7 bits (the 8th is the guard bit)
_MAX_RESP = 4        # responses per launch (the kernel's accumulators)
S_MAX = 6            # split nodes of a tree evaluated by outcome table (2^S_MAX rows)
_TAB_FEAT = 8        # features the table loop gathers from: two packed words
_UNUSED_NODE = 0x80  # threshold byte of a descriptor's unused node: its bit is always 0
# (cells x slots x features) compares per block of the plain version
_PLAIN_ELEMS = {"cpu": 1 << 25, "cuda": 1 << 28}


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class LeafBinTables(NamedTuple):
    """Host-built bin-space leaf geometry of one forest (weight-free)."""

    etab: np.ndarray      # (F_pad, B_pad) f32 per-feature sorted edges, +inf pad
    lo: np.ndarray        # (F_pad, TL_pad) f32 per-feature lower bin bound
    hi: np.ndarray        # (F_pad, TL_pad) f32 upper bound (pad slots lo=1,hi=0)
    leaf_tree: np.ndarray  # (TL_pad,) int32 tree id of each leaf slot (-1 pad)
    leaf_node: np.ndarray  # (TL_pad,) int32 node id of each leaf slot (0 pad)
    n_feat: int           # real feature count p
    n_bins: int           # B (edges + 1) before lane padding
    # drop-leaf trick (None = off): node id of the one leaf per tree left
    # out of the slot tables.  A tree's leaves partition bin space, so
    # sum_l w v_l sel_l == sum_{l != drop} w (v_l - v_drop) sel_l + w v_drop.
    drop_node: np.ndarray | None = None  # (T,) int32


def build_leaf_bins(trees, n_feat: int | None = None, drop_leaf: bool = True) -> LeafBinTables:
    """Walk every tree's reachable subtree and emit leaf bin-intervals.

    trees: a Tree of (T, N) arrays (numpy or CPU tensors).  ``drop_leaf``
    leaves out of the tables the leaf of each tree with the most constrained
    features.  Slots are sorted by constrained-feature set (popcount, then
    mask), padded to a multiple of 512 with empty slots."""
    feat = np.asarray(trees.feat)
    thr = np.asarray(trees.thr)
    internal = np.asarray(trees.internal)
    left = np.asarray(trees.left)
    right = np.asarray(trees.right)
    t, _ = feat.shape
    p = int(n_feat if n_feat is not None else feat.max() + 1)
    f_pad = _round_up(p, _FEAT_GRANULE)

    int_mask = internal > 0
    edges = [np.unique(thr[int_mask & (feat == f)]) for f in range(p)]
    n_edges = max((len(e) for e in edges), default=0)
    n_bins = n_edges + 1
    b_pad = _round_up(max(n_edges, 1), 128)
    etab = np.full((f_pad, b_pad), np.inf, np.float32)
    for f in range(p):
        etab[f, : len(edges[f])] = edges[f]

    los, his, l_tree, l_node = [], [], [], []
    drop_node = np.zeros(t, np.int32) if drop_leaf else None
    for ti in range(t):
        tree_leaves = []
        stack = [(0, np.zeros(p, np.int64), np.full(p, n_bins - 1, np.int64))]
        while stack:
            q, lo_q, hi_q = stack.pop()
            if int_mask[ti, q]:
                f = int(feat[ti, q])
                k = int(np.searchsorted(edges[f], thr[ti, q]))
                lo_l, hi_l = lo_q.copy(), hi_q.copy()
                hi_l[f] = min(hi_l[f], k)          # left: x <= thr <=> bin <= k
                lo_r, hi_r = lo_q.copy(), hi_q.copy()
                lo_r[f] = max(lo_r[f], k + 1)      # right: bin >= k + 1
                stack.append((int(left[ti, q]), lo_l, hi_l))
                stack.append((int(right[ti, q]), lo_r, hi_r))
            else:
                tree_leaves.append((q, lo_q, hi_q))
        if drop_leaf:
            ncons = [int(np.count_nonzero((lo_q > 0) | (hi_q < n_bins - 1))) for _, lo_q, hi_q in tree_leaves]
            di = int(np.argmax(ncons))
            drop_node[ti] = tree_leaves[di][0]
            del tree_leaves[di]
        for q, lo_q, hi_q in tree_leaves:
            los.append(lo_q)
            his.append(hi_q)
            l_tree.append(ti)
            l_node.append(q)

    n_leaves = len(l_tree)
    l_tree = np.asarray(l_tree, np.int32)
    l_node = np.asarray(l_node, np.int32)
    if n_leaves:
        lo_real = np.stack(los, axis=1).astype(np.float32)   # (p, L)
        hi_real = np.stack(his, axis=1).astype(np.float32)
        if p < 63:
            cons = (lo_real > 0) | (hi_real < n_bins - 1)    # (p, L)
            mask_int = (cons * (1 << np.arange(p, dtype=np.int64))[:, None]).sum(0)
            order = np.lexsort((mask_int, cons.sum(0)))
            lo_real, hi_real = lo_real[:, order], hi_real[:, order]
            l_tree, l_node = l_tree[order], l_node[order]
    tl_pad = _round_up(max(n_leaves, 1), _LEAF_CHUNK)
    # padding slots are empty on feature 0 only (lo=1 > hi=0 never matches)
    lo = np.zeros((f_pad, tl_pad), np.float32)
    hi = np.full((f_pad, tl_pad), float(n_bins - 1), np.float32)
    lo[0, :] = 1.0
    hi[0, :] = 0.0
    if n_leaves:
        lo[:p, :n_leaves] = lo_real
        hi[:p, :n_leaves] = hi_real
    leaf_tree = np.full(tl_pad, -1, np.int32)
    leaf_node = np.zeros(tl_pad, np.int32)
    leaf_tree[:n_leaves] = l_tree
    leaf_node[:n_leaves] = l_node
    return LeafBinTables(etab, lo, hi, leaf_tree, leaf_node, p, n_bins, drop_node)


class OutcomeTables(NamedTuple):
    """Host tables of the kernel's two loops (``outcome_tables``)."""

    desc: np.ndarray       # (Tt, 4) int32: byte selectors of split nodes 0-3 and 4-7, then k + 1 bytes
    row_slot: np.ndarray   # (Tt, 2^S) int64 slot of each outcome row; TL (the zero row) for a dropped leaf
    loop_slot: np.ndarray  # (Ls,) int64 the real slots of the trees outside the tables


def outcome_tables(trees, tables: LeafBinTables, s_max: int = S_MAX) -> OutcomeTables:
    """Per-tree outcome tables of a forest, built for all trees at once.

    A tree with S <= ``s_max`` split nodes (and p <= 8) gets a descriptor:
    split node j (the j-th internal node by id) tests feature f_j against
    bin threshold k_j, as ``build_leaf_bins`` computes it, and goes right
    iff bin > k_j.  Its rows walk the tree for every pattern u of 2^S bits
    ("right at node j iff bit j of u"), S the largest split count of the
    tabled trees; a tree with fewer splits leaves its unused nodes' bits 0.
    The slots of every other tree stay in ``loop_slot`` for the membership
    test.  trees: a Tree of (T, N) arrays (numpy or CPU tensors)."""
    feat = np.asarray(trees.feat).astype(np.int64)
    thr = np.asarray(trees.thr)
    int_mask = np.asarray(trees.internal) > 0
    left = np.asarray(trees.left).astype(np.int64)
    right = np.asarray(trees.right).astype(np.int64)
    p, tl = tables.n_feat, tables.leaf_tree.shape[0]
    n_split = int_mask.sum(1)
    tabled = n_split <= s_max
    if p > _TAB_FEAT or tables.n_bins > _MAX_BINS:
        tabled[:] = False
    tt = np.flatnonzero(tabled)
    real = np.flatnonzero(tables.leaf_tree >= 0)
    loop_slot = real[~tabled[tables.leaf_tree[real]]].astype(np.int64)
    s = int(n_split[tt].max()) if tt.size else 0
    # split node j of each tabled tree: its feature and threshold byte k + 1
    kbin = np.zeros(feat.shape, np.int64)
    for f in range(p):
        at = int_mask & (feat == f)
        kbin[at] = np.searchsorted(np.unique(thr[at]), thr[at])
    node_ids = np.argsort(~int_mask[tt], axis=1, kind="stable")[:, :2 * _PACK]     # internal nodes first
    if node_ids.shape[1] < 2 * _PACK:
        node_ids = np.pad(node_ids, ((0, 0), (0, 2 * _PACK - node_ids.shape[1])))
    used = np.arange(2 * _PACK)[None, :] < n_split[tt][:, None]                    # (Tt, 8)
    nfeat = np.where(used, np.take_along_axis(feat[tt], node_ids, 1), 0)
    kbyte = np.where(used, np.take_along_axis(kbin[tt], node_ids, 1) + 1, _UNUSED_NODE)
    shifts4, shifts8 = 4 * np.arange(_PACK), 8 * np.arange(_PACK)
    desc = np.stack([
        (nfeat[:, :_PACK] << shifts4).sum(1), (nfeat[:, _PACK:] << shifts4).sum(1),
        (kbyte[:, :_PACK] << shifts8).sum(1), (kbyte[:, _PACK:] << shifts8).sum(1),
    ], 1).astype(np.uint32).view(np.int32)
    # walk every tabled tree for every pattern u at once, on flat int32 node
    # ids (node q of tabled tree i is i * N + q): a split node's rank and
    # its (left, right) children; a leaf is its own child on both sides
    it = int_mask[tt]
    flat = (np.arange(tt.size, dtype=np.int32) * feat.shape[1])[:, None]
    node = np.arange(feat.shape[1])[None, :]
    rank = np.where(it, np.cumsum(it, 1) - 1, 0).astype(np.int32).ravel()
    child = (np.stack([np.where(it, left[tt], node), np.where(it, right[tt], node)], -1)
             + flat[:, :, None]).astype(np.int32).ravel()
    u = np.arange(1 << s, dtype=np.int32)[None, :]
    cur = np.repeat(flat, 1 << s, axis=1)
    for _ in range(s):
        cur = child[2 * cur + ((u >> rank[cur]) & 1)]
    slot_of = np.full(feat.shape, tl, np.int64)
    slot_of[tables.leaf_tree[real], tables.leaf_node[real]] = real
    return OutcomeTables(desc, slot_of[tt].ravel()[cur], loop_slot)


class ForestTables(NamedTuple):
    """A forest's leaf tables and weighted slot values on one device."""

    etab: torch.Tensor     # (p, B_pad) float32 sorted edges, +inf pad
    lo: torch.Tensor       # (p, TL) float32 lower bin bounds (plain version)
    hi: torch.Tensor       # (p, TL) float32 upper bin bounds
    desc: torch.Tensor     # (Tt, 4) int32 outcome-table trees' split nodes (kernel)
    row_slot: torch.Tensor  # (Tt, 2^S) int64 slot of each outcome row, TL for none
    loop_slot: torch.Tensor  # (Ls,) int64 slots of the other trees
    lo_w: torch.Tensor     # (Ls, W) int32: those slots' lo packed 4 features a word
    hi_w: torch.Tensor     # (Ls, W) int32: hi | 0x80 packed likewise
    wv: torch.Tensor       # (TL, R) float32 weight x (value - dropped value)
    offset: torch.Tensor   # (R,) float32 dropped leaves' weighted values
    single: bool           # weights were (T,)


def _pack(a: np.ndarray, guard: int, fill: int) -> np.ndarray:
    """(p, TL) small ints -> (TL, W) int32 words, feature f in byte f % 4 of
    word f // 4, each byte OR-ed with ``guard``; unused bytes hold ``fill``."""
    p, tl = a.shape
    n_words = -(-p // _PACK)
    b = np.full((n_words * _PACK, tl), fill, np.uint32)
    b[:p] = a.astype(np.uint32) | guard
    b = b.reshape(n_words, _PACK, tl)
    words = sum(b[:, j] << (8 * j) for j in range(_PACK))      # (W, TL) uint32
    return np.ascontiguousarray(words.T).view(np.int32)


def prepare_forest(trees, weights, tables: LeafBinTables, device, s_max: int = S_MAX) -> ForestTables:
    """Device tensors for ``predict_prepared``: the tables (float bounds for
    the plain version; outcome tables for the trees with at most ``s_max``
    splits and packed bytes for the other trees' slots, for the kernel) and
    each slot's weighted value relative to its tree's dropped leaf, with the
    dropped values' weighted sum as a per-response offset.  ``weights`` (T,)
    or (T, R)."""
    dev = torch.device(device)
    p = tables.n_feat
    w = torch.as_tensor(weights).to(device=dev, dtype=torch.float32)
    single = w.ndim == 1
    wcols = w[:, None] if single else w                              # (T, R)
    value = torch.as_tensor(trees.value).to(device=dev, dtype=torch.float32)
    lt = torch.as_tensor(tables.leaf_tree, device=dev).long()
    ln = torch.as_tensor(tables.leaf_node, device=dev).long()
    ltc = lt.clamp_min(0)
    leaf_val = value[ltc, ln]                                        # (TL,)
    leaf_w = torch.where((lt >= 0)[:, None], wcols[ltc], torch.zeros((), device=dev))
    if tables.drop_node is not None:
        tw = int(tables.drop_node.shape[0])
        vdrop = value[torch.arange(tw, device=dev), torch.as_tensor(tables.drop_node, device=dev).long()]
        leaf_val = leaf_val - vdrop[lt.clamp(0, tw - 1)]
        offset = vdrop @ wcols[:tw]                                  # (R,)
    else:
        offset = torch.zeros((wcols.shape[1],), dtype=torch.float32, device=dev)
    wv = (leaf_val[:, None] * leaf_w).contiguous()
    lo, hi = tables.lo[:p], tables.hi[:p]
    ot = outcome_tables(_host_tree(trees), tables, s_max)
    if tables.n_bins <= _MAX_BINS:
        lo_w, hi_w = _pack(lo[:, ot.loop_slot], 0, 0), _pack(hi[:, ot.loop_slot], 0x80, 0xFF)
    else:
        lo_w = hi_w = np.zeros((0, 1), np.int32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return ForestTables(t(tables.etab[:p]), t(lo), t(hi), t(ot.desc), t(ot.row_slot), t(ot.loop_slot),
                        t(lo_w), t(hi_w), wv, offset, single)


def forest_predict_plain(ft: ForestTables, x) -> torch.Tensor:
    """The kernel's function in plain PyTorch: (m, R) float32 without the
    offset, streamed over cell blocks of at most ``_PLAIN_ELEMS`` compares
    (2^25 on the CPU, 2^28 on a card)."""
    x = torch.as_tensor(x).to(torch.float32)
    m, p = x.shape[0], ft.etab.shape[0]
    tl = ft.lo.shape[1]
    out = torch.empty((m, ft.wv.shape[1]), dtype=torch.float32, device=x.device)
    blk = max(1, _PLAIN_ELEMS.get(x.device.type, 1 << 25) // max(tl * p, 1))
    for c0 in range(0, m, blk):
        xb = x[c0 : c0 + blk, :p]
        bins = (xb[:, :, None] > ft.etab[None]).sum(2).to(torch.float32)      # (mb, p)
        ok = (bins[:, :, None] >= ft.lo[None]) & (bins[:, :, None] <= ft.hi[None])
        sel = ok.all(dim=1).to(torch.float32)                                # (mb, TL)
        out[c0 : c0 + blk] = sel @ ft.wv
    return out


def _launcher():
    from ..kernels.build import load_library

    lib = load_library("forest_predict")
    fn = lib.forest_predict_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8                       # x, etab, desc, vtab, lo_w, hi_w, wv_loop, out
        + [ctypes.c_int] * 8                        # m, p, n_edges_pad, n_tab, tab_log2_rows, n_slots,
                                                    # n_words, n_resp
        + [ctypes.c_void_p]                         # stream
    )
    return fn


def forest_predict_cuda(ft: ForestTables, x) -> torch.Tensor:
    """Launch K3 on the current stream: (m, R) float32 without the offset.
    ``x`` (m, >= p) float32 on the tables' CUDA device.  The outcome rows
    and the loop slots' values are gathered from ``ft.wv`` at each launch,
    so the kernel sums exactly the slot formulation's terms.  Raises on a
    wrong device, dtype or shape, on more than 127 edges per feature, and on
    a launch error."""
    dev = ft.wv.device
    if x.device != dev or dev.type != "cuda":
        raise ValueError(f"forest_predict_cuda: x must be on {dev}, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"forest_predict_cuda: x must be float32, got {x.dtype}")
    p, b_pad = ft.etab.shape
    if b_pad > _MAX_BINS or int(torch.isfinite(ft.etab).sum(1).max()) >= _MAX_BINS:
        raise ValueError(f"forest_predict_cuda: at most {_MAX_BINS - 1} edges per feature")
    n_tab, rows = ft.row_slot.shape
    if n_tab and (p > _TAB_FEAT or rows > 1 << S_MAX or rows & (rows - 1)):
        raise ValueError(f"forest_predict_cuda: outcome tables of {rows} rows for {p} features")
    x = x[:, :p].contiguous()
    m = x.shape[0]
    n_slots, n_words = ft.lo_w.shape
    n_resp = ft.wv.shape[1]
    out = torch.empty((m, n_resp), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    if m >= 2**31:
        raise ValueError("forest_predict_cuda: too many cells for 32-bit indices")
    fn = _launcher()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for r0 in range(0, n_resp, _MAX_RESP):
        r1 = min(r0 + _MAX_RESP, n_resp)
        wv_ext = torch.cat([ft.wv[:, r0:r1], torch.zeros((1, r1 - r0), device=dev)])   # row TL: zeros
        vtab = wv_ext[ft.row_slot].contiguous()                                     # (Tt, 2^S, r)
        wl = wv_ext[ft.loop_slot].contiguous()                                      # (Ls, r)
        o = out if (r0, r1) == (0, n_resp) else torch.empty((m, r1 - r0), dtype=torch.float32, device=dev)
        err = fn(x.data_ptr(), ft.etab.data_ptr(), ft.desc.data_ptr(), vtab.data_ptr(), ft.lo_w.data_ptr(),
                 ft.hi_w.data_ptr(), wl.data_ptr(), o.data_ptr(), m, p, b_pad, n_tab, rows.bit_length() - 1,
                 n_slots, n_words, r1 - r0, stream)
        if err != 0:
            raise RuntimeError(f"forest_predict kernel launch failed: CUDA error {err}")
        LAUNCHES["forest_predict"] += 1
        if o is not out:
            out[:, r0:r1] = o
    return out


def predict_prepared(ft: ForestTables, x) -> torch.Tensor:
    """Forest prediction of (m, p) cells: (m,) for (T,) weights, (m, R) for
    (T, R).  CUDA cells launch K3, CPU cells run the plain version.  The
    cells must lie on the tables' device: this never moves them."""
    x = torch.as_tensor(x)
    if x.device != ft.wv.device:
        raise ValueError(f"predict_prepared: cells on {x.device}, tables on {ft.wv.device}")
    x = x.to(torch.float32)
    out = forest_predict_cuda(ft, x) if x.device.type == "cuda" else forest_predict_plain(ft, x)
    out = out + ft.offset[None, :]
    return out[:, 0] if ft.single else out


def forest_predict_bins(trees, x, weights, tables: LeafBinTables | None = None) -> torch.Tensor:
    """Weighted forest prediction sum_t w_t tree_t(x) for (m, p) inputs:
    (m,) for (T,) weights, (m, R) for (T, R) weights (R weighted sums of the
    same trees in one pass).  Pass ``tables`` to reuse one table walk."""
    x = torch.as_tensor(x)
    if tables is None:
        tables = build_leaf_bins(_host_tree(trees), n_feat=x.shape[1])
    return predict_prepared(prepare_forest(trees, weights, tables, x.device), x)


def _host_tree(trees):
    return type(trees)(*(a.cpu() if isinstance(a, torch.Tensor) else a for a in trees))
