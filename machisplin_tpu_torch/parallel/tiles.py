"""Batched TPS tiles on one device.

Counterpart of ``pack_tiles`` and ``batched_tile_solve`` in
``machisplin_tpu/parallel/sharded.py``: per-tile knot sets are padded to one
knot budget with masks, so every tile factorises and solves in one batched
call (``ops/tps.py``'s mask-exact factorisation).  The multi-device mesh
path is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.tps import TPSModel, tps_factor, tps_solve
from ..utils import resolve_device

__all__ = ["pack_tiles", "batched_tile_solve"]


def pack_tiles(coords_list, y_list, pad_to: int | None = None, dtype=torch.float64, device="cuda"):
    """Pad per-tile (coords, y) to one knot budget with masks.

    Returns coords (T, K, 2), y (T, K) or (T, K, R), mask (T, K) as tensors
    of ``dtype`` on ``device``; padded knots sit at 0.5 with mask 0."""
    sizes = [len(c) for c in coords_list]
    k = pad_to or max(max(sizes), 8)
    t = len(coords_list)
    resp_shape = np.asarray(y_list[0]).shape[1:]
    coords = np.full((t, k, 2), 0.5)
    y = np.zeros((t, k) + resp_shape)
    mask = np.zeros((t, k))
    for i, (c, v) in enumerate(zip(coords_list, y_list)):
        n = len(c)
        if n > k:
            raise ValueError(f"tile {i} has {n} knots > budget {k}")
        coords[i, :n] = np.asarray(c)
        y[i, :n] = np.asarray(v)
        mask[i, :n] = 1.0
    dev = resolve_device(device)
    as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=dev)
    return as_t(coords), as_t(y), as_t(mask)


def batched_tile_solve(coords, y, mask, *, lam=None, ngrid: int = 200, refine: int = 40) -> TPSModel:
    """Factorise and solve every padded tile in one batched call; returns a
    TPSModel with a leading tile axis."""
    return tps_solve(tps_factor(coords, mask), y, lam=lam, ngrid=ngrid, refine=refine)
