"""The device mesh: SPMD over ``torch.distributed``, and the batched TPS tiles.

Counterpart of ``machisplin_tpu/parallel/sharded.py``.  The JAX package
drives every device from one process (``shard_map``); here there is one
process per device, in the idiom of ``torch.distributed``:

* every rank calls the same entry point with the same inputs;
* each rank computes its share of a leading batch axis (tiles, boosting
  chains, model lanes, raster cells, stations), padded to a multiple of the
  world size by repeating row 0;
* the shares are gathered, so every rank returns the full result.

A mesh is a ``DeviceMesh`` over the default process group, which the caller
creates (``torchrun``, or ``torch.multiprocessing.spawn`` with a ``file://``
store).  Every collective of the port lives in this module: the gather of a
padded share and the broadcast of rank 0's tensors and decisions.  Gloo takes CUDA
tensors for both, so a mesh of several ranks on one card (gloo) and one
rank a card (NCCL) share the code.
Draws are made whole on every rank and then sliced, so a share's result
does not depend on the world size, and decisions that steer control flow
are rank 0's, broadcast.  With ``mesh=None`` none of this runs.

What splits is the hand-written kernels' work (K1 tiles, K2 chains, K3
cells, K4 lanes), the RF's forests and the Nystrom fit's chunks.  The plain
PyTorch steps around them run at the unsharded batch width on every rank:
PyTorch's CUDA reductions lay out their threads by the batch width, so a
share computed in a narrower batch would part from the unsharded result
in the last bits.

``pack_tiles`` pads per-tile knot sets to one knot budget with masks, so
every tile factorises and solves in one batched call (``ops/tps.py``'s
mask-exact factorisation); ``batched_tile_tps`` also predicts each tile
with kernel K1 (``ops/tps_grid``), each rank its share of the tiles
(``predict_tiles``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..grid import GridSpec
from ..utils import resolve_device

# ``ops/`` imports the collectives below, so the tile functions import
# ``ops.tps`` when they run

__all__ = ["make_mesh", "pack_tiles", "batched_tile_solve", "batched_tile_tps", "tile_tps_predict", "predict_tiles"]


def make_mesh(n_devices: int | None = None, axis: str = "tile", device_type: str = "cuda"):
    """A one-axis ``DeviceMesh`` named ``axis`` over the initialised default
    process group.  ``n_devices`` None means the world size; any other
    value must equal it (one process per device, so there is no "first n
    devices").  On CUDA, rank r runs on ``cuda:(r % device_count)``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise the default process group first "
                           "(torchrun, or init_process_group in each spawned rank)")
    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"make_mesh: n_devices={n_devices} but the process group has {world} ranks")
    if device_type == "cuda":
        resolve_device("cuda")
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


# ---------------------------------------------------------------- collectives

def rank_world(mesh) -> tuple[int, int]:
    """(this rank's index on the mesh, the mesh size); (0, 1) without one."""
    if mesh is None:
        return 0, 1
    return int(mesh.get_local_rank()), int(mesh.size())


def share_rows(n: int, mesh) -> torch.Tensor:
    """The rows of a leading axis of ``n`` that this rank computes: rank r
    takes rows [r per, (r + 1) per) of the axis padded to world x per
    (per = ceil(n / world)); padding rows repeat row 0."""
    rank, world = rank_world(mesh)
    per = -(-n // world)
    idx = torch.arange(rank * per, (rank + 1) * per)
    return torch.where(idx < n, idx, torch.zeros_like(idx))


def gather_rows(local: torch.Tensor, n: int, mesh, dim: int = 0) -> torch.Tensor:
    """Every rank's ``share_rows`` result, concatenated along ``dim`` and cut
    to ``n``: the full result, the same on every rank."""
    import torch.distributed as dist

    if mesh is None:
        return local
    src = local.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size())]
    dist.all_gather(parts, src, group=mesh.get_group())
    return torch.cat(parts, dim=dim).narrow(dim, 0, n)


def broadcast_tensor(t: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's ``t`` on every rank."""
    import torch.distributed as dist

    if mesh is None:
        return t
    grp = mesh.get_group()
    buf = t.detach().contiguous().clone()
    dist.broadcast(buf, src=dist.get_global_rank(grp, 0), group=grp)
    return buf


def broadcast_object(obj, mesh):
    """Rank 0's picklable ``obj`` on every rank (decisions that steer
    control flow: kept letters and weights, lambda, keep-if-R^2-improves)."""
    import torch.distributed as dist

    if mesh is None:
        return obj
    grp = mesh.get_group()
    box = [obj]
    dist.broadcast_object_list(box, src=dist.get_global_rank(grp, 0), group=grp)
    return box[0]


def on_rank0(mesh, fn, *args, **kwargs):
    """Run ``fn`` on rank 0 only (file writes), then let every rank go on
    together; an error on rank 0 is raised on every rank.  Returns rank 0's
    result, on every rank."""
    rank, _ = rank_world(mesh)
    out, err = None, None
    if rank == 0:
        try:
            out = fn(*args, **kwargs)
        except Exception as e:  # re-raised on every rank below
            err = e
    if mesh is None:
        if err is not None:
            raise err
        return out
    got = broadcast_object((out, None if err is None else f"{type(err).__name__}: {err}"), mesh)
    if err is not None:
        raise err
    if got[1] is not None:
        raise RuntimeError(f"rank 0 failed: {got[1]}")
    return got[0]


class _TensorSpec(tuple):
    """A tensor's (shape, dtype), standing in for it in ``rank0_result``'s
    broadcast of a result's structure."""


def _map_leaves(obj, kind, fn):
    """``obj`` with ``fn`` applied to every ``kind`` inside its tuples,
    NamedTuples, lists and dicts, in a fixed order."""
    if isinstance(obj, kind):
        return fn(obj)
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return type(obj)(*(_map_leaves(a, kind, fn) for a in obj))
    if isinstance(obj, (tuple, list)):
        return type(obj)(_map_leaves(a, kind, fn) for a in obj)
    if isinstance(obj, dict):
        return {k: _map_leaves(v, kind, fn) for k, v in obj.items()}
    return obj


def rank0_result(mesh, device, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` computed on rank 0 alone and received by every
    rank, its tensors on ``device``: for the plain-PyTorch fits a mesh does
    not split, which would run at the same width on every rank.  Only the
    result's structure (its other values, each tensor's shape and dtype)
    is pickled; the tensors are broadcast on ``device``.  ``fn`` must draw
    nothing from a generator the ranks share (draw first, on every rank)."""
    if mesh is None:
        return fn(*args, **kwargs)
    tensors = []

    def spec(t):
        tensors.append(t)
        return _TensorSpec((tuple(t.shape), t.dtype))

    skeleton = on_rank0(mesh, lambda: _map_leaves(fn(*args, **kwargs), torch.Tensor, spec))
    held = iter(tensors)                            # rank 0's, in the order of the skeleton's leaves
    rank, _ = rank_world(mesh)

    def receive(sp):
        shape, dtype = sp
        buf = next(held).to(device) if rank == 0 else torch.empty(shape, dtype=dtype, device=device)
        return broadcast_tensor(buf, mesh)

    return _map_leaves(skeleton, _TensorSpec, receive)


# ---------------------------------------------------------------------- tiles

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


def batched_tile_solve(coords, y, mask, *, lam=None, ngrid: int = 200, refine: int = 40, mesh=None,
                       axis: str | None = None):
    """Factorise and solve every padded tile in one batched call; returns a
    TPSModel with a leading tile axis.  ``mesh`` and ``axis`` are accepted
    for the JAX signature: the solve is plain PyTorch at the batch's width,
    so every rank solves every tile (the models are then the unsharded
    ones bit for bit)."""
    from ..ops.tps import tps_factor, tps_solve

    return tps_solve(tps_factor(coords, mask), y, lam=lam, ngrid=ngrid, refine=refine)


def tile_tps_predict(model, origin, tile_shape, cell, block_rows: int = 256) -> torch.Tensor:
    """One tile's surface on the lattice of ``tile_shape`` (rows, cols) cells
    of size ``cell`` (dx, dy) whose top-left corner is ``origin`` (xmin,
    ymax), through ``ops.tps.tps_predict_grid`` (K1 on the card).  Returns
    (rows, cols) or (rows, cols, R)."""
    from ..ops.tps import tps_predict_grid

    rows, cols = tile_shape
    g = GridSpec(nrows=int(rows), ncols=int(cols), xmin=float(origin[0]), ymax=float(origin[1]),
                 dx=float(cell[0]), dy=float(cell[1]))
    return tps_predict_grid(model, g, block_rows=block_rows)


def predict_tiles(models, grids, mesh=None, block_rows: int = 256) -> list:
    """Each tile's surface on its own grid through ``tps_predict_grid`` (K1
    on the card): ``models`` and ``grids`` one a tile.  With a ``mesh`` each
    rank predicts its share of the tiles and the surfaces are gathered
    (padded with NaN to the largest tile for the gather).  Returns a list
    of (rows, cols) or (rows, cols, R) tensors."""
    from ..ops.tps import tps_predict_grid

    if mesh is None:
        return [tps_predict_grid(m, g, block_rows=block_rows) for m, g in zip(models, grids)]
    t = len(grids)
    rows, cols = max(g.nrows for g in grids), max(g.ncols for g in grids)
    mine = []
    for i in share_rows(t, mesh).tolist():
        surf = tps_predict_grid(models[i], grids[i], block_rows=block_rows)
        pad = surf.new_full((rows, cols) + tuple(surf.shape[2:]), float("nan"))
        pad[: surf.shape[0], : surf.shape[1]] = surf
        mine.append(pad)
    every = gather_rows(torch.stack(mine), t, mesh)
    return [every[i, : g.nrows, : g.ncols] for i, g in enumerate(grids)]


def batched_tile_tps(coords, y, mask, origins, *, tile_shape: tuple[int, int], cell: tuple[float, float],
                     lam=None, ngrid: int = 200, refine: int = 40, mesh=None, axis: str | None = None,
                     block_rows: int = 256) -> torch.Tensor:
    """Solve and predict every tile: coords (T, K, 2), y (T, K[, R]), mask
    (T, K), origins (T, 2) -> surfaces (T, rows, cols[, R]) in the model's
    dtype, each tile on the lattice of ``tile_shape`` cells of size ``cell``
    from its origin (xmin, ymax).  The solve is ``batched_tile_solve``'s on
    every rank; with a ``mesh`` each rank predicts its share of the tiles
    with K1 (``predict_tiles``) and the surfaces are gathered."""
    from ..ops.tps import TPSModel

    model = batched_tile_solve(coords, y, mask, lam=lam, ngrid=ngrid, refine=refine)
    origins = torch.as_tensor(origins).tolist()
    grids = [GridSpec(nrows=int(tile_shape[0]), ncols=int(tile_shape[1]), xmin=float(o[0]), ymax=float(o[1]),
                      dx=float(cell[0]), dy=float(cell[1])) for o in origins]
    models = [TPSModel(*(a[i] for a in model)) for i in range(len(grids))]
    return torch.stack([s.to(coords.dtype) for s in predict_tiles(models, grids, mesh, block_rows)])
