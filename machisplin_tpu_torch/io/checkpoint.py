"""Checkpoint / resume for pipeline runs (counterpart of
``machisplin_tpu/io/checkpoint.py``).

The reference has no checkpointing: its documented recovery pattern is "loop
over layers/tiles yourself and write outputs as each finishes" (README.md:
147-154).  Every LayerResult saves to one ``.npz`` (the arrays plus a
``__meta__`` JSON entry, the JAX package's layout, so a file written by
either package loads in the other) and restores losslessly onto a device;
``mltps_resumable`` runs the pipeline one response at a time and loads the
layers already saved instead of computing them again.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..grid import GridSpec, Raster
from ..parallel.sharded import broadcast_object, on_rank0
from ..pipeline.mltps import LayerResult
from ..utils import resolve_device

__all__ = ["save_layer", "load_layer", "mltps_resumable"]


def _grid_meta(g: GridSpec) -> dict:
    return {"nrows": g.nrows, "ncols": g.ncols, "xmin": g.xmin, "ymax": g.ymax,
            "dx": g.dx, "dy": g.dy, "crs": g.crs}


def _raster_entries(prefix: str, r: Raster | None, arrays: dict, meta: dict):
    if r is None:
        return
    arrays[f"{prefix}_data"] = r.data.detach().cpu().numpy()
    meta[prefix] = {"grid": _grid_meta(r.grid), "names": list(r.names)}


def save_layer(path: str, res: LayerResult, mesh=None):
    """Write ``res`` (rasters copied to the host) to ``path`` (.npz); with a
    device ``mesh``, on rank 0."""
    if mesh is not None:
        return on_rank0(mesh, save_layer, path, res)
    arrays: dict = {"residuals": np.asarray(res.residuals)}
    meta: dict = {
        "name": res.name,
        "summary": res.summary,
        "n_layers": res.n_layers,
        "var_imp": res.var_imp,
    }
    _raster_entries("final", res.final, arrays, meta)
    _raster_entries("ensemble", res.ensemble, arrays, meta)
    _raster_entries("tps_surface", res.tps_surface, arrays, meta)
    arrays["__meta__"] = np.frombuffer(json.dumps(meta, default=float).encode(), np.uint8)
    np.savez_compressed(path, **arrays)


def _load_raster(prefix: str, z, meta, dev) -> Raster | None:
    if prefix not in meta:
        return None
    g = GridSpec(**meta[prefix]["grid"])
    return Raster(torch.from_numpy(z[f"{prefix}_data"]).to(dev), g, tuple(meta[prefix]["names"]))


def load_layer(path: str, device="cuda") -> LayerResult:
    """The LayerResult saved at ``path``, its rasters on ``device``."""
    dev = resolve_device(device)
    z = np.load(path)
    meta = json.loads(bytes(z["__meta__"]).decode())
    return LayerResult(
        name=meta["name"],
        final=_load_raster("final", z, meta, dev),
        residuals=z["residuals"],
        var_imp=meta["var_imp"],
        summary=meta["summary"],
        n_layers=meta["n_layers"],
        ensemble=_load_raster("ensemble", z, meta, dev),
        tps_surface=_load_raster("tps_surface", z, meta, dev),
    )


def mltps_resumable(int_values, covar_ras, checkpoint_dir: str, *, folds=None, device="cuda", **kwargs):
    """Run ``mltps`` one response at a time, saving each layer to
    ``<checkpoint_dir>/<response>.npz``; layers saved there already are
    loaded onto ``device`` instead of computed.

    ``folds``: optional (R, n) fold ids, row r for response r (passed on to
    its run as a (1, n) array); ``device``, ``generator`` and every other
    keyword go to ``mltps`` unchanged.  Under ``config.mesh`` rank 0 decides
    which layers exist and writes the checkpoints."""
    from ..pipeline.mltps import mltps

    mesh = getattr(kwargs.get("config"), "mesh", None)
    on_rank0(mesh, os.makedirs, checkpoint_dir, exist_ok=True)
    arr = np.asarray(int_values)
    names = list(arr.dtype.names)
    resp_names = names[2:]
    if folds is not None and len(folds) != len(resp_names):
        raise ValueError(f"folds needs one row per response ({len(resp_names)}), got {len(folds)}")
    results = []
    for r, rn in enumerate(resp_names):
        ck = os.path.join(checkpoint_dir, f"{rn}.npz")
        if broadcast_object(os.path.exists(ck), mesh):
            results.append(load_layer(ck, device=device))
            continue
        sub = arr[[names[0], names[1], rn]]
        fold_r = None if folds is None else np.asarray(folds[r])[None]
        res = mltps(sub, covar_ras, folds=fold_r, device=device, **kwargs)[0]
        res.n_layers = len(resp_names)
        save_layer(ck, res, mesh)
        results.append(res)
    return results
