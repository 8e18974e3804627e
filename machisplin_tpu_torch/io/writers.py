"""Output writers — machisplin.write.{geotiff,residuals,loadings} equivalents
(counterpart of ``machisplin_tpu/io/writers.py``; the same files, byte for
byte, for the same results and ``seed``).

Formats mirror the reference:

* ``write_geotiff`` (V73:998-1052): one ``<layer>.tif`` per response plus a
  ``MACHISPLIN_results_<6 random digits>.csv`` summary with the 7-line
  human legend appended;
* ``write_residuals`` (V73:1119-1125): ``<layer>_residuals.csv`` with
  residual, long, lat columns;
* ``write_loadings`` (V73:1082-1089): ``<layer>_model_loadings.txt`` with the
  per-algorithm importance report.
"""
from __future__ import annotations

import csv
import os
import random
from typing import Sequence

from .geotiff import write_geotiff_file

_LEGEND = [
    "",
    "R2 Final: ensemble of the best models & thin-plate-spline of the residuals of the ensemble model",
    "Best model legend: The quantity of letters depicts the number of models ensembled.",
    "The letters themselves depict the model algorithm: b = boosted regression trees (BRT);",
    "g = generalized additive model (GAM); m = multivariate adaptive regression splines (MARS);",
    "v = support vector machines (SVM); r = random forests (RF); n = neural networks (NN)",
    "The ensemble weights is percentage that each algorithm contributed to the ensemble model",
    "NOTE: if 'R2 Ensemble' is greater than 'R2 Final', then the output model is only the ensembled model (the thin-plate-spline of residuals were not used)",
]


def write_geotiff(
    results: Sequence,
    out_dir: str = ".",
    out_names: Sequence[str] | None = None,
    overwrite: bool = True,
    seed: int | None = None,
    overviews: bool | Sequence[int] = False,
):
    """Write each layer's final raster + the summary CSV; returns paths.

    ``overviews=True`` additionally builds a GDAL-compatible ``<layer>.tif.ovr``
    pyramid per raster (NaN-aware averaged levels; see io/overviews.py); pass
    a list of decimation factors to choose the ladder explicitly.  Off by
    default to mirror terra::writeRaster (V73:1011), which emits none."""
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, res in enumerate(results):
        name = out_names[i] if out_names else res.name
        path = os.path.join(out_dir, f"{name}.tif")
        if os.path.exists(path) and not overwrite:
            raise FileExistsError(path)
        write_geotiff_file(path, res.final)
        paths.append(path)
        if overviews:
            from .overviews import write_overviews

            levels = None if overviews is True else list(overviews)
            ovr = write_overviews(path, res.final, levels=levels)
            if ovr:
                paths.append(ovr)

    rng = random.Random(seed)
    csv_path = os.path.join(out_dir, f"MACHISPLIN_results_{rng.randint(100000, 999999)}.csv")
    cols = []
    for res in results:
        for c in res.summary:
            if c not in cols:
                cols.append(c)
    with open(csv_path, "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow([""] + cols)
        for i, res in enumerate(results):
            writer.writerow([i + 1] + [res.summary.get(c, "") for c in cols])
    with open(csv_path, "a") as f:
        for line in _LEGEND:
            f.write(line + "\n")
    return paths + [csv_path]


def write_residuals(results: Sequence, out_dir: str = ".", out_names=None):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, res in enumerate(results):
        name = out_names[i] if out_names else res.name
        path = os.path.join(out_dir, f"{name}_residuals.csv")
        with open(path, "w", newline="") as f:
            writer = csv.writer(f)
            writer.writerow(["", "residuals", "long", "lat"])
            for j, row in enumerate(res.residuals):
                writer.writerow([j + 1] + [repr(float(v)) for v in row])
        paths.append(path)
    return paths


def _format_imp(value, indent=0) -> str:
    pad = " " * indent
    if isinstance(value, dict):
        return "\n".join(f"{pad}{k}: {_format_imp(v, indent + 2).lstrip() if not isinstance(v, dict) else chr(10) + _format_imp(v, indent + 2)}" for k, v in value.items())
    if isinstance(value, float):
        return f"{pad}{value:.6g}"
    return f"{pad}{value}"


def write_loadings(results: Sequence, out_dir: str = ".", out_names=None):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for i, res in enumerate(results):
        name = out_names[i] if out_names else res.name
        path = os.path.join(out_dir, f"{name}_model_loadings.txt")
        with open(path, "w") as f:
            for algo, imp in res.var_imp.items():
                f.write(f"${algo}\n")
                f.write(_format_imp(imp))
                f.write("\n\n")
        paths.append(path)
    return paths
