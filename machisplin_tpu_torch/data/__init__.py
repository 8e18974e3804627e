"""Bundled datasets — the reference's ``data(sampling)`` fixture.

``load_sampling()`` returns the 813-station table (long, lat, bio_1, bio_12;
northern Peru, data-raw/sampling.csv, or its R serialization
data/sampling.RData); ``load_example_dat()`` the same table under the name
``data(example.dat)`` gives it (R/data.R:20-38).  ``example_grid()`` is the bundled
covariate rasters' geometry (3264 x 2476 cells at 0.0008333333 deg), and
``synthetic_covariates`` builds the same alt/slope/TWI-like stack as
``machisplin_tpu.data.synthetic_covariates``, bit for bit: numpy with
``default_rng(seed)`` on float32 cell-centre coordinates.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from ..grid import GridSpec, Raster
from ..utils import resolve_device

__all__ = ["load_sampling", "load_example_dat", "example_grid", "synthetic_covariates"]

_HERE = os.path.dirname(os.path.abspath(__file__))


def load_sampling(source: str = "csv") -> np.ndarray:
    """Structured array with fields long, lat, bio_1, bio_12 (813 rows).

    ``source="rdata"`` decodes the bundled R serialization (the object
    ``data(sampling)`` loads) through ``io/rdata.py`` instead of the CSV;
    the two agree exactly."""
    if source == "rdata":
        from ..io.rdata import read_rdata

        return read_rdata(os.path.join(_HERE, "sampling.RData"))["sampling"]
    if source != "csv":
        raise ValueError(f"source must be 'csv' or 'rdata', got {source!r}")
    return np.genfromtxt(os.path.join(_HERE, "sampling.csv"), delimiter=",", names=True)


def load_example_dat() -> np.ndarray:
    """The reference's second bundled fixture, ``data(example.dat)``: the
    same 813-station table under the name README Example 1 uses, decoded
    from its R serialization."""
    from ..io.rdata import read_rdata

    return read_rdata(os.path.join(_HERE, "example.dat.Rdata"))["example.dat"]


def example_grid(downsample: int = 1) -> GridSpec:
    d = 0.0008333333 * downsample
    return GridSpec(
        nrows=2476 // downsample, ncols=3264 // downsample,
        xmin=-77.7435765934, ymax=-5.8094167820, dx=d, dy=d,
    )


def synthetic_covariates(downsample: int = 8, seed: int = 0, device="cuda") -> Raster:
    """alt/slope/TWI-like float32 stack on the bundled grid geometry, on
    ``device``.  ``downsample=1`` is the full 2476 x 3264 grid."""
    dev = resolve_device(device)
    g = example_grid(downsample)
    rng = np.random.default_rng(seed)
    xs = g.x_coords(torch.float32, "cpu").numpy()[None, :]
    ys = g.y_coords(torch.float32, "cpu").numpy()[:, None]
    # Andes-like ridge running NW-SE with valley dissection
    ridge = 3800 * np.exp(-((xs + 77.3 + 0.35 * (ys + 6.8)) ** 2) / 0.18)
    valleys = 400 * np.sin(40 * xs) * np.cos(35 * ys)
    alt = 300 + ridge + valleys + 30 * rng.standard_normal(g.shape).astype(np.float32)
    alt = alt.astype(np.float32)
    gy, gx = np.gradient(alt)
    slope = np.sqrt(gx**2 + gy**2).astype(np.float32)
    twi = (10 - 2.5 * np.log1p(slope) + rng.normal(0, 0.5, g.shape)).astype(np.float32)
    data = torch.from_numpy(np.stack([alt, slope, twi])).to(dev)
    return Raster(data, g, ("alt", "slope", "TWI"))
