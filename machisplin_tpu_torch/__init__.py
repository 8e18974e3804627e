"""machisplin_tpu_torch — the PyTorch + CUDA port of machisplin_tpu.

A second package beside the JAX one, ported slice by slice; it imports
torch, numpy and scipy and nothing of JAX or of ``machisplin_tpu``.  Entry
points take ``device=`` (default ``"cuda"``, which raises without a GPU).
The TPS grid prediction runs a hand-written CUDA kernel (``csrc/``, built
with nvcc at first use) on CUDA tensors and its plain PyTorch version on CPU
tensors.  This slice runs ``mltps`` over the GAM + MARS pool.
"""
from .utils.precision import highest_precision

highest_precision()

from .data import example_grid, load_sampling, synthetic_covariates  # noqa: E402
from .grid import GridSpec, Raster, crop, extract, lonlat_rasters, mosaic, stack  # noqa: E402
from .ops.feather import feather_blend  # noqa: E402
from .ops.tps import TPSModel, tps_factor, tps_fit, tps_predict, tps_predict_grid, tps_solve  # noqa: E402
from .pipeline.mltps import LayerResult, MLTPSConfig, mltps  # noqa: E402
from .utils.timing import PhaseTimer  # noqa: E402

__all__ = [
    "GridSpec", "LayerResult", "MLTPSConfig", "PhaseTimer", "Raster", "TPSModel",
    "crop", "example_grid", "extract", "feather_blend", "load_sampling",
    "lonlat_rasters", "mltps", "mosaic", "stack", "synthetic_covariates",
    "tps_factor", "tps_fit", "tps_predict", "tps_predict_grid", "tps_solve",
]
