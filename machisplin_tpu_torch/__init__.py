"""machisplin_tpu_torch — the PyTorch + CUDA port of machisplin_tpu.

A second package beside the JAX one, ported slice by slice; it imports
torch, numpy and scipy and nothing of JAX or of ``machisplin_tpu``.  Entry
points take ``device=`` (default ``"cuda"``, which raises without a GPU).
Four hand-written CUDA kernels (``csrc/``, built with nvcc at first use)
run on CUDA tensors, their plain PyTorch versions on CPU tensors: the TPS
grid prediction (K1), the boosting-tree grower (K2), the forest
bin-interval predictor (K3) and the SVM's coordinate sweep (K4).  ``mltps``
runs over all six letters (BRT, GAM, NN, MARS, RF, SVM); the NN trains with
the port's copy of optax's L-BFGS (``optim/lbfgs.py``).
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
