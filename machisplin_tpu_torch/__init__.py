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

Every name of the JAX package's public API has its counterpart here: the
grid substrate (``grid.py``), the GeoTIFF codec, the output writers and
checkpoint/resume (``io/``), and the tiled-landscape workflow
(``tiles_create`` -> ``mltps`` per tile -> ``tiles_merge``,
``pipeline/tiles.py``).  The device mesh (``parallel/sharded.py``) runs
``mltps``, the CV, the batched BRT fits, the raster passes, the TPS tiles
and the Nystrom fit SPMD over ``torch.distributed``, one process a rank;
the host library (``csrc/host_native.cpp`` through ``io/native.py``,
built with the C++ compiler at first use) decodes GeoTIFF strips.
"""
from .utils.precision import highest_precision

highest_precision()

from .data import example_grid, load_sampling, synthetic_covariates  # noqa: E402
from .grid import (  # noqa: E402
    WGS84, GridSpec, Raster, crop, extend, extract, lonlat_rasters, mosaic, resample_near, stack,
)
from .io.checkpoint import load_layer, mltps_resumable, save_layer  # noqa: E402
from .io.geotiff import read_geotiff, write_geotiff_file  # noqa: E402
from .io.writers import write_geotiff, write_loadings, write_residuals  # noqa: E402
from .ops.feather import feather_blend  # noqa: E402
from .ops.tps import TPSModel, tps_factor, tps_fit, tps_predict, tps_predict_grid, tps_solve  # noqa: E402
from .pipeline.mltps import LayerResult, MLTPSConfig, mltps  # noqa: E402
from .pipeline.tiles import tiles_create, tiles_id, tiles_merge  # noqa: E402
from .utils.timing import PhaseTimer  # noqa: E402

__version__ = "0.1.0"

__all__ = [
    "GridSpec", "LayerResult", "MLTPSConfig", "PhaseTimer", "Raster", "TPSModel", "WGS84",
    "crop", "example_grid", "extend", "extract", "feather_blend", "load_layer", "load_sampling",
    "lonlat_rasters", "mltps", "mltps_resumable", "mosaic", "read_geotiff", "resample_near", "save_layer",
    "stack", "synthetic_covariates", "tiles_create", "tiles_id", "tiles_merge",
    "tps_factor", "tps_fit", "tps_predict", "tps_predict_grid", "tps_solve",
    "write_geotiff", "write_geotiff_file", "write_loadings", "write_residuals", "__version__",
]
