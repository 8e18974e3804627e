from .feather import crossfade, feather_blend
from .tps import TPSFactor, TPSModel, tps_factor, tps_fit, tps_predict, tps_predict_grid, tps_solve

__all__ = [
    "TPSFactor", "TPSModel", "crossfade", "feather_blend", "tps_factor", "tps_fit",
    "tps_predict", "tps_predict_grid", "tps_solve",
]
