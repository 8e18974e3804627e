from .feather import crossfade, feather_blend
from .host_tps import tps_fit_host
from .nystrom import nystrom_tps_fit, select_landmarks
from .tps import (
    TPSFactor, TPSModel, gcv_curve, tps_factor, tps_fit, tps_fit_auto, tps_predict, tps_predict_grid, tps_solve,
)

__all__ = [
    "TPSFactor", "TPSModel", "crossfade", "feather_blend", "gcv_curve", "nystrom_tps_fit", "select_landmarks",
    "tps_factor", "tps_fit", "tps_fit_auto", "tps_fit_host", "tps_predict", "tps_predict_grid", "tps_solve",
]
