from .cv import CVConfig, residual_matrix, run_cv
from .kfold import fold_masks, kfold, numpy_folds
from .weights import (
    WeightResult, ensemble_objective, optimize_weights_aicc, optimize_weights_lbfgsb, optimize_weights_sweep,
)

__all__ = [
    "CVConfig", "WeightResult", "fold_masks", "kfold", "numpy_folds",
    "ensemble_objective", "optimize_weights_aicc", "optimize_weights_lbfgsb", "optimize_weights_sweep",
    "residual_matrix", "run_cv",
]
