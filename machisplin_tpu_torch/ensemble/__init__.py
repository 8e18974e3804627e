from .cv import CVConfig, residual_matrix, run_cv
from .kfold import fold_masks, kfold, numpy_folds
from .weights import WeightResult, optimize_weights_lbfgsb

__all__ = [
    "CVConfig", "WeightResult", "fold_masks", "kfold", "numpy_folds",
    "optimize_weights_lbfgsb", "residual_matrix", "run_cv",
]
