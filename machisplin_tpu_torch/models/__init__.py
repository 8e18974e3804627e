"""Model zoo: the six letters of the reference (``b`` BRT via gbm.step,
``g`` GAM, ``n`` NN, ``m`` MARS, ``r`` RF, ``v`` SVM)."""
from . import base, brt, deviance, gam, gbm_step, mars, nn, rf, svm, trees
from .base import ALGORITHM_LETTERS, LETTER_ORDER, LETTER_TO_NAME

__all__ = ["ALGORITHM_LETTERS", "LETTER_ORDER", "LETTER_TO_NAME", "base", "brt", "deviance", "gam", "gbm_step",
           "mars", "nn", "rf", "svm", "trees"]
