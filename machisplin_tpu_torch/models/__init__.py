"""Model zoo: the letters ported so far (``b`` BRT via gbm.step, ``g`` GAM,
``n`` NN, ``m`` MARS)."""
from . import brt, gam, gbm_step, mars, nn, trees
from .base import ALGORITHM_LETTERS, LETTER_ORDER, LETTER_TO_NAME

__all__ = ["ALGORITHM_LETTERS", "LETTER_ORDER", "LETTER_TO_NAME", "brt", "gam", "gbm_step", "mars", "nn", "trees"]
