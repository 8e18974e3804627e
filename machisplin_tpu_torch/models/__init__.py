"""Model zoo: the letters ported so far (``b`` BRT via gbm.step, ``g`` GAM,
``m`` MARS)."""
from . import brt, gam, gbm_step, mars, trees
from .base import ALGORITHM_LETTERS, LETTER_ORDER, LETTER_TO_NAME

__all__ = ["ALGORITHM_LETTERS", "LETTER_ORDER", "LETTER_TO_NAME", "brt", "gam", "gbm_step", "mars", "trees"]
