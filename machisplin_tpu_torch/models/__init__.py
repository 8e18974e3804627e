"""Model zoo: the letters ported so far (``g`` GAM, ``m`` MARS)."""
from . import gam, mars
from .base import ALGORITHM_LETTERS, LETTER_ORDER, LETTER_TO_NAME

__all__ = ["ALGORITHM_LETTERS", "LETTER_ORDER", "LETTER_TO_NAME", "gam", "mars"]
