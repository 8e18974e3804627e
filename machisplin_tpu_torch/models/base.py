"""Model zoo protocol (counterpart of ``machisplin_tpu/models/base.py``).

Every algorithm module exposes ``fit(x, y, *, sample_weight=None, **hyper)``,
``predict(state, x)`` and ``importance(state, ...)``.  ``x`` is (n, p); ``y``
and ``sample_weight`` are (n,) or (B, n): a leading batch axis trains B models
at once (CV folds, responses), where the JAX package used ``vmap``.  A 0/1
``sample_weight`` trains on a subset without changing shapes (V73:225-252).
"""
from __future__ import annotations

import torch

ALGORITHM_LETTERS = {"brt": "b", "gam": "g", "nn": "n", "mars": "m", "rf": "r", "svm": "v"}

# the order in which the reference assembles its letter string (V73:340-362)
LETTER_ORDER = ("b", "g", "n", "m", "r", "v")
LETTER_TO_NAME = {v: k for k, v in ALGORITHM_LETTERS.items()}


def as_weight(sample_weight, shape, dtype, device) -> torch.Tensor:
    if sample_weight is None:
        return torch.ones(shape, dtype=dtype, device=device)
    return torch.as_tensor(sample_weight, device=device).to(dtype)
