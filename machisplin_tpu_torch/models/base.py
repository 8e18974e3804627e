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


def chunk_elems(cpu_elems: int, dtype, device, cuda_bytes: int) -> int:
    """Values a chunked batch computation may hold at once: ``cpu_elems`` on
    the CPU; on a CUDA device ``cuda_bytes`` of ``dtype`` (and never fewer
    than ``cpu_elems``).  The chunks, and with them a run's bits, follow
    these constants, not the card the run is on or what else it holds; each
    caller's constant states what it leaves for a second rank on the card."""
    if torch.device(device).type != "cuda":
        return cpu_elems
    return max(cpu_elems, cuda_bytes // torch.empty((), dtype=dtype).element_size())
