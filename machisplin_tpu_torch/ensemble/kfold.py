"""k-fold assignment with the reference's semantics (machisplin.kfold,
V73:1553-1609): near-equal group sizes from rounded cut points, assigned by a
random permutation, and an error when there are fewer records than folds.
Counterpart of ``machisplin_tpu/ensemble/kfold.py`` (stratification ``by``
is not ported yet)."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["kfold", "fold_masks", "numpy_folds"]


def _groups(n: int, k: int) -> np.ndarray:
    """Fold ids before shuffling: rounded cut points -> group sizes
    (V73:1563-1564)."""
    if n / k < 1:
        raise ValueError(f"insufficient records: {n}, with k={k}")
    cuts = np.round(np.concatenate([[0.0], n / k * np.arange(1, k), [float(n)]]))
    return np.repeat(np.arange(k, dtype=np.int64), np.diff(cuts).astype(int))


def kfold(n: int, k: int = 5, generator: torch.Generator | None = None) -> torch.Tensor:
    """Fold id in [0, k) per row (the reference uses 1..k), shuffled by a
    ``torch.randperm`` draw from ``generator``; an int64 CPU tensor."""
    if k == 1:
        return torch.zeros(n, dtype=torch.int64)
    group = torch.from_numpy(_groups(n, k))
    return group[torch.randperm(n, generator=generator)]


def numpy_folds(n: int, k: int, n_resp: int, seed: int = 0) -> np.ndarray:
    """(n_resp, n) fold ids drawn with numpy's ``default_rng(seed)``, one
    permutation per response in order: a draw that both this package and
    the JAX package can be given, so that their runs share folds."""
    group = _groups(n, k)
    rng = np.random.default_rng(seed)
    return np.stack([group[rng.permutation(n)] for _ in range(n_resp)])


def fold_masks(folds: torch.Tensor, k: int, invert: bool = False):
    """(..., k, n) float train/test mask pairs for fold ids (..., n).

    ``invert=True`` reproduces the reference's >4000-row behaviour: train on
    ONE fold and test on the other k-1 (V73:227-232)."""
    ids = torch.arange(k, device=folds.device)[:, None]
    is_fold = (folds[..., None, :] == ids).to(torch.float32)
    if invert:
        return is_fold, 1.0 - is_fold
    return 1.0 - is_fold, is_fold
