"""k-fold cross-validation of the ensemble's algorithms.

Counterpart of ``machisplin_tpu/ensemble/cv.py`` (V73:220-320): assign k=10
folds per response, train each algorithm on every fold's train split and
collect the test-split residuals, concatenated fold-major into one vector per
algorithm.  Above 4000 rows the split is INVERTED — train on one fold, test
on the other nine (V73:227-232).

Every (response, fold) model of a letter trains in one batched call: the
0/1 train masks ride a leading batch axis of the model's ``sample_weight``;
for BRT (``b``) every (response, fold) pair is one outer chain of the
batched gbm.step (``models/gbm_step.fit_outer_batched``, kernel K2).
Letters ported so far: ``b`` (BRT), ``g`` (GAM) and ``m`` (MARS).
"""
from __future__ import annotations

import dataclasses
import logging
import time

import numpy as np
import torch

from ..models import gam, gbm_step, mars
from .kfold import fold_masks, kfold

__all__ = ["CVConfig", "run_cv", "residual_matrix"]

log = logging.getLogger("machisplin_tpu_torch.cv")

PORTED_LETTERS = "bgm"
_LATER = {
    "r": "the random-forest slice",
    "n": "the neural-network slice (optax L-BFGS port)",
    "v": "the SVM slice",
}


def require_ported(letters: str) -> None:
    """Raise NotImplementedError naming the slice that ports a letter."""
    for letter in letters:
        if letter not in PORTED_LETTERS:
            raise NotImplementedError(
                f"algorithm {letter!r} is not ported yet: it comes with "
                f"{_LATER.get(letter, 'a later slice')}"
            )


@dataclasses.dataclass(frozen=True)
class CVConfig:
    """Hyperparameters; defaults mirror the reference's CV call sites
    (V73:247-252)."""

    n_folds: int = 10
    invert_threshold: int = 4000
    brt: dict = dataclasses.field(
        default_factory=lambda: dict(
            tree_complexity=25, learning_rate=0.01, bag_fraction=0.5,
            step_size=50, max_trees=10000,
        )
    )
    mars: dict = dataclasses.field(default_factory=dict)
    gam: dict = dataclasses.field(default_factory=dict)


def run_cv(
    x, y, *, config: CVConfig | None = None, algorithms: str = "gm",
    folds=None, generator: torch.Generator | None = None,
) -> dict[str, np.ndarray]:
    """Returns {letter: fold-major concatenated test residuals}.

    ``y`` is (n,) for one response or (n, R) for a batch; a batch returns
    {letter: (R, n_concat)}.  ``folds`` injects the (R, n) fold ids; without
    it they are drawn per response from ``generator``, which also seeds the
    BRT letter's fold selectors and bag draws.
    """
    require_ported(algorithms)
    config = config or CVConfig()
    x = torch.as_tensor(x)
    y = torch.as_tensor(y, device=x.device)
    single = y.ndim == 1
    ys = (y[:, None] if single else y).to(x.dtype)          # (n, R)
    n, n_resp = ys.shape
    k = config.n_folds
    invert = n > config.invert_threshold
    if folds is None:
        folds = torch.stack([kfold(n, k, generator) for _ in range(n_resp)])
    folds = torch.as_tensor(np.asarray(folds), dtype=torch.int64, device=x.device)
    if folds.shape != (n_resp, n):
        raise ValueError(f"folds must be ({n_resp}, {n}), got {tuple(folds.shape)}")
    train_w, test_w = fold_masks(folds, k, invert=invert)    # (R, K, n)
    flat_w = train_w.reshape(n_resp * k, n).to(x.dtype)
    flat_y = ys.T.repeat_interleave(k, dim=0)                # (R*K, n)

    preds = {}
    if "g" in algorithms:
        t0 = time.perf_counter()
        preds["g"] = gam.predict(gam.fit(x, flat_y, sample_weight=flat_w, **config.gam), x)
        log.info("cv letter g done in %.1f s", time.perf_counter() - t0)
    if "m" in algorithms:
        t0 = time.perf_counter()
        preds["m"] = mars.predict(mars.fit(x, flat_y, sample_weight=flat_w, **config.mars), x)
        log.info("cv letter m done in %.1f s", time.perf_counter() - t0)
    if "b" in algorithms:
        t0 = time.perf_counter()
        # every (response, outer fold) gbm.step run is one outer chain of a
        # single batched curve: R x K x K boosting chains per K2 launch
        preds_b, _ = gbm_step.fit_outer_batched(x, flat_y, flat_w, generator=generator, **config.brt)
        preds["b"] = preds_b.to(x.dtype)
        log.info("cv letter b done in %.1f s", time.perf_counter() - t0)

    # fold-major concatenation of test residuals (V73:255-319), per response
    test_np = test_w.cpu().numpy() > 0
    y_np = ys.cpu().numpy()
    out: dict[str, np.ndarray] = {}
    for letter, p in preds.items():
        p_np = p.cpu().numpy().reshape(n_resp, k, n)
        out[letter] = np.stack([
            np.concatenate([y_np[test_np[r, v], r] - p_np[r, v][test_np[r, v]] for v in range(k)])
            for r in range(n_resp)
        ])
        if single:
            out[letter] = out[letter][0]
    return out


def residual_matrix(cv_out: dict[str, np.ndarray], letters: str = "gm") -> np.ndarray:
    """(A, n_concat) matrix in canonical letter order for the weight search."""
    return np.stack([cv_out[letter] for letter in letters])
