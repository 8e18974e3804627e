"""k-fold cross-validation of the ensemble's algorithms.

Counterpart of ``machisplin_tpu/ensemble/cv.py`` (V73:220-320): assign k=10
folds per response, train each algorithm on every fold's train split and
collect the test-split residuals, concatenated fold-major into one vector per
algorithm.  Above 4000 rows the split is INVERTED — train on one fold, test
on the other nine (V73:227-232).

Every (response, fold) model of a letter trains in one batched call: the
0/1 train masks ride a leading batch axis of the model's ``sample_weight``;
for BRT (``b``) every (response, fold) pair is one outer chain of the
batched gbm.step (``models/gbm_step.fit_outer_batched``, kernel K2); for NN
(``n``) every (response, fold) pair is one lane of the batched L-BFGS
(``models/nn.py``), on a response min-shifted and max-scaled to [0, 1] with
its train split's statistics (V73:234-241); for SVM (``v``) every pair is
one lane of the batched coordinate sweep (kernel K4), on the gathered rows
of its one training fold when the split is inverted; for RF (``r``) the
(response x fold) forests grow ``CVConfig.rf_group`` a call (all in one
call by default) and the predictions come from the growers' own node
assignments (``RFState.train_pred``).  All six
letters of the reference are ported: ``b`` (BRT), ``g`` (GAM), ``n`` (NN),
``m`` (MARS), ``r`` (RF) and ``v`` (SVM).

With a device mesh (``parallel/sharded.py``) the kernels' work splits
across the ranks: the BRT's boosting chains (K2), the SVM's sweep lanes
(K4) and the RF's forests (each rank its share).  The plain
PyTorch fits run the whole lane batch: the GAM, NN and MARS on rank 0,
which sends their predictions to every rank, and the SVM's operands on
every rank.  PyTorch's CUDA reductions lay out their threads by the batch
width, so a lane computed in a narrower batch parts from the unsharded run
in the last bits, which the NN's L-BFGS steps and MARS's greedy picks then
amplify.  Every draw is made for the whole batch on every rank and sliced,
so each lane's result does not depend on the world size.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import time

import numpy as np
import torch

from ..models import gam, gbm_step, mars, nn, rf, svm
from ..parallel.sharded import gather_rows, rank0_result, share_rows
from ..utils.timing import PhaseTimer
from .kfold import fold_masks, kfold

__all__ = ["CVConfig", "run_cv", "residual_matrix"]

log = logging.getLogger("machisplin_tpu_torch.cv")

PORTED_LETTERS = "bgnmrv"


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
    rf: dict = dataclasses.field(default_factory=lambda: dict(ntree=500))
    rf_group: int | None = None  # (response x fold) forests grown per call on a device; None: all of them
    nn: dict = dataclasses.field(default_factory=lambda: dict(hidden=10, maxit=10000))
    mars: dict = dataclasses.field(default_factory=dict)
    svm: dict = dataclasses.field(default_factory=dict)
    gam: dict = dataclasses.field(default_factory=dict)


def _nn_y_transform(y, train_w):
    """The reference's train-split min-shift/max-scale (V73:234-241), per
    lane: y and train_w (L, n) -> (y scaled, y_min (L,), y_max (L,))."""
    big = torch.finfo(y.dtype).max
    y_min = torch.where(train_w > 0, y, big).amin(-1)
    y_shift = y - y_min[:, None]
    y_max = torch.where(train_w > 0, y_shift, -big).amax(-1).clamp_min(1e-12)
    return y_shift / y_max[:, None], y_min, y_max


def run_cv(
    x, y, *, config: CVConfig | None = None, algorithms: str = "bgnmrv",
    folds=None, generator: torch.Generator | None = None, nn_init=None,
    svm_pairs=None, rf_draws=None, timer: PhaseTimer | None = None, mesh=None,
) -> dict[str, np.ndarray]:
    """Returns {letter: fold-major concatenated test residuals}.

    ``y`` is (n,) for one response or (n, R) for a batch; a batch returns
    {letter: (R, n_concat)}.  ``folds`` injects the (R, n) fold ids; without
    it they are drawn per response from ``generator``, which also seeds the
    BRT letter's fold selectors and bag draws, the NN's initial weights, the
    SVM's sigest pairs and the RF's bootstrap rows and node feature draws.
    ``nn_init`` injects the NN's weights instead: (w1, b1, w2, b2) with a
    leading (response x fold) axis, response-major; ``svm_pairs`` the SVM's
    sigest pairs (i, j), each (R*K, m), indices into the rows each lane fits
    on; ``rf_draws`` the RF's (bootstrap counts (R*K, ntree, n), node
    feature scores (R*K, ntree, 2^max_depth - 1, p)).  ``timer`` times each
    letter as phase ``cv_<letter>`` (synchronised, so a letter's seconds on
    a GPU are its own).

    ``mesh``: every rank calls ``run_cv`` with the same inputs and
    generator state; the BRT's chains, the SVM's sweep lanes and the RF's
    forests split across the ranks (see the module docstring) and every
    rank returns the full result.  The draws are made whole and sliced, so
    the generator is consumed as without a mesh.
    """
    for name in algorithms:
        if name not in PORTED_LETTERS:
            raise ValueError(f"unknown algorithm {name!r}: the pool is {PORTED_LETTERS!r}")
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
    n_lanes = n_resp * k

    timer = timer or PhaseTimer()
    preds = {}

    @contextlib.contextmanager
    def letter(name):
        t0 = time.perf_counter()
        with timer.phase(f"cv_{name}"):
            yield
        log.info("cv letter %s done in %.1f s", name, time.perf_counter() - t0)

    if "g" in algorithms:
        with letter("g"):
            preds["g"] = rank0_result(mesh, x.device, lambda: gam.predict(
                gam.fit(x, flat_y, sample_weight=flat_w, **config.gam), x))
    if "n" in algorithms:
        with letter("n"):
            # every (response, fold) model is one lane of the batched L-BFGS
            yn, y_min, y_max = _nn_y_transform(flat_y, flat_w)
            if mesh is not None and nn_init is None:
                nn_init = nn.draw_init(n_lanes, x.shape[1], config.nn.get("hidden", 10),
                                       config.nn.get("init_range", 0.7), generator, x.dtype, x.device)
            pred = rank0_result(mesh, x.device, lambda: nn.predict(
                nn.fit(x, yn, sample_weight=flat_w, init=nn_init, generator=generator, **config.nn), x))
            preds["n"] = pred * y_max[:, None] + y_min[:, None]
    if "m" in algorithms:
        with letter("m"):
            preds["m"] = rank0_result(mesh, x.device, lambda: mars.predict(
                mars.fit(x, flat_y, sample_weight=flat_w, **config.mars), x))
    if "v" in algorithms:
        with letter("v"):
            if invert:
                # each model trains on one ~n/k-row fold (V73:227-232): fit on
                # its active rows, in order, padded with inactive rows (weight 0)
                n_tr = int((flat_w > 0).sum(1).max())
                idx = torch.argsort((flat_w <= 0).to(torch.int8), dim=1, stable=True)[:, :n_tr]
                state = svm.fit(x[idx], flat_y.gather(1, idx), sample_weight=flat_w.gather(1, idx),
                                pairs=svm_pairs, generator=generator, mesh=mesh, **config.svm)
            else:
                state = svm.fit(x, flat_y, sample_weight=flat_w, pairs=svm_pairs, generator=generator, mesh=mesh,
                                **config.svm)
            preds["v"] = svm.predict(state, x)
    if "r" in algorithms:
        with letter("r"):
            # predictions at x from the growers' own node assignments; each
            # rank grows its share of the forests (all of them without a
            # mesh), rf_group a call, from draws made for all of them at once
            counts, scores = rf.draw(flat_w, x.shape[1], generator=generator, **config.rf) if rf_draws is None \
                else rf_draws
            counts = torch.as_tensor(counts)
            scores = None if scores is None else torch.as_tensor(scores)
            idx = share_rows(n_lanes, mesh)
            mine = [None if a is None else a[idx.to(a.device)] for a in (flat_y, flat_w, counts, scores)]
            group = len(idx) if config.rf_group is None else max(1, config.rf_group)
            grown = []
            for s in range(0, len(idx), group):
                yy, ww, cc, ss = (None if a is None else a[s : s + group] for a in mine)
                grown.append(rf.fit(x, yy, sample_weight=ww, boot_counts=cc, scores=ss, **config.rf).train_pred)
            preds["r"] = gather_rows(torch.cat(grown), n_lanes, mesh)
    if "b" in algorithms:
        with letter("b"):
            # every (response, outer fold) gbm.step run is one outer chain of
            # a single batched curve: R x K x K boosting chains per K2 launch
            preds_b, _ = gbm_step.fit_outer_batched(x, flat_y, flat_w, generator=generator, mesh=mesh,
                                                    **config.brt)
            preds["b"] = preds_b.to(x.dtype)

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


def residual_matrix(cv_out: dict[str, np.ndarray], letters: str = "bgnmrv") -> np.ndarray:
    """(A, n_concat) matrix in canonical letter order for the weight search."""
    return np.stack([cv_out[letter] for letter in letters])
