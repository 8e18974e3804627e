"""breakDown-style variable importance for black-box models (the SVM path);
counterpart of ``machisplin_tpu/pipeline/importance.py``.

The reference explains the final SVM with ``breakDown::broken`` on up to 200
sampled stations (seed 1313), averaging absolute per-variable contributions
(V73:562-580).  For each sampled observation, a variable's contribution is
the shift of the model's mean prediction over the background sample when
that variable is fixed to the observation's value; absolute contributions
are averaged over the sample.  The sample is drawn with numpy's
``default_rng(seed)``, as the JAX package draws it, and the averages are
taken in numpy, so both packages give the same numbers for the same
predictions.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["breakdown_importance"]


def breakdown_importance(predict_fn, x, names, n_sample: int = 200, seed: int = 1313) -> dict:
    """``predict_fn`` maps an (m, p) tensor on ``x``'s device (in its dtype)
    to (m,) predictions; ``x`` the (n, p) training inputs."""
    xt = torch.as_tensor(x)
    x_np = xt.cpu().numpy()
    n, p = x_np.shape
    rng = np.random.default_rng(seed)
    sample = x_np[rng.choice(n, n_sample, replace=False)] if n > n_sample else x_np
    m = sample.shape[0]

    def run(a):
        return predict_fn(torch.as_tensor(a, device=xt.device)).cpu().numpy()

    base = float(np.mean(run(sample)))
    acc = np.zeros(p)
    for j in range(p):
        # row block i holds the background with x_j := sample[i, j]
        rep = np.tile(sample, (m, 1))
        rep[:, j] = np.repeat(sample[:, j], m)
        contrib = run(rep).reshape(m, m).mean(axis=1) - base
        acc[j] = np.mean(np.abs(contrib))
    return {nm: {"contributions to SVM": float(acc[j])} for j, nm in enumerate(names)}
