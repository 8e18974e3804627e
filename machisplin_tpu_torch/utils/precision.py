"""Full-f32 matmul precision for the statistical compute paths.

The port's matmuls carry statistics (kernel matrices, QR and normal-equation
factors, model coefficients), where TF32's ~3 decimal digits would break the
parity with the reference and, as the JAX package found with bf16 inputs,
the thin-plate spline's large-coefficient cancellation.  TF32 is turned off
for matmuls and for cuDNN, and float32 matmuls run at "highest" precision.
"""
from __future__ import annotations

import torch

__all__ = ["highest_precision"]


def highest_precision() -> None:
    """Pin float32 matmuls and convolutions to full float32 (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
