"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
no sparsity, at the full 700 W power limit).  A roofline share is stated
against these, with the card's power limit beside it."""

PEAKS = {
    "float32_ops": 67e12,     # CUDA cores, outside the tensor cores
    "float64_ops": 34e12,     # CUDA cores
    "tf32_ops": 495e12,
    "bf16_ops": 989e12,
    "hbm_bytes": 3.35e12,     # HBM3, bytes a second
}


def bound_s(ops: float, nbytes: float, ops_peak: str = "float32_ops") -> tuple[float, str]:
    """The least seconds ``ops`` operations and ``nbytes`` bytes of memory
    traffic take on the card, and which of the two bounds it."""
    t_ops, t_bytes = ops / PEAKS[ops_peak], nbytes / PEAKS["hbm_bytes"]
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")
