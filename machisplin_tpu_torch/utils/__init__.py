from .logging import banner, log, run_log
from .precision import highest_precision
from .timing import PhaseTimer, trace

__all__ = ["PhaseTimer", "banner", "highest_precision", "log", "resolve_device", "run_log", "trace"]


def resolve_device(device):
    """The torch device an entry point runs on.

    ``"cuda"`` (the default everywhere) raises when no GPU is present: the
    port never drops to the CPU on its own; callers ask for ``"cpu"``."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
