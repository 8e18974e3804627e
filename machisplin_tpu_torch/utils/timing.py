"""Structured per-phase timing (the counterpart of machisplin_tpu.utils.timing).

Phases are host wall-clock spans.  Work on a CUDA device is asynchronous, so
a phase that launches device work synchronises the device before it closes;
otherwise the span would measure only the launches."""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

__all__ = ["PhaseTimer"]


@dataclass
class PhaseTimer:
    phases: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            import torch

            if torch.cuda.is_available() and torch.cuda.is_initialized():
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name not in self.phases:
                self._order.append(name)
                self.phases[name] = 0.0
            self.phases[name] += dt

    def report(self) -> str:
        total = sum(self.phases.values())
        lines = [f"{'phase':<40} {'seconds':>10} {'share':>7}"]
        for name in self._order:
            dt = self.phases[name]
            lines.append(f"{name:<40} {dt:>10.2f} {dt / max(total, 1e-9):>6.1%}")
        lines.append(f"{'TOTAL':<40} {total:>10.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return dict(self.phases)
