"""Structured per-phase timing, the port's spans and a profiler trace (the
counterpart of machisplin_tpu.utils.timing).

Phases are host wall-clock spans.  Work on a CUDA device is asynchronous, so
a phase that launches device work synchronises the device before it closes;
otherwise the span would measure only the launches.  ``trace(log_dir)``
records a ``torch.profiler`` trace of its block into ``log_dir``.

``span(name)`` marks a step of the program in whatever profiler is running
(``trace``, or a benchmark's own ``torch.profiler.profile``) as a range
named ``port:<name>``, on the profiler's clock beside the device's kernels
and copies; it never synchronises.  With no profiler running it costs one
check and records nothing.  Every ``PhaseTimer`` phase is a span too."""
from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["PhaseTimer", "SPAN_PREFIX", "span", "trace"]

SPAN_PREFIX = "port:"
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context marking the block as the program step ``name``: a
    ``port:<name>`` range of the running profiler, nested in the span open
    around it; the shared no-op context when no profiler runs.

    The range is a plain profiler operation, not a ``record_function``
    annotation: the profiler mirrors an annotation onto the device's
    timeline as an interval spanning the kernels launched inside it, which
    a reading of the device's busy time would take for device work."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + name)


@dataclass
class PhaseTimer:
    phases: dict = field(default_factory=dict)
    _order: list = field(default_factory=list)

    @contextlib.contextmanager
    def phase(self, name: str):
        with span(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
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


@contextlib.contextmanager
def trace(log_dir: str | None):
    """``torch.profiler`` trace of the block when a ``log_dir`` is given
    (host activity, and the card's where a CUDA device is present), written
    into ``log_dir`` as a Chrome trace (``trace_<pid>_<ns>.json``, readable
    in chrome://tracing or Perfetto), with the port's spans in it; a no-op
    for None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
