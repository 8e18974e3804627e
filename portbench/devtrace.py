"""The traced run's device timeline, reduced in memory.

``torch.profiler`` records the host's operations and the benchmark's spans
(``record_function`` ranges named ``pb:<span>``) beside every kernel, copy
and set on the card.  ``reduce`` keeps only what the metrics read: the
device's busy time (the union of its intervals inside the window), the
seconds of each device operation by name, and the idle gaps, each named by
the benchmark span and the host operation open at its middle.  No trace
file is written."""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

SPAN_PREFIX = "pb:"
WINDOW = SPAN_PREFIX + "window"


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    device_ops: dict = field(default_factory=dict)     # name -> seconds
    idle_gaps: dict = field(default_factory=dict)      # "span / host op" -> seconds

    def op_seconds(self, fragment: str) -> float:
        """Seconds of the device operations whose name holds ``fragment``."""
        return sum(s for name, s in self.device_ops.items() if fragment in name)

    def top(self, which: str, k: int = 10) -> list:
        d = getattr(self, which)
        return [[name, s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:k]]


def _interval(ev) -> tuple[int, int]:
    start = ev.start_ns() if hasattr(ev, "start_ns") else int(ev.start_us() * 1000)
    dur = ev.duration_ns() if hasattr(ev, "duration_ns") else int(ev.duration_us() * 1000)
    return start, start + dur


def _is_device(kind, known: dict) -> bool:
    """Whether a device type (as the profiler gives it) is CUDA's; ``known``
    keeps the answers, since a window holds millions of events."""
    if kind not in known:
        known[kind] = str(kind).split(".")[-1].upper() == "CUDA"
    return known[kind]


def short_name(name: str) -> str:
    """A kernel's name without its return type, namespace noise and
    parameter list, at most 120 characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for k, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and k > 0:
            name = name[:k]
            break
    return name[:120].strip()


def reduce(prof) -> TraceSummary:
    """Reduce a stopped ``torch.profiler.profile`` whose window is the
    ``pb:window`` range."""
    events = prof.profiler.kineto_results.events()
    spans, host_ops, dev = [], [], []
    window = None
    known: dict = {}
    for ev in events:
        name = ev.name()
        a, b = _interval(ev)
        if _is_device(ev.device_type(), known):
            # the profiler mirrors the benchmark's spans on the device's
            # timeline; they are not device work
            if b > a and not name.startswith(SPAN_PREFIX):
                dev.append((a, b, short_name(name)))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(SPAN_PREFIX):
            spans.append((a, b, name[len(SPAN_PREFIX):]))
        else:
            host_ops.append((a, b, name))
    if window is None:
        raise RuntimeError("the trace holds no pb:window range")
    w0, w1 = window
    ops: dict = {}
    ivs = []
    for a, b, name in dev:
        a, b = max(a, w0), min(b, w1)
        if b <= a:
            continue
        ops[name] = ops.get(name, 0.0) + (b - a) * 1e-9
        ivs.append((a, b))
    ivs.sort()
    busy, gaps, cur = 0, [], None
    last_end = w0
    for a, b in ivs:
        if cur is None or a > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            if a > last_end:
                gaps.append((last_end, a))
            cur = [a, b]
        else:
            cur[1] = max(cur[1], b)
        last_end = max(last_end, b)
    if cur is not None:
        busy += cur[1] - cur[0]
    if w1 > last_end:
        gaps.append((last_end, w1))
    return TraceSummary(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9, device_ops=ops,
                        idle_gaps=_name_gaps(gaps, spans, host_ops))


def _innermost(intervals, starts, t):
    """The latest-starting interval of ``intervals`` (sorted by start) that
    holds ``t``, looking back at most 256 entries."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - 256, -1), -1):
        a, b, name = intervals[j]
        if a <= t <= b:
            return name
    return None


def _name_gaps(gaps, spans, host_ops) -> dict:
    spans.sort()
    host_ops.sort()
    s_starts = [s[0] for s in spans]
    h_starts = [h[0] for h in host_ops]
    out: dict = {}
    for a, b in gaps:
        mid = (a + b) // 2
        span = _innermost(spans, s_starts, mid) or "between spans"
        op = _innermost(host_ops, h_starts, mid) or "python"
        key = f"{span} / {op}"
        out[key] = out.get(key, 0.0) + (b - a) * 1e-9
    return out
