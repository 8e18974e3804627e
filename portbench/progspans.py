"""The port's own spans in a traced run, reduced in memory.

The port marks its steps as ``port:<name>`` ranges of the running profiler
(``machisplin_tpu_torch.utils.timing.span``), on the same clock as the
card's kernels and copies.  ``reduce`` gives, for each program span name
and for each benchmark span (``pb:<name>``), summed over its instances in
the ``pb:window`` range:

* ``completed_s``: from the span's host start to the end of the last device
  operation launched inside it, or to its host end where that is later;
* ``device_s``: the device seconds of the operations launched inside it;
* ``idle_s``: the idle gaps whose middle it holds;
* ``launches``: the runtime's kernel launches inside it;
* ``host_syncs``: the runtime's ``*Synchronize`` calls and blocking copies
  inside it: where the host waits for the card.

A device operation is joined to its launch, a call of the CUDA runtime or
driver (a host event named ``cu*``), by the profiler's correlation id; one
whose launch the trace lacks is counted as unattributed.  The busy
intervals and idle gaps are those ``devtrace.reduce`` finds in the same
window; a gap under a program span is named by the benchmark span, the
innermost program span and the host operation open at its middle
("fit / tps.gcv_search / aten::mul"), any other as ``devtrace`` names it.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from .devtrace import SPAN_PREFIX, WINDOW, _innermost, _interval, _is_device

PORT_PREFIX = "port:"
RUNTIME_PREFIX = "cu"


@dataclass
class SpanStats:
    count: int = 0
    completed_s: float = 0.0
    device_s: float = 0.0
    idle_s: float = 0.0
    launches: int = 0
    host_syncs: int = 0
    program_device_s: float = 0.0   # of device_s, launched under a program span too
    program_idle_s: float = 0.0     # of idle_s, under a program span too

    def per(self, calls: int) -> dict:
        """Each number over ``calls``."""
        return {k: v / calls for k, v in vars(self).items() if k != "count"}


@dataclass
class SpanSummary:
    program: dict = field(default_factory=dict)    # program span name -> SpanStats
    bench: dict = field(default_factory=dict)      # benchmark span name -> SpanStats
    idle_gaps: dict = field(default_factory=dict)  # "span / program span / host op" -> seconds
    device_s: float = 0.0                          # device seconds of the window
    unattributed_s: float = 0.0                    # of device_s, whose launch the trace lacks


def _is_launch(name: str) -> bool:
    return "Launch" in name


def _is_host_sync(name: str) -> bool:
    return name.endswith("Synchronize") or (name.startswith(("cudaMemcpy", "cuMemcpy")) and "Async" not in name)


def _holders(spans):
    """A lookup from a time to the indices of the spans (a, b, ...) that hold
    it, a <= t < b: the elementary segments between all spans' ends."""
    marks = sorted([(s[0], 1, i) for i, s in enumerate(spans)] + [(s[1], 0, i) for i, s in enumerate(spans)])
    bounds, held, cur = [], [], set()
    for t, opens, i in marks:
        (cur.add if opens else cur.discard)(i)
        if bounds and bounds[-1] == t:
            held[-1] = tuple(cur)
        else:
            bounds.append(t)
            held.append(tuple(cur))

    def lookup(t):
        k = bisect.bisect_right(bounds, t) - 1
        return held[k] if k >= 0 else ()

    return lookup


def reduce(prof) -> SpanSummary:
    """Reduce a stopped ``torch.profiler.profile`` whose window is the
    ``pb:window`` range."""
    events = prof.profiler.kineto_results.events()
    spans, host_ops, dev, launches, syncs = [], [], [], [], []
    launched_at: dict = {}
    window = None
    known: dict = {}
    for ev in events:
        name = ev.name()
        a, b = _interval(ev)
        if _is_device(ev.device_type(), known):
            if b > a and not name.startswith(SPAN_PREFIX):
                dev.append((a, b, ev.correlation_id()))
        elif name == WINDOW:
            window = (a, b)
        elif name.startswith(SPAN_PREFIX):
            spans.append((a, b, name[len(SPAN_PREFIX):], False))
        elif name.startswith(PORT_PREFIX):
            spans.append((a, b, name[len(PORT_PREFIX):], True))
        else:
            host_ops.append((a, b, name))
            if name.startswith(RUNTIME_PREFIX):
                launched_at[ev.correlation_id()] = a
                if _is_launch(name):
                    launches.append(a)
                elif _is_host_sync(name):
                    syncs.append(a)
    if window is None:
        raise RuntimeError("the trace holds no pb:window range")
    w0, w1 = window
    spans = sorted(s for s in spans if s[0] < w1 and s[1] > w0)
    n = len(spans)
    held = _holders(spans)
    last_end = [s[1] for s in spans]
    dev_s, prog_dev_s, idle_s, prog_idle_s = [0.0] * n, [0.0] * n, [0.0] * n, [0.0] * n
    n_launch, n_sync = [0] * n, [0] * n
    out = SpanSummary()

    ivs = []
    for a, b, corr in dev:
        ca, cb = max(a, w0), min(b, w1)
        if cb <= ca:
            continue
        ivs.append((ca, cb))
        sec = (cb - ca) * 1e-9
        out.device_s += sec
        t = launched_at.get(corr)
        if t is None:
            out.unattributed_s += sec
            continue
        hs = held(t)
        in_prog = any(spans[i][3] for i in hs)
        for i in hs:
            dev_s[i] += sec
            prog_dev_s[i] += sec if in_prog else 0.0
            last_end[i] = max(last_end[i], b)
    for times, counts in ((launches, n_launch), (syncs, n_sync)):
        for t in times:
            for i in held(t):
                counts[i] += 1

    bench_sorted = sorted((a, b, name) for a, b, name, prog in spans if not prog)
    prog_sorted = sorted((a, b, name) for a, b, name, prog in spans if prog)
    host_ops.sort()
    b_starts, p_starts, h_starts = ([s[0] for s in x] for x in (bench_sorted, prog_sorted, host_ops))
    for a, b in _gaps(ivs, w0, w1):
        mid = (a + b) // 2
        sec = (b - a) * 1e-9
        hs = held(mid)
        in_prog = any(spans[i][3] for i in hs)
        for i in hs:
            idle_s[i] += sec
            prog_idle_s[i] += sec if in_prog else 0.0
        parts = [_innermost(bench_sorted, b_starts, mid) or "between spans"]
        if in_prog:
            parts.append(_innermost(prog_sorted, p_starts, mid))
        parts.append(_innermost(host_ops, h_starts, mid) or "python")
        key = " / ".join(parts)
        out.idle_gaps[key] = out.idle_gaps.get(key, 0.0) + sec

    for i, (a, b, name, prog) in enumerate(spans):
        st = (out.program if prog else out.bench).setdefault(name, SpanStats())
        st.count += 1
        st.completed_s += (max(b, last_end[i]) - a) * 1e-9
        st.device_s += dev_s[i]
        st.idle_s += idle_s[i]
        st.launches += n_launch[i]
        st.host_syncs += n_sync[i]
        st.program_device_s += prog_dev_s[i]
        st.program_idle_s += prog_idle_s[i]
    return out


def _gaps(ivs, w0, w1):
    """The window's stretches that no interval of ``ivs`` covers."""
    gaps, last_end = [], w0
    for a, b in sorted(ivs):
        if a > last_end:
            gaps.append((last_end, a))
        last_end = max(last_end, b)
    if w1 > last_end:
        gaps.append((last_end, w1))
    return gaps
