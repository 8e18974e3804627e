"""Kernel K1's share of its roofline, in %: the least time the window's
surfaces need on the card (``roofline/k1.py``: operations over the float32
peak, or bytes over the HBM bandwidth, whichever is larger, counted from
the inputs' shapes by the entry) over K1's device time, summed over its
launches in the profiler's trace.  Nothing where the trace holds no K1."""

KERNEL = "tps_grid_kernel"


def read(rec):
    if rec.trace is None or "k1_bound_s" not in rec.counters:
        return None
    t = rec.trace.op_seconds(KERNEL)
    return 100.0 * rec.counters["k1_bound_s"] / t if t > 0 else None
