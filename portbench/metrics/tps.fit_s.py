"""Seconds a call in the benchmark's synchronised span around the port's
``tps_fit_auto``, averaged over the calls of the traced window."""


def read(rec):
    s = rec.spans.get("fit")
    return sum(s) / len(s) if s else None
