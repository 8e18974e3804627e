"""Seconds a call in the benchmark's synchronised span around the port's
``tps_predict_grid`` (K1's tables and launches) and the gather of the
checked rows, averaged over the calls of the traced window."""


def read(rec):
    s = rec.spans.get("surface")
    return sum(s) / len(s) if s else None
