"""Seconds a call: the completed calls' wall times, summed, over their
count.  Each call is timed on the host clock from the end of the one before
to its own closing device synchronise, so the window holds nothing untimed."""


def read(rec):
    return sum(rec.calls) / len(rec.calls) if rec.calls else None
