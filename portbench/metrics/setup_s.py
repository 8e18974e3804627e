"""Seconds from the start of the process to the first timed call: imports,
the device's start, loading (or, in a checkout's first run, building) the
kernels, making the inputs and the warm-up calls."""


def read(rec):
    return rec.setup_s
