"""Run logging — the reference's MachiSplin.LOG.txt tee (counterpart of
``machisplin_tpu/utils/logging.py``).

The reference tees every progress print to 'MachiSplin.LOG.txt' via sink()
(V73:200/966).  The port's pipeline logs through the ``machisplin_tpu_torch``
logger and its children; ``run_log`` attaches a file handler to it for the
length of a run, and ``banner`` writes a phase banner.  Under a device mesh
``mltps`` opens the file on rank 0 only.
"""
from __future__ import annotations

import contextlib
import logging

log = logging.getLogger("machisplin_tpu_torch")

__all__ = ["banner", "run_log"]


@contextlib.contextmanager
def run_log(path: str = "MachiSplin.LOG.txt", level=logging.INFO, echo: bool = True):
    """Tee the pipeline's logging to ``path`` for the duration of the context."""
    handler = logging.FileHandler(path, mode="w")
    handler.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
    log.addHandler(handler)
    prev_level = log.level
    log.setLevel(level)
    stream = None
    if echo and not any(isinstance(h, logging.StreamHandler) for h in log.handlers):
        stream = logging.StreamHandler()
        log.addHandler(stream)
    try:
        yield log
    finally:
        log.removeHandler(handler)
        handler.close()
        if stream is not None:
            log.removeHandler(stream)
        log.setLevel(prev_level)


def banner(title: str):
    bar = "#" * 91
    log.info(bar)
    log.info("### %s", title)
    log.info(bar)
