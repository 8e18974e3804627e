"""``utils.timing.trace``: the port's counterpart of the JAX package's
``trace(log_dir)`` over ``torch.profiler``; a Chrome trace is written into
``log_dir``, and ``None`` writes nothing."""
import json
import os

import torch

from machisplin_tpu.utils import timing as jtiming
from machisplin_tpu_torch import utils
from machisplin_tpu_torch.utils import timing
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)


def test_trace_is_exported_beside_the_jax_name():
    assert "trace" in jtiming.__all__ and "trace" in timing.__all__
    assert utils.trace is timing.trace


def test_trace_writes_a_chrome_trace(tmp_path):
    d = tmp_path / "trace"
    with timing.trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.load(open(d / files[0]))["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_none_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with timing.trace(None):
        torch.ones(3).sum()
    assert os.listdir(tmp_path) == []
