"""The port's spans (``utils.timing.span``): a shared no-op with no profiler
running; under a CPU ``torch.profiler`` the ``port:`` ranges of every
``tps_fit_auto`` route and of ``tps_predict_grid``, nested as the program
nests its steps; ``PhaseTimer`` phases and ``trace(log_dir)`` carry them;
the Nystrom fit synchronises only for a caller's timer.
"""
import json
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from machisplin_tpu_torch.grid import GridSpec
from machisplin_tpu_torch.ops import nystrom, tps
from machisplin_tpu_torch.utils import timing
from torch_cpu import torch_threads  # noqa: F401  (autouse: two torch threads)

EXACT = {
    "tps.fit": None,
    "tps.factor": "tps.fit",
    "tps.kernel_matrix": "tps.factor",
    "tps.qr": "tps.factor",
    "tps.eigh": "tps.factor",
    "tps.basis": "tps.factor",
    "tps.solve": "tps.fit",
    "tps.gcv_search": "tps.solve",
    "tps.coef": "tps.solve",
}
SURFACE = {"tps.surface": None, "k1.tables": "tps.surface", "k1.launch": "tps.surface"}
NYSTROM_STEPS = ("landmarks", "stream_stats", "f64_tail", "gcv_coef", "fitted")


def _network(n, r=2, seed=0):
    rng = np.random.default_rng(seed)
    coords = rng.uniform(0, 1, (n, 2)) * np.array([2.0, 1.0]) + np.array([-77.5, -6.5])
    ys = np.stack([np.sin((4 + j) * coords[:, 0]) + 0.1 * rng.standard_normal(n) for j in range(r)], 1)
    return torch.as_tensor(coords), torch.as_tensor(ys)


def _ranges(fn):
    """The ``port:`` ranges recorded while ``fn`` runs under a CPU profiler:
    [(name without the prefix, start ns, end ns)], in start order."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    out = [(e.name()[len(timing.SPAN_PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events() if e.name().startswith(timing.SPAN_PREFIX)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def _parents(ranges):
    """Each range's name -> the name of the innermost range holding it."""
    parents = {}
    for i, (name, a, b) in enumerate(ranges):
        holders = [r for r in ranges[:i] if r[1] <= a and b <= r[2]]
        parents[name] = holders[-1][0] if holders else None
    return parents


def test_span_is_a_shared_no_op_without_a_profiler():
    assert not torch.autograd._profiler_enabled()
    s = timing.span("tps.fit")
    assert s is timing.span("k1.launch")
    with s:
        with timing.span("tps.eigh"):
            torch.ones(3).sum()


def test_exact_route_and_surface_spans_nest():
    coords, ys = _network(60)
    grid = GridSpec(nrows=6, ncols=7, xmin=-77.5, ymax=-5.5, dx=2.0 / 7, dy=1.0 / 6)
    model = {}

    def run():
        model["m"] = tps.tps_fit_auto(coords, ys, method="exact", device="cpu")
        tps.tps_predict_grid(model["m"], grid)

    ranges = _ranges(run)
    names = [r[0] for r in ranges]
    assert sorted(names) == sorted({**EXACT, **SURFACE}), names
    assert _parents(ranges) == {**EXACT, **SURFACE}
    # the steps run in the program's order
    assert names == ["tps.fit", "tps.factor", "tps.kernel_matrix", "tps.qr", "tps.eigh", "tps.basis",
                     "tps.solve", "tps.gcv_search", "tps.coef", "tps.surface", "k1.tables", "k1.launch"]
    # the same fit with spans off
    want = tps.tps_fit_auto(coords, ys, method="exact", device="cpu")
    assert torch.equal(model["m"].c, want.c) and torch.equal(model["m"].lam, want.lam)


def test_fixed_lambda_has_no_gcv_search_span():
    coords, ys = _network(40)
    names = [r[0] for r in _ranges(lambda: tps.tps_fit_auto(coords, ys, lam=1e-3, method="exact", device="cpu"))]
    assert "tps.gcv_search" not in names and "tps.coef" in names


def test_host_route_span():
    coords, ys = _network(50)
    ranges = _ranges(lambda: tps.tps_fit_auto(coords, ys, method="exact", max_device_knots=20, device="cpu"))
    assert _parents(ranges) == {"tps.fit": None, "tps.host_fit": "tps.fit"}


def test_nystrom_route_spans():
    coords, ys = _network(300)
    ranges = _ranges(lambda: tps.tps_fit_auto(coords, ys, method="nystrom", landmarks=24, device="cpu",
                                              generator=torch.Generator().manual_seed(0)))
    want = {"tps.fit": None, **{f"nystrom.{s}": "tps.fit" for s in NYSTROM_STEPS}}
    assert _parents(ranges) == want
    assert [r[0] for r in ranges] == ["tps.fit"] + [f"nystrom.{s}" for s in NYSTROM_STEPS]


def test_phase_timer_phase_is_a_span():
    timer = timing.PhaseTimer()

    def run():
        with timer.phase("cv_all_responses"):
            with timing.span("inner"):
                torch.ones(4).sum()

    assert _parents(_ranges(run)) == {"cv_all_responses": None, "inner": "cv_all_responses"}
    assert list(timer.phases) == ["cv_all_responses"] and timer.phases["cv_all_responses"] > 0


@pytest.fixture
def card_syncs(monkeypatch):
    """Make the CPU look like an initialised card to ``PhaseTimer`` and count
    its ``torch.cuda.synchronize`` calls."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: calls.append(1))
    return calls


def test_nystrom_without_a_timer_never_synchronises(card_syncs):
    coords, ys = _network(300)
    nystrom.nystrom_tps_fit(coords, ys, m=24, generator=torch.Generator().manual_seed(0), device="cpu")
    assert card_syncs == []


def test_nystrom_timer_keeps_its_synchronised_phases(card_syncs):
    coords, ys = _network(300)
    timer = timing.PhaseTimer()
    ranges = _ranges(lambda: nystrom.nystrom_tps_fit(coords, ys, m=24, generator=torch.Generator().manual_seed(0),
                                                     device="cpu", timer=timer))
    assert list(timer.phases) == list(NYSTROM_STEPS) and len(card_syncs) == len(NYSTROM_STEPS)
    # each phase sits inside its step's span
    assert _parents(ranges) == {**{f"nystrom.{s}": None for s in NYSTROM_STEPS},
                                **{s: f"nystrom.{s}" for s in NYSTROM_STEPS}}


def test_trace_writes_the_spans(tmp_path):
    coords, ys = _network(40)
    with timing.trace(str(tmp_path)):
        tps.tps_fit_auto(coords, ys, method="exact", device="cpu")
    (f,) = os.listdir(tmp_path)
    names = {e.get("name") for e in json.load(open(tmp_path / f))["traceEvents"]}
    assert {timing.SPAN_PREFIX + n for n in EXACT} <= names
