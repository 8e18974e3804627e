"""The reduction of the port's spans (``progspans.py``) on a hand-built trace,
``devtrace.reduce`` unmoved by program spans on the same trace, and on a
card, a traced exact fit joined to its launches.

    python -m pytest portbench/tests/test_portbench_spans.py -q
"""
import os
import sys
import types

import pytest
import torch

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(PB))

from portbench import devtrace, progspans  # noqa: E402
from portbench.tools import span_split  # noqa: E402


class _Ev:
    def __init__(self, name, start, end, dev=False, corr=0):
        self._n, self._a, self._b, self._d, self._c = name, start, end, dev, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"

    def correlation_id(self):
        return self._c


def _rt(name, a, b, corr):
    return _Ev(name, a, b, corr=corr)


def _prof(evs):
    results = types.SimpleNamespace(events=lambda: evs)
    return types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=results))


# one call: the benchmark's fit and surface spans, the program's steps inside
PROGRAM = [
    _Ev("port:tps.fit", 10, 1172), _Ev("port:tps.factor", 20, 600), _Ev("port:tps.eigh", 100, 500),
    _Ev("port:tps.solve", 600, 1170), _Ev("port:tps.gcv_search", 610, 1000), _Ev("port:tps.surface", 1210, 1990),
]
OTHERS = [
    _Ev("pb:window", 0, 2000), _Ev("pb:fit", 0, 1200), _Ev("pb:surface", 1200, 2000),
    _Ev("pb:fit", 130, 1199, dev=True),                         # the profiler's mirror of a benchmark span
    # a host operation's correlation id is no launch's, though the numbers meet
    _Ev("aten::linalg_eigh", 110, 490, corr=99), _Ev("aten::copy_", 510, 530), _Ev("aten::mul", 620, 700),
    _rt("cudaLaunchKernel", 120, 125, 1), _Ev("eigh_kernel", 130, 400, dev=True, corr=1),
    _rt("cudaStreamSynchronize", 410, 480, 2),
    _rt("cudaLaunchKernel", 630, 635, 4), _Ev("mul_kernel", 640, 660, dev=True, corr=4),
    _rt("cudaLaunchKernel", 800, 805, 5), _Ev("sum_kernel", 850, 870, dev=True, corr=5),
    _rt("cudaLaunchKernel", 990, 995, 8), _Ev("div_kernel", 995, 1050, dev=True, corr=8),   # ends after its span
    _rt("cudaMemcpy", 1100, 1110, 9), _Ev("Memcpy DtoH (Device -> Pageable)", 1101, 1109, dev=True, corr=9),
    _Ev("lost_kernel", 1120, 1150, dev=True, corr=99),          # its launch is not in the trace
    _rt("cudaLaunchKernel", 1195, 1197, 6), _Ev("tail_kernel", 1198, 1199, dev=True, corr=6),
    _rt("cudaLaunchKernel", 1220, 1225, 7),
    _Ev("void tps_grid_kernel<8>(float const*, int)", 1300, 1900, dev=True, corr=7),
]


def test_program_spans_by_hand():
    s = progspans.reduce(_prof(OTHERS + PROGRAM))
    ns = 1e-9
    want = {  # completed, device, idle (ns), launches, host syncs
        "tps.fit": (1162, 373, 747, 4, 2),
        "tps.factor": (580, 270, 370, 1, 1),
        "tps.eigh": (400, 270, 0, 1, 1),
        "tps.solve": (570, 103, 377, 3, 1),
        "tps.gcv_search": (440, 95, 315, 3, 0),       # completed at its last kernel's end, after its host end
        "tps.surface": (780, 600, 201, 1, 0),
    }
    assert set(s.program) == set(want)
    for name, (done, dev, idle, launches, syncs) in want.items():
        st = s.program[name]
        assert st.count == 1, name
        assert (st.completed_s, st.device_s, st.idle_s) == pytest.approx((done * ns, dev * ns, idle * ns)), name
        assert (st.launches, st.host_syncs) == (launches, syncs), name
        assert st.program_device_s == pytest.approx(st.device_s) and st.program_idle_s == pytest.approx(st.idle_s)
    fit = s.bench["fit"]
    assert (fit.completed_s, fit.device_s, fit.idle_s) == pytest.approx((1200 * ns, 374 * ns, 795 * ns))
    assert (fit.program_device_s, fit.program_idle_s) == pytest.approx((373 * ns, 747 * ns))
    assert (fit.launches, fit.host_syncs) == (5, 2)
    assert s.device_s == pytest.approx(1004 * ns) and s.unattributed_s == pytest.approx(30 * ns)
    assert s.idle_gaps == pytest.approx({
        "fit / tps.factor / python": 130 * ns, "fit / tps.factor / aten::copy_": 240 * ns,
        "fit / tps.gcv_search / python": 315 * ns, "fit / tps.solve / python": 62 * ns,
        "fit / python": 48 * ns,                                    # under no program span: devtrace's name
        "surface / tps.surface / python": 201 * ns,
    })


def test_devtrace_unmoved_by_program_spans():
    """The same events with and without the program's ranges reduce to the
    same window, busy time and device operations; the gaps' seconds agree."""
    plain, spanned = devtrace.reduce(_prof(OTHERS)), devtrace.reduce(_prof(OTHERS + PROGRAM))
    assert (spanned.window_s, spanned.busy_s, spanned.device_ops) == (plain.window_s, plain.busy_s, plain.device_ops)
    assert sum(spanned.idle_gaps.values()) == pytest.approx(sum(plain.idle_gaps.values()))
    split = progspans.reduce(_prof(OTHERS + PROGRAM))
    assert sum(split.idle_gaps.values()) == pytest.approx(plain.window_s - plain.busy_s)
    assert split.device_s == pytest.approx(sum(plain.device_ops.values()))


def test_two_calls_and_the_report():
    shifted = [_Ev(e._n, e._a + 2000, e._b + 2000, e._d, e._c + 100 if e._c else 0) for e in OTHERS + PROGRAM
               if e._n != "pb:window"]
    s = progspans.reduce(_prof([_Ev("pb:window", 0, 4000)] + [e for e in OTHERS + PROGRAM if e._n != "pb:window"]
                               + shifted))
    assert s.program["tps.fit"].count == 2 and s.program["tps.fit"].launches == 8
    r = span_split.report(s, 2)
    assert r["program"]["tps.eigh"]["completed_s"] == pytest.approx(400e-9)
    assert r["program"]["tps.fit"]["host_syncs"] == 2 and r["program"]["tps.fit"]["count"] == 2
    assert r["unattributed_share"] == pytest.approx(60 / 2008)
    assert r["idle_gaps"][0] == ["fit / tps.gcv_search / python", pytest.approx(315e-9)]


def test_no_window_raises():
    with pytest.raises(RuntimeError, match="pb:window"):
        progspans.reduce(_prof(PROGRAM))


@pytest.mark.gpu
def test_a_traced_fit_on_the_card():
    """On a card: the program's ranges stay off the device's timeline, every
    kernel of the fit is joined to its launch, and the fit's steps launch
    kernels and wait on the card (cuSOLVER's info checks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from torch.profiler import ProfilerActivity, profile, record_function

    from machisplin_tpu_torch.ops import tps

    g = torch.Generator(device="cuda").manual_seed(0)
    coords = torch.rand((600, 2), device="cuda", generator=g)
    ys = torch.sin(6 * coords[:, :1]) + 0.1 * torch.randn((600, 3), device="cuda", generator=g)
    tps.tps_fit_auto(coords, ys, method="exact")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function("pb:window"):
            with record_function("pb:fit"):
                tps.tps_fit_auto(coords, ys, method="exact")
                torch.cuda.synchronize()
    summary = devtrace.reduce(prof)
    assert not [n for n in summary.device_ops if n.startswith("port:")]
    s = progspans.reduce(prof)
    assert s.unattributed_s == 0.0 and s.device_s > 0
    fit = s.program["tps.fit"]
    assert fit.device_s == pytest.approx(s.bench["fit"].device_s)
    assert fit.launches > 0 and fit.host_syncs > 0 and s.program["tps.eigh"].device_s > 0
