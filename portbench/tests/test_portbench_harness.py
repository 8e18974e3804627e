"""The benchmark's harness on the CPU, at tiny sizes: cells, configurations,
traffic and metric readers found by name from their files alone, the result
line, the roofline counts, the trace reduction, the plain reference against
the port, the control and the planted faults coming out not correct.

    python -m pytest portbench/tests -q

The test marked ``gpu`` runs the control at the cell's own size on a card
and skips without one.  The Nystrom route has no cell (its float32 fit
lies further from the float64 reference than the control does); its
reference is held to the port in float64 here.
"""
import io
import json
import math
import os
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHECKOUT = os.path.dirname(PB)
sys.path.insert(0, CHECKOUT)

from portbench import devtrace, harness  # noqa: E402
from portbench.entries import tps_surface  # noqa: E402
from portbench.roofline import k1, peaks  # noqa: E402
from portbench.tools import faults  # noqa: E402

torch.set_num_threads(2)
CELL = "national_tps19_exact"
TINY = "tiny_tps"


@pytest.fixture
def tiny(tmp_path):
    """A copy of the benchmark's data files with a tiny TPS cell added as
    files of its own (600 stations x 3 responses, a 40 x 50 grid, the exact
    fit, with the national cell's limits), and the BENCHMARK.json that
    lists it."""
    root = tmp_path / "pb"
    for kind in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(os.path.join(PB, kind), root / kind)
    cfg = harness.load_json("configs", "national_10k")
    cfg.update(name="tiny_10k", stations=600, responses=3)
    cfg["grid"].update(nrows=40, ncols=50)
    (root / "configs" / "tiny_10k.json").write_text(json.dumps(cfg))
    tr = harness.load_json("traffic", "fresh_networks_exact")
    tr.update(name="tiny_pool", pool=24, fit_args={"method": "exact"})
    (root / "traffic" / "tiny_pool.json").write_text(json.dumps(tr))
    w = harness.load_json("workloads", CELL)
    w.update(name=TINY, config="tiny_10k", traffic="tiny_pool")
    (root / "workloads" / f"{TINY}.json").write_text(json.dumps(w))
    bench = harness.load_benchmark()
    bench["workloads"].append({"name": TINY, "config": "tiny_10k", "traffic": "tiny_pool", "chips": 1, "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"].append(TINY)
    return str(root), bench


def _run(root, bench, trace=False, entry=None, seed=2**31 + 77, seconds=0.5):
    out, err = io.StringIO(), io.StringIO()
    rc = harness.run_cell(TINY, seed, seconds, trace, t_start=time.perf_counter(), device="cpu", root=root,
                          bench=bench, out=out, err=err, entry=entry)
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_every_listed_cell_config_and_metric_has_its_files():
    bench = harness.load_benchmark()
    for c in bench["configs"]:
        assert os.path.isfile(os.path.join(CHECKOUT, c["file"]))
        assert harness.load_json("configs", c["name"])["name"] == c["name"]
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"], bench=bench)
        assert cell.config["name"] == w["config"] and cell.traffic["name"] == w["traffic"]
        assert hasattr(harness.entry_module(cell.workload["entry"]), "judge")
        assert "call_s" in cell.end_to_end and "setup_s" in cell.end_to_end
        assert cell.per_layer
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))


def test_a_new_cell_and_metric_are_found_from_new_files_alone(tiny):
    root, bench = tiny
    with open(os.path.join(root, "metrics", "calls_done.py"), "w") as f:
        f.write('"""Completed calls of the window."""\n\n\ndef read(rec):\n    return float(len(rec.calls))\n')
    bench["end_to_end"].append({"name": "calls_done", "unit": "calls", "better": "higher", "bound": 0.25,
                                "source": "host_clock", "workloads": [TINY]})
    cell = harness.load_cell(TINY, root, bench)
    assert cell.config["stations"] == 600 and "calls_done" in cell.end_to_end
    rc, line, _ = _run(root, bench)
    assert rc == 0 and line["metrics"]["calls_done"]["value"] == line["attempted"]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_and_checks(tiny, trace):
    root, bench = tiny
    rc, line, err = _run(root, bench, trace=trace)
    assert rc == 0
    want = ["correct", "attempted", "failed", "metrics", "device"] + (["breakdown"] if trace else []) + ["checks"]
    assert list(line) == want
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    cell = harness.load_cell(TINY, root, bench)
    names = cell.per_layer if trace else cell.end_to_end
    # a CPU run has no device trace: the readers of device metrics give nothing
    assert set(line["metrics"]) <= set(names)
    if not trace:
        assert set(line["metrics"]) == {"call_s", "setup_s"}
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])
    for name, c in line["checks"].items():
        assert c["value"] <= c["limit"], name


def test_no_result_without_a_card(tiny):
    root, bench = tiny
    out, err = io.StringIO(), io.StringIO()
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    rc = harness.run_cell(TINY, 1, 0.5, False, t_start=time.perf_counter(), root=root, bench=bench, out=out, err=err)
    assert rc != 0 and out.getvalue() == ""


def test_a_run_makes_no_more_calls_than_the_pool_holds(tiny):
    root, bench = tiny
    tr = harness.load_json("traffic", "tiny_pool", root)
    tr["pool"] = 3
    with open(os.path.join(root, "traffic", "tiny_pool.json"), "w") as f:
        json.dump(tr, f)
    rc, line, _ = _run(root, bench, seconds=600)
    assert rc == 0 and line["attempted"] == 3 and line["correct"] is True


def test_a_cell_must_give_every_number_of_its_route_a_limit(tiny):
    root, bench = tiny
    w = harness.load_json("workloads", TINY, root)
    del w["limits"]["fit_gap"]
    with open(os.path.join(root, "workloads", f"{TINY}.json"), "w") as f:
        json.dump(w, f)
    with pytest.raises(ValueError, match="fit_gap"):
        _run(root, bench)


def test_run_py_needs_the_port_and_a_card(tmp_path):
    """In a directory holding only BENCHMARK.json and the benchmark's files,
    run.py exits non-zero and prints no result."""
    shutil.copy(os.path.join(CHECKOUT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PB, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "portbench/run.py", "--workload", CELL, "--seed", "3", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_k1_work_counts_by_hand():
    # 10 cells x 4 knots: (8 + 2 x 2) operations a pair; bytes: 2 x 10 surface
    # values, 2 x 4 knot coordinates, 2 x 4 coefficients, 2 x 3 polynomial terms
    assert k1.work(10, 4, 2) == (480, 4 * (20 + 8 + 8 + 6))
    t, by = k1.bound(10**7, 2048, 19)
    assert by == "operations" and t == pytest.approx(10**7 * 2048 * 46 / peaks.PEAKS["float32_ops"])
    assert peaks.bound_s(0, 3.35e12) == (1.0, "bytes")


class _Ev:
    def __init__(self, name, start, end, dev):
        self._n, self._a, self._b, self._d = name, start, end, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def device_type(self):
        return "DeviceType.CUDA" if self._d else "DeviceType.CPU"


def test_trace_reduction_by_hand():
    evs = [
        _Ev("pb:window", 0, 1000, False), _Ev("pb:window", 0, 1000, True),
        _Ev("pb:fit", 0, 600, False), _Ev("pb:surface", 600, 1000, False),
        _Ev("aten::linalg_eigh", 100, 500, False),
        _Ev("void (anonymous namespace)::tps_grid_kernel<8>(float const*, int)", 700, 900, True),
        _Ev("void (anonymous namespace)::tps_grid_kernel<8>(float const*, int)", 850, 950, True),
        _Ev("Memcpy HtoD (Pinned -> Device)", 50, 100, True),
    ]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(kineto_results=types.SimpleNamespace(events=lambda: evs)))
    s = devtrace.reduce(prof)
    assert s.window_s == pytest.approx(1e-6) and s.busy_s == pytest.approx(300e-9)
    assert s.device_ops == {"tps_grid_kernel<8>": pytest.approx(300e-9), "Memcpy HtoD": pytest.approx(50e-9)}
    assert s.op_seconds("tps_grid_kernel") == pytest.approx(300e-9)
    # gaps: [0, 50) in fit, [100, 700) in fit / eigh at its middle, [950, 1000) in surface
    assert s.idle_gaps == {"fit / python": pytest.approx(50e-9), "fit / aten::linalg_eigh": pytest.approx(600e-9),
                           "surface / python": pytest.approx(50e-9)}


def _small_state(route, n=1500, r=3, m=128, side=30, seed=5):
    cfg = harness.load_json("configs", "national_10k")
    cfg.update(stations=n, responses=r)
    cfg["grid"].update(nrows=side, ncols=side)
    cfg["fit"].update(landmarks=m)
    tr = harness.load_json("traffic", "fresh_networks_exact")
    tr.update(pool=4, warmup_calls=0, fit_args={"method": route, "landmarks": m} if route == "nystrom" else {"method": route})
    limits = (harness.load_json("workloads", CELL)["limits"] if route == "exact"
              else dict.fromkeys(tps_surface.NUMBERS[route], math.inf))   # gaps() alone: no limit read
    cell = types.SimpleNamespace(config=cfg, traffic=tr, workload={"limits": limits})
    return tps_surface.prepare(cell, seed, torch.device("cpu"))


@pytest.mark.parametrize("route", ["exact", "nystrom"])
def test_reference_is_the_port_in_float64(route):
    """The plain reference and the port's fit and surface, both in float64,
    on the same inputs and landmark seed."""
    st = _small_state(route, n=1500 if route == "nystrom" else 600)
    from machisplin_tpu_torch.ops import tps as port_tps

    for i in range(2):
        model = port_tps.tps_fit_auto(st.coords[i].double(), st.ys[i].double(),
                                      generator=torch.Generator().manual_seed(st.seeds[i]), **st.fit_kw)
        rows = port_tps.tps_predict_grid(model, st.grid)[torch.as_tensor(st.rows_idx)]
        out = {"lam": model.lam, "fitted": model.fitted, "rows": rows, "z": model.knots, "c": model.c,
               "d": model.d, "shift": model.shift, "scale": model.scale}
        g = tps_surface.gaps(st, i, out)
        assert g["fit_gap"] < 1e-8 and g["surface_gap"] < 1e-8 and g["gcv_excess"] < 1e-10, g
        assert g["k1_gap"] < 1e-10 and g["fitted_eval_gap"] < 1e-10 and g["knots_gap"] == 0, g
        assert g.get("knots_sse_excess", 0.0) < 1e-10 and g.get("knots_pos_gap", 0.0) < 1e-12, g


def test_control_is_not_correct():
    """The reference one precision step below the configuration's, in the
    port's place, reads above the cell's limits at a size a test holds."""
    st = _small_state("exact", n=800, r=4, side=40)
    per_call = [tps_surface.gaps(st, i, tps_surface.control_outputs(st, i)) for i in range(3)]
    run = {k: max(g[k] for g in per_call) for k in per_call[0]}
    failed = [k for k, lim in st.limits.items() if run[k] > lim]
    assert failed, run


@pytest.mark.parametrize("fault", faults.FAULTS)
def test_faults_come_out_not_correct(tiny, fault):
    root, bench = tiny
    rc, line, _ = _run(root, bench, entry=faults.entry_with(fault))
    assert rc == 0 and line["correct"] is False, line["checks"]


@pytest.mark.gpu
def test_control_at_the_cells_size_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(CELL)
    st = tps_surface.prepare(cell, 2**31 + 11, torch.device("cuda"))
    per_call = [tps_surface.gaps(st, i, tps_surface.control_outputs(st, i)) for i in range(3)]
    run = {k: max(g[k] for g in per_call) for k in per_call[0]}
    assert [k for k, lim in st.limits.items() if run[k] > lim], run
