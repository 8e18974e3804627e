"""Finds a cell's files by name, runs its window and prints the result line.

``run_cell`` is the whole of a run; ``run.py`` only parses the command line.
A cell's entry (``entries/<entry>.py``) supplies four functions:

* ``prepare(cell, seed, device) -> state``: make the inputs from the seed
  and warm up every shape the calls use (set-up);
* ``call(state, i, span)``: the i-th call of the window, ending in a
  synchronise; ``span(name)`` opens a timed benchmark span;
* ``release(state)``: free the port's state once the window has closed;
* ``judge(state) -> [(name, value, limit), ...]``: the comparison with the
  plain reference; a value above its limit, or not finite, is not correct.

The entry may add counters to ``state.counters``; metric readers read them.
Where its inputs run out after some number of calls, ``state.capacity``
says how many; the window makes no more.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import math
import os
import sys
import time
import traceback
from dataclasses import dataclass, field

PB_ROOT = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(PB_ROOT)
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "machisplin_tpu"})


def load_json(kind: str, name: str, root: str = PB_ROOT) -> dict:
    """``<root>/<kind>/<name>.json``."""
    with open(os.path.join(root, kind, name + ".json")) as f:
        return json.load(f)


def load_benchmark(checkout: str = CHECKOUT) -> dict:
    with open(os.path.join(checkout, "BENCHMARK.json")) as f:
        return json.load(f)


def metric_reader(name: str, root: str = PB_ROOT):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_module(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


@dataclass
class Cell:
    """A cell as its files give it."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    chips: int = 1
    end_to_end: list = field(default_factory=list)   # metric names, --trace 0
    per_layer: list = field(default_factory=list)    # metric names, --trace 1


def _reported(metrics: list, cell: str) -> list:
    return [m["name"] for m in metrics if "workloads" not in m or cell in m["workloads"]]


def load_cell(name: str, root: str = PB_ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name``: ``workloads/<name>.json``, its configuration and
    traffic files, and the metrics ``BENCHMARK.json`` has it report."""
    w = load_json("workloads", name, root)
    bench = load_benchmark() if bench is None else bench
    listed = {c["name"]: c for c in bench["workloads"]}
    if name not in listed:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    entry = listed[name]
    if (entry["config"], entry["traffic"]) != (w["config"], w["traffic"]):
        raise ValueError(f"workloads/{name}.json and BENCHMARK.json disagree on its config or traffic")
    return Cell(name=name, workload=w, config=load_json("configs", w["config"], root),
                traffic=load_json("traffic", w["traffic"], root), chips=int(entry["chips"]),
                end_to_end=_reported(bench["end_to_end"], name), per_layer=_reported(bench["per_layer"], name))


@dataclass
class Record:
    """What a run measured; the metric readers read it."""

    setup_s: float = 0.0
    calls: list = field(default_factory=list)        # seconds of each completed call of the window
    spans: dict = field(default_factory=dict)        # span name -> [seconds, ...]
    counters: dict = field(default_factory=dict)
    window_peak_mem_bytes: int = 0
    trace: object = None                              # devtrace.TraceSummary of a traced run


class Spans:
    """Named host-clock spans, each closed by a device synchronise; in a
    traced run each is also a ``pb:<name>`` range of the profiler."""

    def __init__(self, record: Record, traced: bool, sync):
        self.record, self.traced, self.sync = record, traced, sync

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = contextlib.nullcontext()
        if self.traced:
            from torch.profiler import record_function

            rf = record_function("pb:" + name)
        with rf:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.sync()
                self.record.spans.setdefault(name, []).append(time.perf_counter() - t0)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _device_info(torch, device, chips: int, peak: int) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": peak}
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": chips,
            "memory_peak_bytes": peak}
    with contextlib.suppress(OSError, ValueError, IndexError):
        import subprocess

        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
        info["power_limit"] = out.strip().splitlines()[device.index or 0]
    return info


def _metric_values(names: list, rec: Record, units: dict, root: str) -> dict:
    out = {}
    for name in names:
        v = metric_reader(name, root)(rec)
        if v is not None:
            out[name] = {"value": v, "unit": units[name]}
    return out


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, t_start: float, device: str = "cuda",
             root: str = PB_ROOT, bench: dict | None = None, out=None, err=None, entry=None) -> int:
    """Run cell ``name`` and print its result line; returns the exit code.

    ``device="cpu"`` skips the look for a chip (tests drive the rest of a
    run that way); ``entry`` replaces the cell's entry module."""
    out, err = out or sys.stdout, err or sys.stderr
    bench = load_benchmark() if bench is None else bench
    cell = load_cell(name, root, bench)
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            print(f"portbench: {name} needs {cell.chips} CUDA device(s); "
                  f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=err)
            return 3
        sync = torch.cuda.synchronize
    else:
        sync = lambda: None
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    entry = entry or entry_module(cell.workload["entry"])
    rec = Record()
    state = entry.prepare(cell, seed, dev)
    state.counters = rec.counters
    span = Spans(rec, trace, sync)
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
        window_range = record_function("pb:window")
        window_range.__enter__()
    setup_peak = 0
    if dev.type == "cuda":
        sync()
        setup_peak = int(torch.cuda.max_memory_allocated(dev))
        torch.cuda.reset_peak_memory_stats(dev)
    attempted = failed = 0
    cap = getattr(state, "capacity", None) or (1 << 30)
    t0 = time.perf_counter()
    rec.setup_s = t0 - t_start
    t_prev = t0
    # a call starts only where the mean so far says it ends inside the
    # window; the first always starts.  Calls are timed end to end, so what
    # the host does between two calls lands inside the later one.
    while attempted < cap and not (attempted and (t_prev - t0) * (1 + 1 / attempted) > seconds):
        attempted += 1
        try:
            entry.call(state, attempted - 1, span)
            sync()
            ok = True
        except Exception:                       # a call that raises counts as failed; the run goes on
            failed += 1
            ok = False
            traceback.print_exc(file=err)
        t = time.perf_counter()
        if ok:
            rec.calls.append(t - t_prev)
        t_prev = t
    if trace:
        window_range.__exit__(None, None, None)
        t_stop = time.perf_counter()
        prof.stop()
        t_stop = time.perf_counter() - t_stop
    if dev.type == "cuda":
        rec.window_peak_mem_bytes = int(torch.cuda.max_memory_allocated(dev))
    device_info = _device_info(torch, dev, cell.chips, max(setup_peak, rec.window_peak_mem_bytes))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the window loaded {', '.join(bad)}", file=err)
        return 4
    if trace:
        from . import devtrace

        t_reduce = time.perf_counter()
        rec.trace = devtrace.reduce(prof)
        print(f"trace: the profiler stopped in {t_stop:.1f} s, reduced in {time.perf_counter() - t_reduce:.1f} s",
              file=err)
        del prof
        device_info["busy_s"] = rec.trace.busy_s
        device_info["window_s"] = rec.trace.window_s
    metrics = _metric_values(cell.per_layer if trace else cell.end_to_end, rec, units, root)
    entry.release(state)
    checks = entry.judge(state)
    correct = failed == 0 and len(rec.calls) > 0 and all(
        math.isfinite(v) and v <= lim for _, v, lim in checks)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=err)
        return 4
    result = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
              "device": device_info}
    if trace:
        result["breakdown"] = {"device_ops": rec.trace.top("device_ops"), "idle_gaps": rec.trace.top("idle_gaps")}
    # a number that is not finite is printed as null: JSON has no infinity
    result["checks"] = {n: {"value": v if math.isfinite(v) else None, "limit": lim} for n, v, lim in checks}
    slow = sorted(range(len(rec.calls)), key=lambda k: -rec.calls[k])[:3]
    print("slowest calls: " + ", ".join(f"#{k} {rec.calls[k]:.4f} s" for k in slow), file=err)
    for name, times in [("calls", rec.calls)] + sorted(rec.spans.items()):
        print(f"{name} (s): " + " ".join(f"{t:.4f}" for t in times), file=err)
    print("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in getattr(state, "setup_parts", {}).items()), file=err)
    for n, v, lim in checks:
        print(f"check {n} {v!r} limit {lim!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
