"""A traced run of a cell with the port's spans reduced beside its metrics.

    python3 portbench/tools/span_split.py --workload national_tps19_exact --seed 7 --seconds 51 \\
        --out chiprun_out/span_split.json

Runs the cell as ``run.py --trace 1`` does and prints the same result
line; the same trace is also reduced by ``progspans.reduce``, and ``--out``
gets, per call of the window: each program span's and benchmark span's
``completed_s``, ``device_s``, ``idle_s``, launches and host syncs; the
share of the window's device seconds whose launch the trace lacks; the
longest idle gaps by benchmark span, program span and host operation; and
the seconds the extra reduction took.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)


def report(split, calls: int, top: int = 15) -> dict:
    """The split of ``progspans.reduce`` per call of a window of ``calls``."""
    return {
        "calls": calls,
        "program": {n: {"count": s.count, **s.per(calls)} for n, s in sorted(split.program.items())},
        "bench": {n: {"count": s.count, **s.per(calls)} for n, s in sorted(split.bench.items())},
        "device_s": split.device_s / calls,
        "unattributed_share": split.unattributed_s / split.device_s if split.device_s else None,
        "idle_gaps": [[k, v / calls] for k, v in sorted(split.idle_gaps.items(), key=lambda kv: -kv[1])[:top]],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out", required=True)
    a = p.parse_args(argv)
    import torch

    torch.set_num_threads(4)
    from portbench import devtrace, harness, progspans

    found = {}
    reduce = devtrace.reduce

    def reduce_both(prof):
        t0 = time.perf_counter()
        found["split"] = progspans.reduce(prof)
        found["reduce_s"] = time.perf_counter() - t0
        return reduce(prof)

    # the harness reduces the trace and drops it; the split rides on that call
    devtrace.reduce = reduce_both
    try:
        rc = harness.run_cell(a.workload, a.seed, a.seconds, True, t_start=T_START)
    finally:
        devtrace.reduce = reduce
    if rc != 0 or "split" not in found:
        return rc or 1
    split = found["split"]
    calls = max((s.count for s in split.bench.values()), default=1)   # each call opens each benchmark span once
    out = {"workload": a.workload, "seed": a.seed, "reduce_s": found["reduce_s"], **report(split, calls)}
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    with open(a.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"span split: {a.out} ({calls} calls, reduced in {found['reduce_s']:.1f} s)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
