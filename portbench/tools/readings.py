"""The readings a TPS surface cell's limits are set from, in one process:

* the port's: for each seed, ``--calls`` calls of the cell at its own size
  (each on its own network and landmark seed, as in a run), every compared
  number of every call;
* the control's: the reference one precision step below the
  configuration's in the port's place, on the control seeds' calls;
* each planted fault's (``tools/faults.py``), on the fault seeds' calls.

    python3 portbench/tools/readings.py --workload national_tps19_exact \\
        --seeds 101,102,... --control-seeds 201,202,203 --fault-seeds 301,302,303 \\
        --out chiprun_out/readings.json

Prints, for each number, the largest reading of the port (the lower
reading), the smallest of the control and of each fault (upper readings),
and writes every reading to ``--out``.
"""
import argparse
import contextlib
import json
import os
import sys
import time

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, CHECKOUT)


def _seeds(s: str) -> list:
    return [int(v) for v in s.split(",") if v]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--calls", type=int, default=0, help="calls a seed (default: the traffic's sampled_calls)")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default="")
    a = p.parse_args(argv)
    import torch

    torch.set_num_threads(4)
    from portbench import harness
    from portbench.entries import tps_surface as entry
    from portbench.tools import faults

    cell = harness.load_cell(a.workload)
    dev = torch.device(a.device)
    calls = a.calls or int(cell.traffic["check"]["sampled_calls"])
    nospan = contextlib.nullcontext
    rows = []

    def program_run(seed, ent, kind):
        st = ent.prepare(cell, seed, dev)
        for i in range(calls):
            ent.call(st, i, nospan)
        ent.release(st)
        for _, (i, out) in sorted(st.kept.items()):
            rows.append({"kind": kind, "seed": seed, "call": i, **entry.gaps(st, i, out)})

    t0 = time.perf_counter()
    for seed in _seeds(a.seeds):
        program_run(seed, entry, "port")
    for seed in _seeds(a.control_seeds):
        st = entry.prepare(cell, seed, dev)
        for i in range(calls):
            rows.append({"kind": "control", "seed": seed, "call": i, **entry.gaps(st, i, entry.control_outputs(st, i))})
    for fault in faults.FAULTS:
        for seed in _seeds(a.fault_seeds):
            program_run(seed, faults.entry_with(fault), "fault:" + fault)
    if a.out:                               # the rows first, whatever the summary does
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump({"workload": a.workload, "rows": rows}, f)
    names = [k for k in rows[0] if k not in ("kind", "seed", "call")] if rows else []
    # a run reads its worst call, as the entry's judge does; the port's lower
    # reading is its worst run, the control's and each fault's upper reading
    # its best run
    summary = {}
    for kind in dict.fromkeys(r["kind"] for r in rows):
        sel = [r for r in rows if r["kind"] == kind]
        runs = {s: {n: max(r[n] for r in sel if r["seed"] == s) for n in names}
                for s in dict.fromkeys(r["seed"] for r in sel)}
        pick = max if kind == "port" else min
        summary[kind] = {n: pick(w[n] for w in runs.values()) for n in names}
        summary[kind]["runs"] = len(runs)
        summary[kind]["calls"] = len(sel)
    result = {"workload": a.workload, "seconds": time.perf_counter() - t0, "summary": summary, "rows": rows}
    if dev.type == "cuda":
        result["device"] = torch.cuda.get_device_name(dev)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"seconds": result["seconds"], "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
