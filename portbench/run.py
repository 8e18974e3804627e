"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload national_tps19_exact --seed 7 --seconds 51 --trace 0

from the root of a checkout.  The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared beside its limit); the same checks are the last lines of standard
error.  Exits non-zero, with no result, without enough CUDA devices for
the cell, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

# the port builds its kernels with nvcc into build/<hash>/ inside the
# checkout, so only a checkout's first run builds
CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, CHECKOUT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    torch.set_num_threads(4)
    from portbench.harness import run_cell

    print(f"set-up: interpreter to torch imported {time.perf_counter() - T_START:.3f} s", file=sys.stderr)

    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start=T_START)


if __name__ == "__main__":
    sys.exit(main())
