"""The benchmark of the PyTorch and CUDA port (``machisplin_tpu_torch``).

``portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell: it makes the cell's inputs from the seed, warms up, calls the
port's entry back to back for ``--seconds``, judges what the calls produced
against a plain reference, and prints one JSON line.

Everything here is found by name from files of its own:

* ``configs/<config>.json``  a deployment: its source, sizes and draws;
* ``traffic/<traffic>.json`` a traffic mix: how calls come and what is new in each;
* ``workloads/<cell>.json``  a cell: its configuration, traffic, entry, limits and why;
* ``entries/<entry>.py``     how a cell's calls drive the port and are judged;
* ``metrics/<metric>.py``    one reader a metric, ``read(record) -> float | None``;
* ``reference/``             plain PyTorch references, importing nothing of the port;
* ``roofline/``              the table of peaks and the kernels' work counts.

``BENCHMARK.json`` at the root of the checkout says which metrics a cell
reports.  Nothing here imports JAX or the JAX package.
"""
