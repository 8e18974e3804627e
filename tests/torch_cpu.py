"""Torch's CPU threads for the port's tests.

The suite runs in several pytest-xdist workers on one machine, and each
worker's torch would otherwise use one thread a core: the workers then
oversubscribe the cores, and the port's small tensors pay for the threads'
hand-offs (``test_torch_mesh.py::test_rf_group_grows_the_same_forests``'s
four CV runs: 19 s on 8 threads, 2.3 s on 2, alone on an 8-core CPU).

A test module that imports ``torch_threads`` runs its tests, its module
fixtures included, on THREADS threads, and the thread count is restored
after the module.  A module whose tolerances rest on a BLAS summation
order does not import it (``test_torch_nystrom.py``: its float64 Nystrom
fit moves 1.5e-8 of the range between 8 and 2 threads, against a 1e-8
tolerance).
"""
import pytest
import torch

THREADS = 2


@pytest.fixture(scope="module", autouse=True)
def torch_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield THREADS
    torch.set_num_threads(before)
