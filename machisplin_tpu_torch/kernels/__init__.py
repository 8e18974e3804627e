"""nvcc builds of the hand-written CUDA kernels in ``csrc/`` (see build.py)."""
