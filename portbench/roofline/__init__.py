"""The table of peaks and the kernels' work counts."""
