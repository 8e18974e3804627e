"""Scripts that set and check the benchmark's limits; no run reads them."""
