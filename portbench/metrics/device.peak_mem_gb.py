"""The card's peak allocated memory over the window, in GB
(``torch.cuda.max_memory_allocated`` after a reset at the window's start)."""


def read(rec):
    return rec.window_peak_mem_bytes / 1e9 if rec.window_peak_mem_bytes else None
