"""peak_mem_gb: ``torch.cuda.max_memory_allocated()`` over the window
(reset at its start), in GB (1e9 bytes)."""


def read(rec):
    return rec.window_peak / 1e9 if rec.window_peak else None
