"""Peak device memory over set-up and window, in GB (1e9 bytes), as the
caching allocator counts it (``torch.cuda.max_memory_allocated``): what the
program holds plus the inputs handed to it."""

UNIT = "GB"


def read(run):
    return run.memory_peak_bytes / 1e9 if run.memory_peak_bytes else None
