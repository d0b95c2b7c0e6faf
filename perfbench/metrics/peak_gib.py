"""The device allocator's peak over warm-up and window, in GiB
(``torch.cuda.max_memory_allocated``, reset after the inputs were made)."""


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
