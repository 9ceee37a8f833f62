"""peak_mem_gib (GiB, end to end): the most device memory the program's
tensors held during the window (``torch.cuda.max_memory_allocated`` after
a reset at the window's start). Every model the engine keeps resident
shares one weight budget, so activation memory is a cost users feel."""


def read(run):
    if run.trace is not None or not run.window_peak_bytes:
        return None
    return run.window_peak_bytes / 2 ** 30
