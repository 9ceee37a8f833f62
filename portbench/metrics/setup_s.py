"""setup_s (s, end to end): from the start of the process to the first
timed request: imports, loading (and, in a fresh checkout, building) the
cell's CUDA sources, the weights, the inputs and one warm-up request per
size of the mix."""


def read(run):
    return run.setup_s if run.trace is None else None
