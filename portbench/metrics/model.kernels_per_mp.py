"""model.kernels_per_mp (1/MP, model layer): device kernels launched over
the traced window per input megapixel; launch overhead scales with it."""


def read(run):
    if run.trace is None or run.input_mp <= 0 or not run.trace.kernels:
        return None
    return run.trace.kernels / run.input_mp
