"""engine.copy_ms_per_mp (ms/MP, engine layer): device time of the copies
between host and card (the float32 image in, the uint8 answer out, and any
other) over the traced window, per input megapixel."""


def read(run):
    if run.trace is None or not run.trace.busy_s or run.input_mp <= 0:
        return None
    return 1e3 * run.trace.memcpy_s / run.input_mp
