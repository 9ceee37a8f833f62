"""mp_per_s (MP/s, end to end): input megapixels of the requests the
window completed, over the window's seconds on the host clock (from the
first request's start to the last answer's return)."""


def read(run):
    if run.trace is not None or run.window_s <= 0:
        return None
    return run.input_mp / run.window_s
