"""tiling.work_ratio (ratio, tiling layer): pixels the model's forward
received (bucket and pad, band or tile overlap, a batch padded with
repeated tiles) per input pixel, over the traced window. A forward
pre-hook on the served model counts them."""


def read(run):
    if run.hooks is None or run.input_mp <= 0:
        return None
    return run.hooks.forward_pixels / (run.input_mp * 1e6)
