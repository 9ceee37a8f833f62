"""request.mfu_pct (%, whole request): the network's FLOP at each
request's unpadded input size (the configuration's reference module
counts them, products only), summed over the traced window's requests,
over the window's seconds times the card's peak product rate (float32
priced at TF32's). Padding, overlap and repeated work earn nothing."""


def read(run):
    if run.trace is None or run.peak is None or run.trace.window_s <= 0:
        return None
    arch = run.cell.config["arch"]
    flop = sum(run.reference.flops(arch, r[0], r[1])
               for r in run.requests if r[5])
    if not flop:
        return None
    return 100.0 * flop / (run.trace.window_s * run.peak["flops"])
