"""device.idle_pct (%, device layer): the share of the traced window in
which no kernel, copy or memset ran on the card (the complement of the
union of their intervals)."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0 or not run.trace.busy_s:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
