"""device_idle_share (share): 1 - the union of the card's operation
intervals over the traced window's length."""


def read(run):
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 1.0 - run.trace.busy_s / run.trace.window_s
