"""The share of the traced window in which no kernel or copy ran on the
device: 1 − (union of the device intervals) / window, in %."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.busy:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
