"""Percent of the traced window in which nothing ran on the device:
1 - the union of the device records' intervals over the window."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.busy:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
