"""1 - (the union of the device's kernel, copy and set intervals) / (the
traced window's length), both from the same traced run."""


def read(ctx):
    t = ctx.trace
    if t is None or t.busy_s <= 0:
        return None
    return 1.0 - t.busy_s / t.window_s
