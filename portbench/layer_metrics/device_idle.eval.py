"""The device's idle share of the traced segment: the part of the traced
window in which no device operation runs (the union of their intervals),
in percent."""


def read(ctx):
    trace = ctx.trace
    if trace is None or not trace.device_ops or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
