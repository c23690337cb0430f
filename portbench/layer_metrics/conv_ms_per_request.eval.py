"""Device time of the kernels launched inside ``aten::convolution`` (the
hoisted image encoders' convolutions, cuDNN's kernels and their bias
adds), per traced request (ms)."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("requests"):
        return None
    count, seconds = ctx.trace.kernels_launched_under({"aten::convolution"})
    if count == 0:
        return None
    return 1e3 * seconds / ctx.work["requests"]
