"""Device kernels launched per optimizer step of end-to-end training."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("optimizer_steps"):
        return None
    kernels = len(ctx.trace.kernels)
    return kernels / ctx.work["optimizer_steps"] if kernels else None
