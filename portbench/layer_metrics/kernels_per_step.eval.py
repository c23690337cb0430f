"""Device kernels launched per filter step of an eval request: kernels in
the traced segment over T times the requests traced."""


def read(ctx):
    if ctx.trace is None or not ctx.work.get("steps"):
        return None
    kernels = len(ctx.trace.kernels)
    return kernels / ctx.work["steps"] if kernels else None
