"""Device time of the kernels launched inside the program's ``mmf.pf.encode``
span (the hoisted encoder pass over every frame of the loop: the image
CNNs, the MLP encoders, the gate's log-weights and the control encoder),
per traced request (ms)."""

from portbench import spans


def read(ctx):
    if ctx.trace is None or not ctx.work.get("requests"):
        return None
    count, seconds = ctx.trace.kernels_launched_under({spans.PF_ENCODE})
    if count == 0:
        return None
    return 1e3 * seconds / ctx.work["requests"]
