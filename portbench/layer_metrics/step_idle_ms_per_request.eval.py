"""Device idle while the host is inside the step layer, per traced request
(ms): the traced window less the union of the device's operations, within
the program's outermost step-layer spans (``mmf.pf.step``,
``mmf.fused.pack``, ``mmf.fused.launch``)."""

from portbench import spans


def read(ctx):
    if ctx.trace is None or not ctx.work.get("requests"):
        return None
    if not spans.intervals(ctx.trace, spans.STEP_LAYER):
        return None
    return spans.idle_within(ctx.trace, spans.STEP_LAYER) / 1e3 / ctx.work["requests"]
