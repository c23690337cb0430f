"""Host time in the step layer per filter step (us/step): the union of the
program's outermost step-layer spans (each ``mmf.pf.step`` of a per-step
loop; the fused route's ``mmf.fused.pack`` and ``mmf.fused.launch``) over
T times the requests traced."""

from portbench import spans


def read(ctx):
    if ctx.trace is None or not ctx.work.get("steps"):
        return None
    step_layer = spans.intervals(ctx.trace, spans.STEP_LAYER)
    if not step_layer:
        return None
    return spans.length(step_layer) / ctx.work["steps"]
