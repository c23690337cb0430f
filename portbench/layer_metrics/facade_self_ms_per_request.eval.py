"""Host self time of the facade per traced request (ms): the program's
``mmf.facade.*`` spans (``StatefulFilter.initialize_beliefs`` and
``forward_loop``: moving inputs to the device, the initial draw and its
Cholesky, the loop's bookkeeping) less the ``mmf.*`` spans nested in them
(the encoder pass, the steps, the fused route)."""

from portbench import spans


def read(ctx):
    trace = ctx.trace
    if trace is None or not ctx.work.get("requests") or not spans.intervals(trace, spans.FACADE):
        return None
    return spans.self_time(trace, spans.FACADE) / 1e3 / ctx.work["requests"]
