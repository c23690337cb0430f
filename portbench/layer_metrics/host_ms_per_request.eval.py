"""Host time to dispatch an eval request: the benchmark's span from the
call into ``initialize_beliefs`` to the return of ``forward_loop``, before
the synchronise, mean over the window's requests (ms)."""


def read(ctx):
    spans = ctx.window.get("spans", [])
    if not spans or len(spans[0]) != 3:
        return None
    return 1e3 * sum(t1 - t0 for t0, t1, _ in spans) / len(spans)
