"""B1 (``csrc/pf_resample.cu``, the per-step eval tail: update, estimate,
multinomial resample) against its least time: ``counts.tail_bound_s`` at
the mix's (N, M, D) over B1's device time per launch, in percent. B1 and B4
share one kernel template; the mixes that list this metric resample
multinomially, so every launch is B1."""

KERNEL = "pf_row_tail_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    launches, seconds = ctx.trace.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    n, m, d = ctx.traffic["N"], ctx.traffic["M"], ctx.config["state_dim"]
    return 100.0 * ctx.counts.tail_bound_s(n, m, d) / (seconds / launches)
