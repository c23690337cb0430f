"""B3 (``csrc/pf_fused_step.cu``, the whole fused eval loop) against its
least time: ``counts.b3_bound_s`` at the mix's (T, N, M) over B3's device
time per launch in the traced segment, in percent."""

KERNEL = "pf_fused_forward_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    launches, seconds = ctx.trace.kernel_seconds(KERNEL)
    if not launches or seconds <= 0:
        return None
    t, n, m = ctx.traffic["T"], ctx.traffic["N"], ctx.traffic["M"]
    return 100.0 * ctx.counts.b3_bound_s(ctx.config, t, n, m) / (seconds / launches)
