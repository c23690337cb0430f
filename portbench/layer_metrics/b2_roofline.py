"""B2f and B2b (``csrc/pf_estimate.cu``, the training tail forward and
backward) against their least time: their bounds (``counts.b2_bound_s``
at the mix's (B, M, D)) summed over every launch, over their device times
summed, in percent."""

FORWARD, BACKWARD = "pf_estimate_fwd_kernel", "pf_estimate_bwd_kernel"


def read(ctx):
    if ctx.trace is None:
        return None
    b, m, d = ctx.traffic["B"], ctx.traffic["M"], ctx.config["state_dim"]
    bound = seconds = 0.0
    for kernel, backward in ((FORWARD, False), (BACKWARD, True)):
        launches, s = ctx.trace.kernel_seconds(kernel)
        bound += launches * ctx.counts.b2_bound_s(b, m, d, backward)
        seconds += s
    if seconds <= 0:
        return None
    return 100.0 * bound / seconds
