"""The whole eval request's share of the chip's fp32 peak: the work the
mix's shapes need (``counts.eval_request_flops``) times the requests the
window completed, over the window's seconds and 67 TFLOP/s, in percent."""


def read(ctx):
    requests, seconds = ctx.window.get("requests"), ctx.window.get("window_s")
    if not requests or not seconds:
        return None
    t, n, m = ctx.traffic["T"], ctx.traffic["N"], ctx.traffic["M"]
    flops = ctx.counts.eval_request_flops(ctx.config, t, n, m) * requests
    return 100.0 * flops / seconds / ctx.counts.FP32_OPS_PER_S
