"""The whole optimizer step's share of the chip's fp32 peak: the work the
mix's shapes need (``counts.train_step_flops``: forward, and backward as
twice the forward) times the steps the window completed, over the
window's seconds and 67 TFLOP/s, in percent."""


def read(ctx):
    steps, seconds = ctx.window.get("optimizer_steps"), ctx.window.get("window_s")
    if not steps or not seconds:
        return None
    b, seq_len, m = ctx.traffic["B"], ctx.traffic["L"], ctx.traffic["M"]
    flops = ctx.counts.train_step_flops(ctx.config, b, seq_len, m) * steps
    return 100.0 * flops / seconds / ctx.counts.FP32_OPS_PER_S
