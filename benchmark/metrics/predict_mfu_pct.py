"""The predictive sweep's share of the card's float32 peak, percent:
each input's forward (`counts.forward_flops`) and its last-layer output
variances (`counts.ll_variance_flops`), over the inputs of the window's
calls, divided by the window's span times 67 TFLOP/s."""

from benchmark import counts


def read(ctx):
    if not ctx.stats.get("n_inputs"):
        return None
    per_input = counts.forward_flops(ctx.config) + counts.ll_variance_flops(ctx.config)
    return 100.0 * per_input * ctx.stats["n_inputs"] / (ctx.stats["span_s"] * counts.PEAK_FLOPS_F32)
