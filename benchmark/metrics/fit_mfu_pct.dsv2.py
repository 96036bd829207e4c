"""A whole reward-model fit's share of the card's float32 peak, percent:
the FLOPs a KFAC fit of the mix's pairs needs (`counts_dsv2.fit_flops`:
the forward, the 2 sweeps, the A and B Grams with the experts' rows at
their expected share, each factor's eigendecomposition but its
tridiagonal solve) over the window's mean fit time times 67 TFLOP/s."""

from benchmark import counts, counts_dsv2


def read(ctx):
    fit_s = ctx.stats.get("fit_s")
    if not fit_s:
        return None
    flops = counts_dsv2.fit_flops(ctx.config, ctx.stats["n_per_fit"], ctx.stats["seq_len"])
    return 100.0 * flops / (fit_s * counts.PEAK_FLOPS_F32)
