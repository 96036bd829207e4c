"""A whole fit's share of the card's float32 peak, percent: the FLOPs an
all-weights exact-Fisher KFAC fit of the mix's inputs needs
(`counts.kfac_fit_flops`: the forward, the C sweeps, the A and B Grams,
each factor's eigendecomposition but its tridiagonal solve) over the
window's mean fit time times 67 TFLOP/s."""

from benchmark import counts


def read(ctx):
    fit_s = ctx.stats.get("fit_s")
    if not fit_s:
        return None
    flops = counts.kfac_fit_flops(ctx.config, ctx.stats["n_per_fit"])
    return 100.0 * flops / (fit_s * counts.PEAK_FLOPS_F32)
