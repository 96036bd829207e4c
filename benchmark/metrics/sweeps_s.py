"""Seconds of a fit's C backward sweeps (the cotangents and the batched
`torch.autograd.grad` over the taps' offsets, `curvature/kfac.kfac_factors`),
the mean of the program's `fit_seconds["accumulate.sweeps"]` over the
window's fits: device-timeline seconds, summed over the fit's batches."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "accumulate.sweeps")
