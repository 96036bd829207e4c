"""Seconds of a fit's A and B Grams (`curvature/kfac._grams`: im2col,
`ops/im2col.py`, and the Gram products), the mean of the program's
`fit_seconds["accumulate.grams"]` over the window's fits: device-timeline
seconds, summed over the fit's batches."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "accumulate.grams")
