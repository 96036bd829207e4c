"""Seconds of a fit's routed-expert Grams (the held experts' A and B Grams
in `curvature/kfac._grams`), the mean of the program's
`fit_seconds["accumulate.grams.experts"]` over the window's fits:
device-timeline seconds, summed over the fit's batches. None where the
program has no such span."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "accumulate.grams.experts")
