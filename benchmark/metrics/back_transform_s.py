"""Seconds of a fit's back-transform (`ops/tridiag.apply_q`: the WY
products that carry stage 2's vectors back), the mean of the program's
`fit_seconds["decompose.back_transform"]` over the window's fits:
device-timeline seconds. None where no stack takes the two-stage solver
(the CPU)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "decompose.back_transform")
