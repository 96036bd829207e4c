"""Seconds of a fit's stage 2 (the tridiagonal divide and conquer,
`ops/tridiag_eig.tridiag_eigh`), the mean of the program's
`fit_seconds["decompose.stage2"]` over the window's fits: device-timeline
seconds. None where no stack takes the two-stage solver (the CPU)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "decompose.stage2")
