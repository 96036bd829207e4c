"""Seconds of a fit's stage-2 merges (every level of
`ops/tridiag_eig._merge_level`: the secular equations and the vectors), the
mean of the program's `fit_seconds["decompose.stage2.merge"]` over the
window's fits: device-timeline seconds. None where no stack takes the
two-stage solver (the CPU)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "decompose.stage2.merge")
