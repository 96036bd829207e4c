"""Seconds of a fit's stage 1 (the tridiagonalization of every stack the
two-stage solver takes: the panel kernels and the trailing updates,
`ops/tridiag_eig.eigh_stack_ts`), the mean of the program's
`fit_seconds["decompose.stage1"]` over the window's fits: device-timeline
seconds. None where no stack takes the two-stage solver (the CPU)."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "decompose.stage1")
