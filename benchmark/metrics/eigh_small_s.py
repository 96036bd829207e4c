"""Seconds of a fit's `torch.linalg.eigh` (every factor class the two-stage
solver does not take: below 512 rows on the card, all on the CPU), the mean
of the program's `fit_seconds["decompose.eigh"]` over the window's fits:
device-timeline seconds."""

from benchmark import program_spans


def read(ctx):
    return program_spans.fit_mean(ctx, "decompose.eigh")
