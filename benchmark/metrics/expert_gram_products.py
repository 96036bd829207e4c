"""Matrix products of the routed experts' Grams per traced fit (one for
each A and each B of a held expert's projection, each batch): the
program's counter `accumulate.grams.experts.products` over the traced
segment's fits. None where the program has no such counter."""

from benchmark import program_spans


def read(ctx):
    reg = program_spans.registry(ctx)
    if reg is None or "accumulate.grams.experts.products" not in reg["counters"]:
        return None
    return reg["counters"]["accumulate.grams.experts.products"] / ctx.trace["units"]
