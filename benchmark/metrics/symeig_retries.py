"""Factors sent to the `symeig` retry per traced fit (a factor whose
eigensolver output holds a NaN, `utils/matrix.Kron.decompose`): the
program's counter `decompose.retries` over the traced segment's fits, 0
where the decompose ran and none was retried."""

from benchmark import program_spans


def read(ctx):
    reg = program_spans.registry(ctx)
    if reg is None or "decompose" not in reg["spans"]:
        return None
    return reg["counters"].get("decompose.retries", 0) / ctx.trace["units"]
