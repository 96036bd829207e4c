"""Launches of stage 2's secular kernel per traced fit: the program's
counter `decompose.stage2.secular_launches` (one each time
`ops/tridiag_eig._secular` launches `csrc/secular.cu`, once a merge level
on the card) over the traced segment's fits. None where the program has no
such counter: a program whose merges launch no kernel, or a run without a
card."""

from benchmark import program_spans


def read(ctx):
    reg = program_spans.registry(ctx)
    if reg is None or "decompose.stage2.secular_launches" not in reg["counters"]:
        return None
    return reg["counters"]["decompose.stage2.secular_launches"] / ctx.trace["units"]
