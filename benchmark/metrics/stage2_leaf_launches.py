"""Launches of stage 2's Jacobi leaves kernel per traced fit: the
program's counter `decompose.stage2.leaf_launches` (one each time
`ops/tridiag_eig._jacobi_eigh` launches `csrc/jacobi_leaves.cu`, once a
stage-2 call on the card) over the traced segment's fits. None where the
program has no such counter: a program whose leaves launch no kernel, or
a run without a card."""

from benchmark import program_spans


def read(ctx):
    reg = program_spans.registry(ctx)
    if reg is None or "decompose.stage2.leaf_launches" not in reg["counters"]:
        return None
    return reg["counters"]["decompose.stage2.leaf_launches"] / ctx.trace["units"]
