"""The host's waits for the card inside a fit's decompose, per traced fit:
the synchronizing CUDA operations that the program counts in its spans
under `decompose` while the profiler traces (`utils/spans.py`). None where
none were counted (no card)."""

from benchmark import program_spans


def read(ctx):
    reg = program_spans.registry(ctx)
    if reg is None:
        return None
    spans = reg["spans"]
    syncs = [e["syncs"] for name, e in spans.items()
             if program_spans.within(spans, name, "decompose") and e["syncs"] is not None]
    return sum(syncs) / ctx.trace["units"] if syncs else None
