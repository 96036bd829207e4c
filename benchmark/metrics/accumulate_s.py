"""Seconds of a fit's accumulate (the taps and sweeps: `nnmodel.py`,
`curvature/backend.py`, `curvature/kfac.py`, `ops/im2col.py`), the mean of
the program's `fit_seconds["accumulate"]` (host clock, synchronised on
both sides) over the window's fits."""

import statistics


def read(ctx):
    fits = ctx.stats.get("fit_seconds") or []
    values = [f["accumulate"] for f in fits if "accumulate" in f]
    return statistics.fmean(values) if values else None
