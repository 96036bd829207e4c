"""Seconds of a fit's decompose (`utils/matrix.Kron.decompose`: stage 1
on the panel kernels or `torch.linalg.eigh`, stage 2 in
`ops/tridiag_eig.py`, the back-transform in `ops/tridiag.py`), the mean of
the program's `fit_seconds["decompose"]` over the window's fits."""

import statistics


def read(ctx):
    fits = ctx.stats.get("fit_seconds") or []
    values = [f["decompose"] for f in fits if "decompose" in f]
    return statistics.fmean(values) if values else None
