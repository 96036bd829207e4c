"""The stage-1 panel kernels' share of their roofline in a fit, percent.

The least time of every factor stack (K, n) that the fit's decompose
routes to the kernels (n >= 512: `ops/latrd.py` with `csrc/latrd.cu` below
2304, `ops/latrd_v4.py` with `csrc/latrd_v4.cu` from 2304), worked out
from the configuration's layer table by `counts.stage1_least_seconds`,
over the device time of the kernels named in `KERNELS` in the traced fits.
Nothing is read where the trace holds none of them."""

import re

from benchmark import counts

# the kernels' names in the device trace (`k_panel<...>` in both sources)
KERNELS = (r"\bk_panel\b",)
ROUTED_MIN_N = 512


def read(ctx):
    if ctx.trace is None:
        return None
    device_s = sum(s for name, s in ctx.trace["kernel_s"].items()
                   if any(re.search(k, name) for k in KERNELS))
    if device_s <= 0:
        return None
    least = sum(counts.stage1_least_seconds(K, n)[0]
                for n, K in counts.factor_classes(ctx.config).items() if n >= ROUTED_MIN_N)
    return 100.0 * least * ctx.trace["units"] / device_s
