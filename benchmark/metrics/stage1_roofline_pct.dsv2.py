"""The stage-1 panel kernels' share of their roofline in a reward-model
fit, percent: the least time of every factor stack (K, n) with n >= 512
(`counts.stage1_least_seconds` over `counts_dsv2.factor_classes`) over the
device time of the `k_panel` kernels (v1 below 2304, v4 from it) in the
traced fits. Nothing is read where the trace holds none of them."""

import re

from benchmark import counts, counts_dsv2

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
                for n, K in counts_dsv2.factor_classes(ctx.config).items() if n >= ROUTED_MIN_N)
    return 100.0 * least * ctx.trace["units"] / device_s
