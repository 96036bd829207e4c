"""Readers of the program's own spans and counters
(`laplace_jax_torch/utils/spans.py`) for the per-layer metrics: a key of
the window's per-fit `fit_seconds`, and the registry that the traced
segment fills (the program records while `torch.profiler` is active).
Each returns None where there is nothing to read: a program without such
a span, or work the run's device does not do."""

import statistics


def fit_mean(ctx, key: str):
    """The mean over the window's fits of `fit_seconds[key]`, seconds on the
    device's timeline; None where no fit has the key."""
    values = [f[key] for f in ctx.stats.get("fit_seconds") or [] if key in f]
    return statistics.fmean(values) if values else None


def registry(ctx):
    """The program's registry (`spans.summary()`) after the traced segment;
    None without a trace or where the program has no spans."""
    if ctx.trace is None:
        return None
    try:
        from laplace_jax_torch.utils import spans
    except ImportError:
        return None
    return spans.summary()


def within(spans: dict, name: str, root: str) -> bool:
    """Whether span `name` is `root` or lies inside it, by the registry's
    parents."""
    seen = set()
    while name is not None and name not in seen:
        if name == root:
            return True
        seen.add(name)
        name = spans.get(name, {}).get("parent")
    return False


def per_call_ms(ctx, names: tuple):
    """The device-timeline milliseconds of the spans `names` together, per
    `predict.call` of the traced segment; None where one is missing."""
    reg = registry(ctx)
    if reg is None:
        return None
    spans = reg["spans"]
    if "predict.call" not in spans or any(n not in spans for n in names):
        return None
    return 1e3 * sum(spans[n]["device_s"] for n in names) / spans["predict.call"]["count"]
