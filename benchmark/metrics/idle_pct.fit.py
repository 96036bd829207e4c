"""The share of the traced segment in which no operation ran on the card,
percent: 1 - busy / window, busy the union of the device operations'
intervals in the trace."""


def read(ctx):
    if ctx.trace is None or ctx.trace["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
