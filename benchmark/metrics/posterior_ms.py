"""Milliseconds of a predictive call's Laplace part: the phi (x) I Jacobians
(`predict.jacobians`), the Kron output variance
(`KronDecomposed.inv_square_form`, `predict.variance`) and the probit link
(`predict.link`), device-timeline seconds per `predict.call` in the traced
segment."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, ("predict.jacobians", "predict.variance",
                                           "predict.link"))
