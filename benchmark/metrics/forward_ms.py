"""Milliseconds of a predictive call's network forward to the features
(`model.apply_with_features` in `curvature/backend.last_layer_jacobians`):
the device-timeline seconds of the program's span `predict.forward` per
`predict.call` in the traced segment."""

from benchmark import program_spans


def read(ctx):
    return program_spans.per_call_ms(ctx, ("predict.forward",))
