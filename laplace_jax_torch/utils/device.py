"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take `cuda`, and they raise when there is none. Nothing
falls back to the CPU silently. `full_f32` scopes the float32 precision
settings to the port's own heavy calls; `to_device` moves a batch.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Mapping

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device`, or `cuda` when it is None; raises when CUDA is asked for
    (explicitly or by default) and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "No CUDA device is available. Pass device='cpu' to run on the "
            "CPU explicitly."
        )
    return dev


def to_device(x, device, dtype):
    """An input on `device`: floating arrays and tensors in `dtype`, integer
    ones as they are, a dict entry by entry; entries that are not arrays
    (strings, None) stay as they are."""
    if isinstance(x, Mapping):
        return {k: to_device(v, device, dtype) for k, v in x.items()}
    if not isinstance(x, (torch.Tensor, np.ndarray, np.generic, int, float, list, tuple)):
        return x
    t = torch.as_tensor(x, device=device)
    return t.to(dtype) if t.is_floating_point() else t


def _precision_knobs() -> list:
    """The `fp32_precision` settings of this torch (the newer precision
    API; absent before torch 2.9)."""
    b = torch.backends
    knobs = [b, b.cuda.matmul, b.cudnn, getattr(b.cudnn, "conv", None),
             getattr(b.cudnn, "rnn", None)]
    return [k for k in knobs if k is not None and hasattr(k, "fp32_precision")]


def _read(get):
    """A precision setting, or None where torch refuses to read it (it
    raises once the legacy and the newer API have both been used)."""
    try:
        return get()
    except RuntimeError:
        return None


@contextmanager
def full_f32():
    """Within the scope, float32 products and cuDNN convolutions run in full
    float32 (no TF32); on exit, also on an exception, every precision
    setting is as it was.

    The eigensolver's trailing rank-2nb updates diverge O(1) after a few
    panels when products round to TF32 (the JAX package documents the same
    failure at reduced matmul precision, `laplace_jax/ops/latrd_pallas.py`,
    `tridiagonalize_pallas`), and the KFAC factors feed that solver, so the
    port's entry points run in this scope; the caller's own code keeps its
    settings. Scopes nest.
    """
    matmul = _read(lambda: torch.backends.cuda.matmul.allow_tf32)
    cudnn = _read(lambda: torch.backends.cudnn.allow_tf32)
    precision = _read(torch.get_float32_matmul_precision)
    knobs = [(k, k.fp32_precision) for k in _precision_knobs()]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        # the legacy flags, then the matmul precision, then the newer API's
        # settings: this order gives back each state torch can be left in
        if matmul is not None:
            torch.backends.cuda.matmul.allow_tf32 = matmul
        if cudnn is not None:
            torch.backends.cudnn.allow_tf32 = cudnn
        if precision is not None:
            torch.set_float32_matmul_precision(precision)
        for knob, value in knobs:
            knob.fp32_precision = value
