"""Device resolution shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: with no
device given they take `cuda`, and they raise when there is none. Nothing
falls back to the CPU silently.
"""

from __future__ import annotations

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


def full_f32_matmuls() -> None:
    """Pin float32 products to full float32 precision.

    The eigensolver's trailing rank-2nb updates diverge O(1) after a few
    panels when products round to TF32 (the JAX package documents the same
    failure at reduced matmul precision, `laplace_jax/ops/latrd_pallas.py`,
    `tridiagonalize_pallas`), and the KFAC factors feed that solver, so both
    the matmul and the cuDNN convolution switches are set explicitly.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
