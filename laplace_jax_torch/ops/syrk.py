"""Symmetric rank-k update `H = AᵀA` for CUDA (replaces
`laplace_jax/ops/syrk.py`, `syrk`), the dense GGN of `FullLaplace`.

On a CUDA tensor `syrk` launches `csrc/syrk.cu` for any shape, float32 or
float64; on a CPU tensor it runs `syrk_plain`, the JAX package's
`syrk_reference`. There is no other route: a CUDA tensor the kernel does
not take raises. (The JAX wrapper falls back to the einsum for unaligned
shapes; the CUDA kernel guards its ragged tiles instead.)

`syrk.launches` counts the kernel launches on the card.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.ops import _build

__all__ = ["syrk", "syrk_plain"]


def syrk_plain(A: torch.Tensor) -> torch.Tensor:
    """AᵀA in plain PyTorch."""
    return torch.einsum("rp,rq->pq", A, A)


def syrk(A: torch.Tensor) -> torch.Tensor:
    """AᵀA (P, P) of A (R, P): the CUDA kernel for a CUDA tensor, exactly
    symmetric; the plain version for a CPU tensor."""
    if A.device.type == "cpu":
        return syrk_plain(A)
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"syrk kernel takes float32/float64, got {A.dtype}")
    if A.ndim != 2 or not A.is_contiguous():
        raise ValueError(f"syrk kernel takes a contiguous (R, P) matrix, got "
                         f"{tuple(A.shape)} contiguous={A.is_contiguous()}")
    R, P = A.shape
    H = torch.empty(P, P, dtype=A.dtype, device=A.device)
    if P == 0:
        return H
    if max(R, P) >= 2**31:
        raise ValueError(f"syrk kernel: shape {tuple(A.shape)} is too large")
    lib = _build.load("syrk")
    fn = lib.syrk_f32 if A.dtype == torch.float32 else lib.syrk_f64
    rc = fn(A.data_ptr(), H.data_ptr(), R, P, torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"syrk launch failed: {lib.error_string(rc).decode()}")
    syrk.launches += 1
    return H


syrk.launches = 0
