"""Symmetric rank-k update `H = AᵀA` for CUDA (replaces
`laplace_jax/ops/syrk.py`, `syrk`), the dense GGN of `FullLaplace`.

On a CUDA tensor `syrk` launches `csrc/syrk.cu` for any shape, float32 or
float64; on a CPU tensor it runs `syrk_plain`, the JAX package's
`syrk_reference`. There is no other route: a CUDA tensor the kernel does
not take raises. (The JAX wrapper falls back to the einsum for unaligned
shapes; the CUDA kernel guards its ragged tiles instead.)

`syrk_plan` is the kernel's launch geometry (its lower tiles in launch
order, tile edge, chunk, ring stages, copy width, shared memory), which
the card tests hold against the library's own `syrk_geometry`;
`syrk_tiled` computes H the way the kernel does, tile by tile, for the
CPU tests.

`syrk.launches` counts the kernel launches on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from laplace_jax_torch.ops import _build

__all__ = ["SyrkPlan", "syrk", "syrk_plain", "syrk_plan", "syrk_tiled"]

CHUNK = 32  # rows of A a ring slot holds
STAGES = 2  # ring slots
THREADS = 256


class SyrkPlan(NamedTuple):
    tile: int  # output tile edge
    thread_tile: int  # a thread's register tile edge (thread_tile ** 2 accumulators)
    threads: int
    chunk: int
    stages: int
    copy_bytes: int  # cp.async width (A at a 16-byte aligned address); no padded copy
    smem_bytes: int  # dynamic shared memory a block: the ring or the epilogue's tile
    n_chunks: int
    tiles: tuple  # the lower tiles (ti, tj), ti >= tj, one block each, in launch order


def syrk_plan(R: int, P: int, dtype: torch.dtype) -> SyrkPlan:
    """The launch geometry of `csrc/syrk.cu` for A (R, P) of `dtype`."""
    size = torch.empty(0, dtype=dtype).element_size()
    if size not in (4, 8) or R < 0 or P < 1:
        raise ValueError(f"syrk plan: shape {(R, P)}, dtype {dtype}")
    sub = 16 // size  # one 16-byte vector a fragment
    tile, n = 32 * sub, -(-P // (32 * sub))
    row = P * size
    copy = 16 if row % 16 == 0 else 8 if row % 8 == 0 else 4
    smem = max(STAGES * 2 * CHUNK * tile, tile * (tile + 1)) * size
    tiles = tuple((i, j) for i in range(n) for j in range(i + 1))
    return SyrkPlan(tile, 2 * sub, THREADS, CHUNK, STAGES, copy, smem, -(-R // CHUNK), tiles)


def syrk_plain(A: torch.Tensor) -> torch.Tensor:
    """AᵀA in plain PyTorch, exactly symmetric: the product's lower
    triangle mirrored, as the kernel and the JAX `syrk` write it (a CPU
    BLAS need not return the product itself symmetric)."""
    low = torch.tril(torch.einsum("rp,rq->pq", A, A))
    return low + torch.tril(low, -1).mT


def syrk_tiled(A: torch.Tensor) -> torch.Tensor:
    """AᵀA as the kernel computes it: zero-filled strips, each lower tile
    summed over the rows of A in the kernel's order (chunk by chunk, k by
    k), then each tile's lower part written and mirrored. Any device; a
    reference for tests (one Python step per row of A)."""
    R, P = A.shape
    plan = syrk_plan(R, P, A.dtype)
    t = plan.tile
    n = -(-P // t)
    padded = A.new_zeros(plan.n_chunks * plan.chunk, n * t)
    padded[:R, :P] = A
    strips = padded.view(-1, n, t)  # strips[k, s] = row k of strip s
    ti = torch.tensor([i for i, _ in plan.tiles], device=A.device)
    tj = torch.tensor([j for _, j in plan.tiles], device=A.device)
    acc = A.new_zeros(len(plan.tiles), t, t)
    for k in range(strips.shape[0]):
        acc += strips[k, ti][:, :, None] * strips[k, tj][:, None, :]
    H = A.new_zeros(n * t, n * t)
    H.view(n, t, n, t)[ti, :, tj, :] = acc
    low = torch.tril(H)  # a diagonal tile's lower half; the others lie below it
    return (low + torch.tril(low, -1).mT)[:P, :P]


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
