"""LATRD panel kernel for CUDA (replaces `laplace_jax/ops/latrd_pallas.py`,
`latrd_panel` / `_panel_kernel`), used by stage 1 for 512 <= n < 2304.

`latrd_panel` runs one panel of blocked Householder tridiagonalization on a
stack of K symmetric windows (the contract in `ops/tridiag.py`). On a CUDA
tensor it launches `csrc/latrd.cu`; on a CPU tensor it runs
`latrd_panel_plain`, the same contract in plain PyTorch. There is no other
route: a CUDA tensor the kernel does not take raises.

`latrd_panel.launches` counts the panels launched on the card.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.tridiag import (
    _cdiv,
    _tridiag_small,
    panel_plain,
    tridiagonalize_windows,
)

__all__ = ["latrd_panel", "latrd_panel_plain", "tridiagonalize_latrd"]


def latrd_panel_plain(Aw, off: int, q_base: int, n_real: int, nb: int):
    """The panel in plain PyTorch: full trailing matvec."""
    return panel_plain(Aw, off, q_base, n_real, nb)


def panel_buffers(lib, K: int, m: int, nb: int, dtype, device) -> dict:
    """The outputs and scratch of one panel launch, in the order of the C
    interface; the library gives the sizes of the scratch it indexes."""
    kw = dict(dtype=dtype, device=device)
    return dict(UW=torch.empty(K, 2 * nb, m, **kw), det=torch.empty(K, 3, nb, **kw),
                col=torch.empty(K, m, **kw), part=torch.empty(lib.part_elems(K, m), **kw),
                y=torch.empty(K, m, **kw), st=torch.empty(K, 2 * nb, **kw),
                scal=torch.empty(K, 4, **kw),
                work=torch.empty(max(lib.work_elems(K, m, nb), 1), **kw))


def check_window(Aw, off: int, nb: int) -> None:
    """Raise for a window the panel kernels do not take."""
    if Aw.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"panel kernel takes float32/float64, got {Aw.dtype}")
    if Aw.ndim != 3 or Aw.shape[1] != Aw.shape[2] or not Aw.is_contiguous():
        raise ValueError(f"panel kernel takes a contiguous (K, m, m) window, got "
                         f"{tuple(Aw.shape)} contiguous={Aw.is_contiguous()}")
    m = Aw.shape[1]
    if m % 64 or not 0 <= off <= m - nb or nb < 1:
        raise ValueError(f"panel kernel needs m % 64 == 0 and off + nb <= m "
                         f"(m={m}, off={off}, nb={nb})")


def launch_panel(lib_name: str, Aw, off: int, q_base: int, n_real: int, nb: int,
                 extra: tuple = ()):
    """Check the window and run one panel of the library's kernel on
    PyTorch's current stream; returns (UW, det) as in the contract.
    `extra` are the arguments a library takes after `n_real`
    (`ops/latrd_v4.py`'s schedule)."""
    check_window(Aw, off, nb)
    K, m, _ = Aw.shape
    lib = _build.load(lib_name)
    fn = lib.panel_f32 if Aw.dtype == torch.float32 else lib.panel_f64
    buf = panel_buffers(lib, K, m, nb, Aw.dtype, Aw.device)
    stream = torch.cuda.current_stream(Aw.device).cuda_stream
    rc = fn(Aw.data_ptr(), *(b.data_ptr() for b in buf.values()),
            K, m, nb, off, q_base, n_real, *extra, stream)
    if rc != 0:
        raise RuntimeError(f"{lib_name} panel launch failed: "
                           f"{lib.error_string(rc).decode()}")
    return buf["UW"], buf["det"]


def latrd_panel(Aw, off: int, q_base: int, n_real: int, nb: int):
    """One LATRD panel: the CUDA kernel for a CUDA window, the plain
    version for a CPU window."""
    if Aw.device.type == "cpu":
        return latrd_panel_plain(Aw, off, q_base, n_real, nb)
    out = launch_panel("latrd", Aw, off, q_base, n_real, nb)
    latrd_panel.launches += 1
    return out


latrd_panel.launches = 0


def tridiagonalize_latrd(A: torch.Tensor, nb: int = 64, n_classes: int = 4):
    """Stage 1 with the LATRD panel kernel (the JAX package's
    `tridiagonalize_pallas`): window classes of ~n/n_classes rows rounded
    up to 128, so every window is a multiple of 128 wide, and `nb` a
    multiple of 8 dividing them (the JAX package normalizes `nb` the same
    way in `eigh_stack_ts`, `tridiag_eig.py:515-527`)."""
    K, n, _ = A.shape
    if n <= 2:
        return _tridiag_small(A)
    S = max(128, _cdiv(_cdiv(n, n_classes), 128) * 128)
    nb = min(max(8, nb) & ~7, S)
    while S % nb:
        nb -= 8
    return tridiagonalize_windows(A, nb, S, latrd_panel)
