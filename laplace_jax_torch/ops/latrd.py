"""LATRD panel kernel for CUDA (replaces `laplace_jax/ops/latrd_pallas.py`,
`latrd_panel` / `_panel_kernel`), used by stage 1 for 512 <= n < 2304.

`latrd_panel` runs one panel of blocked Householder tridiagonalization on a
stack of K symmetric windows (the contract in `ops/tridiag.py`). On a CUDA
tensor it launches `csrc/latrd.cu`; on a CPU tensor it runs
`latrd_panel_plain`, the same contract in plain PyTorch. There is no other
route: a CUDA tensor the kernel does not take raises.

On the card a panel is one cooperative launch, one block per SM (fewer for
small windows). Which rows each block owns, and whether its window rows and
its rows of U and W fit in its shared memory for the whole panel, is
decided here (`panel_plan`) and handed to the kernel.

`latrd_panel.launches` counts the panels launched on the card.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.tridiag import (
    _cdiv,
    _tridiag_small,
    panel_plain,
    tridiagonalize_windows,
)

__all__ = ["latrd_panel", "latrd_panel_plain", "tridiagonalize_latrd", "panel_plan",
           "block_count"]

SMEM_BYTES = 232448  # shared memory one block may use on the H100 (227 KB)
STATIC_BYTES = 1024  # the kernel's static shared memory (none), with room to spare
MIN_ROWS = 8         # rows a block owns at least: small windows take fewer blocks


class PanelPlan(NamedTuple):
    """One v1 panel launch: `n_cta` blocks, each owning `rows` live rows at
    most; whether each block keeps its window rows
    (`cache_window`) and its rows of U and W and of window rows off ..
    off+nb-1 (`cache_rows`) in shared memory; and the dynamic shared memory
    in bytes."""

    n_cta: int
    rows: int
    cache_window: bool
    cache_rows: bool
    smem: int


def _rows_and_windows(K: int, L: int, n_cta: int) -> tuple:
    """(R, NW): the rows a block owns at most and the windows it touches at
    most (`layout` in csrc/latrd_panel.cuh). The live rows (window-relative
    rows >= off, L = m - off a window) are cut as `Rows` there cuts them:
    with K <= n_cta (a multiple of K) each window's rows into n_cta / K runs
    of its own, else all K L rows into n_cta runs; runs differ by at most a
    row."""
    if K <= n_cta:
        return _cdiv(L, n_cta // K), 1
    R = _cdiv(K * L, n_cta)
    return R, min(K, (R + L - 2) // L + 1)


def block_count(K: int, L: int, n_sm: int) -> int:
    """The blocks of a row-run panel launch (v1, v2) on a card with `n_sm`
    SMs, for K windows of L live rows: with K <= n_sm, each window takes
    min(n_sm // K, L / MIN_ROWS) blocks of its own; else min(n_sm, K L /
    MIN_ROWS) blocks share the K L rows."""
    if K <= n_sm:
        return K * min(n_sm // K, _cdiv(L, MIN_ROWS))
    return min(n_sm, _cdiv(K * L, MIN_ROWS))


def smem_bytes(K: int, m: int, off: int, nb: int, n_cta: int, cache_window: bool,
               cache_rows: bool, itemsize: int) -> int:
    """The kernel's dynamic shared memory (`layout` in csrc/latrd_panel.cuh,
    NG = 1): the window rows from column cb = vec_floor(off + 1) on (R x
    LW), the staged column of each window a block touches (NW x LW), its
    rows of U and W (2nb x R) and of the panel's window rows (nb x R), its
    rows' corrected column and y (2 x R), and per window U[:, c], W[:, c]
    (2nb), U v, W v, y.v (2nb + 1) and 4 scalars."""
    R, NW = _rows_and_windows(K, m - off, n_cta)
    vec = 16 // itemsize
    LW = m - (off + 1) // vec * vec
    elems = (R * LW * cache_window + NW * LW + 3 * nb * R * cache_rows + 2 * R
             + NW * (4 * nb + 5))
    return elems * itemsize


def panel_plan(K: int, m: int, off: int, nb: int, itemsize: int, n_sm: int) -> PanelPlan:
    """The launch of one panel on a card with `n_sm` SMs: `block_count`
    blocks over the L = m - off live rows of each window. Each block keeps
    its window rows and its rows of U and W in shared memory when they fit,
    else only its rows of U and W, else neither (it then reads them from
    L2). Raises for a window whose per-window vectors alone do not fit."""
    L = m - off
    n_cta = block_count(K, L, n_sm)
    rows = _rows_and_windows(K, L, n_cta)[0]
    for cache_window, cache_rows in ((True, True), (False, True), (False, False)):
        smem = smem_bytes(K, m, off, nb, n_cta, cache_window, cache_rows, itemsize)
        if STATIC_BYTES + smem <= SMEM_BYTES:
            return PanelPlan(n_cta, rows, cache_window, cache_rows, smem)
    raise ValueError(f"the v1 panel kernel does not take K={K}, m={m}, off={off}, nb={nb} "
                     f"in {itemsize}-byte floats: its vectors need {smem} bytes of shared "
                     f"memory a block")


_plans: dict = {}


def _plan_args(Aw, off: int, nb: int) -> tuple:
    """The kernel's plan arguments for this panel (n_cta, cache_window,
    cache_rows), cached by (K, m, off, nb, dtype, device); the first use
    checks the plan's shared memory against the kernel's own reckoning."""
    K, m, _ = Aw.shape
    key = (K, m, off, nb, Aw.dtype, Aw.device)
    if key not in _plans:
        size = Aw.element_size()
        n_sm = torch.cuda.get_device_properties(Aw.device).multi_processor_count
        plan = panel_plan(K, m, off, nb, size, n_sm)
        args = (plan.n_cta, int(plan.cache_window), int(plan.cache_rows))
        lib_smem = _build.load("latrd").smem_bytes(K, m, off, nb, *args, size)
        if lib_smem != plan.smem:
            raise RuntimeError(f"csrc/latrd.cu reckons {lib_smem} bytes of shared memory, "
                               f"ops/latrd.py {plan.smem}")
        _plans[key] = args
    return _plans[key]


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
    `extra` are the arguments a library takes after `n_real` (the plan of
    `latrd`, the schedule of `latrd_v4`)."""
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
    check_window(Aw, off, nb)
    out = launch_panel("latrd", Aw, off, q_base, n_real, nb, _plan_args(Aw, off, nb))
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
