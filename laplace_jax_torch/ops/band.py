"""Successive band reduction (SBR), stage A: full symmetric -> banded with
semi-bandwidth `b`, by blocked panel QR with compact-WY two-sided updates.

Port of `laplace_jax/ops/band.py`. The window classes, the panel loop and
the reflector layout are the JAX package's, so each output compares one to
one: the reflector of global column `c` is stored in `V[:, :, c]` with its
unit leading element at row `c + b` and support `[c + b, n)`, and
`A = Q B Q^T` with `Q = H_0 H_1 ...`; `ops.tridiag.apply_q` applies `Q`
unchanged. The JAX package builds its per-k products as one 2-D matmul
over a block-diagonal operand; here they are `torch.bmm` over k.

The op runs on the device of its input. No entry point reaches it: with
`ops.chase` it is a standalone op chain, full -> band -> tridiagonal.
"""

from __future__ import annotations

import torch

from laplace_jax_torch.ops.tridiag import _cdiv, eps_tiny, reflector, wy_factor

__all__ = ["band_reduce"]


def band_reduce(A: torch.Tensor, b: int = 64, n_classes: int = 8):
    """Reduce a batch of symmetric matrices to symmetric band form.

    A (K, n, n) symmetric. Returns `B` (K, n, n) banded (entries with
    |i - j| > b zero), `V` (K, n, n) the Householder vectors (columns past
    the last panel zero) and `taus` (K, n) (0 for the identity).
    """
    K, n, _ = A.shape
    dtype, dev = A.dtype, A.device
    if n <= b + 1:
        # already banded; no reflectors
        return A.clone(), A.new_zeros(K, n, n), A.new_zeros(K, n)

    # panels cover columns [0, n_cols): column c needs zeros below row c + b,
    # the last b + 1 columns have none
    n_cols = n - b - 1
    S = max(b, _cdiv(_cdiv(n, n_classes), b) * b)  # class granularity
    n_pad = _cdiv(n, S) * S
    Ap = A.new_zeros(K, n_pad, n_pad)
    Ap[:, :n, :n] = A
    V = A.new_zeros(K, n_pad, n_pad)
    taus = A.new_zeros(K, n_pad)
    tiny = eps_tiny(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    rows_full = torch.arange(n_pad, device=dev)

    q = 0
    while q < n_cols:
        m = n_pad - q  # the window is rows and columns [q, n_pad)
        Aw = Ap[:, q:, q:].contiguous()
        rows_w = rows_full[:m]
        real = rows_w + q < n
        for t in range(_cdiv(min(S, n_cols - q), b)):
            off = t * b  # window-relative panel start column

            # panel QR: Householders of the block below the band; updates
            # stay inside the (m, b) panel block C
            C = Aw[:, :, off:off + b].clone()
            Vp = A.new_zeros(K, m, b)
            tp = A.new_zeros(K, b)
            for j in range(b):
                c = off + j
                if q + c >= n_cols:
                    # past the last column to eliminate: tau = 0, v = 0 (an
                    # exact no-op on C)
                    break
                piv = c + b  # window-relative pivot row
                col = C[:, :, j]
                x = torch.where((rows_w > piv) & real, col, zero)
                alpha = col[:, piv]
                tau, denom, _, _ = reflector(alpha, (x * x).sum(1), tiny)
                v = x / denom[:, None]
                v[:, piv] = 1.0
                # (I - tau v v^T) on the whole panel block: columns < j are
                # zero below their own pivot, so they change by rounding on
                # exact zeros only; one product keeps the loop short
                w = (v[:, None, :] @ C)[:, 0]  # (K, b) = v^T C
                C -= (tau[:, None] * v)[:, :, None] * w[:, None, :]
                Vp[:, :, j] = v
                tp[:, j] = tau

            T = wy_factor(Vp.mT @ Vp, tp)

            # two-sided compact-WY update of the window:
            # A <- A - V W^T - W V^T with P = A V, S = V^T P, M = T^T S T,
            # W = P T - V M / 2. V is zero on rows < off + b, so rows above
            # the panel's pivot block take exactly the right-application
            # A (I - V T V^T) and earlier banded rows are untouched.
            P = Aw @ Vp
            M = T.mT @ (Vp.mT @ P) @ T
            W = P @ T - 0.5 * (Vp @ M)
            Aw = Aw - Vp @ W.mT - W @ Vp.mT

            V[:, q:, q + off:q + off + b] = Vp
            taus[:, q + off:q + off + b] = tp
        Ap[:, q:, q:] = Aw
        q += S

    # clear the numerically zeroed entries outside the band and symmetrize
    B = Ap[:, :n, :n]
    i = torch.arange(n, device=dev)
    band = (i[:, None] - i[None, :]).abs() <= b
    B = torch.where(band, (B + B.mT) * 0.5, zero)
    return B, V[:, :n, :n].contiguous(), taus[:, :n].contiguous()
