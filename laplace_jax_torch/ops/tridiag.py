"""Batched blocked Householder tridiagonalization (stage 1 of the two-stage
symmetric eigensolver) and the WY back-transform `apply_q`.

Port of `laplace_jax/ops/tridiag.py`. Conventions are the JAX package's:
`T = H_last ... H_0 A H_0 ... H_last` with `H_j = I - tau_j v_j v_j^T`,
`v_j` supported on rows `j+1..n-1` with its leading entry 1, `tau_j = 0`
for trivial reflectors; so `A = Q T Q^T` with `Q = H_0 H_1 ... H_last`.

Stage 1 walks the matrix in window classes: each class is a trailing
window `(K, m, m)` whose panels of `nb` columns run one LATRD panel each
(`panel_plain` here, or a CUDA panel kernel in `ops/latrd.py` /
`ops/latrd_v4.py`), followed by the rank-2nb trailing update
`Aw -= U^T W + W^T U`.

The panel contract (shared by every panel implementation):
`panel(Aw, off, q_base, n_real, nb) -> (UW (K, 2nb, m), det (K, 3, nb))`
for window-relative columns `c = off .. off+nb-1` of the window that starts
at global row `q_base`; `UW[:, j]` is reflector `v_j`, `UW[:, nb+j]` is
`w_j`, `det[:, :, j]` is `(d_c, e_c, tau_c)`. Rows at or past `n_real -
q_base` are padding. Columns whose global index is `>= n_real - 2` are
exact no-ops (`tau = 0`, `v = w = 0`).
"""

from __future__ import annotations

import torch

__all__ = ["tridiagonalize", "apply_q", "panel_plain", "panel_residual",
           "tridiagonalize_windows"]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def eps_tiny(dtype) -> float:
    """Threshold of the trivial-reflector test (the JAX package's)."""
    return 1e-290 if dtype == torch.float64 else torch.finfo(dtype).tiny * 1e4


def reflector(alpha: torch.Tensor, xnorm2: torch.Tensor, tiny: float):
    """The Householder reflector taking (alpha, x) to (beta, 0), as the JAX
    package forms it, from alpha and |x|^2: `(tau, denom, beta, trivial)`,
    with v = x / denom under a unit leading entry; where |x|^2 <= tiny
    |(alpha, x)|^2 it is the identity (tau = 0, denom = 1)."""
    anorm = torch.sqrt(alpha * alpha + xnorm2)
    sign = torch.where(alpha >= 0, 1.0, -1.0).to(alpha.dtype)
    beta = -sign * anorm
    trivial = xnorm2 <= tiny * anorm * anorm
    denom = torch.where(trivial, 1.0, alpha - beta)
    tau = torch.where(trivial, 0.0, (beta - alpha) / torch.where(trivial, 1.0, beta))
    return tau, denom, beta, trivial


def full_matvec(Aw: torch.Tensor):
    """`y = Aw v` per k."""
    return lambda v: (Aw @ v[:, :, None])[:, :, 0]


def lower_half_matvec(Aw: torch.Tensor):
    """`y = Aw v` per k from the lower triangle only (the symmetric-half
    form: `y = L v + L_strict^T v`)."""
    L = torch.tril(Aw)
    Ls = torch.tril(Aw, -1)
    return lambda v: (L @ v[:, :, None] + Ls.mT @ v[:, :, None])[:, :, 0]


def panel_plain(Aw, off: int, q_base: int, n_real: int, nb: int, matvec=None):
    """One LATRD panel in plain PyTorch (the contract in the module docstring)."""
    K, m, _ = Aw.shape
    dtype, dev = Aw.dtype, Aw.device
    matvec = full_matvec(Aw) if matvec is None else matvec
    UW = torch.zeros(K, 2 * nb, m, dtype=dtype, device=dev)
    U, W = UW[:, :nb], UW[:, nb:]
    det = torch.zeros(K, 3, nb, dtype=dtype, device=dev)
    rows = torch.arange(m, device=dev)
    valid = rows < n_real - q_base
    tiny = eps_tiny(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)
    for j in range(nb):
        c = off + j
        ok = c + q_base < n_real - 2
        # corrected column c = A[:, c] - U W^T[:, c] - W U^T[:, c]; the
        # window is symmetric, so row c is read instead of column c
        col = Aw[:, c, :] - torch.einsum("kq,kqi->ki", U[:, :, c], W) \
            - torch.einsum("kq,kqi->ki", W[:, :, c], U)
        col = torch.where(valid, col, zero)
        below = rows > c
        x = torch.where(below, col, zero)
        d_val = col[:, c]
        alpha = col[:, c + 1] if c + 1 < m else torch.zeros(K, dtype=dtype, device=dev)
        xnorm2 = ((x * x).sum(1) - alpha * alpha).clamp(min=0.0)
        tau, denom, beta, trivial = reflector(alpha, xnorm2, tiny)
        tau = tau if ok else torch.zeros_like(tau)
        e_val = torch.where(trivial, alpha, beta)
        v = torch.where(below, x / denom[:, None], zero)
        v = torch.where(rows == c + 1, 1.0, v) if ok else torch.zeros_like(v)
        # w = tau (A v - U (W^T v) - W (U^T v)) - 0.5 tau (w^T v) v
        Av = torch.where(below, matvec(v), zero)
        s = torch.einsum("kqi,ki->kq", U, v)
        t = torch.einsum("kqi,ki->kq", W, v)
        Av = Av - torch.einsum("kq,kqi->ki", t, U) - torch.einsum("kq,kqi->ki", s, W)
        w = tau[:, None] * Av
        w = w - (0.5 * tau * (w * v).sum(1))[:, None] * v
        w = torch.where(below, w, zero)
        U[:, j] = v
        W[:, j] = w
        det[:, 0, j], det[:, 1, j], det[:, 2, j] = d_val, e_val, tau
    return UW, det


def panel_residual(Aw, off: int, q_base: int, n_real: int, nb: int, UW, det) -> torch.Tensor:
    """How far one panel's outputs `(UW, det)` are from satisfying the
    contract's recurrences on `Aw`, per matrix, evaluated in float64 from
    the outputs themselves (column c corrected by their own earlier U, W).
    The largest of, over the panel's columns:

    - `|d_c - col_c[c]|`, `max |H_c x_c - e_c e_{c+1}|` (x_c: col_c below
      row c) and `max |w_c - w(v_c, tau_c)|`, each over `max |Aw|`;
    - `|tau_c v_c^T v_c / 2 - 1|` where `tau_c != 0` (a reflector);
    - `|v_c[c+1] - 1|`, and any entry of `v_c` or `w_c` where the contract
      has an exact zero.

    A correct float32 panel is within a few `m * eps` of zero here whatever
    the window's conditioning; its forward error against the exact panel is
    not, where the window's columns are nearly deflated."""
    A = Aw.double()
    K, m, _ = A.shape
    U, W = UW[:, :nb].double(), UW[:, nb:].double()
    d, e, tau = det.double().unbind(1)
    rows = torch.arange(m, device=A.device)
    valid = rows < n_real - q_base
    scale = torch.where(valid[:, None] & valid[None, :], A, 0.0).abs().amax((1, 2))
    scale = scale.clamp(min=torch.finfo(torch.float64).tiny)
    res = torch.zeros(K, dtype=torch.float64, device=A.device)
    for j in range(nb):
        c = off + j
        ok = c + q_base < n_real - 2
        Uj, Wj = U[:, :j], W[:, :j]
        col = A[:, c] - torch.einsum("kq,kqi->ki", Uj[:, :, c], Wj) \
            - torch.einsum("kq,kqi->ki", Wj[:, :, c], Uj)
        col = torch.where(valid, col, 0.0)
        below = rows > c
        v, w, t = U[:, j], W[:, j], tau[:, j]
        x = torch.where(below, col, 0.0)
        hx = x - (t * (v * x).sum(1))[:, None] * v - e[:, j, None] * (rows == c + 1)
        Av = torch.where(below, (A @ v[:, :, None])[:, :, 0], 0.0) \
            - torch.einsum("kq,kqi->ki", (Wj * v[:, None]).sum(2), Uj) \
            - torch.einsum("kq,kqi->ki", (Uj * v[:, None]).sum(2), Wj)
        w_ref = t[:, None] * Av
        w_ref = torch.where(below, w_ref - (0.5 * t * (w_ref * v).sum(1))[:, None] * v, 0.0)
        zero_v = ~below | ~valid if ok else torch.ones_like(below)
        terms = [(d[:, j] - col[:, c]).abs() / scale, hx.abs().amax(1) / scale,
                 (w - w_ref).abs().amax(1) / scale,
                 torch.where(t != 0, (t * (v * v).sum(1) / 2 - 1).abs(), 0.0),
                 torch.where(zero_v, v, 0.0).abs().amax(1)]
        if ok:
            terms.append((v[:, c + 1] - 1).abs())
        res = torch.maximum(res, torch.stack(terms).amax(0))
    return res


def tridiagonalize_windows(A: torch.Tensor, nb: int, S: int, panel):
    """Stage 1 over window classes of `S` rows with `nb`-column panels
    (`nb` divides `S`); `panel` follows the contract above. Returns
    `(d (K, n), e (K, n-1), V (K, n_pad, n), taus (K, n))`."""
    K, n, _ = A.shape
    dtype, dev = A.dtype, A.device
    n_pad = _cdiv(n, S) * S
    d = torch.zeros(K, n_pad, dtype=dtype, device=dev)
    e = torch.zeros(K, n_pad, dtype=dtype, device=dev)
    taus = torch.zeros(K, n_pad, dtype=dtype, device=dev)
    V = torch.zeros(K, n_pad, n_pad, dtype=dtype, device=dev)
    Aw = torch.zeros(K, n_pad, n_pad, dtype=dtype, device=dev)
    Aw[:, :n, :n] = A
    n_cols = n - 2
    q = 0
    while True:
        m = n_pad - q
        for t in range(_cdiv(min(S, n_cols - q), nb)):
            off = t * nb
            UW, det = panel(Aw, off, q, n, nb)
            U, W = UW[:, :nb], UW[:, nb:]
            g = q + off
            d[:, g : g + nb], e[:, g : g + nb], taus[:, g : g + nb] = det.unbind(1)
            V[:, q:, g : g + nb] = U.mT
            # rank-2nb trailing update Aw -= U^T W + W^T U (in place)
            Aw.baddbmm_(U.mT, W, alpha=-1).baddbmm_(W.mT, U, alpha=-1)
        if q + S >= n_cols:
            break
        Aw = Aw[:, S:, S:].contiguous()  # next class: the trailing window
        q += S
    # trailing 2x2 block, window-relative to the last class
    r = n - 2 - q
    d[:, n - 2] = Aw[:, r, r]
    d[:, n - 1] = Aw[:, r + 1, r + 1]
    e[:, n - 2] = Aw[:, r + 1, r]
    return d[:, :n], e[:, : n - 1], V[:, :, :n], taus[:, :n]


def tridiagonalize(A: torch.Tensor, nb: int = 64, n_classes: int = 8):
    """Plain stage 1 (the JAX package's XLA formulation): window classes of
    ~n/n_classes rows rounded to `nb`, plain panels."""
    K, n, _ = A.shape
    if n <= 2:
        return _tridiag_small(A)
    nb = max(8, min(nb, n))
    S = max(nb, _cdiv(_cdiv(n, n_classes), nb) * nb)
    return tridiagonalize_windows(A, nb, S, panel_plain)


def _tridiag_small(A):
    """n <= 2: already tridiagonal, no reflectors."""
    K, n, _ = A.shape
    d = torch.diagonal(A, dim1=1, dim2=2).clone()
    e = A[:, 1:, 0].reshape(K, n - 1) if n == 2 else A.new_zeros(K, 0)
    return d, e, A.new_zeros(K, n, n), A.new_zeros(K, n)


def wy_factor(G: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """The forward compact-WY factor of a block of reflectors:
    `T[j, j] = tau_j`, `T[:j, j] = -tau_j T[:j, :j] (V^T v_j)[:j]`, from the
    Gram matrix `G = V^T V` (..., r, r) and `taus` (..., r)."""
    r = taus.shape[-1]
    T = torch.zeros_like(G)
    for j in range(r):
        if j:
            T[..., :j, j] = -taus[..., j, None] * (T[..., :j, :j] @ G[..., :j, j, None])[..., 0]
        T[..., j, j] = taus[..., j]
    return T


def apply_q(V: torch.Tensor, taus: torch.Tensor, S: torch.Tensor, nb: int = 64):
    """`Q @ S` with `Q = H_0 H_1 ... H_{n-3}` from stage 1; `S` is (K, n, c).

    Compact WY per block of `nb` reflectors, applied last block first:
    `P S = S - V T (V^T S)`. All blocks' T factors are built together by
    the forward recurrence over the `nb` in-block columns.
    """
    K, n_pad, n = V.shape
    dtype, dev = V.dtype, V.device
    out = torch.zeros(K, n_pad, S.shape[-1], dtype=dtype, device=dev)
    out[:, :n] = S
    n_cols = max(n - 2, 0)
    if n_cols == 0:
        return out[:, :n]
    n_blocks = _cdiv(n_cols, nb)
    ncp = n_blocks * nb
    Vp = torch.zeros(K, n_pad, ncp, dtype=dtype, device=dev)
    Vp[:, :, :n_cols] = V[:, :, :n_cols]
    tp = torch.zeros(K, ncp, dtype=dtype, device=dev)
    tp[:, :n_cols] = taus[:, :n_cols]
    Vb = Vp.reshape(K, n_pad, n_blocks, nb).permute(2, 0, 1, 3)  # (b, K, n_pad, nb)
    G = Vb.mT @ Vb  # (b, K, nb, nb)
    T = wy_factor(G, tp.reshape(K, n_blocks, nb).permute(1, 0, 2))  # (b, K, nb, nb)
    for b in reversed(range(n_blocks)):
        out = out - Vb[b] @ (T[b] @ (Vb[b].mT @ out))
    return out[:, :n]
