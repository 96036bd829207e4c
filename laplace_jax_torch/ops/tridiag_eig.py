"""Batched tridiagonal divide-and-conquer (stage 2) and the full two-stage
driver `eigh_stack_ts` (port of `laplace_jax/ops/tridiag_eig.py`).

Stage 2 is Cuppen's splitting with all rank-one corrections up front, a
batched round-robin Jacobi base case, and merges with branchless LAPACK
laed2/laed3-style deflation, an origin-selected bisection + Newton secular
solver and the Gu-Eisenstat z-recomputation; float32 vectors are
re-orthonormalized by QR where the JAX package uses CholeskyQR2
(`_orthonormalize` says why). Everything is batched over
the K factors of one size. Python loops take the place of the JAX
package's `fori_loop`s.

`eigh_stack_ts` picks stage 1 as the JAX package does: on CUDA the LATRD
panel kernel (`ops/latrd.py`) for 512 <= n < 2304 and the symmetric-half
kernel (`ops/latrd_v4.py`) for n >= 2304, otherwise the plain stage 1. The
v3 and v2 kernels (`ops/latrd_v3.py`, `ops/latrd_v2.py`) run only when
asked for by name, as their JAX counterparts are never picked
automatically.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from laplace_jax_torch.ops.latrd import tridiagonalize_latrd
from laplace_jax_torch.ops.latrd_v2 import tridiagonalize_latrd_v2
from laplace_jax_torch.ops.latrd_v3 import tridiagonalize_latrd_v3
from laplace_jax_torch.ops.latrd_v4 import tridiagonalize_latrd_v4
from laplace_jax_torch.ops.tridiag import apply_q, tridiagonalize
from laplace_jax_torch.utils.device import full_f32_matmuls, resolve_device

__all__ = ["tridiag_eigh", "eigh_stack_ts"]

# the JAX package's defaults: D&C leaves of <= 48 rows, 12 Jacobi sweeps on
# them, 40 bisection steps then >= 10 Newton / fixed-point steps per root
BASE_SIZE = 48
JACOBI_SWEEPS = 12
BISECT_ITERS = 40
REFINE_ITERS = 10


def _round_robin_schedule(m: int) -> np.ndarray:
    """(m-1) rounds of m/2 disjoint pairs covering all pairs once (m even)."""
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        rounds.append([(min(players[i], players[m - 1 - i]),
                        max(players[i], players[m - 1 - i])) for i in range(m // 2)])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int64)


def _jacobi_eigh(A: torch.Tensor):
    """Batched cyclic Jacobi for small symmetric blocks (B, m, m): each
    tournament round rotates all disjoint pairs of all blocks at once.
    Returns ascending (vals (B, m), vecs (B, m, m))."""
    B, m, _ = A.shape
    dtype, dev = A.dtype, A.device
    if m == 1:
        return A[:, :, 0], torch.ones(B, 1, 1, dtype=dtype, device=dev)
    mp = m + (m % 2)
    if mp != m:  # pad with a decoupled zero row/col
        A = torch.nn.functional.pad(A, (0, 1, 0, 1))
    sched = torch.as_tensor(_round_robin_schedule(mp), device=dev)
    eye = torch.eye(mp, dtype=dtype, device=dev).expand(B, mp, mp)
    tiny = torch.finfo(dtype).tiny * 1e6
    cap = 1.0 / math.sqrt(torch.finfo(dtype).eps)
    V = eye.clone()
    for _ in range(JACOBI_SWEEPS):
        for r in range(sched.shape[0]):
            p, q = sched[r, :, 0], sched[r, :, 1]
            app, aqq, apq = A[:, p, p], A[:, q, q], A[:, p, q]
            zero = apq.abs() <= tiny
            tau = (aqq - app) / torch.where(zero, 1.0, 2.0 * apq)
            tau_c = tau.clamp(-cap, cap)
            t = torch.sign(tau_c) / (tau_c.abs() + torch.sqrt(1.0 + tau_c * tau_c))
            t = torch.where(tau.abs() > cap, 0.5 / tau, t)
            t = torch.where(tau == 0, 1.0, t)
            c = 1.0 / torch.sqrt(1.0 + t * t)
            s = t * c
            c = torch.where(zero, 1.0, c)
            s = torch.where(zero, 0.0, s)
            Rm = eye.clone()
            Rm[:, p, p] = c
            Rm[:, q, q] = c
            Rm[:, p, q] = s
            Rm[:, q, p] = -s
            A = Rm.mT @ A @ Rm
            V = V @ Rm
    vals = torch.diagonal(A, dim1=1, dim2=2)[:, :m]
    order = torch.argsort(vals, dim=1, stable=True)
    vals = torch.gather(vals, 1, order)
    V = torch.gather(V[:, :m, :m], 2, order[:, None, :].expand(B, m, m))
    return vals, V


def _suffix_min(x: torch.Tensor) -> torch.Tensor:
    return torch.cummin(x.flip(-1), dim=-1).values.flip(-1)


def _merge_level(D, U, rho, z):
    """One D&C merge: eigendecompose diag(D) + rho z z^T with the children's
    bases folded into U (B, M, M). Returns ascending (lam, U @ G)."""
    B, M = D.shape
    dtype, dev = D.dtype, D.device
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny * 1e8
    iota = torch.arange(M, device=dev)

    # ---- sort poles
    perm = torch.argsort(D, dim=1, stable=True)
    ds = torch.gather(D, 1, perm)
    zs = torch.gather(z, 1, perm)
    Up = torch.gather(U, 2, perm[:, None, :].expand(B, M, M))

    zn2 = (zs * zs).sum(1)
    scale = torch.maximum(ds.abs().amax(1), rho * zn2).clamp(min=tiny)
    tol_gap = (8.0 * eps) * scale

    # ---- runs of nearly-equal poles
    close = (ds[:, 1:] - ds[:, :-1]) <= tol_gap[:, None]
    true_col = torch.ones(B, 1, dtype=torch.bool, device=dev)
    is_first = torch.cat([true_col, ~close], 1)
    is_last = torch.cat([~close, true_col], 1)
    rs = torch.cummax(torch.where(is_first, iota, -1), dim=1).values
    rl = _suffix_min(torch.where(is_last, iota, M))

    c = torch.cumsum(zs * zs, 1)
    c_before = torch.where(rs > 0, torch.gather(c, 1, (rs - 1).clamp(min=0)), 0.0)
    a = torch.sqrt((c - c_before).clamp(min=0.0))

    singleton = rs == rl
    surv = iota[None, :] == rl
    z_eff = torch.where(surv, torch.where(singleton, zs, a), 0.0)
    a_last = torch.gather(a, 1, rl)
    # deflation criterion linear in z (LAPACK laed2)
    active = surv & (rho[:, None] * z_eff.abs() * torch.sqrt(zn2)[:, None]
                     > tol_gap[:, None])
    z2 = torch.where(active, z_eff * z_eff, 0.0)
    zn2_act = z2.sum(1)

    # ---- secular brackets
    suf = _suffix_min(torch.where(active, iota, M))
    nxt = torch.cat([suf[:, 1:], torch.full((B, 1), M, device=dev)], 1)
    has_up = nxt < M
    d_up = torch.gather(ds, 1, nxt.clamp(max=M - 1))
    top = ds + (rho * zn2_act)[:, None] + tol_gap[:, None]
    d_up = torch.where(has_up, d_up, top)
    gap = (d_up - ds).clamp(min=tiny)

    rho_b = rho[:, None, None]
    mask = z2[:, :, None] > 0

    def f_eval(Dg, mu):
        """Secular f(lambda), f'(lambda) with lambda = d_origin + mu."""
        denom = Dg - mu[:, None, :]
        denom = torch.where(denom == 0, tiny, denom)
        t1 = torch.where(mask, rho_b * z2[:, :, None] / denom, 0.0)
        t2 = torch.where(mask, t1 / denom, 0.0)
        return 1.0 + t1.sum(1), t2.sum(1)

    # origin selection: root in the upper half of the gap => upper pole
    f_mid, _ = f_eval(ds[:, :, None] - ds[:, None, :], 0.5 * gap)
    use_up = (f_mid < 0) & has_up
    origin = torch.where(use_up, nxt, iota[None, :])
    d_o = torch.gather(ds, 1, origin)
    Dg = ds[:, :, None] - d_o[:, None, :]

    zeros = torch.zeros_like(gap)
    lo = torch.where(use_up, -0.5 * gap, zeros)
    hi = torch.where(use_up, zeros, torch.where(has_up, 0.5 * gap, gap))
    for _ in range(BISECT_ITERS):
        mu = 0.5 * (lo + hi)
        neg = f_eval(Dg, mu)[0] < 0
        lo, hi = torch.where(neg, mu, lo), torch.where(neg, hi, mu)
    mu = 0.5 * (lo + hi)

    # pole-dominant fixed point (laed4's rational model), Newton, halving
    z2_o = torch.gather(z2, 1, origin)
    best_mu, best_af = mu, torch.full_like(mu, math.inf)
    for _ in range(REFINE_ITERS):
        f, fp = f_eval(Dg, mu)
        af = f.abs()
        better = af < best_af
        best_mu = torch.where(better, mu, best_mu)
        best_af = torch.where(better, af, best_af)
        neg = f < 0
        lo, hi = torch.where(neg, mu, lo), torch.where(neg, hi, mu)
        mu_safe = torch.where(mu == 0, tiny, mu)
        s_rest = f - 1.0 + rho[:, None] * z2_o / mu_safe
        denom = 1.0 + s_rest
        mu_fp = rho[:, None] * z2_o / torch.where(denom == 0, tiny, denom)
        mu_nt = mu - f / fp.clamp(min=tiny)
        good_fp = (mu_fp >= lo) & (mu_fp <= hi)
        good_nt = (mu_nt >= lo) & (mu_nt <= hi)
        mu = torch.where(good_fp, mu_fp, torch.where(good_nt, mu_nt, 0.5 * (lo + hi)))
    f_fin, _ = f_eval(Dg, mu)
    mu = torch.where(f_fin.abs() <= best_af, mu, best_mu)
    lam = torch.where(active, d_o + mu, ds)

    # ---- Gu-Eisenstat z-hat over ACTIVE r
    num = mu[:, None, :] - Dg  # lam_r - d_t (rows t, cols r)
    den = ds[:, None, :] - ds[:, :, None]  # d_r - d_t
    off_diag = iota[None, :, None] != iota[None, None, :]
    act_r = active[:, None, :]
    ratio = torch.where(act_r & off_diag,
                        num / torch.where(den == 0, tiny, den), 1.0)
    diag_fac = torch.where(active, mu + (d_o - ds), 1.0)
    zhat2 = torch.prod(ratio, dim=2) * diag_fac
    zhat = torch.where(active, torch.sign(z_eff) * torch.sqrt(zhat2.clamp(min=0.0)), 0.0)

    # ---- eigenvector columns
    w = torch.where(act_r & mask, zhat[:, :, None] / torch.where(num == 0, tiny, -num), 0.0)
    w = w / torch.sqrt((w * w).sum(1).clamp(min=tiny))[:, None, :]
    smear = torch.where(singleton, 1.0, zs / a_last.clamp(min=tiny))
    # row t takes the run-last row of w (a gather; the JAX package uses a
    # one-hot matmul because gathers are slow on the TPU)
    w_runlast = torch.gather(w, 1, rl[:, :, None].expand(B, M, M))
    G_act = smear[:, :, None] * w_runlast

    # deflated run-member columns (closed form)
    j_col = iota[None, None, :]
    t_row = iota[None, :, None]
    in_seg = (t_row >= rs[:, None, :]) & (t_row <= j_col)
    z_next = torch.cat([zs[:, 1:], torch.zeros(B, 1, dtype=dtype, device=dev)], 1)
    a_next = torch.cat([a[:, 1:], torch.ones(B, 1, dtype=dtype, device=dev)], 1)
    denom_run = (a[:, None, :] * a_next[:, None, :]).clamp(min=tiny)
    body = zs[:, :, None] * z_next[:, None, :] / denom_run
    tail = -(a / a_next.clamp(min=tiny))[:, None, :]
    G_defl = torch.where(in_seg, body, 0.0)
    G_defl = torch.where(t_row == j_col + 1, tail, G_defl)
    degen = (a[:, None, :] <= tiny) | (a_next[:, None, :] <= tiny)
    eye_col = (t_row == j_col).to(dtype)
    G_defl = torch.where(degen, eye_col, G_defl)
    G = torch.where(active[:, None, :], G_act,
                    torch.where(~surv[:, None, :], G_defl, eye_col))
    U_new = Up @ G

    order = torch.argsort(lam, dim=1, stable=True)
    lam = torch.gather(lam, 1, order)
    U_new = torch.gather(U_new, 2, order[:, None, :].expand(B, M, M))
    return lam, U_new


def _orthonormalize(V: torch.Tensor) -> torch.Tensor:
    """Restore orthonormality of f32 eigenvector columns (ascending
    eigenvalues): Householder QR of the columns in descending-eigenvalue
    order, signs kept.

    The JAX package applies CholeskyQR2 here. On KFAC factors f32 secular
    noise can leave two columns of a cluster of numerically-zero eigenvalues
    (nearly) equal; their Gram is then not positive definite and the
    Cholesky fails (NaN on the JAX side, which sends the factor to the
    `symeig` retry). QR works for any columns: the well-separated
    large-eigenvalue columns come first and move only by their
    orthogonality error, and a dependent cluster column becomes the
    complement of all columns before it, which lies in its cluster.
    """
    Q, R = torch.linalg.qr(V.flip(-1))
    sign = torch.where(torch.diagonal(R, dim1=-2, dim2=-1) < 0, -1.0, 1.0).to(V.dtype)
    return (Q * sign.unsqueeze(-2)).flip(-1)


def tridiag_eigh(d: torch.Tensor, e: torch.Tensor):
    """Eigendecompose a batch of symmetric tridiagonals (Cuppen D&C).

    d (K, n) diagonals, e (K, n-1) sub-diagonals. Returns ascending
    (vals (K, n), vecs (K, n, n))."""
    K, n = d.shape
    dtype, dev = d.dtype, d.device
    if n == 1:
        return d, torch.ones(K, 1, 1, dtype=dtype, device=dev)
    if n <= BASE_SIZE:
        T = torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
        return _jacobi_eigh(T)

    L = max(1, math.ceil(math.log2(n / BASE_SIZE)))
    m0 = -(-n // (1 << L))
    n_pad = m0 << L

    # pad: decoupled large distinct diagonal entries sort last
    e_pad = torch.zeros(K, n_pad, dtype=dtype, device=dev)
    e_pad[:, : n - 1] = e
    bnd = d.abs().amax(1) + 4.0 * e.abs().amax(1) + 1.0
    pad_j = torch.arange(n_pad - n, dtype=dtype, device=dev)
    pad_vals = bnd[:, None] * (1.001 + 1e-3 * pad_j[None, :]) + pad_j
    dhat = torch.cat([d, pad_vals], 1)

    # Cuppen corrections: every multiple of m0 splits exactly one merge
    bounds = torch.arange(m0, n_pad, m0, device=dev)
    abs_be = e_pad[:, bounds - 1].abs()
    dhat[:, bounds - 1] -= abs_be
    dhat[:, bounds] -= abs_be

    S0 = n_pad // m0
    eb = e_pad.reshape(K, S0, m0)[:, :, : m0 - 1]
    T = (torch.diag_embed(dhat.reshape(K, S0, m0)) + torch.diag_embed(eb, 1)
         + torch.diag_embed(eb, -1))
    vals, vecs = _jacobi_eigh(T.reshape(K * S0, m0, m0))
    D = vals.reshape(K, S0, m0)
    U = vecs.reshape(K, S0, m0, m0)

    m = m0
    while m < n_pad:
        S = D.shape[1] // 2
        M2 = 2 * m
        p_idx = (2 * torch.arange(S, device=dev) + 1) * m - 1
        e_sel = e_pad[:, p_idx]
        rho = e_sel.abs()
        Upr = U.reshape(K, S, 2, m, m)
        z = torch.cat([torch.sign(e_sel)[..., None] * Upr[:, :, 0, m - 1, :],
                       Upr[:, :, 1, 0, :]], -1)
        Ucat = torch.zeros(K, S, M2, M2, dtype=dtype, device=dev)
        Ucat[:, :, :m, :m] = Upr[:, :, 0]
        Ucat[:, :, m:, m:] = Upr[:, :, 1]
        lam, U_new = _merge_level(
            D.reshape(K * S, M2), Ucat.reshape(K * S, M2, M2),
            rho.reshape(K * S), z.reshape(K * S, M2),
        )
        D = lam.reshape(K, S, M2)
        U = U_new.reshape(K, S, M2, M2)
        m = M2

    Uf = U[:, 0, :n, :n]
    if dtype == torch.float32:
        # f32 secular noise breaks Gu-Eisenstat orthogonality inside
        # near-degenerate clusters
        Uf = _orthonormalize(Uf)
    return D[:, 0, :n], Uf


# stage-1 drivers by name: the CUDA panel kernels and the plain stage 1
STAGE1 = {"latrd": tridiagonalize_latrd, "latrd_v4": tridiagonalize_latrd_v4,
          "latrd_v3": tridiagonalize_latrd_v3, "latrd_v2": tridiagonalize_latrd_v2,
          "plain": tridiagonalize}


def _stage1_impl(n: int, stage1: str, device: torch.device) -> str:
    """Stage-1 implementation, a name in `STAGE1`; "auto" follows the JAX
    package's thresholds on CUDA (v1 for 512 <= n < 2304, v4 above) and
    takes "plain" elsewhere."""
    if stage1 != "auto":
        return stage1
    if device.type != "cuda" or n < 512:
        return "plain"
    return "latrd_v4" if n >= 2304 else "latrd"


def eigh_stack_ts(stack: torch.Tensor, nb: int = 64, stage1: str = "auto", device=None):
    """Two-stage symmetric eigendecomposition of a (k, n, n) stack: blocked
    Householder tridiagonalization -> batched secular D&C -> WY
    back-transform. Ascending eigenvalues, orthonormal eigenvectors.

    Runs on `device` (CUDA unless the caller asks for the CPU). `stage1`:
    "auto" or a name in `STAGE1` ("latrd", "latrd_v4", "latrd_v3",
    "latrd_v2", "plain"); the kernel routes take their plain PyTorch panels
    when the stack lies on the CPU.
    """
    dev = resolve_device(device)
    stack = stack.to(dev)
    full_f32_matmuls()
    n = stack.shape[-1]
    impl = _stage1_impl(n, stage1, dev)
    if impl not in STAGE1:
        raise ValueError(f"Unknown stage1 {stage1!r}.")
    d, e, V, taus = STAGE1[impl](stack, nb=nb)
    lam, Ut = tridiag_eigh(d, e)
    return lam, apply_q(V, taus, Ut, nb=nb)
