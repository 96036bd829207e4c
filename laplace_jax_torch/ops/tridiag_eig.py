"""Batched tridiagonal divide-and-conquer (stage 2) and the full two-stage
driver `eigh_stack_ts` (port of `laplace_jax/ops/tridiag_eig.py`).

Stage 2 is Cuppen's splitting with all rank-one corrections up front, a
batched round-robin Jacobi base case, and merges with branchless LAPACK
laed2/laed3-style deflation, an origin-selected bisection + Newton secular
solver and the Gu-Eisenstat z-recomputation. Two departures from the JAX
package in float32: a merge solves its secular equation in float64
(`_merge_level` says why), and the vectors are polished by one
Newton-Schulz step in float64 where the JAX package uses CholeskyQR2
(`_orthonormalize` says why).
Everything is batched over the K factors of one size. Python loops take
the place of the JAX package's `fori_loop`s; on CUDA the Jacobi leaves are
one launch of `csrc/jacobi_leaves.cu` a call instead (`_jacobi_eigh`), and
a merge level's secular roots one launch of `csrc/secular.cu` (`_secular`).
The spans `decompose.stage2` and its `.leaves`, `.merge` (each level) and
`.orthonormalize`, and `decompose.stage1` and `decompose.back_transform` in
`eigh_stack_ts`, time the stages, and the counters
`decompose.stage2.leaf_launches` and `decompose.stage2.secular_launches`
count the two kernels' launches (`utils/spans.py`).

`eigh_stack_ts` picks stage 1 as the JAX package does: on CUDA the LATRD
panel kernel (`ops/latrd.py`) for 512 <= n < 2304 and the symmetric-half
kernel (`ops/latrd_v4.py`) for n >= 2304, otherwise the plain stage 1. The
v3 and v2 kernels (`ops/latrd_v3.py`, `ops/latrd_v2.py`) run only when
asked for by name, as their JAX counterparts are never picked
automatically; the environment variable `LAPLACE_TS_STAGE1` overrides the
choice with v1, v4 or the plain stage 1, as in the JAX package.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.latrd import tridiagonalize_latrd
from laplace_jax_torch.ops.latrd_v2 import tridiagonalize_latrd_v2
from laplace_jax_torch.ops.latrd_v3 import tridiagonalize_latrd_v3
from laplace_jax_torch.ops.latrd_v4 import tridiagonalize_latrd_v4
from laplace_jax_torch.ops.tridiag import apply_q, tridiagonalize
from laplace_jax_torch.utils import spans
from laplace_jax_torch.utils.device import full_f32, resolve_device

__all__ = ["tridiag_eigh", "eigh_stack_ts"]

# the JAX package's defaults: D&C leaves of <= 48 rows, 12 Jacobi sweeps on
# them, 40 bisection steps then >= 10 Newton / fixed-point steps per root
BASE_SIZE = 48
JACOBI_SWEEPS = 12
BISECT_ITERS = 40
REFINE_ITERS = 10
# a merge level's float64 temporaries are (tridiagonals, M, M): a stack is
# merged in chunks of tridiagonals whose one such temporary, at the last
# level, stays within this many bytes (a 147-deep stack of n = 2048, or
# n = 10,944, would otherwise want tens of GB)
MERGE_CHUNK_BYTES = 1 << 30
# largest max |VᵀV - I| of a float32 basis that `_orthonormalize` polishes;
# a factor beyond it comes back as NaN for the `symeig` retry
ORTH_GUARD = 1e-4


def _round_robin_schedule(m: int) -> np.ndarray:
    """(m-1) rounds of m/2 disjoint pairs covering all pairs once (m even)."""
    players = list(range(m))
    rounds = []
    for _ in range(m - 1):
        rounds.append([(min(players[i], players[m - 1 - i]),
                        max(players[i], players[m - 1 - i])) for i in range(m // 2)])
        players = [players[0]] + [players[-1]] + players[1:-1]
    return np.asarray(rounds, dtype=np.int64)


def _round_robin_pair(m: int, r: int, i: int) -> tuple:
    """Slot i of round r of `_round_robin_schedule(m)` in closed form, as
    the leaves' kernel (`csrc/jacobi_leaves.cu`, `pair_of`) computes it:
    player 0 stays, the others turn one place a round."""
    n = m - 1
    a = 0 if i == 0 else 1 + (i - 1 - r) % n
    b = 1 + (n - 1 - i - r) % n
    return min(a, b), max(a, b)


@spans.span("decompose.stage2.leaves")
def _jacobi_eigh(A: torch.Tensor):
    """Eigendecompose small symmetric blocks A (B, m, m), m <= `BASE_SIZE`:
    ascending (vals (B, m), vecs (B, m, m)). On a CUDA tensor one launch of
    `csrc/jacobi_leaves.cu` (a block per leaf, every sweep in shared
    memory); on a CPU tensor `_jacobi_eigh_plain`. A CUDA tensor the kernel
    does not take raises. `_jacobi_eigh.launches` counts the launches, and
    the counter `decompose.stage2.leaf_launches` too while recording."""
    if A.device.type == "cpu":
        return _jacobi_eigh_plain(A)
    if A.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"Jacobi leaves kernel takes float32/float64, got {A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2] or not A.is_contiguous():
        raise ValueError(f"Jacobi leaves kernel takes a contiguous (B, m, m) stack, got "
                         f"{tuple(A.shape)} contiguous={A.is_contiguous()}")
    B, m, _ = A.shape
    if m > BASE_SIZE or B >= 2**31:
        raise ValueError(f"Jacobi leaves kernel takes m <= {BASE_SIZE} and B < 2**31, "
                         f"got {tuple(A.shape)}")
    if m == 1:
        return A[:, :, 0], torch.ones(B, 1, 1, dtype=A.dtype, device=A.device)
    vals = torch.empty(B, m, dtype=A.dtype, device=A.device)
    vecs = torch.empty(B, m, m, dtype=A.dtype, device=A.device)
    if B == 0:
        return vals, vecs
    lib = _build.load("jacobi_leaves")
    fn = lib.jacobi_leaves_f32 if A.dtype == torch.float32 else lib.jacobi_leaves_f64
    rc = fn(A.data_ptr(), vals.data_ptr(), vecs.data_ptr(), B, m, JACOBI_SWEEPS,
            torch.cuda.current_stream(A.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Jacobi leaves launch failed: {lib.error_string(rc).decode()}")
    _jacobi_eigh.launches += 1
    spans.count("decompose.stage2.leaf_launches")
    return vals, vecs


_jacobi_eigh.launches = 0


def _jacobi_eigh_plain(A: torch.Tensor):
    """Batched cyclic Jacobi for small symmetric blocks (B, m, m) in plain
    PyTorch: each tournament round rotates all disjoint pairs of all blocks
    at once. Returns ascending (vals (B, m), vecs (B, m, m))."""
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


def _secular(ds, z2, rho, gap, nxt, tiny: float):
    """The secular roots of a merge level: for root r of merge b (ds (B, M)
    ascending, z2 = 0 at a deflated pole, rho (B,), the bracket `gap` and
    the next active pole `nxt` (M where none) from `_merge_level`), the
    origin pole (r, or nxt[r] where the root lies in the upper half of its
    gap) and mu, the root's offset from that pole, in float64: the origin
    choice, `BISECT_ITERS` bisection and `REFINE_ITERS` refinement steps and
    a final check, 52 evaluations of the secular function.

    On a CUDA tensor one launch of `csrc/secular.cu` (a root per group of
    lanes, the poles in shared memory, every evaluation in one launch); on
    a CPU tensor `_secular_plain`. A CUDA tensor the kernel does not take
    raises. `_secular.launches` counts the launches, and the counter
    `decompose.stage2.secular_launches` too while recording."""
    if ds.device.type == "cpu":
        return _secular_plain(ds, z2, rho, gap, nxt, tiny)
    B, M = ds.shape
    for name, t in (("ds", ds), ("z2", z2), ("gap", gap), ("rho", rho)):
        if t.dtype != torch.float64:
            raise TypeError(f"secular kernel takes float64 {name}, got {t.dtype}")
    if nxt.dtype != torch.int64:
        raise TypeError(f"secular kernel takes int64 nxt, got {nxt.dtype}")
    shapes_ok = (ds.ndim == 2 and all(tuple(t.shape) == (B, M) for t in (z2, gap, nxt))
                 and tuple(rho.shape) == (B,))
    if not shapes_ok or M < 1 or not all(t.is_contiguous() and t.device == ds.device
                                         for t in (ds, z2, rho, gap, nxt)):
        raise ValueError("secular kernel takes contiguous ds, z2, gap, nxt (B, M) and rho (B,) "
                         f"on one device, got {tuple(ds.shape)}, {tuple(z2.shape)}, "
                         f"{tuple(gap.shape)}, {tuple(nxt.shape)}, {tuple(rho.shape)}")
    mu = torch.empty_like(ds)
    origin = torch.empty_like(nxt)
    if B == 0:
        return mu, origin
    lib = _build.load("secular")
    rc = lib.secular_f64(ds.data_ptr(), z2.data_ptr(), rho.data_ptr(), gap.data_ptr(),
                         nxt.data_ptr(), mu.data_ptr(), origin.data_ptr(), B, M, tiny,
                         torch.cuda.current_stream(ds.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"secular launch failed: {lib.error_string(rc).decode()}")
    _secular.launches += 1
    spans.count("decompose.stage2.secular_launches")
    return mu, origin


_secular.launches = 0


def _secular_plain(ds, z2, rho, gap, nxt, tiny: float):
    """`_secular` in plain PyTorch: each evaluation of the secular function
    over all (pole, root) pairs of the level at once, as float64 (B, M, M)
    temporaries. Returns (mu, origin)."""
    B, M = ds.shape
    iota = torch.arange(M, device=ds.device)
    has_up = nxt < M
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
    return mu, origin


@spans.span("decompose.stage2.merge")
def _merge_level(D, U, rho, z):
    """One D&C merge: eigendecompose diag(D) + rho z z^T with the children's
    bases folded into U (B, M, M). Returns ascending (lam, U @ G).

    A float32 merge solves its secular equation and builds G in float64
    (the product U @ G stays float32): in float32 a root can settle a
    hundred ulps off, and its vector with it."""
    B, M = D.shape
    out_dtype = D.dtype
    if out_dtype == torch.float32:
        D, rho, z = D.double(), rho.double(), z.double()
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

    # ---- secular roots: lam = d_origin + mu
    mu, origin = _secular(ds, z2, rho, gap, nxt, tiny)
    d_o = torch.gather(ds, 1, origin)
    Dg = ds[:, :, None] - d_o[:, None, :]
    mask = z2[:, :, None] > 0
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
    # a run whose survivor deflates (z negligible on the whole run) is not
    # rotated: each pole keeps its own vector, as a small-z deflation does.
    # (The JAX package rotates its members all the same and gives the
    # survivor e_j, which repeats a member's column when z's weight is not
    # on the run's last pole.)
    rotated = ~surv & torch.gather(active, 1, rl)
    G = torch.where(active[:, None, :], G_act,
                    torch.where(rotated[:, None, :], G_defl, eye_col))
    U_new = Up @ G.to(out_dtype)

    order = torch.argsort(lam, dim=1, stable=True)
    lam = torch.gather(lam, 1, order).to(out_dtype)
    U_new = torch.gather(U_new, 2, order[:, None, :].expand(B, M, M))
    return lam, U_new


@spans.span("decompose.stage2.orthonormalize")
def _orthonormalize(V: torch.Tensor) -> torch.Tensor:
    """Restore orthonormality of a (K, n, n) stack of float32 eigenvector
    columns by one Newton-Schulz (polar) step, V - V E / 2 with E = VᵀV - I:
    two batched float64 GEMMs, rounded once to V's dtype. Column order and
    signs stay; V moves only by its own deviation, to the nearest
    orthonormal basis up to O(E²). A factor whose max |E| is not within
    `ORTH_GUARD` comes back as NaN, which `Kron.decompose`'s flags send to
    the `symeig` retry, as the JAX package's CholeskyQR2 sends a failed
    Cholesky; no value is read on the host.

    The Gram is formed in float64 because in float32 its own rounding
    (about √n ε₃₂) is as large as E; the product runs in float64 too, which
    the H100 did faster than in float32 (0.46 against 0.49 s over the
    reward cell's classes). The step needs nearly orthonormal columns. The
    float32 secular noise that made the port use Householder QR here went
    with the float64 merges (`_merge_level`): over every class of the
    ResNet-18 and DeepSeek-V2-Lite fits on an H100, stage 2's float32
    vectors deviate by 5.2e-6 to 1.04e-5 before the polish (5.5e-6 to
    6.2e-6 on the CPU tests' cases) and leave it below 1e-7, where the QR
    left 8.0e-7 to 1.8e-6. A factor of very low rank (an expert's
    output-gradient factor with 4 to 6 nonzero eigenvalues of 1408, say)
    still, in about one reward fit of four, comes out with a pair of
    columns 4.5e-3 to 0.11 from orthonormal, which one step leaves at
    1.5e-5 to 1e-2; the next-worst factors read 2.1e-5 to 2.3e-5, which it
    takes to 6e-8. `ORTH_GUARD` (1e-4) lies between the two: one step
    leaves about (3/4) E² behind, so below it the basis comes out near
    float32's working precision, and above it the factor is retried.
    """
    V64 = V.double()
    E = V64.mT @ V64
    E.diagonal(dim1=-2, dim2=-1).sub_(1.0)
    within = E.abs().amax((-2, -1)) <= ORTH_GUARD  # False for NaN too
    V1 = torch.baddbmm(V64, V64, E, alpha=-0.5).to(V.dtype)
    return torch.where(within[:, None, None], V1, torch.nan)


def _merge_sizes(n: int) -> tuple:
    """(leaf size, padded size) of the D&C tree of an n-row tridiagonal:
    leaves of at most `BASE_SIZE` rows, doubled at each level."""
    L = max(1, math.ceil(math.log2(n / BASE_SIZE)))
    m0 = -(-n // (1 << L))
    return m0, m0 << L


@spans.span("decompose.stage2")
def tridiag_eigh(d: torch.Tensor, e: torch.Tensor):
    """Eigendecompose a batch of symmetric tridiagonals (Cuppen D&C).

    d (K, n) diagonals, e (K, n-1) sub-diagonals. Returns ascending
    (vals (K, n), vecs (K, n, n)). Above `BASE_SIZE` rows the stack goes
    in chunks of at most `MERGE_CHUNK_BYTES` per merge temporary."""
    K, n = d.shape
    if n > BASE_SIZE:
        step = max(1, MERGE_CHUNK_BYTES // (8 * _merge_sizes(n)[1] ** 2))
        if K > step:
            parts = [_tridiag_eigh(d[i:i + step], e[i:i + step]) for i in range(0, K, step)]
            return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])
    return _tridiag_eigh(d, e)


def _tridiag_eigh(d: torch.Tensor, e: torch.Tensor):
    K, n = d.shape
    dtype, dev = d.dtype, d.device
    if n == 1:
        return d, torch.ones(K, 1, 1, dtype=dtype, device=dev)
    if n <= BASE_SIZE:
        T = torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
        return _jacobi_eigh(T)

    m0, n_pad = _merge_sizes(n)

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
        # the float32 products U @ G of the levels leave the columns about
        # 1e-5 from orthonormal: one Newton-Schulz step in float64
        Uf = _orthonormalize(Uf)
    return D[:, 0, :n], Uf


# stage-1 drivers by name: the CUDA panel kernels and the plain stage 1
STAGE1 = {"latrd": tridiagonalize_latrd, "latrd_v4": tridiagonalize_latrd_v4,
          "latrd_v3": tridiagonalize_latrd_v3, "latrd_v2": tridiagonalize_latrd_v2,
          "plain": tridiagonalize}


# `LAPLACE_TS_STAGE1` values: the JAX package's three names (its
# `tridiag_eig.py:487-489`) and the port's spellings of the same routes
STAGE1_OVERRIDE = {"pallas": "latrd", "pallas_v4": "latrd_v4", "xla": "plain",
                   "latrd": "latrd", "latrd_v4": "latrd_v4", "plain": "plain"}


def _stage1_impl(n: int, stage1: str, device: torch.device) -> str:
    """Stage-1 implementation, a name in `STAGE1`. The environment variable
    `LAPLACE_TS_STAGE1` beats the argument and the auto rule when it names a
    route of `STAGE1_OVERRIDE` (v1, v4 or plain, as in the JAX package; it
    cannot select v3 or v2); any other value is ignored. "auto" follows the
    JAX package's thresholds on CUDA (v1 for 512 <= n < 2304, v4 above) and
    takes "plain" elsewhere."""
    env = os.environ.get("LAPLACE_TS_STAGE1")
    if env in STAGE1_OVERRIDE:
        return STAGE1_OVERRIDE[env]
    if stage1 != "auto":
        return stage1
    if device.type != "cuda" or n < 512:
        return "plain"
    return "latrd_v4" if n >= 2304 else "latrd"


@full_f32()
def eigh_stack_ts(stack: torch.Tensor, nb: int = 64, stage1: str = "auto", device=None):
    """Two-stage symmetric eigendecomposition of a (k, n, n) stack: blocked
    Householder tridiagonalization -> batched secular D&C -> WY
    back-transform. Ascending eigenvalues, orthonormal eigenvectors.

    Runs on `device` (CUDA unless the caller asks for the CPU). `stage1`:
    "auto" or a name in `STAGE1` ("latrd", "latrd_v4", "latrd_v3",
    "latrd_v2", "plain"), unless `LAPLACE_TS_STAGE1` overrides it
    (`_stage1_impl`); the kernel routes take their plain PyTorch panels
    when the stack lies on the CPU.
    """
    dev = resolve_device(device)
    stack = stack.to(dev)
    n = stack.shape[-1]
    impl = _stage1_impl(n, stage1, dev)
    if impl not in STAGE1:
        raise ValueError(f"Unknown stage1 {stage1!r}.")
    with spans.span("decompose.stage1", device=dev):
        d, e, V, taus = STAGE1[impl](stack, nb=nb)
    lam, Ut = tridiag_eigh(d, e)
    with spans.span("decompose.back_transform", device=dev):
        return lam, apply_q(V, taus, Ut, nb=nb)
