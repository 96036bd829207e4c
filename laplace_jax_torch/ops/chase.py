"""Successive band reduction (SBR), stage B: symmetric band -> tridiagonal by
pipelined Householder bulge chasing, and the grouped compact-WY application
of the chase transform.

Port of `laplace_jax/ops/chase.py`; the schedule, the storage and the logs
are the JAX package's, so each output compares one to one:

- The band lives in diagonal storage `D[k, p] = B[p + k, p]` (k < 2b), with
  front padding, back padding and a parking slab for masked tasks.
- Task (s, t): sweep s eliminates band column s; its chase task t cleans one
  column with a length-b reflector on rows `[s + t b + 1, s + (t + 1) b]`
  and applies it two-sided, on a (3b, 3b) dense block gathered from a
  (2b, 2b) slab of `D` through static index maps.
- Wavefront schedule `time(s, t) = 3 s + t`, `W = TCAP // 3 + 2` tasks a
  step: concurrent slabs are disjoint, so one gather and one scatter serve
  every task of a step.
- A sweep's chain reflectors have disjoint supports: sweep s's chain is
  column s of `Vlog`, its scalars `taulog[:, t, s]`.

`apply_chase_q` applies `Q = H_0 H_1 ...` in groups G(J, t) of g sweeps at
one chase position, group after group along anti-diagonals (groups of one
anti-diagonal touch disjoint rows and go in one batched product).

Both run on the device of their input, with every static index map built
there before the loop, and no host sync inside it. No entry point reaches
them: with `ops.band` they are a standalone op chain.
"""

from __future__ import annotations

import numpy as np
import torch

from laplace_jax_torch.ops.tridiag import _cdiv, eps_tiny, reflector, wy_factor

__all__ = ["band_to_tridiag", "apply_chase_q"]


def _chain_cap(n: int, b: int) -> int:
    """Most chase tasks in a sweep: task (s, t) exists while its first
    eliminated row s + t b + 2 is a real row (< n); the worst case is s = 0."""
    return max((n - 3) // b + 1, 1)


def band_to_tridiag(B: torch.Tensor, b: int):
    """Reduce a batch of symmetric band matrices to tridiagonal form.

    B (K, n, n) symmetric with semi-bandwidth `b` (entries |i - j| > b are
    ignored), as `ops.band.band_reduce` returns it. Returns `d` (K, n), `e`
    (K, n - 1), `Vlog` (K, n, n - 2) (column s holds sweep s's whole chain,
    the reflector of task (s, t) on rows [s + t b + 1, s + (t + 1) b] with
    its unit leading element) and `taulog` (K, TCAP, n - 2).

    `T = H_last ... H_0 B H_0 ... H_last` in execution order, so
    `B = Q T Q^T` with `Q = H_0 H_1 ...`; `apply_chase_q` computes `Q @ S`.
    """
    K, n, _ = B.shape
    dtype, dev = B.dtype, B.device
    if n <= 2 or b <= 1:
        d = torch.diagonal(B, dim1=1, dim2=2).clone()
        if n == 2:
            e = B[:, 1:, 0].reshape(K, 1)
        elif n > 2:
            e = torch.diagonal(B, offset=-1, dim1=1, dim2=2).clone()
        else:
            e = B.new_zeros(K, max(n - 1, 0))
        return d, e, B.new_zeros(K, n, n), B.new_zeros(K, _chain_cap(n, max(b, 2)), n)

    TCAP = _chain_cap(n, b)
    n_sweeps = n - 2  # sweep s cleans column s; the last with work is n - 3
    W = TCAP // 3 + 2  # concurrent tasks (t spacing 3 across active sweeps)

    # diagonal storage with front and back padding and a parking slab
    P0 = b  # front pad: t = 0 slabs start at column s - b + 1
    Np = P0 + n + 4 * b
    p_park = P0 + n + 2 * b
    D = B.new_zeros(K, 2 * b, Np)
    for k in range(b + 1):
        # rows k > b start zero: B is banded by contract (the JAX package
        # fills them and masks them out)
        kk = min(k, n - 1)
        D[:, k, P0:P0 + n - kk] = torch.diagonal(B, offset=-kk, dim1=1, dim2=2)
    D_flat = D.view(K, 2 * b * Np)

    Vlog = B.new_zeros(K, n, n_sweeps + 1)  # the last column is the parking one
    taulog = B.new_zeros(K, TCAP, n_sweeps + 1)
    tiny = eps_tiny(dtype)
    zero = torch.zeros((), dtype=dtype, device=dev)

    # static maps between a slab starting at D column w0 and the (3b, 3b)
    # local dense block: L[i, j] = D[|i - j|, w0 + min(i, j)]; a slab entry
    # (k, p) with k + p < 3b is owned by the block, as L[p + k, p]
    i3 = torch.arange(3 * b, device=dev)
    kk = (i3[:, None] - i3[None, :]).abs()
    pp = torch.minimum(i3[:, None], i3[None, :])
    L_valid = (kk < 2 * b) & (pp < 2 * b)
    L_idx = torch.where(L_valid, kk * Np + pp, 0)  # into D_flat, less w0
    k2, p2 = np.nonzero(np.add.outer(np.arange(2 * b), np.arange(2 * b)) < 3 * b)
    S_dst = torch.as_tensor(k2 * Np + p2, device=dev)  # into D_flat, less w0
    S_src = torch.as_tensor((p2 + k2) * 3 * b + p2, device=dev)  # into L flat
    elim_rows = (i3 >= b + 1) & (i3 < 2 * b)  # eliminated entries
    refl_rows = (i3 >= b) & (i3 < 2 * b)  # reflector support
    ar_b = torch.arange(b, device=dev)

    # every step's task layout, built once: (T_steps, W) each
    T_steps = 3 * (n_sweeps - 1) + 1
    step = torch.arange(T_steps, device=dev)[:, None]
    s = step // 3 - torch.arange(W, device=dev)[None, :]
    t = step - 3 * s
    valid = (s >= 0) & (s <= n - 3) & (t >= 0) & (s + t * b + 2 <= n - 1)
    w0g = s + (t - 1) * b + 1  # global slab start (t = 0: s - b + 1)
    w0_all = torch.where(valid, P0 + w0g, p_park)
    c_all = torch.where(t >= 1, 0, b - 1)  # local column being cleaned
    # each step's logs, written out after the loop: v's support rows, tau,
    # and the (d, e) pair a t = 0 task finalizes
    v_steps = B.new_empty(T_steps, K, W, b)
    tau_steps = B.new_empty(T_steps, K, W)
    de_steps = B.new_empty(T_steps, K, W, 2)

    for st in range(T_steps):
        w0, ok = w0_all[st], valid[st]
        L = torch.where(L_valid, D_flat[:, L_idx + w0[:, None, None]], zero)  # (K, W, 3b, 3b)

        # the reflector from the cleaned column
        x = torch.take_along_dim(L, c_all[st][None, :, None, None], dim=3)[..., 0]
        alpha = x[..., b]
        xt = torch.where(elim_rows, x, zero)
        tau, denom, _, _ = reflector(alpha, (xt * xt).sum(-1), tiny)
        tau = torch.where(ok, tau, zero)
        v = torch.where(i3 == b, 1.0, xt / denom[..., None])
        v = torch.where(refl_rows & ok[:, None], v, zero)

        # two-sided rank-2 update
        wv = tau[..., None] * (L @ v[..., None])[..., 0]
        wv = wv - (0.5 * tau * (wv * v).sum(-1))[..., None] * v
        L = L - v[..., :, None] * wv[..., None, :] - wv[..., :, None] * v[..., None, :]

        # write back the owned slab entries; parked tasks share the parking
        # slab, and as their v is 0 each writes back the values it read, so
        # duplicate indices all carry equal values
        D_flat[:, S_dst + w0[:, None]] = L.flatten(2)[..., S_src]

        v_steps[st] = v[..., b:2 * b]
        tau_steps[st] = tau
        de_steps[st] = L[:, :, b - 1:b + 1, b - 1]

    # the logs of every step: parked tasks add zeros to the dummy column, and
    # a chain's rows past n - 1 are clamped onto row n - 1 with v = 0 there,
    # so only the accumulating put is exact with repeated indices
    s_col = torch.where(valid, s, n_sweeps)
    rows_v = (torch.where(valid, w0g + b, n - 1)[..., None] + ar_b).clamp(max=n - 1)
    Vlog.index_put_((torch.arange(K, device=dev)[:, None, None, None], rows_v[None],
                     s_col[None, :, :, None]), v_steps.transpose(0, 1), accumulate=True)
    # parked tasks write tau = 0 to the dummy column
    taulog[:, t.clamp(0, TCAP - 1), s_col] = tau_steps.transpose(0, 1)
    # t = 0 finalizes d[s] and e[s], once for each s < n - 2
    is0 = valid & (t == 0)
    de = de_steps.transpose(0, 1)[:, is0]  # (K, n - 2, 2)

    # the trailing 2x2 block straight from the band store
    d = B.new_zeros(K, n)
    e = B.new_zeros(K, n - 1)
    s0 = s[is0]
    d[:, s0], e[:, s0] = de[..., 0], de[..., 1]
    d[:, n - 2:] = D[:, 0, P0 + n - 2:P0 + n]
    e[:, n - 2] = D[:, 1, P0 + n - 2]
    return d, e, Vlog[:, :, :n_sweeps], taulog[:, :, :n_sweeps]


def apply_chase_q(Vlog: torch.Tensor, taulog: torch.Tensor, S: torch.Tensor, b: int,
                  g: int | None = None) -> torch.Tensor:
    """`Q @ S` (S (K, n, c)) with `Q = H_0 H_1 ...` from `band_to_tridiag`.

    Grouped compact WY: the reflectors {(s, t) : s in [J g, J g + g)} form
    group G(J, t) on rows [J g + t b + 1, J g + g - 1 + (t + 1) b]. The
    order J ascending, t descending is a valid linearization (reflectors
    (s, t), (s', t') with |t - t'| >= 2 and |s - s'| < g <= b have disjoint
    supports), groups on one anti-diagonal {(J + k, t + k)} touch disjoint
    rows, and `Q S` applies the anti-diagonals in reverse: omega = J - t
    descending. `g` is min(b, 64) by default and at most b.
    """
    K, n, n_sweeps = Vlog.shape
    dev = Vlog.device
    Sc = S.shape[-1]
    if n_sweeps == 0:
        return S
    g = min(b, 64) if g is None else g
    g = min(g, b)  # the commutation argument needs g <= b
    TCAP = taulog.shape[1]
    G_s = _cdiv(n_sweeps, g)
    Lg = b + g  # a group's row span (b + g - 1, padded by 1)
    NG = G_s * TCAP

    # every group's reflectors: group (J, t) = J * TCAP + t starts at row
    # r0 = J g + t b + 1; member j (sweep J g + j) holds local rows [j, j + b)
    Jt = torch.arange(NG, device=dev)
    Jg_all = (Jt // TCAP) * g
    t_all = Jt % TCAP
    r0_all = Jg_all + t_all * b + 1
    rows_l = torch.arange(Lg, device=dev)
    ar_g = torch.arange(g, device=dev)
    row_ids = r0_all[:, None] + rows_l  # (NG, Lg)
    col_ids = Jg_all[:, None] + ar_g  # (NG, g)
    real_col = col_ids < n_sweeps
    keep = ((rows_l[:, None] >= ar_g) & (rows_l[:, None] < ar_g + b)  # support
            & (row_ids < n)[:, :, None] & real_col[:, None, :])  # (NG, Lg, g)
    row_ids, col_ids = row_ids.clamp(max=n - 1), col_ids.clamp(max=n_sweeps - 1)
    Vg = torch.where(keep, Vlog[:, row_ids[:, :, None], col_ids[:, None, :]], 0.0)
    taus_g = torch.where(real_col, taulog[:, t_all[:, None], col_ids], 0.0)  # (K, NG, g)
    T_all = wy_factor(Vg.mT @ Vg, taus_g)  # (K, NG, g, g)

    # the anti-diagonals, omega descending; a group whose rows start at or
    # past n holds no reflector (all its rows are masked) and is skipped
    out = S.new_zeros(K, n + Lg, Sc)
    out[:, :n] = S
    groups, rows = [], []
    for omega in range(G_s - 1, -TCAP, -1):
        lo = max(omega, 0)
        hi = min(G_s, TCAP + omega, (n - 2 + omega * b) // (g + b) + 1)
        J = np.arange(lo, max(hi, lo))
        groups.append(J * TCAP + J - omega)
        rows.append(((J * (g + b) - omega * b + 1)[:, None] + np.arange(Lg)).ravel())
    sizes = [len(x) for x in groups]
    idx_all = torch.as_tensor(np.concatenate(groups), device=dev)
    rows_all = torch.as_tensor(np.concatenate(rows), device=dev)
    a = 0
    for cnt in sizes:
        if cnt == 0:
            continue
        idx, rws = idx_all[a:a + cnt], rows_all[a * Lg:(a + cnt) * Lg]
        a += cnt
        U = out.index_select(1, rws).view(K, cnt, Lg, Sc)
        Vd = Vg.index_select(1, idx)
        X = T_all.index_select(1, idx) @ (Vd.mT @ U)
        out.index_copy_(1, rws, (U - Vd @ X).view(K, cnt * Lg, Sc))
    return out[:, :n]
