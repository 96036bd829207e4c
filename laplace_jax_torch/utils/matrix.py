"""Kronecker-factored curvature (port of `laplace_jax/utils/matrix.py`).

Layout convention, as in the JAX package: a parameter leaf of flax shape
``(..., out)`` is the 2-factor group ``(A, B)`` with A the input/activation
factor over ``prod(lead)`` and B the output-gradient factor, so the dense
block under the canonical row-major flatten is ``A kron B``; a 1-dim leaf
is the 1-factor group ``(F,)``.

`Kron.decompose` sends each same-shape stack of factors to the two-stage
eigensolver `eigh_stack_ts` on CUDA (float32/float64, n >= 512) and to
`torch.linalg.eigh` otherwise, as the JAX package sends them to its
two-stage solver on an accelerator and to LAPACK on the CPU. With
`EIGH_IMPLEMENTATION = "dc"` every CUDA class with n >= 512 of one dtype
goes instead to one pooled spectral divide-and-conquer call
(`ops/eigh_dc.eigh_pooled_dc`). Each factor's output is checked for NaN; a
bad factor takes the `symeig` jitter retry, and `SYMEIG_RETRIES` counts
those factors, so an eigensolver that returns NaN cannot hide behind the
retry.
"""

from __future__ import annotations

from typing import Sequence

import torch

from laplace_jax_torch.ops.eigh_dc import eigh_pooled_dc
from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts
from laplace_jax_torch.utils.linalg import symeig

__all__ = ["Kron", "KronDecomposed"]

# Eigensolver of `Kron.decompose` on CUDA: None or "ts" (the two-stage
# solver, the default), or "dc" (the pooled spectral divide-and-conquer).
# The JAX package's "qdwh" and "jacobi" name XLA's own eigh solvers, which
# PyTorch does not have: they raise.
EIGH_IMPLEMENTATION: str | None = None

# below these sizes the two-stage and the D&C paths' fixed costs do not pay
# (the JAX package's `_TS_MIN_SIZE`, `_DC_MIN_SIZE`)
_TS_MIN_SIZE = 512
_DC_MIN_SIZE = 512

# factors sent to the `symeig` retry by `Kron.decompose` in this process
SYMEIG_RETRIES = 0


def _check_implementation() -> None:
    if EIGH_IMPLEMENTATION in ("qdwh", "jacobi"):
        raise ValueError(
            f"EIGH_IMPLEMENTATION={EIGH_IMPLEMENTATION!r} selects one of XLA's own eigh "
            "solvers, which have no PyTorch counterpart; use None/'ts' or 'dc'.")
    if EIGH_IMPLEMENTATION not in (None, "ts", "dc"):
        raise ValueError(f"Unknown EIGH_IMPLEMENTATION {EIGH_IMPLEMENTATION!r}; "
                         "use None, 'ts' or 'dc'.")


def _use_dc(stack: torch.Tensor) -> bool:
    return (stack.is_cuda and EIGH_IMPLEMENTATION == "dc"
            and stack.shape[-1] >= _DC_MIN_SIZE)


def _use_ts(stack: torch.Tensor) -> bool:
    return (EIGH_IMPLEMENTATION in (None, "ts") and stack.is_cuda
            and stack.shape[-1] >= _TS_MIN_SIZE
            and stack.dtype in (torch.float32, torch.float64))


def _clip_flags(l: torch.Tensor, Q: torch.Tensor):
    """Clipped eigenvalues, NaN-cleaned vectors and per-factor NaN flags on
    the raw output."""
    flags = torch.isnan(l).any(1) | torch.isnan(Q).any(2).any(1)
    return torch.nan_to_num(l.clamp(min=0.0)), torch.nan_to_num(Q), flags


def _batched_eigh_clipped(stack: torch.Tensor):
    """Eigendecompose a (k, n, n) stack, as `_clip_flags` returns it."""
    stack = (stack + stack.mT) / 2
    if _use_ts(stack):
        return _clip_flags(*eigh_stack_ts(stack, device=stack.device))
    return _clip_flags(*torch.linalg.eigh(stack))


def broadcast_groups(values: torch.Tensor, sizes) -> torch.Tensor:
    """Per-group scalars as a flat per-parameter vector: one broadcast per
    group and a concat. (`repeat_interleave` computes the same, but its
    backward scatter-adds millions of entries into a few slots.)"""
    return torch.cat([values[g].expand(n) for g, n in enumerate(sizes)])


def _group_sizes(groups) -> list[int]:
    return [F[0].shape[0] if len(F) == 1 else F[0].shape[0] * F[1].shape[0]
            for F in groups]


class Kron:
    """Sum-accumulable Kronecker-factored curvature: a tuple of groups, each
    one dense block ``(F,)`` or two factors ``(A, B)``."""

    def __init__(self, kfacs: Sequence[Sequence[torch.Tensor]]):
        self.kfacs = tuple(tuple(F) for F in kfacs)

    def __add__(self, other: "Kron") -> "Kron":
        if not isinstance(other, Kron):
            raise ValueError("Can only add Kron to Kron.")
        return Kron([tuple(a + b for a, b in zip(Fi, Fj))
                     for Fi, Fj in zip(self.kfacs, other.kfacs)])

    def __mul__(self, scalar) -> "Kron":
        """Scalar multiply, distributed as `scalar**(1/len(F))` per factor."""
        return Kron([tuple((scalar ** (1.0 / len(F))) * H for H in F)
                     for F in self.kfacs])

    @property
    def group_sizes(self) -> list[int]:
        return _group_sizes(self.kfacs)

    def decompose(self, damping: bool = False) -> "KronDecomposed":
        """Eigendecompose every factor, one batched call per (shape, dtype),
        or, with `EIGH_IMPLEMENTATION = "dc"`, one pooled D&C call for all
        eligible classes of each dtype."""
        _check_implementation()
        by_shape: dict = {}
        for gi, F in enumerate(self.kfacs):
            for fi, H in enumerate(F):
                by_shape.setdefault((tuple(H.shape), H.dtype), []).append((gi, fi))
        results = {}

        def collect(keys, ls, Qs, flags):
            global SYMEIG_RETRIES
            for j, (key, bad) in enumerate(zip(keys, flags.tolist())):
                gi, fi = key
                results[key] = (ls[j], Qs[j])
                if bad:
                    SYMEIG_RETRIES += 1
                    results[key] = symeig(self.kfacs[gi][fi])

        dc_by_dtype: dict = {}
        for keys in by_shape.values():
            stack = torch.stack([self.kfacs[gi][fi] for gi, fi in keys])
            if _use_dc(stack):
                dc_by_dtype.setdefault(stack.dtype, []).append((keys, stack))
                continue
            collect(keys, *_batched_eigh_clipped(stack))
        for pool in dc_by_dtype.values():
            outs = eigh_pooled_dc([stack for _, stack in pool], device=pool[0][1].device)
            for (keys, _), (l, Q) in zip(pool, outs):
                collect(keys, *_clip_flags(l, Q))
        eigvecs = [tuple(results[(gi, fi)][1] for fi in range(len(F)))
                   for gi, F in enumerate(self.kfacs)]
        eigvals = [tuple(results[(gi, fi)][0] for fi in range(len(F)))
                   for gi, F in enumerate(self.kfacs)]
        return KronDecomposed(eigvecs, eigvals, damping=damping)


class KronDecomposed:
    """Eigendecomposed `Kron` plus per-group prior scalars `deltas`:
    ``(A kron B + delta I)^e @ v`` in the Kronecker eigenbasis, or the damped
    ``((l_A + sqrt(delta)) kron (l_B + sqrt(delta)))^e``."""

    def __init__(self, eigenvectors, eigenvalues, deltas=None, damping: bool = False):
        self.eigenvectors = tuple(tuple(Qs) for Qs in eigenvectors)
        self.eigenvalues = tuple(tuple(ls) for ls in eigenvalues)
        l0 = self.eigenvalues[0][0]
        if deltas is None:
            self.deltas = torch.zeros(len(self.eigenvalues), dtype=l0.dtype,
                                      device=l0.device)
        else:
            self.deltas = self._check_deltas(deltas)
        self.damping = damping
        self._flat_eigs_cache = None

    def _check_deltas(self, deltas) -> torch.Tensor:
        l0 = self.eigenvalues[0][0]
        deltas = torch.as_tensor(deltas, dtype=l0.dtype, device=l0.device)
        if deltas.ndim == 0 or (deltas.ndim == 1 and deltas.shape[0] in
                                (1, len(self.eigenvalues))):
            return deltas.reshape(-1).expand(len(self.eigenvalues))
        raise ValueError("Invalid shape of delta added to KronDecomposed.")

    @property
    def group_sizes(self) -> list[int]:
        return _group_sizes(self.eigenvalues)

    def __add__(self, deltas) -> "KronDecomposed":
        out = KronDecomposed(self.eigenvectors, self.eigenvalues,
                             self.deltas + self._check_deltas(deltas),
                             damping=self.damping)
        out._flat_eigs_cache = self._flat_eigs_cache
        return out

    def __mul__(self, scalar) -> "KronDecomposed":
        eigenvalues = [tuple((scalar ** (1.0 / len(ls))) * l for l in ls)
                       for ls in self.eigenvalues]
        return KronDecomposed(self.eigenvectors, eigenvalues, self.deltas,
                              damping=self.damping)

    def _group_eig(self, ls, delta, exponent):
        lA, lB = ls
        if self.damping:
            s = torch.sqrt(delta)
            return torch.outer(lA + s, lB + s) ** exponent
        return (torch.outer(lA, lB) + delta) ** exponent

    @property
    def _flat_eigs(self) -> torch.Tensor:
        """Concatenated per-group Kronecker eigenvalues (P,), cached."""
        if self._flat_eigs_cache is None:
            self._flat_eigs_cache = torch.cat([
                ls[0] if len(ls) == 1 else torch.outer(ls[0], ls[1]).reshape(-1)
                for ls in self.eigenvalues
            ])
        return self._flat_eigs_cache

    def _flat_deltas(self) -> torch.Tensor:
        return broadcast_groups(self.deltas, self.group_sizes)

    def logdet(self) -> torch.Tensor:
        if self.damping:
            ld = 0.0
            for ls, delta in zip(self.eigenvalues, self.deltas):
                if len(ls) == 1:
                    ld = ld + torch.log(ls[0] + delta).sum()
                else:
                    s = torch.sqrt(delta)
                    lA, lB = ls
                    ld = ld + lB.shape[0] * torch.log(lA + s).sum()
                    ld = ld + lA.shape[0] * torch.log(lB + s).sum()
            return ld
        return torch.log(self._flat_eigs + self._flat_deltas()).sum()

    def _bmm(self, W: torch.Tensor, exponent: float = -1) -> torch.Tensor:
        """`H^e @ W` for W (batch, classes, params)."""
        B, K, P = W.shape
        W = W.reshape(B * K, P)
        cur, out = 0, []
        for ls, Qs, delta in zip(self.eigenvalues, self.eigenvectors, self.deltas):
            if len(ls) == 1:
                Q, l = Qs[0], ls[0]
                p = l.shape[0]
                out.append(((W[:, cur : cur + p] @ Q) * (l + delta) ** exponent) @ Q.T)
            else:
                QA, QB = Qs
                p = ls[0].shape[0] * ls[1].shape[0]
                W_p = W[:, cur : cur + p].reshape(B * K, ls[0].shape[0], ls[1].shape[0])
                # (A kron B)^e vec(W) = vec(QA ((QA^T W QB) * L^e) QB^T)
                W_p = (QA.T @ W_p @ QB) * self._group_eig(ls, delta, exponent)
                out.append((QA @ W_p @ QB.T).reshape(B * K, p))
            cur += p
        return torch.cat(out, 1).reshape(B, K, P)

    def bmm(self, W: torch.Tensor, exponent: float = -1) -> torch.Tensor:
        if W.ndim == 1:
            return self._bmm(W[None, None], exponent).reshape(-1)
        if W.ndim == 2:
            return self._bmm(W[:, None], exponent).squeeze(1)
        if W.ndim == 3:
            return self._bmm(W, exponent)
        raise ValueError("Invalid shape for W")

    def inv_square_form(self, W: torch.Tensor) -> torch.Tensor:
        """`W H^{-1} W^T` batched over the leading axis."""
        return torch.einsum("bkp,blp->bkl", W, self._bmm(W, exponent=-1))
