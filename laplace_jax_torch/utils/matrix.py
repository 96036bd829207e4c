"""Kronecker-factored curvature (port of `laplace_jax/utils/matrix.py`).

Layout convention, as in the JAX package: a parameter leaf of flax shape
``(..., out)`` is the 2-factor group ``(A, B)`` with A the input/activation
factor over ``prod(lead)`` and B the output-gradient factor, so the dense
block under the canonical row-major flatten is ``A kron B``; a 1-dim leaf
is the 1-factor group ``(F,)``.

`Kron.decompose` sends each same-shape stack of factors to the two-stage
eigensolver `eigh_stack_ts` on CUDA (float32/float64, n >= 512) and to
`torch.linalg.eigh` otherwise, as the JAX package sends them to its
two-stage solver on an accelerator and to LAPACK on the CPU. Each factor's
output is checked for NaN; a bad factor takes the `symeig` jitter retry,
and `SYMEIG_RETRIES` counts those factors, so an eigensolver that returns
NaN cannot hide behind the retry. `decompose(devices=[...])` spreads the
factors over several devices (largest first, to the least-loaded), as the
JAX package's multi-device decompose does. The spans `decompose.class` (a
stack), `decompose.eigh` (`torch.linalg.eigh`), `decompose.flags` (the
flag read and the retries) and the counter `decompose.retries` time and
count it (`utils/spans.py`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts
from laplace_jax_torch.utils import spans
from laplace_jax_torch.utils.device import full_f32
from laplace_jax_torch.utils.linalg import block_diag, kron, symeig

__all__ = ["Kron", "KronDecomposed"]

# Eigensolver of `Kron.decompose` on CUDA: None or "ts", the two-stage
# solver, the port's only one. The JAX package's other names ("dc", its
# pooled spectral divide-and-conquer; "qdwh" and "jacobi", XLA's own eigh
# solvers) raise.
EIGH_IMPLEMENTATION: str | None = None

# below this size the two-stage path's fixed costs do not pay (the JAX
# package's `_TS_MIN_SIZE`)
_TS_MIN_SIZE = 512

# factors sent to the `symeig` retry by `Kron.decompose` in this process
SYMEIG_RETRIES = 0


def _check_implementation() -> None:
    if EIGH_IMPLEMENTATION in ("dc", "qdwh", "jacobi"):
        raise ValueError(
            f"EIGH_IMPLEMENTATION={EIGH_IMPLEMENTATION!r} names one of the JAX package's "
            "eigensolvers; the port has the two-stage solver only: use None or 'ts'.")
    if EIGH_IMPLEMENTATION not in (None, "ts"):
        raise ValueError(f"Unknown EIGH_IMPLEMENTATION {EIGH_IMPLEMENTATION!r}; "
                         "use None or 'ts'.")


def _use_ts(stack: torch.Tensor) -> bool:
    return (stack.is_cuda
            and stack.shape[-1] >= _TS_MIN_SIZE
            and stack.dtype in (torch.float32, torch.float64))


def _clip_flags(l: torch.Tensor, Q: torch.Tensor):
    """Clipped eigenvalues, NaN-cleaned vectors and per-factor NaN flags on
    the raw output."""
    flags = torch.isnan(l).any(1) | torch.isnan(Q).any(2).any(1)
    return torch.nan_to_num(l.clamp(min=0.0)), torch.nan_to_num(Q), flags


def _batched_eigh_clipped(stack: torch.Tensor):
    """Eigendecompose a (k, n, n) stack, as `_clip_flags` returns it."""
    with spans.span("decompose.class", device=stack.device):
        stack = (stack + stack.mT) / 2
        if _use_ts(stack):
            return _clip_flags(*eigh_stack_ts(stack, device=stack.device))
        with spans.span("decompose.eigh"):
            l, Q = torch.linalg.eigh(stack)
        return _clip_flags(l, Q)


def _device_list(devices) -> list:
    """`devices` as a list of `torch.device`s: none for None, this
    process's own device for a `DeviceMesh` (the JAX package's
    `_device_list` keeps a process's addressable devices; here a process
    has one)."""
    if devices is None:
        return []
    if hasattr(devices, "device_type"):  # a DeviceMesh
        if devices.device_type == "cuda":
            return [torch.device("cuda", torch.cuda.current_device())]
        return [torch.device(devices.device_type)]
    return [torch.device(d) for d in devices]


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

    @classmethod
    def init_from_params(cls, params, dtype=None, device=None) -> "Kron":
        """Zero factors shaped from parameter leaves in canonical order and
        flax layout (tensors or shapes): a leaf of at most one dim is the
        group ``(F,)``, any other the group ``(A, B)`` over ``prod(lead)``
        and its last dim."""
        kfacs = []
        for p in params:
            shape = tuple(p.shape) if hasattr(p, "shape") else tuple(p)
            dt = dtype or getattr(p, "dtype", None) or torch.get_default_dtype()
            dev = device if device is not None else getattr(p, "device", None)
            size = math.prod(shape)
            if len(shape) <= 1:
                P = max(size, 1)
                kfacs.append((torch.zeros(P, P, dtype=dt, device=dev),))
            else:
                p_in, p_out = size // shape[-1], shape[-1]
                kfacs.append((torch.zeros(p_in, p_in, dtype=dt, device=dev),
                              torch.zeros(p_out, p_out, dtype=dt, device=dev)))
        return cls(kfacs)

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

    def _bmm(self, W: torch.Tensor) -> torch.Tensor:
        """`H @ W` for W (batch, classes, params)."""
        B, K, P = W.shape
        W = W.reshape(B * K, P)
        cur, out = 0, []
        for F in self.kfacs:
            if len(F) == 1:
                p = F[0].shape[0]
                out.append(W[:, cur : cur + p] @ F[0].T)
            else:
                A, Bf = F
                p_in, p_out = A.shape[0], Bf.shape[0]
                p = p_in * p_out
                W_p = W[:, cur : cur + p].reshape(B * K, p_in, p_out)
                # (A kron B) vec(W) = vec(A W B^T)
                out.append(torch.einsum("ij,bjo,po->bip", A, W_p, Bf).reshape(B * K, p))
            cur += p
        return torch.cat(out, 1).reshape(B, K, P)

    def bmm(self, W: torch.Tensor, exponent: float = 1) -> torch.Tensor:
        """`H @ W` for W (params,), (batch, params) or (batch, classes,
        params); other exponents need the decomposition."""
        if exponent != 1:
            raise ValueError("Only supported after decomposition.")
        if W.ndim == 1:
            return self._bmm(W[None, None]).reshape(-1)
        if W.ndim == 2:
            return self._bmm(W[:, None]).squeeze(1)
        if W.ndim == 3:
            return self._bmm(W)
        raise ValueError("Invalid shape for W")

    def logdet(self) -> torch.Tensor:
        """Log determinant of the block-diagonal matrix."""
        ld = 0.0
        for F in self.kfacs:
            if len(F) == 1:
                ld = ld + torch.linalg.slogdet(F[0])[1]
            else:
                A, B = F
                ld = ld + B.shape[0] * torch.linalg.slogdet(A)[1]
                ld = ld + A.shape[0] * torch.linalg.slogdet(B)[1]
        return torch.as_tensor(ld)

    def diag(self) -> torch.Tensor:
        """Diagonal of the block-diagonal matrix."""
        return torch.cat([torch.diagonal(F[0]) if len(F) == 1 else
                          torch.outer(torch.diagonal(F[0]), torch.diagonal(F[1])).reshape(-1)
                          for F in self.kfacs])

    def to_matrix(self) -> torch.Tensor:
        """The dense block-diagonal matrix (for tests)."""
        return block_diag([F[0] if len(F) == 1 else kron(F[0], F[1]) for F in self.kfacs])

    @full_f32()
    def decompose(self, damping: bool = False, devices=None) -> "KronDecomposed":
        """Eigendecompose every factor: one batched call per (device, shape,
        dtype), `eigh_stack_ts` for a CUDA class with n >= 512 and
        `torch.linalg.eigh` for the rest. An `EIGH_IMPLEMENTATION` other
        than None or "ts" raises `ValueError` before any factor is solved.

        `devices` (the JAX package's `utils/matrix.py:340-470`): None (the
        factors' own device), a sequence of `torch.device`s, or a
        `DeviceMesh`, which stands for this process's own device (each rank
        of a data-parallel fit decomposes every factor itself; no factor is
        split across ranks). Factors go greedily, largest n³ first, to the
        least-loaded device (a device may be named twice); every solve is
        enqueued before any result is read; results are gathered to the
        first device, the NaN flags read once, and the flagged factors
        retried through `symeig`."""
        global SYMEIG_RETRIES
        _check_implementation()
        dev_list = _device_list(devices) or [self.kfacs[0][0].device]
        keys = [(gi, fi) for gi, F in enumerate(self.kfacs) for fi in range(len(F))]
        loads, device_of = [0.0] * len(dev_list), {}
        for gi, fi in sorted(keys, key=lambda k: -self.kfacs[k[0]][k[1]].shape[0] ** 3):
            device_of[(gi, fi)] = d = loads.index(min(loads))
            loads[d] += float(self.kfacs[gi][fi].shape[0]) ** 3
        groups: dict = {}
        for gi, fi in sorted(keys, key=device_of.get):  # each device's in factor order
            H = self.kfacs[gi][fi]
            groups.setdefault((device_of[(gi, fi)], tuple(H.shape), H.dtype), []).append((gi, fi))
        pending = []
        for (d, _, _), keys in groups.items():
            stack = torch.stack([self.kfacs[gi][fi].to(dev_list[d]) for gi, fi in keys])
            pending.append((keys, *_batched_eigh_clipped(stack)))
        first = dev_list[0]
        results, flag_keys = {}, []
        for keys, ls, Qs, _ in pending:
            ls, Qs = ls.to(first), Qs.to(first)
            for j, key in enumerate(keys):
                results[key] = (ls[j], Qs[j])
            flag_keys.extend(keys)
        with spans.span("decompose.flags", device=first):
            flags = torch.cat([f.to(first) for *_, f in pending]).tolist()  # the one read
            for (gi, fi), bad in zip(flag_keys, flags):
                if bad:
                    SYMEIG_RETRIES += 1
                    spans.count("decompose.retries")
                    results[(gi, fi)] = symeig(self.kfacs[gi][fi].to(first))
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

    @spans.span("predict.variance")
    def inv_square_form(self, W: torch.Tensor) -> torch.Tensor:
        """`W H^{-1} W^T` batched over the leading axis."""
        return torch.einsum("bkp,blp->bkl", W, self._bmm(W, exponent=-1))

    def diag(self, exponent: float = 1) -> torch.Tensor:
        """Diagonal of `H^e`."""
        diags = []
        for Qs, ls, delta in zip(self.eigenvectors, self.eigenvalues, self.deltas):
            if len(ls) == 1:
                Q, l = Qs[0], ls[0]
                diags.append(torch.einsum("mp,p,mp->m", Q, (l + delta) ** exponent, Q))
            else:
                QA, QB = Qs
                eig = self._group_eig(ls, delta, exponent)
                diags.append(torch.einsum("mp,nq,pq->mn", QA ** 2, QB ** 2, eig).reshape(-1))
        return torch.cat(diags)

    def to_matrix(self, exponent: float = 1) -> torch.Tensor:
        """The dense `H^e` (for tests)."""
        blocks = []
        for Qs, ls, delta in zip(self.eigenvectors, self.eigenvalues, self.deltas):
            if len(ls) == 1:
                Q, l = Qs[0], ls[0]
                blocks.append(Q @ torch.diag((l + delta) ** exponent) @ Q.T)
            else:
                Q = kron(Qs[0], Qs[1])
                blocks.append(Q @ torch.diag(self._group_eig(ls, delta, exponent).reshape(-1)) @ Q.T)
        return block_diag(blocks)
