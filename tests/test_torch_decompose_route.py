"""The eigensolver route of `Kron.decompose`: the two-stage solver
`eigh_stack_ts` for the classes its gate opens, `torch.linalg.eigh` for the
rest, and a `ValueError` for the JAX package's eigensolvers the port lacks.

The gate is CUDA-only; the route test opens it on the CPU for n >= 64 (as
`tests/test_ts_budget.py` opens `_use_ts`) and holds the result to the
closed gate's, within the tolerances of `tests/test_torch_tridiag_eig.py`:
1e-9 in float64 and 1e-5 in float32, relative to the spectrum's scale.
"""

import numpy as np
import pytest
import torch

from laplace_jax_torch.utils import matrix
from laplace_jax_torch.utils.matrix import Kron

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

TOL = {torch.float64: 1e-9, torch.float32: 1e-5}


def _psd_stack(rng, k, n, decay=8.0, dtype=np.float64):
    Q = np.linalg.qr(rng.standard_normal((k, n, n)))[0]
    lam = np.exp(-np.linspace(0.0, decay, n))[None] * (1 + rng.random((k, n)))
    A = np.einsum("kij,kj,klj->kil", Q, lam, Q)
    return ((A + np.swapaxes(A, 1, 2)) / 2).astype(dtype)


def _kron(seed, dtype=torch.float64):
    """Factor groups of sizes 300 x 20, 64 x 20 and one dense 300 block."""
    rng = np.random.default_rng(seed)
    t = lambda n, decay=8.0: torch.as_tensor(_psd_stack(rng, 1, n, decay)[0], dtype=dtype)  # noqa: E731
    return Kron([(t(300), t(20, 2.0)), (t(64), t(20, 2.0)), (t(300, 4.0),)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_decompose_ts_matches_default_route(monkeypatch, dtype):
    """With the gate open for n >= 64, the 300 and 64 classes go to
    `eigh_stack_ts` (one call each) and the 20 class to `torch.linalg.eigh`;
    eigenvalues and log determinant match the closed gate's."""
    kron = _kron(5, dtype)
    ref = kron.decompose()
    ts_calls, eigh_calls = [], []
    real_ts, real_eigh = matrix.eigh_stack_ts, torch.linalg.eigh

    def ts(stack, **kw):
        ts_calls.append(tuple(stack.shape))
        return real_ts(stack, **kw)

    def eigh(stack, *a, **kw):
        eigh_calls.append(tuple(stack.shape))
        return real_eigh(stack, *a, **kw)

    monkeypatch.setattr(matrix, "_use_ts", lambda stack: stack.shape[-1] >= 64)
    monkeypatch.setattr(matrix, "eigh_stack_ts", ts)
    monkeypatch.setattr(torch.linalg, "eigh", eigh)
    retries = matrix.SYMEIG_RETRIES
    got = kron.decompose()
    monkeypatch.undo()
    assert matrix.SYMEIG_RETRIES == retries
    assert ts_calls == [(2, 300, 300), (1, 64, 64)]
    assert eigh_calls == [(2, 20, 20)]
    tol = TOL[dtype]
    for ls_g, ls_r in zip(got.eigenvalues, ref.eigenvalues, strict=True):
        for g, r in zip(ls_g, ls_r, strict=True):
            assert g.dtype == dtype
            torch.testing.assert_close(g, r, atol=tol * float(r.abs().max()), rtol=0)
    torch.testing.assert_close(got.logdet().double(), ref.logdet().double(), atol=0, rtol=tol)


def test_ts_gate_is_cuda_only():
    assert not matrix._use_ts(torch.zeros(2, 512, 512))


@pytest.mark.parametrize("impl", ["dc", "qdwh", "jacobi", "lapack"])
def test_decompose_rejects_solvers_the_port_lacks(monkeypatch, impl):
    """The JAX package's other eigensolvers, and unknown names, raise before
    any factor is solved."""
    monkeypatch.setattr(matrix, "EIGH_IMPLEMENTATION", impl)
    monkeypatch.setattr(matrix, "_batched_eigh_clipped", lambda stack: pytest.fail("solved"))
    with pytest.raises(ValueError, match="JAX package" if impl != "lapack" else "Unknown"):
        _kron(6).decompose()
