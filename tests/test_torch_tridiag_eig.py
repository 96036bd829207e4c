"""The port's stage 2 (`tridiag_eigh`), the two-stage driver
`eigh_stack_ts` and `Kron.decompose`'s dispatch, against the JAX package.

Eigenvalues agree to 1e-9 (relative to the spectrum's scale) in float64:
both sides run the same D&C, so the only differences are rounding.
Eigenvectors are compared by reconstruction and orthogonality, not
element-wise (signs and bases of clusters are free).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.tridiag_eig import eigh_stack_ts as jax_eigh_stack_ts
from laplace_jax.ops.tridiag_eig import tridiag_eigh as jax_tridiag_eigh
from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts, tridiag_eigh
from laplace_jax_torch.utils import matrix
from laplace_jax_torch.utils.matrix import Kron

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)


def _sym(seed, K, n, psd=False):
    rng = np.random.default_rng(seed)
    if psd:  # KFAC-like decaying spectrum with a near-degenerate tail
        Q = np.linalg.qr(rng.standard_normal((K, n, n)))[0]
        lam = np.exp(-np.linspace(0.0, 12.0, n))[None] * (1 + rng.random((K, n)))
        A = np.einsum("kij,kj,klj->kil", Q, lam, Q)
    else:
        A = rng.standard_normal((K, n, n))
    return (A + A.transpose(0, 2, 1)) / 2


def _check_pairs(A, lam, vecs, lam_ref, tol):
    A, lam, vecs = (torch.as_tensor(np.asarray(t), dtype=torch.float64) for t in (A, lam, vecs))
    scale = float(lam.abs().max())
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), rtol=0, atol=tol * scale)
    rec = vecs @ torch.diag_embed(lam) @ vecs.mT
    assert float((rec - A).norm() / A.norm()) < 1e3 * tol
    eye = torch.eye(A.shape[-1], dtype=A.dtype)
    assert float((vecs.mT @ vecs - eye).abs().max()) < 1e3 * tol


@pytest.mark.parametrize("n", [40, 130])
def test_tridiag_eigh_matches_jax(n):
    rng = np.random.default_rng(n)
    d, e = rng.standard_normal((2, n)), rng.standard_normal((2, n - 1))
    lam_j, U_j = jax_tridiag_eigh(jnp.asarray(d), jnp.asarray(e))
    lam, U = tridiag_eigh(torch.as_tensor(d), torch.as_tensor(e))
    T = np.stack([np.diag(d[k]) + np.diag(e[k], 1) + np.diag(e[k], -1) for k in range(2)])
    _check_pairs(T, lam, U, lam_j, 1e-9)


@pytest.mark.parametrize("psd", [False, True], ids=["gaussian", "psd"])
@pytest.mark.parametrize("stage1", ["plain", "latrd", "latrd_v4"])
def test_eigh_stack_ts_matches_jax(stage1, psd):
    A = _sym(7, 2, 130, psd)
    lam_j, _ = jax_eigh_stack_ts(jnp.asarray(A), nb=16, stage1="xla")
    lam, vecs = eigh_stack_ts(torch.as_tensor(A), nb=16, stage1=stage1, device="cpu")
    _check_pairs(A, lam, vecs, lam_j, 1e-9)


def test_eigh_stack_ts_float32_polished():
    """float32 runs through the QR polish (`_orthonormalize`, where the JAX
    package applies CholeskyQR2); eigenvalues within n * eps32 * ||A||
    (~1e-5 at n = 100)."""
    A = _sym(8, 2, 100, psd=True).astype(np.float32)
    lam, vecs = eigh_stack_ts(torch.as_tensor(A), nb=16, device="cpu")
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    _check_pairs(A, lam, vecs, ref, 1e-5)


def test_float32_rank_deficient_spectrum():
    """A KFAC-like factor with a large cluster of numerically-zero
    eigenvalues: float32 D&C duplicates vectors inside the cluster, where
    CholeskyQR2 (the JAX package's polish) finds no Cholesky factor; the QR
    polish returns an orthonormal basis and accurate pairs."""
    X = np.maximum(np.random.default_rng(10).standard_normal((2, 40, 256)), 0)
    A = np.einsum("kri,krj->kij", X, X).astype(np.float32) / 40
    lam, vecs = eigh_stack_ts(torch.as_tensor(A), nb=16, device="cpu")
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    _check_pairs(A, lam, vecs, ref, 1e-5)


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eigh_stack_ts(torch.eye(3)[None])


def test_decompose_cpu_uses_eigh_and_counts_retries(monkeypatch):
    facs = [torch.as_tensor(_sym(s, 1, 6, psd=True)[0]) for s in range(3)]
    H = Kron([(facs[0], facs[1]), (facs[2],)])
    dec = H.decompose()
    for Qs, ls, F in zip(dec.eigenvectors, dec.eigenvalues, H.kfacs):
        for Q, l, M in zip(Qs, ls, F):
            torch.testing.assert_close(Q @ torch.diag(l) @ Q.T, M, atol=1e-12, rtol=0)
    # a NaN from the batched solver sends that factor through the retry
    real_eigh = torch.linalg.eigh

    def nan_once(M):
        L, W = real_eigh(M)
        return (L * np.nan, W) if M.ndim == 3 and M.shape[-1] == 6 else (L, W)

    monkeypatch.setattr(torch.linalg, "eigh", nan_once)
    before = matrix.SYMEIG_RETRIES
    dec = H.decompose()
    assert matrix.SYMEIG_RETRIES == before + 3
    assert all(torch.isfinite(l).all() for ls in dec.eigenvalues for l in ls)
