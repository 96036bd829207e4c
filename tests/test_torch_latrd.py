"""The port's LATRD panels and stage-1 drivers against the JAX package.

- One panel, plain port vs the JAX Pallas kernels (`latrd_panel`,
  `latrd_panel_v4`, interpret mode as `tests/test_latrd_pallas.py` runs
  them), element-wise at 1e-5: the Pallas kernels route their segment
  selections through float32 dot_generals (`preferred_element_type=float32`),
  so even their float64 outputs carry float32 rounding (~2e-6 here).
- One panel, plain port vs the first panel of the JAX package's XLA
  formulation `tridiag.tridiagonalize` in float64, element-wise at 1e-9.
- Whole stage 1 by invariants only (`Q T Q^T = A`, `Q^T Q = I`, spectrum):
  reflector signs diverge chaotically between implementations
  (`tests/test_latrd_pallas.py:6-10`), so d/e are not compared.

The CUDA kernels are held against these plain panels on the card in
`tests/test_torch_cuda_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.latrd_pallas import latrd_panel as jax_latrd_panel
from laplace_jax.ops.latrd_pallas_v4 import latrd_panel_v4 as jax_latrd_panel_v4
from laplace_jax.ops.tridiag import tridiagonalize as jax_tridiagonalize
from laplace_jax_torch.ops.latrd import latrd_panel, latrd_panel_plain, tridiagonalize_latrd
from laplace_jax_torch.ops.latrd_v4 import (
    latrd_panel_v4,
    latrd_panel_v4_plain,
    tridiagonalize_latrd_v4,
)
from laplace_jax_torch.ops.tridiag import apply_q, tridiagonalize

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)


def _sym_window(rng, K, m, n_real, dtype=np.float64):
    A = rng.standard_normal((K, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    A[:, n_real:, :] = 0
    A[:, :, n_real:] = 0
    return A.astype(dtype)


def _unpack_pallas(UWT, det, K, m, nb):
    """Pallas (UWT (2nb, K*m), det (nb, 24)) -> port (UW (K, 2nb, m), det (K, 3, nb))."""
    UW = np.asarray(UWT).reshape(2 * nb, K, m).transpose(1, 0, 2)
    det = np.asarray(det)
    return UW, np.stack([det[:, :K].T, det[:, 8 : 8 + K].T, det[:, 16 : 16 + K].T], 1)


@pytest.mark.parametrize("m,off", [(128, 0), (256, 16)])
def test_panel_plain_matches_pallas_v1(m, off):
    K, nb, n_real = 2, 16, m - 6
    A = _sym_window(np.random.default_rng(0), K, m, n_real)
    ref = _unpack_pallas(*jax_latrd_panel(jnp.asarray(A), off, 0, n_real, K=K, m=m,
                                          nb=nb, interpret=True), K, m, nb)
    got = latrd_panel_plain(torch.as_tensor(A), off, 0, n_real, nb)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,off", [(128, 0), (256, 16)])
def test_panel_v4_plain_matches_pallas_v4(m, off):
    K, nb, n_real, T = 2, 16, m - 6, 128
    A = _sym_window(np.random.default_rng(1), K, m, n_real)
    H, nt = min(2 * T, m), m // T
    A2 = jnp.transpose(jnp.asarray(A).reshape(K * m, nt, T), (1, 0, 2))
    A2p = jnp.concatenate([A2, jnp.zeros((nt, H, T), A2.dtype)], axis=1)
    ref = _unpack_pallas(*jax_latrd_panel_v4(jnp.asarray(A), A2p, off, 0, n_real, K=K,
                                             m=m, nb=nb, T=T, H=H, interpret=True),
                         K, m, nb)
    got = latrd_panel_v4_plain(torch.as_tensor(A), off, 0, n_real, nb)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("panel", [latrd_panel_plain, latrd_panel_v4_plain])
def test_first_panel_matches_xla_tridiagonalize(panel):
    """d, e, tau and the reflectors of columns 0..nb-1 equal the JAX XLA
    formulation's to 1e-9 in float64 (no reflector has diverged yet)."""
    K, n, nb = 2, 96, 16
    A = _sym_window(np.random.default_rng(2), K, n, n)
    d, e, V, taus = (np.asarray(a) for a in jax_tridiagonalize(jnp.asarray(A), nb=nb))
    UW, det = panel(torch.as_tensor(A), 0, 0, n, nb)
    np.testing.assert_allclose(det[:, 0].numpy(), d[:, :nb], atol=1e-9)
    np.testing.assert_allclose(det[:, 1].numpy(), e[:, :nb], atol=1e-9)
    np.testing.assert_allclose(det[:, 2].numpy(), taus[:, :nb], atol=1e-9)
    np.testing.assert_allclose(UW[:, :nb].numpy(), V[:, :n, :nb].transpose(0, 2, 1), atol=1e-9)


def _assemble_T(d, e):
    return torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)


def _check_stage1(A, out, nb, tol=1e-10):
    d, e, V, taus = out
    K, n, _ = A.shape
    T = _assemble_T(d, e)
    Q = apply_q(V, taus, torch.eye(n, dtype=A.dtype).expand(K, n, n), nb=nb)
    scale = max(1.0, float(A.abs().max()))
    torch.testing.assert_close(Q @ T @ Q.mT, A, atol=tol * scale, rtol=0)
    torch.testing.assert_close(Q.mT @ Q, torch.eye(n, dtype=A.dtype).expand(K, n, n),
                               atol=tol, rtol=0)
    torch.testing.assert_close(torch.linalg.eigvalsh(T), torch.linalg.eigvalsh(A),
                               atol=tol * scale, rtol=0)


def _sym_stack(seed, K, n):
    A = torch.as_tensor(np.random.default_rng(seed).standard_normal((K, n, n)))
    return (A + A.mT) / 2


def _psd_stack(seed, K, n):
    rng = np.random.default_rng(seed)
    Q = np.linalg.qr(rng.standard_normal((K, n, n)))[0]
    lam = np.exp(-np.linspace(0.0, 10.0, n))[None] * (1 + rng.random((K, n)))
    A = torch.as_tensor(np.einsum("kij,kj,klj->kil", Q, lam, Q))
    return (A + A.mT) / 2


STAGE1_CASES = [  # (A, nb, n_classes) at the sizes of test_latrd_pallas.py / test_latrd_v4.py
    pytest.param(lambda: _sym_stack(0, 2, 40), 16, 2, id="2x40"),
    pytest.param(lambda: _sym_stack(0, 1, 130), 16, 2, id="1x130"),
    pytest.param(lambda: _sym_stack(0, 3, 33), 16, 2, id="3x33"),
    pytest.param(lambda: _sym_stack(1, 2, 150), 32, 2, id="2x150-multiwindow"),
    pytest.param(lambda: _psd_stack(3, 2, 64), 16, 2, id="psd-kfac-like"),
]


@pytest.mark.parametrize("make,nb,n_classes", STAGE1_CASES)
def test_stage1_latrd_invariants(make, nb, n_classes):
    A = make()
    _check_stage1(A, tridiagonalize_latrd(A, nb=nb, n_classes=n_classes), nb)


@pytest.mark.parametrize("make,nb,n_classes", STAGE1_CASES + [
    pytest.param(lambda: _sym_stack(1, 2, 300), 32, 3, id="2x300-multiwindow"),
    pytest.param(lambda: _sym_stack(6, 2, 130), 20, 4, id="nb20-rounds-down"),
])
def test_stage1_latrd_v4_invariants(make, nb, n_classes):
    A = make()
    _check_stage1(A, tridiagonalize_latrd_v4(A, nb=nb, n_classes=n_classes), nb)


@pytest.mark.parametrize("make,nb,n_classes", STAGE1_CASES)
def test_stage1_plain_invariants(make, nb, n_classes):
    A = make()
    _check_stage1(A, tridiagonalize(A, nb=nb, n_classes=n_classes), nb)


@pytest.mark.parametrize("n", [1, 2])
def test_stage1_tiny_n(n):
    A = _sym_stack(2, 2, n)
    for fn in (tridiagonalize, tridiagonalize_latrd, tridiagonalize_latrd_v4):
        d, e, V, taus = fn(A)
        assert d.shape == (2, n) and e.shape == (2, n - 1)


def test_cpu_window_takes_plain_panel_and_counts_nothing():
    A = torch.as_tensor(_sym_window(np.random.default_rng(3), 2, 128, 128))
    before = (latrd_panel.launches, latrd_panel_v4.launches)
    for kern, plain in ((latrd_panel, latrd_panel_plain), (latrd_panel_v4, latrd_panel_v4_plain)):
        for g, r in zip(kern(A, 0, 0, 128, 8), plain(A, 0, 0, 128, 8)):
            assert torch.equal(g, r)
    assert (latrd_panel.launches, latrd_panel_v4.launches) == before
