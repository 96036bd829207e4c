"""The port's v3 and v2 LATRD panels and stage-1 drivers against the JAX
package.

- One panel, plain port vs the JAX Pallas kernels (`latrd_panel_v3`,
  `_latrd_panel_v2`, interpret mode as `tests/test_latrd_v3.py` and
  `tests/test_latrd_pallas.py` run them), element-wise at 1e-5: the Pallas
  kernels route their segment selections through float32 dot_generals, so
  even their float64 outputs carry float32 rounding (as in
  `tests/test_torch_latrd.py`).
- One panel, plain port vs the first panel of the JAX package's XLA
  `tridiagonalize` in float64, element-wise at 1e-9.
- Whole stage 1 by invariants only (`Q T Q^T = A`, `Q^T Q = I`, spectrum) at
  1e-10, at the JAX tests' cases; and the whole solver through each
  stage-1 name against `torch.linalg.eigh`.

The CUDA kernels are held against these plain panels on the card in
`tests/test_torch_cuda_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.latrd_pallas_v2 import _latrd_panel_v2 as jax_latrd_panel_v2
from laplace_jax.ops.latrd_pallas_v3 import latrd_panel_v3 as jax_latrd_panel_v3
from laplace_jax.ops.tridiag import tridiagonalize as jax_tridiagonalize
from laplace_jax_torch.ops.latrd import tridiagonalize_latrd
from laplace_jax_torch.ops.latrd_v2 import (
    latrd_panel_v2,
    latrd_panel_v2_plain,
    tridiagonalize_latrd_v2,
)
from laplace_jax_torch.ops.latrd_v3 import (
    latrd_panel_v3,
    latrd_panel_v3_plain,
    tridiagonalize_latrd_v3,
)
from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts
from tests.test_torch_latrd import (
    _check_stage1,
    _psd_stack,
    _sym_stack,
    _sym_window,
    _unpack_pallas,
)

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)


@pytest.mark.parametrize("m,off", [(256, 16)])  # two T-wide tile columns, off > 0
def test_panel_v3_plain_matches_pallas_v3(m, off):
    K, nb, n_real, T = 2, 16, m - 6, 128
    A = _sym_window(np.random.default_rng(10), K, m, n_real)
    # the kernel's col-tile-major copy, as `tridiagonalize_pallas_v3` builds it
    A2 = jnp.transpose(jnp.asarray(A).reshape(K * m, m // T, T), (1, 0, 2))
    ref = _unpack_pallas(*jax_latrd_panel_v3(jnp.asarray(A), A2, off, 0, n_real, K=K, m=m,
                                             nb=nb, T=T, interpret=True), K, m, nb)
    got = latrd_panel_v3_plain(torch.as_tensor(A), off, 0, n_real, nb)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("m,off", [(128, 0), (256, 16)])
def test_panel_v2_plain_matches_pallas_v2(m, off):
    K, nb, n_real = 2, 16, m - 6
    A = _sym_window(np.random.default_rng(11), K, m, n_real)
    ref = _unpack_pallas(*jax_latrd_panel_v2(jnp.asarray(A), off, 0, n_real, K=K, m=m,
                                             nb=nb, TR=128, interpret=True), K, m, nb)
    got = latrd_panel_v2_plain(torch.as_tensor(A), off, 0, n_real, nb)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5)


@pytest.mark.parametrize("panel", [latrd_panel_v3_plain, latrd_panel_v2_plain])
def test_first_panel_matches_xla_tridiagonalize(panel):
    """d, e, tau and the reflectors of columns 0..nb-1 equal the JAX XLA
    formulation's to 1e-9 in float64."""
    K, n, nb = 2, 96, 16
    A = _sym_window(np.random.default_rng(12), K, n, n)
    d, e, V, taus = (np.asarray(a) for a in jax_tridiagonalize(jnp.asarray(A), nb=nb))
    UW, det = panel(torch.as_tensor(A), 0, 0, n, nb)
    np.testing.assert_allclose(det[:, 0].numpy(), d[:, :nb], atol=1e-9)
    np.testing.assert_allclose(det[:, 1].numpy(), e[:, :nb], atol=1e-9)
    np.testing.assert_allclose(det[:, 2].numpy(), taus[:, :nb], atol=1e-9)
    np.testing.assert_allclose(UW[:, :nb].numpy(), V[:, :n, :nb].transpose(0, 2, 1), atol=1e-9)


@pytest.mark.parametrize("make,nb,n_classes,T", [  # the cases of tests/test_latrd_v3.py
    pytest.param(lambda: _sym_stack(0, 2, 40), 16, 2, None, id="2x40"),
    pytest.param(lambda: _sym_stack(0, 1, 130), 16, 2, None, id="1x130"),
    pytest.param(lambda: _sym_stack(0, 3, 33), 16, 2, None, id="3x33"),
    pytest.param(lambda: _sym_stack(1, 2, 300), 32, 3, 128, id="2x300-multiwindow-multitile"),
    pytest.param(lambda: _psd_stack(3, 2, 64), 16, 2, None, id="psd-kfac-like"),
    pytest.param(lambda: _sym_stack(7, 2, 300), 200, 4, 128, id="nb200-above-class"),
])
def test_stage1_latrd_v3_invariants(make, nb, n_classes, T):
    A = make()
    out = tridiagonalize_latrd_v3(A, nb=nb, n_classes=n_classes, T=T)
    _check_stage1(A, out, max(8, min(nb, A.shape[-1])))


@pytest.mark.parametrize("k,n", [(2, 40), (2, 150)])  # tests/test_latrd_pallas.py v2 cases
def test_stage1_latrd_v2_invariants(k, n):
    A = _sym_stack(7, k, n)
    _check_stage1(A, tridiagonalize_latrd_v2(A, nb=16, n_classes=2), 16)


@pytest.mark.parametrize("n,nb", [(130, 20), (2, 64), (1, 64)])
def test_stage1_latrd_v2_delegates_to_v1(n, nb):
    """nb not a multiple of 8, or n <= 2: the reference's delegation to v1."""
    A = _sym_stack(8, 2, n)
    got = tridiagonalize_latrd_v2(A, nb=nb, n_classes=4)
    for g, r in zip(got, tridiagonalize_latrd(A, nb=nb, n_classes=4)):
        assert torch.equal(g, r)
    if n > 2:
        _check_stage1(A, got, 16)


@pytest.mark.parametrize("n", [1, 2])
def test_stage1_latrd_v3_tiny_n(n):
    d, e, V, taus = tridiagonalize_latrd_v3(_sym_stack(2, 2, n))
    assert d.shape == (2, n) and e.shape == (2, n - 1)


@pytest.mark.parametrize("stage1", ["latrd_v3", "latrd_v2"])
def test_eigh_stack_ts_stage1_name(stage1):
    A = _psd_stack(9, 2, 140)
    lam, Q = eigh_stack_ts(A, nb=16, stage1=stage1, device="cpu")
    torch.testing.assert_close(lam, torch.linalg.eigvalsh(A), atol=1e-10, rtol=0)
    torch.testing.assert_close(Q @ torch.diag_embed(lam) @ Q.mT, A, atol=1e-10, rtol=0)


def test_eigh_stack_ts_unknown_stage1_raises():
    with pytest.raises(ValueError):
        eigh_stack_ts(_sym_stack(0, 1, 8), stage1="latrd_v5", device="cpu")


def test_cpu_window_takes_plain_panel_and_counts_nothing():
    A = torch.as_tensor(_sym_window(np.random.default_rng(13), 2, 128, 128))
    before = (latrd_panel_v3.launches, latrd_panel_v2.launches)
    for kern, plain in ((latrd_panel_v3, latrd_panel_v3_plain),
                        (latrd_panel_v2, latrd_panel_v2_plain)):
        for g, r in zip(kern(A, 0, 0, 128, 8), plain(A, 0, 0, 128, 8)):
            assert torch.equal(g, r)
    assert (latrd_panel_v3.launches, latrd_panel_v2.launches) == before

