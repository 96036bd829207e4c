"""The port's multi-device `Kron.decompose(devices=...)` against its
single-device decompose and the JAX package's multi-device decompose over
8 virtual CPU devices, in float64 (mirrors `tests/test_decompose_multidevice.py`).

On the CPU a list that names the same device several times exercises the
assignment: factors go greedily, largest n³ first, to the least-loaded
device, one batched eigensolve per (device, shape, dtype). Tolerances, the
JAX file's: eigenvalues rtol 1e-10 (atol 1e-12), reconstructions Q L Qᵀ
rtol 1e-8 (atol 1e-10; vectors may rotate within degenerate eigenspaces),
log determinants rtol 1e-10. A `DeviceMesh` stands for this process's own
device.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from laplace_jax.utils.matrix import Kron as JaxKron
from laplace_jax_torch.utils import matrix
from laplace_jax_torch.utils.matrix import Kron

SHAPES = [(17, 5), (9, 3), (33, 7)]  # (n_in, n_out) of each layer, a bias factor beside


def _factors(seed):
    rng = np.random.default_rng(seed)
    kfacs = []
    for n_in, n_out in SHAPES:
        A = rng.standard_normal((n_in, n_in))
        B = rng.standard_normal((n_out, n_out))
        kfacs.append((A @ A.T, B @ B.T))
        bias = rng.standard_normal((n_out, n_out))
        kfacs.append((bias @ bias.T,))
    return kfacs


def _kron(seed=0):
    return Kron([tuple(torch.as_tensor(F) for F in G) for G in _factors(seed)])


def _assert_same(dec, ref):
    for Qr, lr, Qm, lm in zip(ref.eigenvectors, ref.eigenvalues, dec.eigenvectors,
                              dec.eigenvalues):
        for qr, er, qm, em in zip(Qr, lr, Qm, lm):
            qr, er, qm, em = (np.asarray(a) for a in (qr, er, qm, em))
            np.testing.assert_allclose(em, er, rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(qm * em @ qm.T, qr * er @ qr.T, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("n_devices", [2, 3, 8])
def test_multi_device_decompose_matches_single_and_jax(n_devices):
    K = _kron()
    multi = K.decompose(devices=[torch.device("cpu")] * n_devices)
    _assert_same(multi, K.decompose())
    jk = JaxKron([tuple(jnp.asarray(F) for F in G) for G in _factors(0)])
    assert len(jax.devices()) == 8
    _assert_same(multi, jk.decompose(devices=jax.devices()[:n_devices]))


def test_factors_go_largest_first_to_the_least_loaded_device(monkeypatch):
    """Over two devices the 33² factor (33³ = 35937) fills the first and
    every other factor (together 13,032) goes to the second: one batched
    call per (device, shape), the devices in turn, each device's classes in
    factor order."""
    calls = []
    real = matrix._batched_eigh_clipped

    def record(stack):
        calls.append(tuple(stack.shape))
        return real(stack)

    monkeypatch.setattr(matrix, "_batched_eigh_clipped", record)
    _kron().decompose(devices=["cpu", "cpu"])
    assert calls == [(1, 33, 33), (1, 17, 17), (2, 5, 5), (1, 9, 9), (2, 3, 3), (2, 7, 7)]


def test_multi_device_nan_takes_the_retry(monkeypatch):
    """A NaN from one device's batched solve sends those factors through the
    `symeig` jitter retry after the one flag read, and counts them."""
    real_eigh = torch.linalg.eigh

    def nan_on_7(M):
        L, W = real_eigh(M)
        return (L * np.nan, W) if M.ndim == 3 and M.shape[-1] == 7 else (L, W)

    monkeypatch.setattr(torch.linalg, "eigh", nan_on_7)
    before = matrix.SYMEIG_RETRIES
    dec = _kron().decompose(devices=["cpu"] * 3)
    assert matrix.SYMEIG_RETRIES == before + 2
    assert all(torch.isfinite(l).all() for ls in dec.eigenvalues for l in ls)
    monkeypatch.setattr(torch.linalg, "eigh", real_eigh)
    _assert_same(dec, _kron().decompose())


@pytest.fixture
def world_of_one():
    """A process group of this one process, torn down after the test."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_multi_device_decompose_mesh_argument(world_of_one):
    from laplace_jax_torch.parallel import data_mesh

    K = _kron(1)
    multi = K.decompose(devices=data_mesh())
    ref = K.decompose()
    deltas = torch.ones(len(K.kfacs), dtype=torch.float64)
    np.testing.assert_allclose((multi + deltas).logdet(), (ref + deltas).logdet(), rtol=1e-10)
    jk = JaxKron([tuple(jnp.asarray(F) for F in G) for G in _factors(1)])
    jref = jk.decompose(devices=jax.devices())
    np.testing.assert_allclose((multi + deltas).logdet(),
                               np.asarray((jref + jnp.ones(len(K.kfacs))).logdet()), rtol=1e-10)


def test_damping_and_dtype_carry_over():
    K = Kron([tuple(F.float() for F in G) for G in _kron().kfacs])
    dec = K.decompose(damping=True, devices=["cpu", "cpu"])
    assert dec.damping and all(l.dtype == torch.float32 for ls in dec.eigenvalues for l in ls)
    ref = K.decompose(damping=True)
    torch.testing.assert_close((dec + 0.5).logdet(), (ref + 0.5).logdet(), rtol=1e-5, atol=0)
