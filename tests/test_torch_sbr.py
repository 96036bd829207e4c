"""The port's successive band reduction (`laplace_jax_torch/ops/band.py`,
`ops/chase.py`) against the JAX package's, in float64 at the shapes of
`tests/test_band_reduce.py` and `tests/test_chase.py`.

Each output compares one to one (same reflector layout, logs and padding):
`band_reduce`'s B, V and taus and `band_to_tridiag`'s d, e, Vlog and taulog
within 1e-9, `apply_chase_q` within 1e-10 of the JAX package and of a
naive per-reflector product. The whole chain (band -> chase -> the port's
`tridiag_eigh` -> `apply_chase_q` -> `apply_q`) is held to
`numpy.linalg.eigh` at `test_chase.py`'s tolerances, a float32 chain to
`test_band_reduce.py`'s 1e-5, and zero rows and columns (dead units) must
take trivial reflectors without NaNs. Every JAX result is computed once, in
a module-scoped fixture.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.band import band_reduce as jax_band_reduce
from laplace_jax.ops.chase import apply_chase_q as jax_apply_chase_q
from laplace_jax.ops.chase import band_to_tridiag as jax_band_to_tridiag
from laplace_jax_torch.ops.band import band_reduce
from laplace_jax_torch.ops.chase import apply_chase_q, band_to_tridiag
from laplace_jax_torch.ops.tridiag import apply_q
from laplace_jax_torch.ops.tridiag_eig import tridiag_eigh

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

BAND_SHAPES = [(2, 16, 4), (1, 33, 8), (2, 96, 16), (2, 40, 64)]  # the last is the no-op
CHASE_SHAPES = [(2, 40, 8, 8), (1, 52, 4, 3), (2, 33, 8, 5)]  # (k, n, b, g)


def _spd(k, n, seed=0, dtype=np.float64):
    A = np.random.default_rng(seed).standard_normal((k, n, n)).astype(dtype)
    return np.einsum("kij,klj->kil", A, A) / n


def _band_of(A, b):
    i = np.arange(A.shape[1])
    return A * (np.abs(i[:, None] - i[None, :]) <= b)[None]


def _tridiag_dense(d, e):
    return np.stack([np.diag(dk) + np.diag(ek, 1) + np.diag(ek, -1) for dk, ek in zip(d, e)])


def _q_naive(Vlog, taulog, n, b):
    """Q = H_0 H_1 ... one reflector at a time in execution order
    time(s, t) = 3 s + t (`tests/test_chase.py`'s reference)."""
    K, _, n_sweeps = Vlog.shape
    Q = np.broadcast_to(np.eye(n), (K, n, n)).copy()
    for _, s, t in sorted((3 * s + t, s, t) for s in range(n_sweeps)
                          for t in range(taulog.shape[1])):
        r0 = s + t * b + 1
        if r0 >= n:
            continue
        v = np.zeros((K, n))
        v[:, r0:r0 + b] = Vlog[:, r0:r0 + b, s]
        Q = Q - taulog[:, t, s][:, None, None] * (Q @ v[:, :, None]) * v[:, None, :]
    return Q


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's outputs at every shape, computed once."""
    band = {}
    for k, n, b in BAND_SHAPES:
        A = _spd(k, n, seed=n + b)
        band[k, n, b] = A, [np.asarray(o) for o in jax_band_reduce(jnp.asarray(A), b=b)]
    chase = {}
    for k, n, b, g in CHASE_SHAPES:
        A = _band_of(_spd(k, n, seed=n + b), b)
        out = jax_band_to_tridiag(jnp.asarray(A), b=b)
        S = _spd(k, n, seed=5)[:, :, :n // 2 + 1]
        QS = jax_apply_chase_q(out[2], out[3], jnp.asarray(S), b=b, g=g)
        chase[k, n, b, g] = A, [np.asarray(o) for o in out], S, np.asarray(QS)
    return band, chase


@pytest.mark.parametrize("k,n,b", BAND_SHAPES)
def test_band_reduce_matches_jax(jax_results, k, n, b):
    A, ref = jax_results[0][k, n, b]
    out = band_reduce(_t(A), b=b)
    for name, got, want in zip(("B", "V", "taus"), out, ref):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("k,n,b,g", CHASE_SHAPES)
def test_band_to_tridiag_matches_jax(jax_results, k, n, b, g):
    A, ref, _, _ = jax_results[1][k, n, b, g]
    out = band_to_tridiag(_t(A), b)
    for name, got, want in zip(("d", "e", "Vlog", "taulog"), out, ref):
        assert tuple(got.shape) == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9, err_msg=name)
    # the chase keeps the spectrum
    T = _tridiag_dense(out[0].numpy(), out[1].numpy())
    np.testing.assert_allclose(np.linalg.eigvalsh(T), np.linalg.eigvalsh(A), atol=1e-9)


@pytest.mark.parametrize("k,n,b,g", CHASE_SHAPES)
def test_apply_chase_q_matches_jax_and_naive(jax_results, k, n, b, g):
    A, ref, S, QS = jax_results[1][k, n, b, g]
    _, _, Vlog, taulog = band_to_tridiag(_t(A), b)
    got = apply_chase_q(Vlog, taulog, _t(S), b=b, g=g).numpy()
    np.testing.assert_allclose(got, QS, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got, _q_naive(ref[2], ref[3], n, b) @ S, rtol=0, atol=1e-10)


def _chain(A, b):
    B, V1, t1 = band_reduce(A, b=b)
    d, e, V2, t2 = band_to_tridiag(B, b)
    lam, Ut = tridiag_eigh(d, e)
    return lam, apply_q(V1, t1, apply_chase_q(V2, t2, Ut, b=b))


def test_full_chain_matches_lapack():
    """band_reduce -> chase -> D&C -> both back-transforms == numpy eigh
    (`tests/test_chase.py:138-160`'s tolerances)."""
    k, n, b = 2, 48, 8
    A = _spd(k, n, seed=n)
    lam, vecs = (t.numpy() for t in _chain(_t(A), b))
    for kk in range(k):
        np.testing.assert_allclose(lam[kk], np.linalg.eigvalsh(A[kk]), atol=1e-9)
        np.testing.assert_allclose(vecs[kk].T @ vecs[kk], np.eye(n), atol=1e-10)
        np.testing.assert_allclose(vecs[kk] @ np.diag(lam[kk]) @ vecs[kk].T, A[kk], atol=1e-8)


def test_float32_chain():
    """In float32 (`tests/test_band_reduce.py:67-80`'s 1e-5): stage A's Q is
    orthogonal and Q B Q^T = A, and so is the whole chain's."""
    k, n, b = 2, 128, 16
    A = _t(_spd(k, n, seed=7, dtype=np.float32))
    assert A.dtype == torch.float32
    B, V, taus = band_reduce(A, b=b)
    Q = apply_q(V, taus, torch.eye(n).expand(k, n, n).clone()).double()
    An, nrm = A.double(), float(A.abs().max())
    eye = torch.eye(n, dtype=torch.float64)
    assert float((Q.mT @ Q - eye).abs().max()) < 1e-5
    assert float((Q @ B.double() @ Q.mT - An).abs().max()) / nrm < 1e-5
    lam, vecs = _chain(A, b)
    assert lam.dtype == vecs.dtype == torch.float32
    lam, vecs = lam.double(), vecs.double()
    assert float((vecs.mT @ vecs - eye).abs().max()) < 1e-5
    assert float((vecs @ torch.diag_embed(lam) @ vecs.mT - An).abs().max()) / nrm < 1e-5


def test_rank_deficient():
    """Zero rows and columns (dead units in a KFAC factor) take trivial
    reflectors without NaNs, in both stages (`tests/test_band_reduce.py:83`,
    `tests/test_chase.py:123`)."""
    A = _spd(1, 48, seed=3)
    A[:, 10:20, :] = 0.0
    A[:, :, 10:20] = 0.0
    B, V, taus = band_reduce(_t(A), b=8)
    assert all(bool(torch.isfinite(o).all()) for o in (B, V, taus))
    np.testing.assert_allclose(np.linalg.eigvalsh(B[0].numpy()), np.linalg.eigvalsh(A[0]),
                               atol=1e-9)

    A = _spd(1, 40, seed=3)
    A[:, 10:20, :] = 0.0
    A[:, :, 10:20] = 0.0
    A = _band_of(A, 8)
    out = band_to_tridiag(_t(A), 8)
    assert all(bool(torch.isfinite(o).all()) for o in out)
    T = _tridiag_dense(out[0].numpy(), out[1].numpy())
    np.testing.assert_allclose(np.linalg.eigvalsh(T[0]), np.linalg.eigvalsh(A[0]), atol=1e-9)


def test_small_and_narrow_bands_return_early():
    """n <= 2 or b <= 1: the band is already tridiagonal (the JAX package's
    shapes: Vlog (K, n, n), taulog (K, TCAP, n))."""
    A = _band_of(_spd(2, 6, seed=1), 1)
    d, e, Vlog, taulog = band_to_tridiag(_t(A), 1)
    np.testing.assert_allclose(d.numpy(), np.diagonal(A, axis1=1, axis2=2))
    np.testing.assert_allclose(e.numpy(), np.diagonal(A, offset=-1, axis1=1, axis2=2))
    assert tuple(Vlog.shape) == (2, 6, 6) and tuple(taulog.shape) == (2, 2, 6)
    assert not Vlog.any() and not taulog.any()
    S = _t(A)
    assert apply_chase_q(Vlog[:, :, :0], taulog[:, :, :0], S, b=1) is S  # no sweep: Q = I
