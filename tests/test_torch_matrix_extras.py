"""The port's `Kron` (`init_from_params`, `bmm`, `logdet`, `diag`,
`to_matrix`), `KronDecomposed` (`diag`, `to_matrix`) and the
`utils/linalg` helpers (`kron`, `block_diag`, `diagonal_add_scalar`,
`is_valid_scalar`) against `laplace_jax/utils/{matrix,linalg}.py` in
float64, on the cases of `tests/test_matrix.py`.

The decomposed factors are the JAX package's own eigenpairs, handed to the
port's `KronDecomposed`, so both sides work on the same numbers.
Tolerance: 1e-9 relative to the largest entry of the JAX result
(1e-12 for products with no accumulation to speak of).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.utils import Kron as JaxKron
from laplace_jax.utils import linalg as jax_linalg
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.utils import linalg
from laplace_jax_torch.utils.flatten import leaf_specs
from laplace_jax_torch.utils.matrix import Kron, KronDecomposed

from .utils import get_psd_matrix, make_mlp

REL = 1e-9


def _close(got, ref, rel=REL):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture
def pair():
    """Two groups: (3x3) ⊗ (2x2) and a 2x2 block, in both packages."""
    A, B, F = (get_psd_matrix(3, seed=1), get_psd_matrix(2, seed=2), get_psd_matrix(2, seed=3))
    return JaxKron([(A, B), (F,)]), Kron([(_t(A), _t(B)), (_t(F),)])


def test_init_from_params_matches_jax():
    """Zero factors shaped like the JAX package's, from the MLP twin's
    leaves in canonical order and flax layout."""
    _, params = make_mlp(in_dim=3, hidden=5, out_dim=2)
    ref = JaxKron.init_from_params(params)
    net = MLP(3, (5,), 2).double()
    shapes = [s.shape for s in leaf_specs(net)]
    got = Kron.init_from_params(shapes, dtype=torch.float64)
    assert [[tuple(H.shape) for H in F] for F in got.kfacs] == \
        [[tuple(H.shape) for H in F] for F in ref.kfacs]
    assert got.group_sizes == [5, 15, 2, 10]
    assert all(float(H.abs().max()) == 0.0 and H.dtype == torch.float64
               for F in got.kfacs for H in F)
    from_tensors = Kron.init_from_params([p.detach() for p in net.parameters()])
    assert all(H.dtype == torch.float64 for F in from_tensors.kfacs for H in F)


def test_to_matrix_and_diag_match(pair):
    jk, tk = pair
    _close(tk.to_matrix().numpy(), jk.to_matrix(), 1e-12)
    _close(tk.diag().numpy(), jk.diag(), 1e-12)
    _close(tk.diag().numpy(), np.diag(tk.to_matrix().numpy()), 1e-12)


def test_logdet_matches(pair):
    jk, tk = pair
    np.testing.assert_allclose(float(tk.logdet()), float(jk.logdet()), rtol=REL)
    np.testing.assert_allclose(float(tk.logdet()),
                               np.linalg.slogdet(tk.to_matrix().numpy())[1], rtol=REL)


@pytest.mark.parametrize("ndim", [1, 2, 3])
def test_bmm_matches(pair, ndim):
    jk, tk = pair
    rng = np.random.default_rng(ndim)
    W = rng.standard_normal({1: (8,), 2: (4, 8), 3: (4, 3, 8)}[ndim])
    _close(tk.bmm(_t(W)).numpy(), jk.bmm(jnp.asarray(W)))
    with pytest.raises(ValueError, match="decomposition"):
        tk.bmm(_t(W), exponent=-1)


def _decomposed_pair(jk, delta, damping):
    jd = jk.decompose(damping=damping) + jnp.asarray(delta)
    td = KronDecomposed([[_t(Q) for Q in Qs] for Qs in jd.eigenvectors],
                        [[_t(l) for l in ls] for ls in jd.eigenvalues],
                        deltas=_t(jd.deltas), damping=damping)
    return jd, td


@pytest.mark.parametrize("damping", [False, True])
@pytest.mark.parametrize("exponent", [1, -1, -0.5])
def test_decomposed_diag_and_to_matrix_match(pair, exponent, damping):
    jd, td = _decomposed_pair(pair[0], 0.1, damping)
    _close(td.to_matrix(exponent).numpy(), jd.to_matrix(exponent=exponent))
    _close(td.diag(exponent).numpy(), jd.diag(exponent=exponent))
    _close(td.diag(exponent).numpy(), np.diag(td.to_matrix(exponent).numpy()))


def test_decomposed_bmm_matches_its_matrix(pair):
    """`bmm` with exponent e is the product with `to_matrix(e)`."""
    _, td = _decomposed_pair(pair[0], 0.3, False)
    W = torch.as_tensor(np.random.default_rng(4).standard_normal((5, 8)))
    for e in (1, -1, -0.5):
        _close(td.bmm(W, exponent=e).numpy(), (W @ td.to_matrix(e).mT).numpy())


def test_kron_and_block_diag_match():
    rng = np.random.default_rng(5)
    A, B, C = rng.standard_normal((3, 3)), rng.standard_normal((2, 4)), rng.standard_normal((1, 1))
    _close(linalg.kron(_t(A), _t(B)).numpy(), jax_linalg.kron(jnp.asarray(A), jnp.asarray(B)),
           1e-15)
    _close(linalg.block_diag([_t(A), _t(C), _t(A)]).numpy(),
           jax_linalg.block_diag([jnp.asarray(A), jnp.asarray(C), jnp.asarray(A)]), 0)
    _close(linalg.diagonal_add_scalar(_t(A), 0.7).numpy(),
           jax_linalg.diagonal_add_scalar(jnp.asarray(A), 0.7), 1e-15)


@pytest.mark.parametrize("value", [1, 2.5, np.float64(3.0), np.array(1.0), np.array([2.0]),
                                   np.array([1.0, 2.0]), np.ones((2, 2)), "a", None])
def test_is_valid_scalar_matches(value):
    ref = jax_linalg.is_valid_scalar(value)
    assert linalg.is_valid_scalar(value) == ref
    if isinstance(value, np.ndarray):
        assert linalg.is_valid_scalar(torch.as_tensor(value)) == ref
