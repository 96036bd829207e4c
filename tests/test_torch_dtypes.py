"""The port's float32 and bfloat16 tier for the six core flavors (mirrors
`tests/test_dtypes.py`): fit, posterior dtype, marglik, prior tuning, the
probit and MC predictives, sampling, regression's predictive and the
marglik gradient in both hyperparameters (`torch.autograd.grad` in place
of `jax.grad`), and `symeig` on a near-singular float32 factor.

Every tier starts from the same weights: the flax MLP (4 -> 10 -> out,
tanh) initialized in float64 and cast, carried into the torch twin
(`state_dict_from_flax`). Tolerances, the JAX file's: float32 probit rows
sum to 1 within 1e-5 (MC rows within 1e-4); float32 against float64 (the
port's and the JAX package's) probit within 5e-4 absolute and marglik
within 1e-3 relative; bfloat16 rows within 2e-2. bfloat16 stays with the
diagonal flavors, as in the JAX package (`torch.linalg.eigh` and
`cholesky` take no bfloat16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import DiagLaplace as JaxDiag
from laplace_jax import FullLaplace as JaxFull
from laplace_jax import KronLaplace as JaxKron
from laplace_jax.models import MLP as FlaxMLP
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import (
    DiagLaplace,
    DiagLLLaplace,
    FullLaplace,
    FullLLLaplace,
    KronLaplace,
    KronLLLaplace,
)
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.matrix import Kron

torch.set_num_threads(1)

ALL_CLS = [FullLaplace, KronLaplace, DiagLaplace, FullLLLaplace, KronLLLaplace, DiagLLLaplace]
JAX_CLS = {FullLaplace: JaxFull, KronLaplace: JaxKron, DiagLaplace: JaxDiag}


def _data(likelihood, n=20, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    if likelihood == "regression":
        return X, rng.standard_normal((n, 2)).astype(np.float32), 2
    return X, rng.integers(0, 3, size=(n,)), 3


def _setup(dtype, likelihood="classification", seed=0):
    """The torch MLP in `dtype`, its loader and test inputs."""
    X, y, out = _data(likelihood, seed=seed)
    params = FlaxMLP(hidden=(10,), out_dim=out, dtype=jnp.float64).init(
        jax.random.key(seed), jnp.asarray(X[:1], dtype=jnp.float64))
    net = MLP(4, (10,), out).double()
    net.load_state_dict(state_dict_from_flax(params, net))
    net = net.to(dtype)
    Xt = torch.as_tensor(X).to(dtype)
    y = torch.as_tensor(y).to(dtype) if likelihood == "regression" else y
    return net, ArrayLoader(Xt, y, batch_size=8), Xt


def _jax_f64(cls):
    X, y, out = _data("classification")
    model = FlaxMLP(hidden=(10,), out_dim=out, dtype=jnp.float64)
    params = model.init(jax.random.key(0), jnp.asarray(X[:1], dtype=jnp.float64))
    la = JAX_CLS[cls](JaxNNModel.from_flax(model, params), "classification")
    X64 = X.astype(np.float64)
    la.fit(JaxLoader(X64, y, batch_size=8))
    return (np.asarray(la(jnp.asarray(X64[:6]), link_approx="probit")),
            float(la.log_marginal_likelihood()))


def _leaves(H):
    if isinstance(H, Kron):
        return [F for G in H.kfacs for F in G]
    return [H]


@pytest.mark.parametrize("cls", ALL_CLS, ids=lambda c: c.__name__)
def test_f32_fit_predict_marglik(cls):
    net, loader, X = _setup(torch.float32)
    la = cls(net, "classification", device="cpu")
    la.fit(loader)
    assert la._dtype == torch.float32
    for leaf in _leaves(la.H_facs if isinstance(la, KronLaplace) else la.H):
        assert leaf.dtype == torch.float32 and torch.isfinite(leaf).all()
    assert la.prior_precision.dtype == torch.float32
    assert np.isfinite(float(la.log_marginal_likelihood()))
    la.optimize_prior_precision(n_steps=10)
    assert la.prior_precision.dtype == torch.float32
    assert np.isfinite(float(la.log_marginal_likelihood()))
    probs = la(X[:6], link_approx="probit")
    assert probs.dtype == torch.float32
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-5)
    probs_mc = la(X[:6], link_approx="mc", n_samples=40,
                  generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(probs_mc.sum(-1).numpy(), 1.0, atol=1e-4)
    s = la.sample(8, generator=torch.Generator().manual_seed(0))
    assert s.dtype == torch.float32 and torch.isfinite(s).all()


@pytest.mark.parametrize("cls", [FullLaplace, KronLaplace, DiagLaplace], ids=lambda c: c.__name__)
def test_f32_regression_predictive_and_sigma(cls):
    net, loader, X = _setup(torch.float32, likelihood="regression")
    la = cls(net, "regression", sigma_noise=0.7, device="cpu")
    la.fit(loader)
    f_mu, f_var = la(X[:6])
    assert f_mu.dtype == f_var.dtype == torch.float32
    assert torch.isfinite(f_mu).all() and torch.isfinite(f_var).all()
    assert (torch.diagonal(f_var, dim1=-2, dim2=-1) >= -1e-5).all()
    # marglik differentiable in both hyperparameters at float32
    lp = torch.zeros(1, dtype=torch.float32, requires_grad=True)
    ls = torch.zeros((), dtype=torch.float32, requires_grad=True)
    grads = torch.autograd.grad(-la._log_marglik(lp.exp(), ls.exp()), (lp, ls))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in grads)


@pytest.mark.parametrize("cls", ALL_CLS, ids=lambda c: c.__name__)
def test_f32_matches_f64_within_tolerance(cls):
    """The float32 posterior tracks the float64 one, the port's and, for
    the all-weights flavors, the JAX package's."""
    (net32, loader32, X32), (net64, loader64, X64) = (_setup(torch.float32),
                                                      _setup(torch.float64))
    la32 = cls(net32, "classification", device="cpu")
    la32.fit(loader32)
    la64 = cls(net64, "classification", device="cpu")
    la64.fit(loader64)
    p32 = la32(X32[:6], link_approx="probit").double().numpy()
    refs = [(la64(X64[:6], link_approx="probit").numpy(), float(la64.log_marginal_likelihood()))]
    if cls in JAX_CLS:
        refs.append(_jax_f64(cls))
    ml32 = float(la32.log_marginal_likelihood())
    for p64, ml64 in refs:
        np.testing.assert_allclose(p32, p64, atol=5e-4)
        np.testing.assert_allclose(ml32, ml64, rtol=1e-3)


def test_f32_symeig_robust_near_singular():
    """Near-singular float32 factors decompose without NaN (the jitter
    retry path, reference `utils/utils.py:193-228`)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 2)).astype(np.float32)
    F = torch.as_tensor(a @ a.T)  # rank 2, PSD, float32
    dec = Kron([(F,), (F * 1e-30,)]).decompose()
    for ls in dec.eigenvalues:
        assert ls[0].dtype == torch.float32
        assert torch.isfinite(ls[0]).all() and (ls[0] >= 0).all()
    assert torch.isfinite((dec + 0.5).logdet())


@pytest.mark.parametrize("cls", [DiagLaplace, DiagLLLaplace], ids=lambda c: c.__name__)
def test_bf16_diag_fit_predict(cls):
    """The bfloat16 tier where it is sane: the diagonal posterior
    (elementwise operations only)."""
    net, loader, X = _setup(torch.bfloat16)
    la = cls(net, "classification", device="cpu")
    la.fit(loader)
    assert la.H.dtype == torch.bfloat16 and torch.isfinite(la.H.float()).all()
    probs = la(X[:6], link_approx="probit")
    np.testing.assert_allclose(probs.float().sum(-1).numpy(), 1.0, atol=2e-2)
    s = la.sample(4, generator=torch.Generator().manual_seed(0))
    assert s.dtype == torch.bfloat16 and torch.isfinite(s.float()).all()
    assert np.isfinite(float(la.log_marginal_likelihood()))


def test_bf16_tap_diagonal_on_a_conv_net():
    """The all-weights tap diagonal (conv and Dense taps) of a width-4
    ResNet-18 in bfloat16, the card's bfloat16 row in small: finite, within
    3e-2 of the float32 diagonal's largest entry (bfloat16 keeps 8 bits; 1.1e-2
    read here), probit rows within 2e-2."""
    from laplace_jax_torch.models.resnet import ResNet18

    rng = np.random.default_rng(0)
    X = rng.standard_normal((16, 8, 8, 3)).astype(np.float32)
    y = rng.integers(0, 10, 16)
    loader = ArrayLoader(X, y, batch_size=8)
    net = ResNet18(width=4, generator=torch.Generator().manual_seed(0))
    d32 = DiagLaplace(net, "classification", device="cpu")
    d32.fit(loader)
    db = DiagLaplace(ResNet18(width=4, generator=torch.Generator().manual_seed(0))
                     .to(torch.bfloat16), "classification", device="cpu")
    db.fit(loader)
    assert db.H.dtype == torch.bfloat16 and torch.isfinite(db.H.float()).all()
    err = float((db.H.float() - d32.H).abs().max() / d32.H.abs().max())
    assert err <= 3e-2, err
    probs = db(X[:4])
    np.testing.assert_allclose(probs.float().sum(-1).numpy(), 1.0, atol=2e-2)
