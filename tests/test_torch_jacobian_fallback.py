"""The whole-batch Jacobian fallback of the port's `CurvatureBackend`
(`laplace_jax/curvature/backend.py:30-48,136-205`), mirroring the four
tests of `tests/test_jacobian_fallback.py` against the JAX package in
float64 on the CPU.

A model whose parameters are shape-coupled to the batch (a `DenseGeneral`
with `batch_dims`) cannot run one sample: the backend warns with a
`RuntimeWarning` ("... QUADRATIC in batch size ...") and takes the whole
batch's Jacobian, cut to the subnetwork as the per-sample path cuts it. A
shape bug, which fails the whole batch too, still raises (torch's own
`RuntimeError` where JAX raises `TypeError`), and a healthy model does not
warn. Through the fallback, `DiagLaplace`, `FullLaplace`, the subnetwork and
the GP routes fit such a model. Tolerances: Jacobians 1e-12 absolute, as
the JAX test; H 1e-10 relative to its largest entry.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax_torch import DiagLaplace, FullLaplace, FunctionalLaplace, Laplace
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.models.flax_layers import DenseGeneral
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_twins import close

torch.set_num_threads(1)


class _FlaxBatchCoupled(fnn.Module):
    """`tests/test_jacobian_fallback.py`'s model: kernel coupled to the batch."""

    @fnn.compact
    def __call__(self, x):  # (B, T, D)
        h = fnn.DenseGeneral(4, batch_dims=(0,), param_dtype=jnp.float64)(x)
        return h.mean(axis=1)


class BatchCoupled(nn.Module):
    def __init__(self, batch=4, d=5):
        super().__init__()
        self.DenseGeneral_0 = DenseGeneral(d, 4, batch_dims=(0,), batch_shape=(batch,))

    def forward(self, x):
        return self.DenseGeneral_0(x).mean(1)


class ShapeBug(nn.Module):
    """Broken for every batch size: x against a mis-shaped kernel."""

    def __init__(self, d=5):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d + 1, 2, dtype=torch.float64))

    def forward(self, x):
        return x @ self.w


def _batch_coupled(seed):
    X = np.random.default_rng(seed).standard_normal((4, 3, 5))
    fm = _FlaxBatchCoupled()
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                    fm.init(jax.random.key(0), jnp.asarray(X)))
    tm = BatchCoupled().double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    return JaxNNModel.from_flax(fm, params), tm, X


def test_batch_coupled_model_warns_and_matches_naive():
    """The fallback warns, and its Jacobians are the whole-batch Jacobian's,
    the JAX package's and `torch.func.jacrev`'s of the batch's forward."""
    jm, tm, X = _batch_coupled(0)
    be = CurvatureBackend(NNModel(tm), "classification")
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        Js, f = be.jacobians(torch.as_tensor(X))
    theta = be.model.mean_vector
    naive = torch.func.jacrev(lambda t: be.model.apply_vec(t, torch.as_tensor(X)))(theta)
    np.testing.assert_allclose(Js.numpy(), naive.detach().numpy(), rtol=0, atol=1e-12)
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        Jj, fj = JaxBackend(jm, "classification").jacobians(jnp.asarray(X))
    np.testing.assert_allclose(Js.numpy(), np.asarray(Jj), rtol=0, atol=1e-12)
    close(f, fj, 1e-12)


def test_batch_coupled_subnet_warns():
    """With `subnetwork_indices` the fallback's columns are the subnetwork's,
    in index order, as the JAX package's."""
    jm, tm, X = _batch_coupled(1)
    idx = np.array([7, 0, 3, 12, 5, 1, 30, 2])
    be = CurvatureBackend(NNModel(tm), "classification",
                          subnetwork_indices=torch.as_tensor(idx))
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        Js, _ = be.jacobians(torch.as_tensor(X))
    assert Js.shape[-1] == 8
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        Jj, _ = JaxBackend(jm, "classification", subnetwork_indices=jnp.asarray(idx)).jacobians(
            jnp.asarray(X))
    np.testing.assert_allclose(Js.numpy(), np.asarray(Jj), rtol=0, atol=1e-12)


def test_shape_bug_model_raises():
    """A shape bug fails the whole batch too: the fallback's attempt warns,
    then torch's own error propagates."""
    X = np.random.default_rng(2).standard_normal((4, 5))
    be = CurvatureBackend(NNModel(ShapeBug()), "classification")
    with pytest.raises(RuntimeError, match="shapes cannot be multiplied"):
        with pytest.warns(RuntimeWarning, match="QUADRATIC"):
            be.jacobians(torch.as_tensor(X))


def test_other_errors_propagate_without_warning(recwarn):
    """An error that is no shape error (here a `NameError` in the forward)
    propagates at once, with no fallback."""

    class Broken(nn.Module):
        def __init__(self):
            super().__init__()
            self.Dense_0 = nn.Linear(5, 3).double()

        def forward(self, x):
            raise NameError("undefined_name")

    be = CurvatureBackend(NNModel(Broken()), "classification")
    with pytest.raises(NameError):
        be.jacobians(torch.zeros(4, 5, dtype=torch.float64))
    assert not [w for w in recwarn if issubclass(w.category, RuntimeWarning)]


def test_healthy_model_does_not_warn(recwarn):
    X = np.random.default_rng(3).standard_normal((4, 5))
    net = nn.Linear(5, 3).double()
    CurvatureBackend(NNModel(net), "classification").jacobians(torch.as_tensor(X))
    assert not [w for w in recwarn if issubclass(w.category, RuntimeWarning)]


@pytest.mark.parametrize("flavor", ["full", "diag"])
def test_fits_through_the_fallback_match_jax(flavor):
    """`FullLaplace` and `DiagLaplace` fit the batch-coupled model (one batch
    of 4, the kernel's batch) through the fallback, warning: H against the
    JAX backend's `full` / `diag` of that batch, which falls back too, and
    a finite marglik. (The JAX package's flavors read the output size from
    one input, which this model refuses; the port's read it from the whole
    batch then, `NNModel.output_probe`.)"""
    jm, tm, X = _batch_coupled(4)
    y = np.arange(4) % 4
    tcls = {"full": FullLaplace, "diag": DiagLaplace}[flavor]
    tla = tcls(tm, "classification", device="cpu")
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        tla.fit(ArrayLoader(X, y, batch_size=4))
    jb = JaxBackend(jm, "classification")
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        _, Hj = getattr(jb, flavor)(jnp.asarray(X), jnp.asarray(y), N=4)
    close(tla.H, Hj, 1e-10)
    assert np.isfinite(float(tla.log_marginal_likelihood()))


def test_subnetwork_and_gp_routes_fit_through_the_fallback():
    """The subnetwork route's H is the full GGN's block at its indices, and
    the GP route fits and predicts, both through the fallback."""
    _, tm, X = _batch_coupled(5)
    y = np.arange(4) % 4
    loader = ArrayLoader(X, y, batch_size=4)
    full = FullLaplace(tm, "classification", device="cpu")
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        full.fit(loader)
    idx = torch.tensor([0, 3, 9, 17, 40])
    sub = Laplace(tm, "classification", "subnetwork", "full", subnetwork_indices=idx,
                  device="cpu")
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        sub.fit(loader)
    close(sub.H, full.H[idx][:, idx].numpy(), 1e-12)
    gp = FunctionalLaplace(tm, "classification", n_subset=4, device="cpu")
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        gp.fit(loader)
    with pytest.warns(RuntimeWarning, match="QUADRATIC"):
        probs = gp(X)
    assert torch.isfinite(probs).all()
    np.testing.assert_allclose(probs.sum(-1).numpy(), 1.0, atol=1e-12)
