"""The port's tap diagonal (`curvature/diag_taps.py`) in float64 on the CPU:
against the port's own Jacobian and gradient paths, and against the JAX
package's diagonal, on an MLP, a two-conv net, ResNet-18 at width 8 and
WideResNet-16 at widen 1 on 8x8 inputs under BatchNorm, GroupNorm and
LayerNorm, for the GGN and the EF in classification and regression.

Oracles mirrored: `tests/test_curvature.py:298` (the tap diagonal equals
the Jacobian path), `:323` (on a conv net), `tests/test_kron_norm.py:124`
and `:137` (on norm layers). An all-weights `DiagLaplace` fit builds no
(B, C, P) array: `CurvatureBackend.jacobians` is patched to raise. The
chunk of samples whose kernel gradients are held at once changes no
number. A leaf outside the tapped layers falls back to the exact Jacobian
path. Tolerance: 1e-9 relative to the largest entry (1e-12 between two
chunkings of the same sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax_torch import DiagLaplace
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.curvature.diag_taps import TapUnsupported, diag_curvature_taps
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_twins import (
    bncnn_pair,
    classification,
    close,
    conv_pair,
    mlp_pair,
    regression,
    resnet_pair,
    scaled_pair,
    wrn_pair,
)

torch.set_num_threads(1)

MODELS = {
    "mlp": (mlp_pair, (3,), 2),
    "conv": (conv_pair, (6, 6, 2), 3),
    "resnet18_w8": (resnet_pair, (8, 8, 3), 10),
    "wrn_batch": (lambda: wrn_pair("batch"), (8, 8, 3), 4),
    "wrn_group": (lambda: wrn_pair("group"), (8, 8, 3), 4),
    "wrn_layer": (lambda: wrn_pair("layer"), (8, 8, 3), 4),
    "bncnn_layer": (lambda: bncnn_pair("layer"), (6, 6, 2), 3),  # a LayerNorm on (B, 6)
}


@pytest.fixture(scope="module", params=sorted(MODELS))
def model(request):
    make, shape, C = MODELS[request.param]
    jm, tm = make()
    return dict(name=request.param, jm=jm, nnm=NNModel(tm), shape=shape, C=C)


def _data(model, likelihood, n=6, seed=3):
    make = classification if likelihood == "classification" else regression
    X, y = make(n, model["shape"], model["C"], seed)
    return X, y, torch.as_tensor(X), torch.as_tensor(y)


def _jacobian_diag(be, Xt, yt):
    """The diagonal from the Jacobian (GGN) or per-sample gradient (EF)
    paths, written out here."""
    if be.curv_type == "ef":
        G, _ = be.gradients(Xt, yt)
        return be.factor * (G * G).sum(0)
    Js, f = be.jacobians(Xt)
    lam = be._functional_hessian(f)
    if lam is None:
        return torch.einsum("bcp,bcp->p", Js, Js)
    return torch.einsum("bcp,bck,bkp->p", Js, lam, Js)


@pytest.mark.parametrize("curv", ["ggn", "ef"])
@pytest.mark.parametrize("likelihood", ["classification", "regression"])
def test_tap_diagonal_equals_the_jacobian_path(model, likelihood, curv):
    """`tests/test_curvature.py:298` and `:323`, `tests/test_kron_norm.py:124`
    and `:137`: the backend's diagonal is the taps' and equals the
    Jacobian (GGN) or gradient (EF) path's."""
    _, _, Xt, yt = _data(model, likelihood)
    be = CurvatureBackend(model["nnm"], likelihood, curv)
    assert be._can_use_taps()
    loss, d = be.diag(Xt, yt)
    loss_t, d_t = diag_curvature_taps(model["nnm"], Xt, yt, likelihood, be.lossfunc, curv)
    close(d, (d_t * (be.factor if curv == "ef" else 1.0)).numpy(), 0.0)
    close(d, _jacobian_diag(be, Xt, yt).numpy(), 1e-9)
    with torch.no_grad():
        ref = be.factor * float(be.lossfunc(model["nnm"].apply(Xt), yt))
    np.testing.assert_allclose(float(loss), ref, rtol=1e-12)


def test_tap_diagonal_matches_jax(model):
    """The port's GGN and EF tap diagonals against the JAX package's (its
    own taps) in classification (one JAX program for both)."""
    X, y, Xt, yt = _data(model, "classification")
    ref = jax.jit(lambda a, b: [JaxBackend(model["jm"], "classification", c).diag(a, b)
                                for c in ("ggn", "ef")])(jnp.asarray(X), jnp.asarray(y))
    for curv, (lj, dj) in zip(("ggn", "ef"), ref):
        lt, dt = CurvatureBackend(model["nnm"], "classification", curv).diag(Xt, yt)
        close(dt, dj, 1e-9)
        np.testing.assert_allclose(float(lt), float(lj), rtol=1e-12)


def test_chunking_changes_no_number(model):
    """Kernel gradients of one sample at a time against the default chunk."""
    _, _, Xt, yt = _data(model, "classification")
    be = CurvatureBackend(model["nnm"], "classification")
    _, ref = diag_curvature_taps(model["nnm"], Xt, yt, "classification", be.lossfunc)
    _, one = diag_curvature_taps(model["nnm"], Xt, yt, "classification", be.lossfunc,
                                 chunk_bytes=1)
    close(one, ref.numpy(), 1e-12)


@pytest.mark.parametrize("name,make,shape,C", [("conv", conv_pair, (6, 6, 2), 3),
                                               ("wrn_batch", lambda: wrn_pair("batch"),
                                                (8, 8, 3), 4)])
def test_diag_laplace_builds_no_jacobian(name, make, shape, C, monkeypatch):
    """An all-weights `DiagLaplace` fit (GGN and EF) never calls the
    per-sample Jacobians, and its H is the Jacobian path's."""
    _, tm = make()
    X, y = classification(8, shape, C, 5)
    ref = {}
    for backend in ("ggn", "ef"):
        be = CurvatureBackend(NNModel(tm), "classification", backend)
        ref[backend] = sum(_jacobian_diag(be, torch.as_tensor(X[s]), torch.as_tensor(y[s]))
                           for s in (slice(0, 4), slice(4, 8)))

    def no_jacobians(*args, **kwargs):
        raise AssertionError("the tap diagonal built per-sample Jacobians")

    monkeypatch.setattr(CurvatureBackend, "jacobians", no_jacobians)
    for backend in ("ggn", "ef"):
        la = DiagLaplace(tm, "classification", backend=backend, device="cpu")
        la.fit(ArrayLoader(X, y, batch_size=4))
        close(la.H, ref[backend].numpy(), 1e-9)
        assert np.isfinite(float(la.log_marginal_likelihood()))


def test_untapped_leaf_falls_back_to_the_jacobian_path():
    """A bare parameter outside the tapped layers raises `TapUnsupported`;
    the backend then takes the exact Jacobian path, as the JAX package's."""
    jm, tm = scaled_pair()
    nnm = NNModel(tm)
    X, y = classification(6, (4,), 3, 2)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)
    be = CurvatureBackend(nnm, "classification")
    with pytest.raises(TapUnsupported):
        diag_curvature_taps(nnm, Xt, yt, "classification", be.lossfunc)
    _, d = be.diag(Xt, yt)
    close(d, _jacobian_diag(be, Xt, yt).numpy(), 1e-12)
    _, dj = jax.jit(JaxBackend(jm, "classification").diag)(jnp.asarray(X), jnp.asarray(y))
    close(d, dj, 1e-9)
