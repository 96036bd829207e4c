"""The exact tap diagonal and Laplace fits on the conv variants of
`tests/torch_conv_twins.py` against the JAX package in float64 on the CPU:
the GGN and EF diagonals through the taps (mask² on masked convs), the
mask-frozen entries' zero diagonal (`tests/test_masked_conv.py:103`), and a
`KronLaplace` and a `DiagLaplace` fit each (`tests/test_grouped_conv.py:108`,
`test_masked_conv.py:158`): log marginal likelihood and GLM probit.

Tolerances: Kron factors, Jacobians and diagonals 1e-10 relative to their
largest entry; the log marginal likelihood 1e-10 relative, the GLM probit
1e-10 absolute.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import DiagLaplace as JaxDiag
from laplace_jax import KronLaplace as JaxKron
from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import DiagLaplace, KronLaplace
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_conv_twins import MODELS, REL, pair
from .torch_twins import close

torch.set_num_threads(1)


@pytest.mark.parametrize("curv", ["ggn", "ef"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tap_diagonal_against_jax(name, curv):
    """The tap diagonal (the port's Jacobian path is disabled, so it is the
    taps or nothing), with mask² on masked convs, against the JAX
    package's."""
    jm, tm, X, y = pair(name)
    _, dj = JaxBackend(jm, "classification", curv_type=curv).diag(jnp.asarray(X),
                                                                  jnp.asarray(y))
    be = CurvatureBackend(NNModel(tm), "classification", curv_type=curv)
    be.jacobians = be.gradients = None
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, dt = be.diag(torch.as_tensor(X), torch.as_tensor(y))
    close(dt, dj, REL)


@pytest.mark.parametrize("name", ["masked", "masked_grouped"])
def test_masked_entries_have_zero_diagonal(name):
    """`tests/test_masked_conv.py:103`: a mask-frozen kernel entry moves no
    output, so its exact GGN diagonal is exactly 0; the others are not."""
    _, tm, X, y = pair(name)
    nnm = NNModel(tm)
    _, d = CurvatureBackend(nnm, "classification").diag(torch.as_tensor(X), torch.as_tensor(y))
    spec = next(s for s in nnm.leaf_specs if s.path == ("Conv_0", "kernel"))
    dk = d[spec.offset:spec.offset + spec.size].reshape(spec.shape).numpy()
    mask = np.broadcast_to(dict(MODELS[name][0][0][1])["mask"], spec.shape)
    assert np.all(dk[mask == 0] == 0.0)
    assert np.all(dk[mask == 1] != 0.0)


FITS = ["g4_s1_same", "depthwise", "circular_g2", "input_dilation", "masked", "conv1d",
        "conv3d", "torch_conv2d_circular"]


@pytest.mark.parametrize("flavor", ["kron", "diag"])
@pytest.mark.parametrize("name", FITS)
def test_fit_marglik_and_probit_against_jax(name, flavor):
    """`tests/test_grouped_conv.py:108` and `test_masked_conv.py:158`: a
    KronLaplace and a DiagLaplace fit in two batches, the log marginal
    likelihood and the GLM probit against the JAX package's."""
    jm, tm, X, y = pair(name)
    jcls, tcls = {"kron": (JaxKron, KronLaplace), "diag": (JaxDiag, DiagLaplace)}[flavor]
    jla = jcls(jm, "classification")
    jla.fit(JaxLoader(X, y, batch_size=3))
    tla = tcls(tm, "classification", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the 3-D net's InstanceNorm leaves under "skip"
        tla.fit(ArrayLoader(X, y, batch_size=3))
    lj = float(jla.log_marginal_likelihood())
    np.testing.assert_allclose(float(tla.log_marginal_likelihood()), lj, rtol=REL)
    pj = np.asarray(jla(jnp.asarray(X[:4]), pred_type="glm", link_approx="probit"))
    pt = tla(X[:4], pred_type="glm", link_approx="probit").numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=REL)
