"""KFAC on the conv variants of `tests/torch_conv_twins.py` (grouped,
depthwise, circular, input-dilated, masked, 1-D and 3-D convs, torch's own
conv modules) against the JAX package in float64 on the CPU: the factors
and warnings under each `kron_unsupported` policy (every conv leaf is
tapped; only the 3-D net's InstanceNorm leaves follow the policy), and
`tests/test_grouped_conv.py`'s shape and additivity contracts.

Tolerances: Kron factors, Jacobians and diagonals 1e-10 relative to their
largest entry; the log marginal likelihood 1e-10 relative, the GLM probit
1e-10 absolute.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.nnmodel import NNModel

from .torch_conv_twins import MODELS, N, REL, pair
from .torch_twins import close, outcome

torch.set_num_threads(1)


@pytest.mark.parametrize("policy", ["skip", "block", "raise"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_kron_against_jax(name, policy):
    """The same Kron factors and warnings (or exception class) as the JAX
    package under each policy: every conv leaf is tapped, so only the
    InstanceNorm leaves follow the policy."""
    jm, tm, X, y = pair(name)
    ref = outcome(lambda: JaxBackend(jm, "classification", kron_unsupported=policy).kron(
        jnp.asarray(X), jnp.asarray(y), N=N))
    got = outcome(lambda: CurvatureBackend(NNModel(tm), "classification",
                                            kron_unsupported=policy).kron(
        torch.as_tensor(X), torch.as_tensor(y), N=N))
    if isinstance(ref, type):
        assert got is ref
        return
    assert not isinstance(got, type), got
    (lj, kj), wj = ref
    (lt, kt), wt = got
    assert wt == wj
    assert bool(wt) == (name == "conv3d" and policy == "skip")
    np.testing.assert_allclose(float(lt), float(lj), rtol=REL)
    assert [tuple(F.shape for F in g) for g in kt.kfacs] == [
        tuple(F.shape for F in g) for g in kj.kfacs]
    for Ft, Fj in zip(kt.kfacs, kj.kfacs):
        for a, b in zip(Ft, Fj):
            close(a, b, REL)


@pytest.mark.parametrize("name", ["g2_s1_same", "g4_s1_same", "depthwise"])
def test_grouped_kron_shapes_and_additivity(name):
    """`tests/test_grouped_conv.py:86`: each group's factors span its leaf,
    and a batch's factors are the sum of its halves' (A carries 1/N)."""
    _, tm, X, y = pair(name)
    be = CurvatureBackend(NNModel(tm), "classification")
    X, y = torch.as_tensor(X), torch.as_tensor(y)
    _, k = be.kron(X, y, N=N)
    assert k.group_sizes == [s.size for s in be.model.leaf_specs]
    _, k1 = be.kron(X[:3], y[:3], N=N)
    _, k2 = be.kron(X[3:], y[3:], N=N)
    for F, F1, F2 in zip(k.kfacs, k1.kfacs, k2.kfacs):
        for H, H1, H2 in zip(F, F1, F2):  # A carries 1/N, B sums
            close(H, (H1 + H2).numpy(), REL)
