"""`laplace_jax_torch.utils` exports a counterpart of every name that
`laplace_jax.utils` exports, and the parameter-count and prior helpers
agree with the JAX package's on the ResNet-18 twin (width 8, float64).

The JAX package's four pytree-only helpers have no shim in the port; each
is mapped here to the port's counterpart, which must exist.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laplace_jax.utils as jax_utils
import laplace_jax_torch.utils as torch_utils
from laplace_jax_torch.utils import flatten
from .torch_twins import resnet_pair

# the JAX package's pytree-only helpers and the port's counterparts
PYTREE_ONLY = {
    "tree_to_vector": (flatten, "parameters_to_vector"),
    "make_unflatten": (flatten, "vector_to_parameters"),
    "partition": (flatten, "leaf_specs"),  # leaf_specs(module, trainable=...)
    "merge": (flatten, "leaf_specs"),
}


@pytest.mark.parametrize("name", sorted(jax_utils.__all__))
def test_every_jax_utils_name_has_a_counterpart(name):
    if name in PYTREE_ONLY:
        module, counterpart = PYTREE_ONLY[name]
        assert name not in torch_utils.__all__
        assert callable(getattr(module, counterpart))
        return
    assert name in torch_utils.__all__
    assert getattr(torch_utils, name) is not None


def test_every_export_resolves():
    for name in torch_utils.__all__:
        assert getattr(torch_utils, name) is not None, name


@pytest.fixture(scope="module")
def resnet():
    jnnm, net = resnet_pair()
    return jnnm.params["params"], net


def test_num_params_and_params_per_leaf_match_jax(resnet):
    params, net = resnet
    sizes = torch_utils.params_per_leaf(net)
    assert sizes == jax_utils.params_per_leaf(params)
    assert torch_utils.num_params(net) == jax_utils.num_params(params) == sum(sizes)
    assert sizes == [s.size for s in torch_utils.leaf_specs(net)]


@pytest.mark.parametrize("structure", ["scalar", "layerwise", "diag"])
def test_expand_prior_precision_matches_jax(resnet, structure):
    params, net = resnet
    n = {"scalar": 1, "layerwise": len(torch_utils.params_per_leaf(net)),
         "diag": torch_utils.num_params(net)}[structure]
    prec = np.random.default_rng(n).uniform(0.5, 2.0, n)
    # a scalar as a Python float (taken in the parameters' dtype)
    prec = float(prec[0]) if structure == "scalar" else prec
    got = torch_utils.expand_prior_precision(prec if structure == "scalar"
                                             else torch.as_tensor(prec), net)
    want = np.asarray(jax_utils.expand_prior_precision(jnp.asarray(prec), params))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=0)


def test_expand_prior_precision_rejects_a_mismatch(resnet):
    _, net = resnet
    with pytest.raises(ValueError, match="Mismatch"):
        torch_utils.expand_prior_precision(torch.ones(3), net)
    with pytest.raises(ValueError, match="at most 1-dimensional"):
        torch_utils.expand_prior_precision(torch.ones(2, 2), net)
