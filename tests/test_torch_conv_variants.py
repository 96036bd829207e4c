"""The conv half of tap breadth in the port, against the JAX package in
float64 on the CPU: the twins' forwards and flat vectors, the Jacobian
columns of grouped, 1-D and 3-D kernels, the patches of every rank
(`ops/im2col.py`) and the taps' metadata, on the models of
`tests/torch_conv_twins.py`. The Kron factors are in
`test_torch_conv_variants_kron.py`, the tap diagonal and the fits in
`test_torch_conv_variants_diag.py`.

Tolerances: twin forwards 1e-13 relative to their largest output; the flat
vector and the patches exactly; Jacobians 1e-10 relative to their largest
entry.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax.ops.im2col import im2col as jax_im2col
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.models.flax_layers import Conv
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.ops.im2col import im2col

from .torch_conv_twins import MODELS, REL, pair
from .torch_twins import close

torch.set_num_threads(1)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_twin_forward_matches_flax(name):
    """Each twin gives the flax model's outputs, and its flat vector is the
    flax parameters in ravel order (the mask is no leaf)."""
    from jax.flatten_util import ravel_pytree

    jm, tm, X, _ = pair(name)
    with torch.no_grad():
        got = tm(torch.as_tensor(X))
    close(got, jm.apply(jm.train_params, jnp.asarray(X)), 1e-13)
    close(NNModel(tm).mean_vector, np.asarray(ravel_pytree(jm.train_params)[0]), 0.0)


@pytest.mark.parametrize("name", ["g2_s1_same", "masked_grouped", "conv1d", "conv3d",
                                  "torch_conv3d"])
def test_jacobian_columns_match_jax(name):
    """Rank-3 and rank-5 kernels (1-D and 3-D convs) and grouped kernels:
    the per-sample Jacobians' columns in the JAX package's flat order."""
    jm, tm, X, _ = pair(name)
    Jj, fj = JaxBackend(jm, "classification").jacobians(jnp.asarray(X))
    Jt, ft = CurvatureBackend(NNModel(tm), "classification").jacobians(torch.as_tensor(X))
    close(Jt, Jj, REL)
    close(ft, fj, REL)


IM2COL = [  # (input shape (B, *S, C), kernel, strides, padding, kernel dilation, input dilation)
    ((2, 9, 3), (3,), (2,), "SAME", (1,), None),
    ((2, 9, 3), (2,), (1,), ((2, 0),), (3,), (2,)),
    ((2, 7, 6, 3), (3, 2), (2, 1), "SAME", (1, 2), None),
    ((2, 7, 6, 3), (3, 3), (1, 2), ((1, 2), (0, 1)), (1, 1), (2, 3)),
    ((2, 7, 6, 3), (3, 3), (2, 2), "CIRCULAR", (2, 1), None),
    ((2, 5, 4, 6, 2), (3, 2, 3), (1, 2, 2), "SAME", (1, 1, 2), None),
    ((2, 5, 4, 6, 2), (2, 3, 2), (2, 1, 1), ((1, 0), (1, 1), (0, 2)), (1, 1, 1), (1, 2, 1)),
    ((2, 5, 4, 6, 2), (3, 3, 3), (1, 1, 1), "CIRCULAR", (1, 1, 1), None),
    ((2, 5, 4, 6, 2), (2, 2, 2), (1, 1, 1), "VALID", (1, 1, 1), None),
]


@pytest.mark.parametrize("case", IM2COL, ids=[f"{len(c[1])}d-{i}" for i, c in enumerate(IM2COL)])
def test_im2col_matches_jax_for_every_rank(case):
    """Patches for 1, 2 and 3 spatial dims, kernel and input dilation, and
    CIRCULAR padding: the JAX package's, exactly (they are copies)."""
    shape, k, s, p, d, idil = case
    x = np.random.default_rng(5).standard_normal(shape)
    ref = jax_im2col(jnp.asarray(x), k, s, p, d, input_dilation=idil)
    got = im2col(torch.as_tensor(x), k, s, p, dilation=d, input_dilation=idil)
    close(got, ref, 0.0)


def test_circular_with_input_dilation_raises():
    """No conv has these semantics: the patches refuse, and the twin (as
    flax) refuses string padding with input dilation."""
    x = torch.zeros(1, 5, 5, 2)
    with pytest.raises(ValueError, match="CIRCULAR"):
        im2col(x, (3, 3), (1, 1), "CIRCULAR", input_dilation=2)
    with pytest.raises(ValueError, match="CIRCULAR"):
        im2col(x, (3, 3), (1, 1), ((1, 1), (1, 1)), input_dilation=2, wrap=True)
    for padding in ("SAME", "VALID", "CIRCULAR"):
        with pytest.raises(ValueError, match="input_dilation"):
            Conv(2, 3, (3, 3), padding=padding, input_dilation=2)
        with pytest.raises(ValueError, match="String padding"):
            fnn.Conv(3, (3, 3), padding=padding, input_dilation=2).init(
                jax.random.key(0), jnp.zeros((1, 5, 5, 2)))


def test_conv_taps_record_groups_and_mask():
    """The tap of a grouped masked twin carries its groups and its mask (in
    the kernel's torch layout); a torch circular conv's its own pads."""
    _, tm, X, _ = pair("masked_grouped")
    _, taps = NNModel(tm).apply_with_taps(torch.as_tensor(X))
    spec = next(t for t in taps if t.path == ("Conv_0",)).spec
    assert spec["groups"] == 2
    assert torch.equal(spec["mask"], tm.Conv_0.mask)
    _, tm, X, _ = pair("torch_conv2d_circular")
    spec = next(t for t in NNModel(tm).apply_with_taps(torch.as_tensor(X))[1]
                if t.path == ("Conv_0",)).spec
    assert spec["wrap"] and spec["padding"] == [(1, 1), (1, 1)]
