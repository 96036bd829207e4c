"""KFAC's policies for leaves outside Dense and Conv layers
(`kron_unsupported` = skip / block / raise) in the port, against the JAX
package in float64 on the CPU: the norm twins (`BatchNorm` with frozen
running statistics, `GroupNorm`, `LayerNorm`) on `tests/test_kron_norm.py`'s
BNCNN and on WideResNet-16 at widen 1 on 8x8 inputs, the `InstanceNorm`
twin on the BNCNN, and a bare parameter
under no layer (`tests/test_kron_generic_block.py`'s generic exact block;
its interleaved Einsum is in `tests/test_torch_dense_general_taps.py`), and
a DenseGeneral, which gets Kron factors under every policy.

The same factors, the same "zero curvature" warning and the same exception
class as the JAX package, under each policy. Oracles mirrored:
`tests/test_kron_norm.py:66-209` and `tests/test_kron_generic_block.py:54`,
`:123`. Tolerances: Kron factors and blocks 1e-9 relative to their largest
entry, log marginal likelihoods 1e-8 relative, predictives 1e-8 absolute.
"""

import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax import KronLaplace as JaxKron
from laplace_jax import KronLLLaplace as JaxKronLL
from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import DiagLaplace, KronLaplace, KronLLLaplace
from laplace_jax_torch.curvature import kfac
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.models.flax_layers import DenseGeneral
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.nnmodel import NNModel
from laplace_jax_torch.utils.data import ArrayLoader

from .torch_twins import (
    JaxDraws,
    bncnn_pair,
    classification,
    close,
    kron_close,
    scaled_pair,
    wrn_pair,
)

torch.set_num_threads(1)

NORMS = ["batch", "group", "layer"]
BNCNN_NORMS = NORMS + ["instance"]  # the InstanceNorm twin in the BNCNN alone
POLICIES = ["skip", "block", "raise"]


def _is_norm_leaf(spec) -> bool:
    return spec.path[-1] == "scale" or (spec.path[-1] == "bias" and "Norm" in spec.path[-2])


def _kron_both(jm, tm, X, y, **kw):
    """(JAX outcome, port outcome) of one batch's `kron`: (Kron, the zero
    curvature warnings, with the JAX leaf paths' leading `params/`) or the
    exception's class. The JAX side runs as one program (it warns and
    raises while tracing)."""
    jb = JaxBackend(jm, "classification", "ggn", **kw)
    tb = CurvatureBackend(NNModel(tm), "classification", "ggn", **kw)
    out = []
    for run in (lambda: jax.jit(lambda a, b: jb.kron(a, b, len(X)))(jnp.asarray(X),
                                                                    jnp.asarray(y)),
                lambda: tb.kron(torch.as_tensor(X), torch.as_tensor(y), len(X))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                kron = run()
            except Exception as exc:  # the class is what is compared
                out.append(type(exc))
                continue
        out.append((kron[1], [str(w.message).replace("'params/", "'") for w in caught
                              if "zero curvature" in str(w.message)]))
    return out


@pytest.mark.parametrize("make,shape", [(lambda n: wrn_pair(n), (8, 8, 3)),
                                        (lambda n: bncnn_pair(n), (6, 6, 2))],
                         ids=["wrn", "bncnn"])
@pytest.mark.parametrize("norm", NORMS)
def test_norm_twins_forward_as_flax(make, shape, norm):
    """The BatchNorm (running statistics), GroupNorm and LayerNorm twins
    inside both networks give flax's outputs within 1e-12, and the flat
    vector is flax's parameters in ravel order."""
    from jax.flatten_util import ravel_pytree

    jm, tm = make(norm)
    X = np.random.default_rng(7).standard_normal((3,) + shape)
    with torch.no_grad():
        got = tm(torch.as_tensor(X)).numpy()
    ref = jax.jit(jm.apply)(jm.train_params, jnp.asarray(X))
    np.testing.assert_allclose(got, np.asarray(ref), rtol=0, atol=1e-12)
    close(NNModel(tm).mean_vector, np.asarray(ravel_pytree(jm.train_params)[0]), 0.0)


def test_instance_norm_twin_forward_as_flax():
    """The InstanceNorm twin (statistics per sample and channel, over the
    spatial axes) inside the BNCNN gives flax's `InstanceNorm` outputs
    within 1e-12, and the flat vector is flax's parameters."""
    from jax.flatten_util import ravel_pytree

    jm, tm = bncnn_pair("instance")
    X = np.random.default_rng(7).standard_normal((3, 6, 6, 2))
    with torch.no_grad():
        got = tm(torch.as_tensor(X)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax.jit(jm.apply)(jm.train_params,
                                                                 jnp.asarray(X))),
                               rtol=0, atol=1e-12)
    close(NNModel(tm).mean_vector, np.asarray(ravel_pytree(jm.train_params)[0]), 0.0)


@pytest.mark.parametrize("policy", POLICIES)
def test_instance_norm_policies_match_jax(policy):
    """The BNCNN with an InstanceNorm under each policy: the same factors
    and warning (skip), the same exact blocks and no warning (block),
    `ValueError` (raise), as the JAX package's."""
    jm, tm = bncnn_pair("instance")
    X, y = classification(6, (6, 6, 2), 3, 1)
    jout, tout = _kron_both(jm, tm, X, y, kron_unsupported=policy)
    if policy == "raise":
        assert jout is ValueError and tout is ValueError
        return
    (kj, wj), (kt, wt) = jout, tout
    kron_close(kt, kj)
    assert wt == wj and len(wt) == (policy == "skip")


def test_wideresnet_16_4_has_flax_leaves():
    """At full size (widen 4, 10 classes, BatchNorm) the twin's leaves are
    the flax model's, 2,750,682 weights (`jax.eval_shape`, no init)."""
    from laplace_jax.models import WideResNet16x4 as FlaxWRN
    from laplace_jax_torch.models.wideresnet import WideResNet16x4

    shapes = jax.eval_shape(FlaxWRN(norm="batch").init, jax.random.key(0),
                            jnp.zeros((1, 32, 32, 3)))
    flat = jax.tree_util.tree_flatten_with_path(shapes["params"])[0]
    ref = sorted(("/".join(str(k.key) for k in path), tuple(v.shape)) for path, v in flat)
    nnm = NNModel(WideResNet16x4(10, 4, "batch"))
    assert [("/".join(s.path), s.shape) for s in nnm.leaf_specs] == ref
    assert nnm.n_params == 2_750_682


@pytest.mark.parametrize("policy", POLICIES)
@pytest.mark.parametrize("norm", NORMS)
def test_wrn_policies_match_jax(norm, policy):
    """WideResNet-16 (widen 1) under each norm and policy: the same factors
    and the same warning (skip), the same factors and no warning (block),
    `ValueError` (raise)."""
    jm, tm = wrn_pair(norm)
    X, y = classification(6, (8, 8, 3), 4, 1)
    jout, tout = _kron_both(jm, tm, X, y, kron_unsupported=policy)
    if policy == "raise":
        assert jout is ValueError and tout is ValueError
        return
    (kj, wj), (kt, wt) = jout, tout
    kron_close(kt, kj)
    assert wt == wj and len(wt) == (policy == "skip")
    norm_groups = [F for s, F in zip(NNModel(tm).leaf_specs, kt.kfacs) if _is_norm_leaf(s)]
    assert len(norm_groups) == 13 * 2
    assert all(bool((F[0] == 0).all()) == (policy == "skip") for F in norm_groups)


@pytest.mark.parametrize("norm", BNCNN_NORMS)
def test_kron_skip_warns_and_fits(norm):
    """`tests/test_kron_norm.py:79`: the norm groups' Kron diagonal is
    exactly 0, the posterior there is the prior, everything stays finite."""
    _, tm = bncnn_pair(norm)
    X, y = classification(12, (6, 6, 2), 3, 0)
    la = KronLaplace(tm, "classification", device="cpu")
    with pytest.warns(UserWarning, match="zero curvature"):
        la.fit(ArrayLoader(X, y, batch_size=6))
    diag = la.H_facs.diag()
    for spec in la.model.leaf_specs:
        if _is_norm_leaf(spec):
            assert bool((diag[spec.offset:spec.offset + spec.size] == 0).all()), spec.path
    assert np.isfinite(float(la.log_marginal_likelihood()))
    assert bool(torch.isfinite(la(X[:4])).all())
    assert bool(torch.isfinite(la.sample(5, generator=torch.Generator().manual_seed(0))).all())


@pytest.mark.parametrize("norm", BNCNN_NORMS)
def test_kron_block_matches_full_ggn_blocks(norm):
    """`tests/test_kron_norm.py:103`: the 'block' groups of the norm leaves
    equal those leaves' blocks of the exact full GGN, and the JAX package's
    factors."""
    jm, tm = bncnn_pair(norm)
    X, y = classification(12, (6, 6, 2), 3, 0)
    (kj, _), (kt, _) = _kron_both(jm, tm, X, y, kron_unsupported="block")
    kron_close(kt, kj)
    nnm = NNModel(tm)
    _, H = CurvatureBackend(nnm, "classification").full(torch.as_tensor(X), torch.as_tensor(y))
    checked = 0
    for spec, group in zip(nnm.leaf_specs, kt.kfacs):
        if _is_norm_leaf(spec):
            sl = slice(spec.offset, spec.offset + spec.size)
            assert len(group) == 1
            close(group[0], H[sl, sl].numpy(), 1e-9)
            checked += 1
    assert checked >= 2


def test_kron_raise_mode_still_raises():
    """`tests/test_kron_norm.py:147`."""
    _, tm = bncnn_pair("batch")
    X, y = classification(12, (6, 6, 2), 3, 0)
    la = KronLaplace(tm, "classification", backend_kwargs={"kron_unsupported": "raise"},
                     device="cpu")
    with pytest.raises(ValueError, match="KFAC is undefined"):
        la.fit(ArrayLoader(X, y, batch_size=6))


def test_kron_block_fit_end_to_end():
    """`tests/test_kron_norm.py:158`: a 'block' fit does not warn, its scale
    groups are not zero, it tunes and predicts; its marglik and probit
    against the JAX package's."""
    jm, tm = bncnn_pair("batch")
    X, y = classification(12, (6, 6, 2), 3, 0)
    la = KronLaplace(tm, "classification", backend_kwargs={"kron_unsupported": "block"},
                     device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        la.fit(ArrayLoader(X, y, batch_size=6))
    diag = la.H_facs.diag()
    for spec in la.model.leaf_specs:
        if spec.path[-1] == "scale":
            assert bool((diag[spec.offset:spec.offset + spec.size] != 0).any())
    jla = JaxKron(jm, "classification", backend_kwargs={"kron_unsupported": "block"})
    jla.fit(JaxLoader(X, y, batch_size=6))
    kron_close(la.H_facs, jla.H_facs)
    np.testing.assert_allclose(float(la.log_marginal_likelihood()),
                               float(jla.log_marginal_likelihood()), rtol=1e-8)
    close(la(X[:4]), np.asarray(jla(jnp.asarray(X[:4]))), 1e-8)
    la.optimize_prior_precision(n_steps=5)
    np.testing.assert_allclose(la(X[:4]).sum(-1).numpy(), 1.0, atol=1e-6)


def test_bn_wideresnet_diag_and_kron_smoke():
    """`tests/test_kron_norm.py:187`: DiagLaplace and KronLaplace (skip,
    warning) fit the BatchNorm WideResNet with finite margliks."""
    _, tm = wrn_pair("batch")
    X, y = classification(8, (8, 8, 3), 4, 0)
    loader = ArrayLoader(X, y, batch_size=4)
    la = DiagLaplace(tm, "classification", device="cpu")
    la.fit(loader)
    assert np.isfinite(float(la.log_marginal_likelihood()))
    la_k = KronLaplace(tm, "classification", device="cpu")
    with pytest.warns(UserWarning, match="zero curvature"):
        la_k.fit(loader)
    assert np.isfinite(float(la_k.log_marginal_likelihood()))


def test_batch_stats_are_frozen_buffers():
    """`tests/test_kron_norm.py:66`: flax's `batch_stats` land in the
    BatchNorm twins' `mean` and `var` buffers, outside the flat vector,
    which holds what the JAX package's trainable leaves hold."""
    jm, tm = wrn_pair("batch")
    nnm = NNModel(tm)
    assert nnm.n_params == jm.n_params
    assert not [s for s in nnm.leaf_specs if s.path[-1] in ("mean", "var")]
    stats = jm.frozen_params["batch_stats"]
    np.testing.assert_array_equal(tm.BatchNorm_0.var.numpy(), stats["BatchNorm_0"]["var"])
    np.testing.assert_array_equal(tm.WideBlock_3.BatchNorm_1.mean.numpy(),
                                  stats["WideBlock_3"]["BatchNorm_1"]["mean"])
    from jax.flatten_util import ravel_pytree

    close(nnm.mean_vector, np.asarray(ravel_pytree(jm.train_params)[0]), 0.0)


@pytest.mark.parametrize("policy", ["skip", "block"])
def test_kron_norm_serialization_roundtrip(policy, tmp_path):
    """`tests/test_kron_norm.py:209`: zero and block norm groups survive the
    npz archive and the decompose on load, in both packages: the port loads
    the JAX package's archive and the JAX package the port's."""
    jm, tm = bncnn_pair("batch")
    X, y = classification(12, (6, 6, 2), 3, 0)
    kw = {"backend_kwargs": {"kron_unsupported": policy}}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        la = KronLaplace(tm, "classification", device="cpu", **kw)
        la.fit(ArrayLoader(X, y, batch_size=6))
        jla = JaxKron(jm, "classification", **kw)
        jla.fit(JaxLoader(X, y, batch_size=6))
    la.optimize_prior_precision(n_steps=5)
    la.save(str(tmp_path / "port.npz"))
    jla.save(str(tmp_path / "jax.npz"))
    la2 = KronLaplace(tm, "classification", device="cpu", **kw).load(str(tmp_path / "port.npz"))
    np.testing.assert_allclose(float(la2.log_marginal_likelihood()),
                               float(la.log_marginal_likelihood()), rtol=1e-10)
    close(la2(X[:4]), la(X[:4]).numpy(), 1e-10)
    from_jax = KronLaplace(tm, "classification", device="cpu", **kw).load(
        str(tmp_path / "jax.npz"))
    kron_close(from_jax.H_facs, jla.H_facs)
    jla2 = JaxKron(jm, "classification", **kw)
    jla2.load(str(tmp_path / "port.npz"))
    kron_close(la.H_facs, jla2.H_facs)


# -- a leaf under no layer: the generic exact block --------------------------------


def test_generic_block_matches_full_ggn():
    """`tests/test_kron_generic_block.py:54`: the bare parameter's 'block'
    group is its block of the full GGN, no warning, and the JAX package's
    factors."""
    jm, tm = scaled_pair()
    X, y = classification(10, (4,), 3, 0)
    (kj, wj), (kt, wt) = _kron_both(jm, tm, X, y, kron_unsupported="block")
    assert wj == wt == []
    kron_close(kt, kj)
    nnm = NNModel(tm)
    _, H = CurvatureBackend(nnm, "classification").full(torch.as_tensor(X), torch.as_tensor(y))
    spec = next(s for s in nnm.leaf_specs if s.path == ("w",))
    group = kt.kfacs[nnm.leaf_specs.index(spec)]
    assert len(group) == 1
    sl = slice(spec.offset, spec.offset + spec.size)
    close(group[0], H[sl, sl].numpy(), 1e-9)


@pytest.mark.parametrize("policy", POLICIES)
def test_generic_leaf_policies_match_jax(policy):
    """The bare parameter under each policy: its zero group and warning
    (skip), its exact block (block), `ValueError` (raise), as the JAX
    package; and 'block' over `kron_block_max_params` falls back to skip
    (`tests/test_kron_generic_block.py:123`)."""
    jm, tm = scaled_pair()
    X, y = classification(10, (4,), 3, 0)
    jout, tout = _kron_both(jm, tm, X, y, kron_unsupported=policy)
    if policy == "raise":
        assert jout is ValueError and tout is ValueError
        return
    (kj, wj), (kt, wt) = jout, tout
    kron_close(kt, kj)
    assert wt == wj and len(wt) == (policy == "skip")
    if policy == "block":
        (kj, wj), (kt, wt) = _kron_both(jm, tm, X, y, kron_unsupported="block",
                                        kron_block_max_params=4)
        kron_close(kt, kj)
        assert wt == wj and len(wt) == 1


@pytest.mark.parametrize("kw", [{"stochastic": True, "num_samples": 2}, {"curv_type": "ef"}])
def test_generic_block_mc_and_ef_match_jax(kw, monkeypatch):
    """`tests/test_kron_generic_block.py:151`: the generic block with the
    MC (the JAX package's draws) and EF cotangents: symmetric, not zero,
    and the JAX package's."""
    jm, tm = scaled_pair()
    X, y = classification(10, (4,), 3, 0)
    key = jax.random.key(0)
    _, kj = JaxBackend(jm, "classification", kron_unsupported="block", **kw).kron(
        jnp.asarray(X), jnp.asarray(y), N=10, key=key)
    monkeypatch.setattr(kfac, "mc_draws", JaxDraws([key]))
    _, kt = CurvatureBackend(NNModel(tm), "classification", kron_unsupported="block",
                             **kw).kron(torch.as_tensor(X), torch.as_tensor(y), N=10)
    kron_close(kt, kj)
    blk = kt.kfacs[[s.path for s in NNModel(tm).leaf_specs].index(("w",))][0]
    assert bool(blk.abs().max() > 0) and torch.equal(blk, blk.T)


# -- heads and leaves the port does not factor ------------------------------------


@pytest.mark.parametrize("policy", POLICIES)
def test_kron_ll_on_a_norm_head_raises_as_jax(policy):
    """KronLLLaplace on a LayerNorm head: the JAX package raises
    `ValueError` under every policy (no Dense/Conv layer is tapped); so does
    the port (`NoKFACHead`, also a `NotImplementedError`)."""
    jm, tm = bncnn_pair("layer")
    X, y = classification(12, (6, 6, 2), 3, 0)
    kw = {"backend_kwargs": {"kron_unsupported": policy}}
    with pytest.raises(ValueError):
        JaxKronLL(jm, "classification", last_layer_name="LayerNorm_1", **kw).fit(
            JaxLoader(X, y, batch_size=6))
    with pytest.raises(ValueError, match="ROADMAP.md"):
        KronLLLaplace(tm, "classification", last_layer_name="LayerNorm_1", device="cpu",
                      **kw).fit(ArrayLoader(X, y, batch_size=6))


class _DGNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.DenseGeneral_0 = DenseGeneral((3,), (4,))
        self.Dense_0 = torch.nn.Linear(4, 2)

    def forward(self, x):
        return self.Dense_0(torch.tanh(self.DenseGeneral_0(x)))


class _FlaxDGNet(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        return fnn.Dense(2)(jnp.tanh(fnn.DenseGeneral(4)(x)))


@pytest.mark.parametrize("policy", POLICIES)
def test_dense_general_leaves_are_item_5(policy):
    """A DenseGeneral's leaves get the JAX package's Kron factors under
    every policy: the kernel (A, B), the bias (B,); no warning, nothing
    raised, and the same factors and marglik as the JAX package's fit."""
    X = np.random.default_rng(0).standard_normal((6, 3))
    params = _FlaxDGNet().init(jax.random.key(0), jnp.asarray(X[:1]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    net = _DGNet().double()
    net.load_state_dict(state_dict_from_flax(params, net))
    kw = {"backend_kwargs": {"kron_unsupported": policy}}
    y = np.arange(6) % 2
    jla = JaxKron(JaxNNModel.from_flax(_FlaxDGNet(), params), "classification", **kw)
    jla.fit(JaxLoader(X, y, batch_size=3))
    la = KronLaplace(net, "classification", device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        la.fit(ArrayLoader(X, y, batch_size=3))
    specs = [s.path for s in la.model.leaf_specs]
    assert [len(F) for F in la.H_facs.kfacs] == [1, 2, 1, 2]
    assert specs[:2] == [("DenseGeneral_0", "bias"), ("DenseGeneral_0", "kernel")]
    kron_close(la.H_facs, jla.H_facs)
    np.testing.assert_allclose(float(la.log_marginal_likelihood()),
                               float(jla.log_marginal_likelihood()), rtol=1e-8)
