"""The port's DenseGeneral, Einsum, Embed and RMSNorm taps against the JAX
package in float64 on the CPU: KFAC factors under each `kron_unsupported`
policy, the tap diagonal (GGN and EF), the exact blocks of `unfactored`
Einsum leaves, and the taps' own metadata.

The models are those of the JAX package's oracle tests, written as layer
lists that build a flax model and its torch twin (weights carried over by
`state_dict_from_flax`): `tests/test_dense_general.py` (tuple features,
two contracted axes, an Einsum over a sequence, an Embed, `batch_dims`),
`tests/test_einsum_general.py` (ellipsis, feature-major "ok" kernels,
permuted outputs, interleaved labels), `tests/test_einsum_unfactored.py`
(a summed-out feature, repeated labels, a per-position kernel, a kernel
batch axis) and `tests/test_kron_generic_block.py` (its interleaved
Einsum between two Dense layers); plus a DenseGeneral contracting a middle
axis and an RMSNorm. Where those tests end in a product with a matrix of
ones (equal logits, a GGN that vanishes), the models here end in a Dense
head, so the curvature compared is not zero. Tolerances: factors, blocks
and diagonals 1e-10 relative to their largest entry.
"""

import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from laplace_jax.curvature.backend import CurvatureBackend as JaxBackend
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax_torch.curvature.backend import CurvatureBackend
from laplace_jax_torch.models.flax_layers import DenseGeneral, Einsum, Embed, LayerNorm, RMSNorm
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.nnmodel import NNModel, general_linear_tap

from .torch_twins import close, outcome

torch.set_num_threads(1)

REL = 1e-10
F64 = jnp.float64


class FlaxStack(fnn.Module):
    """A layer list: ("dg", features, kwargs), ("einsum", shape, equation),
    ("dense", n), ("embed", vocab, d), ("rmsnorm",), ("layernorm",),
    ("tanh",), ("flat",), ("mean1",), ("move0",)."""

    layers: tuple

    @fnn.compact
    def __call__(self, x):
        for op, *a in self.layers:
            if op == "dg":
                x = fnn.DenseGeneral(a[0], **dict(a[1]), param_dtype=F64)(x)
            elif op == "einsum":
                x = fnn.Einsum(a[0], a[1], param_dtype=F64)(x)
            elif op == "dense":
                x = fnn.Dense(a[0], param_dtype=F64)(x)
            elif op == "embed":
                x = fnn.Embed(a[0], a[1], param_dtype=F64)(x)
            elif op == "rmsnorm":
                x = fnn.RMSNorm(param_dtype=F64)(x)
            elif op == "layernorm":
                x = fnn.LayerNorm(param_dtype=F64)(x)
            else:
                x = _plain(op, a, x, jnp)
        return x


def _plain(op, a, x, xp):
    if op == "tanh":
        return xp.tanh(x)
    if op == "flat":
        return x.reshape(x.shape[0], -1)
    if op == "mean1":
        return x.mean(1)
    if op == "move0":
        return xp.moveaxis(x, 0, -1)
    raise ValueError(op)


class TorchStack(nn.Module):
    """The torch twin of a `FlaxStack`, each layer shaped after its flax
    parameters and named as flax names it."""

    def __init__(self, layers, params):
        super().__init__()
        self.ops, counts = [], {}
        for op, *a in layers:
            cls = {"dg": "DenseGeneral", "einsum": "Einsum", "dense": "Dense", "embed": "Embed",
                   "rmsnorm": "RMSNorm", "layernorm": "LayerNorm"}.get(op)
            if cls is None:
                self.ops.append((op, a, None))
                continue
            name = f"{cls}_{counts.get(cls, 0)}"
            counts[cls] = counts.get(cls, 0) + 1
            p = params[name]
            k = np.shape(p.get("kernel", p.get("embedding", p.get("scale"))))
            if op == "dg":
                kw = dict(a[1])
                feats = a[0] if isinstance(a[0], tuple) else (a[0],)
                nb = len(kw.get("batch_dims", ()))
                mod = DenseGeneral(k[nb:len(k) - len(feats)], feats, axis=kw.get("axis"),
                                   batch_dims=kw.get("batch_dims", ()), batch_shape=k[:nb])
            elif op == "einsum":
                mod = Einsum(a[0], a[1])
            elif op == "dense":
                mod = nn.Linear(*k)
            elif op == "embed":
                mod = Embed(*k)
            elif op == "rmsnorm":
                mod = RMSNorm(k[0])
            else:
                mod = LayerNorm(k[0])
            self.add_module(name, mod)
            self.ops.append((op, a, name))

    def forward(self, x):
        for op, a, name in self.ops:
            x = getattr(self, name)(x) if name else _plain(op, a, x, torch)
        return x


MODELS = {  # name: (layers, input shape (or vocab for ids), classes)
    "dg_features": ((("dg", (2, 3), ()), ("flat",), ("tanh",), ("dense", 3)), (5,), 3),
    "dg_two_axes": ((("dg", (2, 4), ()), ("dg", 6, (("axis", (-2, -1)),)), ("tanh",),
                     ("mean1",), ("dense", 3)), (3, 5), 3),
    "dg_middle_axis": ((("dg", 4, (("axis", 1),)), ("tanh",), ("mean1",), ("dense", 3)), (5, 3), 3),
    "einsum_seq": ((("einsum", (5, 2, 3), "btd,dhk->bthk"), ("flat",), ("tanh",),
                    ("dense", 2)), (3, 5), 2),
    "einsum_ellipsis": ((("einsum", (5, 6), "...d,dh->...h"), ("tanh",), ("mean1",), ("dense", 3)),
                        (3, 5), 3),
    "einsum_ok": ((("einsum", (6, 2, 3), "btnh,dnh->btd"), ("tanh",), ("mean1",), ("dense", 3)),
                  (3, 2, 3), 3),
    "einsum_permuted_out": ((("einsum", (5, 6), "btd,dh->hbt"), ("move0",), ("tanh",),
                             ("mean1",), ("dense", 3)), (3, 5), 3),
    "einsum_interleaved": ((("einsum", (2, 6, 5), "btnd,nfd->btf"), ("tanh",), ("mean1",),
                            ("dense", 3)), (3, 2, 5), 3),
    "einsum_summed_out": ((("einsum", (5, 4, 2), "bi,ioz->bo"), ("tanh",), ("dense", 3)), (5,), 3),
    "einsum_repeated": ((("einsum", (4, 5), "bii,io->bo"), ("tanh",), ("dense", 3)), (4, 4), 3),
    "einsum_position_kernel": ((("einsum", (3, 4, 5), "btd,tdh->bth"), ("tanh",), ("mean1",),
                                ("dense", 3)), (3, 4), 3),
    "generic_block": ((("dense", 5), ("tanh",), ("einsum", (2, 5, 3), "...a,bac->...bc"),
                       ("flat",), ("dense", 3)), (4,), 3),
    "embed": ((("embed", 11, 6), ("tanh",), ("mean1",), ("dense", 3)), 11, 3),
    "rmsnorm": ((("dense", 6), ("rmsnorm",), ("tanh",), ("dense", 3)), (4,), 3),
    "einsum_kernel_batch": ((("einsum", (4, 5, 4), "bi,bio->bo"), ("tanh",), ("dense", 3)), (5,), 3),
    "dg_batch_dims": ((("dg", 4, (("batch_dims", (0,)),)), ("tanh",), ("dense", 3)), (5,), 3),
}
# no tap: the diagonal takes the Jacobian path, and `batch_dims` its
# whole-batch fallback (an Einsum broadcasts a one-sample batch)
NO_TAP = {"einsum_kernel_batch", "dg_batch_dims"}
UNFACTORED = {"einsum_interleaved", "einsum_summed_out", "einsum_repeated",
              "einsum_position_kernel", "generic_block"}
N = 4


def _pair(name, seed=0):
    layers, shape, C = MODELS[name]
    rng = np.random.default_rng(seed)
    if isinstance(shape, int):
        X = rng.integers(0, shape, size=(N, 5))
    else:
        X = rng.standard_normal((N,) + shape)
    y = rng.integers(0, C, N)
    fm = FlaxStack(layers)
    variables = fm.init(jax.random.key(seed), jnp.asarray(X))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), variables)
    if "scale" in str(jax.tree_util.tree_structure(variables)):  # a norm that is not the identity
        variables = jax.tree_util.tree_map_with_path(
            lambda p, a: a + 0.3 * rng.standard_normal(a.shape) if "scale" in str(p) else a,
            variables)
    tm = TorchStack(layers, variables["params"]).double()
    tm.load_state_dict(state_dict_from_flax(variables, tm))
    return JaxNNModel.from_flax(fm, variables), tm, X, y


@pytest.mark.parametrize("policy", ["skip", "block", "raise"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_kron_against_jax(name, policy):
    """The same Kron factors and warnings, or the same exception class, as
    the JAX package under each policy; no DenseGeneral, Einsum or Embed leaf
    raises `NotImplementedError`."""
    jm, tm, X, y = _pair(name)
    ref = outcome(lambda: JaxBackend(jm, "classification", kron_unsupported=policy).kron(
        jnp.asarray(X), jnp.asarray(y), N=N))
    got = outcome(lambda: CurvatureBackend(NNModel(tm), "classification",
                                            kron_unsupported=policy).kron(
        torch.as_tensor(X), torch.as_tensor(y), N=N))
    if isinstance(ref, type):
        if name in NO_TAP and policy == "block":
            # the exact block applies the layer to one sample, which its
            # kernel's batch axis refuses: each framework raises its own error
            assert isinstance(got, type), got
        else:
            assert got is ref
        return
    assert not isinstance(got, type), got
    (lj, kj), wj = ref
    (lt, kt), wt = got
    assert wt == wj
    np.testing.assert_allclose(float(lt), float(lj), rtol=REL)
    assert [tuple(F.shape for F in g) for g in kt.kfacs] == [
        tuple(F.shape for F in g) for g in kj.kfacs]
    for Ft, Fj in zip(kt.kfacs, kj.kfacs):
        for a, b in zip(Ft, Fj):
            close(a, b, REL)


def _diag_outcome(be, X, y):
    """(diagonal, the whole-batch fallback's warnings) of `be.diag`, or the
    exception's class."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            _, d = be.diag(X, y)
        except Exception as exc:  # noqa: BLE001 - the class is compared
            return type(exc)
    return d, [c.category for c in caught if "QUADRATIC" in str(c.message)]


@pytest.mark.parametrize("curv", ["ggn", "ef"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_tap_diagonal_against_jax(name, curv):
    """The tap diagonal (the port never takes its Jacobian path here:
    `jacobians` raises) against the JAX package's. A `NO_TAP` model takes
    the Jacobian path in both packages, `batch_dims` the whole-batch
    fallback with its `RuntimeWarning` in each, or raises in each (the EF's
    one-sample gradients, which neither package falls back from)."""
    jm, tm, X, y = _pair(name)
    be = CurvatureBackend(NNModel(tm), "classification", curv_type=curv)
    if name in NO_TAP:
        ref = _diag_outcome(JaxBackend(jm, "classification", curv_type=curv),
                            jnp.asarray(X), jnp.asarray(y))
        got = _diag_outcome(be, torch.as_tensor(X), torch.as_tensor(y))
        if isinstance(ref, type):
            assert isinstance(got, type), got
            return
        assert not isinstance(got, type), got
        assert got[1] == ref[1] and ref[1] == [RuntimeWarning] * (name == "dg_batch_dims")
        close(got[0], ref[0], REL)
        return
    _, dj = JaxBackend(jm, "classification", curv_type=curv).diag(jnp.asarray(X),
                                                                  jnp.asarray(y))
    be.jacobians = be.gradients = None  # the tap path or nothing
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, dt = be.diag(torch.as_tensor(X), torch.as_tensor(y))
    close(dt, dj, REL)


@pytest.mark.parametrize("name", sorted(UNFACTORED))
def test_unfactored_blocks_are_the_exact_ggn_blocks(name):
    """An unfactored Einsum's leaves take exact blocks under "skip" with no
    warning: each the GGN's diagonal block of that leaf, in both packages."""
    jm, tm, X, y = _pair(name)
    be = CurvatureBackend(NNModel(tm), "classification")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _, kt = be.kron(torch.as_tensor(X), torch.as_tensor(y), N=N)
    _, H = CurvatureBackend(NNModel(tm), "classification").full(torch.as_tensor(X),
                                                                torch.as_tensor(y))
    taps = NNModel(tm).apply_with_taps(torch.as_tensor(X))[1]
    unf = {t.path for t in taps if t.kind == "unfactored"}
    assert unf
    for spec, group in zip(be.model.leaf_specs, kt.kfacs):
        if spec.path[:-1] in unf:
            assert len(group) == 1
            sl = slice(spec.offset, spec.offset + spec.size)
            close(group[0], H[sl, sl].numpy(), REL)


@pytest.mark.parametrize("name", sorted(set(MODELS) - {"embed"}))
def test_general_linear_tap_metadata_matches_jax(name):
    """Each DenseGeneral/Einsum tap has the JAX tap's kind, spec and
    activation rows (None where the JAX package records no tap). The rows
    of a layer after the first are the output of another layer, which torch
    and XLA compute with different matmuls, so they agree to rounding only,
    as the forwards do (`test_twin_forwards_match_flax`): 1e-13 of the
    largest entry. A misplaced or permuted row moves entries by O(1)."""
    jm, tm, X, _ = _pair(name)
    _, jtaps = jm.apply_with_taps(jm.train_params, jnp.asarray(X))
    jtaps = {t.path: t for t in jtaps if t.kind in ("dense_general", "unfactored")}
    tnet = NNModel(tm)
    for path, mod in ((tuple(n.split(".")), m) for n, m in tm.named_modules()
                      if isinstance(m, (DenseGeneral, Einsum))):
        x_in = []
        h = mod.register_forward_hook(lambda m, a, o: x_in.append(a[0]))
        tnet.apply(torch.as_tensor(X))
        h.remove()
        tap = general_linear_tap(mod, x_in[0])
        if path not in jtaps:
            assert tap is None
            continue
        jt = jtaps[path]
        assert tap[0] == jt.kind
        if jt.kind == "dense_general":
            assert tap[1] == jt.conv_spec
            close(tap[2], jt.patches, 1e-13)


def test_embed_factor_is_the_diagonal_count_gram():
    """The Embed's A factor is diag(token counts)/(N·T), its B the output
    gradients' Gram; ties and absent ids included."""
    jm, tm, X, y = _pair("embed")
    _, kt = CurvatureBackend(NNModel(tm), "classification").kron(
        torch.as_tensor(X), torch.as_tensor(y), N=N)
    idx = [s.path for s in NNModel(tm).leaf_specs].index(("Embed_0", "embedding"))
    A = kt.kfacs[idx][0]
    counts = np.bincount(X.ravel(), minlength=11)
    assert (counts == 0).any() and (counts > 1).any()
    np.testing.assert_array_equal(A.numpy(), np.diag(counts) / (N * X.shape[1]))


def test_twin_forwards_match_flax():
    """Every model's torch twin gives the flax model's outputs."""
    for name in sorted(MODELS):
        jm, tm, X, _ = _pair(name)
        close(tm(torch.as_tensor(X)).detach(), jm.apply(jm.train_params, jnp.asarray(X)), 1e-13)
