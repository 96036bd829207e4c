"""KFAC taps beyond ResNet-18's own layers, and the scope of the float32
precision switches, on the CPU in float64.

- `torch.nn.Conv2d` layers (bias; stride 1 and 2; explicit, `'valid'` and
  `'same'` padding; kernel dilation; two groups; circular padding) get the
  JAX package's KFAC factors on a flax twin with explicit padding pairs (or
  CIRCULAR), and no zero-curvature warning.
- A Dense layer on a sequence `(B, T, in)` gets "expand" KFAC factors,
  A = 1/(N T) sum a a^T.
- The port's fits, decompose, marglik and predictives leave
  `torch.backends.cuda.matmul.allow_tf32` and `torch.backends.cudnn.allow_tf32`
  as the caller set them, and run the eigensolver with both off.

Weights are the flax twin's, carried over by `state_dict_from_flax`; the
same numpy inputs go to both packages. Tolerances: every KFAC factor 1e-9
of its largest entry (the port's KFAC parity, as in
`tests/test_torch_resnet_kfac.py`); the log marginal likelihood and the
GLM probit predictive likewise, relative to their magnitude.
"""

import warnings

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from laplace_jax import KronLaplace as JaxKronLaplace
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import KronLaplace
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.ops import tridiag_eig
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.device import _precision_knobs, full_f32

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

N, BATCH, CLASSES = 12, 6, 3


class JaxConvNet(fnn.Module):
    """Conv (bias) -> ReLU -> spatial mean -> Dense, NHWC."""

    stride: int
    padding: tuple
    dilation: int

    @fnn.compact
    def __call__(self, x):
        x = fnn.Conv(4, (3, 3), strides=(self.stride,) * 2, padding=self.padding,
                     kernel_dilation=(self.dilation,) * 2, param_dtype=jnp.float64)(x)
        x = jax.nn.relu(x).mean(axis=(1, 2))
        return fnn.Dense(CLASSES, param_dtype=jnp.float64)(x)


class TorchConvNet(nn.Module):
    """The torch twin on NHWC inputs, with an `nn.Conv2d` of its own padding."""

    def __init__(self, stride, padding, dilation):
        super().__init__()
        self.Conv_0 = nn.Conv2d(3, 4, 3, stride=stride, padding=padding, dilation=dilation)
        self.Dense_0 = nn.Linear(4, CLASSES)

    def forward(self, x):
        x = torch.relu(self.Conv_0(x.permute(0, 3, 1, 2)))
        return self.Dense_0(x.mean(dim=(2, 3)))


class JaxSeqNet(fnn.Module):
    """Dense on (B, T, 4) -> tanh -> mean over T -> Dense."""

    @fnn.compact
    def __call__(self, x):
        x = jnp.tanh(fnn.Dense(5, param_dtype=jnp.float64)(x)).mean(axis=1)
        return fnn.Dense(CLASSES, param_dtype=jnp.float64)(x)


class TorchSeqNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.Dense_0 = nn.Linear(4, 5)
        self.Dense_1 = nn.Linear(5, CLASSES)

    def forward(self, x):
        return self.Dense_1(torch.tanh(self.Dense_0(x)).mean(dim=1))


# (id, torch Conv2d stride, padding, dilation, flax explicit padding pairs)
CONVS = [
    ("pad1", 1, 1, 1, ((1, 1), (1, 1))),
    ("stride2", 2, 1, 1, ((1, 1), (1, 1))),
    ("valid", 1, "valid", 1, ((0, 0), (0, 0))),
    ("dilation2-same", 1, "same", 2, ((2, 2), (2, 2))),
    ("dilation2-stride2-pad21", 2, (2, 1), 2, ((2, 2), (1, 1))),
]


def _fit_pair(jm, tm_factory, X, y):
    """Both packages' KronLaplace fitted on the same data, the torch model
    holding the flax twin's weights; and the warnings of the torch fit."""
    params = jm.init(jax.random.key(1), jnp.asarray(X[:1]))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), params)
    tm = tm_factory().double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    jla = JaxKronLaplace(JaxNNModel.from_flax(jm, params), "classification")
    jla.fit(JaxLoader(X, y, batch_size=BATCH))
    tla = KronLaplace(tm, "classification", device="cpu")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        tla.fit(ArrayLoader(X, y, batch_size=BATCH))
    return jla, tla, [str(w.message) for w in caught]


@pytest.fixture(scope="module", params=CONVS, ids=[c[0] for c in CONVS])
def conv_pair(request):
    _, stride, padding, dilation, pairs = request.param
    rng = np.random.default_rng(2)
    X, y = rng.standard_normal((N, 9, 8, 3)), rng.integers(0, CLASSES, N)
    jm = JaxConvNet(stride, pairs, dilation)
    return (X, y) + _fit_pair(jm, lambda: TorchConvNet(stride, padding, dilation), X, y)


@pytest.fixture(scope="module")
def seq_pair():
    rng = np.random.default_rng(3)
    X, y = rng.standard_normal((N, 7, 4)), rng.integers(0, CLASSES, N)
    return (X, y) + _fit_pair(JaxSeqNet(), TorchSeqNet, X, y)


def _assert_factors_match(jla, tla):
    jf, tf = jla.H_facs.kfacs, tla.H_facs.kfacs
    assert [[tuple(a.shape) for a in F] for F in jf] == [[tuple(b.shape) for b in F] for F in tf]
    for Fj, Ft in zip(jf, tf):
        for a, b in zip(Fj, Ft):
            a = np.asarray(a)
            assert np.abs(a).max() > 0
            np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=1e-9 * np.abs(a).max())


def _assert_marglik_and_predictive_match(X, jla, tla):
    ref, got = float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood())
    assert np.isfinite(got)
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    pj, pt = np.asarray(jla(jnp.asarray(X[:4]))), tla(X[:4]).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-9)


def test_conv2d_factors_match_jax(conv_pair):
    """Conv_0's kernel (27 x 27, 4 x 4) and bias (4 x 4) groups and the
    head's, against the flax twin's."""
    _, _, jla, tla, _ = conv_pair
    _assert_factors_match(jla, tla)
    assert [tuple(F[0].shape) for F in tla.H_facs.kfacs][:2] == [(4, 4), (27, 27)]


def test_conv2d_marglik_and_predictive_match_jax(conv_pair):
    X, _, jla, tla, _ = conv_pair
    _assert_marglik_and_predictive_match(X, jla, tla)


def test_conv2d_gets_no_zero_curvature_warning(conv_pair):
    assert not [m for m in conv_pair[-1] if "zero curvature" in m]


class JaxGroupedOrCircular(fnn.Module):
    """A 3x3 conv, 4 -> 4 channels: two groups with explicit (1, 1) pads, or
    one group CIRCULAR (a wrap of 1 on each side); flatten; Dense."""

    circular: bool

    @fnn.compact
    def __call__(self, x):
        pad, groups = ("CIRCULAR", 1) if self.circular else (((1, 1), (1, 1)), 2)
        x = fnn.Conv(4, (3, 3), padding=pad, feature_group_count=groups,
                     param_dtype=jnp.float64)(x)
        return fnn.Dense(CLASSES, param_dtype=jnp.float64)(x.reshape(x.shape[0], -1))


class TorchGroupedOrCircular(nn.Module):
    def __init__(self, circular):
        super().__init__()
        self.Conv_0 = nn.Conv2d(4, 4, 3, padding=1, groups=1 if circular else 2,
                                padding_mode="circular" if circular else "zeros")
        self.Dense_0 = nn.Linear(100, CLASSES)

    def forward(self, x):
        x = self.Conv_0(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        return self.Dense_0(x.reshape(x.shape[0], -1))


@pytest.mark.parametrize("circular", [False, True], ids=["grouped", "circular"])
def test_grouped_and_circular_conv2d_are_tapped(circular):
    """A grouped and a circular `nn.Conv2d` are tapped: no "zero curvature"
    warning, and the JAX package's factors on the flax twin."""
    rng = np.random.default_rng(4)
    X, y = rng.standard_normal((N, 5, 5, 4)), rng.integers(0, CLASSES, N)
    jla, tla, caught = _fit_pair(JaxGroupedOrCircular(circular),
                                 lambda: TorchGroupedOrCircular(circular), X, y)
    assert not [m for m in caught if "zero curvature" in m]
    _assert_factors_match(jla, tla)
    assert [tuple(F[0].shape) for F in tla.H_facs.kfacs][:2] == [
        (4, 4), (36 if circular else 18, 36 if circular else 18)]


def test_dense_on_a_sequence_gets_expand_kfac_factors(seq_pair):
    """Dense_0 on (B, 7, 4): A is 4 x 4 over N * 7 rows, B 5 x 5."""
    _, _, jla, tla, caught = seq_pair
    _assert_factors_match(jla, tla)
    shapes = [[tuple(a.shape) for a in F] for F in tla.H_facs.kfacs]
    assert shapes[:2] == [[(5, 5)], [(4, 4), (5, 5)]]
    assert not [m for m in caught if "zero curvature" in m]


def test_dense_on_a_sequence_marglik_and_predictive_match_jax(seq_pair):
    X, _, jla, tla, _ = seq_pair
    _assert_marglik_and_predictive_match(X, jla, tla)


# -- the float32 precision scope ---------------------------------------------


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)


def _state():
    """Every precision setting, including the matmul precision."""
    return (_flags(), torch.get_float32_matmul_precision(),
            [k.fp32_precision for k in _precision_knobs()])


@pytest.fixture
def sentinel_flags():
    """Both TF32 switches set opposite to torch's defaults; torch's defaults
    again afterwards."""
    knobs = [(k, k.fp32_precision) for k in _precision_knobs()]
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = False
    yield (True, False)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    for knob, value in knobs:
        knob.fp32_precision = value


def test_fit_decompose_marglik_predictive_leave_the_flags(sentinel_flags, seq_pair):
    X, y = seq_pair[:2]
    before = _state()
    la = KronLaplace(TorchSeqNet().double(), "classification", device="cpu")
    assert _flags() == sentinel_flags
    la.fit(ArrayLoader(X, y, batch_size=BATCH))
    assert _flags() == sentinel_flags
    la.H_facs.decompose()
    la.log_marginal_likelihood()
    la.optimize_prior_precision(n_steps=2)
    la(X[:3])
    la.predictive_samples(X[:3], n_samples=4)
    assert _state() == before


def test_eigh_stack_ts_runs_with_both_flags_off(sentinel_flags, monkeypatch):
    seen = []
    inner = tridiag_eig.tridiag_eigh

    def spy(d, e):
        seen.append(_flags())
        return inner(d, e)

    monkeypatch.setattr(tridiag_eig, "tridiag_eigh", spy)
    A = torch.as_tensor(np.random.default_rng(5).standard_normal((2, 20, 20)))
    tridiag_eig.eigh_stack_ts((A + A.mT) / 2, device="cpu")
    assert seen == [(False, False)]
    assert _flags() == sentinel_flags


@pytest.mark.parametrize("start", ["flags", "precision-high", "precision-medium", "new-api"])
def test_scope_restores_every_setting_also_on_an_exception(sentinel_flags, start):
    """Torch's precision state set by either of its APIs comes back as it
    was, after an exception inside the scope too."""
    if start.startswith("precision"):
        torch.set_float32_matmul_precision(start.split("-")[1])
    if start == "new-api":
        torch.backends.cuda.matmul.fp32_precision = "tf32"
        torch.backends.cudnn.conv.fp32_precision = "ieee"
        before = [k.fp32_precision for k in _precision_knobs()]
    else:
        before = _state()
    with pytest.raises(ZeroDivisionError):
        with full_f32():
            assert _flags() == (False, False)
            1 / 0
    after = [k.fp32_precision for k in _precision_knobs()] if start == "new-api" else _state()
    assert after == before
    with pytest.raises(ValueError):  # a decorated entry point that raises
        tridiag_eig.eigh_stack_ts(torch.eye(3)[None], stage1="nope", device="cpu")
    after = [k.fp32_precision for k in _precision_knobs()] if start == "new-api" else _state()
    assert after == before
