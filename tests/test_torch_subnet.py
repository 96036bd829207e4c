"""The port's `SubnetLaplace` flavors, subnetwork masks and diagonal SWAG
against the JAX package in float64 on the CPU.

Models: the MLP twin (4 -> 8 -> C, tanh; P = 67 at C = 3) and the LeNet
twin on 12x12x1 inputs (P = 30,391), weights carried over from flax; their
biases are zero, as flax initializes them. Data: N = 24 inputs from a
seeded numpy draw, batch 8, C = 3 classes or 2 regression outputs.

Checked against the JAX package:

- `FullSubnetLaplace` and `DiagSubnetLaplace`, classification and
  regression: H, the posterior precision, the log marginal likelihood at
  two prior precisions and its gradient, `log_prob`, the GLM predictive,
  and `assemble_full_samples` (samples from JAX's own draws fed to
  `_samples_from`); an online fit (`override=False`).
- The indices of all seven mask strategies, equal as integers, including
  a top k that cuts through the zero biases' tie.
- `fit_diagonal_swag_var`, and its SGD iterates against optax's
  `chain(add_decayed_weights, sgd)` after each epoch.
- `Laplace()` dispatch on the subnetwork keys, and index validation.

Oracles: `tests/test_subnetlaplace.py`, `test_subnet_breadth.py`,
`test_subnetmask_swag_marglik.py`. Tolerance: 1e-9 relative to the largest
entry of the JAX value (SWAG iterates 1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from laplace_jax import DiagLaplace as JaxDiagLaplace
from laplace_jax import Laplace as JaxLaplace
from laplace_jax.models.lenet import LeNet as JaxLeNet
from laplace_jax.models.mlp import MLP as JaxMLP
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils import subnetmask as jmask
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax.utils.swag import fit_diagonal_swag_var as jax_swag_var
from laplace_jax_torch import DiagLaplace, DiagSubnetLaplace, FullSubnetLaplace, Laplace
from laplace_jax_torch.models.lenet import LeNet
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.ops.syrk import syrk
from laplace_jax_torch.utils import subnetmask as tmask
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.swag import fit_diagonal_swag_var, swag_iterates

torch.set_num_threads(1)

N, BATCH = 24, 8
REL = 1e-9
S = 4  # posterior samples


def _np(x):
    if isinstance(x, tuple):
        return tuple(_np(v) for v in x)
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _close(got, ref, rel=REL):
    got, ref = _np(got), _np(ref)
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, rel)
        return
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-300))


def _f64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(1)
    X, Xi = rng.standard_normal((N, 4)), rng.standard_normal((N, 12, 12, 1))
    out = {"y": {"classification": rng.integers(0, 3, N),
                 "regression": rng.standard_normal((N, 2))}}
    for name, C in (("mlp3", 3), ("mlp2", 2)):
        jm = JaxMLP(hidden=(8,), out_dim=C, dtype=jnp.float64)
        params = _f64(jm.init(jax.random.key(C), jnp.asarray(X[:1])))
        tm = MLP(4, (8,), C).double()
        tm.load_state_dict(state_dict_from_flax(params, tm))
        out[name] = dict(jnn=JaxNNModel.from_flax(jm, params), tm=tm, X=X)
    jm = JaxLeNet(num_classes=3, dtype=jnp.float64)
    params = _f64(jm.init(jax.random.key(5), jnp.asarray(Xi[:1])))
    tm = LeNet(3, 1, 12).double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    out["lenet"] = dict(jnn=JaxNNModel.from_flax(jm, params), tm=tm, X=Xi)
    return out


def _loaders(models, model, lik):
    m, y = models[model], models["y"][lik]
    return JaxLoader(m["X"], y, batch_size=BATCH), ArrayLoader(m["X"], y, batch_size=BATCH)


# name: (model, likelihood, hessian_structure, subnetwork size)
CONFIGS = {
    "mlp-cls-full": ("mlp3", "classification", "full", 20),
    "mlp-cls-diag": ("mlp3", "classification", "diag", 20),
    "mlp-reg-full": ("mlp2", "regression", "full", 30),
    "mlp-reg-diag": ("mlp2", "regression", "diag", 30),
    "lenet-cls-full": ("lenet", "classification", "full", 150),
    "lenet-cls-diag": ("lenet", "classification", "diag", 150),
}


def _indices(models, model, k):
    n_params = models[model]["jnn"].n_params
    return np.sort(np.random.default_rng(k).choice(n_params, k, replace=False))


@pytest.fixture(scope="module", params=list(CONFIGS))
def fitted(request, models):
    model, lik, hs, k = CONFIGS[request.param]
    m, idx = models[model], _indices(models, model, k)
    kw = dict(sigma_noise=0.7) if lik == "regression" else {}
    jla = JaxLaplace(m["jnn"], lik, "subnetwork", hs, subnetwork_indices=idx,
                     prior_precision=0.5, **kw)
    tla = Laplace(m["tm"], lik, "subnetwork", hs, subnetwork_indices=idx, prior_precision=0.5,
                  device="cpu", **kw)
    jl, tl = _loaders(models, model, lik)
    jla.fit(jl)
    launches = syrk.launches
    tla.fit(tl)
    assert syrk.launches == launches  # the CPU route launches nothing
    Xt = m["X"][:5]
    out = dict(H=(jla.H, tla.H), mean=(jla.mean, tla.mean),
               posterior_precision=(jla.posterior_precision, tla.posterior_precision),
               loss=(float(jla.loss), float(tla.loss)),
               lml=(float(jla.log_marginal_likelihood()), float(tla.log_marginal_likelihood())),
               pred=(jla(jnp.asarray(Xt)), tla(Xt)),
               joint=(jla.functional_covariance(jla.backend.jacobians(jnp.asarray(Xt))[0]),
                      tla.functional_covariance(tla.backend.jacobians(tla._tensor(Xt))[0])))
    value = np.asarray(jla.mean) + 0.01 * np.random.default_rng(2).standard_normal(jla.n_params)
    out["log_prob"] = (float(jla.log_prob(jnp.asarray(value))), float(tla.log_prob(value)))
    key = jax.random.key(4)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (S, k), dtype=jnp.float64)))
    out["samples"] = (jla.sample(S, key=key), tla._samples_from(eps))
    j_g = jax.grad(lambda p: jla.log_marginal_likelihood(p))(jnp.asarray([0.8]))
    pp = torch.tensor([0.8], dtype=torch.float64, requires_grad=True)
    tla.log_marginal_likelihood(pp).backward()
    out["lml_grad"] = (j_g, pp.grad)
    out["lml_pp20"] = (float(jla.log_marginal_likelihood(20.0)),
                       float(tla.log_marginal_likelihood(20.0)))
    out["_la"] = (jla, tla, idx)
    return out


QUANTITIES = ["H", "mean", "posterior_precision", "loss", "lml", "pred", "joint", "log_prob",
              "samples", "lml_grad", "lml_pp20"]


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_matches_jax(fitted, quantity):
    ref, got = fitted[quantity]
    _close(got, ref)


def test_subnet_shapes_and_samples(fitted):
    jla, tla, idx = fitted["_la"]
    k = len(idx)
    assert tla.n_params_subnet == k and tla.n_params == jla.n_params
    assert tuple(tla.H.shape) == ((k, k) if isinstance(tla, FullSubnetLaplace) else (k,))
    if isinstance(tla, FullSubnetLaplace):
        assert torch.equal(tla.H, tla.H.mT)  # syrk_plain mirrors its lower triangle
    samples = tla.sample(3, generator=torch.Generator().manual_seed(0))
    rest = np.setdiff1d(np.arange(tla.n_params), idx)
    assert torch.equal(samples[:, rest], tla.mean[None, rest].expand(3, -1))
    _close(tla.assemble_full_samples(tla.mean_subnet[None]), tla.mean[None], rel=0)


@pytest.mark.parametrize("hs", ["full", "diag"])
def test_online_fit_matches_jax(models, hs):
    idx = _indices(models, "mlp3", 12)
    m = models["mlp3"]
    jla = JaxLaplace(m["jnn"], "classification", "subnetwork", hs, subnetwork_indices=idx)
    tla = Laplace(m["tm"], "classification", "subnetwork", hs, subnetwork_indices=idx,
                  device="cpu")
    jl, tl = _loaders(models, "mlp3", "classification")
    for la, loader in ((jla, jl), (tla, tl)):
        la.fit(loader)
        la.fit(loader, override=False)
    assert tla.n_data == jla.n_data == 2 * N
    _close(tla.H, jla.H)
    _close(tla.log_marginal_likelihood(), jla.log_marginal_likelihood())


def _masks(pkg, m, lik, loader):
    """Every strategy, built in `pkg`'s package on model `m`."""
    lib = jmask if pkg == "jax" else tmask
    model = m["jnn"] if pkg == "jax" else m["tm"]
    kw = {} if pkg == "jax" else dict(device="cpu")
    n_params = m["jnn"].n_params
    n_nonzero = int(np.count_nonzero(np.asarray(m["jnn"].mean_vector)))
    diag = (JaxDiagLaplace(model, lik) if pkg == "jax"
            else DiagLaplace(model, lik, device="cpu"))
    return {
        "random": lib.RandomSubnetMask(model, 10, seed=3, **kw),
        # past the nonzero weights: the top k cuts through the zero biases' tie
        "magnitude_tie": lib.LargestMagnitudeSubnetMask(model, n_nonzero + 5, **kw),
        "magnitude": lib.LargestMagnitudeSubnetMask(model, min(12, n_params), **kw),
        "variance_diag": lib.LargestVarianceDiagLaplaceSubnetMask(model, 10, diag, **kw),
        "variance_swag": lib.LargestVarianceSWAGSubnetMask(model, 10, likelihood=lik,
                                                           swag_n_snapshots=3, **kw),
        "param_name": lib.ParamNameSubnetMask(
            model, ["params/Dense_1/bias", "params/Dense_0/kernel"], **kw),
        "module_name": lib.ModuleNameSubnetMask(model, ["Dense_1"], **kw),
        "last_layer": lib.LastLayerSubnetMask(model, **kw),
        "last_layer_named": lib.LastLayerSubnetMask(model, "Dense_0", **kw),
    }


MASKS = ["random", "magnitude_tie", "magnitude", "variance_diag", "variance_swag",
         "param_name", "module_name", "last_layer", "last_layer_named"]


@pytest.fixture(scope="module")
def mask_indices(models):
    out = {}
    for model, lik in (("mlp3", "classification"), ("mlp2", "regression")):
        jl, tl = _loaders(models, model, lik)
        j, t = (_masks(p, models[model], lik, None) for p in ("jax", "torch"))
        out[model] = {name: (j[name].select(jl), t[name].select(tl)) for name in MASKS}
    return out


@pytest.mark.parametrize("model", ["mlp3", "mlp2"])
@pytest.mark.parametrize("name", MASKS)
def test_mask_indices_equal_jax(mask_indices, model, name):
    ref, got = mask_indices[model][name]
    assert isinstance(got, np.ndarray) and np.issubdtype(got.dtype, np.integer)
    np.testing.assert_array_equal(got, ref)


def test_magnitude_tie_is_real(models):
    """The tie case selects some but not all of the zero parameters."""
    theta = np.asarray(models["mlp3"]["jnn"].mean_vector)
    k = int(np.count_nonzero(theta)) + 5
    assert 0 < k - np.count_nonzero(theta) < np.sum(theta == 0)


def test_lenet_magnitude_and_module_masks(models):
    m = models["lenet"]
    jl, tl = _loaders(models, "lenet", "classification")
    for j, t in ((jmask.LargestMagnitudeSubnetMask(m["jnn"], 128),
                  tmask.LargestMagnitudeSubnetMask(m["tm"], 128, device="cpu")),
                 (jmask.ModuleNameSubnetMask(m["jnn"], ["Conv_1"]),
                  tmask.ModuleNameSubnetMask(m["tm"], ["Conv_1"], device="cpu")),
                 (jmask.LastLayerSubnetMask(m["jnn"]),
                  tmask.LastLayerSubnetMask(m["tm"], device="cpu"))):
        np.testing.assert_array_equal(t.select(tl), j.select(jl))


@pytest.mark.parametrize("lik,model", [("classification", "mlp3"), ("regression", "mlp2")])
def test_swag_iterates_match_optax(models, lik, model):
    """The port's SGD (`torch.optim.SGD` with weight decay and momentum)
    against optax's `chain(add_decayed_weights(wd), sgd(lr, momentum))`,
    as `laplace_jax/utils/swag.py` runs it, after each of 3 epochs."""
    m, (jl, tl) = models[model], _loaders(models, model, lik)
    jnn, lr, mom, wd = m["jnn"], 0.05, 0.9, 3e-4

    def criterion(f, y):
        if lik == "regression":
            return jnp.mean((f - y) ** 2)
        logp = jax.nn.log_softmax(f, axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[..., None].astype(int), axis=-1))

    opt = optax.chain(optax.add_decayed_weights(wd), optax.sgd(lr, momentum=mom))
    theta = jnn.mean_vector
    state = opt.init(theta)
    iterates = swag_iterates(m["tm"], tl, lik, lr=lr, momentum=mom, weight_decay=wd,
                             device="cpu")
    for _ in range(3):
        for x, y in jl:
            g = jax.grad(lambda t: criterion(jnn.apply_vec(t, jnp.asarray(x)), jnp.asarray(y)))(
                theta)
            updates, state = opt.update(g, state, theta)
            theta = optax.apply_updates(theta, updates)
        _close(next(iterates), theta, rel=1e-10)


@pytest.mark.parametrize("n_snapshots,freq", [(3, 1), (2, 2)])
def test_swag_variances_match_jax(models, n_snapshots, freq):
    m = models["mlp3"]
    jl, tl = _loaders(models, "mlp3", "classification")
    ref = jax_swag_var(m["jnn"], jl, "classification", n_snapshots_total=n_snapshots,
                       snapshot_freq=freq, lr=0.05)
    got = fit_diagonal_swag_var(m["tm"], tl, "classification", n_snapshots_total=n_snapshots,
                                snapshot_freq=freq, lr=0.05, device="cpu")
    _close(got, ref)
    assert float(got.min()) >= 1e-30


@pytest.mark.parametrize("hs,cls", [("full", FullSubnetLaplace), ("diag", DiagSubnetLaplace)])
def test_laplace_dispatch(models, hs, cls):
    m = models["mlp3"]
    la = Laplace(m["tm"], "classification", "subnetwork", hs, subnetwork_indices=[0, 5, 9],
                 device="cpu")
    assert type(la) is cls and la.n_params_subnet == 3


def test_unported_subnetwork_key_raises(models):
    with pytest.raises(ValueError, match="not ported"):
        Laplace(models["mlp3"]["tm"], "classification", "subnetwork", "kron",
                subnetwork_indices=[0], device="cpu")


BAD_INDICES = {"none": None, "empty": [], "two_dim": [[0, 1]], "float": [0.0, 1.0],
               "negative": [-1, 2], "too_large": [0, 10**6], "duplicate": [1, 1, 2]}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
@pytest.mark.parametrize("case", list(BAD_INDICES))
def test_index_validation_matches_jax(models, case, pkg):
    m, idx = models["mlp3"], BAD_INDICES[case]
    with pytest.raises(ValueError, match="[Ss]ubnetwork indices"):
        if pkg == "jax":
            JaxLaplace(m["jnn"], "classification", "subnetwork", "full", subnetwork_indices=idx)
        else:
            Laplace(m["tm"], "classification", "subnetwork", "full", subnetwork_indices=idx,
                    device="cpu")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_prior_length_checked_against_the_subnetwork(models, pkg):
    m = models["mlp3"]
    with pytest.raises(ValueError, match="subnetwork"):
        if pkg == "jax":
            JaxLaplace(m["jnn"], "classification", "subnetwork", "diag",
                       subnetwork_indices=[0, 1, 2], prior_precision=np.ones(4))
        else:
            Laplace(m["tm"], "classification", "subnetwork", "diag",
                    subnetwork_indices=[0, 1, 2], prior_precision=np.ones(4), device="cpu")


def test_mask_errors(models):
    m = models["mlp3"]["tm"]
    with pytest.raises(ValueError, match="larger than model"):
        tmask.RandomSubnetMask(m, 10**6, device="cpu")
    mask = tmask.RandomSubnetMask(m, 4, device="cpu")
    mask.select()
    with pytest.raises(ValueError, match="already selected"):
        mask.select()
    with pytest.raises(ValueError, match="do not exist"):
        tmask.ParamNameSubnetMask(m, ["Dense_9/kernel"], device="cpu").select()
    with pytest.raises(ValueError, match="do not exist"):
        tmask.ModuleNameSubnetMask(m, ["Dense_9"], device="cpu").select()
    with pytest.raises(ValueError, match="train loader"):
        tmask.LastLayerSubnetMask(m, device="cpu").select()
    with pytest.raises(AttributeError, match="not selected"):
        tmask.RandomSubnetMask(m, 4, device="cpu").indices
