"""Pickle-free save/load of every ported flavor (`laplace_jax_torch.utils.
serialization`, `BaseLaplace.save`/`load`), and archives moving between the
port and `laplace_jax`, in float64 on the JAX package's toy MLP (3 -> 20 ->
2, tanh; `tests/utils.py`) and its torch twin.

- A round trip of every flavor: Kron, Full, Diag; KronLL, FullLL, DiagLL
  (into a fresh instance that finds its head from the saved probe); the GP
  cached and streamed; the functional LL; the Full and Diag subnetwork. The
  loaded object predicts and gives the log marginal likelihood bit for bit.
- A round trip of FullLL and FunctionalLL on a 2-D conv head and on a
  LayerNorm head (`tests/test_torch_ll_heads.py`), found or named by
  `last_layer_name`: the loaded object takes the head's kind from the saved
  probe and predicts bit for bit.
- A JAX archive loads into the port and predicts what the JAX object
  predicts (within 1e-10); a port archive of Kron, Full and Diag loads into
  the JAX package likewise.
- The archive layout is the JAX package's (the same keys and metadata), and
  `np.load(..., allow_pickle=False)` reads it.
- The error cases of `tests/test_serialization_breadth.py:51-134`, with the
  JAX package's messages.
`LowRankLaplace`'s save and load, in both packages, are held in
`tests/test_torch_lowrank.py`.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import laplace_jax as lj
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax.utils.serialization import load_state_dict as jax_load_state_dict
from laplace_jax.utils.serialization import save_state_dict as jax_save_state_dict
from laplace_jax_torch import (
    DiagLaplace,
    DiagLLLaplace,
    DiagSubnetLaplace,
    FullLaplace,
    FullLLLaplace,
    FullSubnetLaplace,
    FunctionalLaplace,
    FunctionalLLLaplace,
    KronLaplace,
    KronLLLaplace,
    load_state_dict,
    save_state_dict,
)
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.utils.data import ArrayLoader

from .test_torch_ll_heads import HEADS, _head
from .utils import classification_data, make_mlp

torch.set_num_threads(1)

CROSS_TOL = 1e-10
IDX = np.array([1, 4, 9, 22, 40, 61, 77, 80])  # a subnetwork of the MLP's 102 weights

# name: (port class, JAX class, constructor keywords)
FLAVORS = {
    "kron": (KronLaplace, lj.KronLaplace, {}),
    "full": (FullLaplace, lj.FullLaplace, {}),
    "diag": (DiagLaplace, lj.DiagLaplace, {}),
    "kron_ll": (KronLLLaplace, lj.KronLLLaplace, {}),
    "full_ll": (FullLLLaplace, lj.FullLLLaplace, {}),
    "diag_ll": (DiagLLLaplace, lj.DiagLLLaplace, {}),
    "gp": (FunctionalLaplace, lj.FunctionalLaplace, dict(n_subset=6, streaming=False)),
    "gp_streamed": (FunctionalLaplace, lj.FunctionalLaplace, dict(n_subset=6, streaming=True)),
    "gp_ll": (FunctionalLLLaplace, lj.FunctionalLLLaplace, dict(n_subset=6)),
    "full_subnet": (FullSubnetLaplace, lj.FullSubnetLaplace, dict(subnetwork_indices=IDX)),
    "diag_subnet": (DiagSubnetLaplace, lj.DiagSubnetLaplace, dict(subnetwork_indices=IDX)),
}


@pytest.fixture(scope="module")
def setup():
    fm, params = make_mlp()
    tm = MLP(3, (20,), 2, "tanh").double()
    tm.load_state_dict(state_dict_from_flax(params, tm))
    X, y = (np.asarray(a) for a in classification_data(n=10))
    return dict(fm=fm, params=params, tm=tm, X=X, y=y)


def _port(setup, name, **kw):
    cls, _, extra = FLAVORS[name]
    return cls(setup["tm"], "classification", device="cpu", **(extra | kw))


def _jax(setup, name):
    _, cls, extra = FLAVORS[name]
    kw = {k: v for k, v in extra.items() if k != "streaming"}
    if "streaming" in extra:
        kw["streaming"] = extra["streaming"]
    return cls(JaxNNModel.from_flax(setup["fm"], setup["params"]), "classification", **kw)


def _loader(setup):
    return ArrayLoader(setup["X"], setup["y"], batch_size=5)


@pytest.mark.parametrize("name", sorted(FLAVORS))
def test_round_trip(setup, name, tmp_path):
    la = _port(setup, name)
    la.fit(_loader(setup))
    path = str(tmp_path / f"{name}.npz")
    la.save(path)
    la2 = _port(setup, name).load(path)
    X = setup["X"]
    assert torch.equal(la(X), la2(X))
    assert torch.equal(la.log_marginal_likelihood(), la2.log_marginal_likelihood())
    if name == "kron":  # the factors bit for bit, decomposed again on load
        for F1, F2 in zip(la.H_facs.kfacs, la2.H_facs.kfacs):
            assert all(torch.equal(a, b) for a, b in zip(F1, F2))
    if name.endswith("_ll"):
        assert la2.last_layer_path == la.last_layer_path == ("Dense_1",)
    if name == "gp_streamed":
        assert la2.Js_M is None and len(la2._sod_x) == len(la._sod_x)


@pytest.mark.parametrize("named", [False, True], ids=["found", "named"])
@pytest.mark.parametrize("head_name", ["conv2d", "norm"])
@pytest.mark.parametrize("cls,kw", [(FullLLLaplace, {}), (FunctionalLLLaplace, dict(n_subset=6))],
                         ids=["full_ll", "gp_ll"])
def test_round_trip_non_dense_head(head_name, named, cls, kw, tmp_path):
    head = _head(head_name)
    if named:
        kw = dict(kw, last_layer_name=".".join(head["path"]))
    la = cls(head["tm"], "classification", device="cpu", **kw)
    la.fit(ArrayLoader(head["X"], head["y"], batch_size=6))
    path = str(tmp_path / "head.npz")
    la.save(path)
    la2 = cls(head["tm"], "classification", device="cpu", **kw)
    assert la2.data is None
    la2.load(path)
    assert la2.last_layer_path == la.last_layer_path == head["path"]
    assert la2._head_kind == la._head_kind == HEADS[head_name][5]
    assert not la2.backend.last_layer_dense
    X = head["X"]
    assert torch.equal(la(X), la2(X))
    assert torch.equal(la.log_marginal_likelihood(), la2.log_marginal_likelihood())


@pytest.mark.parametrize("name", ["kron", "full", "diag", "kron_ll", "full_ll", "gp",
                                  "gp_streamed", "full_subnet"])
def test_jax_archive_loads_into_port(setup, name, tmp_path):
    jla = _jax(setup, name)
    jla.fit(JaxLoader(setup["X"], setup["y"], batch_size=5))
    path = str(tmp_path / "jax.npz")
    jla.save(path)
    la = _port(setup, name).load(path)
    X = setup["X"]
    np.testing.assert_allclose(la(X).numpy(), np.asarray(jla(jnp.asarray(X))), rtol=0,
                               atol=CROSS_TOL)
    ref = float(jla.log_marginal_likelihood())
    assert abs(float(la.log_marginal_likelihood()) - ref) <= CROSS_TOL * abs(ref)


@pytest.mark.parametrize("name", ["kron", "full", "diag"])
def test_port_archive_loads_into_jax(setup, name, tmp_path):
    la = _port(setup, name)
    la.fit(_loader(setup))
    path = str(tmp_path / "port.npz")
    la.save(path)
    jla = _jax(setup, name).load(path)
    X = setup["X"]
    np.testing.assert_allclose(np.asarray(jla(jnp.asarray(X))), la(X).numpy(), rtol=0,
                               atol=CROSS_TOL)


def test_archive_layout_and_no_pickle(setup, tmp_path):
    """The port writes the JAX package's keys and metadata for the same
    state; every entry loads with `allow_pickle=False` and none is an
    object array."""
    la = _port(setup, "kron")
    la.fit(_loader(setup))
    jla = _jax(setup, "kron")
    jla.fit(JaxLoader(setup["X"], setup["y"], batch_size=5))
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    save_state_dict(la.state_dict(), ours)
    jax_save_state_dict(jla.state_dict(), theirs)
    with np.load(ours, allow_pickle=False) as a, np.load(theirs, allow_pickle=False) as b:
        assert sorted(a.files) == sorted(b.files)
        assert all(a[k].dtype.kind != "O" for k in a.files)
        meta_a = json.loads(bytes(a["__laplace_jax_meta__"]).decode())
        meta_b = json.loads(bytes(b["__laplace_jax_meta__"]).decode())
    assert meta_a == meta_b
    assert meta_a["H"] == {"kind": "Kron", "n_leaves": 6, "aux": [1, 2, 1, 2]}
    # a decomposed Kron in the tree-flatten order, through both loaders
    H = la.H
    save_state_dict({"H": H}, ours)
    for state in (load_state_dict(ours), jax_load_state_dict(ours)):
        for Qs, Qs2 in zip(H.eigenvectors, state["H"].eigenvectors):
            assert all(np.array_equal(np.asarray(a), np.asarray(b)) for a, b in zip(Qs, Qs2))
        assert np.array_equal(np.asarray(state["H"].deltas), H.deltas.numpy())


def test_loaded_arrays_are_numpy(setup, tmp_path):
    la = _port(setup, "full_ll")
    la.fit(_loader(setup))
    path = str(tmp_path / "ll.npz")
    la.save(path)
    state = load_state_dict(path)
    assert isinstance(state["mean"], np.ndarray) and isinstance(state["data"], np.ndarray)
    assert state["_last_layer_name"] is None and state["cls_name"] == "FullLLLaplace"


@pytest.fixture(scope="module")
def full_state(setup):
    la = _port(setup, "full")
    la.fit(_loader(setup))
    return la.state_dict()


@pytest.mark.parametrize("other", ["kron", "diag", "full_ll"])
def test_wrong_flavor_load_raises(setup, full_state, other):
    with pytest.raises(ValueError, match="wrong Laplace type"):
        _port(setup, other).load_state_dict(full_state)


def test_wrong_likelihood_load_raises(setup, full_state):
    la = FullLaplace(setup["tm"], "regression", device="cpu")
    with pytest.raises(ValueError, match="Different likelihoods"):
        la.load_state_dict(full_state)


def test_different_parameter_count_raises(full_state):
    other = MLP(3, (7,), 2, "tanh").double()
    with pytest.raises(ValueError, match="different number of parameters"):
        FullLaplace(other, "classification", device="cpu").load_state_dict(full_state)


@pytest.mark.parametrize("key,value,message", [("temperature", 2.0, "temperature"),
                                               ("enable_backprop", True, "enable_backprop")])
def test_mismatched_hyperparams_warn(setup, full_state, key, value, message):
    la = FullLaplace(setup["tm"], "classification", device="cpu", **{key: value})
    with pytest.warns(UserWarning, match=message):
        la.load_state_dict(full_state)


def test_subnet_wrong_indices_load_raises(setup):
    la = _port(setup, "full_subnet")
    la.fit(_loader(setup))
    other = FullSubnetLaplace(setup["tm"], "classification", IDX[:5], device="cpu")
    with pytest.raises(ValueError, match="Different `subnetwork_indices`"):
        other.load_state_dict(la.state_dict())


@pytest.mark.parametrize("name", ["full_ll", "gp_ll"])
def test_ll_wrong_last_layer_name_load_raises(setup, name):
    la = _port(setup, name, last_layer_name="Dense_1")
    la.fit(_loader(setup))
    state = la.state_dict()
    assert state["_last_layer_name"] == "Dense_1"
    with pytest.raises(ValueError, match="Different `last_layer_name`"):
        _port(setup, name, last_layer_name="Dense_0").load_state_dict(state)


def test_unfitted_state_raises(setup):
    with pytest.raises(AttributeError, match="not fitted"):
        _port(setup, "kron").state_dict()
