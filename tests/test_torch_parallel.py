"""The port's data parallelism (`laplace_jax_torch/parallel/`) on gloo
groups of 2 and 3 CPU ranks, against the port's single-rank fits and the
JAX package's `DataParallel` fits over 8 virtual devices (`conftest.py`),
in float64. Mirrors `tests/test_parallel.py`, `test_parallel_2d.py` and
`test_multiprocess.py`.

One module fixture starts both groups at once, each rank a process of
`tests/torch_parallel_worker.py` (torch and the port only), and computes
the JAX references while they run; every scenario of a group runs in that
one spawn. Each rank fits every scenario with `parallel=` and without it.

Tolerances, the JAX files' own: Kron diagonal rtol 1e-10, H rtol 1e-8
(atol 1e-12), probit atol 1e-8 (1e-10 for the sharded predictive and the
sharded posterior), loss rtol 1e-10, marglik rtol 1e-10 (1e-8 through the
Laplace factory, as `mp_worker.py`), the (replica x data) meshes' H atol
1e-10, LowRank eigenvalues atol 1e-8 and |U| atol 1e-6, the sharded
posterior's log det rtol 1e-10 and samples atol 1e-8. Every rank must
hold the same results bit for bit: the sums are `all_reduce`d and the
predictive `all_gather`ed. The MC Fisher is held (rtol 1e-10) to the sum
of each rank's rows fitted alone with that rank's generator: each rank
draws for its own rows, so it cannot equal a single-rank MC fit draw for
draw.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from laplace_jax import DiagLaplace as JaxDiag
from laplace_jax import FullLaplace as JaxFull
from laplace_jax import KronLaplace as JaxKron
from laplace_jax import LowRankLaplace as JaxLowRank
from laplace_jax.models import MLP as FlaxMLP
from laplace_jax.nnmodel import NNModel as JaxNNModel
from laplace_jax.parallel import DataParallel as JaxDataParallel
from laplace_jax.parallel import data_mesh as jax_data_mesh
from laplace_jax.utils.data import ArrayLoader as JaxLoader
from laplace_jax_torch import DiagLaplace
from laplace_jax_torch.models.mlp import MLP
from laplace_jax_torch.models.resnet import state_dict_from_flax
from laplace_jax_torch.parallel import DataParallel, data_mesh, multihost_mesh
from laplace_jax_torch.utils.data import ArrayLoader

from . import torch_parallel_worker as W
from .torch_twins import mlp_pair

WORLDS = (2, 3)
WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_parallel_worker.py")
JAX_FLAVORS = {"full": JaxFull, "kron": JaxKron, "diag": JaxDiag}


def _flat(la):
    H = la.H_facs if isinstance(la, JaxKron) else la.H
    if isinstance(H, jax.Array):
        return np.asarray(H).reshape(-1)
    return np.concatenate([np.asarray(F).reshape(-1) for G in H.kfacs for F in G])


def _mlp2d(hidden, X):
    fm = FlaxMLP(hidden=(hidden,), out_dim=3, dtype=jnp.float64)
    params = fm.init(jax.random.key(0), jnp.asarray(X[:1]))
    tm = MLP(5, (hidden,), 3).double()
    return JaxNNModel.from_flax(fm, params), state_dict_from_flax(params, tm)


def _inputs():
    """The models' weights for the workers, and the JAX models."""
    jm, tm = mlp_pair()
    X2, _ = W.setup_2d()
    jm8, sd8 = _mlp2d(8, X2)
    _, sd13 = _mlp2d(13, X2)
    inp = {f"w/mlp/{k}": v.numpy() for k, v in tm.state_dict().items()}
    inp.update({f"w/mlp8/{k}": v.numpy() for k, v in sd8.items()})
    inp.update({f"w/mlp13/{k}": v.numpy() for k, v in sd13.items()})
    P8 = jm8.n_params
    v0 = jax.random.normal(jax.random.key(0), (P8,), dtype=jnp.float64)
    inp["v0/mlp8"] = np.asarray(v0 / jnp.linalg.norm(v0))
    return inp, dict(mlp=jm, mlp8=jm8)


def _jax_refs(models):
    """The JAX package's `DataParallel` fits (its default mode, which its
    own tests hold to the explicit one) of the flavors, the uneven batch,
    regression and LowRank on a (replica x data) mesh; the probit on 12
    inputs."""
    ref = {}
    X, y = W.classification(W.N_MAIN)
    loader = JaxLoader(X, y, batch_size=W.BATCH_MAIN)
    dp = JaxDataParallel(jax_data_mesh())
    for name, cls in JAX_FLAVORS.items():
        la = cls(models["mlp"], "classification", parallel=dp)
        la.fit(loader)
        key = f"flavor/{name}"
        ref[f"{key}/H"] = _flat(la)
        ref[f"{key}/loss"] = float(la.loss)
        ref[f"{key}/lml"] = float(la.log_marginal_likelihood())
        if name == "kron":
            ref[f"{key}/diag"] = np.asarray(la.H_facs.diag())
        ref[f"{key}/probit_x12"] = np.asarray(
            la(jnp.asarray(W.classification(12)[0]), link_approx="probit"))
    Xu, yu = W.classification(31)
    la = JaxDiag(models["mlp"], "classification", parallel=dp)
    la.fit(JaxLoader(Xu, yu, batch_size=31))
    ref["uneven/H"] = _flat(la)
    Xr, yr = W.regression(W.N_MAIN)
    la = JaxFull(models["mlp"], "regression", parallel=dp)
    la.fit(JaxLoader(Xr, yr, batch_size=W.BATCH_MAIN))
    ref["regression_full/lml"] = float(la.log_marginal_likelihood())
    X2, y2 = W.setup_2d()
    loader2 = JaxLoader(X2, y2, batch_size=W.BATCH_MAIN)
    mesh2 = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2), ("replica", "data"))
    dp2 = JaxDataParallel(mesh2, axis_name=("replica", "data"))
    la = JaxLowRank(models["mlp8"], "classification", backend="ggn", low_rank=5, parallel=dp2)
    la.fit(loader2)
    (U, lam), _ = la.posterior_precision
    ref["lowrank/U"], ref["lowrank/eigvals"] = np.asarray(U), np.asarray(lam)
    ref["lowrank/probit"] = np.asarray(la(jnp.asarray(X2[:5]), link_approx="probit"))
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{world: [rank 0's results, rank 1's, ...]} and the JAX references."""
    tmp = tmp_path_factory.mktemp("parallel")
    inp, models = _inputs()
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {w: [subprocess.Popen(
        [sys.executable, WORKER, str(tmp / f"rdv{w}"), str(r), str(w), str(tmp / "in.npz"),
         str(tmp / f"out{w}_{r}.npz")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, text=True) for r in range(w)] for w in WORLDS}
    try:
        ref = _jax_refs(models)
        outs = {w: [p.communicate(timeout=300)[0] for p in ps] for w, ps in procs.items()}
    finally:
        for ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
    for w, ps in procs.items():
        for r, (p, out) in enumerate(zip(ps, outs[w])):
            assert p.returncode == 0 and f"WORKER_OK rank={r}" in out, \
                f"world {w} rank {r} failed (rc={p.returncode}):\n{out[-4000:]}"
    return {w: [dict(np.load(tmp / f"out{w}_{r}.npz")) for r in range(w)]
            for w in WORLDS}, ref


def _res(runs, world):
    return runs[0][world][0]


def _close(got, ref, rtol=0.0, atol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("world", WORLDS)
def test_every_rank_holds_the_same_results(runs, world):
    ranks = runs[0][world]
    assert int(ranks[0]["world"]) == world
    for other in ranks[1:]:
        assert sorted(other) == sorted(ranks[0])
        for k in ranks[0]:
            if k.startswith("shard/p122"):  # a rank outside the posterior mesh keeps H whole
                continue
            np.testing.assert_array_equal(other[k], ranks[0][k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", list(W.MODES))
@pytest.mark.parametrize("flavor", list(W.FLAVORS))
def test_sharded_fit_equals_single_rank_and_jax(runs, world, mode, flavor):
    res, ref = _res(runs, world), runs[1]
    key, jkey = f"flavor/{flavor}/{mode}", f"flavor/{flavor}"
    for src in (res[f"{key}/one/H"], ref[f"{jkey}/H"]):
        _close(res[f"{key}/par/H"], src, rtol=1e-8, atol=1e-12)
    if flavor == "kron":
        for src in (res[f"{key}/one/diag"], ref[f"{jkey}/diag"]):
            _close(res[f"{key}/par/diag"], src, rtol=1e-10)
    for src in (res[f"{key}/one/loss"], ref[f"{jkey}/loss"]):
        _close(res[f"{key}/par/loss"], src, rtol=1e-10)
    # the Kron fit decomposes on the mesh (`test_decompose_multidevice.py`)
    for src in (res[f"{key}/one/lml"], ref[f"{jkey}/lml"]):
        _close(res[f"{key}/par/lml"], src, rtol=1e-8)
    # 10 and 12 rows: sharded over 2 ranks; 7, and 10 over 3, whole on each
    for xn in ("x10", "x12", "x7"):
        _close(res[f"{key}/par/probit_{xn}"], res[f"{key}/one/probit_{xn}"], atol=1e-8)
    _close(res[f"{key}/par/probit_x12"], ref[f"{jkey}/probit_x12"], atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_kron_fit_keeps_the_first_ranks_eigenpairs(runs, world):
    """Each rank decomposes every factor itself; where the ranks' solves
    differ (here by a factor 1 + 1e-6 rank on the eigenvalues), every rank
    keeps the first rank's eigenpairs: each rank's equal the unskewed
    single-rank fit's to the H tolerances, and every rank holds the same
    bits (`test_every_rank_holds_the_same_results`)."""
    for res in runs[0][world]:
        _close(res["rank_solver/par/eigvals"], res["rank_solver/one/eigvals"], rtol=1e-8,
               atol=1e-12)
        _close(res["rank_solver/par/lml"], res["rank_solver/one/lml"], rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_uneven_batch_default_mode_and_explicit_rejection(runs, world):
    res, ref = _res(runs, world), runs[1]
    for src in (res["uneven/one/H"], ref["uneven/H"]):
        _close(res["uneven/par/H"], src, rtol=1e-8, atol=1e-12)
    assert "not divisible" in str(res["uneven/explicit_raised"])


@pytest.mark.parametrize("world", WORLDS)
def test_batch_smaller_than_group_runs_whole(runs, world):
    res = _res(runs, world)
    _close(res["small/par/H"], res["small/one/H"], rtol=1e-12)
    _close(res["small/par/loss"], res["small/one/loss"], rtol=1e-12)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_regression_full_marglik(runs, world):
    res, ref = _res(runs, world), runs[1]
    for src in (res["regression_full/one/lml"], ref["regression_full/lml"]):
        _close(res["regression_full/par/lml"], src, rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", list(W.MODES))
def test_mc_fisher_is_each_ranks_rows_with_its_generator(runs, world, mode):
    res = _res(runs, world)
    _close(res[f"mc/{mode}/par"], res[f"mc/{mode}/ref"], rtol=1e-10, atol=1e-14)


def test_explicit_mode_draws_differ_across_ranks(runs):
    res = _res(runs, 2)
    assert not np.allclose(res["mc/explicit/par"], res["mc/annotated/par"])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("flavor", list(W.LL_FLAVORS))
def test_last_layer_flavors_pass_parallel_through(runs, world, flavor):
    res = _res(runs, world)
    key = f"ll/{flavor}"
    _close(res[f"{key}/par/H"], res[f"{key}/one/H"], rtol=1e-8, atol=1e-12)
    _close(res[f"{key}/par/lml"], res[f"{key}/one/lml"], rtol=1e-10)
    _close(res[f"{key}/par/probit_x12"], res[f"{key}/one/probit_x12"], atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_gp_and_subnet_pass_parallel_through(runs, world):
    res = _res(runs, world)
    _close(res["gp/par/lml"], res["gp/one/lml"], rtol=1e-10)
    _close(res["gp/par/probit_x12"], res["gp/one/probit_x12"], atol=1e-8)
    _close(res["subnet/par/H"], res["subnet/one/H"], rtol=1e-8, atol=1e-12)
    _close(res["subnet/par/probit_x12"], res["subnet/one/probit_x12"], atol=1e-8)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mesh", ["one_host", "per_rank"])
@pytest.mark.parametrize("mode", list(W.MODES))
@pytest.mark.parametrize("structure", ["kron", "diag"])
def test_replica_data_mesh_fit_equals_single(runs, world, mesh, mode, structure):
    res = _res(runs, world)
    shape = {"one_host": [1, world], "per_rank": [world, 1]}[mesh]
    assert list(res[f"mesh2d/{mesh}/shape"]) == shape
    key = f"mesh2d/{mesh}/{structure}/{mode}"
    _close(res[f"{key}/par/H"], res[f"{key}/one/H"], atol=1e-10)
    _close(res[f"{key}/par/loss"], res[f"{key}/one/loss"], rtol=1e-12)
    _close(res[f"{key}/par/lml"], res[f"{key}/one/lml"], rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_one_dim_of_a_2d_mesh_and_mesh_errors(runs, world):
    res = _res(runs, world)
    _close(res["mesh2d/replica_axis/par/H"], res["mesh2d/replica_axis/one/H"], rtol=1e-8,
           atol=1e-12)
    assert "explicit mesh" in str(res["mesh2d/no_mesh_raised"])
    if world == 3:
        assert "Non-uniform hosts" in str(res["mesh2d/nonuniform_raised"])


@pytest.mark.parametrize("world", WORLDS)
def test_lowrank_lanczos_sharded_equals_single_and_jax(runs, world):
    res, ref = _res(runs, world), runs[1]
    for U, lam, probit in ((res["lowrank/one/U"], res["lowrank/one/eigvals"],
                            res["lowrank/one/probit"]),
                           (ref["lowrank/U"], ref["lowrank/eigvals"], ref["lowrank/probit"])):
        _close(res["lowrank/par/eigvals"], lam, atol=1e-8)
        _close(np.abs(res["lowrank/par/U"]), np.abs(U), atol=1e-6)
        _close(res["lowrank/par/probit"], probit, atol=1e-8)
    _close(res["lowrank/par/loss"], res["lowrank/one/loss"], rtol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_full_shard_posterior_equals_replicated(runs, world):
    res = _res(runs, world)
    assert str(res["shard/placements"]) == "(Shard(dim=0),)"
    assert int(res["shard/local_rows"]) == 120 // world
    _close(res["shard/sharded/logdet"], res["shard/replicated/logdet"], rtol=1e-10)
    _close(res["shard/sharded/samples"], res["shard/replicated/samples"], atol=1e-8)
    _close(res["shard/sharded/probit"], res["shard/replicated/probit"], atol=1e-10)
    _close(res["shard/sharded/lml"], res["shard/replicated/lml"], rtol=1e-10)
    _close(res["shard/sharded/square_norm"], res["shard/replicated/square_norm"], rtol=1e-10)
    assert np.isfinite(res["shard/sharded/tuned_prior"]).all()


@pytest.mark.parametrize("world", WORLDS)
def test_shard_posterior_group_size_must_divide(runs, world):
    """P = 122: over 3 ranks, no mesh takes 2 of them (with a warning, the
    third keeps H whole) and a mesh axis of 3 raises; over 2 both divide."""
    ranks = runs[0][world]
    logdets = [float(r["shard/p122/logdet"]) for r in ranks]
    _close(logdets, [logdets[0]] * world, rtol=1e-12)
    warned = [str(w) for w in ranks[0]["shard/p122/warned"]]
    raised = str(ranks[0]["shard/p122/mesh_raised"])
    if world == 3:
        assert any("sharding the posterior over 2" in w for w in warned)
        assert [bool(r["shard/p122/is_dtensor"]) for r in ranks] == [True, True, False]
        assert "must be divisible" in raised
    else:
        assert warned == [""] and raised == ""
        assert all(bool(r["shard/p122/is_dtensor"]) for r in ranks)


@pytest.fixture
def world_of_one():
    """A process group of this one process (the fallback `data_mesh` and
    `multihost_mesh` bring up), torn down after the test so that the next
    test file of this worker starts without one."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def test_single_process_fallback(world_of_one):
    """With no group up, `DataParallel()` and `multihost_mesh()` run over a
    world of this one process: (1, 1) meshes, fits equal the plain ones."""
    assert not dist.is_initialized()
    mesh = multihost_mesh()
    assert mesh.mesh_dim_names == ("replica", "data") and tuple(mesh.shape) == (1, 1)
    assert tuple(data_mesh().shape) == (1,)
    nnm, tm = mlp_pair()
    X, y = W.classification(16)
    loader = ArrayLoader(X, y, batch_size=8)
    one = DiagLaplace(tm, "classification", device="cpu")
    one.fit(loader)
    dp = DataParallel(mesh, axis_name=("replica", "data"))
    par = DiagLaplace(tm, "classification", device="cpu", parallel=dp)
    par.fit(loader)
    assert dp.size == 1
    torch.testing.assert_close(par.H, one.H, rtol=0, atol=0)
    assert np.isfinite(float(par.log_marginal_likelihood()))


def test_rows_cut_as_tensor_split():
    """Each rank's row block is the one `torch.tensor_split` gives it."""
    shards = object.__new__(W.sharding._Shards)
    for size in (1, 2, 3, 8):
        for bsz in (1, 7, 24, 31):
            shards.size = size
            blocks = torch.tensor_split(torch.arange(bsz), size)
            for r in range(size):
                shards.rank = r
                assert torch.arange(bsz)[shards.rows(bsz)].tolist() == blocks[r].tolist()
