"""One rank of the port's data-parallel scenarios on a gloo group.

    python tests/torch_parallel_worker.py RENDEZVOUS RANK WORLD INPUT.npz OUT.npz

`tests/test_torch_parallel.py` starts WORLD of these on one host (a
`file://` rendezvous at RENDEZVOUS, one CPU thread each). INPUT holds the
models' float64 weights (torch layout, carried over from the flax twins)
and the JAX package's Lanczos start vector. Every rank builds the same
data from numpy seeds (the multi-process contract: every rank's loader
yields the same global batch), fits each scenario with `parallel=` and
without it, and writes its results to OUT; the test compares the ranks,
the two fits, and the JAX package. This file imports torch and the port
only, never JAX. It prints `WORKER_OK rank=R` when every scenario ran.
"""

import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from laplace_jax_torch import (  # noqa: E402
    DiagLaplace,
    DiagLLLaplace,
    FullLaplace,
    FullLLLaplace,
    FullSubnetLaplace,
    FunctionalLaplace,
    KronLaplace,
    KronLLLaplace,
    Laplace,
    LowRankLaplace,
)
from laplace_jax_torch.curvature import lanczos  # noqa: E402
from laplace_jax_torch.models.mlp import MLP  # noqa: E402
from laplace_jax_torch.parallel import DataParallel, data_mesh, multihost_mesh  # noqa: E402
from laplace_jax_torch.parallel import sharding  # noqa: E402
from laplace_jax_torch.utils.data import ArrayLoader  # noqa: E402
from laplace_jax_torch.utils.matrix import Kron, KronDecomposed  # noqa: E402

FLAVORS = {"full": FullLaplace, "kron": KronLaplace, "diag": DiagLaplace}
LL_FLAVORS = {"full": FullLLLaplace, "kron": KronLLLaplace, "diag": DiagLLLaplace}
MODES = {"annotated": False, "explicit": True}
# the global batch divides 2, 3 and the JAX package's 8 virtual devices
N_MAIN, BATCH_MAIN = 48, 24


def classification(n, d=3, k=2, seed=711):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), rng.integers(0, k, size=(n,))


def regression(n, d=3, k=2, seed=711):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, d)), rng.standard_normal((n, k))


def setup_2d(n=N_MAIN, seed=0):
    """`tests/test_parallel_2d.py`'s data: 5 features, 3 classes."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 5)), rng.integers(0, 3, size=(n,))


def net(inp, name):
    """The MLP twin `name` with the weights the test carried over."""
    in_dim, hidden, out = {"mlp": (3, 20, 2), "mlp8": (5, 8, 3), "mlp13": (5, 13, 3)}[name]
    m = MLP(in_dim, (hidden,), out).double()
    m.load_state_dict({k.split("/", 2)[2]: torch.as_tensor(v) for k, v in inp.items()
                       if k.startswith(f"w/{name}/")})
    return m


def curvature(la):
    """The fitted curvature, flat: a Kron's factors, else H."""
    H = la.H_facs if isinstance(la, KronLaplace) else la.H
    if isinstance(H, Kron):
        return torch.cat([F.reshape(-1) for G in H.kfacs for F in G])
    return sharding.full_tensor(H).reshape(-1)


class Results(dict):
    def put(self, key, value):
        if torch.is_tensor(value):
            value = value.detach().cpu().numpy()
        self[key] = np.asarray(value)

    def fit_pair(self, key, make, loader, X_tests):
        """`make(parallel)` fitted with a `DataParallel` and without one:
        curvature, loss, marglik and the probit on each test batch."""
        for tag, la in (("one", make(None)), ("par", make(True))):
            la.fit(loader)
            self.put(f"{key}/{tag}/H", curvature(la))
            self.put(f"{key}/{tag}/loss", la.loss)
            self.put(f"{key}/{tag}/lml", la.log_marginal_likelihood())
            if isinstance(la, KronLaplace):
                self.put(f"{key}/{tag}/diag", la.H_facs.diag())
            for name, X in X_tests.items():
                self.put(f"{key}/{tag}/probit_{name}", la(X, link_approx="probit"))


def main():
    rendezvous, rank, world, inp_path, out_path = sys.argv[1:6]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", world_size=world,
                            rank=rank)
    inp = dict(np.load(inp_path))
    res = Results()
    mlp = net(inp, "mlp")
    X, y = classification(N_MAIN)
    loader = ArrayLoader(X, y, batch_size=BATCH_MAIN)
    X_tests = {"x10": classification(10)[0], "x12": classification(12)[0],
               "x7": classification(7)[0]}

    # Full, Kron and Diag in both modes (`tests/test_parallel.py`)
    mesh = data_mesh()
    for mode, explicit in MODES.items():
        dpm = DataParallel(mesh, explicit=explicit)
        for name, cls in FLAVORS.items():
            res.fit_pair(f"flavor/{name}/{mode}", lambda p, cls=cls: cls(
                mlp, "classification", device="cpu", parallel=dpm if p else None),
                loader, X_tests)
    dp = DataParallel(mesh)
    # each rank's decompose made to differ by rank, as a solver whose bits do
    # not repeat differs: the fit keeps the first rank's eigenpairs on all
    real_decompose = Kron.decompose

    def skewed(self, *args, **kwargs):
        dec = real_decompose(self, *args, **kwargs)
        return KronDecomposed(dec.eigenvectors, [tuple(l * (1 + rank * 1e-6) for l in ls)
                                                 for ls in dec.eigenvalues], damping=dec.damping)

    for tag in ("one", "par"):
        la = KronLaplace(mlp, "classification", device="cpu", parallel=dp if tag == "par" else None)
        Kron.decompose = skewed if tag == "par" else real_decompose
        la.fit(loader)
        Kron.decompose = real_decompose
        res.put(f"rank_solver/{tag}/eigvals", torch.cat([l for ls in la.H.eigenvalues for l in ls]))
        res.put(f"rank_solver/{tag}/lml", la.log_marginal_likelihood())
    # a global batch no group size divides: the default mode sums uneven row
    # blocks; the explicit mode refuses it
    Xu, yu = classification(31)
    uneven = ArrayLoader(Xu, yu, batch_size=31)
    res.fit_pair("uneven", lambda p: DiagLaplace(mlp, "classification", device="cpu",
                                                 parallel=dp if p else None), uneven, {})
    try:
        DiagLaplace(mlp, "classification", device="cpu",
                    parallel=DataParallel(mesh, explicit=True)).fit(uneven)
        res.put("uneven/explicit_raised", "")
    except ValueError as e:
        res.put("uneven/explicit_raised", str(e))
    # a batch smaller than the group runs whole on every rank
    Xs, ys = classification(world - 1 or 1)
    res.fit_pair("small", lambda p: FullLaplace(mlp, "classification", device="cpu",
                                                parallel=dp if p else None),
                 ArrayLoader(Xs, ys, batch_size=len(ys)), {})
    # regression Full marglik
    Xr, yr = regression(N_MAIN)
    res.fit_pair("regression_full", lambda p: FullLaplace(mlp, "regression", device="cpu",
                                                          parallel=dp if p else None),
                 ArrayLoader(Xr, yr, batch_size=BATCH_MAIN), {})
    # the MC Fisher: each rank draws for its own rows, so the fit is held to
    # the sum of each rank's rows fitted alone with that rank's generator
    for mode, explicit in MODES.items():
        dpm = DataParallel(mesh, explicit=explicit)
        la = KronLaplace(mlp, "classification", backend="mc", device="cpu", parallel=dpm)
        la.fit(loader)
        res.put(f"mc/{mode}/par", curvature(la))
        ref = KronLaplace(mlp, "classification", backend="mc", device="cpu")
        caller = torch.Generator().manual_seed(0)  # the instance generator of a fit
        gens = [torch.Generator().manual_seed(0) for _ in range(world)]
        H = None
        for xb, yb in loader:
            if explicit:
                seed = sharding.draw_seed(caller)
                gens = [sharding.rank_generator(seed, r, "cpu") for r in range(world)]
            for r, idx in enumerate(torch.tensor_split(torch.arange(len(yb)), world)):
                _, H_r = ref._curv_closure(torch.as_tensor(xb[idx.numpy()]),
                                           torch.as_tensor(yb[idx.numpy()]), len(y), gens[r])
                H = H_r if H is None else H + H_r
        res.put(f"mc/{mode}/ref", torch.cat([F.reshape(-1) for G in H.kfacs for F in G]))

    # last-layer, GP and subnetwork flavors pass `parallel` through
    for name, cls in LL_FLAVORS.items():
        res.fit_pair(f"ll/{name}", lambda p, cls=cls: cls(
            mlp, "classification", device="cpu", parallel=dp if p else None),
            loader, {"x12": X_tests["x12"]})
    for tag, p in (("one", None), ("par", dp)):
        gp = FunctionalLaplace(mlp, "classification", n_subset=24, device="cpu", parallel=p)
        gp.fit(loader)
        res.put(f"gp/{tag}/lml", gp.log_marginal_likelihood())
        res.put(f"gp/{tag}/probit_x12", gp(X_tests["x12"]))
        sub = FullSubnetLaplace(mlp, "classification", subnetwork_indices=np.arange(0, 122, 3),
                                device="cpu", parallel=p)
        sub.fit(loader)
        res.put(f"subnet/{tag}/H", sub.H)
        res.put(f"subnet/{tag}/probit_x12", sub(X_tests["x12"]))

    # (replica x data) meshes (`tests/test_parallel_2d.py`, `test_multiprocess.py`):
    # one host, (1, world); every rank a host of its own, (world, 1)
    real_host = sharding._host_name
    meshes = {"one_host": multihost_mesh()}
    sharding._host_name = lambda: f"host{rank}"
    meshes["per_rank"] = multihost_mesh()
    if world == 3:  # hosts of 2 and 1 ranks
        sharding._host_name = lambda: f"host{rank // 2}"
        try:
            multihost_mesh()
            res.put("mesh2d/nonuniform_raised", "")
        except ValueError as e:
            res.put("mesh2d/nonuniform_raised", str(e))
    sharding._host_name = real_host
    mlp8 = net(inp, "mlp8")
    X2, y2 = setup_2d()
    loader2 = ArrayLoader(X2, y2, batch_size=BATCH_MAIN)
    for mesh_name, mesh in meshes.items():
        res.put(f"mesh2d/{mesh_name}/shape", list(mesh.shape))
        for mode, explicit in MODES.items():
            dp2 = DataParallel(mesh, axis_name=("replica", "data"), explicit=explicit)
            for structure in ("kron", "diag"):
                res.fit_pair(f"mesh2d/{mesh_name}/{structure}/{mode}", lambda p: Laplace(
                    mlp8, "classification", "all", structure, device="cpu",
                    parallel=dp2 if p else None), loader2, {})
    # one dim of a 2-D mesh
    dp2 = DataParallel(meshes["per_rank"], axis_name="replica")
    res.fit_pair("mesh2d/replica_axis", lambda p: DiagLaplace(
        mlp8, "classification", device="cpu", parallel=dp2 if p else None), loader2, {})
    try:
        DataParallel(axis_name=("replica", "data"))
        res.put("mesh2d/no_mesh_raised", "")
    except ValueError as e:
        res.put("mesh2d/no_mesh_raised", str(e))

    # LowRank Lanczos over a (world, 1) mesh, from the JAX package's start vector
    v0 = torch.as_tensor(inp["v0/mlp8"])
    lanczos.start_vector = lambda P, dtype, device, generator: v0.to(dtype)
    for tag, p in (("one", None), ("par", DataParallel(meshes["per_rank"],
                                                        axis_name=("replica", "data")))):
        lr = LowRankLaplace(mlp8, "classification", backend="ggn", low_rank=5, device="cpu",
                            parallel=p)
        lr.fit(loader2)
        res.put(f"lowrank/{tag}/U", lr.H[0])
        res.put(f"lowrank/{tag}/eigvals", lr.H[1])
        res.put(f"lowrank/{tag}/loss", lr.loss)
        res.put(f"lowrank/{tag}/probit", lr(X2[:5], link_approx="probit"))

    # FullLaplace.shard_posterior: P = 120 divides 2 and 3
    mlp13 = net(inp, "mlp13")
    la = FullLaplace(mlp13, "classification", device="cpu")
    la.fit(loader2)
    for tag in ("replicated", "sharded"):
        if tag == "sharded":
            la.shard_posterior()
            res.put("shard/placements", str(la.H.placements))
            res.put("shard/local_rows", la.H.to_local().shape[0])
        res.put(f"shard/{tag}/logdet", la.log_det_posterior_precision)
        res.put(f"shard/{tag}/samples", la.sample(4, generator=torch.Generator().manual_seed(1)))
        res.put(f"shard/{tag}/probit", la(X2[:5], link_approx="probit"))
        res.put(f"shard/{tag}/lml", la.log_marginal_likelihood())
        res.put(f"shard/{tag}/square_norm", la.square_norm(la.mean + 0.1))
    la.optimize_prior_precision(n_steps=5)
    res.put("shard/sharded/tuned_prior", la.prior_precision)
    # P = 122 (the 3-20-2 MLP): no mesh over 3 ranks takes 2 and warns; a
    # mesh axis of 3 raises
    full = FullLaplace(mlp, "classification", device="cpu")
    full.fit(loader)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        full.shard_posterior()
    res.put("shard/p122/warned", [str(w.message) for w in caught] or [""])
    res.put("shard/p122/is_dtensor", hasattr(full.H, "device_mesh"))
    res.put("shard/p122/logdet", full.log_det_posterior_precision)
    try:
        bad = FullLaplace(mlp, "classification", device="cpu")
        bad.fit(loader)
        bad.shard_posterior(data_mesh(axis_name="model"))
        res.put("shard/p122/mesh_raised", "")
    except ValueError as e:
        res.put("shard/p122/mesh_raised", str(e))

    res.put("world", world)
    np.savez(out_path, **res)
    dist.barrier()
    dist.destroy_process_group()
    print(f"WORKER_OK rank={rank}", flush=True)


if __name__ == "__main__":
    main()
