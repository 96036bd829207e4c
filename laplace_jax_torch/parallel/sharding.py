"""Data-parallel curvature accumulation over `torch.distributed` (port of
`laplace_jax/parallel/sharding.py`).

The fit loop's per-batch curvature is a sum over data points for every
structure the port fits (GGN, EF, MC, the KFAC factors, diag, full) and so
is the loss. So each rank of a process group computes the curvature of its
own rows of the batch and one `all_reduce(SUM)` of `(loss, H)` stands in
for the JAX package's `psum`. The JAX package runs one process over many
devices; PyTorch's idiom is one process per device, so:

- a `DeviceMesh` with named dims stands in for `jax.sharding.Mesh`
  (`data_mesh`, `multihost_mesh`);
- every rank's loader yields the same global batch and each rank takes its
  own contiguous row block (the contract of the JAX package's `_local_rows`);
- `shard_closure` (the default mode) allows uneven batches
  (`torch.tensor_split`) and runs a batch smaller than the group whole on
  every rank; `shard_map_closure` (`explicit=True`) requires the batch to
  divide and gives each rank its own draws, the counterpart of
  `fold_in(axis_index)`;
- `DataParallel.shard_batch` runs a predictive over each rank's rows and
  `all_gather`s the output to every rank;
- `FullLaplace.shard_posterior` lays H out row-wise as a DTensor
  (`Shard(0)`), the counterpart of a `NamedSharding`.

Collectives take the tensors as they are, in their dtype and on their
device: gloo reduces CPU (and CUDA) tensors, NCCL CUDA tensors.
"""

from __future__ import annotations

import logging
import os
import socket
from typing import Callable, Mapping

import torch
import torch.distributed as dist

from laplace_jax_torch.nnmodel import batch_slice
from laplace_jax_torch.utils.matrix import Kron

__all__ = [
    "data_mesh",
    "multihost_mesh",
    "DataParallel",
    "shard_closure",
    "shard_map_closure",
]


def _device_type() -> str:
    return "cuda" if torch.cuda.is_available() else "cpu"


def ensure_group() -> int:
    """Bring the default process group up if it is not, and return the world
    size: from the `torchrun` environment when it is set (NCCL with a card,
    else gloo), else as a world of this one process with its rendezvous in
    memory."""
    if not dist.is_initialized():
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            if torch.cuda.is_available() and "LOCAL_RANK" in os.environ:
                torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
            dist.init_process_group(backend)
        else:
            dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0)
    return dist.get_world_size()


def data_mesh(devices=None, axis_name: str = "data"):
    """A 1-D `DeviceMesh` over the world, or over the global ranks in
    `devices`, each rank on its own device (CUDA when the process has a
    card). Every rank of the world calls it."""
    from torch.distributed.device_mesh import DeviceMesh

    world = ensure_group()
    ranks = list(range(world)) if devices is None else [int(r) for r in devices]
    return DeviceMesh(_device_type(), ranks, mesh_dim_names=(axis_name,))


def _host_name() -> str:
    return socket.gethostname()


def multihost_mesh(dcn_axis: str = "replica", ici_axis: str = "data",
                   coordinator_address: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None):
    """A 2-D `DeviceMesh`, hosts x ranks per host: the slow axis across
    hosts, the fast one within a host. With `coordinator_address`
    ("host:port") or more than one process, the default group is brought
    up over TCP at that address; otherwise as `ensure_group` does. With
    one host (one process, say) the mesh is (1, world). Hosts must hold the
    same number of ranks, in contiguous rank order: row blocks of a batch
    then stay host-contiguous."""
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized() and (coordinator_address is not None
                                      or (num_processes or 1) > 1):
        dist.init_process_group("nccl" if torch.cuda.is_available() else "gloo",
                                init_method=f"tcp://{coordinator_address}",
                                world_size=num_processes, rank=process_id)
    world = ensure_group()
    hosts = [None] * world
    dist.all_gather_object(hosts, _host_name())
    names = list(dict.fromkeys(hosts))
    counts = [hosts.count(h) for h in names]
    if len(set(counts)) != 1:
        raise ValueError(
            f"Non-uniform hosts: {world} ranks across {len(names)} hosts ({counts}); a "
            "(DCN, ICI) mesh needs the same rank count per host.")
    grid = [[r for r in range(world) if hosts[r] == h] for h in names]
    if sum(grid, []) != list(range(world)):
        raise ValueError("Ranks are not host-contiguous; cannot build a host-aligned "
                         "(DCN, ICI) mesh.")
    return DeviceMesh(_device_type(), grid, mesh_dim_names=(dcn_axis, ici_axis))


def _axis_tuple(axis_name) -> tuple:
    return tuple(axis_name) if isinstance(axis_name, (tuple, list)) else (axis_name,)


def _leading_dim(x) -> int:
    if isinstance(x, Mapping):
        return next(v for v in x.values() if torch.is_tensor(v)).shape[0]
    return x.shape[0]


class _Shards:
    """The process group over a mesh's batch axes, its size and this rank's
    place in it: one dim's group, or the whole world for a tuple of every
    dim of a mesh over the world."""

    def __init__(self, mesh, axis_name):
        axes = _axis_tuple(axis_name)
        if len(axes) == 1:
            group = mesh.get_group(axes[0])
        elif sorted(axes) == sorted(mesh.mesh_dim_names) and mesh.size() == dist.get_world_size():
            group = dist.group.WORLD
        else:
            raise ValueError(f"axis_name {axis_name!r}: name one dim of the mesh, or all of "
                             "the dims of a mesh over the whole world.")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def rows(self, bsz: int) -> slice:
        """This rank's block of `bsz` rows, as `torch.tensor_split` cuts
        them (the first `bsz % size` blocks one row longer)."""
        per, extra = divmod(bsz, self.size)
        start = self.rank * per + min(self.rank, extra)
        return slice(start, start + per + (self.rank < extra))


def _leaves(tree) -> list:
    if torch.is_tensor(tree):
        return [tree]
    if isinstance(tree, Kron):
        return [H for F in tree.kfacs for H in F]
    if isinstance(tree, (tuple, list)):
        return [t for part in tree for t in _leaves(part)]
    raise TypeError(f"Cannot reduce a {type(tree).__name__}.")


def _rebuild(tree, it):
    if torch.is_tensor(tree):
        return next(it)
    if isinstance(tree, Kron):
        return Kron([tuple(next(it) for _ in F) for F in tree.kfacs])
    return type(tree)(_rebuild(part, it) for part in tree)


def _packed(tree, collective: Callable):
    """`tree` (a tensor, a `Kron`, or tuples and lists of them) through
    `collective`, one call per (dtype, device) of its leaves, packed flat.
    The results carry no autograd graph."""
    leaves = _leaves(tree)
    out = list(leaves)
    by_kind: dict = {}
    for i, t in enumerate(leaves):
        by_kind.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_kind.values():
        flat = torch.cat([leaves[i].detach().reshape(-1) for i in idx])
        collective(flat)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return _rebuild(tree, iter(out))


def all_reduce_tree(tree, group=None):
    """`tree` summed over `group` (`_packed`)."""
    return _packed(tree, lambda flat: dist.all_reduce(flat, group=group))


def broadcast_tree(tree, group=None):
    """`tree` as the first rank of `group` holds it, on every rank of
    `group` (`_packed`)."""
    src = 0 if group is None else dist.get_global_rank(group, 0)
    return _packed(tree, lambda flat: dist.broadcast(flat, src, group=group))


def _all_gather_rows(out, group, size: int):
    """Each tensor of `out` (or `out` itself) gathered over `group` and
    concatenated along its leading dim, in group-rank order."""
    if isinstance(out, (tuple, list)):
        return type(out)(_all_gather_rows(o, group, size) for o in out)
    parts = [torch.empty_like(out) for _ in range(size)]
    dist.all_gather(parts, out.contiguous(), group=group)
    return torch.cat(parts)


def draw_seed(generator: torch.Generator) -> int:
    """One 63-bit seed drawn from `generator` (it advances the same on every
    rank)."""
    return int(torch.randint(0, 2**63 - 1, (1,), generator=generator,
                             device=generator.device))


def rank_generator(seed: int, rank: int, device) -> torch.Generator:
    """A generator for `rank` from a shared `seed`: distinct ranks draw
    distinct streams (the counterpart of `fold_in(key, axis_index)`)."""
    folded = (seed + rank * 0x9E3779B97F4A7C15) % 2**63
    return torch.Generator(device=device).manual_seed(folded)


def _sharded(closure: Callable, shards: _Shards, explicit: bool) -> Callable:
    n = shards.size

    def call(x, y, N, generator=None):
        if n == 1:
            return closure(x, y, N, generator)
        bsz = _leading_dim(x)
        if explicit:
            if bsz % n:
                raise ValueError(f"Batch size {bsz} not divisible by mesh size {n}; use "
                                 "shard_closure (the default mode) for uneven batches.")
            if generator is not None:
                generator = rank_generator(draw_seed(generator), shards.rank, generator.device)
        elif bsz < n:  # a batch smaller than the group runs whole on every rank
            return closure(x, y, N, generator)
        sl = shards.rows(bsz)
        return all_reduce_tree(closure(batch_slice(x, sl), y[sl], N, generator), shards.group)

    return call


def shard_closure(closure: Callable, mesh, axis_name="data") -> Callable:
    """A per-batch curvature closure `(x, y, N, generator) -> (loss, H)` over
    `mesh`'s `axis_name` (one dim, or a tuple of dims taken jointly): each
    rank runs it on its row block of the global batch (`tensor_split`,
    uneven allowed) and the results are summed over the group, so every
    rank holds the whole batch's `(loss, H)`. A batch smaller than the group
    runs whole on every rank. Each rank draws from the caller's generator
    (one program over the global batch with one key, in the JAX package);
    on an uneven batch the ranks' generators then drift apart."""
    return _sharded(closure, _Shards(mesh, axis_name), explicit=False)


def shard_map_closure(closure: Callable, mesh, axis_name="data", model=None) -> Callable:
    """The explicit mode: as `shard_closure`, but the batch must divide the
    group (`ValueError` otherwise), and each rank draws from its own
    generator, seeded from one draw of the caller's generator folded with
    its rank, so MC draws differ across ranks. `model` is accepted for the
    JAX package's signature."""
    return _sharded(closure, _Shards(mesh, axis_name), explicit=True)


def shard_rows(H: torch.Tensor, mesh, axis_name: str):
    """`H`, present whole on every rank, as a DTensor split by rows over
    `mesh`'s `axis_name` (`Shard(0)`; replicated over any other dim), built
    from this rank's rows without communication; `H` itself on a rank
    outside the mesh."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    coord = mesh.get_coordinate()
    if coord is None:
        return H
    dim = mesh.mesh_dim_names.index(axis_name)
    local = H.chunk(mesh.size(dim))[coord[dim]]
    placements = [Shard(0) if d == dim else Replicate() for d in range(mesh.ndim)]
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=H.shape,
                              stride=H.stride())


def full_tensor(t):
    """A DTensor gathered into a plain tensor, one `all_gather` over each
    mesh dim it is sharded on (a collective every rank of the mesh joins;
    c10d's own collectives, which gloo also runs on CUDA tensors); anything
    else as it is. Evenly sharded tensors only, as `shard_rows` makes."""
    if not hasattr(t, "device_mesh"):
        return t
    out, mesh = t.to_local(), t.device_mesh
    for d, p in enumerate(t.placements):
        if p.is_shard():
            group = mesh.get_group(d)
            parts = [torch.empty_like(out) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, out.contiguous(), group=group)
            out = torch.cat(parts, dim=p.dim)
    return out


class DataParallel:
    """Data-parallel configuration for a Laplace flavor: pass `parallel=dp`
    to its constructor (or through `Laplace(...)`).

    `mesh` defaults to `data_mesh(axis_name=axis_name)`; `axis_name` may be a
    tuple of the mesh's dims, which then split the batch jointly, e.g.
    `DataParallel(multihost_mesh(), axis_name=("replica", "data"))`; a tuple
    needs a mesh. `explicit` selects `shard_map_closure`. Every rank builds
    it and runs the same fits and predictives on the same data."""

    def __init__(self, mesh=None, axis_name="data", explicit: bool = False):
        if mesh is None:
            if isinstance(axis_name, (tuple, list)):
                raise ValueError("Multi-axis DataParallel needs an explicit mesh (e.g. "
                                 "multihost_mesh()).")
            mesh = data_mesh(axis_name=axis_name)
        self.mesh = mesh
        self.axis_name = axis_name
        self.explicit = explicit
        self._shards = _Shards(mesh, axis_name)

    @property
    def size(self) -> int:
        """Ranks over the batch axes."""
        return self._shards.size

    def wrap(self, closure: Callable, model=None) -> Callable:
        """`closure` `(x, y, N, generator) -> (loss, H)` over the batch axes,
        as `shard_map_closure` (explicit) or `shard_closure` makes it;
        `model` is accepted for the JAX package's signature."""
        return _sharded(closure, self._shards, self.explicit)

    def rows(self, bsz: int) -> slice:
        """This rank's row block of a batch of `bsz` rows."""
        return self._shards.rows(bsz)

    def all_reduce(self, tree):
        """`tree` summed over the batch axes (`all_reduce_tree`)."""
        if self._shards.size == 1:
            return tree
        return all_reduce_tree(tree, self._shards.group)

    def broadcast(self, tree):
        """`tree` as the first rank over the batch axes holds it, on every
        rank (`broadcast_tree`)."""
        if self._shards.size == 1:
            return tree
        return broadcast_tree(tree, self._shards.group)

    def shard_batch(self, x, fn: Callable):
        """`fn(x)` computed data-parallel: each rank runs `fn` on its rows of
        `x` and `all_gather` returns the whole output (a tensor, or a tuple
        of tensors, each with the batch leading) on every rank. A batch size
        that the group does not divide runs whole on every rank (the JAX
        package's `shard_batch` leaves such a batch unsharded too)."""
        n, bsz = self._shards.size, _leading_dim(x)
        if n == 1:
            return fn(x)
        if bsz % n:
            logging.debug("DataParallel.shard_batch: batch size %d not divisible by mesh "
                          "size %d; running this batch unsharded.", bsz, n)
            return fn(x)
        return _all_gather_rows(fn(batch_slice(x, self._shards.rows(bsz))),
                                self._shards.group, n)
