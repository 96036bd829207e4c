"""Matrix-free Lanczos eigendecomposition of the dataset curvature (port of
`laplace_jax/curvature/lanczos.py`).

The top-k eigenpairs of the total curvature Σ_batches H_b (the exact
Hessian or the GGN, after the backend's `curv_type`) come from m =
min(max(4k + 16, k + 2), P) Lanczos steps, never forming the P x P matrix:

- the loader is read once, its batches moved to the device (as the JAX
  package stacks or lists them there); each matrix-vector product is a loop
  over those batches, every batch's product by `torch.func`
  (`batch_hvp_fn`);
- each step reorthogonalizes once against the whole basis, `w -= V (Vᵀ w)`,
  as the JAX package does (in float32 the basis still loses orthogonality
  at large P; callers measure it);
- under a `DataParallel` (`parallel=`), each rank keeps its row block of
  every batch (`tensor_split`); each matvec and the loss sum those rows and
  are summed over the ranks (`all_reduce`), so every rank runs the same
  iteration on the same numbers, from the same start vector to T's `eigh`
  (the JAX package's `lanczos.py:115-150` shards the batch axis);
- the iteration stops at breakdown (β < 1e-12); the tridiagonal T goes to
  the host in float64, and of its `eigh` the top k eigenvalues above 1e-6
  are kept, with their Ritz vectors.

The basis V holds P x m numbers of the parameters' dtype: 0.94 GB at P =
4.2 M, m = 56, in float32. The start vector is a standard normal draw from
a `torch.Generator` (seeded 0 by default), normalized (`start_vector`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import grad, jvp, vjp

from laplace_jax_torch.enums import Likelihood
from laplace_jax_torch.nnmodel import batch_slice
from laplace_jax_torch.utils.device import to_device

__all__ = ["lanczos_eig_curvature", "batch_hvp_fn", "curvature_matvec", "start_vector"]


def batch_hvp_fn(backend):
    """`hvp(theta, v, x, y)`: one batch's curvature times `v` at the flat
    vector `theta`.

    - "hessian": the Hessian of the summed loss times v, forward over
      reverse (`torch.func.jvp` of `torch.func.grad`);
    - "ggn": Jᵀ Λ J v, a jvp through the network, the softmax's Λ (I for
      regression), then a vjp.
    """
    model, lossfunc = backend.model, backend.lossfunc
    if backend.curv_type == "ef":
        raise ValueError("Low-rank eigendecomposition supports 'hessian' and 'ggn' "
                         "curvature, not 'ef'.")
    if backend.curv_type == "hessian":

        def hvp(theta, v, x, y):
            def total_loss(t):
                return lossfunc(model.apply_vec(t, x), y)

            return jvp(grad(total_loss), (theta,), (v,))[1]

        return hvp

    def ggn_vp(theta, v, x, y):
        def f_fn(t):
            return model.apply_vec(t, x)

        f, Jv = jvp(f_fn, (theta,), (v,))
        if backend.likelihood == Likelihood.REGRESSION:
            lam_Jv = Jv
        else:
            p = torch.softmax(f, dim=-1)
            lam_Jv = p * Jv - p * (p * Jv).sum(-1, keepdim=True)
        return vjp(f_fn, theta)[1](lam_Jv)[0]

    return ggn_vp


def curvature_matvec(backend, batches, parallel=None):
    """`v -> Σ_batches H_b v` at the MAP, over `(x, y)` batches on the
    parameters' device, summed over `parallel`'s ranks when given."""
    hvp = batch_hvp_fn(backend)
    theta = backend.model.mean_vector

    def matvec(v):
        out = torch.zeros_like(v)
        for x, y in batches:
            out += hvp(theta, v, x, y)
        return out if parallel is None else parallel.all_reduce(out)

    return matvec


def start_vector(P: int, dtype, device, generator: torch.Generator | None) -> torch.Tensor:
    """The normalized standard normal start vector (P,), drawn from
    `generator` (a fresh one seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    v0 = torch.randn(P, generator=generator, dtype=dtype, device=device)
    return v0 / torch.linalg.norm(v0)


def _rank_rows(batches, parallel):
    """This rank's row block of each batch; batches it has no rows of are
    left out."""
    out = []
    for x, y in batches:
        sl = parallel.rows(y.shape[0])
        if sl.stop > sl.start:
            out.append((batch_slice(x, sl), y[sl]))
    return out


@torch.no_grad()
def lanczos_eig_curvature(backend, loader, low_rank: int = 10,
                          generator: torch.Generator | None = None, unpack=None,
                          parallel=None):
    """(eigenvectors (P, k'), eigenvalues (k',), loss): the top `low_rank`
    eigenpairs of Σ_batches curvature with eigenvalues above 1e-6, and the
    total loss times `backend.factor` (the JAX package's
    `lanczos_eig_curvature`). `loader` yields `(x, y)` batches, or batches
    `unpack` makes into them; it is iterated once, each batch moved to the
    parameters' device and dtype. The transforms differentiate under
    `no_grad`; nothing else records a graph."""
    model = backend.model
    theta = model.mean_vector
    P, dtype, device = theta.shape[0], theta.dtype, theta.device
    unpack = unpack or (lambda data: data)
    batches = [tuple(to_device(a, device, dtype) for a in unpack(data)) for data in loader]
    if parallel is not None and parallel.size > 1:
        batches = _rank_rows(batches, parallel)
    else:
        parallel = None
    matvec = curvature_matvec(backend, batches, parallel)

    m = int(min(max(4 * low_rank + 16, low_rank + 2), P))
    V = torch.zeros(P, m, dtype=dtype, device=device)
    alphas, betas = [], []
    v = start_vector(P, dtype, device, generator)
    v_prev, beta = torch.zeros_like(v), 0.0
    for j in range(m):
        w = matvec(v) - beta * v_prev
        alpha = torch.dot(w, v)
        w -= alpha * v
        V[:, j] = v
        Vj = V[:, : j + 1]
        w -= Vj @ (Vj.T @ w)  # one full reorthogonalization
        beta = torch.linalg.norm(w)
        alphas.append(float(alpha))
        betas.append(float(beta))
        if betas[-1] < 1e-12:  # an invariant subspace: breakdown
            break
        v_prev, v = v, w / beta
    k = len(alphas)
    T = np.diag(alphas) + np.diag(betas[: k - 1], 1) + np.diag(betas[: k - 1], -1)
    evals, evecs = np.linalg.eigh(T)
    order = np.argsort(evals)[::-1][:low_rank]
    evals, evecs = evals[order], evecs[:, order]
    keep = evals > 1e-6
    ritz = V[:, :k] @ torch.as_tensor(evecs[:, keep], dtype=dtype, device=device)
    loss = sum((backend.lossfunc(model.apply(x), y) for x, y in batches),
               torch.zeros((), dtype=dtype, device=device))
    if parallel is not None:
        loss = parallel.all_reduce(loss)
    return ritz, torch.as_tensor(evals[keep], dtype=dtype, device=device), backend.factor * loss
