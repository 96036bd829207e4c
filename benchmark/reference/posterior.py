"""The Laplace posterior from KFAC groups, in plain PyTorch.

A group is `(A, B)` (a kernel, precision block ``A kron B``) or `(F,)` (a
bias). With a scalar prior precision delta, the posterior precision of a
group is ``f H + delta I`` (f = 1 for a classifier), so its log determinant
is the sum of ``log(lambda_A,i lambda_B,j + delta)`` over the factors'
eigenvalues (clipped at 0, as a PSD factor's are).

The log marginal likelihood (Immer et al. 2021; Daxberger et al. 2021):

    log p(D) ~ -loss - 1/2 (log det P - P_n log delta + delta |theta|^2)

with `loss` the summed cross-entropy at the weights theta (the MAP, the
prior mean 0) and P_n the number of weights in the posterior.
"""

from __future__ import annotations

import math

import torch


def eigvals(groups: dict) -> dict:
    """{name: tuple of ascending eigenvalues, clipped at 0}, one per factor."""
    return {k: tuple(torch.linalg.eigvalsh(F).clamp(min=0.0) for F in fs)
            for k, fs in groups.items()}


def logdet_posterior(eigs: dict, delta) -> torch.Tensor:
    total = 0.0
    for ls in eigs.values():
        lam = ls[0] if len(ls) == 1 else torch.outer(ls[0], ls[1]).reshape(-1)
        total = total + torch.log(lam + delta).sum()
    return total


def n_weights(eigs: dict) -> int:
    return sum(math.prod(l.shape[0] for l in ls) for ls in eigs.values())


def log_marglik(loss, eigs: dict, theta_sq, delta) -> torch.Tensor:
    P = n_weights(eigs)
    delta = torch.as_tensor(delta, dtype=loss.dtype, device=loss.device)
    return -loss - 0.5 * (logdet_posterior(eigs, delta) - P * torch.log(delta)
                          + delta * theta_sq)


def tune_prior(loss, eigs: dict, theta_sq, n_steps: int, lr: float, init: float = 1.0):
    """The scalar prior precision after `n_steps` Adam steps (lr `lr`) on
    log delta, from `init`, minimizing the negative log marginal
    likelihood."""
    log_delta = torch.tensor(math.log(init), dtype=loss.dtype, device=loss.device,
                             requires_grad=True)
    opt = torch.optim.Adam([log_delta], lr=lr)
    for _ in range(n_steps):
        opt.zero_grad()
        neg = -log_marglik(loss, eigs, theta_sq, log_delta.exp())
        neg.backward()
        opt.step()
    return log_delta.detach().exp()


def ll_covariance(eig: dict, head: str, delta, dtype) -> torch.Tensor:
    """The dense posterior covariance of a dense head from its groups'
    eigenpairs `eig` (`{name: ((l, Q) per factor)}`), in `dtype`: the bias
    block ``Q diag(1 / (l + delta)) Q^T`` first, then the kernel's,
    input-major (index i * C + o), with ``Q = Q_A kron Q_B`` and the
    eigenvalues ``l_A,i l_B,j``."""
    blocks = []
    for name in (f"{head}.bias", f"{head}.weight"):
        if name not in eig:
            continue
        ls = [l.to(dtype) for l, _ in eig[name]]
        Qs = [Q.to(dtype) for _, Q in eig[name]]
        if len(Qs) == 2:
            lam, Q = torch.outer(ls[0], ls[1]).reshape(-1), torch.kron(Qs[0], Qs[1])
        else:
            lam, Q = ls[0], Qs[0]
        blocks.append((Q / (lam + delta)) @ Q.T)
    return torch.block_diag(*blocks)


def lift_null(eig: dict, head: str, rel: float) -> dict:
    """`eig` with the smallest eigenvalue of B, the last factor of each of
    the head's groups, raised to `rel` times B's largest. B = sum diag(p) -
    p p^T is singular (its rows sum to zero), so that eigenvalue is 0 in
    exact arithmetic; a float32 B's comes out anywhere within about the
    dtype's machine epsilon times B's largest."""
    out = dict(eig)
    for name in (f"{head}.bias", f"{head}.weight"):
        if name in eig:
            *rest, (l, Q) = eig[name]
            l = l.clone()
            l[0] = rel * l[-1]
            out[name] = (*rest, (l, Q))
    return out


def ll_jacobians(phi: torch.Tensor, C: int, bias: bool) -> torch.Tensor:
    """(B, C, P) Jacobians of a dense head's logits in its weights: the
    bias block I_C, then the kernel block phi kron I_C."""
    eye = torch.eye(C, dtype=phi.dtype, device=phi.device)
    J = torch.einsum("bi,co->bcio", phi, eye).reshape(phi.shape[0], C, -1)
    if bias:
        J = torch.cat([eye.expand(phi.shape[0], C, C), J], dim=2)
    return J


def probit(f: torch.Tensor, f_var_diag: torch.Tensor) -> torch.Tensor:
    """The probit approximation to E[softmax(f)] under N(f, var):
    softmax(f / sqrt(1 + pi/8 var)) (MacKay 1992)."""
    return torch.softmax(f / torch.sqrt(1.0 + math.pi / 8 * f_var_diag), dim=-1)


def ll_probit(f: torch.Tensor, phi: torch.Tensor, Sigma: torch.Tensor, bias: bool):
    """Probit class probabilities of a dense head's GLM predictive with the
    dense posterior covariance Sigma."""
    J = ll_jacobians(phi, f.shape[1], bias)
    f_var = torch.einsum("bcp,pq,bcq->bc", J, Sigma, J)
    return probit(f, f_var)
