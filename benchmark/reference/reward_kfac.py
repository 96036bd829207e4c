"""Exact-Fisher KFAC factors of a reward model over preference pairs, in
plain PyTorch, with the routing of its expert layers held to the program's
only where float rounding can decide it.

A pair's two rewards are its logits, so the likelihood is the 2-way
cross-entropy (Bradley-Terry), and its C = 2 square-root-Hessian columns
are swept back through one forward, block by block of pairs. The port's
conventions (`laplace_jax_torch/curvature/kfac.py`):

- a projection's ``A = sum a a^T / (N P)``, P the positions per pair of
  the tokens it reads (2T; 2 for the head on the last tokens), and for a
  routed expert's projection the positions of the batch its rows came
  from, the sum over its routed rows only;
- ``B = sum_c sum g g^T`` over the rows of its output;
- an RMSNorm scale's block ``sum_c sum_n u u^T``, u the pair's gradient:
  the sum over its positions of ``g * x_hat``.

Routing (`Router`): each token takes the top k of its own scores (kept in
`chosen` where there is no program to follow: the control's), unless
the gap between its k-th and (k+1)-th router logits is below `band`, where
float32 rounding in the program can swap them: there it takes the
program's choice. Outside the band a program choice that differs from the
reference's is counted (`mismatches`), as is every token in the band
(`near_ties`).
"""

from __future__ import annotations

import torch


class Recorder:
    """What one block's forward recorded: projections (input, output,
    positions) and norms (x_hat, output), by name."""

    def __init__(self):
        self.lin, self.nrm = {}, {}

    def linear(self, name, x, out, positions):
        self.lin[name] = (x, out, positions)

    def norm(self, name, xhat, out):
        self.nrm[name] = (xhat, out)


class Router:
    """Top-k routing for the reference (module docstring). `program` holds,
    per MoE layer, the program's (tokens, k) choices of the current block,
    or None to route by the reference's scores alone."""

    def __init__(self, k: int, band: float):
        self.k, self.band = k, band
        self.program = None
        self.chosen: dict = {}  # MoE layer -> the choices made, block by block
        self.near_ties = self.mismatches = self.tokens = 0

    def __call__(self, layer: int, logits: torch.Tensor) -> torch.Tensor:
        top = torch.topk(logits, self.k + 1, dim=-1, sorted=True)
        own = top.indices[:, :self.k]
        if self.program is None:
            self.chosen.setdefault(layer, []).append(own)
            return own
        prog = self.program[layer].to(own.device)
        tie = (top.values[:, self.k - 1] - top.values[:, self.k]) < self.band
        differ = (own.sort(-1).values != prog.sort(-1).values).any(-1)
        self.tokens += own.shape[0]
        self.near_ties += int(tie.sum())
        self.mismatches += int((differ & ~tie).sum())
        return torch.where(tie[:, None], prog, own)


def sqrt_hessian_columns(f: torch.Tensor) -> torch.Tensor:
    p = torch.softmax(f, dim=-1)
    eye = torch.eye(f.shape[1], dtype=f.dtype, device=f.device)
    return p.T.sqrt()[:, :, None] * (eye[:, None, :] - p[None])


def kfac_factors(forward, weights: dict, config: dict, ids: torch.Tensor, y: torch.Tensor,
                 block: int, router: Router, routing=None):
    """({parameter name: factors}, summed loss) over the pairs `ids` (N, 2,
    T) with labels y, in blocks of `block` pairs. `routing`: the program's
    choices per MoE layer over all N * 2T tokens, in pair order, or None.
    The weights' dtype and device are the computation's; the frozen
    embedding takes no factors."""
    dev, dtype = next(iter(weights.values())).device, next(iter(weights.values())).dtype
    frozen = set(config.get("frozen", ()))
    w = {k: v.detach().requires_grad_(k not in frozen) for k, v in weights.items()}
    N, tokens = ids.shape[0], ids.shape[1] * ids.shape[2]
    A, B, loss = {}, {}, torch.zeros((), dtype=dtype, device=dev)
    for start in range(0, N, block):
        x = ids[start:start + block].to(dev)
        yb = y[start:start + block].to(dev)
        n = x.shape[0]
        if routing is not None:
            router.program = [r[start * tokens:(start + n) * tokens] for r in routing]
        rec = Recorder()
        with torch.enable_grad():
            f = forward(w, x, config, rec, router)
            S = sqrt_hessian_columns(f.detach())
            lin, nrm = list(rec.lin), list(rec.nrm)
            outs = [rec.lin[k][1] for k in lin] + [rec.nrm[k][1] for k in nrm]
            for c in range(S.shape[0]):
                gs = torch.autograd.grad(f, outs, grad_outputs=S[c],
                                         retain_graph=c < S.shape[0] - 1)
                for name, g in zip(lin, gs):
                    r = g.reshape(-1, g.shape[-1])
                    B[name] = B.get(name, 0.0) + r.T @ r
                for name, g in zip(nrm, gs[len(lin):]):
                    u = (g * rec.nrm[name][0].detach()).reshape(n, -1, g.shape[-1]).sum(1)
                    B[name] = B.get(name, 0.0) + u.T @ u
        for name in lin:
            a, _, positions = rec.lin[name]
            a = a.detach().reshape(-1, a.shape[-1])
            P = positions if positions is not None else a.shape[0] // n
            A[name] = A.get(name, 0.0) + a.T @ a / (N * P)
        loss = loss + torch.nn.functional.cross_entropy(f.detach(), yb, reduction="sum")
        del rec, f, outs, gs
    router.program = None
    groups = {f"{k}.weight": (A[k], B[k]) for k in A}
    groups.update({f"{k}.scale": (B[k],) for k in B if k not in A})
    return groups, loss
