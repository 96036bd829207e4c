"""Exact-Fisher KFAC factors of a classifier, in plain PyTorch.

Adapted from the plain fit that `bench_torch_baseline.py` (`kfac_fit`)
runs, with its patch order and scaling fixed to the port's conventions:

- activation factor ``A = (1 / (N T)) sum_{n,t} a a^T``, T the output
  positions of a conv (1 for a dense layer on a (batch, features) input);
  a conv's patch rows are ordered (kh, kw, c_in), the flax kernel flatten;
- gradient factor ``B = sum_c sum_{n,t} g g^T`` over the C square-root
  Hessian columns of the summed cross-entropy, ``s_c = sqrt(p_c) (e_c -
  p)``, g the cotangent at the layer's output;
- a kernel is the group (A, B), input-major; a bias the group (B,).

The C sweeps are C backward passes through one forward; everything runs in
the dtype of the weights given.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmark.reference.layers import Ops


def sqrt_hessian_columns(f: torch.Tensor) -> torch.Tensor:
    """(C, B, C): column c is sqrt(p_c) (e_c - p) for each row of logits f,
    so that sum_c s_c s_c^T = diag(p) - p p^T."""
    p = torch.softmax(f, dim=-1)
    eye = torch.eye(f.shape[1], dtype=f.dtype, device=f.device)
    return p.T.sqrt()[:, :, None] * (eye[:, None, :] - p[None])


def cross_entropy_sum(f: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(f, y, reduction="sum")


def conv_patches(xp: torch.Tensor, k: int, stride: int) -> torch.Tensor:
    """Rows (B * T, k * k * c_in) of a padded conv input, each in (kh, kw,
    c_in) order. `F.unfold` gives (c_in, kh, kw); the reorder is the
    flatten of a flax conv kernel (kh, kw, in, out)."""
    u = F.unfold(xp, k, stride=stride)  # (B, c_in * k * k, T)
    B, D, T = u.shape
    c_in = D // (k * k)
    return u.reshape(B, c_in, k * k, T).permute(0, 3, 2, 1).reshape(B * T, k * k * c_in)


def kfac_factors(forward, weights: dict, layers: list, X: torch.Tensor, y: torch.Tensor,
                 batch_size: int):
    """The factors of every conv and dense layer over the inputs X (N, ...)
    with labels y, in batches of `batch_size`, and the summed
    cross-entropy. Returns ({layer: {"A": A, "B": B}}, loss). The weights'
    dtype and device are the computation's."""
    ref = next(iter(weights.values()))
    w = {k: v.detach().clone().requires_grad_(v.is_floating_point()) for k, v in weights.items()}
    tapped = [e for e in layers if e["kind"] in ("conv", "dense")]
    N = X.shape[0]
    A = {e["name"]: 0.0 for e in tapped}
    Bf = {e["name"]: 0.0 for e in tapped}
    loss = torch.zeros((), dtype=ref.dtype, device=ref.device)
    for start in range(0, N, batch_size):
        x = X[start:start + batch_size].to(ref.device, ref.dtype)
        yb = y[start:start + batch_size].to(ref.device)
        ops = Ops(w, layers, record=True)
        with torch.enable_grad():
            f, _ = forward(ops, x)
            S = sqrt_hessian_columns(f.detach())
            outs = [ops.taps[e["name"]][1] for e in tapped]
            C = f.shape[1]
            for c in range(C):
                grads = torch.autograd.grad(f, outs, grad_outputs=S[c], retain_graph=c < C - 1)
                for e, g in zip(tapped, grads):
                    rows = g.movedim(1, -1).reshape(-1, g.shape[1])
                    Bf[e["name"]] = Bf[e["name"]] + rows.T @ rows
        loss = loss + cross_entropy_sum(f.detach(), yb)
        for e in tapped:
            inp = ops.taps[e["name"]][0].detach()
            if e["kind"] == "conv":
                rows = conv_patches(inp, e["k"], e["stride"])
                T = rows.shape[0] // inp.shape[0]
            else:
                rows, T = inp.reshape(-1, inp.shape[-1]), 1
            A[e["name"]] = A[e["name"]] + rows.T @ rows / (N * T)
    return {e["name"]: {"A": A[e["name"]], "B": Bf[e["name"]]} for e in tapped}, loss


def groups(factors: dict, layers: list) -> dict:
    """{parameter name: its factors}: a kernel `(A, B)`, a bias `(B,)`."""
    out = {}
    for e in layers:
        if e["name"] not in factors:
            continue
        fac = factors[e["name"]]
        out[f"{e['name']}.weight"] = (fac["A"], fac["B"])
        if e.get("bias"):
            out[f"{e['name']}.bias"] = (fac["B"],)
    return out


def last_layer_factors(phi: torch.Tensor, f: torch.Tensor) -> dict:
    """The dense head's factors from its features phi (N, d) and logits f
    (N, C): A = phi^T phi / N and B = sum_n diag(p_n) - p_n p_n^T."""
    p = torch.softmax(f, dim=-1)
    B = torch.diag(p.sum(0)) - p.T @ p
    return {"A": phi.T @ phi / phi.shape[0], "B": B}

