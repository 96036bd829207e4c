"""Laplace on a transformer with dict-shaped (HF-style) inputs.

The PyTorch counterpart of `examples/huggingface_example.py`: a small
transformer encoder takes `{"input_ids", "attention_mask"}` dicts; the
Laplace classes take dict batches through `dict_key_x` / `dict_key_y`.
Last-layer full Laplace (the head found on its own) with a marglik-tuned
prior, a subnetwork Laplace over one module, and an all-weights diagonal
Laplace whose embedding and attention projections get exact tap diagonals.
No pretrained download.

Run: python examples_torch/huggingface_example.py [--device cpu]
(on the CUDA card by default; without one, pass `--device cpu`).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch import Laplace
from laplace_jax_torch.models.flax_layers import Embed, MultiHeadDotProductAttention, init_dense
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.device import resolve_device
from laplace_jax_torch.utils.subnetmask import ModuleNameSubnetMask


class TinyTransformerClassifier(nn.Module):
    """The example's flax model, with flax's module names (so the flat
    parameter order and `state_dict_from_flax` match): `Embed_0`, a masked
    4-head self-attention, a residual gelu MLP (`Dense_1` widens to 2 dim,
    its first half goes through gelu into `Dense_0`), a mean over the valid
    tokens, and the `Dense_2` head."""

    def __init__(self, vocab=128, dim=32, num_classes=2, generator=None):
        super().__init__()
        self.dim = dim
        self.Embed_0 = Embed(vocab, dim, generator)
        self.MultiHeadDotProductAttention_0 = MultiHeadDotProductAttention(
            dim, num_heads=4, qkv_features=dim, generator=generator)
        self.Dense_0 = nn.Linear(dim, dim)
        self.Dense_1 = nn.Linear(dim, 2 * dim)
        self.Dense_2 = nn.Linear(dim, num_classes)
        for dense in (self.Dense_0, self.Dense_1, self.Dense_2):
            init_dense(dense, generator)

    def forward(self, batch):
        ids, mask = batch["input_ids"], batch["attention_mask"]  # (B, T)
        x = self.Embed_0(ids)
        x = x + self.MultiHeadDotProductAttention_0(x, mask=mask[:, None, None, :].bool())
        x = x + self.Dense_0(F.gelu(self.Dense_1(x)[..., :self.dim], approximate="tanh"))
        # mean-pool over valid tokens, then classify
        denom = mask.sum(-1, keepdim=True).clamp(min=1)
        return self.Dense_2((x * mask[..., None]).sum(1) / denom)


def make_data(B=64, T=12):
    """Random token sequences with random padded tails; the label is the
    parity of the first token."""
    rng = np.random.default_rng(0)
    ids = rng.integers(1, 128, size=(B, T))
    mask = np.ones((B, T), dtype=np.int32)
    for i in range(B):
        pad = rng.integers(0, 5)
        if pad:
            mask[i, -pad:] = 0
            ids[i, -pad:] = 0
    labels = (ids[:, 0] % 2).astype(np.int64)
    return {"input_ids": ids, "attention_mask": mask, "labels": labels}


def main(device=None, B=64, T=12, n_steps=30):
    device = resolve_device(device)
    data = make_data(B, T)
    loader = ArrayLoader(data, batch_size=16)
    net = TinyTransformerClassifier(generator=torch.Generator().manual_seed(0)).to(device)

    # last-layer Laplace over dict batches: the classifier head is discovered
    # automatically; labels come from dict_key_y
    la = Laplace(net, "classification", subset_of_weights="last_layer",
                 hessian_structure="full", dict_key_x="input_ids", dict_key_y="labels",
                 device=device)
    la.fit(loader)
    la.optimize_prior_precision(method="marglik", n_steps=n_steps)

    test = {k: v[:8] for k, v in data.items()}
    probs = la(test, link_approx="probit").cpu().numpy()
    print("last layer discovered at:", la.last_layer_path)
    print("probit predictive (rows sum to 1):")
    print(probs.round(3))

    # subnetwork Laplace over the Dense_2 module
    idx = ModuleNameSubnetMask(net, ["Dense_2"], device=device).select(loader)
    la_sub = Laplace(net, "classification", subset_of_weights="subnetwork",
                     hessian_structure="diag", subnetwork_indices=idx,
                     dict_key_x="input_ids", dict_key_y="labels", device=device)
    la_sub.fit(loader)
    probs_sub = la_sub(test, link_approx="probit").cpu().numpy()
    print(f"subnetwork ({len(idx)} params) predictive ok:", bool(np.isfinite(probs_sub).all()))

    # all-weights diagonal Laplace over the whole transformer: the embedding,
    # every attention projection and the MLP get exact tap diagonals
    la_all = Laplace(net, "classification", subset_of_weights="all",
                     hessian_structure="diag", dict_key_x="input_ids", dict_key_y="labels",
                     device=device)
    la_all.fit(loader)
    la_all.optimize_prior_precision(method="marglik", n_steps=n_steps)
    probs_all = la_all(test, link_approx="probit").cpu().numpy()
    print(f"all-weights diag over {la_all.n_params} params (incl. embedding + attention):")
    print(probs_all.round(3))
    return {"last_layer_path": list(la.last_layer_path), "probs": probs.tolist(),
            "prior_precision": float(la.prior_precision[0]),
            "log_marglik": float(la.log_marginal_likelihood()),
            "subnet_n_params": len(idx), "probs_sub": probs_sub.tolist(),
            "all_n_params": la_all.n_params, "probs_all": probs_all.tolist()}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    main(ap.parse_args().device)
