"""Operation counts of a reward-model KFAC fit on the DeepSeek-V2
configuration (`configs/deepseek-v2-lite-reward.json`), from its sizes
alone, beside `counts.py`, whose Gram and eigendecomposition counts and
peaks they use. Each is a lower bound on the work of what it counts, as
there.

A held expert's projections are counted at their expected share of the
tokens: each takes `num_experts_per_tok / router_outputs` of them (random
routing is near-uniform; the cell prints the rows they took).
"""

from __future__ import annotations

from benchmark import counts


def projections(config: dict) -> list:
    """(name, d_in, d_out, share): every projection of the model, `share`
    the fraction of a pair's tokens it reads (the head: its 2 last tokens
    of 2T, passed as the share None)."""
    k = config["model_kwargs"]
    d, H = k["hidden_size"], k["num_attention_heads"]
    dn, dr, dv, r = k["qk_nope_head_dim"], k["qk_rope_head_dim"], k["v_head_dim"], k["kv_lora_rank"]
    expert_share = k["num_experts_per_tok"] / k["n_routed_experts"]
    out = []
    for i in range(k["num_hidden_layers"]):
        p = f"layers.{i}"
        out += [(f"{p}.q_proj", d, H * (dn + dr), 1.0), (f"{p}.kv_a", d, r + dr, 1.0),
                (f"{p}.kv_b", r, H * (dn + dv), 1.0), (f"{p}.o_proj", H * dv, d, 1.0)]
        mlps = ([(f"{p}.mlp", k["intermediate_size"], 1.0)] if i < k["first_k_dense_replace"]
                else [(f"{p}.shared", k["n_shared_experts"] * k["moe_intermediate_size"], 1.0)]
                + [(f"{p}.expert{e}", k["moe_intermediate_size"], expert_share)
                   for e in k["held_experts"]])
        if i >= k["first_k_dense_replace"]:
            out.append((f"{p}.router", d, k["n_routed_experts"], 1.0))
        for name, width, share in mlps:
            out += [(f"{name}.gate", d, width, share), (f"{name}.up", d, width, share),
                    (f"{name}.down", width, d, share)]
    out.append(("score", d, 1, None))
    return out


def norms(config: dict) -> list:
    """The size of every RMSNorm scale (its exact block)."""
    k = config["model_kwargs"]
    d = k["hidden_size"]
    return [d, k["kv_lora_rank"], d] * k["num_hidden_layers"] + [d]


def _rows(share, n_pairs: int, seq_len: int) -> float:
    return 2.0 * n_pairs if share is None else share * 2.0 * n_pairs * seq_len


def forward_flops(config: dict, n_pairs: int, seq_len: int) -> float:
    """FLOPs of the forward of `n_pairs` pairs: 2 per multiply-add of every
    projection on the tokens it reads, and the causal attention's two
    products (scores and values) over the T (T + 1) / 2 query-key pairs a
    sequence has. Norms, activations, the router's softmax and top-k are
    left out."""
    k = config["model_kwargs"]
    H, q_head, dv = (k["num_attention_heads"], k["qk_nope_head_dim"] + k["qk_rope_head_dim"],
                     k["v_head_dim"])
    total = sum(2.0 * d_in * d_out * _rows(share, n_pairs, seq_len)
                for _, d_in, d_out, share in projections(config))
    causal = seq_len * (seq_len + 1) / 2.0
    return total + k["num_hidden_layers"] * 2 * n_pairs * H * causal * 2.0 * (q_head + dv)


def factor_sizes(config: dict) -> list:
    """The size of every factor the fit eigendecomposes: each projection's
    A and B, each norm's block."""
    return [n for _, d_in, d_out, _ in projections(config) for n in (d_in, d_out)] + norms(config)


def factor_classes(config: dict) -> dict:
    """{n: K}: how many factors of each size."""
    out: dict = {}
    for n in factor_sizes(config):
        out[n] = out.get(n, 0) + 1
    return out


def fit_flops(config: dict, n_pairs: int, seq_len: int, sweeps: int = 2) -> float:
    """FLOPs a reward-model KFAC fit of `n_pairs` pairs needs: the forward,
    `sweeps` cotangent sweeps each at least the forward's products (every
    projection's input gradient, the attention's), every projection's A
    Gram over the rows it reads and B Gram over each sweep's rows, each
    norm's block over each sweep's per-pair gradients, and each factor's
    eigendecomposition (`counts.eigh_flops`)."""
    total = (1 + sweeps) * forward_flops(config, n_pairs, seq_len)
    for _, d_in, d_out, share in projections(config):
        rows = _rows(share, n_pairs, seq_len)
        total += counts.gram_flops(rows, d_in) + sweeps * counts.gram_flops(rows, d_out)
    total += sum(sweeps * counts.gram_flops(n_pairs, F) for F in norms(config))
    return total + sum(counts.eigh_flops(n) for n in factor_sizes(config))
