"""Weights and preference pairs of the DeepSeek-V2 reward configuration
(`configs/deepseek-v2-lite-reward.json`) from the seed, made on the device
in one draw each.

The tensors are named as the program's model names them (its state dict),
from the configuration's sizes alone; `weights.build_model` loads them
with `strict=True`, so a name or shape that differs fails there. The
streams are `weights.py`'s, so the same seed gives the same weights and
pairs on the same device type.
"""

from __future__ import annotations

import math

import torch

from benchmark.weights import generator


def weight_specs(config: dict) -> list:
    """(name, shape, how, std) of every tensor: `how` "normal" (std) or
    "one_plus" (1 + std * normal, a norm scale)."""
    k = config["model_kwargs"]
    d, H = k["hidden_size"], k["num_attention_heads"]
    dn, dr, dv, r = k["qk_nope_head_dim"], k["qk_rope_head_dim"], k["v_head_dim"], k["kv_lora_rank"]
    s_norm = config["weight_draw"]["norm_scale_std"]
    out = [("embed_tokens.weight", (k["vocab_size"], d), "normal",
            config["weight_draw"]["embedding_std"])]

    def dense(name, d_in, d_out):
        out.append((f"{name}.weight", (d_out, d_in), "normal", math.sqrt(1.0 / d_in)))

    def swiglu(p, width):
        dense(f"{p}.gate_proj", d, width)
        dense(f"{p}.up_proj", d, width)
        dense(f"{p}.down_proj", width, d)

    for i in range(k["num_hidden_layers"]):
        p = f"layers.{i}"
        out.append((f"{p}.input_layernorm.scale", (d,), "one_plus", s_norm))
        a = f"{p}.self_attn"
        dense(f"{a}.q_proj", d, H * (dn + dr))
        dense(f"{a}.kv_a_proj_with_mqa", d, r + dr)
        out.append((f"{a}.kv_a_layernorm.scale", (r,), "one_plus", s_norm))
        dense(f"{a}.kv_b_proj", r, H * (dn + dv))
        dense(f"{a}.o_proj", H * dv, d)
        out.append((f"{p}.post_attention_layernorm.scale", (d,), "one_plus", s_norm))
        if i < k["first_k_dense_replace"]:
            swiglu(f"{p}.mlp", k["intermediate_size"])
            continue
        dense(f"{p}.mlp.gate", d, k["n_routed_experts"])
        for e in k["held_experts"]:
            swiglu(f"{p}.mlp.experts.{e}", k["moe_intermediate_size"])
        swiglu(f"{p}.mlp.shared_experts", k["n_shared_experts"] * k["moe_intermediate_size"])
    out.append(("norm.scale", (d,), "one_plus", s_norm))
    dense("score", d, 1)
    return out


def make_weights(config: dict, seed: int, device, dtype=torch.float32) -> dict:
    """{name: tensor}: one standard normal draw for every entry, shaped and
    scaled per tensor."""
    specs = weight_specs(config)
    total = sum(math.prod(shape) for _, shape, _, _ in specs)
    z = torch.randn(total, generator=generator(seed, "weights", device), device=device,
                    dtype=dtype)
    out, at = {}, 0
    for name, shape, how, std in specs:
        n = math.prod(shape)
        t = z[at:at + n].reshape(shape) * std
        out[name] = t.add_(1.0) if how == "one_plus" else t
        at += n
    return out


def make_pairs(config: dict, n: int, seq_len: int, seed: int, stream: str, device):
    """n preference pairs: token ids (n, 2, seq_len) uniform over the
    vocabulary and labels (n,) uniform over the pair's two members."""
    g = generator(seed, stream, device)
    ids = torch.randint(0, config["vocab_size"], (n, 2, seq_len), generator=g, device=device)
    return ids, torch.randint(0, 2, (n,), generator=g, device=device)
