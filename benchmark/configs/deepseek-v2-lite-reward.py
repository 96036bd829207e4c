"""Plain forward of DeepSeek-V2-Lite as a reward model (DeepSeek-AI 2024,
arXiv:2405.04434; HF `modeling_deepseek.py` and its config.json), cut as
the configuration states: layer 0 dense, then MoE layers holding the
experts `held_experts` of the router's `router_outputs`.

- RMSNorm: x / sqrt(mean(x^2) + eps) * scale.
- MLA, no q compression: q = W_q h, heads of 128 + 64; [c_kv, k_pe] =
  W_kva h; k_nope, v = W_kvb RMSNorm(c_kv); the rotary halves
  de-interleaved (evens, then odds) and turned by YaRN's frequencies
  (factor 40 over 4,096 positions, beta 32 and 1), cos and sin times
  m(mscale) / m(mscale_all_dim); k_pe shared by the heads; causal softmax of
  [q_nope, q_pe] . [k_nope, k_pe] times 192^-1/2 m^2, m = 0.1 * 0.707 ln 40
  + 1; W_o from the heads' values.
- Layer 0: W_down(silu(W_gate h) * W_up h). An MoE layer: scores
  softmax(W_r h) over the router's outputs, each token's top k by score
  (chosen by `router`), each held expert on the rows routed to it, times
  its score, plus the shared expert on every token.
- Head: W_score on the final-normed last token of each sequence; a pair's
  two rewards are its logits.

`forward(w, ids, cfg, rec, router)`: `w` the weights by the program's
names, `ids` (B, 2, T); `rec` records each projection's input and output
(`rec.linear(name, x, out, positions)`, positions None where the input's
own shape gives them) and each norm's x_hat and output (`rec.norm(name,
xhat, out)`); `router(layer, logits)` returns each token's k expert ids.
Returns the (B, 2) logits. Everything runs in the dtype of the weights.
"""

import math

import torch


def _yarn(T, cfg, dtype, device):
    """cos and sin (T, rope dim), and the softmax scale's m."""
    k = cfg["model_kwargs"]
    rs, dr, theta = k["rope_scaling"], k["qk_rope_head_dim"], float(k["rope_theta"])

    def corr(rot):
        return dr * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) / (
            2 * math.log(theta))

    def m(s):
        return 0.1 * s * math.log(rs["factor"]) + 1.0

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dr - 1)
    i = torch.arange(dr // 2, dtype=torch.float64)
    ramp = ((i - low) / max(high - low, 0.001)).clamp(0.0, 1.0)
    extra = theta ** (-2.0 * i / dr)
    inv = extra / rs["factor"] * ramp + extra * (1.0 - ramp)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None]
    ang = torch.cat([ang, ang], dim=1)
    c = m(rs["mscale"]) / m(rs["mscale_all_dim"])
    return ((torch.cos(ang) * c).to(device, dtype), (torch.sin(ang) * c).to(device, dtype),
            m(rs["mscale_all_dim"]))


def _rope(x, cos, sin):
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


def _linear(w, rec, name, x, positions=None):
    out = x @ w[name + ".weight"].T
    rec.linear(name, x, out, positions)
    return out


def _rms(w, rec, name, x, eps):
    xhat = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    out = xhat * w[name + ".scale"]
    rec.norm(name, xhat, out)
    return out


def _swiglu(w, rec, p, h, positions=None):
    g = _linear(w, rec, p + ".gate_proj", h, positions)
    u = _linear(w, rec, p + ".up_proj", h, positions)
    return _linear(w, rec, p + ".down_proj", torch.nn.functional.silu(g) * u, positions)


def _attention(w, rec, p, h, cfg):
    k = cfg["model_kwargs"]
    H, dn, dr, dv, r = (k["num_attention_heads"], k["qk_nope_head_dim"],
                        k["qk_rope_head_dim"], k["v_head_dim"], k["kv_lora_rank"])
    *lead, T, _ = h.shape
    q = _linear(w, rec, p + ".q_proj", h).reshape(*lead, T, H, dn + dr).transpose(-2, -3)
    c = _linear(w, rec, p + ".kv_a_proj_with_mqa", h)
    c_kv = _rms(w, rec, p + ".kv_a_layernorm", c[..., :r], k["rms_norm_eps"])
    kv = _linear(w, rec, p + ".kv_b_proj", c_kv).reshape(*lead, T, H, dn + dv).transpose(-2, -3)
    cos, sin, m = _yarn(T, cfg, h.dtype, h.device)
    k_pe = _rope(c[..., r:], cos, sin).unsqueeze(-3).expand(*lead, H, T, dr)
    qs = torch.cat([q[..., :dn], _rope(q[..., dn:], cos, sin)], dim=-1)
    ks = torch.cat([kv[..., :dn], k_pe], dim=-1)
    s = qs @ ks.transpose(-1, -2) * ((dn + dr) ** -0.5 * m * m)
    future = torch.ones(T, T, dtype=torch.bool, device=h.device).triu(1)
    o = torch.softmax(s.masked_fill(future, -math.inf), dim=-1) @ kv[..., dn:]
    return _linear(w, rec, p + ".o_proj", o.transpose(-2, -3).reshape(*lead, T, H * dv))


def _moe(w, rec, p, h, cfg, router, layer):
    k = cfg["model_kwargs"]
    d = h.shape[-1]
    logits = _linear(w, rec, p + ".gate", h)
    scores = torch.softmax(logits, dim=-1).reshape(-1, logits.shape[-1])
    top = router(layer, logits.detach().reshape(-1, logits.shape[-1]))
    x = h.reshape(-1, d)
    positions = x.shape[0] // h.shape[0]
    out = torch.zeros_like(x)
    for e in k["held_experts"]:
        rows = (top == e).any(-1).nonzero()[:, 0]
        y = _swiglu(w, rec, f"{p}.experts.{e}", x[rows], positions)
        out = out.index_add(0, rows, y * (scores[rows, e] * k["routed_scaling_factor"])[:, None])
    return out.reshape(h.shape) + _swiglu(w, rec, p + ".shared_experts", h)


def forward(w, ids, cfg, rec, router):
    k = cfg["model_kwargs"]
    eps = k["rms_norm_eps"]
    x = w["embed_tokens.weight"][ids]
    moe_layer = 0
    for i in range(k["num_hidden_layers"]):
        p = f"layers.{i}"
        x = x + _attention(w, rec, p + ".self_attn", _rms(w, rec, p + ".input_layernorm", x, eps),
                           cfg)
        h = _rms(w, rec, p + ".post_attention_layernorm", x, eps)
        if i < k["first_k_dense_replace"]:
            x = x + _swiglu(w, rec, p + ".mlp", h)
        else:
            x = x + _moe(w, rec, p + ".mlp", h, cfg, router, moe_layer)
            moe_layer += 1
    last = _rms(w, rec, "norm", x, eps)[..., -1, :]
    return _linear(w, rec, "score", last)[..., 0]
