"""A plain float64 DeepSeek-V2 reward model and its exact-Fisher KFAC, from
the published equations (HF `modeling_deepseek.py`), in plain `torch` on a
dict of weights named as `laplace_jax_torch.models.deepseek_v2`'s
state dict. It imports nothing of the port and no JAX.

The routed experts are written densely: every held expert runs on every
token, times its router weight, which is zero where the token's top-k
leaves it out (so its cotangents there are zero too); the activation
factor of an expert's projection keeps only the routed rows.

KFAC conventions (the port's `curvature/kfac.py`): ``A = sum a a^T / (N P)``
with P the positions per sample of the layer's input (2T on a pair's tokens,
2 for the score head on the last tokens), also for a routed expert's rows;
``B = sum_c sum g g^T`` over the C = 2 square-root-Hessian columns of the
summed cross-entropy of the pair's logits; an RMSNorm scale's block is
``sum_c sum_n u u^T`` with u the per-pair gradient, the sum over positions
of ``g * x_hat``.
"""

from __future__ import annotations

import math

import torch

EPS = 1e-6


def yarn_tables(T: int, rope_dim: int, theta: float, rs: dict) -> tuple:
    """(T, rope_dim) cos and sin and the softmax scale's mscale, worked in
    float64."""
    def corr(rot):
        return rope_dim * math.log(rs["original_max_position_embeddings"] / (rot * 2 * math.pi)) \
            / (2 * math.log(theta))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), rope_dim - 1)
    half = rope_dim // 2
    freq_extra = torch.tensor([theta ** (-2.0 * i / rope_dim) for i in range(half)],
                              dtype=torch.float64)
    freq_inter = freq_extra / rs["factor"]
    ramp = torch.tensor([min(max((i - low) / (high - low if high != low else 0.001), 0.0), 1.0)
                         for i in range(half)], dtype=torch.float64)
    inv = freq_inter * ramp + freq_extra * (1.0 - ramp)
    ang = torch.arange(T, dtype=torch.float64)[:, None] * inv[None, :]
    ang = torch.cat([ang, ang], dim=1)

    def m(s):
        return 0.1 * s * math.log(rs["factor"]) + 1.0 if rs["factor"] > 1 else 1.0

    c = m(rs["mscale"]) / m(rs["mscale_all_dim"])
    return torch.cos(ang) * c, torch.sin(ang) * c, m(rs["mscale_all_dim"])


def rope(x, cos, sin):
    """De-interleave the pairs (evens, then odds), then x cos + rotate_half(x) sin."""
    x = torch.cat([x[..., 0::2], x[..., 1::2]], dim=-1)
    h = x.shape[-1] // 2
    return x * cos + torch.cat([-x[..., h:], x[..., :h]], dim=-1) * sin


class Recorder:
    """The forward's record: each projection's input, output and routed-row
    mask (None but for an expert's), each norm's x_hat and output."""

    def __init__(self):
        self.lin, self.norm = {}, {}

    def linear(self, name, w, x, mask=None):
        y = x @ w[name + ".weight"].T
        self.lin[name] = (x, y, mask)
        return y

    def rms(self, name, w, x):
        xhat = x / torch.sqrt((x * x).mean(-1, keepdim=True) + EPS)
        y = xhat * w[name + ".scale"]
        self.norm[name] = (xhat, y)
        return y


def swiglu(rec, w, p, h, mask=None):
    g = rec.linear(p + ".gate_proj", w, h, mask)
    u = rec.linear(p + ".up_proj", w, h, mask)
    return rec.linear(p + ".down_proj", w, g * torch.sigmoid(g) * u, mask)


def attention(rec, w, p, h, cfg):
    H, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                     cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    T = h.shape[-2]
    lead = h.shape[:-2]
    q = rec.linear(p + ".q_proj", w, h).reshape(*lead, T, H, dn + dr)
    c = rec.linear(p + ".kv_a_proj_with_mqa", w, h)
    c_kv, k_pe = c[..., :cfg["kv_lora_rank"]], c[..., cfg["kv_lora_rank"]:]
    kv = rec.linear(p + ".kv_b_proj", w, rec.rms(p + ".kv_a_layernorm", w, c_kv))
    kv = kv.reshape(*lead, T, H, dn + dv)
    cos, sin, m = yarn_tables(T, dr, cfg["rope_theta"], cfg["rope_scaling"])
    q_pe = rope(q[..., dn:].transpose(-2, -3), cos, sin)  # (..., H, T, dr)
    k_pe = rope(k_pe, cos, sin)[..., None, :, :].expand(*lead, H, T, dr)
    qs = torch.cat([q[..., :dn].transpose(-2, -3), q_pe], dim=-1)
    ks = torch.cat([kv[..., :dn].transpose(-2, -3), k_pe], dim=-1)
    v = kv[..., dn:].transpose(-2, -3)
    s = qs @ ks.transpose(-1, -2) * ((dn + dr) ** -0.5 * m * m)
    s = s + torch.triu(torch.full((T, T), -math.inf, dtype=s.dtype), diagonal=1)
    o = torch.softmax(s, dim=-1) @ v
    return rec.linear(p + ".o_proj", w, o.transpose(-2, -3).reshape(*lead, T, H * dv))


def route(logits, k):
    """(tokens, k) ids of the k largest router scores, by a descending sort."""
    return torch.argsort(torch.softmax(logits, dim=-1), dim=-1, descending=True)[:, :k]


def moe(rec, w, p, h, cfg, held):
    d = h.shape[-1]
    x = h.reshape(-1, d)
    logits = rec.linear(p + ".gate", w, x)
    s = torch.softmax(logits, dim=-1)
    top = route(logits.detach(), cfg["num_experts_per_tok"])
    out = swiglu(rec, w, p + ".shared_experts", x)
    for e in held:
        mask = (top == e).any(-1)
        we = torch.where(mask, s[:, e] * cfg["routed_scaling_factor"], torch.zeros_like(s[:, e]))
        out = out + we[:, None] * swiglu(rec, w, f"{p}.experts.{e}", x, mask)
    return out.reshape(h.shape)


def forward(w, ids, cfg, held, rec=None):
    """Logits (B, 2) of (B, 2, T) ids, or rewards (B, 1) of (B, T) ids."""
    rec = rec or Recorder()
    x = w["embed_tokens.weight"][ids]
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}"
        x = x + attention(rec, w, p + ".self_attn", rec.rms(p + ".input_layernorm", w, x), cfg)
        h = rec.rms(p + ".post_attention_layernorm", w, x)
        x = x + (swiglu(rec, w, p + ".mlp", h) if i < cfg["first_k_dense_replace"]
                 else moe(rec, w, p + ".mlp", h, cfg, held))
    r = rec.linear("score", w, rec.rms("norm", w, x)[..., -1, :])
    return r[..., 0] if ids.ndim == 3 else r


def kfac(w, ids, y, cfg, held):
    """({leaf name: factors}, summed loss) of the exact-Fisher KFAC over the
    pairs `ids` (N, 2, T) with labels y, in one batch."""
    w = {k: v.detach().requires_grad_(k != "embed_tokens.weight") for k, v in w.items()}
    N = ids.shape[0]
    rec = Recorder()
    f = forward(w, ids, cfg, held, rec)
    p = torch.softmax(f.detach(), dim=-1)
    C = f.shape[1]
    eye = torch.eye(C, dtype=f.dtype)
    S = p.T.sqrt()[:, :, None] * (eye[:, None, :] - p[None])
    names, norms = list(rec.lin), list(rec.norm)
    outs = [rec.lin[n][1] for n in names] + [rec.norm[n][1] for n in norms]
    B = {n: 0.0 for n in names + norms}
    for c in range(C):
        gs = torch.autograd.grad(f, outs, grad_outputs=S[c], retain_graph=True)
        for n, g in zip(names, gs):
            r = g.reshape(-1, g.shape[-1])
            B[n] = B[n] + r.T @ r
        for n, g in zip(norms, gs[len(names):]):
            u = (g * rec.norm[n][0].detach()).reshape(N, -1, g.shape[-1]).sum(1)
            B[n] = B[n] + u.T @ u
    out = {}
    for n in names:
        a, _, mask = rec.lin[n]
        P = a.numel() // a.shape[-1] // N if mask is None else 2 * ids.shape[-1]
        a = a.detach().reshape(-1, a.shape[-1])
        if mask is not None:
            a = a[mask]
        out[n + ".weight"] = (a.T @ a / (N * P), B[n])
    for n in norms:
        out[n + ".scale"] = (B[n],)
    loss = torch.nn.functional.cross_entropy(f.detach(), y, reduction="sum")
    return out, loss
