"""DeepSeek-V2 as a reward model: multi-head latent attention (MLA) with
YaRN rotary embeddings, a dense SwiGLU first layer, then mixture-of-experts
layers with shared experts, and a scalar score head on each sequence's last
token (HF `modeling_deepseek.py`, `DeepseekV2ForSequenceClassification` with
one label: a Bradley-Terry reward model).

Every projection is an `nn.Linear` and every norm the `RMSNorm` twin of
`models/flax_layers.py`, so the KFAC taps see all of them; the token
embedding is torch's `nn.Embedding`, which the taps leave alone (a reward
model's Laplace freezes it: `requires_grad_(False)`).

- A decoder layer is `x = x + Attn(RMSNorm(x))`, `x = x + FFN(RMSNorm(x))`;
  the final RMSNorm follows the last layer.
- MLA without q compression: `q = W_q h`, heads of `qk_nope_head_dim +
  qk_rope_head_dim`; the latent `W_kva h` splits into `c_kv`
  (`kv_lora_rank`, RMS-normed by `kv_a_layernorm`) and one rotary key
  `k_pe` for all heads; `W_kvb c_kv` gives each head's `k_nope` and `v`.
  The rotary parts are de-interleaved (`view(..., d / 2, 2).transpose`) and
  rotated by `rotate_half` with YaRN's frequencies; the causal softmax is
  scaled by `q_head_dim ** -0.5 * m ** 2`, `m = 0.1 mscale_all_dim ln(factor)
  + 1`, and cos and sin by `m(mscale) / m(mscale_all_dim)`.
- The router is `softmax(W_r h)` over all `n_routed_experts`, in the
  model's dtype (float32 or wider; HF casts bf16 up to float32), with a
  greedy top-k whose scores, times `routed_scaling_factor`, weight the
  experts (not renormalised). An MoE layer holds the experts `held` of
  them, as one rank of expert parallelism does: it computes each held
  expert once on the rows routed to it and adds the weighted results into
  the tokens' rows, with the shared experts (one SwiGLU of width
  `n_shared_experts * moe_intermediate_size`) on every token. What the
  experts held elsewhere would add is not computed here; summed over ranks
  that hold every expert once, the layers' outputs less the shared part
  give the uncut layer's.
- Inputs are token ids `(..., T)`: `(B, 2, T)` preference pairs give `(B,
  2)` logits, `(B, T)` sequences `(B, 1)` rewards. Activations keep the
  leading axes, so a Dense tap counts `2 T` positions per pair.

A held expert's projections see a gathered `(rows, d)` tensor; their
`routed_positions` (`RoutedLinear`) is set by the MoE layer to the
positions per sample of the batch the rows come from, so the KFAC tap
normalises their activation factor by `N * 2T`, as the attention
projections of the same batch (`curvature/kfac.py`).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from laplace_jax_torch.models.flax_layers import RMSNorm
from laplace_jax_torch.utils import spans

__all__ = ["DeepseekV2RewardModel", "MLAttention", "MoE", "RoutedLinear", "SwiGLU",
           "yarn_inv_freq", "yarn_mscale"]


def yarn_mscale(scale: float, mscale: float) -> float:
    """YaRN's attention temperature factor (HF `yarn_get_mscale`)."""
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def _correction_dim(rotations: float, dim: int, base: float, max_pos: int) -> float:
    return dim * math.log(max_pos / (rotations * 2 * math.pi)) / (2 * math.log(base))


def yarn_inv_freq(dim: int, base: float, factor: float, original_max_position_embeddings: int,
                  beta_fast: float, beta_slow: float) -> torch.Tensor:
    """YaRN's (dim / 2,) inverse frequencies in float64 (HF
    `DeepseekV2YarnRotaryEmbedding`): the extrapolated `base ** (-2i / dim)`
    below the correction range `yarn_find_correction_range(beta_fast,
    beta_slow, ...)`, the interpolated ones divided by `factor` above it, a
    linear ramp between."""
    low = max(math.floor(_correction_dim(beta_fast, dim, base,
                                         original_max_position_embeddings)), 0)
    high = min(math.ceil(_correction_dim(beta_slow, dim, base,
                                         original_max_position_embeddings)), dim - 1)
    if low == high:
        high += 0.001
    i = torch.arange(0, dim, 2, dtype=torch.float64, device="cpu")
    extra = 1.0 / base ** (i / dim)
    inter = extra / factor
    ramp = (torch.arange(dim // 2, dtype=torch.float64, device="cpu") - low) / (high - low)
    ramp = ramp.clamp(0, 1)
    mask = 1.0 - ramp
    return inter * (1 - mask) + extra * mask


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """RoPE as HF applies it: de-interleave the (..., T, d) pairs, then
    `x cos + rotate_half(x) sin`."""
    d = x.shape[-1]
    x = x.unflatten(-1, (d // 2, 2)).transpose(-1, -2).flatten(-2)
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return x * cos + torch.cat((-x2, x1), dim=-1) * sin


class RoutedLinear(nn.Linear):
    """An `nn.Linear` of a routed expert, fed the rows gathered for it.
    `routed_positions`, set by the layer that gathers the rows before each
    call, is the number of positions per sample in the batch those rows
    come from; the KFAC tap divides the activation Gram by `N` times it
    (`nnmodel.apply_with_taps`)."""

    routed_positions: int | None = None


class SwiGLU(nn.Module):
    """`W_down(silu(W_gate h) * W_up h)`, no biases."""

    def __init__(self, d: int, width: int, linear=nn.Linear):
        super().__init__()
        self.gate_proj = linear(d, width, bias=False)
        self.up_proj = linear(d, width, bias=False)
        self.down_proj = linear(width, d, bias=False)

    def forward(self, h):
        return self.down_proj(F.silu(self.gate_proj(h)) * self.up_proj(h))


class MoE(nn.Module):
    """Routed experts with a shared expert, holding the experts `held` of
    `n_experts` (module docstring). While `routing` is a list, each forward
    appends its (tokens, top_k) expert ids to it."""

    def __init__(self, d: int, width: int, n_experts: int, top_k: int, held: Sequence[int],
                 n_shared: int, scaling: float = 1.0):
        super().__init__()
        self.n_experts, self.top_k, self.scaling = n_experts, top_k, scaling
        self.held = sorted(int(e) for e in held)
        if not self.held or self.held[0] < 0 or self.held[-1] >= n_experts or len(
                set(self.held)) != len(self.held):
            raise ValueError(f"held experts {held} must be distinct ids below {n_experts}.")
        self.gate = nn.Linear(d, n_experts, bias=False)
        self.experts = nn.ModuleDict({str(e): SwiGLU(d, width, RoutedLinear) for e in self.held})
        self.shared_experts = SwiGLU(d, n_shared * width)
        self.routing = None

    def route(self, scores: torch.Tensor) -> tuple:
        """Greedy top-k of each row of (tokens, experts) scores: the
        (tokens, k) weights, the scores times `scaling`, and expert ids."""
        weight, ids = torch.topk(scores, self.top_k, dim=-1, sorted=False)
        return weight * self.scaling, ids

    def forward(self, x):
        # the router and the shared experts keep the leading axes, as the
        # attention projections do, so their taps count the same positions
        d = x.shape[-1]
        h = x.reshape(-1, d)
        weight, ids = self.route(self.gate(x).softmax(dim=-1).reshape(-1, self.n_experts))
        weight = weight.reshape(-1)
        if self.routing is not None:
            self.routing.append(ids.detach())
        # each (token, slot) assignment, ordered by expert; one host read of
        # the held experts' counts and offsets sizes their gathers
        flat = ids.reshape(-1)
        order = torch.argsort(flat, stable=True)
        counts = torch.bincount(flat, minlength=self.n_experts)
        starts, counts = torch.stack((torch.cumsum(counts, 0) - counts, counts)).tolist()
        at, n = [starts[e] for e in self.held], [counts[e] for e in self.held]
        if torch.is_grad_enabled():
            spans.count("accumulate.routed_rows", sum(n))
        positions = h.shape[0] // x.shape[0]
        rows, outs = [], []
        for e, a, k in zip(self.held, at, n):
            sel = order[a:a + k]
            tok = torch.div(sel, self.top_k, rounding_mode="floor")
            expert = self.experts[str(e)]
            for lin in (expert.gate_proj, expert.up_proj, expert.down_proj):
                lin.routed_positions = positions
            outs.append(expert(h.index_select(0, tok)) * weight.index_select(0, sel)[:, None])
            rows.append(tok)
        y = h.new_zeros(h.shape).index_add(0, torch.cat(rows), torch.cat(outs))
        return y.reshape(x.shape) + self.shared_experts(x)


class MLAttention(nn.Module):
    """Multi-head latent attention without q compression (module
    docstring), causal over the last but one axis of `(..., T, d)`."""

    def __init__(self, d: int, num_heads: int, kv_lora_rank: int, qk_nope_head_dim: int,
                 qk_rope_head_dim: int, v_head_dim: int, rope_theta: float, rope_scaling: dict,
                 rms_norm_eps: float):
        super().__init__()
        self.h, self.nope, self.rope, self.dv = (num_heads, qk_nope_head_dim, qk_rope_head_dim,
                                                 v_head_dim)
        self.kv_lora_rank = kv_lora_rank
        q_head = qk_nope_head_dim + qk_rope_head_dim
        self.q_proj = nn.Linear(d, num_heads * q_head, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(d, kv_lora_rank + qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(kv_lora_rank, epsilon=rms_norm_eps)
        self.kv_b_proj = nn.Linear(kv_lora_rank, num_heads * (qk_nope_head_dim + v_head_dim),
                                   bias=False)
        self.o_proj = nn.Linear(num_heads * v_head_dim, d, bias=False)
        rs = rope_scaling
        self.inv_freq64 = yarn_inv_freq(qk_rope_head_dim, rope_theta, rs["factor"],
                                        rs["original_max_position_embeddings"], rs["beta_fast"],
                                        rs["beta_slow"])
        m_all = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        self.cos_scale = yarn_mscale(rs["factor"], rs["mscale"]) / m_all
        self.softmax_scale = q_head ** -0.5 * m_all * m_all
        self._tables: dict = {}

    def rope_tables(self, T: int, like: torch.Tensor) -> tuple:
        """(T, rope dim) cos and sin, worked in float64 on the host once per
        length, device and dtype, in `like`'s dtype on its device."""
        key = (T, like.device, like.dtype)
        if key not in self._tables:
            pos = torch.arange(T, dtype=torch.float64, device="cpu")
            emb = torch.outer(pos, self.inv_freq64).repeat(1, 2)
            self._tables[key] = tuple((f(emb) * self.cos_scale).to(like.device, like.dtype)
                                      for f in (torch.cos, torch.sin))
        return self._tables[key]

    def forward(self, x):
        *lead, T, _ = x.shape
        q = self.q_proj(x).unflatten(-1, (self.h, self.nope + self.rope)).transpose(-2, -3)
        q_nope, q_pe = q.split((self.nope, self.rope), dim=-1)
        c_kv, k_pe = self.kv_a_proj_with_mqa(x).split((self.kv_lora_rank, self.rope), dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c_kv))
        kv = kv.unflatten(-1, (self.h, self.nope + self.dv)).transpose(-2, -3)
        k_nope, v = kv.split((self.nope, self.dv), dim=-1)
        cos, sin = self.rope_tables(T, x)
        q_pe = _rotate(q_pe, cos, sin)
        k_pe = _rotate(k_pe, cos, sin).unsqueeze(-3)  # one rotary key for every head
        s = (q_nope @ k_nope.transpose(-1, -2) + q_pe @ k_pe.transpose(-1, -2)) * self.softmax_scale
        causal = torch.ones(T, T, dtype=torch.bool, device=x.device).tril()
        p = s.masked_fill(~causal, float("-inf")).softmax(dim=-1)
        o = (p @ v).transpose(-2, -3).flatten(-2)
        return self.o_proj(o)


class DecoderLayer(nn.Module):
    def __init__(self, attn: MLAttention, mlp: nn.Module, d: int, eps: float):
        super().__init__()
        self.input_layernorm = RMSNorm(d, epsilon=eps)
        self.self_attn = attn
        self.post_attention_layernorm = RMSNorm(d, epsilon=eps)
        self.mlp = mlp

    def forward(self, x):
        x = x + self.self_attn(self.input_layernorm(x))
        return x + self.mlp(self.post_attention_layernorm(x))


class DeepseekV2RewardModel(nn.Module):
    """DeepSeek-V2 with a scalar score head (module docstring). The
    arguments are the HF config's keys; `held_experts` are the routed
    experts this rank holds of `n_routed_experts` (default: all)."""

    def __init__(self, vocab_size: int = 102400, hidden_size: int = 2048,
                 intermediate_size: int = 10944, moe_intermediate_size: int = 1408,
                 num_hidden_layers: int = 27, num_attention_heads: int = 16,
                 n_routed_experts: int = 64, n_shared_experts: int = 2,
                 num_experts_per_tok: int = 6, first_k_dense_replace: int = 1,
                 kv_lora_rank: int = 512, qk_nope_head_dim: int = 128,
                 qk_rope_head_dim: int = 64, v_head_dim: int = 128, rope_theta: float = 10000.0,
                 rope_scaling: dict | None = None, rms_norm_eps: float = 1e-6,
                 routed_scaling_factor: float = 1.0, held_experts: Sequence[int] | None = None):
        super().__init__()
        rope_scaling = rope_scaling or {"factor": 40, "original_max_position_embeddings": 4096,
                                        "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                                        "mscale_all_dim": 0.707}
        d = hidden_size
        held = range(n_routed_experts) if held_experts is None else held_experts
        self.embed_tokens = nn.Embedding(vocab_size, d)
        layers = []
        for i in range(num_hidden_layers):
            attn = MLAttention(d, num_attention_heads, kv_lora_rank, qk_nope_head_dim,
                               qk_rope_head_dim, v_head_dim, rope_theta, rope_scaling,
                               rms_norm_eps)
            mlp = (SwiGLU(d, intermediate_size) if i < first_k_dense_replace else
                   MoE(d, moe_intermediate_size, n_routed_experts, num_experts_per_tok, held,
                       n_shared_experts, routed_scaling_factor))
            layers.append(DecoderLayer(attn, mlp, d, rms_norm_eps))
        self.layers = nn.ModuleList(layers)
        self.norm = RMSNorm(d, epsilon=rms_norm_eps)
        self.score = nn.Linear(d, 1, bias=False)

    def forward(self, ids):
        x = self.embed_tokens(ids)
        for layer in self.layers:
            x = layer(x)
        r = self.score(self.norm(x)[..., -1, :])  # (..., 1): each sequence's last token
        return r[..., 0] if ids.ndim == 3 else r
