"""DeepSeek-V2 as a reward model (`laplace_jax_torch.models.deepseek_v2`)
against the plain float64 reference (`tests/reference_deepseek_v2.py`), at a
tiny size on the CPU: the forward, the expert-parallel share, and the
all-weights KFAC fit of `Laplace(..., "reward_modeling", "all", "kron")`,
routed experts included."""

from __future__ import annotations

import torch

from laplace_jax_torch import Laplace
from laplace_jax_torch.models.deepseek_v2 import DeepseekV2RewardModel, MoE, RoutedLinear
from laplace_jax_torch.utils.data import ArrayLoader
from tests import reference_deepseek_v2 as ref

CFG = dict(vocab_size=40, hidden_size=24, intermediate_size=40, moe_intermediate_size=12,
           num_hidden_layers=3, num_attention_heads=2, n_routed_experts=8, n_shared_experts=2,
           num_experts_per_tok=3, first_k_dense_replace=1, kv_lora_rank=16,
           qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=6, rope_theta=10000.0,
           rope_scaling={"factor": 40, "original_max_position_embeddings": 4096,
                         "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
                         "mscale_all_dim": 0.707},
           rms_norm_eps=1e-6, routed_scaling_factor=1.0)
HELD = (0, 1, 2, 3)
N, T = 6, 7


def model(held=HELD, seed=0):
    torch.manual_seed(seed)
    net = DeepseekV2RewardModel(**CFG, held_experts=held).double()
    with torch.no_grad():
        for name, p in net.named_parameters():
            if name.endswith(".scale"):  # norm scales off 1, so their blocks are not all alike
                p.add_(0.1 * torch.randn_like(p))
    net.embed_tokens.requires_grad_(False)
    return net


def data(seed=1):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, CFG["vocab_size"], (N, 2, T), generator=g)
    return ids, torch.randint(0, 2, (N,), generator=g)


def weights(net):
    return {k: v.detach() for k, v in net.state_dict().items()}


def test_forward_matches_reference_on_pairs_and_sequences():
    net = model()
    ids, _ = data()
    w = weights(net)
    with torch.no_grad():
        pairs, seqs = net(ids), net(ids[:, 0])
    assert pairs.shape == (N, 2) and seqs.shape == (N, 1)
    torch.testing.assert_close(pairs, ref.forward(w, ids, CFG, HELD), rtol=0, atol=1e-12)
    torch.testing.assert_close(seqs, ref.forward(w, ids[:, 0], CFG, HELD), rtol=0, atol=1e-12)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Two ranks of 4 experts each, the shared expert counted once, give the
    layer that holds all 8, and the reference's uncut layer."""
    d = CFG["hidden_size"]
    torch.manual_seed(3)
    full = MoE(d, 12, 8, 3, range(8), 2).double()
    shares = [MoE(d, 12, 8, 3, held, 2).double() for held in ((0, 1, 2, 3), (4, 5, 6, 7))]
    for share in shares:
        share.load_state_dict({k: v for k, v in full.state_dict().items()
                               if k in share.state_dict()})
    x = torch.randn(3, 2, 5, d, dtype=torch.float64)
    with torch.no_grad():
        whole = full(x)
        parts = shares[0](x) + shares[1](x) - full.shared_experts(x)
        w = {f"m.{k}": v for k, v in full.state_dict().items()}
        plain = ref.moe(ref.Recorder(), w, "m", x, CFG, range(8))
    torch.testing.assert_close(parts, whole, rtol=0, atol=1e-12)
    torch.testing.assert_close(plain, whole, rtol=0, atol=1e-12)


def fitted(net, ids, y):
    la = Laplace(net, "reward_modeling", subset_of_weights="all", hessian_structure="kron",
                 backend_kwargs={"kron_unsupported": "block"}, device="cpu")
    la.fit(ArrayLoader(ids, y, batch_size=4))
    return la


def factor_gap(la, factors) -> float:
    names = [s.name for s in la.model.leaf_specs]
    assert sorted(names) == sorted(factors)
    worst = 0.0
    for name, F in zip(names, la.H_facs.kfacs):
        for Fp, Fr in zip(F, factors[name], strict=True):
            worst = max(worst, float((Fp - Fr).norm() / Fr.norm()))
    return worst


def test_kron_fit_matches_reference_kfac():
    net = model()
    ids, y = data()
    la = fitted(net, ids, y)
    factors, loss = ref.kfac(weights(net), ids, y, CFG, HELD)
    assert la.n_params == sum(p.numel() for n, p in net.named_parameters()
                              if n != "embed_tokens.weight")
    assert factor_gap(la, factors) < 1e-10
    assert abs(float(la.loss) - float(loss)) < 1e-10 * abs(float(loss))
    names = [s.name for s in la.model.leaf_specs]
    for name, lams in zip(names, la.H.eigenvalues):
        for lp, Fr in zip(lams, factors[name]):
            lr = torch.linalg.eigvalsh(Fr).clamp(min=0)
            assert float((lp - lr).abs().max()) <= 1e-10 * float(lr.abs().max()) + 1e-300

    # an expert's A is its routed rows' Gram over N * 2T, whatever their number
    name = "layers.1.mlp.experts.2.gate_proj.weight"
    A = la.H_facs.kfacs[names.index(name)][0]
    x, rows = [], 0
    hook = net.layers[1].post_attention_layernorm.register_forward_hook(
        lambda m, a, out: x.append(out.detach().reshape(-1, CFG["hidden_size"])))
    moe_layer = net.layers[1].mlp
    moe_layer.routing = []
    with torch.no_grad():
        net(ids)
    hook.remove()
    routed = (moe_layer.routing[0] == 2).any(-1)
    rows = x[0][routed]
    assert 0 < rows.shape[0] < x[0].shape[0]
    torch.testing.assert_close(A, rows.T @ rows / (N * 2 * T), rtol=1e-12, atol=0)


def test_routed_tap_normalised_by_its_rows_is_caught(monkeypatch):
    """A planted fault: the expert taps take their gathered rows as samples,
    one position each, as a plain Dense on a 2-D input does (A over N)."""
    monkeypatch.setattr(RoutedLinear, "__setattr__",
                        lambda self, k, v: torch.nn.Linear.__setattr__(
                            self, k, 1 if k == "routed_positions" else v))
    net = model()
    ids, y = data()
    la = fitted(net, ids, y)
    factors, _ = ref.kfac(weights(net), ids, y, CFG, HELD)
    assert factor_gap(la, factors) > 1.0


def test_diag_taps_refuse_routed_rows():
    """The tap diagonal takes a 2-D Dense input's rows as samples, which a
    routed expert's are not: `DiagLaplace` falls back to the Jacobians,
    which hold the reference's per-pair gradients."""
    net = model()
    ids, y = data()
    la = Laplace(net, "reward_modeling", subset_of_weights="all", hessian_structure="diag",
                 device="cpu")
    la.fit(ArrayLoader(ids[:2], y[:2], batch_size=2))
    w = {k: v.detach().requires_grad_(k != "embed_tokens.weight")
         for k, v in weights(net).items()}
    names = [s.name for s in la.model.leaf_specs]
    diag = 0.0
    f = ref.forward(w, ids[:2], CFG, HELD)
    p = torch.softmax(f.detach(), -1)
    for b in range(2):
        for c in range(2):
            s = p[b, c].sqrt() * (torch.eye(2, dtype=f.dtype)[c] - p[b])
            g = torch.autograd.grad(f[b] @ s, [w[n] for n in names], retain_graph=True)
            flat = torch.cat([(gi.T if gi.ndim == 2 else gi).reshape(-1) for gi in g])
            diag = diag + flat * flat
    torch.testing.assert_close(la.H, diag, rtol=1e-10, atol=1e-14)
