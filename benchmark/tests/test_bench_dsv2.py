"""The DeepSeek-V2 reward cell at a tiny size on the CPU: a whole run of
`deepseek-v2-lite-reward.rm-kron-fit-p16-t512` (float32, as timed, against
the float64 reference), sound and with a wrong routing choice or a wrong
expert normalisation planted in the program, which the check must catch;
the near-tie rule of the reference's router on crafted ties; and the
configuration's file against the catalog's published sizes."""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import counts_dsv2, harness  # noqa: E402
from benchmark.reference.reward_kfac import Router  # noqa: E402
from benchmark.weights import build_model  # noqa: E402
from benchmark.weights_dsv2 import make_weights, weight_specs  # noqa: E402

CELL = "deepseek-v2-lite-reward.rm-kron-fit-p16-t512"
CONFIG = harness.load_config("deepseek-v2-lite-reward")
TINY_KW = dict(CONFIG["model_kwargs"], vocab_size=64, hidden_size=32, intermediate_size=48,
               moe_intermediate_size=16, num_hidden_layers=3, num_attention_heads=2,
               n_routed_experts=16, num_experts_per_tok=3, kv_lora_rank=16,
               qk_nope_head_dim=8, qk_rope_head_dim=4, v_head_dim=8, held_experts=[0, 1, 2, 3])
TINY = ({"model_kwargs": TINY_KW, "vocab_size": 64, "num_experts_per_tok": 3,
         "held_experts": [0, 1, 2, 3], "router_outputs": 16},
        {"n_per_fit": 4, "seq_len": 6, "batch_size": 2, "input_sets": 2, "check_fits": 1,
         "reference_batch": 2, "trace_fits": 1})


def run_tiny(seed=7, **kw):
    return harness.run_cell(CELL, seed, 0.3, False, device="cpu", config_override=TINY[0],
                            traffic_override=TINY[1], **kw)


def test_sound_run_is_correct():
    result = run_tiny()
    assert result["correct"], result["checks"]
    assert result["checks"]["routing_mismatches"]["value"] == 0


def test_traced_run_reads_the_new_metrics():
    result = harness.run_cell(CELL, 11, 0.3, True, device="cpu", config_override=TINY[0],
                              traffic_override=TINY[1])
    assert result["correct"], result["checks"]
    got = result["metrics"]
    # A and B of 3 projections, 4 experts, 2 MoE layers, 2 batches
    assert got["expert_gram_products"]["value"] == 2 * 3 * 4 * 2 * 2
    assert got["expert_grams_s"]["value"] > 0 and got["fit_mfu_pct.dsv2"]["value"] > 0
    assert "stage1_roofline_pct.dsv2" not in got  # no panel kernel on the CPU


def second_choice(monkeypatch):
    """Each token's last slot goes to its (k+1)-th best expert."""
    from laplace_jax_torch.models.deepseek_v2 import MoE

    def route(self, scores):
        w, ids = torch.topk(scores, self.top_k + 1, dim=-1)
        keep = list(range(self.top_k - 1)) + [self.top_k]
        return w[:, keep] * self.scaling, ids[:, keep]

    monkeypatch.setattr(MoE, "route", route)


def rows_as_samples(monkeypatch):
    """The expert taps take their gathered rows as samples, as a Dense on
    a 2-D input does: one position a sample, A over N."""
    from laplace_jax_torch.models.deepseek_v2 import RoutedLinear

    monkeypatch.setattr(RoutedLinear, "__setattr__",
                        lambda self, k, v: torch.nn.Linear.__setattr__(
                            self, k, 1 if k == "routed_positions" else v))


@pytest.mark.parametrize("fault", [second_choice, rows_as_samples],
                         ids=["wrong-routing-choice", "wrong-expert-normalisation"])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    assert not run_tiny()["correct"]


def test_router_follows_the_program_only_within_the_band():
    """Token 0's 2nd and 3rd logits tie within the band, token 1's do not:
    the reference takes the program's choice for token 0 and counts token
    1's differing choice as a mismatch."""
    logits = torch.tensor([[3.0, 2.0, 2.0 + 5e-5, -1.0], [3.0, 2.0, 1.0, -1.0]],
                          dtype=torch.float64)
    router = Router(k=2, band=1e-4)
    router.program = [torch.tensor([[0, 1], [0, 2]])]
    got = router(0, logits)
    assert got[0].sort().values.tolist() == [0, 1]  # the program's, in the band
    assert got[1].sort().values.tolist() == [0, 1]  # its own, outside it
    assert (router.near_ties, router.mismatches, router.tokens) == (1, 1, 2)
    router = Router(k=2, band=1e-6)
    router.program = [torch.tensor([[0, 1], [0, 1]])]
    router(0, logits)
    assert (router.near_ties, router.mismatches) == (0, 1)


def test_configuration_keeps_the_published_widths():
    """Every key of the catalog's config is in the file as published, but
    the two in `reduced`; the weights the benchmark makes are the model's,
    482,634,240 trainable and 692,349,440 with the embedding."""
    published = {"num_hidden_layers": 27, "n_routed_experts": 64, "hidden_size": 2048,
                 "intermediate_size": 10944, "moe_intermediate_size": 1408,
                 "kv_lora_rank": 512, "qk_nope_head_dim": 128, "qk_rope_head_dim": 64,
                 "v_head_dim": 128, "num_attention_heads": 16, "num_experts_per_tok": 6,
                 "n_shared_experts": 2, "vocab_size": 102400, "first_k_dense_replace": 1}
    changed = {k for k, v in published.items() if CONFIG[k] != v}
    assert changed == set(CONFIG["reduced"]) == {"num_hidden_layers", "n_routed_experts"}
    kw = CONFIG["model_kwargs"]
    assert kw["n_routed_experts"] == CONFIG["router_outputs"] == 64
    assert len(kw["held_experts"]) == CONFIG["n_routed_experts"] == 8
    assert kw["num_hidden_layers"] == CONFIG["num_hidden_layers"]
    n = sum(math.prod(shape) for _, shape, _, _ in weight_specs(CONFIG))
    assert n == CONFIG["n_params_with_embedding"]
    assert n - 102400 * 2048 == CONFIG["n_params"]
    assert counts_dsv2.factor_classes(CONFIG) == {2048: 147, 1408: 96, 10944: 3, 4096: 5,
                                                  3072: 5, 2816: 12, 576: 5, 512: 10, 64: 4,
                                                  1: 1}


def test_tiny_weights_load_into_the_model():
    config = {**CONFIG, **TINY[0]}
    w = make_weights(config, 3, torch.device("cpu"))
    net = build_model(config, w, torch.device("cpu"))
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in w.items()}
