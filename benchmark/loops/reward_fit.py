"""Back-to-back reward-model posterior fits on preference pairs: the
`reward_fit` loop.

Each fit is a user's whole call: `Laplace(net, "reward_modeling",
subset_of_weights, hessian_structure, backend_kwargs={"kron_unsupported":
...})` and `.fit(loader)` on its own `n_per_fit` pairs of 2 x `seq_len`
token ids, which a host loader of `batch_size` pairs copies to the card
batch by batch from pageable memory. The embedding is frozen. The pairs are
drawn from the seed before the window: `input_sets` sets, used in turn, and
one more for the warm-up fit. Timing and the traced segment are the `fit`
loop's (`loops/fit.py`): `fit_s` is the mean fit of the window.

The check: `check_fits` of the window's fits, drawn from the seed, against
the plain float64 reference (`reference/reward_kfac.py` over
`configs/<config>.py`) on the same weights and pairs, in blocks of
`reference_batch` pairs: every KFAC factor, each factor's eigenvalues and
eigenpairs, the summed loss, and the routing. The program's expert layers
record each forward's top-k; the reference routes each token by its own
scores, and takes the program's choice only where its k-th and (k+1)-th
router logits lie within `routing_band` of each other
(`routing_mismatches` counts the other tokens routed otherwise). Standard
error shows the tokens in the band and the rows the held experts took
against their expected share.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import posterior, reward_kfac
from benchmark.reference.layers import tf32
from benchmark.weights import build_model, stream_seed
from benchmark.weights_dsv2 import make_pairs, make_weights

fit = harness.load_loop("fit")


class Loop(fit.Loop):
    def setup(self) -> None:
        import importlib

        module = importlib.import_module(self.config["model"].rsplit(".", 1)[0])
        from laplace_jax_torch.utils.data import ArrayLoader

        if self.device.type == "cuda" and self.traffic.get("build"):
            from laplace_jax_torch.ops import _build

            _build.build_all(self.traffic["build"])
        self.weights = make_weights(self.config, self.seed, self.device)
        self.net = build_model(self.config, self.weights, self.device)
        for name in self.config["frozen"]:
            self.net.get_parameter(name).requires_grad_(False)
        self.moe = [m for m in self.net.modules() if isinstance(m, module.MoE)]
        n, sets, T = self.traffic["n_per_fit"], self.traffic["input_sets"], self.traffic["seq_len"]
        X, y = make_pairs(self.config, n * (sets + 1), T, self.seed, "fit_inputs", self.device)
        self.X, self.y = X.cpu(), y.cpu()  # a user's data set lives on the host
        del X, y
        self.loaders = [ArrayLoader(self.X[i * n:(i + 1) * n], self.y[i * n:(i + 1) * n],
                                    batch_size=self.traffic["batch_size"])
                        for i in range(sets + 1)]
        self.fit(self.loaders[sets])  # the warm-up, on a set of its own

    def fit(self, loader):
        """One fit; its expert layers' routing of the loader's batches is
        left in `self.routing` (the output probe's forward comes first and
        is dropped)."""
        from laplace_jax_torch import Laplace

        for m in self.moe:
            m.routing = []
        la = Laplace(self.net, self.traffic["likelihood"],
                     subset_of_weights=self.traffic["subset_of_weights"],
                     hessian_structure=self.traffic["hessian_structure"],
                     backend_kwargs={"kron_unsupported": self.traffic["kron_unsupported"]},
                     device=self.device)
        la.fit(loader)
        harness.sync(self.device)
        self.routing = [torch.cat(m.routing[-len(loader):]) for m in self.moe]
        for m in self.moe:
            m.routing = None
        return la

    def window(self, seconds: float) -> dict:
        sets = self.traffic["input_sets"]
        self.kept = harness.Reservoir(self.traffic["check_fits"],
                                      np.random.default_rng(stream_seed(self.seed, "check")))
        self.fit_seconds = []

        def step(i):
            la = self.fit(self.loaders[i % sets])
            self.fit_seconds.append(dict(la.fit_seconds))
            self.kept.offer((i % sets, la, self.routing))

        start, spans = harness.timed_loop(seconds, step)
        self.spans = spans
        self.attempted = len(spans)
        self.fit_s = (spans[-1][1] - start) / len(spans)
        self.next_set = len(spans)
        return {"fit_s": self.fit_s}

    def layer_stats(self) -> dict:
        return {**super().layer_stats(), "seq_len": self.traffic["seq_len"]}

    def program_outputs(self) -> list:
        out = []
        for s, la, routing in self.kept.items:
            facs, eig = fit.program_groups(la)
            out.append({"set": s, "factors": facs, "eig": eig, "loss": float(la.loss),
                        "routing": routing})
        return out

    def solve(self, s: int, dtype, control: bool = False, routing=None) -> dict:
        """The reference on fit set `s` in `dtype` (TF32 allowed only for the
        control), routed by its own scores but in the band, where it follows
        `routing`; with `control`, eigenpairs too and its own routing."""
        n = self.traffic["n_per_fit"]
        w = {k: v.to(dtype) for k, v in self.weights.items()}
        router = reward_kfac.Router(self.config["num_experts_per_tok"],
                                    self.traffic["routing_band"])
        with tf32(control):
            groups, loss = reward_kfac.kfac_factors(
                self.forward, w, self.config, self.X[s * n:(s + 1) * n],
                self.y[s * n:(s + 1) * n], self.traffic["reference_batch"], router, routing)
            del w
            if control:
                eig = {k: tuple(torch.linalg.eigh(F) for F in fs) for k, fs in groups.items()}
                eig = {k: tuple((l.clamp(min=0.0), Q) for l, Q in e) for k, e in eig.items()}
                vals = {k: tuple(l for l, _ in e) for k, e in eig.items()}
            else:
                vals, eig = posterior.eigvals(groups), None
        return {"set": s, "factors": groups, "vals": vals, "eig": eig, "loss": float(loss),
                "routing": [torch.cat(router.chosen[i]) for i in sorted(router.chosen)],
                "near_ties": router.near_ties, "mismatches": router.mismatches,
                "tokens": router.tokens}

    def reference(self, outputs: list) -> list:
        return [self.solve(o["set"], torch.float64, routing=o["routing"]) for o in outputs]

    def control_outputs(self, outputs: list) -> list:
        """The reference in the program's place, one precision below the
        configuration's: float32 with TF32 on, routed by its own scores."""
        out = []
        for o in outputs:
            r = self.solve(o["set"], torch.float32, control=True)
            out.append({k: r[k] for k in ("set", "factors", "eig", "loss", "routing")})
        return out

    def compare(self, outputs: list, refs: list) -> dict:
        """The `fit` loop's numbers factor by factor, a factor the
        reference finds exactly zero held to exactly zero instead
        (`zero_factor_norm`: a held expert of the last MoE layer that takes
        none of the last tokens, which alone reach the head, has B = 0),
        and the routing mismatches."""
        split = [(_by_factor(o, r), r) for o, r in zip(outputs, refs, strict=True)]
        worst = super().compare([o for (o, _, _), _ in split],
                                [{**r, "factors": f, "vals": v} for (_, f, v), r in split])
        worst["zero_factor_norm"] = max([0.0] + [z for (o, _, _), _ in split for z in o["zero"]])
        worst["routing_mismatches"] = float(max(r["mismatches"] for r in refs))
        held = torch.tensor(self.config["held_experts"])
        share = (self.config["num_experts_per_tok"] * len(self.config["held_experts"])
                 / self.config["router_outputs"])
        for ((o, _, _), r), out in zip(split, outputs, strict=True):
            rows = sum(int(torch.isin(ids, held.to(ids.device)).sum()) for ids in out["routing"])
            print(f"routing of fit set {o['set']}: {r['near_ties']} of {r['tokens']} token "
                  f"choices within the band {self.traffic['routing_band']:g}, "
                  f"{r['mismatches']} routed otherwise outside it; the held experts took "
                  f"{rows} rows (expected {share * r['tokens']:g}); {len(o['zero'])} factors "
                  "exactly zero", file=sys.stderr)
        return worst


def _by_factor(out: dict, ref: dict) -> tuple:
    """(the program's output with one group per factor, the reference's
    factors and eigenvalues alike), leaving out each factor the reference
    finds exactly zero; the program's norms of those under "zero"."""
    prog = {**out, "factors": {}, "eig": {}, "zero": []}
    factors, vals = {}, {}
    for name, fr in ref["factors"].items():
        for i, Fr in enumerate(fr):
            Fp = out["factors"][name][i]
            if not bool(Fr.any()):
                prog["zero"].append(float(torch.linalg.norm(Fp)))
                continue
            key = f"{name}[{i}]"
            prog["factors"][key], prog["eig"][key] = (Fp,), (out["eig"][name][i],)
            factors[key], vals[key] = (Fr,), (ref["vals"][name][i],)
    return prog, factors, vals
