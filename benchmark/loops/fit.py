"""Back-to-back posterior fits: the `fit` loop.

Each fit is a user's whole call: `Laplace(net, likelihood,
subset_of_weights, hessian_structure)` and `.fit(loader)` on its own
`n_per_fit` inputs and labels, which a host loader of `batch_size` copies
to the card batch by batch. The inputs are drawn from the seed before the
window: `input_sets` sets, used in turn, and one more for the warm-up fit.

End to end: `fit_s`, the span from the first fit's start to the last
fit's synchronised end over the number of fits, where the last fit is the
last one started before `seconds` had passed.

The check: `check_fits` of the window's fits, drawn from the seed, are
compared with the plain reference on the same weights and inputs: every
KFAC factor, every factor's eigenvalues and eigenpairs, and the summed
loss, the data term of the log marginal likelihood (its log determinant
is the eigenvalues', its prior terms the weights').
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, judge
from benchmark.reference import kfac, posterior
from benchmark.reference.layers import tf32
from benchmark.weights import build_model, make_inputs, make_weights, stream_seed


def program_groups(la) -> tuple:
    """({parameter name: factors}, {parameter name: ((eigenvalues,
    eigenvectors) per factor)}) of a fitted KFAC posterior, by the leaf
    names of its flattening."""
    names = [s.name for s in la.model.leaf_specs]
    facs = {n: F for n, F in zip(names, la.H_facs.kfacs, strict=True)}
    eig = {n: tuple(zip(ls, Qs)) for n, ls, Qs in zip(names, la.H.eigenvalues,
                                                       la.H.eigenvectors, strict=True)}
    return facs, eig


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, forward):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.forward = forward
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from laplace_jax_torch.utils.data import ArrayLoader

        if self.device.type == "cuda" and self.traffic.get("build"):
            from laplace_jax_torch.ops import _build

            _build.build_all(self.traffic["build"])
        self.weights = make_weights(self.config, self.seed, self.device)
        self.net = build_model(self.config, self.weights, self.device)
        n, sets = self.traffic["n_per_fit"], self.traffic["input_sets"]
        X, y = make_inputs(self.config, n * (sets + 1), self.seed, "fit_inputs", self.device)
        self.X, self.y = X.cpu(), y.cpu()  # a user's data set lives on the host
        del X, y
        self.loaders = [ArrayLoader(self.X[i * n:(i + 1) * n], self.y[i * n:(i + 1) * n],
                                    batch_size=self.traffic["batch_size"])
                        for i in range(sets + 1)]
        self.fit(self.loaders[sets])  # the warm-up, on a set of its own

    def fit(self, loader):
        from laplace_jax_torch import Laplace

        la = Laplace(self.net, self.traffic["likelihood"],
                     subset_of_weights=self.traffic["subset_of_weights"],
                     hessian_structure=self.traffic["hessian_structure"], device=self.device)
        la.fit(loader)
        harness.sync(self.device)
        return la

    def window(self, seconds: float) -> dict:
        sets = self.traffic["input_sets"]
        self.kept = harness.Reservoir(self.traffic["check_fits"],
                                      np.random.default_rng(stream_seed(self.seed, "check")))
        self.fit_seconds = []

        def step(i):
            la = self.fit(self.loaders[i % sets])
            self.fit_seconds.append(dict(la.fit_seconds))
            self.kept.offer((i % sets, la))

        start, spans = harness.timed_loop(seconds, step)
        self.spans = spans
        self.attempted = len(spans)
        self.fit_s = (spans[-1][1] - start) / len(spans)
        self.next_set = len(spans)
        return {"fit_s": self.fit_s}

    def trace_units(self):
        """(run n units, units per trace): the traced segment's fits, on the
        sets after the window's."""
        sets = self.traffic["input_sets"]

        def run(n):
            for _ in range(n):
                self.fit(self.loaders[self.next_set % sets])
                self.next_set += 1

        return run, self.traffic["trace_fits"]

    def layer_stats(self) -> dict:
        return {"fit_seconds": self.fit_seconds, "fit_s": self.fit_s,
                "n_per_fit": self.traffic["n_per_fit"]}

    def units(self) -> dict:
        """Each window fit's seconds: whole, accumulate, decompose."""
        return {"fit": [[t1 - t0, f["accumulate"], f["decompose"]]
                        for (t0, t1), f in zip(self.spans, self.fit_seconds)]}

    def program_outputs(self) -> list:
        out = []
        for s, la in self.kept.items:
            facs, eig = program_groups(la)
            out.append({"set": s, "factors": facs, "eig": eig, "loss": float(la.loss)})
        return out

    def free(self) -> None:
        """Drop the program's state but the kept fits' outputs."""
        del self.kept, self.net
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def solve(self, s: int, dtype, control: bool = False) -> dict:
        """The reference on fit set `s`: factors, eigenvalues (and with
        `control`, eigenpairs in the program's layout) and the summed loss,
        computed in `dtype`, with TF32 allowed only for the control."""
        n = self.traffic["n_per_fit"]
        w = {k: v.to(dtype) for k, v in self.weights.items()}
        with tf32(control):
            factors, loss = kfac.kfac_factors(self.forward, w, self.config["layers"],
                                              self.X[s * n:(s + 1) * n],
                                              self.y[s * n:(s + 1) * n],
                                              self.traffic["reference_batch"])
            groups = kfac.groups(factors, self.config["layers"])
            if control:
                eig = {k: tuple(torch.linalg.eigh(F) for F in fs) for k, fs in groups.items()}
                eig = {k: tuple((l.clamp(min=0.0), Q) for l, Q in e) for k, e in eig.items()}
                vals = {k: tuple(l for l, _ in e) for k, e in eig.items()}
            else:
                vals = posterior.eigvals(groups)
                eig = None
        return {"set": s, "factors": groups, "vals": vals, "eig": eig, "loss": float(loss)}

    def reference(self, outputs: list) -> list:
        return [self.solve(o["set"], torch.float64) for o in outputs]

    def control_outputs(self, outputs: list) -> list:
        """The reference in the program's place, one precision below the
        configuration's: float32 with TF32 on."""
        out = []
        for o in outputs:
            r = self.solve(o["set"], torch.float32, control=True)
            out.append({"set": r["set"], "factors": r["factors"], "eig": r["eig"],
                        "loss": r["loss"]})
        return out

    def compare(self, outputs: list, refs: list) -> dict:
        worst = {"factor_err": 0.0, "eig_err": 0.0, "eig_resid": 0.0, "loss_err": 0.0}
        for o, r in zip(outputs, refs, strict=True):
            got = {"factor_err": judge.factor_err(o["factors"], r["factors"]),
                   "eig_err": judge.eig_err(o["eig"], r["vals"]),
                   "eig_resid": judge.eig_resid(o["eig"], r["factors"]),
                   "loss_err": judge.rel_err(o["loss"], r["loss"])}
            worst = {k: judge.worse(v, got[k]) for k, v in worst.items()}
        return worst

