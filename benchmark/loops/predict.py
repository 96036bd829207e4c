"""Sweeps of predictive calls over a test set, sent ahead: the `predict` loop.

Set-up builds the posterior a user serves: `Laplace(net, likelihood,
subset_of_weights, hessian_structure)`, `.fit` on `fit_n` inputs in
batches of `fit_batch`, then `.optimize_prior_precision` with the mix's
`tune` arguments. The test set, `test_n` inputs from the seed, stays on
the host, in page-locked memory where the device is a card, as a
`DataLoader(pin_memory=True)` holds it. One caller sweeps it in batches
of `batch_size` (the last batch holds the rest), again and again until
the window ends, as `torch.cat([la(x) for x in loader])` does: each call
copies its batch to the device without blocking and calls `la(x,
pred_type, link_approx)`; the caller waits for a sweep's probabilities
only `ahead_sweeps` sweeps later, so the card stays fed while the host
stands still (as far as the card's queue of launches reaches).

End to end: `predict_inputs_per_s`, the inputs of every call sent in the
window over the span from the first call's start to the moment all of
them are done: when `seconds` have passed the caller sends nothing more,
waits for everything sent, and reads the clock after that wait.

The check: the set-up's posterior (its KFAC factors and their
eigenpairs) and the probabilities of `check_calls` of the window's calls,
drawn from the seed, against the plain reference, which fits, tunes its
own prior and predicts again from the same weights and inputs and takes
nothing the program made. The tuned prior is held through the
probabilities: its float32 value turns on how a solver rounds the
factors' null eigenvalues (dead features in A, the softmax's null vector
in B), which no limit separates from TF32.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import harness, judge
from benchmark.loops.fit import program_groups
from benchmark.reference import kfac, posterior
from benchmark.reference.layers import Ops, tf32
from benchmark.weights import build_model, make_inputs, make_weights, stream_seed


class Loop:
    def __init__(self, config: dict, traffic: dict, seed: int, device, forward):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.forward = forward
        self.attempted = self.failed = 0

    def setup(self) -> None:
        from laplace_jax_torch import Laplace
        from laplace_jax_torch.utils.data import ArrayLoader

        t = self.traffic
        self.weights = make_weights(self.config, self.seed, self.device)
        self.net = build_model(self.config, self.weights, self.device)
        X, y = make_inputs(self.config, t["fit_n"], self.seed, "fit_inputs", self.device)
        self.Xf, self.yf = X.cpu(), y.cpu()
        Xt, _ = make_inputs(self.config, t["test_n"], self.seed, "test_inputs", self.device)
        self.Xt = Xt.cpu()
        if self.device.type == "cuda":
            self.Xt = self.Xt.pin_memory()
        del X, y, Xt
        self.la = Laplace(self.net, t["likelihood"], subset_of_weights=t["subset_of_weights"],
                          hessian_structure=t["hessian_structure"], device=self.device)
        self.la.fit(ArrayLoader(self.Xf, self.yf, batch_size=t["fit_batch"]))
        self.la.optimize_prior_precision(**t["tune"])
        B = t["batch_size"]
        self.starts = list(range(0, t["test_n"], B))
        for s in sorted({self.starts[0], self.starts[-1]}):  # every batch size the window sends
            self.call(s)
        harness.sync(self.device)

    def call(self, start: int) -> torch.Tensor:
        xb = self.Xt[start:start + self.traffic["batch_size"]].to(self.device, non_blocking=True)
        return self.la(xb, pred_type=self.traffic["pred_type"],
                       link_approx=self.traffic["link_approx"])

    def window(self, seconds: float) -> dict:
        nb = len(self.starts)
        self.kept = harness.Reservoir(self.traffic["check_calls"],
                                      np.random.default_rng(stream_seed(self.seed, "check")))
        self.n_inputs = 0
        bad = torch.zeros((), dtype=torch.int64, device=self.device)
        marks = []  # an event where each sweep ends
        ahead = self.traffic["ahead_sweeps"]  # the caller waits this many sweeps late

        def step(i):
            nonlocal bad
            start = self.starts[i % nb]
            p = self.call(start)
            self.n_inputs += p.shape[0]
            self.kept.offer((start, p))
            bad = bad + (~torch.isfinite(p).all()).long()
            if i % nb == nb - 1:
                marks.append(harness.mark(self.device))
                if len(marks) > ahead:
                    marks[-1 - ahead].synchronize()

        start, end, n = harness.ahead_loop(seconds, step, self.device)
        self.attempted = n
        self.failed = int(bad)
        self.span_s = end - start
        self.sweep_s = [a.elapsed_time(b) / 1e3 for a, b in zip(marks, marks[1:])]
        self.next_call = n
        return {"predict_inputs_per_s": self.n_inputs / self.span_s}

    def trace_units(self):
        """(run n units, units per trace): whole sweeps of the test set."""
        nb = len(self.starts)

        def run(n):
            for _ in range(n * nb):
                self.call(self.starts[self.next_call % nb])
                self.next_call += 1
            harness.sync(self.device)

        return run, self.traffic["trace_sweeps"]

    def layer_stats(self) -> dict:
        return {"n_inputs": self.n_inputs, "span_s": self.span_s}

    def units(self) -> dict:
        """The card's seconds for each whole sweep of the window after the
        first (between the events where sweeps end)."""
        return {"sweep": self.sweep_s}

    def program_outputs(self) -> dict:
        facs, eig = program_groups(self.la)
        return {"factors": facs, "eig": eig,
                "calls": sorted(self.kept.items, key=lambda c: c[0])}

    def free(self) -> None:
        del self.kept, self.la, self.net
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _features(self, w: dict, X: torch.Tensor, dtype):
        """Logits and head features of host inputs X, in batches."""
        fs, phis = [], []
        for s in range(0, X.shape[0], self.traffic["reference_batch"]):
            x = X[s:s + self.traffic["reference_batch"]].to(self.device, dtype)
            f, phi = self.forward(Ops(w, self.config["layers"]), x)
            fs.append(f)
            phis.append(phi)
        return torch.cat(fs), torch.cat(phis)

    def solve(self, starts: list, dtype, control: bool = False, band: bool = False) -> dict:
        """The head's factors from the fit inputs, their eigenpairs, the
        prior precision tuned on them as the mix's `tune` says, and the
        probit probabilities of the test batches at `starts` under that
        posterior, all computed in `dtype` (with `control`, TF32 allowed).
        With `band`, each call's probabilities are a range `(lo, hi)`: from
        B's null eigenvalue at 0 to B's largest times the machine epsilon of
        the configuration's dtype (`posterior.lift_null`)."""
        t, head = self.traffic, self.config["layers"][-1]
        w = {k: v.to(dtype) for k, v in self.weights.items()}
        with torch.no_grad(), tf32(control):
            f, phi = self._features(w, self.Xf, dtype)
            groups = kfac.groups({head["name"]: kfac.last_layer_factors(phi, f)}, [head])
            eig = {k: tuple((l.clamp(min=0.0), Q) for l, Q in map(torch.linalg.eigh, fs))
                   for k, fs in groups.items()}
            vals = {k: tuple(l for l, _ in e) for k, e in eig.items()}
            loss = kfac.cross_entropy_sum(f, self.yf.to(self.device))
            theta_sq = sum((w[k] ** 2).sum() for k in groups)
            tune = t["tune"]
            with torch.enable_grad():
                delta = posterior.tune_prior(loss, vals, theta_sq, tune["n_steps"], tune["lr"],
                                             tune.get("init_prior_prec", 1.0))
            eigs = [eig]
            if band:
                eps = torch.finfo(getattr(torch, self.config["dtype"])).eps
                eigs.append(posterior.lift_null(eig, head["name"], eps))
            Sigmas = [posterior.ll_covariance(e, head["name"], delta, dtype) for e in eigs]
            calls = []
            for s in starts:
                fb, phib = self._features(w, self.Xt[s:s + t["batch_size"]], dtype)
                ps = [posterior.ll_probit(fb, phib, S, head["bias"]) for S in Sigmas]
                calls.append((s, (torch.minimum(*ps), torch.maximum(*ps)) if band else ps[0]))
        return {"factors": groups, "vals": vals, "eig": eig, "calls": calls}

    def reference(self, outputs: dict) -> dict:
        """The float64 reference: its own factors, eigenpairs, tuned prior
        and, at the judged side's sampled calls, the range of probabilities
        that B's null eigenvalue leaves open to the configuration's dtype."""
        return self.solve([s for s, _ in outputs["calls"]], torch.float64, band=True)

    def control_outputs(self, outputs: dict) -> dict:
        """The reference in the program's place, one precision below the
        configuration's: float32 with TF32 on."""
        return self.solve([s for s, _ in outputs["calls"]], torch.float32, control=True)

    def compare(self, outputs: dict, ref: dict) -> dict:
        return {"factor_err": judge.factor_err(outputs["factors"], ref["factors"]),
                "eig_err": judge.eig_err(outputs["eig"], ref["vals"]),
                "eig_resid": judge.eig_resid(outputs["eig"], ref["factors"]),
                "probs_err": judge.band_gap([p for _, p in outputs["calls"]],
                                            [b for _, b in ref["calls"]])}

