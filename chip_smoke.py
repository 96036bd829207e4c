#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`laplace_jax_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failed check exits non-zero:

1. device  - the card's name and power limit (`nvidia-smi`);
2. build   - compiles both CUDA kernels from `laplace_jax_torch/csrc/`;
3. kernels - each LATRD panel kernel at a real ResNet-18 factor class
             (v1 at (4, 1152), v4 at (3, 4608), float32) against its plain
             PyTorch version on the same inputs, and the whole
             `eigh_stack_ts` through that kernel against `torch.linalg.eigh`;
4. reference - a width-8 ResNet-18 KFAC fit in float64 on the card (its
             576 class runs the v1 kernel) against the same fit on the CPU,
             where the port decomposes with LAPACK;
5. main    - the main path at full width: `KronLaplace` on ResNet-18
             (width 64, 10 classes, 11.16M weights) over 512 CIFAR-10-shaped
             inputs in batches of 128, marglik prior tuning, and the GLM
             probit predictive on 8 inputs, with both kernels' launch counts
             read from this run.

Then the kernel summary line, the `nvidia-smi` line, and last
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside the
repository checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PANEL_TOL = 1e-4  # float32 panel: max |kernel - plain| / max |plain| per output
STAGE1_TOL = 3e-5  # stage-1 spectrum: max |eig(T) - eig(A)| / max |eig(A)|
# (the JAX package's oracle, laplace_jax/ops/latrd_pallas_v4.py:50-51)
EIG_TOL = 1e-4  # whole float32 solver vs float64 eigvalsh, relative to the
# largest eigenvalue: at (3, 4608) this script has read 5.5e-6 and, in one
# run, 3.6e-5 (stage 2's float32 secular solve on that run's tridiagonal;
# v4's atomics change it from run to run); n * eps32 * ||A|| is 2.7e-4
RECON_TOL = 1e-4  # ||Q L Q^T - A|| / ||A|| and max |Q^T Q - I| in float32

KERNELS = [  # (name, module, lib, source, TPU kernel replaced, K, n)
    ("latrd_panel", "latrd", "laplace_jax_torch/csrc/latrd.cu",
     "laplace_jax/ops/latrd_pallas.py:250", 4, 1152),
    ("latrd_panel_v4", "latrd_v4", "laplace_jax_torch/csrc/latrd_v4.cu",
     "laplace_jax/ops/latrd_pallas_v4.py:319", 3, 4608),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` over `reps` runs, by CUDA events, after
    one warm-up run."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def sym_stack(K: int, n: int, gen, device, dtype):
    import torch

    A = torch.randn(K, n, n, generator=gen, device=device, dtype=dtype)
    return (A + A.mT) / 2


def panel_bound_ms(K: int, m: int, nb: int, itemsize: int, flops_peak: float):
    """Least time for one panel: the window read once and U/W written once,
    against the trailing matvecs and the U/W products it computes."""
    nbytes = K * m * m * itemsize + K * (2 * nb * m + 3 * nb) * itemsize
    flops = sum(2 * K * (m - c - 1) ** 2 + 12 * K * c * m for c in range(nb))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(name, module, source, replaces, K, n, seed, device):
    import importlib

    import torch

    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    mod = importlib.import_module(f"laplace_jax_torch.ops.{module}")
    kernel, plain = getattr(mod, name), getattr(mod, f"{name}_plain")
    driver = mod.tridiagonalize_latrd if module == "latrd" else mod.tridiagonalize_latrd_v4
    gen = torch.Generator(device=device).manual_seed(seed)
    A = sym_stack(K, n, gen, device, torch.float32)
    nb = 64

    # one panel at the first window, kernel vs plain on the same inputs
    got = kernel(A, 0, 0, n, nb)
    ref = plain(A, 0, 0, n, nb)
    torch.cuda.synchronize()
    errs = {}
    for key, g, r in (("U", got[0][:, :nb], ref[0][:, :nb]), ("W", got[0][:, nb:], ref[0][:, nb:]),
                      ("d", got[1][:, 0], ref[1][:, 0]), ("e", got[1][:, 1], ref[1][:, 1]),
                      ("tau", got[1][:, 2], ref[1][:, 2])):
        errs[key] = float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
    max_abs_err = float(max((g - r).abs().max() for g, r in zip(got, ref)))
    for key, err in errs.items():
        check(err <= PANEL_TOL, f"{name} panel {key}: relative error {err:.3e} > {PANEL_TOL}")

    ms = cuda_ms(lambda: kernel(A, 0, 0, n, nb), reps=5)
    plain_ms = cuda_ms(lambda: plain(A, 0, 0, n, nb), reps=2)
    bound_ms, bound_by = panel_bound_ms(K, n, nb, 4, F32_FLOPS)
    library_ms = cuda_ms(lambda: torch.linalg.eigh(A), reps=1)
    stage1_ms = cuda_ms(lambda: driver(A, nb=nb), reps=1)
    d, e = driver(A, nb=nb)[:2]
    T = torch.diag_embed(d.double()) + torch.diag_embed(e.double(), 1) + torch.diag_embed(e.double(), -1)

    # the whole two-stage solver through this kernel against torch.linalg.eigh
    launches0 = kernel.launches
    lam, Q = eigh_stack_ts(A, device=device)
    torch.cuda.synchronize()
    check(kernel.launches > launches0, f"eigh_stack_ts at n={n} did not launch {name}")
    ts_ms = cuda_ms(lambda: eigh_stack_ts(A, device=device), reps=1)
    lam_ref = torch.linalg.eigvalsh(A.double())
    stage1_err = float((torch.linalg.eigvalsh(T) - lam_ref).abs().max() / lam_ref.abs().max())
    eig_err = float((lam.double() - lam_ref).abs().max() / lam_ref.abs().max())
    Qd, Ad = Q.double(), A.double()
    recon = float(torch.linalg.norm(Qd @ torch.diag_embed(lam.double()) @ Qd.mT - Ad) / torch.linalg.norm(Ad))
    orth = float((Qd.mT @ Qd - torch.eye(n, device=device, dtype=torch.float64)).abs().max())
    check(stage1_err <= STAGE1_TOL, f"{name}: stage-1 spectrum error {stage1_err:.3e} > {STAGE1_TOL}")
    check(eig_err <= EIG_TOL, f"{name}: eigenvalue error {eig_err:.3e} > {EIG_TOL}")
    check(recon <= RECON_TOL, f"{name}: reconstruction {recon:.3e} > {RECON_TOL}")
    check(orth <= RECON_TOL, f"{name}: orthogonality {orth:.3e} > {RECON_TOL}")

    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               shape=[K, n, n], nb=nb, dtype="float32", max_abs_err=max_abs_err,
               rel_err=errs, panel_tol=PANEL_TOL, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library_call="torch.linalg.eigh on the whole stack (yardstick only)",
               stage1_ms=stage1_ms, ts_ms=ts_ms, stage1_spectrum_err=stage1_err, eig_rel_err=eig_err,
               recon_rel_err=recon, orth_err=orth)
    emit(dict(phase="kernel", **row))
    return row


def reference_phase(seed, device):
    """A width-8 fit in float64: on the card (the 576 factor class runs the
    v1 kernel) and on the CPU (LAPACK eigh), same weights and data."""
    import numpy as np
    import torch

    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((32, 16, 16, 3))
    y = rng.integers(0, 10, 32)
    net = ResNet18(width=8, generator=torch.Generator().manual_seed(seed)).double()
    out = {}
    for dev in ("cpu", device):
        la = KronLaplace(net, "classification", device=dev)
        la.fit(ArrayLoader(X, y, batch_size=16))
        out[str(dev)] = (float(la.log_marginal_likelihood()), la(X[:4]).cpu().numpy(),
                         la.H._flat_eigs.cpu().numpy())
    (l_c, p_c, e_c), (l_g, p_g, e_g) = out["cpu"], out[str(device)]
    res = dict(phase="reference", lml_cpu=l_c, lml_gpu=l_g, lml_rel_err=abs(l_g - l_c) / abs(l_c),
               pred_max_err=float(np.abs(p_g - p_c).max()),
               eig_rel_err=float(np.abs(e_g - e_c).max() / np.abs(e_c).max()),
               v1_launched=latrd_panel.launches > 0)
    emit(res)
    check(res["v1_launched"], "reference fit did not run the v1 kernel")
    check(res["lml_rel_err"] <= 1e-8, "reference: marglik disagrees with the CPU fit")
    check(res["pred_max_err"] <= 1e-8, "reference: predictive disagrees with the CPU fit")
    check(res["eig_rel_err"] <= 1e-9, "reference: eigenvalues disagree with the CPU fit")


def main_path(seed, device):
    import numpy as np
    import torch

    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.ops.latrd_v4 import latrd_panel_v4
    from laplace_jax_torch.utils import matrix
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((512, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=512)
    loader = ArrayLoader(X, y, batch_size=128)
    net = ResNet18(width=64, num_classes=10, generator=torch.Generator().manual_seed(seed))

    la = KronLaplace(net, "classification", device=device)
    torch.cuda.reset_peak_memory_stats()
    latrd_panel.launches = latrd_panel_v4.launches = 0
    retries0 = matrix.SYMEIG_RETRIES
    t0 = time.perf_counter()
    la.fit(loader)
    fit_s = time.perf_counter() - t0
    launches = {"latrd_panel": latrd_panel.launches, "latrd_panel_v4": latrd_panel_v4.launches}
    retries = matrix.SYMEIG_RETRIES - retries0
    lml = float(la.log_marginal_likelihood())
    sizes = sorted({int(H.shape[0]) for F in la.H_facs.kfacs for H in F})

    # the kernels' factors against torch.linalg.eigh in float64, per class
    worst = 0.0
    for n in (s for s in sizes if s >= 512):
        facs = [(gi, fi) for gi, F in enumerate(la.H_facs.kfacs)
                for fi, H in enumerate(F) if H.shape[0] == n]
        for gi, fi in facs:
            ref = torch.linalg.eigvalsh(la.H_facs.kfacs[gi][fi].double()).clamp(min=0)
            got = la.H.eigenvalues[gi][fi].double()
            worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))

    t0 = time.perf_counter()
    la.optimize_prior_precision(method="marglik", n_steps=100)
    torch.cuda.synchronize()
    marglik_s = time.perf_counter() - t0
    pp = float(la.prior_precision[0])

    X_test = rng.standard_normal((8, 32, 32, 3)).astype(np.float32)
    t0 = time.perf_counter()
    probs = la(X_test)
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    row_err = float((probs.sum(-1) - 1).abs().max())

    res = dict(phase="main", model="ResNet18(width=64, num_classes=10)", n_params=la.n_params,
               n_data=512, batch=128, dtype="float32", fit_s=fit_s,
               accumulate_s=la.fit_seconds["accumulate"], decompose_s=la.fit_seconds["decompose"],
               launches=launches, symeig_retries=retries, factor_sizes=sizes,
               eig_rel_err_vs_eigh=worst, log_marglik=lml, marglik_100_steps_s=marglik_s,
               prior_precision=pp, predictive_s=pred_s, predictive_shape=list(probs.shape),
               predictive_row_sum_err=row_err,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit(res)
    check(la.n_params == 11_164_362, f"ResNet-18 has {la.n_params} weights, not 11164362")
    check(all(v > 0 for v in launches.values()), f"a kernel did not run on the main path: {launches}")
    check(retries == 0, f"{retries} factors needed the symeig retry")
    check(worst <= EIG_TOL, f"main-path eigenvalues off by {worst:.3e} > {EIG_TOL}")
    check(math.isfinite(lml), "log marginal likelihood is not finite")
    check(math.isfinite(pp) and pp > 0, f"tuned prior precision {pp}")
    check(tuple(probs.shape) == (8, 10) and bool(torch.isfinite(probs).all()),
          "predictive has the wrong shape or is not finite")
    check(row_err <= 1e-5, f"predictive rows sum to 1 only within {row_err:.3e}")
    return launches


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device is available")
    root = Path(__file__).resolve().parent
    if not (root / "laplace_jax_torch" / "csrc").is_dir():
        fail("run from the repository checkout (laplace_jax_torch/ not found)")
    sys.path.insert(0, str(root))
    device = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    emit(dict(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
              count=torch.cuda.device_count(), torch=torch.__version__,
              cuda=torch.version.cuda))

    from laplace_jax_torch.ops import _build
    from laplace_jax_torch.utils.device import full_f32_matmuls

    full_f32_matmuls()
    build_s = _build.build_all()
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in _build.SOURCES}
    emit(dict(phase="build", seconds=build_s, ptxas=ptxas))

    rows = [kernel_phase(name, mod, src, rep, K, n, args.seed, device)
            for name, mod, src, rep, K, n in KERNELS]
    reference_phase(args.seed, device)
    launches = main_path(args.seed, device)

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [dict({k: r[k] for k in keys}, launches=launches[r["name"]])
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
