#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`laplace_jax_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line; any failed check exits non-zero:

1. device  - the card's name and power limit (`nvidia-smi`);
2. build   - compiles every CUDA kernel from `laplace_jax_torch/csrc/`,
             one `nvcc` per source, all at once; prints each kernel's
             registers and spills, and v1's shared memory at (4, 1152);
3. kernels - each LATRD panel kernel at a real ResNet-18 factor class
             (v1 and v2 at (4, 1152), v4 and v3 at (3, 4608), float32)
             against its plain PyTorch version on the same inputs, v3 and
             v1 also against themselves (bitwise), and the whole
             `eigh_stack_ts` through that kernel against `torch.linalg.eigh`;
             v1 also on a (17, 128) window at offset 64 (7 blocks a window
             of 9 or 10 rows, next to no work a column), the cost of its
             2 nb grid barriers and phase latencies; v3 (one cooperative
             launch a panel, every sum in one fixed order) also at (4, 1152)
             in float32 and at both shapes in float64, each bitwise over two
             launches, against its plain version and timed (`by_shape`);
             v4 and v3 also with `stream_bound_ms`, the time the trailing
             triangle's tiles that stay off chip take to stream from HBM
             every column;
             the syrk kernel against `syrk_plain`, bitwise over two
             launches and exactly symmetric, at the last-layer GGN shape
             (1280, 5130) and at (1280, 5131) (P odd: 4-byte copies) in
             float32, and at (1280, 5130) and (37, 130) in float64, each
             timed; its ptxas registers and spills, its bound fraction;
4. reference - width-8 ResNet-18 fits in float64 on the card against the
             same fits on the CPU: all-weights KFAC (its 576 class runs the
             v1 kernel; LAPACK on the CPU) and last-layer Full (the float64
             syrk kernel; the einsum on the CPU);
5. main    - the main path at full width: `KronLaplace` on ResNet-18
             (width 64, 10 classes, 11.16M weights) over 512 CIFAR-10-shaped
             inputs in batches of 128, marglik prior tuning, and the GLM
             probit predictive on 8 inputs, with both LATRD kernels' launch
             counts read from this run (35 v1, 108 v4) and every panel it
             launched tallied by (K, m, off); the TF32 switches must read
             as they did before the fit (the port scopes its own);
   windows - each panel the main path launched, on a random window of its
             (K, m) at its offset, timed 5 times with CUDA events: the v4
             and v1 rows gain `ms_by_window` and `main_path_ms` (the sum
             over the main path's launches);
6. last_layer - last-layer Laplace on the same network and data: the
             default `Laplace(net, "classification")` (KronLL, v1 kernel),
             FullLL (the syrk kernel, 4 launches; its GGN against a float64
             one; marglik tuning; probit predictive; 100 GLM predictive
             samples on 128 inputs) and DiagLL (against FullLL's diagonal),
             each kernel's launches read from its own fit; a second FullLL
             fit under `torch.profiler` gives the device time of its syrk
             launches (`full_syrk_ms`, syrk's `main_path_ms`);
7. eigensolvers - on the same network and data, the pooled spectral D&C
             through the user's entry point (`EIGH_IMPLEMENTATION = "dc"`,
             a second `KronLaplace` fit) against float64 `eigvalsh` and the
             `main` phase's marglik; every factor class n >= 512 of that fit
             through `eigh_stack_ts` with the v3 and then the v2 kernel
             (their launches read here, every panel tallied by (K, m,
             off)); and a float64 (2, 576) D&C on the card against the same
             call on the CPU;
   route_windows - each panel of the v3 and v2 runs, timed as in
             `windows`: the v3 and v2 rows gain `ms_by_window` and
             `route_ms`.

Then the kernel summary line (with `main_path_ms`, `route_ms` and
`stream_bound_ms` where measured), the `nvidia-smi` line, and last
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside the
repository checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores
PANEL_TOL = 1e-4  # float32 panel: max |kernel - plain| / max |plain| per output
STAGE1_TOL = 3e-5  # stage-1 spectrum: max |eig(T) - eig(A)| / max |eig(A)|
# (the JAX package's oracle, laplace_jax/ops/latrd_pallas_v4.py:50-51)
EIG_TOL = 1e-4  # whole float32 solver vs float64 eigvalsh, relative to the
# largest eigenvalue: at (3, 4608) this script has read 5.5e-6 and, in one
# run, 3.6e-5 (stage 2's float32 secular solve on that run's tridiagonal;
# v4's atomics change it from run to run); n * eps32 * ||A|| is 2.7e-4
RECON_TOL = 1e-4  # ||Q L Q^T - A|| / ||A|| and max |Q^T Q - I| in float32
# syrk kernel vs syrk_plain, max |kernel - plain| / max |plain|: float32
# sums up to 1280 products per entry in another order; float64 likewise
SYRK_TOL = {"float32": 1e-4, "float64": 1e-10}
# the main-path shape first (8-byte copies), then P odd (4-byte copies),
# float64 at the main-path shape and a ragged float64 shape
SYRK_SHAPES = [((1280, 5130), "float32"), ((1280, 5131), "float32"), ((1280, 5130), "float64"),
               ((37, 130), "float64")]
GGN_TOL = 1e-4  # FullLL float32 H vs the float64 GGN, relative to its largest entry
DIAG_TOL = 1e-5  # DiagLL H vs diag(FullLL H), relative to its largest entry

DC_LML_TOL = 1e-4  # dc fit's marglik vs the main (ts) fit's, relative
DC_F64_TOL = 1e-9  # float64 D&C on the card vs on the CPU, same draws

KERNELS = [  # (name, module, stage-1 driver and name, source, TPU kernel replaced, K, n)
    ("latrd_panel", "latrd", "tridiagonalize_latrd", "latrd",
     "laplace_jax_torch/csrc/latrd.cu", "laplace_jax/ops/latrd_pallas.py:250", 4, 1152),
    ("latrd_panel_v4", "latrd_v4", "tridiagonalize_latrd_v4", "latrd_v4",
     "laplace_jax_torch/csrc/latrd_v4.cu", "laplace_jax/ops/latrd_pallas_v4.py:319", 3, 4608),
    ("latrd_panel_v3", "latrd_v3", "tridiagonalize_latrd_v3", "latrd_v3",
     "laplace_jax_torch/csrc/latrd_v3.cu", "laplace_jax/ops/latrd_pallas_v3.py:283", 3, 4608),
    ("latrd_panel_v2", "latrd_v2", "tridiagonalize_latrd_v2", "latrd_v2",
     "laplace_jax_torch/csrc/latrd_v2.cu", "laplace_jax/ops/latrd_pallas_v2.py:262", 4, 1152),
]
BITWISE = {"latrd_panel_v3", "latrd_panel"}  # kernels whose two launches agree bit for bit
MAIN_LAUNCHES = {"latrd_panel": 35, "latrd_panel_v4": 108}  # panels of one all-weights fit


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


def panel_bound_ms(K: int, m: int, nb: int, itemsize: int, flops_peak: float, off: int = 0):
    """Least time for one panel: the window read once and U/W written once,
    against the trailing matvecs and the U/W products it computes."""
    nbytes = K * m * m * itemsize + K * (2 * nb * m + 3 * nb) * itemsize
    flops = sum(2 * K * (m - off - j - 1) ** 2 + 12 * K * j * m for j in range(nb))
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flops_peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def stream_bound_ms(K: int, m: int, off: int, nb: int, itemsize: int, n_res: int, table,
                    n_cta: int) -> float:
    """Least time for one panel of a persistent symmetric-half kernel (v4,
    v3) whose window does not fit on the chip: each column c reads the
    trailing lower-triangle 64x64 tiles (tile column >= (c+1)//64) from
    device memory at its rate, less the `n_res` tiles each block of the
    plan's schedule `table` keeps in shared memory (a full window)."""
    import torch

    offsets, codes = table[: n_cta + 1].long(), table[n_cta + 1 :].long()
    runs = offsets[1:] - offsets[:-1]
    pos = torch.arange(codes.numel()) - torch.repeat_interleave(offsets[:-1], runs)
    s, streamed = codes & 1023, pos >= n_res
    tiles = sum(int((streamed & (s >= (off + j + 1) // 64)).sum()) for j in range(nb))
    return 1e3 * tiles * 64 * 64 * itemsize / HBM_BYTES_PER_S


def kernel_phase(name, module, driver, stage1, source, replaces, K, n, seed, device):
    import importlib

    import torch

    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    mod = importlib.import_module(f"laplace_jax_torch.ops.{module}")
    kernel, plain, driver = getattr(mod, name), getattr(mod, f"{name}_plain"), getattr(mod, driver)
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
    again = kernel(A, 0, 0, n, nb)
    torch.cuda.synchronize()
    bitwise = all(bool(torch.equal(g, r)) for g, r in zip(got, again))
    check(bitwise or name not in BITWISE, f"{name}: two launches on one window differ")

    ms = cuda_ms(lambda: kernel(A, 0, 0, n, nb), reps=5)
    plain_ms = cuda_ms(lambda: plain(A, 0, 0, n, nb), reps=2)
    bound_ms, bound_by = panel_bound_ms(K, n, nb, 4, F32_FLOPS)
    library_ms = cuda_ms(lambda: torch.linalg.eigh(A), reps=1)
    stage1_ms = cuda_ms(lambda: driver(A, nb=nb), reps=1)
    d, e = driver(A, nb=nb)[:2]
    T = torch.diag_embed(d.double()) + torch.diag_embed(e.double(), 1) + torch.diag_embed(e.double(), -1)

    # the whole two-stage solver through this kernel against torch.linalg.eigh
    launches0 = kernel.launches
    lam, Q = eigh_stack_ts(A, stage1=stage1, device=device)
    torch.cuda.synchronize()
    check(kernel.launches > launches0, f"eigh_stack_ts at n={n} did not launch {name}")
    ts_ms = cuda_ms(lambda: eigh_stack_ts(A, stage1=stage1, device=device), reps=1)
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

    extra = {}
    if name == "latrd_panel":  # the column chain's floor: barriers and phase latency
        small = sym_stack(17, 128, gen, device, torch.float32)
        floor_ms = cuda_ms(lambda: kernel(small, 64, 0, 128, nb), reps=20)
        extra = dict(chain_floor=dict(shape=[17, 128, 128], off=64, nb=nb, ms=floor_ms,
                                      grid_barriers=2 * nb,
                                      us_per_column=1e3 * floor_ms / nb))
    if name in ("latrd_panel_v4", "latrd_panel_v3"):  # the window streams every column
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        plan = mod.panel_plan(K, n, 0, nb, 4, n_sm)
        extra["stream_bound_ms"] = stream_bound_ms(K, n, 0, nb, 4, plan[0], plan[2], n_sm)
    if name == "latrd_panel_v3":  # bitwise and timed at the other shapes too
        extra["by_shape"] = v3_shapes(kernel, plain, nb, gen, device)
    row = dict(name=name, route="cuda", source=source, replaces=replaces,
               shape=[K, n, n], nb=nb, dtype="float32", max_abs_err=max_abs_err,
               rel_err=errs, panel_tol=PANEL_TOL, repeat_bitwise=bitwise, ms=ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
               library_call="torch.linalg.eigh on the whole stack (yardstick only)",
               stage1=stage1, stage1_ms=stage1_ms, ts_ms=ts_ms, stage1_spectrum_err=stage1_err, eig_rel_err=eig_err,
               recon_rel_err=recon, orth_err=orth, **extra)
    emit(dict(phase="kernel", **row))
    return row


# v3's further shapes: the v1 row's window, and float64 at both; two launches
# must agree bit for bit at each (the float32 (3, 4608) panel is the row's)
V3_SHAPES = [(4, 1152, "float32"), (3, 4608, "float64"), (4, 1152, "float64")]
V3_F64_TOL = 1e-10  # float64 panel vs plain: only the summation order differs


def v3_shapes(kernel, plain, nb, gen, device):
    """The v3 panel at V3_SHAPES: bitwise over two launches, against its
    plain version, timed."""
    import torch

    out = {}
    for K, n, dt in V3_SHAPES:
        A = sym_stack(K, n, gen, device, getattr(torch, dt))
        got, again = kernel(A, 0, 0, n, nb), kernel(A, 0, 0, n, nb)
        ref = plain(A, 0, 0, n, nb)
        torch.cuda.synchronize()
        rel = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
        bitwise = all(bool(torch.equal(g, r)) for g, r in zip(got, again))
        tol = PANEL_TOL if dt == "float32" else V3_F64_TOL
        out[f"{K}x{n}_{dt}"] = dict(ms=cuda_ms(lambda: kernel(A, 0, 0, n, nb), reps=5),
                                    rel_err=rel, tol=tol, repeat_bitwise=bitwise)
        check(bitwise, f"latrd_panel_v3 {dt} ({K}, {n}): two launches on one window differ")
        check(rel <= tol, f"latrd_panel_v3 {dt} ({K}, {n}): relative error {rel:.3e} > {tol}")
        del A, got, again, ref
    return out


def syrk_bound_ms(R: int, P: int, itemsize: int, flops_peak: float):
    """Least time for H = A^T A over the lower half: A read once and H
    written once, against R P (P + 1) flops."""
    t_bytes = (R * P + P * P) * itemsize / HBM_BYTES_PER_S
    t_ops = R * P * (P + 1) / flops_peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ptxas_registers(log: str) -> dict:
    """{kernel: "N registers, S bytes spill stores"} from `-Xptxas -v`."""
    out, name, spill = {}, None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            m = re.search(r"k_([a-z]+)I([fd])Li(\d+)E", name)  # k_syrk<float, V>
            if m:
                name = f"k_{m[1]}<{'float' if m[2] == 'f' else 'double'}, {m[3]}>"
        elif "spill stores" in line:
            spill = line.split(",")[1].strip()
        elif "Used" in line and "registers" in line and name:
            out[name] = f"{line.split('Used ')[1].split(',')[0]}, {spill}"
    return out


def syrk_phase(seed, device, ptxas_log):
    """The syrk kernel against `syrk_plain` on the same inputs, bitwise over
    two launches and exactly symmetric, at the last-layer GGN shape and a
    shape with P odd in float32 and at two float64 shapes; timed at each,
    with the plain version, `torch.mm` and the bound at the first."""
    import torch

    from laplace_jax_torch.ops.syrk import syrk, syrk_plain, syrk_plan

    gen = torch.Generator(device=device).manual_seed(seed)
    row = None
    for (R, P), dt in SYRK_SHAPES:
        dtype = getattr(torch, dt)
        A = torch.randn(R, P, generator=gen, device=device, dtype=dtype)
        got, ref = syrk(A), syrk_plain(A)
        again = syrk(A)
        torch.cuda.synchronize()
        max_abs_err = float((got - ref).abs().max())
        rel = max_abs_err / float(ref.abs().max())
        symmetric = bool(torch.equal(got, got.mT))
        bitwise = bool(torch.equal(got, again))
        plan = syrk_plan(R, P, dtype)
        res = dict(phase="kernel", name="syrk", shape=[R, P], dtype=dt, max_abs_err=max_abs_err,
                   rel_err=rel, tol=SYRK_TOL[dt], exactly_symmetric=symmetric,
                   repeat_bitwise=bitwise, tile=plan.tile, copy_bytes=plan.copy_bytes,
                   blocks=len(plan.tiles), smem_bytes=plan.smem_bytes,
                   ms=cuda_ms(lambda: syrk(A), reps=20))
        check(rel <= SYRK_TOL[dt], f"syrk {dt} {(R, P)}: relative error {rel:.3e} > {SYRK_TOL[dt]}")
        check(symmetric, f"syrk {dt} {(R, P)}: output is not exactly symmetric")
        check(bitwise, f"syrk {dt} {(R, P)}: two launches differ")
        if row is None:
            bound_ms, bound_by = syrk_bound_ms(R, P, A.element_size(),
                                               F32_FLOPS if dt == "float32" else F64_FLOPS)
            res.update(route="cuda", source="laplace_jax_torch/csrc/syrk.cu",
                       replaces="laplace_jax/ops/syrk.py:37",
                       plain_ms=cuda_ms(lambda: syrk_plain(A), reps=20),
                       bound_ms=bound_ms, bound_by=bound_by, bound_fraction=bound_ms / res["ms"],
                       library_ms=cuda_ms(lambda: torch.mm(A.mT, A), reps=20),
                       library_call="torch.mm(A.mT, A), TF32 off",
                       ptxas=ptxas_registers(ptxas_log))
            row = res
        emit(res)
    return row


def reference_phase(seed, device):
    """Width-8 fits in float64: on the card and on the CPU, same weights and
    data. All-weights KFAC (the 576 factor class runs the v1 kernel on the
    card, LAPACK eigh on the CPU) and last-layer Full (the float64 syrk
    kernel on the card, the einsum on the CPU)."""
    import numpy as np
    import torch

    from laplace_jax_torch import FullLLLaplace, KronLaplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.ops.syrk import syrk
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((32, 16, 16, 3))
    y = rng.integers(0, 10, 32)
    net = ResNet18(width=8, generator=torch.Generator().manual_seed(seed)).double()
    out, syrk0 = {}, syrk.launches
    for dev in ("cpu", device):
        la = KronLaplace(net, "classification", device=dev)
        la.fit(ArrayLoader(X, y, batch_size=16))
        ll = FullLLLaplace(net, "classification", device=dev)
        ll.fit(ArrayLoader(X, y, batch_size=16))
        out[str(dev)] = (float(la.log_marginal_likelihood()), la(X[:4]).cpu().numpy(),
                         la.H._flat_eigs.cpu().numpy(),
                         float(ll.log_marginal_likelihood()), ll(X[:4]).cpu().numpy())
    (l_c, p_c, e_c, fl_c, fp_c), (l_g, p_g, e_g, fl_g, fp_g) = out["cpu"], out[str(device)]
    res = dict(phase="reference", lml_cpu=l_c, lml_gpu=l_g, lml_rel_err=abs(l_g - l_c) / abs(l_c),
               pred_max_err=float(np.abs(p_g - p_c).max()),
               eig_rel_err=float(np.abs(e_g - e_c).max() / np.abs(e_c).max()),
               v1_launched=latrd_panel.launches > 0,
               full_ll_lml_cpu=fl_c, full_ll_lml_gpu=fl_g,
               full_ll_lml_rel_err=abs(fl_g - fl_c) / abs(fl_c),
               full_ll_pred_max_err=float(np.abs(fp_g - fp_c).max()),
               syrk_f64_launches=syrk.launches - syrk0)
    emit(res)
    check(res["v1_launched"], "reference fit did not run the v1 kernel")
    check(res["lml_rel_err"] <= 1e-8, "reference: marglik disagrees with the CPU fit")
    check(res["pred_max_err"] <= 1e-8, "reference: predictive disagrees with the CPU fit")
    check(res["eig_rel_err"] <= 1e-9, "reference: eigenvalues disagree with the CPU fit")
    check(res["syrk_f64_launches"] == 2, "reference FullLL fit did not run the float64 syrk kernel")
    check(res["full_ll_lml_rel_err"] <= 1e-8, "reference: FullLL marglik disagrees with the CPU fit")
    check(res["full_ll_pred_max_err"] <= 1e-8,
          "reference: FullLL predictive disagrees with the CPU fit")


def full_width(seed):
    """ResNet-18 (width 64, 10 classes) with random weights from `seed`, 512
    CIFAR-10-shaped inputs with labels in batches of 128, and 128 test
    inputs."""
    import numpy as np
    import torch

    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((512, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=512)
    X_test = rng.standard_normal((128, 32, 32, 3)).astype(np.float32)
    net = ResNet18(width=64, num_classes=10, generator=torch.Generator().manual_seed(seed))
    return net, ArrayLoader(X, y, batch_size=128), X_test


# panel wrapper -> module: the main path's, and those of the eigensolvers
# phase's v3 and v2 route
MAIN_PANELS = {"latrd_panel": "latrd", "latrd_panel_v4": "latrd_v4"}
ROUTE_PANELS = {"latrd_panel_v3": "latrd_v3", "latrd_panel_v2": "latrd_v2"}


def panel_module(name):
    import importlib

    return importlib.import_module(f"laplace_jax_torch.ops.{(MAIN_PANELS | ROUTE_PANELS)[name]}")


class PanelTally:
    """Within `with`, each named panel's stage-1 driver (`tridiagonalize_latrd`,
    `tridiagonalize_latrd_v4` for the main path, `tridiagonalize_latrd_v3`,
    `tridiagonalize_latrd_v2` for the eigensolvers route) hands
    `tridiagonalize_windows` its panel wrapped so that every panel it runs is
    tallied by (K, m, off, nb); the panel wrappers and their launch counts
    are untouched."""

    def __init__(self, names=MAIN_PANELS):
        self.counts = {name: {} for name in names}
        self.inner = {}

    def __enter__(self):
        for name in self.counts:
            mod, tally = panel_module(name), self.counts[name]
            inner = mod.tridiagonalize_windows

            def windows(A, nb, S, panel, inner=inner, tally=tally):
                def counted(Aw, off, q_base, n_real, nb):
                    key = (Aw.shape[0], Aw.shape[1], off, nb)
                    tally[key] = tally.get(key, 0) + 1
                    return panel(Aw, off, q_base, n_real, nb)

                return inner(A, nb, S, counted)

            self.inner[name] = inner
            mod.tridiagonalize_windows = windows
        return self

    def __exit__(self, *exc):
        for name, inner in self.inner.items():
            panel_module(name).tridiagonalize_windows = inner


def tf32_flags():
    """(torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)"""
    import torch

    return [torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32]


def main_path(seed, device):
    import torch

    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.ops.latrd_v4 import latrd_panel_v4
    from laplace_jax_torch.utils import matrix

    net, loader, X_test = full_width(seed)
    la = KronLaplace(net, "classification", device=device)
    torch.cuda.reset_peak_memory_stats()
    latrd_panel.launches = latrd_panel_v4.launches = 0
    retries0 = matrix.SYMEIG_RETRIES
    flags0 = tf32_flags()
    t0 = time.perf_counter()
    with PanelTally() as tally:
        la.fit(loader)
    fit_s = time.perf_counter() - t0
    flags_after_fit = tf32_flags()
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

    t0 = time.perf_counter()
    probs = la(X_test[:8])
    torch.cuda.synchronize()
    pred_s = time.perf_counter() - t0
    row_err = float((probs.sum(-1) - 1).abs().max())
    flags_after = tf32_flags()

    res = dict(phase="main", model="ResNet18(width=64, num_classes=10)", n_params=la.n_params,
               n_data=512, batch=128, dtype="float32", fit_s=fit_s,
               accumulate_s=la.fit_seconds["accumulate"], decompose_s=la.fit_seconds["decompose"],
               launches=launches, symeig_retries=retries, factor_sizes=sizes,
               eig_rel_err_vs_eigh=worst, log_marglik=lml, marglik_100_steps_s=marglik_s,
               prior_precision=pp, predictive_s=pred_s, predictive_shape=list(probs.shape),
               predictive_row_sum_err=row_err, tf32_flags_before=flags0,
               tf32_flags_after_fit=flags_after_fit, tf32_flags_after_tuning_and_predictive=flags_after,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit(res)
    res["panels"] = tally.counts
    check(la.n_params == 11_164_362, f"ResNet-18 has {la.n_params} weights, not 11164362")
    check(launches == MAIN_LAUNCHES, f"main-path launches {launches}, not {MAIN_LAUNCHES}")
    check(flags_after_fit == flags0 and flags_after == flags0,
          f"TF32 switches {flags0} read {flags_after_fit} after the fit, {flags_after} at the end")
    check(all(sum(tally.counts[k].values()) == n for k, n in launches.items()),
          f"panels tallied {tally.counts} against launches {launches}")
    check(retries == 0, f"{retries} factors needed the symeig retry")
    check(worst <= EIG_TOL, f"main-path eigenvalues off by {worst:.3e} > {EIG_TOL}")
    check(math.isfinite(lml), "log marginal likelihood is not finite")
    check(math.isfinite(pp) and pp > 0, f"tuned prior precision {pp}")
    check(tuple(probs.shape) == (8, 10) and bool(torch.isfinite(probs).all()),
          "predictive has the wrong shape or is not finite")
    check(row_err <= 1e-5, f"predictive rows sum to 1 only within {row_err:.3e}")
    return res


def window_phase(rows, panels, seed, device, smi, total="main_path_ms"):
    """Each panel a path launched, timed on a random window of its (K, m) at
    its offset (5 repetitions by CUDA events, float32); the kernel's row
    gains `ms_by_window` and `total`, the sum of launches x ms over the
    path's panels (`main_path_ms` for the main path, `route_ms` for the
    eigensolvers phase's v3 and v2 route)."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    out = dict(phase="windows" if total == "main_path_ms" else "route_windows", nvidia_smi=smi,
               reps=5, dtype="float32")
    for row in rows:
        if row["name"] not in panels:
            continue
        kernel = getattr(panel_module(row["name"]), row["name"])
        by_window, path_ms = {}, 0.0
        for K, m in sorted({(K, m) for K, m, _, _ in panels[row["name"]]},
                           key=lambda w: -w[0] * w[1] ** 2):
            A = sym_stack(K, m, gen, device, torch.float32)
            win = dict(launches=0, ms=0.0)
            for (k2, m2, off, nb), n in sorted(panels[row["name"]].items()):
                if (k2, m2) != (K, m):
                    continue
                ms = cuda_ms(lambda: kernel(A, off, 0, m, nb), reps=5)
                win["launches"] += n
                win["ms"] += n * ms
                if off == 0:
                    win["first_panel_ms"] = ms
            by_window[f"{K}x{m}"] = win
            path_ms += win["ms"]
            del A
        row.update({"ms_by_window": by_window, total: path_ms})
        out[row["name"]] = {"ms_by_window": by_window, total: path_ms}
    emit(out)


def ll_ggn_f64(la, loader):
    """The last-layer GGN in float64, accumulated with `syrk_plain` and
    written out apart from the port's backend: for the Dense head with
    features φ and S S^T the softmax Hessian, the rows M[b, s] are
    [S[s, b], φ_b ⊗ S[s, b]] (bias block first, input-major kernel)."""
    import torch

    from laplace_jax_torch.ops.syrk import syrk_plain
    from laplace_jax_torch.utils.device import full_f32

    head = la.model.module.get_submodule(".".join(la.last_layer_path))
    W, bias = head.weight.detach().double(), head.bias.detach().double()
    H = None
    for X, _ in loader:
        # the features as the fit computes them: float32 convolutions without TF32
        with torch.no_grad(), full_f32():
            phi = la.model.apply_with_features(la._tensor(X), la.last_layer_path)[1].double()
        p = torch.softmax(phi @ W.T + bias, dim=-1)
        B, C = p.shape
        eye = torch.eye(C, dtype=p.dtype, device=p.device)
        S = p.sqrt()[:, :, None] * (eye[None] - p[:, None, :])  # (B, sweep s, output o)
        M = torch.cat([S, torch.einsum("bi,bso->bsio", phi, S).reshape(B, C, -1)], 2)
        Hb = syrk_plain(M.reshape(B * C, -1))
        H = Hb if H is None else H + Hb
    return H


def full_syrk_time(net, loader, device):
    """The FullLL fit's syrk launches timed apart: a second fit of the same
    flavor on the same data under `torch.profiler`, and the device time of
    each syrk kernel it ran (`full_syrk_ms` is their sum)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from laplace_jax_torch import Laplace

    la = Laplace(net, "classification", "last_layer", "full", device=device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        la.fit(loader)
        torch.cuda.synchronize()
    ms = [(e.time_range.end - e.time_range.start) / 1e3 for e in prof.events()
          if e.device_type.name == "CUDA" and "k_syrk" in e.name]
    return dict(full_syrk_ms=sum(ms), full_syrk_launch_ms=ms)


def last_layer_phase(seed, device):
    """Last-layer Laplace at full width on the main path's network and data:
    the default KronLL (v1 kernel), FullLL (syrk kernel) and DiagLL."""
    import torch

    from laplace_jax_torch import DiagLLLaplace, FullLLLaplace, KronLLLaplace, Laplace
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.ops.latrd_v4 import latrd_panel_v4
    from laplace_jax_torch.ops.syrk import syrk

    net, loader, X_test = full_width(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    res = dict(phase="last_layer", model="ResNet18(width=64, num_classes=10)", n_data=512,
               batch=128, dtype="float32")

    def fit(la, name):
        torch.cuda.reset_peak_memory_stats()
        latrd_panel.launches = latrd_panel_v4.launches = syrk.launches = 0
        t0 = time.perf_counter()
        la.fit(loader)
        torch.cuda.synchronize()
        res[f"{name}_fit_s"] = time.perf_counter() - t0
        res[f"{name}_launches"] = {"latrd_panel": latrd_panel.launches,
                                   "latrd_panel_v4": latrd_panel_v4.launches,
                                   "syrk": syrk.launches}
        res[f"{name}_fit_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        res[f"{name}_log_marglik"] = float(la.log_marginal_likelihood())
        return res[f"{name}_launches"]

    kron = Laplace(net, "classification", device=device)  # the default flavor
    kron_launches = fit(kron, "kron")
    res.update(kron_class=type(kron).__name__, n_params=kron.n_params,
               last_layer=list(kron.last_layer_path))

    full = Laplace(net, "classification", "last_layer", "full", device=device)
    full_launches = fit(full, "full")
    H64 = ll_ggn_f64(full, loader)
    res["full_H_rel_err_vs_f64"] = float((full.H.double() - H64).abs().max() / H64.abs().max())
    res["full_H_exactly_symmetric"] = bool(torch.equal(full.H, full.H.mT))
    res.update(full_syrk_time(net, loader, device))
    t0 = time.perf_counter()
    full.optimize_prior_precision(method="marglik", n_steps=100)
    torch.cuda.synchronize()
    res["full_marglik_100_steps_s"] = time.perf_counter() - t0
    res["full_prior_precision"] = float(full.prior_precision[0])
    res["full_log_marglik_tuned"] = float(full.log_marginal_likelihood())
    t0 = time.perf_counter()
    probs = full(X_test[:8])
    torch.cuda.synchronize()
    res["full_probit_8_s"] = time.perf_counter() - t0
    res["full_probit_row_sum_err"] = float((probs.sum(-1) - 1).abs().max())
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    samples = full.predictive_samples(X_test, pred_type="glm", n_samples=100, generator=gen)
    torch.cuda.synchronize()
    res["full_glm_samples_100x128_s"] = time.perf_counter() - t0
    res["full_glm_samples_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["full_glm_samples_shape"] = list(samples.shape)
    res["full_glm_samples_row_sum_err"] = float((samples.sum(-1) - 1).abs().max())

    diag = Laplace(net, "classification", "last_layer", "diag", device=device)
    fit(diag, "diag")
    dref = torch.diagonal(full.H)
    res["diag_H_rel_err_vs_full"] = float((diag.H - dref).abs().max() / dref.abs().max())
    emit(res)

    check(isinstance(kron, KronLLLaplace), f"the default Laplace is a {type(kron).__name__}")
    check(isinstance(full, FullLLLaplace) and isinstance(diag, DiagLLLaplace),
          "Laplace() gave the wrong last-layer classes")
    check(kron.n_params == 5130 and tuple(kron.last_layer_path) == ("Dense_0",),
          f"last layer {kron.last_layer_path} with {kron.n_params} weights, not Dense_0 with 5130")
    check(kron_launches["latrd_panel"] > 0, f"the KronLL fit did not run the v1 kernel: {kron_launches}")
    check(full_launches["syrk"] == 4, f"the FullLL fit launched syrk {full_launches['syrk']} times, not 4")
    for name in ("kron", "full", "diag"):
        check(math.isfinite(res[f"{name}_log_marglik"]), f"{name}LL marglik is not finite")
    check(res["full_H_rel_err_vs_f64"] <= GGN_TOL,
          f"FullLL H off the float64 GGN by {res['full_H_rel_err_vs_f64']:.3e} > {GGN_TOL}")
    check(res["full_H_exactly_symmetric"], "FullLL H is not exactly symmetric")
    check(math.isfinite(res["full_prior_precision"]) and res["full_prior_precision"] > 0,
          f"tuned prior precision {res['full_prior_precision']}")
    check(tuple(probs.shape) == (8, 10) and bool(torch.isfinite(probs).all()),
          "FullLL predictive has the wrong shape or is not finite")
    check(res["full_probit_row_sum_err"] <= 1e-5, "FullLL predictive rows do not sum to 1")
    check(tuple(samples.shape) == (100, 128, 10) and bool(torch.isfinite(samples).all()),
          "GLM predictive samples have the wrong shape or are not finite")
    check(res["full_glm_samples_row_sum_err"] <= 1e-5, "GLM predictive samples do not sum to 1")
    check(res["diag_H_rel_err_vs_full"] <= DIAG_TOL,
          f"DiagLL H off diag(FullLL H) by {res['diag_H_rel_err_vs_full']:.3e} > {DIAG_TOL}")
    check(len(res["full_syrk_launch_ms"]) == 4,
          f"the profiled FullLL fit ran {len(res['full_syrk_launch_ms'])} syrk kernels, not 4")
    return {"syrk": full_launches["syrk"]}, res["full_syrk_ms"]


def class_stacks(kfacs):
    """The symmetrized factor stacks of a `Kron`, by size n >= 512, as
    `Kron.decompose` groups them, with their (group, factor) keys."""
    import torch

    keys: dict = {}
    for gi, F in enumerate(kfacs):
        for fi, H in enumerate(F):
            if H.shape[0] >= 512:
                keys.setdefault(H.shape[0], []).append((gi, fi))
    out = {}
    for n, ks in sorted(keys.items()):
        stack = torch.stack([kfacs[gi][fi] for gi, fi in ks])
        out[n] = (ks, (stack + stack.mT) / 2)
    return out


def eigensolvers_phase(seed, device, main):
    """The eigensolver choices of `Kron.decompose` at full width: the pooled
    spectral D&C through `KronLaplace.fit`, every class n >= 512 of that
    fit through the v3 and the v2 stage-1 kernels, and a float64 D&C on the
    card against the CPU."""
    import torch

    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.ops.eigh_dc import eigh_pooled_dc
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.ops.latrd_v2 import latrd_panel_v2
    from laplace_jax_torch.ops.latrd_v3 import latrd_panel_v3
    from laplace_jax_torch.ops.latrd_v4 import latrd_panel_v4
    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts
    from laplace_jax_torch.utils import matrix

    net, loader, _ = full_width(seed)
    res = dict(phase="eigensolvers", model="ResNet18(width=64, num_classes=10)", n_data=512,
               batch=128, dtype="float32", ts_fit_s=main["fit_s"],
               ts_decompose_s=main["decompose_s"], ts_log_marglik=main["log_marglik"])

    # 1. the pooled D&C through the user's entry point
    la = KronLaplace(net, "classification", device=device)
    latrd_panel.launches = latrd_panel_v4.launches = 0
    retries0 = matrix.SYMEIG_RETRIES
    matrix.EIGH_IMPLEMENTATION = "dc"
    try:
        t0 = time.perf_counter()
        la.fit(loader)
        torch.cuda.synchronize()
        res["dc_fit_s"] = time.perf_counter() - t0
    finally:
        matrix.EIGH_IMPLEMENTATION = None
    res["dc_decompose_s"] = la.fit_seconds["decompose"]
    res["dc_ts_kernel_launches"] = latrd_panel.launches + latrd_panel_v4.launches
    res["dc_symeig_retries"] = matrix.SYMEIG_RETRIES - retries0
    res["dc_log_marglik"] = float(la.log_marginal_likelihood())
    res["dc_lml_rel_diff"] = abs(res["dc_log_marglik"] - main["log_marglik"]) / abs(main["log_marglik"])
    stacks = class_stacks(la.H_facs.kfacs)
    refs = {n: torch.linalg.eigvalsh(st.double()) for n, (_, st) in stacks.items()}
    dc_err, dc_recon = {}, {}
    for n, (ks, st) in stacks.items():
        lam = torch.stack([la.H.eigenvalues[gi][fi] for gi, fi in ks]).double()
        Q = torch.stack([la.H.eigenvectors[gi][fi] for gi, fi in ks]).double()
        ref = refs[n].clamp(min=0)
        dc_err[n] = float(((lam - ref).abs().amax(1) / ref.abs().amax(1)).max())
        Sd = st.double()
        dc_recon[n] = float((torch.linalg.matrix_norm(Q @ torch.diag_embed(lam) @ Q.mT - Sd)
                             / torch.linalg.matrix_norm(Sd)).max())
    res.update(dc_eig_rel_err=dc_err, dc_recon_rel_err=dc_recon)

    # 2. every class n >= 512 through the v3 and the v2 stage-1 kernels, each
    # panel tallied by (K, m, off, nb)
    tally = PanelTally(ROUTE_PANELS)
    for stage1, kernel in (("latrd_v3", latrd_panel_v3), ("latrd_v2", latrd_panel_v2)):
        latrd_panel.launches = latrd_panel_v4.launches = 0
        latrd_panel_v2.launches = latrd_panel_v3.launches = 0
        errs, secs = {}, 0.0
        for n, (_, st) in stacks.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with tally:
                lam, _ = eigh_stack_ts(st, stage1=stage1, device=device)
            torch.cuda.synchronize()
            secs += time.perf_counter() - t0
            ref = refs[n]
            errs[n] = float(((lam.double() - ref).abs().amax(1) / ref.abs().amax(1)).max())
        res[f"{stage1}_eig_rel_err"] = errs
        res[f"{stage1}_s"] = secs
        res[f"{stage1}_launches"] = {"latrd_panel": latrd_panel.launches,
                                     "latrd_panel_v4": latrd_panel_v4.launches,
                                     "latrd_panel_v3": latrd_panel_v3.launches,
                                     "latrd_panel_v2": latrd_panel_v2.launches}

    # 3. float64 D&C on the card against the CPU: its default draws come
    # from seeded CPU generators and are moved to the card, so both calls
    # see the same numbers
    S = stacks[576][1][:2].double()
    (l_gpu, _), = eigh_pooled_dc([S], device=device)
    (l_cpu, _), = eigh_pooled_dc([S.cpu()], device="cpu")
    res["dc_f64_gpu_vs_cpu"] = float((l_gpu.cpu() - l_cpu).abs().max() / l_cpu.abs().max())
    emit(res)

    check(res["dc_ts_kernel_launches"] == 0,
          f"the dc fit ran the two-stage kernels ({res['dc_ts_kernel_launches']} launches)")
    check(res["dc_symeig_retries"] == 0, f"{res['dc_symeig_retries']} dc factors needed the symeig retry")
    for n in stacks:
        # held to the two-stage route's limits (the JAX package's float32
        # oracle for its D&C is 5e-4); the D&C computes in float64
        check(dc_err[n] <= EIG_TOL, f"dc eigenvalues at n={n} off by {dc_err[n]:.3e} > {EIG_TOL}")
        check(dc_recon[n] <= RECON_TOL,
              f"dc reconstruction at n={n}: {dc_recon[n]:.3e} > {RECON_TOL}")
    check(res["dc_lml_rel_diff"] <= DC_LML_TOL,
          f"dc marglik {res['dc_log_marglik']} vs ts {main['log_marglik']}")
    for stage1, kernel in (("latrd_v3", "latrd_panel_v3"), ("latrd_v2", "latrd_panel_v2")):
        for n, err in res[f"{stage1}_eig_rel_err"].items():
            check(err <= EIG_TOL, f"{stage1} eigenvalues at n={n} off by {err:.3e} > {EIG_TOL}")
        check(res[f"{stage1}_launches"][kernel] > 0, f"{stage1} did not launch {kernel}")
    check(res["latrd_v2_launches"]["latrd_panel"] == 0, "the v2 run delegated to v1")
    for stage1, kernel in (("latrd_v3", "latrd_panel_v3"), ("latrd_v2", "latrd_panel_v2")):
        check(sum(tally.counts[kernel].values()) == res[f"{stage1}_launches"][kernel],
              f"{kernel}: panels tallied {tally.counts[kernel]} against its launches")
    check(res["dc_f64_gpu_vs_cpu"] <= DC_F64_TOL,
          f"float64 dc on the card vs the CPU: {res['dc_f64_gpu_vs_cpu']:.3e} > {DC_F64_TOL}")
    return ({"latrd_panel_v3": res["latrd_v3_launches"]["latrd_panel_v3"],
             "latrd_panel_v2": res["latrd_v2_launches"]["latrd_panel_v2"]}, tally.counts)


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
    from laplace_jax_torch.ops.latrd import panel_plan

    build_s = _build.build_all()
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in _build.SOURCES}
    emit(dict(phase="build", seconds=build_s, ptxas=ptxas))
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    emit(dict(phase="build", kernel="latrd_panel", ptxas=ptxas["latrd"],
              plan_at_4x1152={dt: panel_plan(4, 1152, 0, 64, size, n_sm)._asdict()
                              for dt, size in (("float32", 4), ("float64", 8))}))

    rows = [kernel_phase(*row, args.seed, device) for row in KERNELS]
    rows.append(syrk_phase(args.seed, device, _build.build_log("syrk")))
    reference_phase(args.seed, device)
    # each kernel's launches from the path that runs it: v1 and v4 from the
    # all-weights main path, syrk from the last-layer FullLL fit, v3 and v2
    # from the eigensolvers phase
    main = main_path(args.seed, device)
    window_phase(rows, main["panels"], args.seed, device, smi)
    launches = dict(main["launches"])
    ll_launches, full_syrk_ms = last_layer_phase(args.seed, device)
    launches.update(ll_launches)
    next(r for r in rows if r["name"] == "syrk")["main_path_ms"] = full_syrk_ms
    route_launches, route_panels = eigensolvers_phase(args.seed, device, main)
    launches.update(route_launches)
    window_phase(rows, route_panels, args.seed, device, smi, total="route_ms")

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("main_path_ms", "route_ms", "stream_bound_ms")
    print(json.dumps({"kernels": [dict({k: r[k] for k in keys}, launches=launches[r["name"]],
                                       **{k: r[k] for k in extra if k in r})
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
