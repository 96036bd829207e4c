#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`laplace_jax_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--window-study SEEDS] [--gp-subnet-repeats N]

Phases, each printing one JSON line; any failed check exits non-zero:

1. device  - the card's name and power limit (`nvidia-smi`);
2. build   - compiles every CUDA kernel from `laplace_jax_torch/csrc/`,
             one `nvcc` per source, all at once; prints each kernel's
             registers and spills, and v1's shared memory at (4, 1152);
3. kernels - each LATRD panel kernel at a real ResNet-18 factor class
             (v1 and v2 at (4, 1152), v4 and v3 at (3, 4608), float32)
             against its plain PyTorch version on the same inputs, v1, v3
             and v2 also against themselves (bitwise), and the whole
             `eigh_stack_ts` through that kernel against `torch.linalg.eigh`;
             v1 also on a (17, 128) window at offset 64 (7 blocks a window
             of 9 or 10 rows, next to no work a column), the cost of its
             2 nb grid barriers and phase latencies; v3 (one cooperative
             launch a panel, every sum in one fixed order) also at (4, 1152)
             in float32 and at both shapes in float64, each bitwise over two
             launches, against its plain version and timed (`by_shape`);
             v4 and v3 also with `stream_bound_ms`, the time the trailing
             triangle's tiles that stay off chip take to stream from HBM
             every column; v2 (one cooperative launch a panel on v1's
             kernel, row corrections grouped by 8 columns, every sum in one
             fixed order) also at (3, 4608) in float32 and at both shapes in
             float64, bitwise, against its plain version and timed
             (`by_shape`, `ms_3x4608`), with `stream_bound_ms` at (3, 4608):
             the time the full rows that stay off chip take to stream from
             HBM every column;
             the syrk kernel against `syrk_plain`, bitwise over two
             launches and exactly symmetric, at the last-layer GGN shape
             (1280, 5130) and at (1280, 5131) (P odd: 4-byte copies) in
             float32, and at (1280, 5130) and (37, 130) in float64, each
             timed; its ptxas registers and spills, its bound fraction;
   leaves  - stage 2's Jacobi leaves kernel (`csrc/jacobi_leaves.cu`, one
             launch a `tridiag_eigh`) at each main-path class's leaves
             (96x32, 80x36, 128x36, 256x36, 384x36, float32) against its
             plain version (eigenvalues, `||A V - V L|| / ||A||` and
             `||V^T V - I||` within 4 times the plain version's own, plus
             16 ulps), timed beside the plain version, `torch.linalg.eigh`
             on the same stack and the bound;
   secular - stage 2's secular kernel (`csrc/secular.cu`, one launch a
             merge level) at the main path's merge levels (1024x64,
             32x2048, 3x4608, 1x11008: merges x roots) against its plain
             version (active roots within 1e-12 of their gap), its launch
             plan, timed beside its float64 bound, the plain solve on the
             card and the whole `_merge_level`;
4. reference - width-8 ResNet-18 fits in float64 on the card against the
             same fits on the CPU: all-weights KFAC (its 576 class runs the
             v1 kernel; LAPACK on the CPU) and last-layer Full (the float64
             syrk kernel; the einsum on the CPU); then (`reference_backends`)
             an EF KFAC fit of it and a `kron_unsupported="block"` fit of a
             BatchNorm WideResNet-16 at widen 1, factors, marglik and probit
             within 1e-12;
5. main    - the main path at full width: `KronLaplace` on ResNet-18
             (width 64, 10 classes, 11.16M weights) over 512 CIFAR-10-shaped
             inputs in batches of 128, marglik prior tuning, and the GLM
             probit predictive on 8 inputs, with both LATRD kernels' launch
             counts read from this run (35 v1, 108 v4), the Jacobi leaves'
             (5: one a factor class n >= 512), the secular kernel's (26:
             one a merge level) and every panel it
             launched tallied by (K, m, off); the TF32 switches must read
             as they did before the fit (the port scopes its own);
   windows - each panel the main path launched, on a random window of its
             (K, m) at its offset, timed 5 times with CUDA events: the v4
             and v1 rows gain `ms_by_window` and `main_path_ms` (the sum
             over the main path's launches);
   parallel - data parallelism over `torch.distributed` on the one card:
             two gloo ranks on cuda:0 (spawned after the build, which they
             only load; gloo's `all_reduce` and `all_gather` on CUDA tensors
             checked first), each fitting the main path under
             `DataParallel(data_mesh())` in the default and the explicit
             mode (35 v1 and 108 v4 launches a rank, read from its own run;
             factor diagonals, marglik and the probit on 8 inputs against
             `main`'s fit; its all-reduces timed alone), then the
             last layer's `FullLLLaplace` (4 syrk launches a rank) and its
             `shard_posterior` (H by rows, `Shard(0)`; logdet, 4 samples
             and the probit against the replicated posterior); an NCCL
             group of this one process fitting the main path; `main`'s
             factors decomposed over `[cuda:0, cuda:0]` and under
             `LAPLACE_TS_STAGE1=pallas` (143 v1 panels, no v4) and `xla`
             (no kernel), eigenvalues, reconstructions and logdet against
             `main`'s decompose; the all-weights tap diagonal in bfloat16
             (finite, probit rows sum to 1 within 2e-2, its error against
             float32 reported);
6. last_layer - last-layer Laplace on the same network and data: the
             default `Laplace(net, "classification")` (KronLL, v1 kernel),
             FullLL (the syrk kernel, 4 launches; its GGN against a float64
             one; marglik tuning; probit predictive; 100 GLM predictive
             samples on 128 inputs) and DiagLL (against FullLL's diagonal),
             each kernel's launches read from its own fit; a second FullLL
             fit under `torch.profiler` gives the device time of its syrk
             launches (`full_syrk_ms`, syrk's `main_path_ms`);
7. eigensolvers - every factor class n >= 512 of the `main` fit through
             `eigh_stack_ts` with the v3 and then the v2 kernel, against
             float64 `eigvalsh` (their launches read here, every panel
             tallied by (K, m, off); no v2 panel may go to v1);
   route_windows - each panel of the v3 and v2 runs, timed as in
             `windows` (each a persistent launch, v2's windows of the 2304
             and 4608 classes streaming most of their rows): the v3 and v2
             rows gain `ms_by_window` and `route_ms`;
   sbr     - the successive band reduction (`ops/band.py`, `ops/chase.py`:
             plain PyTorch, no kernel, as the JAX package's XLA code) on
             every factor class n >= 512 of the `main` fit (6x512, 5x576,
             4x1152, 4x2304, 3x4608, float32, b = 64): band_reduce ->
             band_to_tridiag -> tridiag_eigh -> apply_chase_q -> apply_q on
             the card, eigenvalues against float64 `eigvalsh` (EIG_TOL),
             reconstruction and orthogonality (RECON_TOL), no kernel
             launched, each stage's seconds beside the class's
             `eigh_stack_ts` and `torch.linalg.eigh`, the peak memory; a
             float64 (2, 576) chain on the card against the CPU (1e-9);
   examples - each `examples_torch/*.py` `main()` at the JAX example's own
             sizes on the card, in process: its seconds, every returned
             number finite, probit rows summing to 1 within 1e-5, the
             regression example's joint-vs-marginal asserts;
8. marglik_training - `bench.py` config 3a at full size: BenchCNN (convs
             32/64/64/128 with biases, `Dense_0` to 10), 1024 CIFAR-10-shaped
             inputs, batch 256, 2 epochs, 10 hypersteps a round, Kron,
             classification, float32: `epochs_per_sec`, the margliks, the
             layerwise prior, the v1 launches (the (2, 576) class on each of
             the 3 fits); every marglik finite, probit rows sum to 1, the
             TF32 switches as before, the returned fit's eigenvalues against
             float64 `eigvalsh`, and v1 on the windows (and data) of the
             last fit: bitwise over two launches, its float32 and float64
             outputs each within `ops.tridiag.panel_residual`'s tolerance,
             and its error against the float64 plain panel beside the plain
             float32 panel's (reported only: the tail windows are nearly
             deflated, where two correct float32 panels can differ by more
             than 1e-4, and even float64 ones); then the same run in float64
             on the card (v1's launches counted again) and on the CPU,
             margliks and losses within 1e-6 relative;
9. regression - ResNet-18 (width 64, one output) on the main path's 512
             inputs with float targets, batch 128, float32: an all-weights
             `KronLaplace` fit (35 v1 and 108 v4 launches), 100 marglik
             steps tuning a layerwise prior, the marglik's gradient in
             `sigma_noise`, the GLM `(f_mu, f_var)` and `log_prob(la.mean)`
             under the tuned prior; NN predictives (16 samples of
             `KronLaplace.sample`) on 8 inputs under the tuned prior and
             under one at the initialization's scale, each with its samples'
             spread against the prior and every layer's largest output in
             float32 and float64 for the same weights (a non-finite float32
             predictive must come with float64 values beyond float32's
             range); a FullLL fit (4 syrk launches) and a gridsearch on a
             KronLL (Gaussian NLL on 128 validation targets drawn from the
             predictive at the grid's middle, the default grid of 100; its
             choice against the argmin of the scores taken outside it; and
             one with the default MSE score, a grid value back), each timed;
10. functional - `bench.py`'s `gp_fit_predict` at full size:
             `FunctionalLaplace` on LeNet (28x28x1, 10 classes, 107,786
             weights) over 2048 inputs, batch 128, an SoD of 512, float32:
             the auto rule must stream (a 2.21 GB Jacobian cache); warm-up,
             then `gp_fit_sec` and `gp_predict_sec` (`la(x[:64])`); the
             streamed fit's parts timed alone (`gp_fit_parts`: first pass,
             Jacobians, K_MM's products, the cached Gram, Σ's Cholesky, one
             batch's Jacobians under the profiler); a fit
             with `streaming=False` against the streamed one (K_MM, Σ's
             Cholesky, the probit, the marglik); a gridsearch of 21 values
             (NLL on 128 validation labels drawn from the predictive at the
             grid's middle; its choice against the argmin of the scores
             taken outside it); `independent_outputs=True` (its
             kernels against the full K_MM's class blocks) and
             `FunctionalLLLaplace`; no kernel may launch; a float64 fit at
             an SoD of 64 on the card against the CPU;
11. subnet - `bench.py` config 3b at full size: BenchCNN on 256
             CIFAR-10-shaped inputs, batch 64, float32, the 128 largest
             weights (`LargestMagnitudeSubnetMask`) into
             `Laplace(..., "subnetwork", "full")`: a warm-up fit with every
             syrk launch's M and H recorded (H against `syrk_plain`,
             exactly symmetric, their sum the fit's H), then the timed fit
             (`subnet_full_fit_sec`) with its 4 syrk launches, and its
             Jacobians timed alone (`subnet_fit_parts`); syrk timed at
             (640, 128) (`at_640x128` on the kernel line); the GLM probit
             and the marglik; `DiagSubnetLaplace` against the full H's
             diagonal; the DiagLaplace and SWAG variance masks timed; a
             float64 fit on the card against the CPU.
12. backends - the curvature choices at full width, float32: on ResNet-18
             and the main path's data, `KronLaplace` with the EF and with
             the MC Fisher (35 v1 and 108 v4 panels each, eigenvalues against
             float64 `eigvalsh`, marglik, probit), the all-weights
             `DiagLaplace` through the layer taps (GGN and EF: peak device
             memory against a limit from the tapped outputs' size, the
             diagonal against the Jacobian path's on 4 inputs, 100 tuning
             steps, probit), FullLL on the head with the Hessian (against the
             GGN's H), the EF (against a float64 Σ g gᵀ) and the MC GGN;
             WideResNet-16-4 with BatchNorm (2,750,682 weights, running
             statistics from the seed, 512 inputs, batch 128):
             `kron_unsupported="block"` (v1 and v4 launches against its
             factor classes 576x4, 1152x4 and 2304x3, eigenvalues, its norm
             blocks on the first batch against the exact GGN blocks of
             those leaves and, block by block, both against float64),
             "skip" (a warning, zero norm groups), "raise" (`ValueError`),
             and `DiagLaplace` through the taps against the Jacobian path.
13. transformer - `bench.py` config 5's reward transformer with all its
             4,208,130 weights, full size (512 sequences of 128 tokens,
             batch 64, float32, "reward_modeling"): `KronLaplace` under
             `kron_unsupported="skip"` and "block" (the DenseGeneral,
             attention and Embed taps; v1 on its 1024 class of 12 factors
             and v4 on the Embed's exactly diagonal 4096 factor, launches
             against `expected_panels`, every panel of the block fit held to
             its plain version, eigenvalues against float64 `eigvalsh`, the
             Embed factor's eigenvalues exactly its sorted diagonal, the
             skip warning naming only LayerNorm leaves), 100 marglik steps
             and the probit on 64 sequences; `DiagLaplace` through the taps
             (peak memory, against the Jacobian path on 4 sequences);
             `LowRankLaplace(low_rank=10)` with the Hessian and the GGN
             (matrix-free Lanczos: its and one matvec's seconds, peak
             memory, each Ritz residual, max |UᵀU - I|, probit, marglik,
             100 tuning steps); float64 on the card against the CPU at 1
             block, d 64, vocab 256 (Kron factors, tap diagonal, Lanczos
             eigenpairs from one start vector) within 1e-9.
14. conv_variants - the conv half of tap breadth at full width, float32,
             512 inputs in batches of 128, 10 classes: a CIFAR-shaped 2-D net
             of flax `Conv` twins at ResNet-18's stage widths (a PixelCNN
             mask, input dilation, CIRCULAR padding, 2 groups, a masked
             depthwise conv; 2.3M weights), a 1-D net of `nn.Conv1d` (128
             positions, 64 channels) and a 3-D net of `nn.Conv3d` with the
             `InstanceNorm` twin (16^3 voxels): all-weights `KronLaplace`
             (2-D and 1-D under `kron_unsupported="raise"`, 3-D under "skip",
             warning of its InstanceNorm leaves alone, and "block"; v1 on the
             512-1152 classes, v4 on the grouped conv's 2304; launches
             against `expected_panels`, every panel of each net's last fit
             held to its plain version, eigenvalues against float64
             `eigvalsh`, 100 marglik steps, the probit on 64 inputs);
             `DiagLaplace` through the taps (peak memory, the taps against
             the Jacobian path on 4 inputs); `KronLLLaplace` on the 1-D net's
             conv head; a `DenseGeneral(batch_dims=(0,))` model at batch 4,
             whose whole-batch Jacobian fallback warns and whose
             `FullLaplace` fit launches syrk, held to `syrk_plain`; float64
             on the card against the CPU at an eighth of the widths (Kron
             factors, tap diagonals) within 1e-9.
The `last_layer` phase also runs the bridge, bridge_norm and MC links on
its KronLL (rows sum to 1).

Then the kernel summary line (with `main_path_ms`, `route_ms`,
`stream_bound_ms` and v2's `ms_3x4608` where measured, and
`launches_by_path`: each kernel's launches on the parallel,
marglik_training, regression, subnet, reward, backends, transformer,
conv_variants and serialization paths; the leaves' and the secular
kernel's on each but parallel, whose ranks run in processes of their own;
the secular row's `by_shape`), the
`nvidia-smi` line, and last
`{"ok": true, "device": {...}}`. Without a CUDA device, or outside the
repository checkout, it exits non-zero and prints no result.

`--window-study SEEDS` runs, after the build, only `window_study`: the
`marglik_training` path once a seed, v1 checked on each run's windows as
in that phase, and the spread of every error over the seeds; it prints
no result line.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import re
import subprocess
import sys
import time
import warnings
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
F64_FLOPS = 34e12  # H100 SXM float64 outside the tensor cores
PANEL_TOL = 1e-4  # float32 panel: max |kernel - plain| / max |plain| per output
# a panel's outputs against the contract's recurrences (ops.tridiag.panel_residual,
# over max |Aw|): a correct float32 panel is within a few sqrt(m) eps of 0 on any
# window, a fault of 1e-3 in one output is above 1e-4 (tests/test_torch_panel_residual.py)
RESIDUAL_TOL = {"float32": 1e-5, "float64": 1e-12}
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

DC_F64_TOL = 1e-9  # a float64 eigensolver on the card vs on the CPU

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
# kernels whose two launches agree bit for bit
BITWISE = {"latrd_panel_v3", "latrd_panel", "latrd_panel_v2"}
MAIN_LAUNCHES = {"latrd_panel": 35, "latrd_panel_v4": 108}  # panels of one all-weights fit
LEAF_LAUNCHES = 5  # the Jacobi leaves' launches of that fit: one a class n >= 512
SECULAR_LAUNCHES = 26  # the secular kernel's: one a merge level (4 + 4 + 5 + 6 + 7)
# the main path's stage-2 leaves, (leaves, m) a class: 512, 576, 1152, 2304, 4608
LEAF_SHAPES = [(96, 32), (80, 36), (128, 36), (256, 36), (384, 36)]


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


def rel_err(got, ref) -> float:
    """max |got - ref| / max |ref|, in float64."""
    got, ref = got.double().cpu(), ref.double().cpu()
    return float((got - ref).abs().max() / ref.abs().max())


def port_kernels() -> tuple:
    """The five kernel wrappers, each carrying its launch count."""
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.ops.latrd_v2 import latrd_panel_v2
    from laplace_jax_torch.ops.latrd_v3 import latrd_panel_v3
    from laplace_jax_torch.ops.latrd_v4 import latrd_panel_v4
    from laplace_jax_torch.ops.syrk import syrk

    return latrd_panel, latrd_panel_v4, latrd_panel_v3, latrd_panel_v2, syrk


def kernel_launches(*names) -> dict:
    """The launch counts of the named kernels (all five with no names)."""
    return {k.__name__: k.launches for k in port_kernels() if not names or k.__name__ in names}


def zero_launches() -> None:
    for k in port_kernels():
        k.launches = 0


def timed(res, name, fn):
    """`fn()`, with its seconds (host clock, synchronized) in `res[name]`."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    res[name] = time.perf_counter() - t0
    return out


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


def row_stream_bound_ms(K: int, m: int, off: int, nb: int, itemsize: int, plan) -> float:
    """Least time for one panel of the persistent full-row kernel (v2) whose
    window does not fit on the chip: each column c reads, from device memory
    at its rate, the columns from vec_floor(c + 1) on of every live row
    c < i < m that the plan (`ops/latrd_v2.panel_plan`) does not keep in
    shared memory: all but the first `n_res` rows of each block's run (the
    runs of `Rows` in csrc/latrd_panel.cuh)."""
    import bisect

    L, G, vec = m - off, plan.n_cta, 16 // itemsize
    gk = G // K if K <= G else 0
    base, extra = divmod(L if gk else K * L, gk or G)

    def start(b):
        t = b % gk if gk else b
        return (b // gk * L if gk else 0) + t * base + min(t, extra)

    streamed = [[] for _ in range(K)]  # window rows i that stream, by window
    for b in range(G):
        for g in range(start(b) + plan.n_res, start(b + 1)):
            streamed[g // L].append(off + g % L)
    elems = 0
    for c in range(off, off + nb):
        rows = sum(len(s) - bisect.bisect_right(s, c) for s in streamed)
        elems += rows * (m - (c + 1) // vec * vec)
    return 1e3 * elems * itemsize / HBM_BYTES_PER_S


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
        extra["by_shape"] = more_shapes(name, kernel, plain, V3_SHAPES, nb, gen, device)
    if name == "latrd_panel_v2":  # the 4608 class's window, which streams, and float64
        n_sm = torch.cuda.get_device_properties(device).multi_processor_count
        extra["by_shape"] = more_shapes(name, kernel, plain, V2_SHAPES, nb, gen, device)
        big = extra["by_shape"]["3x4608_float32"]
        plan = mod.panel_plan(3, 4608, 0, nb, 4, n_sm)
        big.update(n_res=plan.n_res, rows=plan.rows,
                   stream_bound_ms=row_stream_bound_ms(3, 4608, 0, nb, 4, plan))
        extra.update(ms_3x4608=big["ms"], stream_bound_ms=big["stream_bound_ms"])
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
# v2's: the v3 row's window, which streams, and float64 at both
V2_SHAPES = [(3, 4608, "float32"), (4, 1152, "float64"), (3, 4608, "float64")]
F64_TOL = 1e-10  # float64 panel vs plain: only the summation order differs


def more_shapes(name, kernel, plain, shapes, nb, gen, device):
    """A persistent panel at further (K, n, dtype) shapes: bitwise over two
    launches, against its plain version, timed."""
    import torch

    out = {}
    for K, n, dt in shapes:
        A = sym_stack(K, n, gen, device, getattr(torch, dt))
        got, again = kernel(A, 0, 0, n, nb), kernel(A, 0, 0, n, nb)
        ref = plain(A, 0, 0, n, nb)
        torch.cuda.synchronize()
        rel = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
        bitwise = all(bool(torch.equal(g, r)) for g, r in zip(got, again))
        tol = PANEL_TOL if dt == "float32" else F64_TOL
        out[f"{K}x{n}_{dt}"] = dict(ms=cuda_ms(lambda: kernel(A, 0, 0, n, nb), reps=5),
                                    rel_err=rel, tol=tol, repeat_bitwise=bitwise)
        check(bitwise, f"{name} {dt} ({K}, {n}): two launches on one window differ")
        check(rel <= tol, f"{name} {dt} ({K}, {n}): relative error {rel:.3e} > {tol}")
        del A, got, again, ref
    return out


class LeafCount:
    """The Jacobi leaves kernel's launches inside a `with` block (`n`), and
    the secular kernel's (`secular`)."""

    def __enter__(self):
        from laplace_jax_torch.ops.tridiag_eig import _jacobi_eigh, _secular

        self.kernels = _jacobi_eigh, _secular
        self.n0 = [k.launches for k in self.kernels]
        return self

    def __exit__(self, *exc):
        self.n, self.secular = (k.launches - n0 for k, n0 in zip(self.kernels, self.n0))
        return False


def leaf_bound_ms(B: int, m: int, itemsize: int, flops_peak: float, sweeps: int):
    """Least time for one leaves launch: A read once, vals and vecs written
    once, against the rotations (9 mp^2 flops a round: 6 an entry of A, 3
    of V)."""
    mp = m + m % 2
    t_bytes = B * (2 * m * m + m) * itemsize / HBM_BYTES_PER_S
    t_ops = B * sweeps * (mp - 1) * 9 * mp * mp / flops_peak
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def leaf_levels(A, vals, vecs):
    """Worst eigenvalue gap to eigvalsh, ||A V - V L|| / ||A|| and
    ||V^T V - I|| over the leaves, in float64."""
    import torch

    A, vals, vecs = A.double(), vals.double(), vecs.double()
    scale = A.flatten(1).norm(dim=1)
    eig = (vals - torch.linalg.eigvalsh(A)).abs().amax(1) / scale
    resid = (A @ vecs - vecs * vals[:, None, :]).flatten(1).norm(dim=1) / scale
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    orth = (vecs.mT @ vecs - eye).flatten(1).norm(dim=1)
    return dict(eig=float(eig.max()), resid=float(resid.max()), orth=float(orth.max()))


def leaves_phase(seed, device):
    """Stage 2's Jacobi leaves kernel at the main path's leaf stacks,
    float32: against its plain version and timed (the kernel summary's
    `jacobi_leaves` row)."""
    import torch

    from laplace_jax_torch.ops.tridiag_eig import JACOBI_SWEEPS, _jacobi_eigh, _jacobi_eigh_plain

    gen = torch.Generator(device=device).manual_seed(seed)
    eps = torch.finfo(torch.float32).eps
    by_class, worst = {}, 0.0
    for B, m in LEAF_SHAPES:
        X = torch.randn(B, m, m, generator=gen, device=device)
        A = (X + X.mT) / 2
        got, ref = _jacobi_eigh(A), _jacobi_eigh_plain(A)
        torch.cuda.synchronize()
        lv, lv_plain = leaf_levels(A, *got), leaf_levels(A, *ref)
        for key in lv:
            check(lv[key] <= 4 * lv_plain[key] + 16 * eps,
                  f"Jacobi leaves ({B}, {m}): {key} {lv[key]:.3e} against plain {lv_plain[key]:.3e}")
        worst = max(worst, float((got[0] - ref[0]).abs().max()))
        bound_ms, bound_by = leaf_bound_ms(B, m, 4, F32_FLOPS, JACOBI_SWEEPS)
        by_class[f"{B}x{m}"] = dict(ms=cuda_ms(lambda: _jacobi_eigh(A), reps=20),
                                    plain_ms=cuda_ms(lambda: _jacobi_eigh_plain(A), reps=1),
                                    library_ms=cuda_ms(lambda: torch.linalg.eigh(A), reps=5),
                                    bound_ms=bound_ms, bound_by=bound_by, levels=lv,
                                    plain_levels=lv_plain)
    total = {k: sum(c[k] for c in by_class.values()) for k in ("ms", "plain_ms", "bound_ms")}
    row = dict(name="jacobi_leaves", route="cuda", source="laplace_jax_torch/csrc/jacobi_leaves.cu",
               replaces="none (laplace_jax/ops/tridiag_eig.py:_jacobi_eigh, jnp code)",
               max_abs_err=worst, ms=by_class["384x36"]["ms"], plain_ms=by_class["384x36"]["plain_ms"],
               bound_ms=by_class["384x36"]["bound_ms"], bound_by=by_class["384x36"]["bound_by"],
               library_ms=by_class["384x36"]["library_ms"], main_path_ms=total["ms"],
               main_path_plain_ms=total["plain_ms"], main_path_bound_ms=total["bound_ms"],
               by_class=by_class, dtype="float32")
    emit(dict(phase="leaves", **row))
    return row


# the main path's merge levels, (merges, M): the first level of a 32-factor
# chunk of the 2048 class and its top level, the top levels of the 4608 and
# 10,944 classes
SECULAR_SHAPES = [(1024, 64), (32, 2048), (3, 4608), (1, 11008)]
SECULAR_TOL = 1e-12  # an active root against the plain solve, relative to its gap


def secular_bound_ms(B: int, M: int, flops_peak: float):
    """Least time for one secular launch: per (root, pole) pair, 42
    evaluations of f (two subtractions, a division, an add) and 10 of f and
    f' (a second division and add), a division counted as one operation.
    Its bytes (a few arrays of B M) are far below."""
    return 1e3 * B * M * M * (42 * 4 + 10 * 6) / flops_peak


def secular_phase(seed, device):
    """Stage 2's secular kernel at the main path's merge levels (merges of
    `tests/torch_merges.deflating_merge`, float64), against its plain
    version and timed, with the whole merge level (the kernel summary's
    `secular` row; its `max_abs_err` is the worst active root's distance
    from the plain solve's, over its gap)."""
    import torch

    from laplace_jax_torch.ops.tridiag_eig import _merge_level, _secular, _secular_plain
    from tests.torch_merges import deflating_merge, secular_against_plain, secular_args

    by_shape, worst = {}, 0.0
    for B, M in SECULAR_SHAPES:
        merge = deflating_merge(B, M, torch.float64, seed + M, device)
        args = secular_args(*merge)
        out, plain = _secular(*args), _secular_plain(*args)
        torch.cuda.synchronize()
        rel, stray = secular_against_plain(args, out, plain)
        check(stray == 0, f"secular ({B}, {M}): {stray} roots took another origin")
        check(rel <= SECULAR_TOL, f"secular ({B}, {M}): root off by {rel:.3e} of its gap")
        worst = max(worst, rel)
        ms = cuda_ms(lambda: _secular(*args), reps=5)
        by_shape[f"{B}x{M}"] = dict(
            ms=ms, plain_ms=cuda_ms(lambda: _secular_plain(*args), reps=1),
            merge_ms=cuda_ms(lambda: _merge_level(*merge), reps=1),
            bound_ms=secular_bound_ms(B, M, F64_FLOPS), max_rel_err=rel,
            origins_differ=int((out[1] != plain[1])[args[1] > 0].sum()),
            active=int((args[1] > 0).sum()))
        del merge, args, out, plain
    top = by_shape["1x11008"]
    row = dict(name="secular", route="cuda", source="laplace_jax_torch/csrc/secular.cu",
               replaces="none (laplace_jax/ops/tridiag_eig.py:_merge_level, jnp in fori_loops)",
               max_abs_err=worst, ms=top["ms"], plain_ms=top["plain_ms"], bound_ms=top["bound_ms"],
               bound_by="operations", library_ms=None, by_shape=by_shape, dtype="float64")
    emit(dict(phase="secular", **row))
    return row


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
    reference_backends(seed, device)


def reference_backends(seed, device):
    """The curvature choices in float64, on the card against the CPU: an EF
    `KronLaplace` on the width-8 ResNet-18 (its 576 class runs v1 on the
    card) and a `kron_unsupported="block"` fit of a BatchNorm WideResNet-16
    at widen 1 (its 576 class likewise, the norm blocks from the taps)."""
    import numpy as np
    import torch

    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.models.flax_layers import BatchNorm
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.models.wideresnet import WideResNet16x4
    from laplace_jax_torch.ops.latrd import latrd_panel
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((32, 16, 16, 3))
    y = rng.integers(0, 10, 32)
    gen = torch.Generator().manual_seed(seed)
    wrn = WideResNet16x4(10, 1, "batch", generator=gen).double()
    with torch.no_grad():
        for m in wrn.modules():
            if isinstance(m, BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=gen, dtype=torch.float64))
                m.var.add_(0.1 * torch.randn(m.var.shape, generator=gen,
                                             dtype=torch.float64).abs())
    fits = {"resnet18_w8_ef": (ResNet18(width=8, generator=gen).double(),
                               dict(backend="ef")),
            "wrn_w1_batchnorm_block": (wrn, dict(backend_kwargs={"kron_unsupported": "block"}))}
    res = dict(phase="reference_backends", dtype="float64")
    for name, (net, kw) in fits.items():
        out = {}
        for dev in ("cpu", device):
            la = KronLaplace(net, "classification", device=dev, **kw)
            v1 = latrd_panel.launches
            la.fit(ArrayLoader(X, y, batch_size=16))
            out[str(dev)] = (la.H_facs, float(la.log_marginal_likelihood()),
                             la(X[:4]).cpu(), la.H._flat_eigs.cpu(), latrd_panel.launches - v1)
        (F_c, l_c, p_c, e_c, _), (F_g, l_g, p_g, e_g, v1_g) = out["cpu"], out[str(device)]
        res[name] = dict(
            factors_rel_err=max(rel_err(a, b) for Fa, Fb in zip(F_g.kfacs, F_c.kfacs)
                                for a, b in zip(Fa, Fb)),
            lml_cpu=l_c, lml_gpu=l_g, lml_rel_err=abs(l_g - l_c) / abs(l_c),
            pred_max_err=float((p_g - p_c).abs().max()), eig_rel_err=rel_err(e_g, e_c),
            v1_launches=v1_g)
    emit(res)
    for name in fits:
        r = res[name]
        check(r["v1_launches"] > 0, f"reference {name} did not run the v1 kernel")
        for key in ("factors_rel_err", "lml_rel_err", "pred_max_err"):
            check(r[key] <= 1e-12, f"reference {name}: {key} {r[key]:.3e} > 1e-12")
        check(r["eig_rel_err"] <= 1e-9, f"reference {name}: eigenvalues off by "
                                        f"{r['eig_rel_err']:.3e}")


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
    are untouched. With `keep`, `inputs[name][key]` holds a copy of the
    last call's arguments at each key (window, off, q_base, n_real, nb)."""

    def __init__(self, names=MAIN_PANELS, keep=False):
        self.counts = {name: {} for name in names}
        self.inputs = {name: {} for name in names}
        self.keep = keep
        self.inner = {}

    def __enter__(self):
        for name in self.counts:
            mod, tally, kept = panel_module(name), self.counts[name], self.inputs[name]
            inner = mod.tridiagonalize_windows

            def windows(A, nb, S, panel, inner=inner, tally=tally, kept=kept):
                def counted(Aw, off, q_base, n_real, nb):
                    key = (Aw.shape[0], Aw.shape[1], off, nb)
                    tally[key] = tally.get(key, 0) + 1
                    if self.keep:
                        kept[key] = (Aw.clone(), off, q_base, n_real, nb)
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


def kernel_eig_err(la) -> float:
    """The largest relative error of a fitted `KronLaplace`'s eigenvalues
    against float64 `torch.linalg.eigvalsh` of its factors, over the factor
    classes n >= 512 (those the LATRD kernels decompose)."""
    import torch

    worst = 0.0
    for gi, F in enumerate(la.H_facs.kfacs):
        for fi, H in enumerate(F):
            if H.shape[0] >= 512:
                ref = torch.linalg.eigvalsh(H.double()).clamp(min=0)
                got = la.H.eigenvalues[gi][fi].double()
                worst = max(worst, float((got - ref).abs().max() / ref.abs().max()))
    return worst


def main_path(seed, device, keep):
    import torch

    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.utils import matrix

    net, loader, X_test = full_width(seed)
    res = dict(phase="main", model="ResNet18(width=64, num_classes=10)", n_data=512, batch=128,
               dtype="float32")
    la = KronLaplace(net, "classification", device=device)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    retries0 = matrix.SYMEIG_RETRIES
    flags0 = tf32_flags()
    with PanelTally() as tally, LeafCount() as leaves:
        timed(res, "fit_s", lambda: la.fit(loader))
    flags_after_fit = tf32_flags()
    launches = kernel_launches(*MAIN_LAUNCHES)
    retries = matrix.SYMEIG_RETRIES - retries0
    lml = float(la.log_marginal_likelihood())
    sizes = sorted({int(H.shape[0]) for F in la.H_facs.kfacs for H in F})
    worst = kernel_eig_err(la)

    timed(res, "marglik_100_steps_s", lambda: la.optimize_prior_precision(method="marglik",
                                                                          n_steps=100))
    pp = float(la.prior_precision[0])
    probs = timed(res, "predictive_s", lambda: la(X_test[:8]))
    row_err = float((probs.sum(-1) - 1).abs().max())
    flags_after = tf32_flags()

    res.update(n_params=la.n_params,
               accumulate_s=la.fit_seconds["accumulate"], decompose_s=la.fit_seconds["decompose"],
               launches=launches, leaf_launches=leaves.n, secular_launches=leaves.secular,
               symeig_retries=retries,
               factor_sizes=sizes,
               eig_rel_err_vs_eigh=worst, log_marglik=lml,
               prior_precision=pp, predictive_shape=list(probs.shape),
               predictive_row_sum_err=row_err, tf32_flags_before=flags0,
               tf32_flags_after_fit=flags_after_fit, tf32_flags_after_tuning_and_predictive=flags_after,
               peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
    emit(res)
    res["panels"] = tally.counts
    check(la.n_params == 11_164_362, f"ResNet-18 has {la.n_params} weights, not 11164362")
    check(launches == MAIN_LAUNCHES, f"main-path launches {launches}, not {MAIN_LAUNCHES}")
    check(leaves.n == LEAF_LAUNCHES,
          f"main path launched the Jacobi leaves {leaves.n} times, not {LEAF_LAUNCHES}")
    check(leaves.secular == SECULAR_LAUNCHES,
          f"main path launched the secular kernel {leaves.secular} times, not {SECULAR_LAUNCHES}")
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
    keep["main_kron"] = (la, lambda: KronLaplace(net, "classification", device=device),
                         X_test[:8])
    return res


PARALLEL_RANKS = 2  # gloo ranks on the one card
# the data-parallel fit against `main`'s single-process fit, float32: the
# all_reduce sums the ranks' halves of each batch where one process sums
# the whole batch, so each factor moves by rounding (about 1e-7 of its
# largest entry), and the decompose, marglik and probit follow it
PARALLEL_DIAG_TOL = 1e-5  # each factor's diagonal, max |par - one| / max |one|
PARALLEL_LML_TOL = 1e-5  # marglik, relative
PARALLEL_PROBIT_TOL = 1e-5  # probit on 8 inputs, absolute
SHARD_TOL = 1e-6  # shard_posterior against the replicated posterior, relative
BF16_ROW_TOL = 2e-2  # bfloat16 probit rows sum to 1 (the JAX package's tests/test_dtypes.py)
# `LAPLACE_TS_STAGE1` on `main`'s factors: "pallas" sends every class n >= 512
# to v1 (35 panels of its own classes, 108 of v4's), "xla" to the plain stage 1
OVERRIDE_LAUNCHES = {"pallas": {"latrd_panel": 143, "latrd_panel_v4": 0},
                     "xla": {"latrd_panel": 0, "latrd_panel_v4": 0}}


def kron_diagonals(kron) -> list:
    """Each factor's diagonal, on the host."""
    return [H.diagonal().cpu() for F in kron.kfacs for H in F]


def max_rel(got: list, ref: list) -> float:
    """The largest max |got - ref| / max |ref| over paired tensors."""
    return max(rel_err(g, r) for g, r in zip(got, ref))


def parallel_rank(rank, world, work, seed, device):
    """One rank of the `parallel` phase, spawned by `parallel_phase` on the
    one card (gloo: NCCL refuses two ranks on one GPU): gloo's collectives
    on CUDA tensors; the full-width ResNet-18 `KronLaplace` under
    `DataParallel(data_mesh())` in the default and the explicit mode, its
    all-reduces timed alone, its launches read from this rank's own run;
    the last-layer `FullLLLaplace` under it, then its `shard_posterior`
    (logdet, 4 samples from one generator, probit) beside the replicated
    posterior. Writes its results to `work/rank<rank>.pt`. `device` is
    `main`'s, "cuda:0"."""
    from datetime import timedelta

    import torch
    import torch.distributed as dist

    from laplace_jax_torch import FullLLLaplace, KronLaplace
    from laplace_jax_torch.parallel import DataParallel, data_mesh, sharding

    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=f"file://{work}/rendezvous", world_size=world,
                            rank=rank, timeout=timedelta(seconds=300))
    res = {}
    t = torch.full((3,), float(rank + 1), device=device)
    dist.all_reduce(t)
    parts = [torch.empty(2, device=device) for _ in range(world)]
    dist.all_gather(parts, torch.full((2,), float(rank), device=device))
    res["gloo_cuda"] = dict(all_reduce=t.tolist(), all_reduce_device=str(t.device),
                            all_gather=[p.tolist() for p in parts],
                            all_gather_devices=sorted({str(p.device) for p in parts}))
    reduce_s, broadcast_s = [0.0], [0.0]

    def timed_collective(fn, acc):
        def call(tree, group=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(tree, group)
            torch.cuda.synchronize()
            acc[0] += time.perf_counter() - t0
            return out
        return call

    sharding.all_reduce_tree = timed_collective(sharding.all_reduce_tree, reduce_s)
    sharding.broadcast_tree = timed_collective(sharding.broadcast_tree, broadcast_s)
    net, loader, X_test = full_width(seed)
    mesh = data_mesh()
    for mode, explicit in (("annotated", False), ("explicit", True)):
        la = KronLaplace(net, "classification", device=device,
                         parallel=DataParallel(mesh, explicit=explicit))
        zero_launches()
        reduce_s[0] = broadcast_s[0] = 0.0
        r = {}
        timed(r, "fit_s", lambda: la.fit(loader))
        r.update(launches=kernel_launches(*MAIN_LAUNCHES, "syrk"), all_reduce_s=reduce_s[0],
                 broadcast_s=broadcast_s[0], accumulate_s=la.fit_seconds["accumulate"],
                 decompose_s=la.fit_seconds["decompose"],
                 log_marglik=float(la.log_marginal_likelihood()),
                 probit=la(X_test[:8]).cpu(), diagonals=kron_diagonals(la.H_facs))
        res[mode] = r
        del la
    ll = FullLLLaplace(net, "classification", device=device, parallel=DataParallel(mesh))
    zero_launches()
    reduce_s[0] = 0.0
    r = {}
    timed(r, "fit_s", lambda: ll.fit(loader))
    r.update(launches=kernel_launches("syrk"), all_reduce_s=reduce_s[0], n_params=ll.n_params)
    for tag in ("replicated", "sharded"):
        if tag == "sharded":
            timed(r, "shard_posterior_s", ll.shard_posterior)
            r.update(placements=str(ll.H.placements), local_shape=list(ll.H.to_local().shape))
        gen = torch.Generator(device=device).manual_seed(seed)
        r[tag] = dict(logdet=float(ll.log_det_posterior_precision),
                      samples=ll.sample(4, generator=gen).cpu(), probit=ll(X_test[:8]).cpu())
        # a marglik step, the best of 3 (each gathers a sharded H first)
        steps = {}
        for i in range(3):
            timed(steps, i, ll.log_marginal_likelihood)
        r[f"log_marglik_step_s_{tag}"] = min(steps.values())
    res["full_ll"] = r
    torch.save(res, Path(work) / f"rank{rank}.pt")
    dist.barrier()
    dist.destroy_process_group()


def parallel_phase(seed, device, smi, main, keep):
    """Data parallelism over `torch.distributed` on the one card, against
    `main`'s fit: 2 gloo ranks (`parallel_rank`); an NCCL group of this one
    process; `Kron.decompose` over two devices; the `LAPLACE_TS_STAGE1`
    override; a bfloat16 tap diagonal. Returns the first rank's launches as
    it read them: its default-mode Kron fit's v1 and v4, its FullLL fit's
    syrk."""
    import os

    import torch
    import torch.distributed as dist
    import torch.multiprocessing as mp

    from laplace_jax_torch import DiagLaplace, KronLaplace
    from laplace_jax_torch.parallel import DataParallel, sharding

    t_start = time.perf_counter()
    la, _, X8 = keep["main_kron"]
    res = dict(phase="parallel", model="ResNet18(width=64, num_classes=10)", n_data=512,
               batch=128, dtype="float32", ranks=PARALLEL_RANKS, nvidia_smi=smi)
    # `main`'s fit at the prior the ranks fit with (`main` tuned it since)
    tuned = la.prior_precision
    la.prior_precision = 1.0
    one_probit = la(X8).cpu()
    one_lml = float(la.log_marginal_likelihood())
    la.prior_precision = tuned
    one_diag = kron_diagonals(la.H_facs)
    check(abs(one_lml - main["log_marglik"]) <= PARALLEL_LML_TOL * abs(main["log_marglik"]),
          f"main's marglik at prior 1 reads {one_lml}, not {main['log_marglik']}")

    # two gloo ranks on cuda:0; every kernel was built before the spawn,
    # so the ranks only load `build/`
    work = Path(__file__).resolve().parent / "build" / "parallel"
    work.mkdir(parents=True, exist_ok=True)
    for stale in ["rendezvous"] + [f"rank{r}.pt" for r in range(PARALLEL_RANKS)]:
        (work / stale).unlink(missing_ok=True)
    timed(res, "spawn_s", lambda: mp.spawn(
        parallel_rank, args=(PARALLEL_RANKS, str(work), seed, str(device)),
        nprocs=PARALLEL_RANKS, join=True))
    ranks = [torch.load(work / f"rank{r}.pt") for r in range(PARALLEL_RANKS)]
    res["gloo_cuda"] = ranks[0]["gloo_cuda"]
    for r, out in enumerate(ranks):
        g = out["gloo_cuda"]
        check(g["all_reduce"] == [3.0] * 3 and g["all_reduce_device"] == "cuda:0"
              and g["all_gather"] == [[0.0, 0.0], [1.0, 1.0]]
              and g["all_gather_devices"] == ["cuda:0"],
              f"rank {r}: gloo on CUDA tensors gave {g}")
    for mode in ("annotated", "explicit"):
        row = {}
        for r, out in enumerate(ranks):
            o = out[mode]
            check(o["launches"] == dict(MAIN_LAUNCHES, syrk=0),
                  f"{mode} rank {r}: launches {o['launches']}, not {MAIN_LAUNCHES}")
            diag_err = max_rel(o["diagonals"], one_diag)
            lml_err = abs(o["log_marglik"] - one_lml) / abs(one_lml)
            probit_err = float((o["probit"] - one_probit).abs().max())
            row[f"rank{r}"] = dict({k: o[k] for k in ("fit_s", "accumulate_s", "decompose_s",
                                                      "all_reduce_s", "broadcast_s", "launches",
                                                      "log_marglik")},
                                   diag_rel_err=diag_err, log_marglik_rel_err=lml_err,
                                   probit_err=probit_err)
            check(diag_err <= PARALLEL_DIAG_TOL,
                  f"{mode} rank {r}: factor diagonals off main's by {diag_err:.3e}")
            check(lml_err <= PARALLEL_LML_TOL, f"{mode} rank {r}: marglik off by {lml_err:.3e}")
            check(probit_err <= PARALLEL_PROBIT_TOL,
                  f"{mode} rank {r}: probit off main's by {probit_err:.3e}")
        # the first rank's eigenpairs are broadcast: every rank holds one posterior
        row["ranks_bitwise"] = all(
            torch.equal(ranks[0][mode]["probit"], out[mode]["probit"])
            and ranks[0][mode]["log_marglik"] == out[mode]["log_marglik"]
            and all(map(torch.equal, ranks[0][mode]["diagonals"], out[mode]["diagonals"]))
            for out in ranks)
        res[mode] = row
        check(row["ranks_bitwise"], f"{mode}: the ranks' marglik, probit or factors differ")
    # shard_posterior over the 2 ranks (P = 5130)
    shard = {}
    for r, out in enumerate(ranks):
        o = out["full_ll"]
        rep, sh = o["replicated"], o["sharded"]
        errs = dict(logdet=abs(sh["logdet"] - rep["logdet"]) / abs(rep["logdet"]),
                    samples=rel_err(sh["samples"], rep["samples"]),
                    probit=float((sh["probit"] - rep["probit"]).abs().max()))
        shard[f"rank{r}"] = dict(fit_s=o["fit_s"], all_reduce_s=o["all_reduce_s"],
                                 log_marglik_step_s={t: o[f"log_marglik_step_s_{t}"]
                                                     for t in ("replicated", "sharded")},
                                 launches=o["launches"], placements=o["placements"],
                                 local_shape=o["local_shape"],
                                 shard_posterior_s=o["shard_posterior_s"], errors=errs,
                                 bitwise=all(torch.equal(torch.as_tensor(sh[k]),
                                                         torch.as_tensor(rep[k])) for k in sh))
        check(o["launches"] == {"syrk": 4}, f"rank {r}: FullLL syrk launches {o['launches']}")
        check(o["placements"] == "(Shard(dim=0),)" and o["local_shape"] == [2565, 5130],
              f"rank {r}: H laid out {o['placements']} {o['local_shape']}")
        check(max(errs.values()) <= SHARD_TOL, f"rank {r}: shard_posterior moved {errs}")
    res["shard_posterior"] = shard

    # an NCCL group of this one process, the route of a multi-GPU user. Its
    # fit runs no collective (a group of one is short-cut), so the
    # collectives the fit would run are driven over it directly
    dp = DataParallel()
    world = dist.group.WORLD
    probit = la(X8)  # one call: the card's probit does not repeat bit for bit
    coll = dict(
        all_reduce_tree=all(map(torch.equal, kron_diagonals(
            sharding.all_reduce_tree(la.H_facs, world)), one_diag)),
        broadcast_tree=all(map(torch.equal, sharding.broadcast_tree(
            (la.H.eigenvalues,), world)[0][0], la.H.eigenvalues[0])),
        all_gather_rows=torch.equal(sharding._all_gather_rows(probit, world, 1), probit))
    net, loader, _ = full_width(seed)
    nccl = dict(backend=dist.get_backend(), world_size=dist.get_world_size(), collectives=coll)
    one = KronLaplace(net, "classification", device=device, parallel=dp)
    zero_launches()
    timed(nccl, "fit_s", lambda: one.fit(loader))
    nccl.update(launches=kernel_launches(*MAIN_LAUNCHES),
                log_marglik_rel_err=abs(float(one.log_marginal_likelihood()) - one_lml)
                / abs(one_lml),
                probit_err=float((one(X8).cpu() - one_probit).abs().max()),
                diag_rel_err=max_rel(kron_diagonals(one.H_facs), one_diag))
    dist.destroy_process_group()
    del one
    res["nccl_one_rank"] = nccl
    check(nccl["backend"] == "nccl" and nccl["world_size"] == 1 and all(coll.values()),
          f"NCCL group: {nccl}")
    check(nccl["launches"] == MAIN_LAUNCHES, f"NCCL fit launches {nccl['launches']}")
    check(nccl["diag_rel_err"] <= PARALLEL_DIAG_TOL
          and nccl["log_marglik_rel_err"] <= PARALLEL_LML_TOL
          and nccl["probit_err"] <= PARALLEL_PROBIT_TOL, f"NCCL fit off main's: {nccl}")

    # the main path's factors over [cuda:0, cuda:0] against main's decompose
    def against_main(dec):
        eig = recon = 0.0
        for Qs, ls, Qr, lr in zip(dec.eigenvectors, dec.eigenvalues, la.H.eigenvectors,
                                  la.H.eigenvalues):
            for Q, lam, Q0, lam0 in zip(Qs, ls, Qr, lr):
                eig = max(eig, rel_err(lam, lam0))
                R0 = (Q0 * lam0) @ Q0.T
                recon = max(recon, rel_err((Q * lam) @ Q.T, R0))
        return eig, recon

    multi = {}
    zero_launches()
    dec = timed(multi, "decompose_s",
                lambda: la.H_facs.decompose(devices=[device, device]))
    multi["launches"] = kernel_launches(*MAIN_LAUNCHES)
    multi["eig_rel_err"], multi["recon_rel_err"] = against_main(dec)
    del dec
    res["decompose_two_devices"] = multi
    check(multi["eig_rel_err"] <= EIG_TOL and multi["recon_rel_err"] <= RECON_TOL,
          f"decompose over two devices off main's: {multi}")

    # LAPLACE_TS_STAGE1 on the same factors
    override = {}
    auto_logdet = float((la.H + 1.0).logdet())
    for value, expect in OVERRIDE_LAUNCHES.items():
        o = {}
        os.environ["LAPLACE_TS_STAGE1"] = value
        try:
            zero_launches()
            dec = timed(o, "decompose_s", la.H_facs.decompose)
        finally:
            del os.environ["LAPLACE_TS_STAGE1"]
        o["launches"] = kernel_launches(*MAIN_LAUNCHES)
        o["eig_rel_err"], o["recon_rel_err"] = against_main(dec)
        o["logdet_rel_err"] = abs(float((dec + 1.0).logdet()) - auto_logdet) / abs(auto_logdet)
        del dec
        override[value] = o
        check(o["launches"] == expect, f"LAPLACE_TS_STAGE1={value}: launches {o['launches']}")
        check(o["eig_rel_err"] <= EIG_TOL and o["logdet_rel_err"] <= EIG_TOL,
              f"LAPLACE_TS_STAGE1={value}: off the auto route: {o}")
    res["stage1_override"] = override

    # the all-weights tap diagonal in bfloat16 against float32
    bf16 = {}
    net32, loader, X_test = full_width(seed)
    d32 = DiagLaplace(net32, "classification", device=device)
    timed(bf16, "float32_fit_s", lambda: d32.fit(loader))
    netb = copy.deepcopy(net32).to(torch.bfloat16)
    db = DiagLaplace(netb, "classification", device=device)
    torch.cuda.reset_peak_memory_stats()
    timed(bf16, "fit_s", lambda: db.fit(loader))
    probs = db(X_test[:8])
    bf16.update(dtype=str(db.H.dtype), peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                H_finite=bool(torch.isfinite(db.H.float()).all()),
                diag_rel_err_vs_float32=rel_err(db.H, d32.H),
                probit_dtype=str(probs.dtype),
                row_sum_err=float((probs.float().sum(-1) - 1).abs().max()),
                log_marglik=float(db.log_marginal_likelihood()))
    res["bfloat16_diag"] = bf16
    check(bf16["dtype"] == "torch.bfloat16" and bf16["H_finite"], f"bfloat16 H: {bf16}")
    check(bf16["row_sum_err"] <= BF16_ROW_TOL,
          f"bfloat16 probit rows sum to 1 within {bf16['row_sum_err']:.3e} only")
    res["phase_s"] = time.perf_counter() - t_start
    emit(res)
    return dict(ranks[0]["annotated"]["launches"], syrk=ranks[0]["full_ll"]["launches"]["syrk"])


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


def last_layer_phase(seed, device, keep):
    """Last-layer Laplace at full width on the main path's network and data:
    the default KronLL (v1 kernel), FullLL (syrk kernel) and DiagLL."""
    import torch

    from laplace_jax_torch import DiagLLLaplace, FullLLLaplace, KronLLLaplace, Laplace

    net, loader, X_test = full_width(seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    res = dict(phase="last_layer", model="ResNet18(width=64, num_classes=10)", n_data=512,
               batch=128, dtype="float32")

    def fit(la, name):
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        timed(res, f"{name}_fit_s", lambda: la.fit(loader))
        res[f"{name}_launches"] = kernel_launches("latrd_panel", "latrd_panel_v4", "syrk")
        res[f"{name}_fit_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        res[f"{name}_log_marglik"] = float(la.log_marginal_likelihood())
        return res[f"{name}_launches"]

    kron = Laplace(net, "classification", device=device)  # the default flavor
    kron_launches = fit(kron, "kron")
    res.update(kron_class=type(kron).__name__, n_params=kron.n_params,
               last_layer=list(kron.last_layer_path))
    links = {}
    for link in ("bridge", "bridge_norm", "mc"):
        links[link] = {}
        p = timed(links[link], "s", lambda: kron(X_test[:8], link_approx=link, n_samples=100,
                                                 generator=gen))
        links[link].update(shape=list(p.shape),
                           finite=bool(torch.isfinite(p).all()),
                           row_sum_err=float((p.sum(-1) - 1).abs().max()))
    res["kron_links_8"] = links

    full = Laplace(net, "classification", "last_layer", "full", device=device)
    full_launches = fit(full, "full")
    H64 = ll_ggn_f64(full, loader)
    res["full_H_rel_err_vs_f64"] = float((full.H.double() - H64).abs().max() / H64.abs().max())
    res["full_H_exactly_symmetric"] = bool(torch.equal(full.H, full.H.mT))
    res.update(full_syrk_time(net, loader, device))
    timed(res, "full_marglik_100_steps_s", lambda: full.optimize_prior_precision(
        method="marglik", n_steps=100))
    res["full_prior_precision"] = float(full.prior_precision[0])
    res["full_log_marglik_tuned"] = float(full.log_marginal_likelihood())
    probs = timed(res, "full_probit_8_s", lambda: full(X_test[:8]))
    res["full_probit_row_sum_err"] = float((probs.sum(-1) - 1).abs().max())
    torch.cuda.reset_peak_memory_stats()
    samples = timed(res, "full_glm_samples_100x128_s", lambda: full.predictive_samples(
        X_test, pred_type="glm", n_samples=100, generator=gen))
    res["full_glm_samples_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    res["full_glm_samples_shape"] = list(samples.shape)
    res["full_glm_samples_row_sum_err"] = float((samples.sum(-1) - 1).abs().max())

    diag = Laplace(net, "classification", "last_layer", "diag", device=device)
    fit(diag, "diag")
    dref = torch.diagonal(full.H)
    res["diag_H_rel_err_vs_full"] = float((diag.H - dref).abs().max() / dref.abs().max())
    emit(res)

    check(isinstance(kron, KronLLLaplace), f"the default Laplace is a {type(kron).__name__}")
    for link, r in links.items():
        check(r["shape"] == [8, 10] and r["finite"] and r["row_sum_err"] <= 1e-5,
              f"KronLL {link} predictive: {r}")
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
    keep["last_layer_full"] = (full, lambda: FullLLLaplace(net, "classification", device=device),
                               X_test[:8])
    keep["last_layer_diag"] = (diag, lambda: DiagLLLaplace(net, "classification", device=device),
                               X_test[:8])
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


def eigensolvers_phase(device, keep):
    """The stage-1 routes that `Kron.decompose` does not take at full width:
    every class n >= 512 of the `main` fit through `eigh_stack_ts` with the
    v3 and the v2 stage-1 kernels."""
    import torch

    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    stacks = class_stacks(keep["main_kron"][0].H_facs.kfacs)
    refs = {n: torch.linalg.eigvalsh(st.double()) for n, (_, st) in stacks.items()}
    res = dict(phase="eigensolvers", source="main path's ResNet-18 Kron factors",
               dtype="float32")
    # every class n >= 512 through the v3 and the v2 stage-1 kernels, each
    # panel tallied by (K, m, off, nb)
    tally = PanelTally(ROUTE_PANELS)
    for stage1 in ("latrd_v3", "latrd_v2"):
        zero_launches()
        errs, secs = {}, {}
        for n, (_, st) in stacks.items():
            with tally:
                lam, _ = timed(secs, n, lambda: eigh_stack_ts(st, stage1=stage1, device=device))
            ref = refs[n]
            errs[n] = float(((lam.double() - ref).abs().amax(1) / ref.abs().amax(1)).max())
        res[f"{stage1}_eig_rel_err"] = errs
        res[f"{stage1}_s"] = sum(secs.values())
        res[f"{stage1}_launches"] = kernel_launches("latrd_panel", "latrd_panel_v4",
                                                    "latrd_panel_v3", "latrd_panel_v2")
    emit(res)

    for stage1, kernel in (("latrd_v3", "latrd_panel_v3"), ("latrd_v2", "latrd_panel_v2")):
        for n, err in res[f"{stage1}_eig_rel_err"].items():
            check(err <= EIG_TOL, f"{stage1} eigenvalues at n={n} off by {err:.3e} > {EIG_TOL}")
        check(res[f"{stage1}_launches"][kernel] > 0, f"{stage1} did not launch {kernel}")
    check(res["latrd_v2_launches"]["latrd_panel"] == 0, "the v2 run delegated to v1")
    for stage1, kernel in (("latrd_v3", "latrd_panel_v3"), ("latrd_v2", "latrd_panel_v2")):
        check(sum(tally.counts[kernel].values()) == res[f"{stage1}_launches"][kernel],
              f"{kernel}: panels tallied {tally.counts[kernel]} against its launches")
    return ({"latrd_panel_v3": res["latrd_v3_launches"]["latrd_panel_v3"],
             "latrd_panel_v2": res["latrd_v2_launches"]["latrd_panel_v2"]}, tally.counts)


SBR_B = 64  # the SBR chain's semi-bandwidth (the JAX package's default)
SBR_STAGES = ("band", "chase", "stage2", "q2", "q1")


def sbr_chain(A, secs=None):
    """Successive band reduction end to end: `band_reduce` -> `band_to_tridiag`
    -> `tridiag_eigh` -> `apply_chase_q` -> `apply_q`, each stage timed into
    `secs` (synchronized) when it is given. Returns (eigenvalues, Q) and the
    tridiagonal (d, e)."""
    from laplace_jax_torch.ops.band import band_reduce
    from laplace_jax_torch.ops.chase import apply_chase_q, band_to_tridiag
    from laplace_jax_torch.ops.tridiag import apply_q
    from laplace_jax_torch.ops.tridiag_eig import tridiag_eigh

    run = (lambda name, fn: timed(secs, name, fn)) if secs is not None else (lambda _, fn: fn())
    B, V1, t1 = run("band", lambda: band_reduce(A, b=SBR_B))
    d, e, V2, t2 = run("chase", lambda: band_to_tridiag(B, SBR_B))
    lam, Ut = run("stage2", lambda: tridiag_eigh(d, e))
    U2 = run("q2", lambda: apply_chase_q(V2, t2, Ut, b=SBR_B))
    return lam, run("q1", lambda: apply_q(V1, t1, U2)), d, e


def sbr_phase(device, smi, keep):
    """The SBR chain (no kernel of its own; the JAX package's standalone op
    chain, which no entry point reaches) on every factor class n >= 512 of
    the main path's fit, float32, on the card: eigenvalues against float64
    `eigvalsh`, reconstruction and orthogonality, each stage's seconds
    beside that class's `eigh_stack_ts` and `torch.linalg.eigh`; then a
    float64 (2, 576) chain on the card against the CPU."""
    import torch

    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    stacks = class_stacks(keep["main_kron"][0].H_facs.kfacs)
    res = dict(phase="sbr", nvidia_smi=smi, source="main path's ResNet-18 Kron factors",
               b=SBR_B, dtype="float32",
               classes={n: list(st.shape) for n, (_, st) in stacks.items()})
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    secs, errs = {}, {}
    for n, (_, st) in stacks.items():
        secs[n] = {}
        lam, Q, _, _ = sbr_chain(st, secs[n])
        ref = torch.linalg.eigvalsh(st.double())
        lam, Q, Sd = lam.double(), Q.double(), st.double()
        eye = torch.eye(n, dtype=torch.float64, device=device)
        errs[n] = dict(
            eig_rel_err=float(((lam - ref).abs().amax(1) / ref.abs().amax(1)).max()),
            recon_rel_err=float((torch.linalg.matrix_norm(Q @ torch.diag_embed(lam) @ Q.mT - Sd)
                                 / torch.linalg.matrix_norm(Sd)).max()),
            orth_err=float((Q.mT @ Q - eye).abs().max()))
        del lam, Q, Sd
    res["chain_kernel_launches"] = sum(kernel_launches().values())
    res["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    for n, (_, st) in stacks.items():
        timed(secs[n], "eigh_stack_ts", lambda: eigh_stack_ts(st, device=device))
        timed(secs[n], "torch_eigh", lambda: torch.linalg.eigh(st))
        secs[n]["sbr_total"] = sum(secs[n][k] for k in SBR_STAGES)
    res.update(seconds=secs, errors=errs,
               sbr_total_s=sum(v["sbr_total"] for v in secs.values()),
               eigh_stack_ts_total_s=sum(v["eigh_stack_ts"] for v in secs.values()),
               torch_eigh_total_s=sum(v["torch_eigh"] for v in secs.values()))

    # float64 on the card against the same chain on the CPU
    S = stacks[576][1][:2].double()
    l_gpu = sbr_chain(S)[0]
    l_cpu = sbr_chain(S.cpu())[0]
    res["f64_gpu_vs_cpu"] = float((l_gpu.cpu() - l_cpu).abs().max() / l_cpu.abs().max())
    emit(res)

    check(res["chain_kernel_launches"] == 0,
          f"the SBR chain launched {res['chain_kernel_launches']} kernels")
    for n, r in errs.items():
        check(r["eig_rel_err"] <= EIG_TOL,
              f"sbr eigenvalues at n={n} off by {r['eig_rel_err']:.3e} > {EIG_TOL}")
        check(r["recon_rel_err"] <= RECON_TOL,
              f"sbr reconstruction at n={n}: {r['recon_rel_err']:.3e} > {RECON_TOL}")
        check(r["orth_err"] <= RECON_TOL,
              f"sbr orthogonality at n={n}: {r['orth_err']:.3e} > {RECON_TOL}")
    check(res["f64_gpu_vs_cpu"] <= DC_F64_TOL,
          f"float64 sbr on the card vs the CPU: {res['f64_gpu_vs_cpu']:.3e} > {DC_F64_TOL}")


EXAMPLES = ("regression_example", "calibration_example", "calibration_gp_example",
            "huggingface_example", "reward_modeling_example", "bayesopt_example",
            "expectation_example")
ROW_TOL = 1e-5  # a probit predictive's rows sum to 1


def result_numbers(out) -> list:
    """Every number in an example's nested result."""
    if isinstance(out, dict):
        return [x for v in out.values() for x in result_numbers(v)]
    if isinstance(out, (list, tuple)):
        return [x for v in out for x in result_numbers(v)]
    return [out] if isinstance(out, (int, float)) else []


def row_sum_errors(out) -> list:
    """|row sum - 1| of every probit predictive in an example's result: its
    `probs*` lists and `row_sum_err` entries."""
    errs = []
    for k, v in out.items():
        if isinstance(v, dict):
            errs += row_sum_errors(v)
        elif k.startswith("probs"):
            errs += [abs(sum(row) - 1) for row in v]
        elif k == "row_sum_err":
            errs.append(v)
    return errs


def examples_phase(device, smi):
    """Each `examples_torch/*.py` `main()` on the card at the JAX example's own
    sizes, in this process (its printout kept out of this script's output):
    every returned number finite, the probit rows summing to 1, the
    regression example's joint-vs-marginal asserts (inside its `main`)."""
    import contextlib
    import importlib
    import io

    res = dict(phase="examples", nvidia_smi=smi, seconds={}, results={})
    for name in EXAMPLES:
        main = importlib.import_module(f"examples_torch.{name}").main
        with contextlib.redirect_stdout(io.StringIO()):
            res["results"][name] = timed(res["seconds"], name, lambda: main(device=device))
    res["total_s"] = sum(res["seconds"].values())
    emit(res)
    for name, out in res["results"].items():
        vals = result_numbers(out)
        check(bool(vals) and all(math.isfinite(v) for v in vals),
              f"example {name} returned a number that is not finite")
        errs = row_sum_errors(out)
        check(all(e <= ROW_TOL for e in errs),
              f"example {name}: probit rows sum to 1 only within {max(errs, default=0.0):.3e}")
    for name in ("calibration_example", "calibration_gp_example", "huggingface_example"):
        check(bool(row_sum_errors(res["results"][name])), f"example {name} returned no probit")


# bench.py config 3a: marglik_training on BenchCNN, N = 1024, batch 256, 2 epochs
MT_N, MT_BATCH, MT_EPOCHS, MT_HYPERSTEPS = 1024, 256, 2, 10
MT_F64_TOL = 1e-6  # float64 margliks and losses, card (v1 + stage 2) vs CPU (LAPACK)


def bench_cnn(seed, dtype):
    """`bench.py`'s BenchCNN (convs 32/64/64/128 with biases, flax 'SAME'
    padding, `Dense_0` to 10) from the port's layers, with flax's
    initializers drawn from `seed`."""
    import torch
    from torch import nn

    from laplace_jax_torch.models.resnet import Conv, _trunc_normal, init_conv

    class BenchCNN(nn.Module):
        def __init__(self):
            super().__init__()
            c_in = 3
            for i, (c, s) in enumerate(zip((32, 64, 64, 128), (1, 2, 1, 2))):
                self.add_module(f"Conv_{i}", Conv(c_in, c, 3, s, use_bias=True))
                c_in = c
            self.Dense_0 = nn.Linear(c_in, 10)

        def forward(self, x):
            x = x.permute(0, 3, 1, 2)  # NHWC -> NCHW
            for i in range(4):
                x = torch.relu(getattr(self, f"Conv_{i}")(x))
            return self.Dense_0(x.mean(dim=(2, 3)))

    gen = torch.Generator().manual_seed(seed)
    net = BenchCNN()
    with torch.no_grad():
        for i in range(4):
            init_conv(getattr(net, f"Conv_{i}"), gen)
        _trunc_normal(net.Dense_0.weight, math.sqrt(1.0 / 128), gen)
        net.Dense_0.bias.zero_()
    return net.to(dtype)


def path_panels_vs_plain(kernel, plain, inputs, bitwise=True, lower_only=False):
    """A panel kernel on the windows a path gave it
    (`PanelTally(keep=True).inputs`): bitwise over two float32 launches
    (reported only with `bitwise=False`: v4 adds with atomics, so its
    float32 outputs vary from launch to launch on a window whose
    reflectors are not trivial), and its float32 outputs, and its float64
    outputs on the same window in float64, within RESIDUAL_TOL of the
    contract's recurrences. With `lower_only=True` (a kernel that reads
    only the lower triangle, v4) each window is first mirrored from its
    lower triangle: a path's windows (a float32 Gram `a.T @ a` on the card, and
    the trailing windows built from it) are symmetric only to float32
    rounding, and the recurrences read whole columns, so they hold the
    kernel to the window it reads. Its error against the float64 plain
    panel stands beside the plain float32 panel's, and beside the
    lower-half-matvec plain float32 panel's (two correct float32 panels):
    on nearly deflated windows these scatter beyond PANEL_TOL, so they are
    reported, not checked."""
    import torch

    from laplace_jax_torch.ops.tridiag import lower_half_matvec, panel_plain, panel_residual

    def worst(outs, exact):
        return max(float((o.double() - x).abs().max() / x.abs().max()) for o, x in zip(outs, exact))

    out = {}
    for (K, m, _, _), (Aw, off, q_base, n_real, nb) in inputs.items():
        args = (off, q_base, n_real, nb)
        if lower_only:
            Aw = Aw.tril() + Aw.tril(-1).mT
        got, again = kernel(Aw, *args), kernel(Aw, *args)
        A64 = Aw.double()
        got64 = kernel(A64, *args)
        ref, exact = plain(Aw, *args), plain(A64, *args)
        lower = panel_plain(Aw, *args, matvec=lower_half_matvec(Aw))
        torch.cuda.synchronize()
        key = f"{K}x{m}@{off}"
        row = out[key] = dict(
            residual=float(panel_residual(Aw, *args, *got).max()),
            residual_f64=float(panel_residual(A64, *args, *got64).max()),
            plain_residual=float(panel_residual(Aw, *args, *ref).max()),
            plain_residual_f64=float(panel_residual(A64, *args, *exact).max()),
            rel_err=worst(got, ref), err_vs_f64=worst(got, exact), plain_err_vs_f64=worst(ref, exact),
            lower_plain_err_vs_f64=worst(lower, exact),
            repeat_bitwise=all(bool(torch.equal(g, r)) for g, r in zip(got, again)))
        check(row["repeat_bitwise"] or not bitwise,
              f"{kernel.__name__} {key}: two launches on one window differ")
        check(row["residual"] <= RESIDUAL_TOL["float32"],
              f"{kernel.__name__} {key}: float32 residual {row['residual']:.3e} > "
              f"{RESIDUAL_TOL['float32']} (plain float32 {row['plain_residual']:.3e})")
        check(row["residual_f64"] <= RESIDUAL_TOL["float64"],
              f"{kernel.__name__} {key}: float64 residual {row['residual_f64']:.3e} > "
              f"{RESIDUAL_TOL['float64']} (plain float64 {row['plain_residual_f64']:.3e})")
    return out


def marglik_training_phase(seed, device, smi):
    """`marglik_training` at `bench.py` config 3a's full size: BenchCNN, 1024
    CIFAR-10-shaped inputs, batch 256, 2 epochs, 10 hypersteps a round,
    Kron, classification, float32 on the card, with the v1 launches (the
    (2, 576) class on each of the three fits) read from the run, and v1
    checked on the last fit's windows (`path_panels_vs_plain`); then the
    same run in float64 on the card and on the CPU."""
    import numpy as np
    import torch

    from laplace_jax_torch import KronLaplace, marglik_training
    from laplace_jax_torch.ops.latrd import latrd_panel, latrd_panel_plain
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(seed)
    X = rng.standard_normal((MT_N, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, MT_N)
    kw = dict(likelihood="classification", hessian_structure="kron", n_epochs=MT_EPOCHS,
              n_hypersteps=MT_HYPERSTEPS, marglik_frequency=1)
    t_start = time.perf_counter()
    res = dict(phase="marglik_training", nvidia_smi=smi, config="bench.py 3a",
               model="BenchCNN (convs 32/64/64/128, Dense_0 to 10)", n_data=MT_N,
               batch=MT_BATCH, epochs=MT_EPOCHS, hypersteps=MT_HYPERSTEPS, dtype="float32")
    net = bench_cnn(seed, torch.float32).to(device)
    flags0 = tf32_flags()
    zero_launches()
    with PanelTally({"latrd_panel": "latrd"}, keep=True) as tally:
        la, _, margliks, losses = timed(res, "seconds", lambda: marglik_training(
            net, ArrayLoader(X, y, batch_size=MT_BATCH), device=device, **kw))
    launches = kernel_launches(*MAIN_LAUNCHES)
    flags_after = tf32_flags()
    probs = la(X[:8])
    row_err = float((probs.sum(-1) - 1).abs().max())
    eig_err = kernel_eig_err(la)
    panels = path_panels_vs_plain(latrd_panel, latrd_panel_plain, tally.inputs["latrd_panel"])

    # the same run in float64, on the card (v1's launches counted again) and
    # on the CPU
    f64 = []
    for dev in (device, torch.device("cpu")):
        zero_launches()
        t = {}
        _, _, ml, lo = timed(t, "s", lambda: marglik_training(
            bench_cnn(seed, torch.float64), ArrayLoader(X.astype(np.float64), y,
                                                        batch_size=MT_BATCH), device=dev, **kw))
        f64.append((np.asarray(ml), np.asarray(lo), t["s"], latrd_panel.launches))
    (ml_g, lo_g, s_g, f64_launches), (ml_c, lo_c, s_c, _) = f64
    res.update(n_params=la.n_params, epochs_per_sec=MT_EPOCHS / res["seconds"],
               margliks=margliks, losses=losses,
               layerwise_prior=la.prior_precision.tolist(), launches=launches,
               v1_windows={f"{k[0]}x{k[1]}@{k[2]}": n for k, n in tally.counts["latrd_panel"].items()},
               v1_vs_plain=panels, eig_rel_err_vs_eigh=eig_err,
               probit_row_sum_err=row_err, tf32_flags_before=flags0, tf32_flags_after=flags_after,
               f64_card_s=s_g, f64_cpu_s=s_c, f64_card_v1_launches=f64_launches,
               f64_marglik_rel_err=float(np.abs(ml_g - ml_c).max() / np.abs(ml_c).max()),
               f64_loss_rel_err=float(np.abs(lo_g - lo_c).max() / np.abs(lo_c).max()),
               phase_s=time.perf_counter() - t_start)
    emit(res)
    check(isinstance(la, KronLaplace), f"marglik_training returned a {type(la).__name__}")
    check(len(margliks) == MT_EPOCHS * MT_HYPERSTEPS and all(map(math.isfinite, margliks)),
          f"margliks {margliks}")
    check(launches["latrd_panel"] > 0 and launches["latrd_panel"] % 3 == 0,
          f"v1 launched {launches['latrd_panel']} panels, not the same number on each of 3 fits")
    check(sum(tally.counts["latrd_panel"].values()) == launches["latrd_panel"]
          and all(k[0] == 2 for k in tally.counts["latrd_panel"]),
          f"v1 panels {tally.counts['latrd_panel']}: not all of the (2, 576) class")
    check(row_err <= 1e-5 and tuple(probs.shape) == (8, 10), f"probit rows sum to 1 within {row_err}")
    check(flags_after == flags0, f"TF32 switches {flags0} read {flags_after} after marglik_training")
    check(eig_err <= EIG_TOL, f"marglik_training eigenvalues off by {eig_err:.3e} > {EIG_TOL}")
    check(len(panels) == len(tally.counts["latrd_panel"]),
          f"v1 held against plain at {len(panels)} of {len(tally.counts['latrd_panel'])} windows")
    check(f64_launches == launches["latrd_panel"],
          f"the float64 card run launched v1 {f64_launches} times, the float32 run "
          f"{launches['latrd_panel']}")
    check(res["f64_marglik_rel_err"] <= MT_F64_TOL and res["f64_loss_rel_err"] <= MT_F64_TOL,
          f"float64 card vs CPU: margliks {res['f64_marglik_rel_err']:.3e}, "
          f"losses {res['f64_loss_rel_err']:.3e} > {MT_F64_TOL}")
    return launches


def window_study(seeds, device, smi):
    """`--window-study SEEDS`: the `marglik_training` phase's float32 run
    once a seed (data and weights from the seed), and v1 on each run's
    last-fit windows through `path_panels_vs_plain`; one JSON line a seed,
    then for each window key the median and largest of each number over the
    seeds, and on how many seeds v1's error against float64 exceeds twice
    the plain float32 panel's, the lower-half plain panel's does the same,
    and v1 is beyond PANEL_TOL of plain."""
    import numpy as np
    import torch

    from laplace_jax_torch import marglik_training
    from laplace_jax_torch.ops.latrd import latrd_panel, latrd_panel_plain
    from laplace_jax_torch.utils.data import ArrayLoader

    by_key = {}
    for seed in range(seeds):
        rng = np.random.default_rng(seed)
        X = rng.standard_normal((MT_N, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, MT_N)
        res = dict(phase="window_study", seed=seed)
        with PanelTally({"latrd_panel": "latrd"}, keep=True) as tally:
            timed(res, "path_s", lambda: marglik_training(
                bench_cnn(seed, torch.float32).to(device), ArrayLoader(X, y, batch_size=MT_BATCH),
                likelihood="classification", hessian_structure="kron", n_epochs=MT_EPOCHS,
                n_hypersteps=MT_HYPERSTEPS, marglik_frequency=1, device=device))
        try:
            rows, failed = path_panels_vs_plain(latrd_panel, latrd_panel_plain,
                                                tally.inputs["latrd_panel"]), False
        except SystemExit:  # a check failed (its message is on stderr): the study goes on
            rows, failed = {}, True
        for key, row in rows.items():
            by_key.setdefault(key, []).append(row)
        emit(dict(res, failed=failed, windows=rows))

    def stat(rows, name):
        vals = np.array([r[name] for r in rows])
        return dict(median=float(np.median(vals)), max=float(vals.max()))

    names = ("residual", "residual_f64", "plain_residual", "rel_err", "err_vs_f64",
             "plain_err_vs_f64", "lower_plain_err_vs_f64")
    emit(dict(phase="window_study", nvidia_smi=smi, seeds=seeds, summary={
        key: dict({n: stat(rows, n) for n in names}, seeds=len(rows),
                  residual_over_plain=dict(min=min(r["residual"] / r["plain_residual"] for r in rows),
                                           max=max(r["residual"] / r["plain_residual"] for r in rows)),
                  kernel_over_2x_plain=sum(r["err_vs_f64"] > 2 * r["plain_err_vs_f64"] for r in rows),
                  lower_over_2x_plain=sum(r["lower_plain_err_vs_f64"] > 2 * r["plain_err_vs_f64"]
                                          for r in rows),
                  rel_err_over_panel_tol=sum(r["rel_err"] > PANEL_TOL for r in rows))
        for key, rows in by_key.items()}))


NN_F32_TOL = 1e-3  # a float32 sampled network vs float64, relative to its largest output
F32_MAX = 3.4028234663852886e38


class GaussianNLL:
    """The mean Gaussian negative log likelihood of targets under a
    regression predictive `(f_mu, f_var)` plus the noise variance."""

    def __init__(self, sigma_noise: float):
        self.s2 = sigma_noise**2
        self.reset()

    def reset(self):
        self.total, self.count = 0.0, 0

    def update(self, mean, var, y):
        import torch

        var = torch.diagonal(var, dim1=-2, dim2=-1) if var.ndim > mean.ndim else var
        v = var.double() + self.s2
        nll = 0.5 * (torch.log(2 * math.pi * v) + (y.double() - mean.double()) ** 2 / v)
        self.total += float(nll.sum())
        self.count += mean.shape[0]

    def compute(self):
        return self.total / self.count


def rms_ratio(a, b):
    """rms(a) / rms(b), or None where b is all zeros."""
    rb = float(b.double().pow(2).mean().sqrt())
    return float(a.double().pow(2).mean().sqrt()) / rb if rb > 0 else None


def nn_samples_report(la, x, gen, pred):
    """What the NN predictive `pred` = (mean, var) of `la` drew: the same
    16 weight samples (`gen` seeded as for `pred`), each leaf's spread about
    the mean against the prior (mean squared deviation times the leaf's prior
    precision: the posterior covariance is at most the prior's, so at most 1
    up to the noise of 16 draws), and each Conv/Dense layer's largest
    |output| over the samples in float32 and, for the same weights, in
    float64. A sample whose float64 outputs all stay inside float32's range
    must agree with its float32 run within NN_F32_TOL."""
    import copy

    import torch
    from torch import nn

    from laplace_jax_torch.models.resnet import Conv
    from laplace_jax_torch.nnmodel import NNModel
    from laplace_jax_torch.utils.device import full_f32

    theta = la.sample(16, generator=gen)
    dev2 = (theta - la.mean).double().pow(2).mean(0) * la.prior_precision_diag.double()
    # each leaf's spread over its bound, 1 + 6 standard deviations of the
    # mean of 16 x size squared standard normals
    spread = {"/".join(sp.path): float(dev2[sp.offset:sp.offset + sp.size].mean())
              / (1 + 6 * math.sqrt(2 / (16 * sp.size))) for sp in la.model.leaf_specs}

    def run(module, thetas, xx):
        peaks, hooks = {}, []
        for name, m in module.named_modules():
            if isinstance(m, (Conv, nn.Linear)):
                def hook(_, __, out, name=name):
                    a = out.detach().abs()
                    fin = a[torch.isfinite(a)]
                    peaks.setdefault(name, []).append(
                        (float(fin.max()) if fin.numel() else 0.0, bool(torch.isfinite(a).all())))
                hooks.append(m.register_forward_hook(hook))
        nnm = NNModel(module)
        try:
            with torch.no_grad(), full_f32():
                fs = torch.stack([nnm.apply_vec(t, xx) for t in thetas])
        finally:
            for h in hooks:
                h.remove()
        return fs, peaks

    net = la.model.module
    f32, peaks32 = run(net, theta, la._tensor(x))
    f64, peaks64 = run(copy.deepcopy(net).double(), theta.double(), la._tensor(x).double())
    # per sample: its largest float64 output over every layer
    top64 = [max(v[s][0] for v in peaks64.values()) for s in range(len(theta))]
    inside = [s for s, t in enumerate(top64) if t < F32_MAX / 16]
    errs = [float((f32[s].double() - f64[s]).abs().max() / f64[s].abs().max().clamp(min=1e-300))
            for s in inside]
    first_nonfinite = next((n for n, v in peaks32.items() if not all(ok for _, ok in v)), None)
    mean, var = pred
    # the predictive of the float64 outputs, as the port forms it
    pred64_max = max(float(f64.mean(0).abs().max()), float(f64.var(0, unbiased=False).max()))
    return dict(
        prior_precision=la.prior_precision.tolist(),
        spread_over_bound_max=max(spread.values()), spread_over_bound=spread,
        deviation_rms_over_mean_rms={"/".join(sp.path): rms_ratio(
            theta[:, sp.offset:sp.offset + sp.size] - la.mean[sp.offset:sp.offset + sp.size],
            la.mean[sp.offset:sp.offset + sp.size]) for sp in la.model.leaf_specs},
        peak_f32={n: max(p for p, _ in v) for n, v in peaks32.items()},
        peak_f64={n: max(p for p, _ in v) for n, v in peaks64.items()},
        first_nonfinite_layer_f32=first_nonfinite,
        f32_samples_finite=int(torch.isfinite(f32).flatten(1).all(1).sum()),
        samples_beyond_f32=sum(t >= F32_MAX for t in top64),
        f64_finite=bool(torch.isfinite(f64).all()),
        f64_abs_max=float(f64.abs().max()),
        in_range_samples=len(inside), in_range_rel_err=max(errs, default=0.0),
        in_range_agree=all(e <= NN_F32_TOL for e in errs),
        predictive_finite=bool(torch.isfinite(mean).all() and torch.isfinite(var).all()),
        predictive_nan=bool(torch.isnan(mean).any() or torch.isnan(var).any()),
        predictive_f64_max=pred64_max, predictive_f64_beyond_f32=pred64_max >= F32_MAX)


def regression_phase(seed, device, smi):
    """Regression at full width: ResNet-18 (width 64, one output) on the
    main path's 512 inputs with float targets from `seed`, batch 128,
    float32: an all-weights `KronLaplace` (v1 and v4 launches read from its
    fit), 100 marglik steps tuning a layerwise prior, the marglik's gradient in
    `sigma_noise`, the GLM `(f_mu, f_var)` and `log_prob(la.mean)`, NN
    predictives (16 samples from `KronLaplace.sample`) on 8 inputs under the
    tuned prior and under one at the initialization's scale; a FullLL fit
    (syrk launches read from it); and gridsearches on a KronLL (Gaussian
    NLL and the default `RunningMSEMetric`, 128 validation inputs, the
    default grid of 100)."""
    import numpy as np
    import torch

    from laplace_jax_torch import KronLaplace, Laplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.utils.data import ArrayLoader

    t_start = time.perf_counter()
    _, loader, X_test = full_width(seed)
    rng = np.random.default_rng(seed + 1)
    y = rng.standard_normal((loader.n_data, 1)).astype(np.float32)
    train = ArrayLoader(loader.x, y, batch_size=128)
    net = ResNet18(width=64, num_classes=1, generator=torch.Generator().manual_seed(seed))
    res = dict(phase="regression", nvidia_smi=smi, model="ResNet18(width=64, num_classes=1)",
               n_data=loader.n_data, batch=128, dtype="float32")

    la = KronLaplace(net, "regression", device=device)
    zero_launches()
    timed(res, "kron_fit_s", lambda: la.fit(train))
    launches = kernel_launches(*MAIN_LAUNCHES)
    res.update(n_params=la.n_params, launches=launches, log_marglik=float(la.log_marginal_likelihood()))
    timed(res, "marglik_100_steps_s", lambda: la.optimize_prior_precision(
        method="marglik", n_steps=100, prior_structure="layerwise"))
    res["prior_precision"] = la.prior_precision.tolist()
    sn = torch.tensor(1.0, device=device, requires_grad=True)
    lml = timed(res, "marglik_grad_s", lambda: la.log_marginal_likelihood(sigma_noise=sn))
    lml.backward()
    res["marglik_grad_sigma_noise"] = float(sn.grad)
    f_mu, f_var = timed(res, "glm_predictive_8_s", lambda: la(X_test[:8]))
    res["f_var_min"] = float(f_var.min())
    log_prob = float(timed(res, "log_prob_s", lambda: la.log_prob(la.mean)))
    res["log_prob_at_mean"] = log_prob

    # the NN predictive under the tuned prior, and what its 16 weight
    # samples do: their spread against the prior's, each layer's largest
    # output in float32 and, for the same weights, in float64
    def nn_predictive():
        return la(X_test[:8], pred_type="nn", link_approx="mc", n_samples=16,
                  generator=torch.Generator(device=device).manual_seed(seed))

    tuned = timed(res, "nn_predictive_tuned_16x8_s", nn_predictive)
    res["nn_tuned"] = nn_samples_report(la, X_test[:8],
                                        torch.Generator(device=device).manual_seed(seed), tuned)
    # and under a prior at the scale of the initialization, 1 / mean(w^2) a
    # layer, whose samples stay inside float32's range
    res["nn_prior_precision"] = [1.0 / max(float(la.mean[sp.offset:sp.offset + sp.size].pow(2)
                                                 .mean()), 1e-4) for sp in la.model.leaf_specs]
    la.prior_precision = res["nn_prior_precision"]
    nn_mean, nn_var = timed(res, "nn_predictive_16x8_s", nn_predictive)
    res["nn_init_scale"] = nn_samples_report(la, X_test[:8],
                                             torch.Generator(device=device).manual_seed(seed),
                                             (nn_mean, nn_var))

    full = Laplace(net, "regression", "last_layer", "full", device=device)
    zero_launches()
    timed(res, "full_ll_fit_s", lambda: full.fit(train))
    res["full_ll_syrk_launches"] = kernel_launches("syrk")["syrk"]
    res["full_ll_log_marglik"] = float(full.log_marginal_likelihood())

    # the gridsearch scored by the Gaussian NLL of f under (f_mu, f_var),
    # which depends on the prior, on validation targets drawn from that
    # predictive at the grid's middle prior (so the best prior lies inside
    # the grid); its choice against the argmin of the same scores taken
    # outside the gridsearch
    kron_ll = Laplace(net, "regression", device=device)
    timed(res, "kron_ll_fit_s", lambda: kron_ll.fit(train))
    grid = np.logspace(-4, 4, 100)
    kron_ll.prior_precision = float(grid[50])
    mu, var = kron_ll(X_test, diagonal_output=True)
    z = torch.as_tensor(rng.standard_normal(tuple(mu.shape)), dtype=mu.dtype, device=device)
    y_val = mu + z * var.sqrt()
    val = ArrayLoader(X_test, y_val.cpu().numpy(), batch_size=128)
    timed(res, "gridsearch_100_s", lambda: kron_ll.optimize_prior_precision(
        method="gridsearch", val_loader=val, loss=GaussianNLL(0.0)))
    res["gridsearch_prior_precision"] = chosen = float(kron_ll.prior_precision[0])
    # the default score for regression, `RunningMSEMetric`, sees only f_mu,
    # which the prior does not move: this shows only that a grid value
    # comes back
    timed(res, "gridsearch_mse_100_s", lambda: kron_ll.optimize_prior_precision(
        method="gridsearch", val_loader=val))
    res["gridsearch_mse_prior_precision"] = float(kron_ll.prior_precision[0])
    scores = []
    for p in grid:
        kron_ll.prior_precision = float(p)
        nll = GaussianNLL(0.0)
        nll.update(*kron_ll(X_test), y_val)
        scores.append(nll.compute())
    res["gridsearch_scores"] = dict(targets_at=float(grid[50]), min=min(scores), max=max(scores),
                                    argmin=float(grid[int(np.argmin(scores))]))
    res["phase_s"] = time.perf_counter() - t_start
    emit(res)

    check(la.n_params == 11_159_745, f"regression ResNet-18 has {la.n_params} weights")
    check(launches == MAIN_LAUNCHES, f"regression fit launches {launches}, not {MAIN_LAUNCHES}")
    check(math.isfinite(res["log_marglik"]), "regression marglik is not finite")
    check(len(res["prior_precision"]) == la.n_layers
          and all(math.isfinite(p) and p > 0 for p in res["prior_precision"]),
          f"tuned layerwise prior precision {res['prior_precision']}")
    check(math.isfinite(res["marglik_grad_sigma_noise"]), "marglik gradient in sigma_noise")
    check(tuple(f_mu.shape) == (8, 1) and tuple(f_var.shape) == (8, 1, 1)
          and bool(torch.isfinite(f_mu).all()) and res["f_var_min"] > 0,
          f"GLM predictive shapes {tuple(f_mu.shape)}, {tuple(f_var.shape)}, min var {res['f_var_min']}")
    check(tuple(nn_mean.shape) == (8, 1) and bool(torch.isfinite(nn_mean).all())
          and bool(torch.isfinite(nn_var).all()) and bool((nn_var >= 0).all()),
          "NN predictive under the initialization-scale prior is not finite")
    for name in ("nn_tuned", "nn_init_scale"):
        r = res[name]
        check(r["spread_over_bound_max"] <= 1, f"{name}: a leaf's samples spread wider than "
              f"the prior allows ({r['spread_over_bound_max']:.3f} of the bound)")
        check(r["f64_finite"], f"{name}: float64 outputs of the sampled networks are not finite")
        check(r["in_range_agree"], f"{name}: a sample inside float32's range disagrees with "
              f"float64 ({r['in_range_rel_err']:.3e} > {NN_F32_TOL})")
        check(not r["predictive_nan"], f"{name}: the NN predictive holds NaN")
        check(r["predictive_finite"] or r["samples_beyond_f32"] > 0 or r["predictive_f64_beyond_f32"],
              f"{name}: the NN predictive is not finite, yet in float64 neither a sample nor "
              f"the predictive leaves float32's range")
    check(math.isfinite(log_prob), f"log_prob(la.mean) = {log_prob}")
    check(res["full_ll_syrk_launches"] == 4,
          f"the regression FullLL fit launched syrk {res['full_ll_syrk_launches']} times, not 4")
    check(math.isfinite(res["full_ll_log_marglik"]), "FullLL regression marglik is not finite")
    check(res["gridsearch_scores"]["max"] > res["gridsearch_scores"]["min"],
          f"gridsearch scores do not vary with the prior: {res['gridsearch_scores']}")
    check(math.isclose(chosen, res["gridsearch_scores"]["argmin"], rel_tol=1e-6),
          f"gridsearch chose {chosen}, the scores' argmin is {res['gridsearch_scores']['argmin']}")
    check(grid[0] < chosen < grid[-1], f"gridsearch chose {chosen}, an end of the grid")
    check(bool(np.isclose(grid, res["gridsearch_mse_prior_precision"], rtol=1e-6).any()),
          f"MSE gridsearch chose {res['gridsearch_mse_prior_precision']}, not a grid value")
    return {"latrd_panel": launches["latrd_panel"], "latrd_panel_v4": launches["latrd_panel_v4"],
            "syrk": res["full_ll_syrk_launches"]}

# bench.py's gp_fit_predict: LeNet on 2048 28x28x1 inputs, batch 128, an SoD of 512
GP_N, GP_BATCH, GP_M, GP_TEST, GP_VAL = 2048, 128, 512, 64, 128
GP_GRID = 21  # gridsearch values over the default [1e-4, 1e4]
GP_F32_TOL = 1e-4  # streamed vs cached fit, float32: K_MM and Sigma_chol relative to
# their largest entry, the probit probabilities absolute
GP_F64_M = 64  # the SoD of the float64 card-vs-CPU fit (bounds the CPU's time)
F64_REL_TOL = 1e-9  # float64 card vs CPU: K_MM, H, margliks and predictives, relative
# bench.py config 3b: FullSubnetLaplace on BenchCNN's 128 largest weights, 256 inputs, batch 64
SUB_N, SUB_BATCH, SUB_K = 256, 64, 128


def device_busy(res, name, fn):
    """`fn()` once under `torch.profiler`: its seconds there (host clock,
    synchronized) in `res[name]`, the seconds the card spent in the kernels
    and copies it ran in `res[name + "_device"]`, and their number in
    `res[name + "_device_ops"]`."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        timed(res, name, fn)
    ops = [e for e in prof.events() if e.device_type.name == "CUDA"]
    res[f"{name}_device"] = sum(e.time_range.end - e.time_range.start for e in ops) / 1e6
    res[f"{name}_device_ops"] = len(ops)


def gp_fit_parts(la):
    """The streamed GP fit's parts, each timed alone on the fit's own SoD
    batches (host clock, synchronized; TF32 off, as in `fit`): its first
    pass (a forward and a jvp a batch), one Jacobian pass over the M
    samples (the streamed fit makes one a batch pair (i, j >= i), so
    (nb + 1) / 2 passes over nb batches), K_MM's block products, the cached
    path's one Gram product in their place, and Σ's Cholesky; one batch's
    Jacobians under the profiler, the card's busy time against the wall;
    and the Jacobian pass again after the profiler (the first time a
    process profiles, later launches may cost the host more)."""
    import torch

    from laplace_jax_torch.utils.device import full_f32

    xs, parts = la._sod_x, {}
    nb = len(xs)

    def first_pass():
        for x in xs:
            with torch.no_grad():
                f = la.model.apply(x)
            la._mean_scatter_term_batch_streaming(x, f, None)

    with full_f32():
        timed(parts, "first_pass_s", first_pass)
        Js = timed(parts, "jacobians_M_s", lambda: [la._jacobians(x)[0] for x in xs])
        timed(parts, "kmm_block_products_s", lambda: [
            torch.einsum("mcp,nep->mcne", Js[i], Js[j]) for i in range(nb) for j in range(i, nb)])
        Jflat = torch.cat(Js).flatten(0, 1)
        del Js
        timed(parts, "kmm_gram_s", lambda: Jflat @ Jflat.T)
        del Jflat
        timed(parts, "sigma_cholesky_s", la._build_Sigma_inv)
        device_busy(parts, "jacobians_batch_profiled_s", lambda: la._jacobians(xs[0]))
        timed(parts, "jacobians_M_after_profiler_s", lambda: [la._jacobians(x)[0] for x in xs])
    parts["jacobian_passes"] = (nb + 1) / 2
    parts["streamed_sum_of_parts_s"] = (parts["first_pass_s"] + parts["jacobian_passes"]
                                        * parts["jacobians_M_s"] + parts["kmm_block_products_s"]
                                        + parts["sigma_cholesky_s"])
    parts["jacobian_ms_per_sample"] = 1e3 * parts["jacobians_M_s"] / la.n_subset
    return parts


def functional_phase(seed, device, smi, keep):
    """`bench.py`'s `gp_fit_predict` at full size: `FunctionalLaplace` on
    LeNet (28x28x1, 10 classes, 107,786 weights, flax's initializers from
    `seed`) over 2048 inputs, batch 128, an SoD of 512, float32. The auto
    rule must stream (the (M, C, P) Jacobian cache would be 2.21 GB); a
    warm-up fit, then the timed fit and `la(x[:64])`; a second fit with
    `streaming=False` (the 2.2 GB cache fits the card), held against the
    streamed one; a gridsearch on 128 validation inputs; FunctionalLLLaplace
    and `independent_outputs=True` once each; and a float64 fit on the card
    against the CPU at an SoD of 64. No kernel of the port may launch: the
    JAX package computes this path outside Pallas too."""
    import numpy as np
    import torch

    from laplace_jax_torch import FunctionalLaplace, FunctionalLLLaplace
    from laplace_jax_torch.functional_laplace import _STREAMING_THRESHOLD_BYTES
    from laplace_jax_torch.models.lenet import LeNet
    from laplace_jax_torch.utils.data import ArrayLoader

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((GP_N, 28, 28, 1)).astype(np.float32)
    y = rng.integers(0, 10, GP_N)
    Xv = rng.standard_normal((GP_VAL, 28, 28, 1)).astype(np.float32)
    loader, X_test = ArrayLoader(X, y, batch_size=GP_BATCH), X[:GP_TEST]
    net = LeNet(generator=torch.Generator().manual_seed(seed))
    res = dict(phase="functional", nvidia_smi=smi, config="bench.py gp_fit_predict",
               model="LeNet (28x28x1, 10 classes)", n_data=GP_N, batch=GP_BATCH, n_subset=GP_M,
               dtype="float32")
    zero_launches()

    la = FunctionalLaplace(net, "classification", n_subset=GP_M, device=device)
    cache_bytes = GP_M * 10 * la.n_params * 4
    la.fit(loader)  # warm-up, as bench.py
    la(X_test)
    torch.cuda.reset_peak_memory_stats()
    timed(res, "gp_fit_sec", lambda: la.fit(loader))
    res["gp_fit_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    probs = timed(res, "gp_predict_sec", lambda: la(X_test))
    res["gp_fit_parts"] = gp_fit_parts(la)
    res.update(n_params=la.n_params, jacobian_cache_bytes=cache_bytes,
               threshold_bytes=_STREAMING_THRESHOLD_BYTES,
               path="streaming" if la.Js_M is None else "cached",
               probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()),
               log_marglik=float(la.log_marginal_likelihood()))

    cached = FunctionalLaplace(net, "classification", n_subset=GP_M, streaming=False,
                               device=device)
    torch.cuda.reset_peak_memory_stats()
    timed(res, "gp_fit_sec_cached", lambda: cached.fit(loader))
    res["gp_fit_cached_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    probs_c = timed(res, "gp_predict_sec_cached", lambda: cached(X_test))
    res.update(cached_path="streaming" if cached.Js_M is None else "cached",
               K_MM_rel_err_stream_vs_cached=rel_err(la.K_MM, cached.K_MM),
               Sigma_chol_rel_err_stream_vs_cached=rel_err(la.Sigma_chol, cached.Sigma_chol),
               probs_abs_err_stream_vs_cached=float((probs - probs_c).abs().max()),
               log_marglik_cached=float(cached.log_marginal_likelihood()))

    # the gridsearch on the cached fit (each grid value rebuilds Σ and runs
    # the predictive), on two sets of validation labels: each input's most
    # likely class under the fit's predictive (the NLL falls as the variance
    # does) and its least likely (the NLL falls as the predictive flattens),
    # so the two best priors differ; each choice against the argmin of the
    # same NLL scores taken outside the gridsearch
    grid = np.logspace(-4, 4, GP_GRID)
    pv = cached(Xv)
    labels = {"mode": pv.argmax(-1), "least": pv.argmin(-1)}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        for name, yv in labels.items():
            timed(res, f"gridsearch_{name}_sec", lambda: cached.optimize_prior_precision(
                method="gridsearch", val_loader=ArrayLoader(Xv, yv.cpu().numpy(),
                                                            batch_size=GP_BATCH),
                grid_size=GP_GRID))
            res[f"gridsearch_{name}_prior_precision"] = float(cached.prior_precision[0])
        res["gridsearch_probit_row_sum_err"] = float((cached(X_test).sum(-1) - 1).abs().max())
        scores = {name: [] for name in labels}
        for p in grid:
            cached.prior_precision = float(p)
            try:
                pv = cached(Xv)
                for name, yv in labels.items():
                    scores[name].append(float(-torch.log(pv[torch.arange(GP_VAL), yv]).mean()))
            except torch.linalg.LinAlgError:  # as the gridsearch: a failed factor scores inf
                for name in labels:
                    scores[name].append(math.inf)
    res["gridsearch_scores"] = {name: dict(min=min(sc), max=max(sc),
                                           argmin=float(grid[int(np.argmin(sc))]))
                                for name, sc in scores.items()}

    ind = FunctionalLaplace(net, "classification", n_subset=GP_M, streaming=False,
                            independent_outputs=True, device=device)
    timed(res, "independent_fit_sec", lambda: ind.fit(loader))
    K_full = cached.K_MM.view(GP_M, 10, GP_M, 10)
    res["independent_K_rel_err_vs_blocks"] = max(
        rel_err(ind.K_MM[c], K_full[:, c, :, c]) for c in range(10))
    res["independent_probit_row_sum_err"] = float((ind(X_test).sum(-1) - 1).abs().max())
    res["independent_log_marglik"] = float(ind.log_marginal_likelihood())

    ll = FunctionalLLLaplace(net, "classification", n_subset=GP_M, device=device)
    timed(res, "ll_fit_sec", lambda: ll.fit(loader))
    res.update(ll_last_layer=list(ll.last_layer_path), ll_n_params=ll.n_params,
               ll_path="streaming" if ll.Js_M is None else "cached",
               ll_probit_row_sum_err=float((ll(X_test).sum(-1) - 1).abs().max()),
               ll_log_marglik=float(ll.log_marginal_likelihood()))
    res["launches"] = kernel_launches()

    # float64: the card against the CPU, at an SoD of 64
    f64 = []
    loader64 = ArrayLoader(X.astype(np.float64), y, batch_size=GP_BATCH)
    for dev in (device, torch.device("cpu")):
        la64 = FunctionalLaplace(LeNet(generator=torch.Generator().manual_seed(seed)).double(),
                                 "classification", n_subset=GP_F64_M, device=dev)
        t = {}
        timed(t, "s", lambda: la64.fit(loader64))
        f64.append((la64.K_MM.cpu(), float(la64.log_marginal_likelihood()),
                    la64(X_test.astype(np.float64)).cpu(), t["s"]))
    (K_g, l_g, p_g, s_g), (K_c, l_c, p_c, s_c) = f64
    res.update(f64_n_subset=GP_F64_M, f64_card_s=s_g, f64_cpu_s=s_c,
               f64_K_MM_rel_err=rel_err(K_g, K_c), f64_log_marglik_rel_err=abs(l_g - l_c) / abs(l_c),
               f64_probs_rel_err=rel_err(p_g, p_c), phase_s=time.perf_counter() - t_start)
    emit(res)

    check(res["path"] == "streaming" and cache_bytes > _STREAMING_THRESHOLD_BYTES,
          f"the auto rule took the {res['path']} path at a {cache_bytes} B cache")
    check(res["cached_path"] == "cached", "streaming=False did not cache the Jacobians")
    check(la.n_params == 107786, f"LeNet has {la.n_params} weights, not 107,786")
    for name in ("", "gridsearch_", "independent_", "ll_"):
        check(res[f"{name}probit_row_sum_err"] <= 1e-5,
              f"{name or 'streamed '}probit rows sum to 1 within {res[f'{name}probit_row_sum_err']}")
    check(tuple(probs.shape) == (GP_TEST, 10) and bool(torch.isfinite(probs).all()),
          f"GP predictive of shape {tuple(probs.shape)}, or not finite")
    for name in ("log_marglik", "log_marglik_cached", "independent_log_marglik", "ll_log_marglik"):
        check(math.isfinite(res[name]), f"{name} {res[name]} is not finite")
    for name in ("K_MM_rel_err_stream_vs_cached", "Sigma_chol_rel_err_stream_vs_cached",
                 "probs_abs_err_stream_vs_cached", "independent_K_rel_err_vs_blocks"):
        check(res[name] <= GP_F32_TOL, f"{name} {res[name]:.3e} > {GP_F32_TOL}")
    check(math.isclose(res["log_marglik"], res["log_marglik_cached"], rel_tol=GP_F32_TOL),
          f"streamed marglik {res['log_marglik']} vs cached {res['log_marglik_cached']}")
    for name, sc in res["gridsearch_scores"].items():
        chosen = res[f"gridsearch_{name}_prior_precision"]
        check(sc["max"] > sc["min"], f"gridsearch scores ({name} labels) do not vary: {sc}")
        check(math.isclose(chosen, sc["argmin"], rel_tol=1e-6),
              f"gridsearch ({name} labels) chose {chosen}, the scores' argmin is {sc['argmin']}")
    check(res["gridsearch_scores"]["mode"]["argmin"] != res["gridsearch_scores"]["least"]["argmin"],
          f"the two label sets' best priors coincide: {res['gridsearch_scores']}")
    check(res["ll_last_layer"] == ["Dense_2"] and ll.n_params == 850,
          f"FunctionalLL took {res['ll_last_layer']} with {ll.n_params} weights")
    check(not any(res["launches"].values()), f"the GP path launched kernels: {res['launches']}")
    for name in ("f64_K_MM_rel_err", "f64_log_marglik_rel_err", "f64_probs_rel_err"):
        check(res[name] <= F64_REL_TOL, f"float64 card vs CPU: {name} {res[name]:.3e} > "
                                        f"{F64_REL_TOL}")
    keep["functional_gp_streamed"] = (la, lambda: FunctionalLaplace(
        net, "classification", n_subset=GP_M, device=device), X_test[:8])


class SyrkTally:
    """Within `with`, every `syrk` call the curvature backend makes is
    recorded: a copy of its M and of its H (the kernel's launch count is
    untouched)."""

    def __enter__(self):
        from laplace_jax_torch.curvature import backend

        self.calls, self.inner = [], backend.syrk

        def recorded(M):
            H = self.inner(M)
            self.calls.append((M.clone(), H.clone()))
            return H

        backend.syrk = recorded
        return self

    def __exit__(self, *exc):
        from laplace_jax_torch.curvature import backend

        backend.syrk = self.inner


def subnet_phase(seed, device, smi, keep):
    """`bench.py` config 3b at full size: BenchCNN (131,466 weights) on 256
    CIFAR-10-shaped inputs, batch 64, float32; `LargestMagnitudeSubnetMask(128)`
    into `Laplace(..., "subnetwork", "full")`: a warm-up fit with every syrk
    launch's M and H recorded (each H against `syrk_plain` on its M, exactly
    symmetric), then the timed fit (`subnet_full_fit_sec`) with its 4 syrk
    launches read from it; the syrk kernel timed at that (640, 128) shape; a
    GLM predictive and a log marglik; `DiagSubnetLaplace` once (against the
    full H's diagonal); the two variance masks timed (an all-weights
    `DiagLaplace`, and SWAG at its defaults: 40 epochs); then float64 fits
    on the card and on the CPU, H and the marglik against each other."""
    import numpy as np
    import torch

    from laplace_jax_torch import DiagLaplace, DiagSubnetLaplace, FullSubnetLaplace, Laplace
    from laplace_jax_torch.ops.syrk import syrk, syrk_plain
    from laplace_jax_torch.utils.data import ArrayLoader
    from laplace_jax_torch.utils.device import full_f32
    from laplace_jax_torch.utils.subnetmask import (
        LargestMagnitudeSubnetMask,
        LargestVarianceDiagLaplaceSubnetMask,
        LargestVarianceSWAGSubnetMask,
    )

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((SUB_N, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, SUB_N)
    loader = ArrayLoader(X, y, batch_size=SUB_BATCH)
    net = bench_cnn(seed, torch.float32)
    res = dict(phase="subnet", nvidia_smi=smi, config="bench.py 3b",
               model="BenchCNN (convs 32/64/64/128, Dense_0 to 10)", n_data=SUB_N,
               batch=SUB_BATCH, n_params_subnet=SUB_K, dtype="float32")
    idx = timed(res, "magnitude_select_sec",
                lambda: LargestMagnitudeSubnetMask(net, SUB_K, device=device).select(loader))
    la = Laplace(net, "classification", "subnetwork", "full", subnetwork_indices=idx,
                 device=device)
    zero_launches()
    with SyrkTally() as tally:
        la.fit(loader)  # warm-up, as bench.py
    warm_launches = syrk.launches
    H_warm = la.H.clone()
    zero_launches()
    timed(res, "subnet_full_fit_sec", lambda: la.fit(loader))
    res["launches"] = kernel_launches()
    # the fit's per-sample Jacobians timed alone (TF32 off, as in `fit`),
    # and one batch's under the profiler
    parts, xs = {}, [la._tensor(la._unpack_batch(data)[0]) for data in loader]
    with full_f32():
        timed(parts, "jacobians_s", lambda: [la.backend.jacobians(x) for x in xs])
        device_busy(parts, "jacobians_batch_profiled_s", lambda: la.backend.jacobians(xs[0]))
    parts["jacobian_ms_per_sample"] = 1e3 * parts["jacobians_s"] / SUB_N
    res["subnet_fit_parts"] = parts
    per_launch = [dict(shape=list(M.shape), rel_err=rel_err(H, syrk_plain(M)),
                       exactly_symmetric=bool(torch.equal(H, H.mT))) for M, H in tally.calls]
    H_sum = tally.calls[0][1]
    for _, H in tally.calls[1:]:
        H_sum = H_sum + H
    M = tally.calls[0][0]
    bound_ms, bound_by = syrk_bound_ms(*M.shape, M.element_size(), F32_FLOPS)
    res.update(n_params=la.n_params, warm_fit_syrk_launches=warm_launches, syrk_per_launch=per_launch,
               fit_H_equals_sum_of_launches=bool(torch.equal(H_sum, H_warm)),
               fits_H_rel_err=rel_err(la.H, H_warm),
               syrk_640x128=dict(shape=list(M.shape), ms=cuda_ms(lambda: syrk(M), reps=50),
                                 plain_ms=cuda_ms(lambda: syrk_plain(M), reps=50),
                                 library_ms=cuda_ms(lambda: torch.mm(M.mT, M), reps=50),
                                 bound_ms=bound_ms, bound_by=bound_by))
    probs = timed(res, "glm_predict_8_sec", lambda: la(X[:8]))
    res.update(probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()),
               log_marglik=float(la.log_marginal_likelihood()))

    diag = Laplace(net, "classification", "subnetwork", "diag", subnetwork_indices=idx,
                   device=device)
    timed(res, "diag_fit_sec", lambda: diag.fit(loader))
    res.update(diag_H_rel_err_vs_full=rel_err(diag.H, torch.diagonal(la.H)),
               diag_log_marglik=float(diag.log_marginal_likelihood()),
               diag_probit_row_sum_err=float((diag(X[:8]).sum(-1) - 1).abs().max()))

    var_idx = timed(res, "variance_diag_select_sec", lambda: LargestVarianceDiagLaplaceSubnetMask(
        net, SUB_K, DiagLaplace(net, "classification", device=device), device=device).select(loader))
    swag_idx = timed(res, "variance_swag_select_sec", lambda: LargestVarianceSWAGSubnetMask(
        net, SUB_K, device=device).select(loader))
    res.update(variance_diag_indices=len(var_idx), variance_swag_indices=len(swag_idx),
               masks_overlap={"magnitude_diag": len(np.intersect1d(idx, var_idx)),
                              "magnitude_swag": len(np.intersect1d(idx, swag_idx))})

    # float64: the card against the CPU, the same indices
    f64 = []
    loader64 = ArrayLoader(X.astype(np.float64), y, batch_size=SUB_BATCH)
    for dev in (device, torch.device("cpu")):
        la64 = FullSubnetLaplace(bench_cnn(seed, torch.float64), "classification", idx, device=dev)
        zero_launches()
        t = {}
        timed(t, "s", lambda: la64.fit(loader64))
        f64.append((la64.H.cpu(), float(la64.log_marginal_likelihood()), syrk.launches, t["s"]))
    (H_g, l_g, n_g, s_g), (H_c, l_c, _, s_c) = f64
    res.update(f64_card_s=s_g, f64_cpu_s=s_c, f64_card_syrk_launches=n_g,
               f64_H_rel_err=rel_err(H_g, H_c), f64_log_marglik_rel_err=abs(l_g - l_c) / abs(l_c),
               phase_s=time.perf_counter() - t_start)
    emit(res)

    n_batches = -(-SUB_N // SUB_BATCH)
    check(isinstance(la, FullSubnetLaplace) and isinstance(diag, DiagSubnetLaplace),
          "Laplace() gave the wrong subnetwork classes")
    check(la.n_params == 131466 and la.n_params_subnet == SUB_K,
          f"BenchCNN with {la.n_params} weights, a subnetwork of {la.n_params_subnet}")
    check(res["launches"]["syrk"] == n_batches and warm_launches == n_batches,
          f"the subnet fits launched syrk {warm_launches} and {res['launches']['syrk']} times, "
          f"not {n_batches}")
    check(len(per_launch) == n_batches and all(r["shape"] == [SUB_BATCH * 10, SUB_K]
                                               for r in per_launch),
          f"syrk calls {[r['shape'] for r in per_launch]}")
    for r in per_launch:
        check(r["rel_err"] <= SYRK_TOL["float32"],
              f"subnet syrk launch off syrk_plain by {r['rel_err']:.3e} > {SYRK_TOL['float32']}")
        check(r["exactly_symmetric"], "a subnet syrk launch is not exactly symmetric")
    check(res["fit_H_equals_sum_of_launches"], "the fit's H is not the sum of its launches' H")
    check(not any(n for k, n in res["launches"].items() if k != "syrk"),
          f"the subnet fit launched other kernels: {res['launches']}")
    check(tuple(probs.shape) == (8, 10) and res["probit_row_sum_err"] <= 1e-5,
          f"subnet probit of shape {tuple(probs.shape)}, rows sum to 1 within "
          f"{res['probit_row_sum_err']}")
    for name in ("log_marglik", "diag_log_marglik"):
        check(math.isfinite(res[name]), f"{name} {res[name]} is not finite")
    check(res["diag_probit_row_sum_err"] <= 1e-5, "DiagSubnet probit rows do not sum to 1")
    check(res["diag_H_rel_err_vs_full"] <= DIAG_TOL,
          f"DiagSubnet H off diag(FullSubnet H) by {res['diag_H_rel_err_vs_full']:.3e} > {DIAG_TOL}")
    check(len(var_idx) == SUB_K and len(swag_idx) == SUB_K, "a variance mask's size is off")
    check(n_g == n_batches, f"the float64 card fit launched syrk {n_g} times")
    for name in ("f64_H_rel_err", "f64_log_marglik_rel_err"):
        check(res[name] <= F64_REL_TOL, f"float64 card vs CPU: {name} {res[name]:.3e} > "
                                        f"{F64_REL_TOL}")
    keep["subnet_full"] = (la, lambda: FullSubnetLaplace(net, "classification", idx,
                                                         device=device), X[:8])
    return {"syrk": res["launches"]["syrk"]}, res["syrk_640x128"]


# bench.py's reward_ll_fit (config 5): the RewardTransformer, 512 random token
# sequences of 128 from vocab 4096, labels in {0, 1}, batch 64, float32
REWARD_SIZES = dict(vocab=4096, d=256, heads=8, mlp=1024, blocks=4)
REWARD_N, REWARD_SEQ, REWARD_BATCH = 512, 128, 64
REWARD_WEIGHTS, REWARD_HEAD = 4_208_130, 2 * 256 + 2
# the float64 card-vs-CPU check on a narrow twin (64 sequences of 16, batch 16)
REWARD_NARROW = dict(vocab=64, d=16, heads=2, mlp=32, blocks=2)
REWARD_F64_TOL = 1e-12  # float64 card vs CPU: factors, H, margliks, predictives, relative
# a loaded object against the one it was saved from, limits set from the
# readings of two runs on an H100 (PERF.md §6). The all-weights Kron
# decomposes its factors again in float32 through v1 and v4 (v4 adds with
# atomics, so the eigenpairs differ in the last bits from run to run): its
# probit read 1.49e-8 absolute (one float32 step at its size) in both runs,
# held to 1e-7; its marglik came back bit for bit, held to two float32
# steps relative. Every other flavor restores its arrays as they were and
# read bitwise in both runs: predictive and marglik within two float32
# steps relative to the largest entry (whether bitwise is reported)
F32_STEP = 2.0 ** -23
KRON_LOAD_PRED_TOL, KRON_LOAD_LML_TOL = 1e-7, 2 * F32_STEP
LOAD_TOL = 2 * F32_STEP


def reward_transformer(seed, dtype, sizes):
    """`bench.py`'s `RewardTransformer` (`bench.py:396-410`) from the port's
    flax-layer twins: `Embed_0`, 4 blocks of `MultiHeadDotProductAttention_i`
    (8 heads over d = 256), `LayerNorm`, `Dense` 1024, tanh-gelu, `Dense`
    256, `LayerNorm`; the mean over the sequence into the head `Dense_8`
    (2 outputs). flax's initializers, drawn from `seed`."""
    import torch
    import torch.nn.functional as F
    from torch import nn

    from laplace_jax_torch.models.flax_layers import Embed, LayerNorm, MultiHeadDotProductAttention
    from laplace_jax_torch.models.resnet import _trunc_normal

    class RewardTransformer(nn.Module):
        def __init__(self, vocab, d, heads, mlp, blocks, generator):
            super().__init__()
            self.blocks = blocks
            self.Embed_0 = Embed(vocab, d, generator=generator)
            for i in range(blocks):
                self.add_module(f"MultiHeadDotProductAttention_{i}",
                                MultiHeadDotProductAttention(d, heads, qkv_features=d,
                                                             generator=generator))
                self.add_module(f"LayerNorm_{2 * i}", LayerNorm(d))
                self.add_module(f"Dense_{2 * i}", nn.Linear(d, mlp))
                self.add_module(f"Dense_{2 * i + 1}", nn.Linear(mlp, d))
                self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(d))
            self.add_module(f"Dense_{2 * blocks}", nn.Linear(d, 2))
            with torch.no_grad():  # flax's Dense initializers: lecun normal, zero bias
                for m in self.modules():
                    if isinstance(m, nn.Linear):
                        _trunc_normal(m.weight, m.in_features ** -0.5, generator)
                        m.bias.zero_()

        def forward(self, ids):
            x = self.Embed_0(ids)
            for i in range(self.blocks):
                x = getattr(self, f"LayerNorm_{2 * i}")(
                    x + getattr(self, f"MultiHeadDotProductAttention_{i}")(x))
                h = F.gelu(getattr(self, f"Dense_{2 * i}")(x), approximate="tanh")
                x = getattr(self, f"LayerNorm_{2 * i + 1}")(
                    x + getattr(self, f"Dense_{2 * i + 1}")(h))
            return getattr(self, f"Dense_{2 * self.blocks}")(x.mean(dim=1))

    return RewardTransformer(**sizes, generator=torch.Generator().manual_seed(seed)).to(dtype)


def outputs(out) -> list:
    """A predictive's tensors: the probabilities, or `(f_mu, f_var)`."""
    return list(out) if isinstance(out, tuple) else [out]


def reward_phase(seed, device, smi, keep):
    """`bench.py`'s `reward_ll_fit` at full size: the `RewardTransformer`
    twin (4,208,130 weights) on 512 random sequences of 128 tokens, labels
    in {0, 1}, batch 64, float32, `"reward_modeling"`. `Laplace(...,
    "last_layer", "kron")`: a warm-up fit, then the timed fit
    (`reward_ll_fit_sec`, bench's name); the head's factors are 256 and 2
    wide, below the LATRD kernels' 512, so no kernel may launch. FullLL on
    the same head: 8 syrk launches at (128, 514), each recorded (H against
    `syrk_plain` on its M, exactly symmetric, their sum the fit's H), its H
    against a float64 GGN; syrk timed at (128, 514); DiagLL against FullLL's
    diagonal; the GLM predictive `(f_mu, f_var)` on 8 sequences; then a
    narrow twin in float64, KronLL and FullLL on the card against the CPU.
    Keeps the KronLL for the serialization phase."""
    import numpy as np
    import torch

    from laplace_jax_torch import DiagLLLaplace, FullLLLaplace, KronLLLaplace, Laplace
    from laplace_jax_torch.ops.syrk import syrk, syrk_plain
    from laplace_jax_torch.utils.data import ArrayLoader

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, REWARD_SIZES["vocab"], size=(REWARD_N, REWARD_SEQ))
    y = rng.integers(0, 2, size=REWARD_N)
    loader = ArrayLoader(ids, y, batch_size=REWARD_BATCH)
    net = reward_transformer(seed, torch.float32, REWARD_SIZES)
    res = dict(phase="reward", nvidia_smi=smi, config="bench.py reward_ll_fit",
               model="RewardTransformer (4 blocks, d 256, 8 heads, MLP 1024, vocab 4096)",
               n_data=REWARD_N, seq=REWARD_SEQ, batch=REWARD_BATCH, dtype="float32",
               n_weights=sum(p.numel() for p in net.parameters()))

    kron = Laplace(net, "reward_modeling", subset_of_weights="last_layer",
                   hessian_structure="kron", device=device)
    timed(res, "reward_ll_fit_warmup_sec", lambda: kron.fit(loader))
    zero_launches()
    timed(res, "reward_ll_fit_sec", lambda: (kron.fit(loader), kron.H.eigenvalues[0][0].cpu()))
    res.update(kron_launches=kernel_launches(), kron_fit_seconds=dict(kron.fit_seconds),
               last_layer=list(kron.last_layer_path), head_kind=kron._head_kind,
               n_params=kron.n_params,
               factor_sizes=sorted({int(H.shape[0]) for F in kron.H_facs.kfacs for H in F}),
               kron_log_marglik=float(kron.log_marginal_likelihood()))
    f_mu, f_var = timed(res, "kron_glm_8_sec", lambda: kron(ids[:8]))
    res.update(glm_shapes=[list(f_mu.shape), list(f_var.shape)],
               glm_finite=bool(torch.isfinite(f_mu).all() and torch.isfinite(f_var).all()),
               glm_var_min_eig=float(torch.linalg.eigvalsh(f_var.double()).min()))

    full = Laplace(net, "reward_modeling", "last_layer", "full", device=device)
    zero_launches()
    with SyrkTally() as tally:
        timed(res, "full_fit_sec", lambda: full.fit(loader))
    res["full_launches"] = kernel_launches()
    per_launch = [dict(shape=list(M.shape), rel_err=rel_err(H, syrk_plain(M)),
                       exactly_symmetric=bool(torch.equal(H, H.mT))) for M, H in tally.calls]
    H_sum = tally.calls[0][1]
    for _, H in tally.calls[1:]:
        H_sum = H_sum + H
    H64 = ll_ggn_f64(full, loader)
    M = tally.calls[0][0]
    bound_ms, bound_by = syrk_bound_ms(*M.shape, M.element_size(), F32_FLOPS)
    res.update(syrk_per_launch=per_launch, fit_H_equals_sum_of_launches=bool(torch.equal(H_sum, full.H)),
               full_H_rel_err_vs_f64=float((full.H.double() - H64).abs().max() / H64.abs().max()),
               full_log_marglik=float(full.log_marginal_likelihood()),
               syrk_128x514=dict(shape=list(M.shape), ms=cuda_ms(lambda: syrk(M), reps=50),
                                 plain_ms=cuda_ms(lambda: syrk_plain(M), reps=50),
                                 library_ms=cuda_ms(lambda: torch.mm(M.mT, M), reps=50),
                                 bound_ms=bound_ms, bound_by=bound_by))
    f_mu_full, f_var_full = full(ids[:8])
    res["full_glm_finite"] = bool(torch.isfinite(f_mu_full).all() and torch.isfinite(f_var_full).all())

    diag = Laplace(net, "reward_modeling", "last_layer", "diag", device=device)
    timed(res, "diag_fit_sec", lambda: diag.fit(loader))
    res.update(diag_H_rel_err_vs_full=rel_err(diag.H, torch.diagonal(full.H)),
               diag_log_marglik=float(diag.log_marginal_likelihood()))

    # float64 on a narrow twin: the card against the CPU, the same weights and data
    ids64 = rng.integers(0, REWARD_NARROW["vocab"], size=(64, 16))
    y64 = rng.integers(0, 2, size=64)
    f64 = []
    for dev in (device, torch.device("cpu")):
        net64 = reward_transformer(seed, torch.float64, REWARD_NARROW)
        outs = []
        for cls in (KronLLLaplace, FullLLLaplace):
            la64 = cls(net64, "reward_modeling", device=dev)
            la64.fit(ArrayLoader(ids64, y64, batch_size=16))
            H = (torch.cat([h.reshape(-1) for F in la64.H_facs.kfacs for h in F])
                 if cls is KronLLLaplace else la64.H)
            outs += [H.cpu(), la64.log_marginal_likelihood().cpu(),
                     *[o.cpu() for o in la64(ids64[:8])]]
        f64.append(outs)
    res["f64_rel_err_card_vs_cpu"] = max(rel_err(a, b) for a, b in zip(*f64))
    res["phase_s"] = time.perf_counter() - t_start
    emit(res)

    n_batches = -(-REWARD_N // REWARD_BATCH)
    check(res["n_weights"] == REWARD_WEIGHTS,
          f"the reward transformer has {res['n_weights']} weights, not {REWARD_WEIGHTS}")
    check(isinstance(kron, KronLLLaplace) and isinstance(full, FullLLLaplace)
          and isinstance(diag, DiagLLLaplace), "Laplace() gave the wrong last-layer classes")
    check(res["last_layer"] == [f"Dense_{2 * REWARD_SIZES['blocks']}"]
          and kron.n_params == REWARD_HEAD
          and res["head_kind"] == "dense",
          f"last layer {res['last_layer']} ({res['head_kind']}) with {kron.n_params} weights")
    check(not any(res["kron_launches"].values()),
          f"the KronLL fit launched kernels: {res['kron_launches']}")
    check(res["full_launches"]["syrk"] == n_batches and len(per_launch) == n_batches,
          f"the FullLL fit launched syrk {res['full_launches']['syrk']} times, not {n_batches}")
    check(all(r["shape"] == [REWARD_BATCH * 2, REWARD_HEAD] for r in per_launch),
          f"syrk calls {[r['shape'] for r in per_launch]}")
    for r in per_launch:
        check(r["rel_err"] <= SYRK_TOL["float32"],
              f"reward syrk launch off syrk_plain by {r['rel_err']:.3e} > {SYRK_TOL['float32']}")
        check(r["exactly_symmetric"], "a reward syrk launch is not exactly symmetric")
    check(res["fit_H_equals_sum_of_launches"], "the FullLL H is not the sum of its launches' H")
    check(res["full_H_rel_err_vs_f64"] <= GGN_TOL,
          f"FullLL H off the float64 GGN by {res['full_H_rel_err_vs_f64']:.3e} > {GGN_TOL}")
    check(res["diag_H_rel_err_vs_full"] <= DIAG_TOL,
          f"DiagLL H off diag(FullLL H) by {res['diag_H_rel_err_vs_full']:.3e} > {DIAG_TOL}")
    check(res["glm_shapes"] == [[8, 2], [8, 2, 2]] and res["glm_finite"] and res["full_glm_finite"],
          f"the GLM predictive has shapes {res['glm_shapes']} or is not finite")
    check(res["glm_var_min_eig"] > 0, "a GLM predictive covariance is not positive definite")
    for name in ("kron_log_marglik", "full_log_marglik", "diag_log_marglik"):
        check(math.isfinite(res[name]), f"{name} {res[name]} is not finite")
    check(res["f64_rel_err_card_vs_cpu"] <= REWARD_F64_TOL,
          f"float64 card vs CPU: {res['f64_rel_err_card_vs_cpu']:.3e} > {REWARD_F64_TOL}")
    keep["reward_kron_ll"] = (kron, lambda: KronLLLaplace(net, "reward_modeling", device=device),
                              ids[:8])
    return {"syrk": res["full_launches"]["syrk"]}, res["syrk_128x514"]


BACKEND_TOL = 1e-5  # float32 curvature against its reference, relative to the largest entry


def expected_panels(kron) -> dict:
    """The v1 and v4 panels `Kron.decompose` launches for a Kron's factor
    classes on the card: one stack a class size n >= 512, cdiv(n - 2, 64)
    panels a stack, v1 below 2304 and v4 from there (ops/tridiag.py's
    window loop with nb = 64)."""
    sizes = {int(H.shape[0]) for F in kron.kfacs for H in F if H.shape[0] >= 512}
    out = {"latrd_panel": 0, "latrd_panel_v4": 0}
    for n in sizes:
        out["latrd_panel_v4" if n >= 2304 else "latrd_panel"] += -(-(n - 2) // 64)
    return out


def classes(kron) -> dict:
    """{n: number of factors} over the classes n >= 512."""
    out: dict = {}
    for F in kron.kfacs:
        for H in F:
            if H.shape[0] >= 512:
                out[int(H.shape[0])] = out.get(int(H.shape[0]), 0) + 1
    return dict(sorted(out.items()))


def jacobian_diag(be, x, y):
    """The diagonal of the batch's curvature written out from per-sample
    Jacobians (GGN) or gradients (EF), as the port's non-tap path takes it."""
    import torch

    if be.curv_type == "ef":
        G, _ = be.gradients(x, y)
        return be.factor * (G * G).sum(0)
    Js, f = be.jacobians(x)
    return torch.einsum("bcp,bck,bkp->p", Js, be._functional_hessian(f), Js)


def tap_memory_limit(model, x1, C, batch):
    """(limit, output gradients) in GiB: the peak device memory a
    tap-diagonal fit in batches of `batch` may use, from its shapes. Four
    times the K = C output gradients of one batch at every tapped layer
    (the batched backward holds them, and about as much again in its
    intermediates), the kernel-gradient chunk and its patches twice, and 2
    GiB for the network, its inputs and the allocator."""
    import torch

    from laplace_jax_torch.curvature.diag_taps import CHUNK_BYTES

    with torch.no_grad():
        _, taps = model.apply_with_taps(x1, norm=True)
    grads = C * batch * sum(t.offset.numel() for t in taps if t.offset is not None) * \
        x1.element_size()
    return (4 * grads + 2 * CHUNK_BYTES + (2 << 30)) / 2**30, grads / 2**30


def wrn_batchnorm(seed, device):
    """WideResNet-16-4 with BatchNorm (10 classes), random weights and
    running statistics from `seed`, 512 CIFAR-10-shaped inputs in batches of
    128, and 8 test inputs."""
    import numpy as np
    import torch

    from laplace_jax_torch.models.flax_layers import BatchNorm
    from laplace_jax_torch.models.wideresnet import WideResNet16x4
    from laplace_jax_torch.utils.data import ArrayLoader

    gen = torch.Generator().manual_seed(seed + 1)
    net = WideResNet16x4(10, 4, "batch", generator=gen)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, BatchNorm):
                m.mean.copy_(0.1 * torch.randn(m.mean.shape, generator=gen))
                m.var.copy_(1 + 0.1 * torch.randn(m.var.shape, generator=gen).abs())
    rng = np.random.default_rng(seed + 1)
    X = rng.standard_normal((512, 32, 32, 3)).astype(np.float32)
    y = rng.integers(0, 10, size=512)
    return net, ArrayLoader(X, y, batch_size=128), X[:8]


def backends_phase(seed, device, smi):
    """The curvature choices at full width, float32. ResNet-18 (the main
    path's network and data): `KronLaplace` with the EF and with the MC
    Fisher (v1 and v4 launches read from each fit, eigenvalues against
    float64 `eigvalsh`, marglik, probit); the all-weights `DiagLaplace`
    (GGN, and EF) through the layer taps, with its peak device memory
    against a limit from its shapes and its diagonal against the Jacobian
    path's on 4 inputs; FullLL on the head with the Hessian (against the
    GGN's H: the head is linear in its weights), the EF (against a float64
    Σ g gᵀ of the same gradients) and the MC GGN. WideResNet-16-4 with
    BatchNorm: `KronLaplace(kron_unsupported="block")` (its launches against
    its factor classes, its norm blocks on the first batch against the
    exact GGN blocks of those leaves), 'skip' (a warning, zero norm groups)
    and 'raise' (`ValueError`), and `DiagLaplace` through the taps."""
    import torch

    from laplace_jax_torch import DiagLaplace, KronLaplace, Laplace
    from laplace_jax_torch.curvature.backend import CurvatureBackend
    from laplace_jax_torch.nnmodel import NNModel
    from laplace_jax_torch.utils.device import full_f32

    t_start = time.perf_counter()
    net, loader, X_test = full_width(seed)
    x4, y4 = (torch.as_tensor(a[:4], device=device) for a in (loader.x, loader.y))
    res = dict(phase="backends", nvidia_smi=smi, model="ResNet18(width=64, num_classes=10)",
               n_data=512, batch=128, dtype="float32", kron={}, diag={}, full_ll={})
    total = {"latrd_panel": 0, "latrd_panel_v4": 0}

    def count(launches):
        for k in total:
            total[k] += launches[k]

    # KronLaplace with the EF and the MC Fisher: one cotangent sweep a batch
    for backend in ("ef", "mc"):
        r = res["kron"][backend] = {}
        la = KronLaplace(net, "classification", backend=backend, device=device)
        zero_launches()
        timed(r, "fit_s", lambda: la.fit(loader, generator=torch.Generator(
            device=device).manual_seed(seed)))
        r["launches"] = kernel_launches(*MAIN_LAUNCHES)
        count(r["launches"])
        probs = la(X_test[:8])
        r.update(accumulate_s=la.fit_seconds["accumulate"],
                 decompose_s=la.fit_seconds["decompose"], eig_rel_err_vs_eigh=kernel_eig_err(la),
                 log_marglik=float(la.log_marginal_likelihood()),
                 probit_finite=bool(torch.isfinite(probs).all()),
                 probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()))
        del la

    # the all-weights diagonal through the taps (GGN, then EF)
    for backend in ("ggn", "ef"):
        r = res["diag"][backend] = {}
        la = DiagLaplace(net, "classification", backend=backend, device=device)
        torch.cuda.reset_peak_memory_stats()
        timed(r, "fit_s", lambda: la.fit(loader))
        r["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        r["mem_limit_gb"], r["tap_grads_gb"] = tap_memory_limit(la.model, x4[:1], 10, 128)
        with full_f32():
            _, d_tap = la.backend.diag(x4, y4)
            torch.cuda.reset_peak_memory_stats()
            d_jac = jacobian_diag(la.backend, x4, y4)
            r["jacobian_path_4_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        r["tap_vs_jacobian_4_rel_err"] = rel_err(d_tap, d_jac)
        del d_jac
        timed(r, "marglik_100_steps_s", lambda: la.optimize_prior_precision(n_steps=100))
        probs = la(X_test[:8])
        r.update(log_marglik=float(la.log_marginal_likelihood()),
                 prior_precision=float(la.prior_precision[0]),
                 probit_finite=bool(torch.isfinite(probs).all()),
                 probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()))
        del la

    # FullLL on the head (P_ll = 5130): the Hessian, the EF and the MC GGN
    ggn = Laplace(net, "classification", "last_layer", "full", device=device)
    ggn.fit(loader)
    for backend in ("hessian", "ef", "mc"):
        r = res["full_ll"][backend] = {}
        la = Laplace(net, "classification", "last_layer", "full", backend=backend, device=device)
        zero_launches()
        timed(r, "fit_s", lambda: la.fit(loader, generator=torch.Generator(
            device=device).manual_seed(seed)))
        r["syrk_launches"] = kernel_launches("syrk")["syrk"]
        H = la.H
        r.update(finite=bool(torch.isfinite(H).all()), exactly_symmetric=bool(torch.equal(H, H.mT)),
                 symmetry_rel_err=rel_err(H, H.mT), rel_dist_from_ggn=float(
                     torch.linalg.norm(H.double() - ggn.H.double())
                     / torch.linalg.norm(ggn.H.double())))
        if backend == "hessian":
            r["rel_err_vs_ggn"] = rel_err(H, ggn.H)
        if backend == "ef":
            H64 = None
            with full_f32():
                for X, y in loader:
                    G, _ = la.backend.gradients(la._tensor(X), la._tensor(y))
                    G = G.double()
                    H64 = G.T @ G if H64 is None else H64 + G.T @ G
            r["rel_err_vs_f64_ggt"] = rel_err(H, H64)
        r["log_marglik"] = float(la.log_marginal_likelihood())
        del la, H
    del ggn

    # WideResNet-16-4 with BatchNorm: the kron_unsupported policies
    wnet, wloader, wX = wrn_batchnorm(seed, device)
    w = res["wrn"] = dict(model='WideResNet16x4(10, widen_factor=4, norm="batch")')
    la = KronLaplace(wnet, "classification", backend_kwargs={"kron_unsupported": "block"},
                     device=device)
    zero_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        timed(w, "block_fit_s", lambda: la.fit(wloader))
    w["block_launches"] = kernel_launches(*MAIN_LAUNCHES)
    count(w["block_launches"])
    w.update(n_params=la.n_params, block_warnings=[str(c.message)[:120] for c in caught
                                                     if "zero curvature" in str(c.message)],
             classes=classes(la.H_facs), expected_launches=expected_panels(la.H_facs),
             accumulate_s=la.fit_seconds["accumulate"], decompose_s=la.fit_seconds["decompose"],
             eig_rel_err_vs_eigh=kernel_eig_err(la),
             log_marglik=float(la.log_marginal_likelihood()))
    probs = la(wX)
    w.update(probit_finite=bool(torch.isfinite(probs).all()),
             probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()))
    specs = la.model.leaf_specs
    norm = [s for s in specs if s.path[-1] == "scale" or (s.path[-1] == "bias"
                                                           and "Norm" in s.path[-2])]
    x0, y0 = (la._tensor(a) for a in next(iter(wloader)))
    with full_f32():
        _, k0 = la.backend.kron(x0, y0, 512)
        idx = torch.cat([torch.arange(s.offset, s.offset + s.size) for s in norm]).to(device)
        sub = CurvatureBackend(la.model, "classification", subnetwork_indices=idx)
        timed(w, "norm_exact_ggn_s", lambda: sub.full(x0, y0))
        _, H_sub = sub.full(x0, y0)
    # the same blocks in float64 through the taps, which equal the float64
    # GGN blocks (tests/test_torch_kron_norm.py): how far each float32 side is
    # from them, block by block
    net64 = copy.deepcopy(wnet).double()
    _, k64 = CurvatureBackend(NNModel(net64), "classification", kron_unsupported="block").kron(
        x0.double(), y0, 512)
    worst, per_block, start = 0.0, {"taps": 0.0, "jacobian_ggn": 0.0}, 0
    scale = float(H_sub.abs().max())
    for s in norm:
        blk, ref = k0.kfacs[specs.index(s)][0], H_sub[start:start + s.size, start:start + s.size]
        blk64 = k64.kfacs[specs.index(s)][0]
        worst = max(worst, float((blk - ref).abs().max()) / scale)
        per_block["taps"] = max(per_block["taps"], rel_err(blk, blk64))
        per_block["jacobian_ggn"] = max(per_block["jacobian_ggn"], rel_err(ref, blk64))
        start += s.size
    w.update(norm_leaves=len(norm), norm_params=start, norm_blocks_rel_err_vs_ggn=worst,
             norm_blocks_per_block_rel_err_vs_f64=per_block)
    del la, k0, k64, net64, H_sub, sub
    skip = CurvatureBackend(NNModel(wnet), "classification")
    with warnings.catch_warnings(record=True) as caught, full_f32():
        warnings.simplefilter("always")
        _, k_skip = skip.kron(x0, y0, 512)
    d_skip = k_skip.diag()
    w.update(skip_warned=any("zero curvature" in str(c.message) for c in caught),
             skip_norm_diag_max=max(float(d_skip[s.offset:s.offset + s.size].abs().max())
                                    for s in norm))
    try:
        with full_f32():
            CurvatureBackend(skip.model, "classification", kron_unsupported="raise").kron(
                x0, y0, 512)
        w["raise_raised"] = None
    except ValueError as exc:
        w["raise_raised"] = type(exc).__name__
    dla = DiagLaplace(wnet, "classification", device=device)
    torch.cuda.reset_peak_memory_stats()
    timed(w, "diag_fit_s", lambda: dla.fit(wloader))
    w["diag_peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    w["diag_mem_limit_gb"] = tap_memory_limit(dla.model, x0[:1], 10, 128)[0]
    with full_f32():
        _, d_tap = dla.backend.diag(x0[:4], y0[:4])
        w["diag_tap_vs_jacobian_4_rel_err"] = rel_err(d_tap, jacobian_diag(dla.backend, x0[:4],
                                                                         y0[:4]))
    w["diag_log_marglik"] = float(dla.log_marginal_likelihood())
    del dla
    res["launches"] = total
    res["phase_s"] = time.perf_counter() - t_start
    emit(res)

    for backend, r in res["kron"].items():
        check(r["launches"] == MAIN_LAUNCHES,
              f"{backend} Kron fit launched {r['launches']}, not {MAIN_LAUNCHES}")
        check(r["eig_rel_err_vs_eigh"] <= EIG_TOL,
              f"{backend} Kron eigenvalues off by {r['eig_rel_err_vs_eigh']:.3e} > {EIG_TOL}")
        check(math.isfinite(r["log_marglik"]), f"{backend} Kron marglik is not finite")
        check(r["probit_finite"] and r["probit_row_sum_err"] <= 1e-5,
              f"{backend} Kron probit: {r}")
    for backend, r in res["diag"].items():
        check(r["peak_mem_gb"] <= r["mem_limit_gb"],
              f"{backend} DiagLaplace fit peaked at {r['peak_mem_gb']:.2f} GiB > "
              f"{r['mem_limit_gb']:.2f}")
        check(r["tap_vs_jacobian_4_rel_err"] <= BACKEND_TOL,
              f"{backend} tap diagonal off the Jacobian path by "
              f"{r['tap_vs_jacobian_4_rel_err']:.3e} > {BACKEND_TOL}")
        check(math.isfinite(r["log_marglik"]) and math.isfinite(r["prior_precision"])
              and r["probit_finite"] and r["probit_row_sum_err"] <= 1e-5,
              f"{backend} DiagLaplace after tuning: {r}")
    for backend, r in res["full_ll"].items():
        check(r["finite"] and r["symmetry_rel_err"] <= BACKEND_TOL and r["syrk_launches"] == 0,
              f"FullLL {backend}: {r}")
        check(math.isfinite(r["log_marglik"]), f"FullLL {backend} marglik is not finite")
    check(res["full_ll"]["hessian"]["rel_err_vs_ggn"] <= BACKEND_TOL,
          f"FullLL Hessian off the GGN by {res['full_ll']['hessian']['rel_err_vs_ggn']:.3e}")
    check(res["full_ll"]["ef"]["rel_err_vs_f64_ggt"] <= BACKEND_TOL,
          f"FullLL EF off float64 GᵀG by {res['full_ll']['ef']['rel_err_vs_f64_ggt']:.3e}")
    check(w["n_params"] == 2_750_682, f"WRN-16-4 has {w['n_params']} weights, not 2750682")
    check(w["classes"] == {576: 4, 1152: 4, 2304: 3}, f"WRN factor classes {w['classes']}")
    check(w["block_launches"] == w["expected_launches"],
          f"WRN block fit launched {w['block_launches']}, its classes give "
          f"{w['expected_launches']}")
    check(not w["block_warnings"], f"the block fit warned: {w['block_warnings']}")
    check(w["eig_rel_err_vs_eigh"] <= EIG_TOL,
          f"WRN eigenvalues off by {w['eig_rel_err_vs_eigh']:.3e} > {EIG_TOL}")
    check(math.isfinite(w["log_marglik"]) and w["probit_finite"]
          and w["probit_row_sum_err"] <= 1e-5, f"WRN block fit: {w}")
    # relative to the largest entry of the norm leaves' GGN: block by block
    # the float32 Jacobian path itself is 1e-5 to 5e-5 off float64
    check(w["norm_blocks_rel_err_vs_ggn"] <= BACKEND_TOL,
          f"WRN norm blocks off the exact GGN by {w['norm_blocks_rel_err_vs_ggn']:.3e}")
    check(w["skip_warned"] and w["skip_norm_diag_max"] == 0.0,
          f"WRN skip: warned {w['skip_warned']}, norm diagonal {w['skip_norm_diag_max']}")
    check(w["raise_raised"] == "ValueError", f"WRN raise gave {w['raise_raised']}")
    check(w["diag_tap_vs_jacobian_4_rel_err"] <= BACKEND_TOL,
          f"WRN tap diagonal off the Jacobian path by {w['diag_tap_vs_jacobian_4_rel_err']:.3e}")
    check(math.isfinite(w["diag_log_marglik"]), "WRN DiagLaplace marglik is not finite")
    check(w["diag_peak_mem_gb"] <= w["diag_mem_limit_gb"],
          f"WRN DiagLaplace fit peaked at {w['diag_peak_mem_gb']:.2f} GiB > "
          f"{w['diag_mem_limit_gb']:.2f}")
    return total


# the transformer phase: the reward transformer with all its weights, at
# bench.py config 5's full size and data (REWARD_SIZES, REWARD_N sequences of
# REWARD_SEQ tokens, batch REWARD_BATCH), float32
TRANSFORMER_CLASSES = {1024: 12, 4096: 1}  # its factor classes n >= 512
TRANSFORMER_LOW_RANK = 10
# float64 card vs CPU at a reduced size (1 block, d 64, vocab 256, 16
# sequences of 16 tokens): Kron factors, the tap diagonal, the Lanczos
# eigenpairs from one start vector, relative to each one's largest entry
TRANSFORMER_SMALL = dict(vocab=256, d=64, heads=4, mlp=128, blocks=1)
TRANSFORMER_F64_TOL = 1e-9


def device_batches(loader, device, dtype):
    """A loader's (x, y) batches on the card, as the Lanczos run holds them."""
    from laplace_jax_torch.utils.device import to_device

    return [tuple(to_device(a, device, dtype) for a in batch) for batch in loader]


def lowrank_report(la, batches):
    """Seconds of one full matvec, each kept pair's Ritz residual
    ||H u - lambda u|| / lambda_1 from one more pass, and max |U^T U - I|."""
    import torch

    from laplace_jax_torch.curvature.lanczos import curvature_matvec
    from laplace_jax_torch.utils.device import full_f32

    matvec = curvature_matvec(la.backend, batches)
    U, lam = la.H
    res = {}
    with torch.no_grad(), full_f32():
        timed(res, "matvec_s", lambda: matvec(U[:, 0]))
        res["ritz_residuals"] = [float(torch.linalg.norm(matvec(U[:, i]) - lam[i] * U[:, i])
                                       / lam[0]) for i in range(U.shape[1])]
        eye = torch.eye(U.shape[1], dtype=U.dtype, device=U.device)
        res["orthogonality_err"] = float((U.T @ U - eye).abs().max())
    res["eigenvalues"] = [float(v) for v in lam]
    return res


def transformer_phase(seed, device, smi):
    """All-weights Laplace on `bench.py`'s reward transformer at full size
    (4,208,130 weights, 512 sequences of 128 tokens, batch 64, float32,
    `"reward_modeling"`): `KronLaplace` under `kron_unsupported="skip"`
    and `"block"` (v1 on the 1024 class of 12 factors, v4 on the Embed's
    exactly diagonal 4096 factor; launches against `expected_panels`, every
    panel of the last fit held to its plain version, eigenvalues against
    float64 `eigvalsh`, the Embed factor's eigenvalues its sorted
    diagonal, the skip warning naming only LayerNorm leaves), 100 marglik
    steps and the probit on 64 sequences; `DiagLaplace` through the taps
    (peak memory, the taps against the Jacobian path on 4 sequences);
    `LowRankLaplace(low_rank=10)` with the Hessian and the GGN (Lanczos
    and matvec seconds, peak memory, Ritz residuals, |U^T U - I|, probit,
    marglik, 100 tuning steps); float64 on the card against the CPU at a
    reduced size. Returns the v1 and v4 launches of its Kron fits."""
    import numpy as np
    import torch

    from laplace_jax_torch import DiagLaplace, KronLaplace, LowRankLaplace
    from laplace_jax_torch.curvature import lanczos
    from laplace_jax_torch.curvature.backend import CurvatureBackend
    from laplace_jax_torch.nnmodel import NNModel
    from laplace_jax_torch.ops.latrd import latrd_panel, latrd_panel_plain
    from laplace_jax_torch.ops.latrd_v4 import latrd_panel_v4, latrd_panel_v4_plain
    from laplace_jax_torch.utils.data import ArrayLoader
    from laplace_jax_torch.utils.device import full_f32

    t_start = time.perf_counter()
    rng = np.random.default_rng(seed + 5)
    ids = rng.integers(0, REWARD_SIZES["vocab"], size=(REWARD_N, REWARD_SEQ))
    y = rng.integers(0, 2, size=REWARD_N)
    loader = ArrayLoader(ids, y, batch_size=REWARD_BATCH)
    net = reward_transformer(seed, torch.float32, REWARD_SIZES)
    res = dict(phase="transformer", nvidia_smi=smi, config="bench.py config 5, all weights",
               model="RewardTransformer (4 blocks, d 256, 8 heads, MLP 1024, vocab 4096)",
               n_data=REWARD_N, seq=REWARD_SEQ, batch=REWARD_BATCH, dtype="float32",
               n_weights=sum(p.numel() for p in net.parameters()), kron={})
    total = {"latrd_panel": 0, "latrd_panel_v4": 0}

    # ---- KronLaplace, skip then block
    for policy in ("skip", "block"):
        r = res["kron"][policy] = {}
        la = KronLaplace(net, "reward_modeling",
                         backend_kwargs={"kron_unsupported": policy}, device=device)
        zero_launches()
        with warnings.catch_warnings(record=True) as caught, PanelTally(keep=True) as tally:
            warnings.simplefilter("always")
            timed(r, "fit_s", lambda: la.fit(loader))
        r["launches"] = kernel_launches(*MAIN_LAUNCHES)
        for k in total:
            total[k] += r["launches"][k]
        msgs = {str(c.message) for c in caught if "zero curvature" in str(c.message)}
        listed = sorted({p.strip(" '") for m in msgs
                         for p in m[m.index("[") + 1:m.index("]")].split(",")})
        specs = la.model.leaf_specs
        zero = ["/".join(s.path) for s, F in zip(specs, la.H_facs.kfacs)
                if all(float(H.abs().max()) == 0 for H in F)]
        gi = [s.path for s in specs].index(("Embed_0", "embedding"))
        A_embed = la.H_facs.kfacs[gi][0]
        embed_diag = torch.sort(torch.diagonal(A_embed)).values
        r.update(accumulate_s=la.fit_seconds["accumulate"],
                 decompose_s=la.fit_seconds["decompose"], classes=classes(la.H_facs),
                 expected_launches=expected_panels(la.H_facs), skip_listed=listed,
                 zero_groups=zero, eig_rel_err_vs_eigh=kernel_eig_err(la),
                 embed_offdiag_max=float((A_embed - torch.diag(torch.diagonal(A_embed)))
                                         .abs().max()),
                 embed_eig_vs_sorted_diag=float((la.H.eigenvalues[gi][0] - embed_diag)
                                                .abs().max()),
                 embed_ties=int(torch.unique(torch.diagonal(A_embed), return_counts=True)[1]
                                .max()),
                 embed_zero_counts=int((torch.diagonal(A_embed) == 0).sum()),
                 log_marglik=float(la.log_marginal_likelihood()))
        if policy == "block":  # the last fit: every panel against its plain version
            r["v1_panels"] = path_panels_vs_plain(latrd_panel, latrd_panel_plain,
                                                  tally.inputs["latrd_panel"])
            r["v4_panels"] = path_panels_vs_plain(latrd_panel_v4, latrd_panel_v4_plain,
                                                  tally.inputs["latrd_panel_v4"], lower_only=True)
            r["panels_checked"] = {k: len(v) for k, v in tally.inputs.items()}
            timed(r, "marglik_100_steps_s", lambda: la.optimize_prior_precision(n_steps=100))
            probs = timed(r, "probit_64_s", lambda: la(ids[:64], fitting=True))
            r.update(prior_precision=float(la.prior_precision[0]),
                     tuned_log_marglik=float(la.log_marginal_likelihood()),
                     probit_finite=bool(torch.isfinite(probs).all()),
                     probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()))
        del la, tally

    # ---- DiagLaplace through the taps
    x4, y4 = (torch.as_tensor(a[:4], device=device) for a in (ids, y))
    d = res["diag"] = {}
    la = DiagLaplace(net, "reward_modeling", device=device)
    torch.cuda.reset_peak_memory_stats()
    timed(d, "fit_s", lambda: la.fit(loader))
    d["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    d["mem_limit_gb"], d["tap_grads_gb"] = tap_memory_limit(la.model, x4[:1], 2, REWARD_BATCH)
    with full_f32():
        _, d_tap = la.backend.diag(x4, y4)
        d_jac = jacobian_diag(la.backend, x4, y4)
    d.update(tap_vs_jacobian_4_rel_err=rel_err(d_tap, d_jac),
             log_marglik=float(la.log_marginal_likelihood()))
    del la, d_tap, d_jac

    # ---- LowRankLaplace: the Hessian (the default) and the GGN
    res["lowrank"] = {}
    batches = device_batches(loader, device, torch.float32)
    for backend in ("hessian", "ggn"):
        r = res["lowrank"][backend] = {}
        la = LowRankLaplace(net, "reward_modeling", backend=backend,
                            low_rank=TRANSFORMER_LOW_RANK, device=device)
        torch.cuda.reset_peak_memory_stats()
        zero_launches()
        timed(r, "fit_s", lambda: la.fit(loader))
        r.update(lanczos_s=la.fit_seconds["lanczos"], launches=kernel_launches(),
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30,
                 basis_gb=la.n_params * min(4 * TRANSFORMER_LOW_RANK + 16, la.n_params) * 4
                 / 2**30, kept=len(la.H[1]))
        r.update(lowrank_report(la, batches))
        r["log_marglik"] = float(la.log_marginal_likelihood())
        probs = timed(r, "probit_64_s", lambda: la(ids[:64], fitting=True))
        timed(r, "marglik_100_steps_s", lambda: la.optimize_prior_precision(n_steps=100))
        r.update(probit_finite=bool(torch.isfinite(probs).all()),
                 probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()),
                 prior_precision=float(la.prior_precision[0]),
                 tuned_log_marglik=float(la.log_marginal_likelihood()))
        del la
    del batches

    # ---- float64 on the card against the CPU, reduced size, one start vector
    ids64 = rng.integers(0, TRANSFORMER_SMALL["vocab"], size=(16, 16))
    y64 = rng.integers(0, 2, size=16)
    loader64 = ArrayLoader(ids64, y64, batch_size=8)
    net64 = reward_transformer(seed, torch.float64, TRANSFORMER_SMALL)
    P64 = sum(p.numel() for p in net64.parameters())
    v0 = torch.randn(P64, dtype=torch.float64, generator=torch.Generator().manual_seed(seed))
    v0 = v0 / v0.norm()
    start_vector = lanczos.start_vector
    lanczos.start_vector = lambda P, dtype, dev, gen: v0.to(dev)
    f64 = []
    try:
        for dev in (device, torch.device("cpu")):
            kron = KronLaplace(net64, "reward_modeling",
                               backend_kwargs={"kron_unsupported": "block"}, device=dev)
            kron.fit(loader64)
            diag = DiagLaplace(net64, "reward_modeling", device=dev)
            diag.fit(loader64)
            out = {"kron": torch.cat([H.reshape(-1).cpu() for F in kron.H_facs.kfacs for H in F]),
                   "diag": diag.H.cpu()}
            for curv in ("hessian", "ggn"):
                U, lam, loss = CurvatureBackend(NNModel(net64), "classification",
                                                curv).eig_lowrank(loader64, TRANSFORMER_LOW_RANK)
                out[f"{curv}_eigvals"], out[f"{curv}_loss"] = lam.cpu(), loss.cpu()
                out[f"{curv}_U"] = U.cpu()
            f64.append(out)
    finally:
        lanczos.start_vector = start_vector
    card, cpu = f64
    errs = {}
    for k in card:
        a, b = card[k], cpu[k]
        if k.endswith("_U"):
            a = a * torch.sign((a * b).sum(0))
        errs[k] = rel_err(a, b) if a.shape == b.shape else float("inf")
    res.update(f64_sizes=TRANSFORMER_SMALL, f64_n_weights=P64, f64_rel_err_card_vs_cpu=errs)
    res["launches"] = total
    res["phase_s"] = time.perf_counter() - t_start
    emit(res)

    check(res["n_weights"] == REWARD_WEIGHTS,
          f"the reward transformer has {res['n_weights']} weights, not {REWARD_WEIGHTS}")
    for policy, r in res["kron"].items():
        check(r["classes"] == TRANSFORMER_CLASSES,
              f"{policy}: factor classes {r['classes']}, not {TRANSFORMER_CLASSES}")
        check(r["launches"] == r["expected_launches"],
              f"{policy}: launches {r['launches']}, its classes give {r['expected_launches']}")
        check(r["eig_rel_err_vs_eigh"] <= EIG_TOL,
              f"{policy}: eigenvalues off by {r['eig_rel_err_vs_eigh']:.3e} > {EIG_TOL}")
        # the Embed factor is exactly diagonal; every reflector of its stage 1 is
        # trivial and stage 2 deflates every pole, so the eigenvalues are its
        # diagonal entries themselves
        check(r["embed_offdiag_max"] == 0 and r["embed_eig_vs_sorted_diag"] == 0,
              f"{policy}: Embed factor off-diagonal {r['embed_offdiag_max']}, eigenvalues off "
              f"its sorted diagonal by {r['embed_eig_vs_sorted_diag']}")
        check(math.isfinite(r["log_marglik"]), f"{policy}: marglik is not finite")
    skip, block = res["kron"]["skip"], res["kron"]["block"]
    check(skip["skip_listed"] and all(p.startswith("LayerNorm_") for p in skip["skip_listed"])
          and set(skip["zero_groups"]) == set(skip["skip_listed"]),
          f"skip warned about {skip['skip_listed']}, zero groups {skip['zero_groups']}")
    check(not block["skip_listed"] and not block["zero_groups"],
          f"block: warned about {block['skip_listed']}, zero groups {block['zero_groups']}")
    check(block["panels_checked"] == {"latrd_panel": block["launches"]["latrd_panel"],
                                      "latrd_panel_v4": block["launches"]["latrd_panel_v4"]},
          f"panels held to plain {block['panels_checked']}, launched {block['launches']}")
    check(math.isfinite(block["tuned_log_marglik"]) and block["probit_finite"]
          and block["probit_row_sum_err"] <= 1e-5, f"Kron after tuning: {block}")
    check(d["peak_mem_gb"] <= d["mem_limit_gb"],
          f"DiagLaplace fit peaked at {d['peak_mem_gb']:.2f} GiB > {d['mem_limit_gb']:.2f}")
    check(d["tap_vs_jacobian_4_rel_err"] <= BACKEND_TOL,
          f"tap diagonal off the Jacobian path by {d['tap_vs_jacobian_4_rel_err']:.3e}")
    check(math.isfinite(d["log_marglik"]), "DiagLaplace marglik is not finite")
    for backend, r in res["lowrank"].items():
        check(r["kept"] > 0 and all(math.isfinite(v) and v > 0 for v in r["eigenvalues"]),
              f"LowRank {backend} eigenvalues {r['eigenvalues']}")
        check(not any(r["launches"].values()), f"LowRank {backend} launched {r['launches']}")
        check(math.isfinite(r["log_marglik"]) and math.isfinite(r["tuned_log_marglik"])
              and r["probit_finite"] and r["probit_row_sum_err"] <= 1e-5,
              f"LowRank {backend}: {r}")
    for k, e in errs.items():
        check(e <= TRANSFORMER_F64_TOL,
              f"float64 card vs CPU: {k} off by {e:.3e} > {TRANSFORMER_F64_TOL}")
    return total


# the conv_variants phase: the conv half of tap breadth at full width on the
# main path's sizes (CONV_N inputs in batches of CONV_BATCH, 10 classes),
# float32; its factor classes n >= 512, and float64 card vs CPU at the widths
# divided by CONV_SMALL_DIV on CONV_SMALL_N inputs
CONV_N, CONV_BATCH, CONV_TEST = 512, 128, 64
CONV_CLASSES = {"conv2d": {512: 7, 576: 1, 1152: 3, 2304: 1}, "conv1d": {768: 2},
                "conv3d": {864: 1}}
CONV_POLICIES = {"conv2d": ("raise",), "conv1d": ("raise",), "conv3d": ("skip", "block")}
CONV_SMALL_DIV, CONV_SMALL_N = 8, 16
CONV_F64_TOL = 1e-9


CONV_SHAPES = {"conv2d": (32, 32, 3), "conv1d": (128, 64), "conv3d": (16, 16, 16, 4)}


def conv_variant_data(seed, n, div=1):
    """{net: (inputs, labels)}: `n` standard-normal inputs of each net's
    shape (the 1-D net's channels divided by `div`) and labels of 10
    classes, from `seed`."""
    import numpy as np

    rng = np.random.default_rng(seed + 7)
    out = {}
    for name, shape in CONV_SHAPES.items():
        if name == "conv1d":
            shape = (shape[0], shape[1] // div)
        out[name] = (rng.standard_normal((n,) + shape).astype(np.float32),
                     rng.integers(0, 10, size=n))
    return out


def skip_listed(caught) -> list:
    """The leaves a "zero curvature" warning lists."""
    msgs = {str(c.message) for c in caught if "zero curvature" in str(c.message)}
    return sorted({p.strip(" '") for m in msgs for p in m[m.index("[") + 1:m.index("]")].split(",")})


def conv_variants_phase(seed, device, smi):
    """The conv half of tap breadth at full width, float32, on the main
    path's sizes (`models/conv_variants.py`: a 2-D net of grouped, circular,
    input-dilated and masked flax `Conv` twins at ResNet-18's widths, a 1-D
    and a 3-D net of torch convs): all-weights `KronLaplace` (the 2-D and
    1-D nets under `kron_unsupported="raise"`, so every leaf is tapped; the
    3-D net under "skip", whose warning names only its InstanceNorm leaves,
    and "block"), v1 and v4 launches against `expected_panels`, every panel
    of each net's last fit held to its plain version, eigenvalues against
    float64 `eigvalsh`, 100 marglik steps and the probit on 64 inputs;
    `DiagLaplace` through the taps (peak memory; against the Jacobian path
    on 4 inputs); `KronLLLaplace` on the 1-D net's conv head; a model
    shape-coupled to the batch (`DenseGeneral(batch_dims=(0,))`, batch 4):
    the whole-batch Jacobian fallback warns and its `FullLaplace` fit
    launches syrk, held to `syrk_plain`; float64 on the card against the
    CPU at reduced width (Kron factors, tap diagonals). Returns the v1, v4
    and syrk launches of its fits."""
    import numpy as np
    import torch
    from torch import nn

    from laplace_jax_torch import DiagLaplace, FullLaplace, KronLaplace, KronLLLaplace
    from laplace_jax_torch.curvature.backend import CurvatureBackend
    from laplace_jax_torch.models.conv_variants import conv_variant_nets
    from laplace_jax_torch.models.flax_layers import DenseGeneral
    from laplace_jax_torch.nnmodel import NNModel
    from laplace_jax_torch.ops.latrd import latrd_panel, latrd_panel_plain
    from laplace_jax_torch.ops.latrd_v4 import latrd_panel_v4, latrd_panel_v4_plain
    from laplace_jax_torch.ops.syrk import syrk_plain
    from laplace_jax_torch.utils.data import ArrayLoader
    from laplace_jax_torch.utils.device import full_f32

    t_start = time.perf_counter()
    nets = conv_variant_nets(seed, torch.float32)
    data = conv_variant_data(seed, CONV_N + CONV_TEST)
    res = dict(phase="conv_variants", nvidia_smi=smi, n_data=CONV_N, batch=CONV_BATCH,
               dtype="float32", nets={})
    total = {"latrd_panel": 0, "latrd_panel_v4": 0, "syrk": 0}

    def count(launches):
        for k, v in launches.items():
            total[k] += v

    for name, net in nets.items():
        X, y = data[name]
        loader = ArrayLoader(X[:CONV_N], y[:CONV_N], batch_size=CONV_BATCH)
        X_test = X[CONV_N:]
        r = res["nets"][name] = dict(n_weights=sum(p.numel() for p in net.parameters()),
                                     kron={})
        for policy in CONV_POLICIES[name]:
            k = r["kron"][policy] = {}
            last = policy == CONV_POLICIES[name][-1]
            la = KronLaplace(net, "classification", backend_kwargs={"kron_unsupported": policy},
                             device=device)
            zero_launches()
            with warnings.catch_warnings(record=True) as caught, PanelTally(keep=last) as tally:
                warnings.simplefilter("always")
                timed(k, "fit_s", lambda: la.fit(loader))
            k["launches"] = kernel_launches(*MAIN_LAUNCHES)
            count(k["launches"])
            specs = la.model.leaf_specs
            k.update(accumulate_s=la.fit_seconds["accumulate"],
                     decompose_s=la.fit_seconds["decompose"], classes=classes(la.H_facs),
                     expected_launches=expected_panels(la.H_facs), skip_listed=skip_listed(caught),
                     zero_groups=["/".join(s.path) for s, F in zip(specs, la.H_facs.kfacs)
                                  if all(float(H.abs().max()) == 0 for H in F)],
                     eig_rel_err_vs_eigh=kernel_eig_err(la),
                     log_marglik=float(la.log_marginal_likelihood()))
            if last:
                k["v1_panels"] = path_panels_vs_plain(latrd_panel, latrd_panel_plain,
                                                      tally.inputs["latrd_panel"])
                k["v4_panels"] = path_panels_vs_plain(latrd_panel_v4, latrd_panel_v4_plain,
                                                      tally.inputs["latrd_panel_v4"],
                                                      bitwise=False, lower_only=True)
                k["panels_checked"] = {p: len(v) for p, v in tally.inputs.items()}
                timed(k, "marglik_100_steps_s", lambda: la.optimize_prior_precision(n_steps=100))
                probs = timed(k, "probit_64_s", lambda: la(X_test))
                k.update(prior_precision=float(la.prior_precision[0]),
                         tuned_log_marglik=float(la.log_marginal_likelihood()),
                         probit_finite=bool(torch.isfinite(probs).all()),
                         probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()))
            del la, tally

        # the diagonal through the taps, against the Jacobian path on 4 inputs
        d = r["diag"] = {}
        x4, y4 = (torch.as_tensor(a[:4], device=device) for a in (X, y))
        dla = DiagLaplace(net, "classification", device=device)
        torch.cuda.reset_peak_memory_stats()
        timed(d, "fit_s", lambda: dla.fit(loader))
        d["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
        d["mem_limit_gb"], d["tap_grads_gb"] = tap_memory_limit(dla.model, x4[:1], 10,
                                                                CONV_BATCH)
        with full_f32():
            _, d_tap = dla.backend.diag(x4, y4)
            d_jac = jacobian_diag(dla.backend, x4, y4)
        d.update(tap_vs_jacobian_4_rel_err=rel_err(d_tap, d_jac),
                 log_marglik=float(dla.log_marginal_likelihood()))
        del dla, d_tap, d_jac

    # one batch of the 2-D net's Kron accumulate under the profiler: the
    # card's busy share and its kernels with the most device time
    from torch.profiler import ProfilerActivity, profile

    be = CurvatureBackend(NNModel(nets["conv2d"]), "classification")
    x0, y0 = (torch.as_tensor(a[:CONV_BATCH], device=device) for a in data["conv2d"])
    acc = res["conv2d_accumulate_batch"] = {}
    with full_f32():
        be.kron(x0, y0, CONV_N)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            timed(acc, "s", lambda: be.kron(x0, y0, CONV_N))
    by_name: dict = {}
    for e in prof.events():
        if e.device_type.name == "CUDA":
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start) / 1e6
    acc.update(device_s=sum(by_name.values()),
               top_kernels_s=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:6]))
    del be, x0, y0, prof

    # KronLL on the 1-D net's conv head
    X, y = data["conv1d"]
    ll = res["kron_ll_conv1d_head"] = {}
    la = KronLLLaplace(nets["conv1d"], "classification", device=device)
    zero_launches()
    timed(ll, "fit_s", lambda: la.fit(ArrayLoader(X[:CONV_N], y[:CONV_N],
                                                  batch_size=CONV_BATCH)))
    ll["launches"] = kernel_launches(*MAIN_LAUNCHES)
    count(ll["launches"])
    probs = timed(ll, "probit_64_s", lambda: la(X[CONV_N:]))
    ll.update(head=list(la.last_layer_path), head_kind=la._head_kind, n_params=la.n_params,
              classes=classes(la.H_facs), expected_launches=expected_panels(la.H_facs),
              eig_rel_err_vs_eigh=kernel_eig_err(la),
              log_marglik=float(la.log_marginal_likelihood()),
              probit_finite=bool(torch.isfinite(probs).all()),
              probit_row_sum_err=float((probs.sum(-1) - 1).abs().max()))
    del la

    # a model shape-coupled to the batch: the whole-batch Jacobian fallback
    class BatchCoupled(nn.Module):
        def __init__(self):
            super().__init__()
            self.DenseGeneral_0 = DenseGeneral(5, 4, batch_dims=(0,), batch_shape=(4,),
                                               generator=torch.Generator().manual_seed(seed))

        def forward(self, x):
            return self.DenseGeneral_0(x).mean(1)

    rng = np.random.default_rng(seed + 8)
    Xb, yb = rng.standard_normal((4, 3, 5)).astype(np.float32), np.arange(4)
    fb = res["batch_fallback"] = {}
    coupled = BatchCoupled()
    full = FullLaplace(coupled, "classification", device=device)
    zero_launches()
    with warnings.catch_warnings(record=True) as caught, SyrkTally() as tally:
        warnings.simplefilter("always")
        full.fit(ArrayLoader(Xb, yb, batch_size=4))
    fb["launches"] = kernel_launches("syrk")
    count(fb["launches"])
    ref = FullLaplace(copy.deepcopy(coupled).double(), "classification", device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref.fit(ArrayLoader(Xb.astype(np.float64), yb, batch_size=4))
    fb.update(warned=any("QUADRATIC" in str(c.message) and c.category is RuntimeWarning
                         for c in caught),
              syrk_per_launch=[dict(shape=list(M.shape), rel_err=rel_err(H, syrk_plain(M)),
                                    exactly_symmetric=bool(torch.equal(H, H.mT)))
                               for M, H in tally.calls],
              H_rel_err_vs_cpu_f64=rel_err(full.H, ref.H),
              log_marglik=float(full.log_marginal_likelihood()))
    del full, ref

    # float64 on the card against the CPU at reduced width
    small = conv_variant_nets(seed, torch.float64, CONV_SMALL_DIV)
    sdata = conv_variant_data(seed, CONV_SMALL_N, CONV_SMALL_DIV)
    errs = {}
    for name, net in small.items():
        X, y = sdata[name]
        loader = ArrayLoader(X.astype(np.float64), y, batch_size=CONV_SMALL_N // 2)
        policy = "block" if name == "conv3d" else "raise"
        out = []
        for dev in (device, torch.device("cpu")):
            kron = KronLaplace(net, "classification",
                               backend_kwargs={"kron_unsupported": policy}, device=dev)
            kron.fit(loader)
            diag = DiagLaplace(net, "classification", device=dev)
            diag.fit(loader)
            out.append((torch.cat([H.reshape(-1).cpu() for F in kron.H_facs.kfacs for H in F]),
                        diag.H.cpu()))
        errs[f"{name}_kron"] = rel_err(out[0][0], out[1][0])
        errs[f"{name}_diag"] = rel_err(out[0][1], out[1][1])
    res.update(f64_width_div=CONV_SMALL_DIV, f64_n=CONV_SMALL_N, f64_rel_err_card_vs_cpu=errs)
    res["launches"] = total
    res["phase_s"] = time.perf_counter() - t_start
    emit(res)

    for name, r in res["nets"].items():
        for policy, k in r["kron"].items():
            tag = f"{name} {policy}"
            check(k["classes"] == CONV_CLASSES[name],
                  f"{tag}: factor classes {k['classes']}, not {CONV_CLASSES[name]}")
            check(k["launches"] == k["expected_launches"],
                  f"{tag}: launches {k['launches']}, its classes give {k['expected_launches']}")
            check(k["eig_rel_err_vs_eigh"] <= EIG_TOL,
                  f"{tag}: eigenvalues off by {k['eig_rel_err_vs_eigh']:.3e} > {EIG_TOL}")
            check(math.isfinite(k["log_marglik"]), f"{tag}: marglik is not finite")
            if policy == "skip":  # only the InstanceNorm leaves, each a zero group
                check(k["skip_listed"] and all(p.startswith("InstanceNorm_")
                                               for p in k["skip_listed"])
                      and set(k["zero_groups"]) == set(k["skip_listed"]),
                      f"{tag}: warned about {k['skip_listed']}, zero groups {k['zero_groups']}")
            else:
                check(not k["skip_listed"] and not k["zero_groups"],
                      f"{tag}: warned about {k['skip_listed']}, zero groups {k['zero_groups']}")
            if "panels_checked" in k:
                check(k["panels_checked"] == k["launches"],
                      f"{tag}: panels held to plain {k['panels_checked']}, launched "
                      f"{k['launches']}")
                check(math.isfinite(k["tuned_log_marglik"]) and k["probit_finite"]
                      and k["probit_row_sum_err"] <= 1e-5, f"{tag} after tuning: {k}")
        d = r["diag"]
        check(d["peak_mem_gb"] <= d["mem_limit_gb"],
              f"{name} DiagLaplace fit peaked at {d['peak_mem_gb']:.2f} GiB > "
              f"{d['mem_limit_gb']:.2f}")
        check(d["tap_vs_jacobian_4_rel_err"] <= BACKEND_TOL,
              f"{name} tap diagonal off the Jacobian path by {d['tap_vs_jacobian_4_rel_err']:.3e}")
        check(math.isfinite(d["log_marglik"]), f"{name} DiagLaplace marglik is not finite")
    check(ll["head"] == ["Conv_2"] and ll["head_kind"] == "conv"
          and ll["classes"] == {768: 1} and ll["launches"] == ll["expected_launches"]
          and ll["eig_rel_err_vs_eigh"] <= EIG_TOL and math.isfinite(ll["log_marglik"])
          and ll["probit_finite"] and ll["probit_row_sum_err"] <= 1e-5,
          f"KronLL on the 1-D conv head: {ll}")
    check(fb["warned"], "the batch-coupled fit did not warn of the whole-batch fallback")
    check(fb["launches"] == {"syrk": 1} and len(fb["syrk_per_launch"]) == 1
          and all(c["rel_err"] <= SYRK_TOL["float32"] and c["exactly_symmetric"]
                  for c in fb["syrk_per_launch"]), f"the fallback's FullLaplace syrk: {fb}")
    check(fb["H_rel_err_vs_cpu_f64"] <= BACKEND_TOL and math.isfinite(fb["log_marglik"]),
          f"the fallback's FullLaplace H off float64 on the CPU: {fb}")
    for k, e in errs.items():
        check(e <= CONV_F64_TOL, f"float64 card vs CPU: {k} off by {e:.3e} > {CONV_F64_TOL}")
    return total


def serialization_phase(keep, device, smi, main_decompose_s):
    """Each fitted object the earlier phases kept (`main`'s all-weights
    `KronLaplace` on ResNet-18, `last_layer`'s FullLL and DiagLL, `reward`'s
    KronLL, `functional`'s streamed GP, `subnet`'s `FullSubnetLaplace`)
    saved to an archive in a temporary directory under `build/`, loaded
    into a fresh instance on the card, and held against the saved object:
    predictive and log marginal likelihood (bitwise reported), archive size,
    save and load seconds. The Kron load decomposes its factors again: its
    v1 and v4 launches are counted (35 and 108), its `H_facs` must come back
    bit for bit, its eigenvalues within the float32 solver's limit of the
    saved ones and of float64 `eigvalsh`."""
    import tempfile

    import numpy as np
    import torch

    from laplace_jax_torch.utils.device import full_f32

    t_start = time.perf_counter()
    res = dict(phase="serialization", nvidia_smi=smi, flavors={})
    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    kron_launches = None
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        for name, (la, fresh, x) in keep.items():
            r = {"class": type(la).__name__}
            path = Path(tmp) / f"{name}.npz"
            timed(r, "save_s", lambda: la.save(str(path)))
            r["archive_mb"] = path.stat().st_size / 2**20
            with np.load(path, allow_pickle=False) as data:
                r["archive_entries"] = len(data.files)
            ref = [o.detach() for o in outputs(la(x))]
            ref_lml = float(la.log_marginal_likelihood())
            if name == "main_kron":  # the same decompose at this point of the run, for scale
                with full_f32():
                    timed(r, "redecompose_saved_s", lambda: la.H_facs.decompose(damping=la.damping))
            la2 = fresh()
            zero_launches()
            timed(r, "load_s", lambda: la2.load(str(path)))
            r["launches"] = kernel_launches()
            got = [o.detach() for o in outputs(la2(x))]
            lml = float(la2.log_marginal_likelihood())
            r.update(pred_rel_err=max(rel_err(g, e) for g, e in zip(got, ref)),
                     pred_abs_err=max(float((g - e).abs().max()) for g, e in zip(got, ref)),
                     pred_bitwise=all(torch.equal(g, e) for g, e in zip(got, ref)),
                     log_marglik=lml, log_marglik_rel_err=abs(lml - ref_lml) / abs(ref_lml),
                     log_marglik_bitwise=lml == ref_lml)
            if name == "main_kron":
                kron_launches = r["launches"]
                r.update(H_facs_bitwise=all(torch.equal(a, b) for F1, F2 in
                                            zip(la.H_facs.kfacs, la2.H_facs.kfacs)
                                            for a, b in zip(F1, F2)),
                         eig_rel_err_vs_saved=max(rel_err(b, a) for l1, l2 in
                                                  zip(la.H.eigenvalues, la2.H.eigenvalues)
                                                  for a, b in zip(l1, l2)),
                         eig_rel_err_vs_eigh=kernel_eig_err(la2),
                         decompose_s=la2.fit_seconds["decompose"],
                         main_decompose_s=main_decompose_s)
            res["flavors"][name] = r
            path.unlink()
            del la2
    res["phase_s"] = time.perf_counter() - t_start
    emit(res)

    check(set(res["flavors"]) == {"main_kron", "last_layer_full", "last_layer_diag",
                                  "reward_kron_ll", "functional_gp_streamed", "subnet_full"},
          f"serialized {sorted(res['flavors'])}")
    for name, r in res["flavors"].items():
        if name == "main_kron":
            check(r["launches"]["latrd_panel"] == MAIN_LAUNCHES["latrd_panel"]
                  and r["launches"]["latrd_panel_v4"] == MAIN_LAUNCHES["latrd_panel_v4"],
                  f"the Kron load launched {r['launches']}, not {MAIN_LAUNCHES}")
            check(r["H_facs_bitwise"], "the loaded Kron factors differ from the saved ones")
            check(r["eig_rel_err_vs_saved"] <= EIG_TOL and r["eig_rel_err_vs_eigh"] <= EIG_TOL,
                  f"loaded eigenvalues off by {r['eig_rel_err_vs_saved']:.3e} (saved), "
                  f"{r['eig_rel_err_vs_eigh']:.3e} (eigvalsh) > {EIG_TOL}")
            check(r["pred_abs_err"] <= KRON_LOAD_PRED_TOL,
                  f"loaded Kron probit off by {r['pred_abs_err']:.3e} > {KRON_LOAD_PRED_TOL}")
            check(r["log_marglik_rel_err"] <= KRON_LOAD_LML_TOL,
                  f"loaded Kron marglik off by {r['log_marglik_rel_err']:.3e} > {KRON_LOAD_LML_TOL}")
        else:
            check(r["pred_rel_err"] <= LOAD_TOL and r["log_marglik_rel_err"] <= LOAD_TOL,
                  f"loaded {name}: predictive off by {r['pred_rel_err']:.3e}, marglik by "
                  f"{r['log_marglik_rel_err']:.3e} > {LOAD_TOL}")
    return {k: kron_launches[k] for k in MAIN_LAUNCHES}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--window-study", type=int, default=0, metavar="SEEDS",
                    help="after the build, run only the v1 window study over SEEDS seeds")
    ap.add_argument("--gp-subnet-repeats", type=int, default=0, metavar="N",
                    help="after the build, run only the functional and subnet phases, N times "
                         "in turn in this one process (the first of each is cold)")
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
    from laplace_jax_torch.ops.latrd_v2 import panel_plan as panel_plan_v2

    build_s = _build.build_all()
    ptxas = {n: [ln.strip() for ln in _build.build_log(n).splitlines()
                 if "registers" in ln or "spill" in ln] for n in _build.SOURCES}
    emit(dict(phase="build", seconds=build_s, ptxas=ptxas))
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    emit(dict(phase="build", kernel="latrd_panel", ptxas=ptxas["latrd"],
              plan_at_4x1152={dt: panel_plan(4, 1152, 0, 64, size, n_sm)._asdict()
                              for dt, size in (("float32", 4), ("float64", 8))}))
    emit(dict(phase="build", kernel="latrd_panel_v2", ptxas=ptxas["latrd_v2"],
              plan={f"{K}x{n}_{dt}": panel_plan_v2(K, n, 0, 64, size, n_sm)._asdict()
                    for K, n in ((4, 1152), (3, 4608)) for dt, size in (("float32", 4),
                                                                      ("float64", 8))}))

    if args.window_study:
        window_study(args.window_study, device, smi)
        return
    if args.gp_subnet_repeats:
        for rep in range(args.gp_subnet_repeats):
            emit(dict(phase="repeat", repetition=rep))
            functional_phase(args.seed, device, smi, {})
            subnet_phase(args.seed, device, smi, {})
        return
    rows = [kernel_phase(*row, args.seed, device) for row in KERNELS]
    rows.append(syrk_phase(args.seed, device, _build.build_log("syrk")))
    rows.append(leaves_phase(args.seed, device))
    rows.append(secular_phase(args.seed, device))
    reference_phase(args.seed, device)
    # each kernel's launches from the path that runs it: v1 and v4 from the
    # all-weights main path, syrk from the last-layer FullLL fit, v3 and v2
    # from the eigensolvers phase
    keep = {}  # fitted objects for the serialization phase
    main = main_path(args.seed, device, keep)
    window_phase(rows, main["panels"], args.seed, device, smi)
    # one rank's launches in one data-parallel fit of the main path (v1, v4)
    # and of its last layer (syrk)
    parallel_launches = parallel_phase(args.seed, device, smi, main, keep)
    launches = dict(main["launches"], jacobi_leaves=main["leaf_launches"],
                    secular=main["secular_launches"])
    ll_launches, full_syrk_ms = last_layer_phase(args.seed, device, keep)
    launches.update(ll_launches)
    next(r for r in rows if r["name"] == "syrk")["main_path_ms"] = full_syrk_ms
    route_launches, route_panels = eigensolvers_phase(device, keep)
    launches.update(route_launches)
    window_phase(rows, route_panels, args.seed, device, smi, total="route_ms")
    # the SBR op chain on the main path's factor classes, then the examples
    sbr_phase(device, smi, keep)
    examples_phase(device, smi)
    # the Jacobi leaves' and the secular kernel's launches on each path of
    # this process, by phase
    leaves = {}

    def on_path(path, phase, *a):
        with LeafCount() as c:
            out = phase(*a)
        leaves[path] = dict(jacobi_leaves=c.n, secular=c.secular)
        return out

    # the marglik-training and regression paths, each read from its own run
    by_path = {"parallel": parallel_launches,
               "marglik_training": on_path("marglik_training", marglik_training_phase,
                                           args.seed, device, smi),
               "regression": on_path("regression", regression_phase, args.seed, device, smi)}
    # the GP path launches no kernel; the subnet path launches syrk once a batch
    functional_phase(args.seed, device, smi, keep)
    by_path["subnet"], syrk_640x128 = on_path("subnet", subnet_phase, args.seed, device, smi, keep)
    next(r for r in rows if r["name"] == "syrk")["at_640x128"] = syrk_640x128
    # the reward head's FullLL launches syrk once a batch; loading the
    # all-weights Kron decomposes it again through v1 and v4
    by_path["reward"], syrk_128x514 = on_path("reward", reward_phase, args.seed, device, smi, keep)
    next(r for r in rows if r["name"] == "syrk")["at_128x514"] = syrk_128x514
    # EF and MC Kron on ResNet-18 and the block Kron on WRN-16-4 launch v1 and v4
    by_path["backends"] = on_path("backends", backends_phase, args.seed, device, smi)
    # the reward transformer with all its weights: v1 on its 1024 class, v4
    # on the Embed's diagonal 4096 factor
    by_path["transformer"] = on_path("transformer", transformer_phase, args.seed, device, smi)
    # the conv variants: v1 on their 512-1152 classes, v4 on the grouped
    # conv's 2304 class, syrk on the batch-coupled model's FullLaplace
    by_path["conv_variants"] = on_path("conv_variants", conv_variants_phase, args.seed, device,
                                       smi)
    by_path["serialization"] = on_path("serialization", serialization_phase, keep, device, smi,
                                       main["decompose_s"])
    by_path = {p: dict(n, **leaves[p]) if p in leaves else n for p, n in by_path.items()}

    keys = ("name", "route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
    extra = ("main_path_ms", "route_ms", "stream_bound_ms", "ms_3x4608", "at_640x128",
             "at_128x514", "main_path_plain_ms", "main_path_bound_ms", "by_class", "by_shape")
    print(json.dumps({"kernels": [dict({k: r[k] for k in keys}, launches=launches[r["name"]],
                                       **{k: r[k] for k in extra if k in r},
                                       launches_by_path={p: n[r["name"]] for p, n in by_path.items()
                                                         if r["name"] in n})
                                  for r in rows]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
