#!/usr/bin/env python3
"""Time the successive band reduction (`ops/band.py`, `ops/chase.py`) stage
by stage on one NVIDIA GPU, and split its error by stage.

    python scripts/trace_sbr.py [--seed 0] [--out FILE]

For each of ResNet-18's factor classes n >= 512 (6x512, 5x576, 4x1152,
4x2304, 3x4608, float32), a stack of random Wishart matrices X X^T / n
(X of n x (n + 64), drawn in that order from a CUDA generator seeded
`--seed`) goes through `chip_smoke.sbr_chain` (b = 64) on the card, each
stage timed with a synchronize around it, then `eigh_stack_ts` and
`torch.linalg.eigh` on the same stack. Errors, relative to the largest
eigenvalue and against float64 `eigvalsh`:

- `stage1_eig_rel_err`: the tridiagonal T's spectrum against A's (band and
  chase together);
- `stage2_eig_rel_err`, `stage2_recon_rel_err`, `stage2_worst_pair`:
  `tridiag_eigh`'s eigenvalues against T's, ||U L U^T - T|| / ||T||, and
  the largest residual ||T u - l u|| with its index, on the card and again
  on the CPU for the card's tridiagonal (n <= 2304);
- `eig_rel_err`, `recon_rel_err`, `orth_err`: the whole chain's.

One JSON line a class (also written to `--out`), with the card's name and
power limit from `nvidia-smi`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CLASSES = [(6, 512), (5, 576), (4, 1152), (4, 2304), (3, 4608)]  # (K, n)
CPU_MAX_N = 2304  # stage 2 again on the CPU up to this class (4608 takes minutes there)


def stage2_errors(d, e, T, lt):
    """`tridiag_eigh(d, e)`'s errors against the float64 spectrum `lt` of T."""
    import torch

    from laplace_jax_torch.ops.tridiag_eig import tridiag_eigh

    lam, U = tridiag_eigh(d, e)
    lam, U, T, lt = lam.double(), U.double(), T.to(lam.device), lt.to(lam.device)
    scale = lt.abs().amax(1)
    res = (T @ U - U * lam[:, None, :]).norm(dim=1) / scale[:, None]
    return dict(
        stage2_eig_rel_err=((lam - lt).abs().amax(1) / scale).tolist(),
        stage2_recon_rel_err=(torch.linalg.matrix_norm(U @ torch.diag_embed(lam) @ U.mT - T)
                              / torch.linalg.matrix_norm(T)).tolist(),
        stage2_worst_pair=[[float(r), int(i)] for r, i in zip(*res.max(1))])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the JSON lines here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_sbr: no CUDA device is available")
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from laplace_jax_torch.ops import _build
    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    _build.build_all()  # eigh_stack_ts's kernels, built before they are timed

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    stacks = {}
    for K, n in CLASSES:
        X = torch.randn(K, n, n + 64, generator=gen, device=dev)
        stacks[n] = X @ X.mT / n
    lines = []
    for n, A in stacks.items():
        secs = {}
        lam, Q, d, e = chip_smoke.sbr_chain(A, secs)
        chip_smoke.timed(secs, "eigh_stack_ts", lambda: eigh_stack_ts(A, device=dev))
        chip_smoke.timed(secs, "torch_eigh", lambda: torch.linalg.eigh(A))
        Ad, lam, Q = A.double(), lam.double(), Q.double()
        ref = torch.linalg.eigvalsh(Ad)
        dd, ed = d.double(), e.double()
        T = torch.diag_embed(dd) + torch.diag_embed(ed, 1) + torch.diag_embed(ed, -1)
        lt = torch.linalg.eigvalsh(T)
        eye = torch.eye(n, dtype=torch.float64, device=dev)
        row = dict(nvidia_smi=smi, n=n, K=A.shape[0], seconds=secs,
                   stage1_eig_rel_err=((lt - ref).abs().amax(1) / ref.abs().amax(1)).tolist(),
                   eig_rel_err=((lam - ref).abs().amax(1) / ref.abs().amax(1)).tolist(),
                   recon_rel_err=(torch.linalg.matrix_norm(Q @ torch.diag_embed(lam) @ Q.mT - Ad)
                                  / torch.linalg.matrix_norm(Ad)).tolist(),
                   orth_err=(Q.mT @ Q - eye).abs().amax((1, 2)).tolist(),
                   card=stage2_errors(d, e, T, lt))
        if n <= CPU_MAX_N:
            row["cpu"] = stage2_errors(d.cpu(), e.cpu(), T.cpu(), lt.cpu())
        print(json.dumps(row), flush=True)
        lines.append(row)
        del Ad, lam, Q, T
    if args.out:
        Path(args.out).write_text("".join(json.dumps(r) + "\n" for r in lines))


if __name__ == "__main__":
    main()
