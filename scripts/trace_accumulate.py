#!/usr/bin/env python3
"""Time the KFAC accumulate of the port's conv taps on one NVIDIA GPU, for
one or more checkouts of the package, each in its own process.

    python scripts/trace_accumulate.py [--root DIR ...] [--repeats N] [--out FILE]

Each `--root` (default: this checkout) is a directory holding a
`laplace_jax_torch/`; give the same root twice to interleave builds (parent,
change, change, parent). For each, in float32 (one JSON line each, and all
of them in `--out`):

- `im2col_ms`: `ops.im2col.im2col` at ResNet-18's 3x3 conv shapes on a
  batch of 128 (SAME, stride 1 and 2), by CUDA events, the median of 20;
- `resnet18`: `KronLaplace` on `chip_smoke.py`'s main path (ResNet-18 at
  width 64, 512 CIFAR-shaped inputs, batch 128): `accumulate_s` and
  `decompose_s` of `--repeats` fits after one warm-up fit;
- `bench_cnn`: the same on `bench.py`'s BenchCNN (config 3a of
  `marglik_training`: 1024 inputs, batch 256), the fits whose accumulate
  `marglik_training` runs each round.

The card's name and power limit from `nvidia-smi` stand in every line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
IM2COL_SHAPES = [(64, 32, 1), (64, 32, 2), (128, 16, 1), (128, 16, 2), (256, 8, 1),
                 (256, 8, 2), (512, 4, 1)]  # (channels, side, stride)


def smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def child(root: str, repeats: int) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.ops.im2col import im2col
    from laplace_jax_torch.utils.data import ArrayLoader

    dev = "cuda"
    out = dict(root=root, nvidia_smi=smi(), device=torch.cuda.get_device_name(0),
               torch=torch.__version__, im2col_ms={})
    for c, side, s in IM2COL_SHAPES:
        x = torch.randn(128, c, side, side, device=dev)
        times = []
        for _ in range(23):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            im2col(x, (3, 3), (s, s), "SAME", channels_last=False)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out["im2col_ms"][f"{c}x{side}x{side}/s{s}"] = float(np.median(times[3:]))
        del x

    rng = np.random.default_rng(0)
    nets = {
        "resnet18": (ResNet18(width=64, num_classes=10, generator=torch.Generator().manual_seed(0)),
                     512, 128),
        "bench_cnn": (chip_smoke.bench_cnn(0, torch.float32), 1024, 256),
    }
    for name, (net, n, batch) in nets.items():
        X = rng.standard_normal((n, 32, 32, 3)).astype(np.float32)
        y = rng.integers(0, 10, size=n)
        loader = ArrayLoader(X, y, batch_size=batch)
        r = out[name] = dict(n_data=n, batch=batch, accumulate_s=[], decompose_s=[])
        for i in range(repeats + 1):
            la = KronLaplace(net, "classification", device=dev)
            la.fit(loader)
            if i:  # the first fit warms up
                r["accumulate_s"].append(la.fit_seconds["accumulate"])
                r["decompose_s"].append(la.fit_seconds["decompose"])
            del la
        torch.cuda.empty_cache()
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", default=None,
                    help="a checkout holding laplace_jax_torch/ (repeatable)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        print(json.dumps(child(a.child, a.repeats)))
        return
    rows = []
    for root in a.root or [str(ROOT)]:
        root = str(Path(root).resolve())
        p = subprocess.run([sys.executable, __file__, "--child", root, "--repeats",
                            str(a.repeats)], capture_output=True, text=True, cwd=root)
        if p.returncode:
            sys.exit(f"{root}: exit {p.returncode}\n{p.stderr[-4000:]}")
        rows.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(rows[-1]), flush=True)
    if a.out:
        Path(a.out).write_text("".join(json.dumps(r) + "\n" for r in rows))


if __name__ == "__main__":
    main()
