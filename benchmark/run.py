"""One run of one benchmark cell of `laplace_jax_torch` on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It sets up (builds the cell's CUDA kernels
into `build/`, makes the weights and inputs from the seed on the card,
warms up every shape the window uses), measures for `--seconds`, with
`--trace 1` runs a traced segment after the window, checks the window's
outputs against the plain reference, and prints one JSON line last on
standard output; the numbers compared, each beside its limit, are the
last lines on standard error. Without a CUDA card, or with fewer cards
than the cell asks for, it prints no result and exits 2; if the process
holds JAX or the JAX package after the window, it exits 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def environment() -> None:
    """Caches inside the checkout at fixed paths; the program's default
    stage-1 route; no JAX through a library that would load it; the
    process held to the first four of its CPUs, so that its host-bound
    launches run on the same cores from run to run."""
    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, cpus[:4])
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)
    os.environ.pop("LAPLACE_TS_STAGE1", None)
    for var in ("USE_FLAX", "USE_JAX", "USE_TF"):
        os.environ[var] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    environment()
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    cell = harness.find_cell(harness.benchmark_json(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found.",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"benchmark: the process holds {leaked}, which nothing on the card may load.",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct = {result['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
