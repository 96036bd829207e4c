"""The readings the check's limits are set from, for one cell, in one
process: for each seed, a short window of the program and the control
(the plain reference one precision below the configuration's float32:
TF32 on) in the program's place on the same inputs, each compared with
the float64 reference.

    python3 benchmark/readings.py --workload <cell> --seconds 4 --seeds 11 12 13 ...

Writes one JSON line a seed to standard output and, with `--out`, to that
file. Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    run.environment()
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("readings: no CUDA card.", file=sys.stderr)
        return 2
    out = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            r = harness.run_cell(args.workload, seed, args.seconds, False, control=True)
            line = json.dumps({"workload": args.workload, "seed": seed,
                               "seconds": time.perf_counter() - t0,
                               "correct": r["correct"], "attempted": r["attempted"],
                               "metrics": r["metrics"], "card": r["card"],
                               "program": {k: c["value"] for k, c in r["checks"].items()},
                               "control": r["control_checks"]})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
