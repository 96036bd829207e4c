#!/usr/bin/env python3
"""Trace builds of the v3 LATRD panel kernel (`laplace_jax_torch/csrc/latrd_v3.cu`)
on one NVIDIA GPU, side by side in one process.

    python scripts/trace_latrd_v3.py [--source PATH ...] [--out FILE] [--quick]

Each source (default: the package's own) is compiled, all at once, with the
flags of `laplace_jax_torch/ops/_build.py` into `build/trace-v3-<n>-<hash>.so`,
with the source's own directory first on the include path (so an older
checkout's `csrc/` builds against its own `latrd_common.cuh`), and driven
through its C entry points `panel_f32`/`panel_f64`. Two interfaces are
known: the four-launch column loop (`LATRD_EXPORTS`, no extra arguments)
and the persistent panel (`ring_slots` exported; the schedule arguments of
`ops/latrd_v3.panel_plan` before the stream). For each build (one JSON line
each, and all of them in `--out`):

- `panels`: one panel at (3, 4608) and (4, 1152) in float32 and (3, 4608)
  in float64, off 0, and (3, 4608) float32 at off 1088 (the last panel of
  the first 1152-wide class), each timed by CUDA events, with its error
  against `latrd_panel_v3_plain`, whether two launches agree bit for bit,
  the once-read bound of `chip_smoke.panel_bound_ms` and, for the
  persistent build, the streaming bound of `chip_smoke.stream_bound_ms`;
- `profiler`: for each float32 shape, device time by kernel name over three
  panels (`torch.profiler`), the launches, and the device's busy share of
  that window (the rest is the gaps between launches);
- `ptxas`: registers, spills and shared memory from `-Xptxas -v`.

`--quick` keeps the (3, 4608) and (4, 1152) float32 panels and drops the
profiler. `--route` also times, in float32, every panel that stage 1 through
`tridiagonalize_latrd_v3` runs for ResNet-18's KFAC classes n >= 512 (the
`eigensolvers` route of chip_smoke.py, 143 panels) and sums them
(`route_ms`). `nvidia-smi`'s name and power limit are printed beside every
row.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# (K, m, off, dtype): the kernel row's shape of chip_smoke.py, the v1 row's
# shape, float64, and a late panel of the largest window
SHAPES = [(3, 4608, 0, "float32"), (4, 1152, 0, "float32"), (3, 4608, 0, "float64"),
          (3, 4608, 1088, "float32")]
QUICK = SHAPES[:2]
NB = 64
# (K, n) of ResNet-18's KFAC classes n >= 512
ROUTE_CLASSES = [(6, 512), (5, 576), (4, 1152), (4, 2304), (3, 4608)]


def route_panels():
    """(K, m, off) of every panel stage 1 runs through
    `tridiagonalize_latrd_v3` for ROUTE_CLASSES (window classes rounded to
    T = 384 from n >= 1536, else 128; nb = 64)."""
    out = []
    for K, n in ROUTE_CLASSES:
        T = 384 if n >= 1536 else 128
        S = max(-(-NB // T) * T, T, -(-(-(-n // 4)) // T) * T)
        n_pad, n_cols = -(-n // S) * S, n - 2
        out += [(K, n_pad - q, t * NB) for q in range(0, n_cols, S)
                for t in range(-(-min(S, n_cols - q) // NB))]
    return out


def start_build(i: int, source: Path):
    """Start nvcc on `source`; returns (process, library path)."""
    from laplace_jax_torch.ops import _build

    h = hashlib.sha256()
    for p in sorted(source.parent.glob("*.cuh")) + [source]:
        h.update(p.read_bytes())
    so = _build.BUILD / f"trace-v3-{i}-{h.hexdigest()[:12]}.so"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(source.parent), "-o", str(so), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def finish_build(proc, so: Path, source: Path):
    """Load the library; returns (library, persistent?, ptxas lines)."""
    from laplace_jax_torch.ops import _build

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    lib = ctypes.CDLL(str(so))
    persistent = hasattr(lib, "ring_slots")
    sig = _build.SIGNATURES["latrd_v3"] if persistent else _build._PANEL_LIB
    for fn, (restype, argtypes) in sig.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln
             or "smem" in ln]
    return lib, persistent, ptxas


def launcher(lib, persistent, A, off):
    """A function that runs one panel of `lib` on window A at `off`; returns
    (UW, det)."""
    import torch

    from laplace_jax_torch.ops.latrd import panel_buffers

    K, m, _ = A.shape
    fn = lib.panel_f32 if A.dtype == torch.float32 else lib.panel_f64
    extra, table = (), None
    if persistent:
        from laplace_jax_torch.ops.latrd_v3 import panel_plan

        n_cta = torch.cuda.get_device_properties(A.device).multi_processor_count
        plan = panel_plan(K, m, off, NB, A.element_size(), n_cta)
        table = plan.table.to(A.device)
        extra = (table.data_ptr(), n_cta, plan.n_res, plan.n_cache)
    stream = torch.cuda.current_stream(A.device).cuda_stream

    def run(table=table):  # the schedule table lives as long as `run`
        buf = panel_buffers(lib, K, m, NB, A.dtype, A.device)
        rc = fn(A.data_ptr(), *(b.data_ptr() for b in buf.values()), K, m, NB, off, 0, m,
                *extra, stream)
        if rc != 0:
            raise RuntimeError(f"panel launch failed: {lib.error_string(rc).decode()}")
        return buf["UW"], buf["det"]
    return run


def profile(run, reps=3):
    """Device time by kernel name over `reps` panels, and the busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    by_name = {}
    for e in kernels:
        name = re.search(r"\b(k_\w+)", e.name)  # the repo's kernels are all k_<name>
        d = by_name.setdefault(name.group(1) if name else e.name[:60], dict(us=0.0, count=0))
        d["us"] += (e.time_range.end - e.time_range.start) / reps
        d["count"] += 1
    for d in by_name.values():
        d["count"] //= reps
    if not kernels:
        return dict(note="no device events in the trace")
    t0 = min(e.time_range.start for e in kernels)
    t1 = max(e.time_range.end for e in kernels)
    busy = sum(e.time_range.end - e.time_range.start for e in kernels)
    return dict(per_panel=by_name, window_us=(t1 - t0) / reps, busy_us=busy / reps,
                busy_share=busy / max(t1 - t0, 1e-9))


def route(lib, persistent, gen, device):
    """Every panel of the route timed once after a warm-up, on a random
    window of its (K, m); their sum in ms."""
    import torch

    import chip_smoke

    total, windows = 0.0, {}
    for K, m, off in route_panels():
        if (K, m) not in windows:
            windows.clear()
            A = torch.randn(K, m, m, generator=gen, device=device)
            windows[(K, m)] = (A + A.mT) / 2
        total += chip_smoke.cuda_ms(launcher(lib, persistent, windows[(K, m)], off), 3)
    return dict(panels=len(route_panels()), route_ms=total)


def trace(lib, persistent, source, device, quick, with_route):
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from laplace_jax_torch.ops.latrd_v3 import latrd_panel_v3_plain

    gen = torch.Generator(device=device).manual_seed(0)
    row = dict(source=str(source), persistent=persistent, panels=[])
    for K, m, off, dt in QUICK if quick else SHAPES:
        dtype = getattr(torch, dt)
        A = torch.randn(K, m, m, generator=gen, device=device, dtype=dtype)
        A = (A + A.mT) / 2
        run = launcher(lib, persistent, A, off)
        got, again = run(), run()
        ref = latrd_panel_v3_plain(A, off, 0, m, NB)
        torch.cuda.synchronize()
        rel = max(float((g - r).abs().max() / r.abs().max()) for g, r in zip(got, ref))
        size = A.element_size()
        bound_ms, bound_by = chip_smoke.panel_bound_ms(
            K, m, NB, size, chip_smoke.F32_FLOPS if size == 4 else chip_smoke.F64_FLOPS, off)
        rec = dict(shape=[K, m, m], off=off, nb=NB, dtype=dt, ms=chip_smoke.cuda_ms(run, 10),
                   rel_err_vs_plain=rel,
                   repeat_bitwise=all(bool(torch.equal(g, r)) for g, r in zip(got, again)),
                   bound_ms=bound_ms, bound_by=bound_by)
        if persistent:
            from laplace_jax_torch.ops.latrd_v3 import panel_plan

            n_cta = torch.cuda.get_device_properties(device).multi_processor_count
            plan = panel_plan(K, m, off, NB, size, n_cta)
            rec.update(n_res=plan.n_res, n_cache=plan.n_cache,
                       stream_bound_ms=chip_smoke.stream_bound_ms(K, m, off, NB, size, plan.n_res,
                                                                   plan.table, n_cta))
        if not quick and dt == "float32":
            rec["profiler"] = profile(run)
        row["panels"].append(rec)
        del A
    if with_route:
        row["route"] = route(lib, persistent, gen, device)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a latrd_v3.cu to trace (repeatable); default the package's")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "trace_latrd_v3.json")
    ap.add_argument("--quick", action="store_true",
                    help="float32 (3, 4608) and (4, 1152) only, no profiler")
    ap.add_argument("--route", action="store_true",
                    help="also time every panel of the v3 route (route_ms)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_latrd_v3: no CUDA device")
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sources = [s.resolve() for s in args.source or [ROOT / "laplace_jax_torch" / "csrc" / "latrd_v3.cu"]]
    rows = []
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        jobs = [start_build(i, src) for i, src in enumerate(sources)]
        for src, (proc, so) in zip(sources, jobs):
            lib, persistent, ptxas = finish_build(proc, so, src)
            row = trace(lib, persistent, src, device, args.quick, args.route)
            row.update(ptxas=ptxas, nvidia_smi=smi)
            print(json.dumps(row), flush=True)
            rows.append(row)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(builds=rows), indent=1))


if __name__ == "__main__":
    main()
