#!/usr/bin/env python3
"""Trace builds of the v3 or the v2 LATRD panel kernel
(`laplace_jax_torch/csrc/latrd_v3.cu`, `latrd_v2.cu`) on one NVIDIA GPU,
side by side in one process.

    python scripts/trace_latrd.py [--kernel v3|v2] [--source PATH ...] [--out FILE]
                                  [--quick] [--route]

Each source (default: the package's own) is compiled, all at once, with the
flags of `laplace_jax_torch/ops/_build.py` into `build/trace-<kernel>-<n>-<hash>.so`,
with the source's own directory first on the include path (so an older
checkout's `csrc/` builds against its own `latrd_common.cuh`), and driven
through its C entry points `panel_f32`/`panel_f64`. Two interfaces are
known for each kernel: the four-launch column loop (no extra arguments) and
the persistent panel, told apart by an export (v3: `ring_slots`, with the
schedule arguments of `ops/latrd_v3.panel_plan`; v2: `smem_bytes`, with the
block count, resident rows and row cache of `ops/latrd_v2.panel_plan`).
For each build (one JSON line each, and all of them in `--out`):

- `panels`: one panel at (3, 4608) and (4, 1152) in float32 and (3, 4608)
  in float64, off 0, and (3, 4608) float32 at off 1088 (the last panel of
  the first 1152-wide class), each timed by CUDA events, with its error
  against the kernel's plain panel, whether two launches agree bit for bit,
  the once-read bound of `chip_smoke.panel_bound_ms` and, for the
  persistent build, the streaming bound (`chip_smoke.stream_bound_ms` for
  v3's tiles, `chip_smoke.row_stream_bound_ms` for v2's rows);
- `profiler`: for each float32 shape, device time by kernel name over three
  panels (`torch.profiler`), the launches, and the device's busy share of
  that window (the rest is the gaps between launches);
- `ptxas`: registers, spills and shared memory from `-Xptxas -v`.

`--quick` keeps the (3, 4608) and (4, 1152) float32 panels and drops the
profiler. `--route` also times, in float32, every panel that stage 1
through the kernel's driver runs for ResNet-18's KFAC classes n >= 512 (the
`eigensolvers` route of chip_smoke.py, 143 panels), and sums them
(`route_ms`, with `ms_by_class` and `ms_by_window`). `nvidia-smi`'s name
and power limit are printed beside every row.
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
# (K, m, off, dtype): the v3 row's shape of chip_smoke.py, the v1 and v2
# rows' shape, float64, and a late panel of the largest window
SHAPES = [(3, 4608, 0, "float32"), (4, 1152, 0, "float32"), (3, 4608, 0, "float64"),
          (3, 4608, 1088, "float32")]
QUICK = SHAPES[:2]
NB = 64
# (K, n) of ResNet-18's KFAC classes n >= 512
ROUTE_CLASSES = [(6, 512), (5, 576), (4, 1152), (4, 2304), (3, 4608)]


def class_width(kernel: str, n: int) -> int:
    """The window class width S of the kernel's stage-1 driver: v3 rounds to
    T = 384 from n >= 1536, else 128; v2 to 128."""
    T = 384 if kernel == "v3" and n >= 1536 else 128
    return max(-(-NB // T) * T, T, -(-(-(-n // 4)) // T) * T)


def route_panels(kernel: str):
    """(K, n, m, off) of every panel stage 1 runs through the kernel's
    driver for ROUTE_CLASSES (nb = 64)."""
    out = []
    for K, n in ROUTE_CLASSES:
        S = class_width(kernel, n)
        n_pad, n_cols = -(-n // S) * S, n - 2
        out += [(K, n, n_pad - q, t * NB) for q in range(0, n_cols, S)
                for t in range(-(-min(S, n_cols - q) // NB))]
    return out


# the four-launch column loop's C interface: the panel contract's arguments
# and the stream, no plan
_P, _I, _Z = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_COLUMN_LOOP = (_I, [_P] * 9 + [_I] * 6 + [_P])
COLUMN_LOOP_LIB = {"panel_f32": _COLUMN_LOOP, "panel_f64": _COLUMN_LOOP,
                   "work_elems": (_Z, [_I] * 3), "part_elems": (_Z, [_I] * 2)}

KERNELS = {  # library, export that marks the persistent build, plain panel
    "v3": ("latrd_v3", "ring_slots", "latrd_panel_v3_plain"),
    "v2": ("latrd_v2", "smem_bytes", "latrd_panel_v2_plain"),
}


def start_build(kernel: str, i: int, source: Path):
    """Start nvcc on `source`; returns (process, library path)."""
    from laplace_jax_torch.ops import _build

    h = hashlib.sha256()
    for p in sorted(source.parent.glob("*.cuh")) + [source]:
        h.update(p.read_bytes())
    so = _build.BUILD / f"trace-{kernel}-{i}-{h.hexdigest()[:12]}.so"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(source.parent), "-o", str(so), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def finish_build(kernel: str, proc, so: Path, source: Path):
    """Load the library; returns (library, persistent?, ptxas lines)."""
    from laplace_jax_torch.ops import _build

    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    lib = ctypes.CDLL(str(so))
    name, marker, _ = KERNELS[kernel]
    persistent = hasattr(lib, marker)
    sig = _build.SIGNATURES[name] if persistent else COLUMN_LOOP_LIB
    for fn, (restype, argtypes) in sig.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln
             or "smem" in ln]
    return lib, persistent, ptxas


def plan_of(kernel: str, K: int, m: int, off: int, itemsize: int, n_sm: int):
    """The persistent build's plan for one panel."""
    if kernel == "v3":
        from laplace_jax_torch.ops.latrd_v3 import panel_plan
    else:
        from laplace_jax_torch.ops.latrd_v2 import panel_plan
    return panel_plan(K, m, off, NB, itemsize, n_sm)


def launcher(kernel, lib, persistent, A, off):
    """A function that runs one panel of `lib` on window A at `off`; returns
    (UW, det)."""
    import torch

    from laplace_jax_torch.ops.latrd import panel_buffers

    K, m, _ = A.shape
    fn = lib.panel_f32 if A.dtype == torch.float32 else lib.panel_f64
    extra, table = (), None
    if persistent:
        n_sm = torch.cuda.get_device_properties(A.device).multi_processor_count
        plan = plan_of(kernel, K, m, off, A.element_size(), n_sm)
        if kernel == "v3":
            table = plan.table.to(A.device)
            extra = (table.data_ptr(), n_sm, plan.n_res, plan.n_cache)
        else:
            extra = (plan.n_cta, plan.n_res, int(plan.cache_rows))
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


def route(kernel, lib, persistent, gen, device):
    """Every panel of the route timed once after a warm-up, on a random
    window of its (K, m); their sum in ms, by class and by window."""
    import torch

    import chip_smoke

    total, by_class, by_window, windows = 0.0, {}, {}, {}
    panels = route_panels(kernel)
    for K, n, m, off in panels:
        if (K, m) not in windows:
            windows.clear()
            A = torch.randn(K, m, m, generator=gen, device=device)
            windows[(K, m)] = (A + A.mT) / 2
        ms = chip_smoke.cuda_ms(launcher(kernel, lib, persistent, windows[(K, m)], off), 3)
        total += ms
        by_class[f"{K}x{n}"] = by_class.get(f"{K}x{n}", 0.0) + ms
        by_window[f"{K}x{m}"] = by_window.get(f"{K}x{m}", 0.0) + ms
    return dict(panels=len(panels), route_ms=total, ms_by_class=by_class, ms_by_window=by_window)


def trace(kernel, lib, persistent, source, device, quick, with_route):
    import importlib

    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    name, _, plain_name = KERNELS[kernel]
    plain = getattr(importlib.import_module(f"laplace_jax_torch.ops.{name}"), plain_name)
    n_sm = torch.cuda.get_device_properties(device).multi_processor_count
    gen = torch.Generator(device=device).manual_seed(0)
    row = dict(kernel=kernel, source=str(source), persistent=persistent, panels=[])
    for K, m, off, dt in QUICK if quick else SHAPES:
        dtype = getattr(torch, dt)
        A = torch.randn(K, m, m, generator=gen, device=device, dtype=dtype)
        A = (A + A.mT) / 2
        run = launcher(kernel, lib, persistent, A, off)
        got, again = run(), run()
        ref = plain(A, off, 0, m, NB)
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
            plan = plan_of(kernel, K, m, off, size, n_sm)
            if kernel == "v3":
                rec.update(n_res=plan.n_res, n_cache=plan.n_cache,
                           stream_bound_ms=chip_smoke.stream_bound_ms(
                               K, m, off, NB, size, plan.n_res, plan.table, n_sm))
            else:
                rec.update(n_cta=plan.n_cta, rows=plan.rows, n_res=plan.n_res,
                           cache_rows=plan.cache_rows,
                           stream_bound_ms=chip_smoke.row_stream_bound_ms(K, m, off, NB, size,
                                                                          plan))
        if not quick and dt == "float32":
            rec["profiler"] = profile(run)
        row["panels"].append(rec)
        del A
    if with_route:
        row["route"] = route(kernel, lib, persistent, gen, device)
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="v3")
    ap.add_argument("--source", action="append", type=Path,
                    help="a source of the kernel to trace (repeatable); default the package's")
    ap.add_argument("--out", type=Path, help="default build/trace_latrd_<kernel>.json")
    ap.add_argument("--quick", action="store_true",
                    help="float32 (3, 4608) and (4, 1152) only, no profiler")
    ap.add_argument("--route", action="store_true",
                    help="also time every panel of the kernel's route (route_ms)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_latrd: no CUDA device")
    sys.path.insert(0, str(ROOT))
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    lib_name = KERNELS[args.kernel][0]
    sources = [s.resolve() for s in
               args.source or [ROOT / "laplace_jax_torch" / "csrc" / f"{lib_name}.cu"]]
    rows = []
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        jobs = [start_build(args.kernel, i, src) for i, src in enumerate(sources)]
        for src, (proc, so) in zip(sources, jobs):
            lib, persistent, ptxas = finish_build(args.kernel, proc, so, src)
            row = trace(args.kernel, lib, persistent, src, device, args.quick, args.route)
            row.update(ptxas=ptxas, nvidia_smi=smi)
            print(json.dumps(row), flush=True)
            rows.append(row)
    out = args.out or ROOT / "build" / f"trace_latrd_{args.kernel}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(builds=rows), indent=1))


if __name__ == "__main__":
    main()
