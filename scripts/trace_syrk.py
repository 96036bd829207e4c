#!/usr/bin/env python3
"""Trace builds of the syrk kernel (`laplace_jax_torch/csrc/syrk.cu`) on one
NVIDIA GPU, side by side in one process.

    python scripts/trace_syrk.py [--source PATH ...] [--out FILE]

Each source (default: the package's own) is compiled, all at once, with the flags of
`laplace_jax_torch/ops/_build.py` into `build/trace-<n>-<hash>.so` and
driven through its C entry points `syrk_f32`/`syrk_f64(A, H, R, P, stream)`, so a
parent's source can be traced beside the current one. For each build, in
float32 (one JSON line each, and all of them in `--out`):

- `ms` at the last-layer GGN shape (1280, 5130), by CUDA events, with the
  achieved rate against R P (P + 1) flops and the 67 TFLOP/s bound, and
  `ms_f64`, the float64 entry point `syrk_f64` on the same matrix;
- `by_R`: the time at P = 5130 against R; its least-squares line splits
  the time into a fixed part (launch, epilogue, the last wave's tail) and
  a part per 16 rows of A;
- `by_P`: the time at R = 1280 against P, around multiples of the tile
  edge (wave quantisation and ragged tiles);
- `profiler`: device time by kernel name over 10 launches
  (`torch.profiler`), and the device's busy share of that window;
- `ptxas`: registers, spills and shared memory from `-Xptxas -v`;
- `sass`: for each float32 kernel in the library (`cuobjdump -sass`, where
  the toolkit has it), the opcodes between its first and last FFMA, which
  is its main loop, counted by name.

`--quick` keeps only `ms` and the times at P = 4096 and 5128 (R = 1280).
`torch.mm(A.mT, A)` with TF32 off is timed once as a yardstick, and
`nvidia-smi` samples the SM clock and board power every 200 ms throughout
(`clocks`: the clocks seen while the board drew over 150 W).
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
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores


def start_build(i: int, source: Path):
    """Start nvcc on `source`; returns (process, library path)."""
    sys.path.insert(0, str(ROOT))
    from laplace_jax_torch.ops import _build

    h = hashlib.sha256(source.read_bytes()).hexdigest()[:12]
    so = _build.BUILD / f"trace-{i}-{h}.so"
    _build.BUILD.mkdir(parents=True, exist_ok=True)
    # the source's own directory first, so that its includes resolve
    cmd = [_build._nvcc(), *_build.FLAGS, "-I", str(source.parent), "-o", str(so), str(source)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so


def finish_build(proc, so: Path, source: Path):
    log = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{log}")
    lib = ctypes.CDLL(str(so))
    P_, I_ = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.syrk_f32, lib.syrk_f64):
        fn.argtypes = [P_, P_, I_, I_, P_]
        fn.restype = I_
    ptxas = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    return lib, ptxas, sass_loop_opcodes(so)


def sass_loop_opcodes(so: Path) -> dict:
    """{kernel: {opcode: count}} over each float32 kernel's instructions
    from its first FFMA to its last (its main loop), and under
    `ffma_bank_pairs` the FFMAs two of whose source registers that the
    operand reuse cache does not serve share a register bank (index mod 2),
    which costs the FFMA an extra cycle."""
    from laplace_jax_torch.ops import _build

    tool = Path(_build._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True, text=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", text)[1:]:
        name = func.split("\n", 1)[0].strip()
        ins = [m.group(1).strip() for m in re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", func)]
        fma = [i for i, op in enumerate(ins) if op.startswith("FFMA")]
        if "IfLi" not in name or not fma:
            continue
        hist, pairs, cached = {}, 0, {}
        for op in ins[fma[0]:fma[-1] + 1]:
            code = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0]
            hist[code] = hist.get(code, 0) + 1
            if not code.startswith("FFMA"):
                continue
            srcs = [o.strip() for o in op.split(None, 1)[1].split(",")][1:4]
            regs = [o.replace(".reuse", "") for o in srcs]
            banks = [int(r[1:]) % 2 for slot, r in enumerate(regs)
                     if r[1:].isdigit() and cached.get(slot) != r]
            pairs += len(banks) != len(set(banks))
            cached = {slot: r for slot, (o, r) in enumerate(zip(srcs, regs)) if o.endswith(".reuse")}
        out[name] = dict(sorted(hist.items(), key=lambda kv: -kv[1]), ffma_bank_pairs=pairs)
    return out


def cuda_ms(fn, reps: int) -> float:
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


def trace(lib, source, gen, device, quick):
    import torch

    stream = torch.cuda.current_stream(device).cuda_stream

    def launcher(A, H):
        R, P = A.shape
        fn = lib.syrk_f32 if A.dtype == torch.float32 else lib.syrk_f64

        def run():
            rc = fn(A.data_ptr(), H.data_ptr(), R, P, stream)
            if rc != 0:
                raise RuntimeError(f"syrk launch failed: {rc}")
        return run

    def timed(R, P, reps=20):
        A = torch.randn(R, P, generator=gen, device=device)
        H = torch.empty(P, P, device=device)
        return cuda_ms(launcher(A, H), reps)

    R, P = 1280, 5130
    A = torch.randn(R, P, generator=gen, device=device)
    H = torch.empty(P, P, device=device)
    run = launcher(A, H)
    run()
    torch.cuda.synchronize()
    ref = A.double().mT @ A.double()
    rel_err = float((H.double() - ref).abs().max() / ref.abs().max())
    ms = cuda_ms(run, 50)
    flops = R * P * (P + 1)
    row = dict(source=str(source), shape=[R, P], ms=ms, tflops=flops / ms / 1e9,
               bound_ms=1e3 * flops / F32_FLOPS, bound_fraction=1e3 * flops / F32_FLOPS / ms,
               rel_err_vs_f64=rel_err, exactly_symmetric=bool(torch.equal(H, H.mT)))
    A64, H64 = A.double(), torch.empty(P, P, device=device, dtype=torch.float64)
    row["ms_f64"] = cuda_ms(launcher(A64, H64), 20)
    row["rel_err_f64"] = float((H64 - ref).abs().max() / ref.abs().max())
    if quick:
        row["by_P"] = {p: timed(R, p) for p in (4096, 5128)}
        return row

    Rs = [0, 16, 160, 320, 640, 1280, 2560]
    by_R = {r: timed(r, P) for r in Rs}
    n = len(Rs)
    mx, my = sum(Rs) / n, sum(by_R.values()) / n
    slope = sum((r - mx) * (by_R[r] - my) for r in Rs) / sum((r - mx) ** 2 for r in Rs)
    row.update(by_R=by_R, fixed_ms=my - slope * mx, us_per_16_rows=1e3 * 16 * slope)
    row["by_P"] = {p: timed(R, p) for p in (4096, 4097, 4224, 4352, 5120, 5128, 5129, 5130, 5131, 5248)}

    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            run()
        torch.cuda.synchronize()
    dev = {}
    for ev in prof.key_averages():
        t = getattr(ev, "device_time_total", None)
        if t is None:
            t = getattr(ev, "cuda_time_total", 0)
        if t:
            dev[ev.key] = dict(device_us=t, count=ev.count)
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    if kernels:
        t0 = min(e.time_range.start for e in kernels)
        t1 = max(e.time_range.end for e in kernels)
        busy = sum(e.time_range.end - e.time_range.start for e in kernels)
        row["profiler"] = dict(kernels=dev, window_us=t1 - t0, busy_us=busy,
                               busy_share=busy / max(t1 - t0, 1e-9))
    else:
        row["profiler"] = dict(kernels=dev, note="no device events in the trace")
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", type=Path,
                    help="a syrk.cu to trace (repeatable); default the package's")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "trace_syrk.json")
    ap.add_argument("--quick", action="store_true",
                    help="time only (1280, 5130), P = 4096 and 5128: no sweeps, no profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("trace_syrk: no CUDA device")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    sources = args.source or [ROOT / "laplace_jax_torch" / "csrc" / "syrk.cu"]
    # the SM clock and the board power every 200 ms while the builds run
    sampler = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
                                "--format=csv,noheader", "-lms", "200"],
                               stdout=subprocess.PIPE, text=True)
    rows = []
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        jobs = [start_build(i, src.resolve()) for i, src in enumerate(sources)]
        for src, (proc, so) in zip(sources, jobs):
            lib, ptxas, sass = finish_build(proc, so, src)
            gen = torch.Generator(device=device).manual_seed(0)
            row = trace(lib, src, gen, device, args.quick)
            row.update(ptxas=ptxas, sass=sass, nvidia_smi=smi)
            print(json.dumps(row), flush=True)
            rows.append(row)
        A = torch.randn(1280, 5130, device=device)
        mm = dict(library="torch.mm(A.mT, A), TF32 off", shape=[1280, 5130],
                  ms=cuda_ms(lambda: torch.mm(A.mT, A), 50), nvidia_smi=smi)
    print(json.dumps(mm), flush=True)
    sampler.terminate()
    samples = [ln.split(", ") for ln in sampler.communicate()[0].splitlines() if ln.count(",") == 2]
    busy = [(float(c.split()[0]), float(w.split()[0])) for c, _, w in samples if float(w.split()[0]) > 150]
    clocks = dict(samples=len(samples), samples_over_150_W=len(busy),
                  sm_mhz_under_load=sorted({c for c, _ in busy}), max_w=max((w for _, w in busy), default=None),
                  max_sm_mhz=samples[0][1] if samples else None)
    print(json.dumps(dict(clocks=clocks)), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(dict(builds=rows, library=mm, clocks=clocks), indent=1))


if __name__ == "__main__":
    main()
