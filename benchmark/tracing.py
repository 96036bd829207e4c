"""The traced segment of a `--trace 1` run.

After the window closes, the loop runs `trace_*` more units (fits or test
set sweeps) under `torch.profiler`, with spans from this file around the
calls into the program's layers. The trace gives the device's busy time
(the union of every device operation's interval), the device time of each
kernel by name, and the idle gaps, each named after the innermost span the
host was in when the gap began.

The spans wrap the program's functions from outside, for the traced
segment only, and are taken off after it; the window itself runs the
program untouched.
"""

from __future__ import annotations

import importlib
import time
from contextlib import contextmanager

# (module, attribute path, span name): calls into the program's layers
SPANS = (
    ("laplace_jax_torch.baselaplace", "KronLaplace.fit", "fit"),
    ("laplace_jax_torch.curvature.backend", "CurvatureBackend.kron", "accumulate.batch"),
    ("laplace_jax_torch.utils.matrix", "Kron.decompose", "decompose"),
    ("laplace_jax_torch.utils.matrix", "_batched_eigh_clipped", "decompose.class"),
    ("laplace_jax_torch.ops.tridiag_eig", "tridiag_eigh", "decompose.stage2"),
    ("laplace_jax_torch.ops.tridiag_eig", "apply_q", "decompose.back_transform"),
    ("laplace_jax_torch.baselaplace", "ParametricLaplace.__call__", "predict.call"),
    ("laplace_jax_torch.curvature.backend", "CurvatureBackend.last_layer_jacobians",
     "predict.features_jacobians"),
    ("laplace_jax_torch.utils.matrix", "KronDecomposed.inv_square_form", "predict.variance"),
)
# the stage-1 routes of the two-stage solver, wrapped in its route table
STAGE1_SPAN = "decompose.stage1"
WINDOW_SPAN = "trace.window"
TOP = 10


def _wrap(fn, name):
    from torch.profiler import record_function

    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    wrapped.__wrapped__ = fn
    return wrapped


@contextmanager
def program_spans():
    """The spans of `SPANS` and the stage-1 routes, on for the scope."""
    undo = []
    try:
        for module, path, name in SPANS:
            owner = importlib.import_module(module)
            *parents, attr = path.split(".")
            for p in parents:
                owner = getattr(owner, p)
            fn = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
            setattr(owner, attr, _wrap(fn, name))
            undo.append((owner, attr, fn))
        table = importlib.import_module("laplace_jax_torch.ops.tridiag_eig").STAGE1
        saved = dict(table)
        for k, fn in saved.items():
            table[k] = _wrap(fn, STAGE1_SPAN)
        undo.append((table, None, saved))
        yield
    finally:
        for owner, attr, fn in reversed(undo):
            if attr is None:
                owner.clear()
                owner.update(fn)
            else:
                setattr(owner, attr, fn)


def _union(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _host_span_at(spans: list, t: float) -> str:
    """The innermost span (latest begun) that holds time t."""
    best, name = None, "outside the program's spans"
    for s, e, n in spans:
        if s <= t < e and (best is None or s >= best):
            best, name = s, n
    return name


def summarize(events, labels: set) -> dict:
    """Busy and window seconds, device seconds by kernel name, the longest
    device operations and the idle gaps by host span, from the profiler's
    raw events (`kineto_results.events()`, times in nanoseconds). The
    device's own copies of the spans (user annotations on its timeline)
    are no device work and are left out."""
    host, device, window = [], [], None
    for e in events:
        name, kind = e.name(), e.device_type().name
        t0, t1 = e.start_ns(), e.start_ns() + e.duration_ns()
        annotation = getattr(e, "is_user_annotation", None)
        if (annotation is not None and annotation()) or name in labels or name == WINDOW_SPAN:
            if kind == "CPU":
                if name == WINDOW_SPAN:
                    window = (t0, t1)
                elif name in labels:
                    host.append((t0, t1, name))
        elif kind == "CUDA":
            device.append((t0, t1, name))
    w0, w1 = window
    by_name: dict = {}
    intervals = []
    for s, t, name in device:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        intervals.append((s, t))
        by_name[name] = by_name.get(name, 0.0) + (t - s) * 1e-9
    busy = _union(intervals)
    gaps: dict = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 > g0:
            name = _host_span_at(host, g0)
            gaps[name] = gaps.get(name, 0.0) + (g1 - g0) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(e - s for s, e in busy) * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "kernel_s": by_name,
            "device_ops": [[n[:160], s] for n, s in top],
            "idle_gaps": [[n, s] for n, s in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]}


def traced(loop, device) -> dict:
    """Run the loop's traced units under the profiler; the summary, with
    `units` (how many fits or sweeps it holds) and `host_s` (the segment's
    seconds on the host clock)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark.harness import sync

    run, n = loop.trace_units()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda"
                                           else [])
    sync(device)
    with program_spans(), profile(activities=activities) as prof:
        with record_function(WINDOW_SPAN):
            t0 = time.perf_counter()
            run(n)
            sync(device)
            host_s = time.perf_counter() - t0
    labels = {name for _, _, name in SPANS} | {STAGE1_SPAN}
    out = summarize(prof.profiler.kineto_results.events(), labels)
    out.update(units=n, host_s=host_s)
    del prof
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out
