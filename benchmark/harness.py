"""The data-driven core: finds a cell's files by name and runs it once.

A cell of `BENCHMARK.json` names a configuration and a traffic mix. By
those names the harness reads:

- `configs/<config>.json`: the sizes, the program's model class and the
  layer table the counts read; `configs/<config>.py`, the plain forward;
- `traffic/<traffic>.json`: the mix's parameters, among them `loop`, the
  kind of work, which names `loops/<loop>.py`;
- `limits/<cell>.json`: the limit of each number the check compares;
- `metrics/<metric>.py`: one reader for each per-layer metric.

So a later cell, configuration, mix or metric is new files and new
entries in `BENCHMARK.json`, and no edit of a file here.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# top-level module names the port must not load (compared whole: the port's
# own name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "laplace_jax")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A Python file as a module; its name need not be an identifier."""
    name = "benchmark_file_" + "".join(c if c.isalnum() else "_" for c in path.stem)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark_json() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find_cell(bm: dict, name: str) -> dict:
    for cell in bm["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"No workload {name!r} in BENCHMARK.json; "
                   f"there are {[c['name'] for c in bm['workloads']]}.")


def load_config(name: str) -> dict:
    return load_json(BENCH / "configs" / f"{name}.json")


def reference_forward(config: dict):
    """The configuration's plain forward, `configs/<name>.py`."""
    return load_module(BENCH / "configs" / f"{config['name']}.py").forward


def load_traffic(name: str) -> dict:
    return load_json(BENCH / "traffic" / f"{name}.json")


def load_limits(cell: str) -> dict:
    return {k: v["limit"] for k, v in load_json(BENCH / "limits" / f"{cell}.json").items()}


def load_loop(kind: str):
    return load_module(BENCH / "loops" / f"{kind}.py")


def cell_metrics(bm: dict, cell: str, traced: bool) -> list:
    """The metric entries a run of `cell` reports: its end-to-end metrics
    (those without `workloads`, or listing the cell); with `traced`, the
    per-layer metrics whose `workloads` list the cell. Every per-layer
    entry names its cells."""
    e2e = [m for m in bm["end_to_end"] if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    unlisted = [m["name"] for m in bm["per_layer"] if "workloads" not in m]
    if unlisted:
        raise ValueError(f"Per-layer metrics {unlisted} list no `workloads`: each names the "
                         "cells in which it is read.")
    return [m for m in bm["per_layer"] if cell in m["workloads"]]


def process_age() -> float:
    """Seconds since this process started, from the kernel's record of its
    start; the interpreter's start-up counts as set-up too."""
    with open("/proc/self/stat") as f:
        start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def forbidden_modules(names=None) -> list:
    """The forbidden top-level names among `names` (default: the modules
    this process holds)."""
    names = sys.modules if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def merge(base: dict, override: dict | None) -> dict:
    return {**base, **(override or {})}


def run_cell(name: str, seed: int, seconds: float, trace: bool, device=None,
             config_override: dict | None = None, traffic_override: dict | None = None,
             control: bool = False) -> dict:
    """Set up, warm up, measure `seconds`, optionally trace, check; the
    result line's dict (with `checks` last). `device` defaults to
    the first card; the overrides replace top-level keys of the
    configuration and the mix (rehearsals on the CPU at a tiny size). A run
    is correct when every number is within its limit and no answer of the
    window failed (`loop.failed`: a call whose probabilities are not
    finite). With
    `control`, the result also holds `control_checks`: the same numbers of
    the control, the reference one precision below the configuration's,
    put in the program's place on the same inputs."""
    import torch

    from benchmark import tracing

    device = torch.device(device or "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats(device)
    bm = benchmark_json()
    cell = find_cell(bm, name)
    config = merge(load_config(cell["config"]), config_override)
    traffic = merge(load_traffic(cell["traffic"]), traffic_override)
    limits = load_limits(name)
    loop = load_loop(traffic["loop"]).Loop(config, traffic, seed, device,
                                           reference_forward(config))
    loop.setup()
    setup_s = process_age()
    e2e = loop.window(seconds)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    trace_summary = tracing.traced(loop, device) if trace else None
    ctx = SimpleNamespace(config=config, traffic=traffic, stats=loop.layer_stats(),
                          trace=trace_summary)
    metrics = {}
    for m in cell_metrics(bm, name, trace):
        if trace:
            value = load_module(BENCH / "metrics" / f"{m['name']}.py").read(ctx)
        else:
            value = setup_s if m["name"] == "setup_s" else e2e[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    outputs = loop.program_outputs()
    loop.free()
    ref = loop.reference(outputs)
    checks = loop.compare(outputs, ref)
    correct = loop.failed == 0 and all(math.isfinite(v) and v <= limits[k]
                                       for k, v in checks.items())
    result = {"correct": correct, "attempted": loop.attempted, "failed": loop.failed,
              "metrics": metrics, "device": device_info(device, memory_peak, trace_summary)}
    if trace_summary is not None:
        result["breakdown"] = {"device_ops": trace_summary["device_ops"],
                               "idle_gaps": trace_summary["idle_gaps"]}
    result["units"] = loop.units()
    result["card"] = card_info(device)
    if control:
        ctrl = loop.control_outputs(outputs)
        result["control_checks"] = loop.compare(ctrl, loop.reference(ctrl))
    result["checks"] = {k: {"value": v, "limit": limits[k]} for k, v in checks.items()}
    return result


def device_info(device, memory_peak: int, trace_summary) -> dict:
    import torch

    cuda = device.type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": memory_peak}
    if trace_summary is not None:
        out["busy_s"] = trace_summary["busy_s"]
        out["window_s"] = trace_summary["window_s"]
    return out


def card_info(device) -> dict:
    """The card's name and power limit as `nvidia-smi` reads them (a card
    set below 700 W runs slower under load)."""
    if device.type != "cuda":
        return {}
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", f"--id={device.index or 0}"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as exc:
        return {"nvidia_smi": f"unread: {exc}"}
    return {"nvidia_smi": out.stdout.strip()}


def timed_loop(seconds: float, step) -> tuple:
    """Closed loop: call `step(i)` for i = 0, 1, ... while fewer than
    `seconds` have passed since the first call began; each call returns
    when its work is synchronised. Returns (start, [(t0, t1)] per call)."""
    spans = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        if spans and t0 - start >= seconds:
            break
        step(i)
        spans.append((t0, time.perf_counter()))
        i += 1
    return start, spans


def mark(device):
    """An event recorded on the device's current stream, timed on a card;
    on the CPU, where work is done when it is sent, a stand-in whose wait
    returns at once and whose time is the host's."""
    if device.type == "cuda":
        import torch

        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event
    return _HostMark()


class _HostMark:
    def __init__(self):
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, later) -> float:
        return 1e3 * (later.t - self.t)


def ahead_loop(seconds: float, step, device) -> tuple:
    """Work sent ahead: call `step(i)` for i = 0, 1, ... while fewer than
    `seconds` have passed since the first call began (each call sends its
    work and returns; it may wait for work sent earlier). Then send
    nothing more, wait for everything sent, and read the clock after that
    wait. Returns (start, end, number of calls)."""
    start = time.perf_counter()
    i = 0
    while i == 0 or time.perf_counter() - start < seconds:
        step(i)
        i += 1
    sync(device)
    return start, time.perf_counter(), i


class Reservoir:
    """A uniform sample of `k` items from a stream of unknown length, drawn
    from the seed (Vitter's algorithm R)."""

    def __init__(self, k: int, rng):
        self.k, self.rng, self.items, self.seen = k, rng, [], 0

    def offer(self, item) -> None:
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1
