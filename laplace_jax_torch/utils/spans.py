"""Spans and counters inside the port: each fit's breakdown by layer, and
on demand the profiler's labels, a registry of every span and the host's
waits for the card.

`span(name)` is a context manager and a decorator; `count(name, n)` adds
to a counter. Three states:

- **Off** (the default): a span checks two flags and returns a shared
  no-op; it records nothing, creates no CUDA event and calls no
  `record_function`. `count` does nothing.
- **Inside a fit**: `collect(seconds, device)`, which the Laplace classes'
  `fit` open, adds every span's seconds to the fit's `fit_seconds` under
  the span's name, summed over its calls. A span's seconds are the device
  timeline's: a CUDA event on the current stream at entry and at exit,
  resolved when the fit closes, after its own closing synchronise (the
  collector adds none). On the CPU they are the host clock's. A span made
  with `host_clock=True` is timed on the host clock wherever it runs: its
  caller synchronises on both sides (`accumulate`, `decompose`,
  `lanczos`). The collector clears the previous fit's keys when it opens.
- **Recording**: inside `recording()`, or while `torch.profiler` is
  active. Every span then also opens `torch.profiler.record_function(name)`
  (so the program's spans lie in the profiler's trace on the clock of its
  device events), goes into this process's registry (`summary()`,
  `reset()`), and counts the host's waits for the card inside it: under
  `torch.cuda.set_sync_debug_mode("warn")` each synchronizing CUDA
  operation warns, and the warning is counted against the innermost span
  instead of being shown (other warnings pass through). `count` adds to
  the registry's counters.

A span's clock follows its `device`: given, else the enclosing span's or
fit's, else the current card once CUDA is initialized, else the host.
Spans belong to the thread that runs the fit.
"""

from __future__ import annotations

import functools
import re
import time
import warnings
from contextlib import contextmanager

import torch
from torch.autograd import profiler as _profiler

__all__ = ["span", "count", "collect", "recording", "summary", "reset"]

# the text of `torch.cuda.set_sync_debug_mode("warn")`'s warning, and of
# the notice that the mode is a prototype (shown once a process)
_SYNC_WARNING = "called a synchronizing CUDA operation"
_PROTOTYPE_NOTICE = "Synchronization debug mode is a prototype feature"

_collectors: list = []  # open per-fit collectors, innermost last
_stack: list = []  # open live spans, innermost last
_recording = 0  # depth of `recording()` scopes
_records: list = []  # recorded spans whose events are not yet read
_spans: dict = {}  # the registry: name -> totals
_child_s: dict = {}  # name -> device-timeline seconds of its children
_counters: dict = {}
_watch = None  # (warnings scope, previous sync debug mode) while syncs are counted
_watch_depth = 0
_off: dict = {}


def _on() -> bool:
    return bool(_collectors) or _recording > 0 or _profiler._is_profiler_enabled


def _is_recording() -> bool:
    return _recording > 0 or _profiler._is_profiler_enabled


class _Named:
    """A span's name and settings; as a decorator, a span around each call."""

    __slots__ = ("name", "host_clock", "device")

    def __init__(self, name: str, host_clock: bool, device):
        self.name, self.host_clock, self.device = name, host_clock, device

    def __call__(self, fn):
        name, host_clock, device = self.name, self.host_clock, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, host_clock=host_clock, device=device):
                return fn(*args, **kwargs)

        return spanned


class _Off(_Named):
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


class _Live(_Named):
    __slots__ = ("parent", "collector", "recorded", "rf", "t0", "e0", "syncs")

    def __enter__(self):
        self.parent = _stack[-1] if _stack else None
        self.collector = _collectors[-1] if _collectors else None
        if self.device is None:
            self.device = (self.parent.device if self.parent is not None
                           else self.collector.device if self.collector is not None
                           else _default_device())
        self.recorded = _is_recording()
        self.syncs = 0
        if self.recorded:
            _watch_enter()
            self.rf = _profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        self.e0 = (_event(self.device) if self.device.type == "cuda"
                   and (self.recorded or not self.host_clock) else None)
        _stack.append(self)
        return self

    def __exit__(self, *exc) -> bool:
        e1 = _event(self.device) if self.e0 is not None else None
        host_s = time.perf_counter() - self.t0
        _stack.pop()
        c = self.collector
        if c is not None:
            if self.host_clock or e1 is None:
                c.seconds[self.name] = c.seconds.get(self.name, 0.0) + host_s
            else:
                c.pending.append((self.name, self.e0, e1))
        if self.recorded:
            self.rf.__exit__(None, None, None)
            _records.append((self.name, None if self.parent is None else self.parent.name,
                             host_s, self.e0, e1, self.syncs if _watch is not None else None))
            _watch_exit()
        return False


def span(name: str, *, host_clock: bool = False, device=None):
    """A span named `name` (module docstring), as `with span(name):` or
    `@span(name)`. `host_clock`: timed on the host clock, the caller
    synchronising on both sides; `device`: the device whose current stream
    times it (default: the enclosing span's or fit's)."""
    if not _on():
        key = (name, host_clock, device)
        off = _off.get(key)
        if off is None:
            off = _off[key] = _Off(name, host_clock, device)
        return off
    return _Live(name, host_clock, None if device is None else torch.device(device))


def count(name: str, n: int = 1) -> None:
    """Add `n` to the registry's counter `name` while recording."""
    if _is_recording():
        _counters[name] = _counters.get(name, 0) + n


class _Collector:
    __slots__ = ("seconds", "device", "pending")

    def __init__(self, seconds: dict, device: torch.device):
        self.seconds, self.device, self.pending = seconds, device, []

    def resolve(self) -> None:
        if self.pending:
            self.pending[-1][2].synchronize()  # done already after the fit's own synchronise
        for name, e0, e1 in self.pending:
            self.seconds[name] = self.seconds.get(name, 0.0) + e0.elapsed_time(e1) / 1e3


@contextmanager
def collect(seconds: dict, device):
    """Collect the spans of one fit into `seconds` (cleared first), timed on
    `device`. Inside a collector of the same dict (a fit that calls its
    base class's fit) it adds nothing."""
    if _collectors and _collectors[-1].seconds is seconds:
        yield
        return
    seconds.clear()
    c = _Collector(seconds, torch.device(device))
    _collectors.append(c)
    try:
        yield
    finally:
        _collectors.remove(c)
    c.resolve()


@contextmanager
def recording():
    """Record every span and counter in the scope (module docstring),
    without the profiler."""
    global _recording
    _recording += 1
    _watch_enter()
    try:
        yield
    finally:
        _watch_exit()
        _recording -= 1


def summary() -> dict:
    """The registry: `spans`, for each recorded span name its calls
    (`count`), host seconds (`host_s`), device-timeline seconds
    (`device_s`; the host's on the CPU), self seconds (`self_s`: its
    device-timeline seconds less its children's), its parent's name
    (`parent`, the latest seen) and the host's waits for the card inside it
    (`syncs`: charged to the innermost span; None where none were counted,
    as on the CPU); and `counters`."""
    _resolve()
    spans = {name: dict(e, self_s=e["device_s"] - _child_s.get(name, 0.0))
             for name, e in _spans.items()}
    return {"spans": spans, "counters": dict(_counters)}


def reset() -> None:
    """Empty the registry."""
    _records.clear()
    _spans.clear()
    _child_s.clear()
    _counters.clear()


def _resolve() -> None:
    for name, parent, host_s, e0, e1, syncs in _records:
        if e1 is None:
            device_s = host_s
        else:
            e1.synchronize()
            device_s = e0.elapsed_time(e1) / 1e3
        e = _spans.setdefault(name, {"count": 0, "host_s": 0.0, "device_s": 0.0,
                                     "parent": parent, "syncs": None})
        e["count"] += 1
        e["host_s"] += host_s
        e["device_s"] += device_s
        e["parent"] = parent
        if syncs is not None:
            e["syncs"] = (e["syncs"] or 0) + syncs
        if parent is not None:
            _child_s[parent] = _child_s.get(parent, 0.0) + device_s
    _records.clear()


def _default_device() -> torch.device:
    if torch.cuda.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _event(device: torch.device):
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


def _watch_enter() -> None:
    """Count the host's waits for the card from here, once CUDA is up."""
    global _watch, _watch_depth
    _watch_depth += 1
    if _watch is not None or not torch.cuda.is_initialized():
        return
    scope = warnings.catch_warnings()
    scope.__enter__()
    warnings.filterwarnings("always", message=re.escape(_SYNC_WARNING))
    warnings.filterwarnings("ignore", message=re.escape(_PROTOTYPE_NOTICE))
    shown = warnings.showwarning

    def show(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING in str(message):
            for s in reversed(_stack):
                if s.recorded:
                    s.syncs += 1
                    break
            return
        shown(message, category, filename, lineno, file, line)

    warnings.showwarning = show
    previous = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("warn")
    _watch = (scope, previous)


def _watch_exit() -> None:
    global _watch, _watch_depth
    _watch_depth -= 1
    if _watch_depth > 0 or _watch is None:
        return
    scope, previous = _watch
    _watch = None
    torch.cuda.set_sync_debug_mode(previous)
    scope.__exit__(None, None, None)
