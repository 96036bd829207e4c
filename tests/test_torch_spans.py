"""The port's spans and counters (`laplace_jax_torch/utils/spans.py`).

Off, a span records nothing and calls nothing; recording, the registry
holds each span's calls, parents, self seconds and the counters; inside a
fit, `fit_seconds` holds each span's seconds; under `torch.profiler` every
span is a user annotation inside its parent, named as the benchmark's
outside label wherever one exists. The card's tests (`cuda` mark) count a
planted host sync and hold a synchronised span's device-timeline seconds
within its host seconds:

    python -m pytest --noconftest tests/test_torch_spans.py -m cuda -q

No JAX here: the file runs on the card too.
"""

import time
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import tracing
from laplace_jax_torch import Laplace
from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts
from laplace_jax_torch.utils import matrix, spans
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.matrix import Kron

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def empty_registry():
    spans.reset()
    yield
    spans.reset()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (host syncs and device-timeline seconds)")
    return torch.device("cuda")


def _net():
    torch.manual_seed(0)
    return torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3, padding=1), torch.nn.ReLU(),
                               torch.nn.Flatten(), torch.nn.Linear(4 * 6 * 6, 5))


def _loader(device="cpu"):
    g = torch.Generator().manual_seed(1)
    X = torch.randn(16, 3, 6, 6, generator=g)
    y = torch.randint(0, 5, (16,), generator=g)
    return ArrayLoader(X.to(device), y.to(device), batch_size=8)


def _kron_fit(subset="all", device="cpu"):
    la = Laplace(_net(), "classification", subset_of_weights=subset, hessian_structure="kron",
                 device=device)
    la.fit(_loader(device))
    return la


def _spd_stack(K, n, dtype=torch.float32):
    A = torch.randn(K, n, n, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    return (A @ A.mT / n + torch.eye(n, dtype=torch.float64)).to(dtype)


def test_off_records_nothing(monkeypatch):
    def forbidden(*args, **kwargs):
        raise AssertionError("called while spans are off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", forbidden)
    monkeypatch.setattr(torch.cuda, "Event", forbidden)
    first = spans.span("decompose.stage2")
    assert spans.span("decompose.stage2") is first  # one shared no-op a name

    @spans.span("decorated")
    def add(a, b):
        return a + b

    with first:
        with spans.span("inner", host_clock=True):
            spans.count("decompose.retries")
            assert add(1, 2) == 3
    assert spans.summary() == {"spans": {}, "counters": {}}


def test_recording_nests_and_counts():
    @spans.span("child.decorated")
    def nap():
        time.sleep(0.002)

    with spans.recording():
        for _ in range(2):
            with spans.span("outer"):
                time.sleep(0.002)
                with spans.span("outer.inner"):
                    time.sleep(0.004)
                    spans.count("events", 3)
                nap()
        spans.count("events")
    out = spans.summary()
    s = out["spans"]
    assert out["counters"] == {"events": 7}
    assert {n: (e["count"], e["parent"]) for n, e in s.items()} == {
        "outer": (2, None), "outer.inner": (2, "outer"), "child.decorated": (2, "outer")}
    children = s["outer.inner"]["device_s"] + s["child.decorated"]["device_s"]
    assert s["outer"]["self_s"] == pytest.approx(s["outer"]["device_s"] - children)
    assert 0.004 <= s["outer"]["self_s"] < s["outer"]["device_s"]
    assert s["outer.inner"]["self_s"] == s["outer.inner"]["device_s"] >= 0.008
    assert all(e["syncs"] is None for e in s.values())  # no card: no syncs counted
    with spans.span("after"):  # the scope has closed: off again
        pass
    spans.reset()
    assert spans.summary() == {"spans": {}, "counters": {}}


def test_fit_fills_fit_seconds():
    la = _kron_fit()
    f = la.fit_seconds
    assert {"accumulate", "decompose", "accumulate.batch", "accumulate.forward",
            "accumulate.sweeps", "accumulate.grams", "decompose.class", "decompose.eigh",
            "decompose.flags", "fit"} <= set(f)
    slack = 1e-6  # the host clock's grain
    assert f["accumulate.forward"] + f["accumulate.sweeps"] + f["accumulate.grams"] <= (
        f["accumulate.batch"] + slack)
    assert f["accumulate.batch"] <= f["accumulate"] + slack
    assert f["decompose.eigh"] <= f["decompose.class"] + slack
    assert f["decompose.class"] + f["decompose.flags"] <= f["decompose"] + slack
    assert f["accumulate"] + f["decompose"] <= f["fit"] + slack
    assert spans.summary()["spans"] == {}  # a fit alone fills no registry
    f["stale"] = 1.0
    la.fit(_loader())
    assert "stale" not in la.fit_seconds  # each fit clears the previous fit's keys


def test_two_stage_solver_spans_its_stages():
    seconds = {}
    with spans.collect(seconds, "cpu"):
        eigh_stack_ts(_spd_stack(2, 100), device="cpu")
    stages = {"decompose.stage1", "decompose.stage2", "decompose.stage2.leaves",
              "decompose.stage2.merge", "decompose.stage2.orthonormalize",
              "decompose.back_transform"}
    assert set(seconds) == stages
    parts = sum(seconds[f"decompose.stage2.{p}"] for p in ("leaves", "merge", "orthonormalize"))
    assert parts <= seconds["decompose.stage2"] + 1e-6


def _annotations(prof) -> list:
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events() if e.is_user_annotation()]


def test_profiler_sees_every_span_inside_its_parent():
    la = _kron_fit(subset="last_layer")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _kron_fit()
        la(_loader().x[:4])
        eigh_stack_ts(_spd_stack(1, 60), device="cpu")
    s = spans.summary()["spans"]
    events = _annotations(prof)
    assert {n for n, _, _ in events} == set(s)
    labels = {name for _, _, name in tracing.SPANS} | {tracing.STAGE1_SPAN}
    assert labels <= set(s)  # each outside label is a program span's name
    for name, t0, t1 in events:
        parent = s[name]["parent"]
        if parent is not None:
            assert any(p == parent and p0 <= t0 and t1 <= p1 for p, p0, p1 in events), name
    assert spans.span("fit") is spans.span("fit")  # the profiler has stopped: off again


def test_planted_nan_counts_one_retry(monkeypatch):
    H = Kron([(_spd_stack(1, 6, torch.float64)[0], _spd_stack(1, 3, torch.float64)[0])])
    real_eigh = torch.linalg.eigh

    def nan_at_6(M):
        L, W = real_eigh(M)
        return (L * torch.nan, W) if M.ndim == 3 and M.shape[-1] == 6 else (L, W)

    monkeypatch.setattr(torch.linalg, "eigh", nan_at_6)
    before = matrix.SYMEIG_RETRIES
    with spans.recording():
        H.decompose()
    assert matrix.SYMEIG_RETRIES == before + 1
    out = spans.summary()
    assert out["counters"] == {"decompose.retries": 1}
    assert out["spans"]["decompose.flags"]["count"] == 1


def test_one_item_is_one_host_sync(cuda):
    x = torch.ones(1000, device=cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        with spans.recording():
            with spans.span("outer"):
                y = x * 2
                with spans.span("outer.read"):
                    y.sum().item()
                warnings.warn("a warning of another kind")
    s = spans.summary()["spans"]
    assert s["outer.read"]["syncs"] == 1
    assert s["outer"]["syncs"] == 0  # charged to the innermost span
    assert [str(w.message) for w in seen] == ["a warning of another kind"]
    assert torch.cuda.get_sync_debug_mode() == 0


def test_synchronised_span_device_seconds_within_host_seconds(cuda):
    a = torch.randn(2048, 2048, device=cuda)
    torch.cuda.synchronize()
    with spans.recording():
        with spans.span("work"):
            for _ in range(10):
                a = a @ a.T / 2048
            torch.cuda.synchronize()
    e = spans.summary()["spans"]["work"]
    # the host's clock is read before the entry's event and after the exit's,
    # which the card runs a launch latency (some µs) after it is recorded
    assert 0.99 * e["host_s"] <= e["device_s"] <= e["host_s"] + 20e-6
