"""`BENCHMARK.json` and the files its names lead to: every cell's
configuration, mix, loop, limits and reference found by name, every name
and unit within the allowed characters, every per-layer metric's cells
reporting the metric it moves, every configuration's layer table true to
the port's model."""

from __future__ import annotations

import math
import re
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import tiny  # noqa: E402
from benchmark import harness  # noqa: E402
from benchmark.weights import build_model, make_weights, weight_specs  # noqa: E402

BM = harness.benchmark_json()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
CELLS = [c["name"] for c in BM["workloads"]]


def test_top_level_keys_and_command():
    assert set(BM) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                       "per_layer"}
    assert BM["command"] == ["python3", "benchmark/run.py"]
    assert BM["paths"] == ["benchmark"]
    assert isinstance(BM["run_seconds"], int) and 1 <= BM["run_seconds"] <= 51
    assert (harness.ROOT / BM["command"][1]).is_file()


def test_entries_have_only_their_keys():
    for c in BM["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BM["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in BM["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BM["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_names_units_and_texts_within_limits():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BM[group]:
            assert NAME.fullmatch(e["name"]), e["name"]
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
            if "unit" in e:
                assert UNIT.fullmatch(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
    for w in BM["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
    for c in BM["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for group in ("configs", "workloads"):
        assert len({e["name"] for e in BM[group]}) == len(BM[group])
    metrics = [m["name"] for m in BM["end_to_end"] + BM["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_file_under_paths_is_named_from_name_characters():
    for p in (harness.ROOT / "benchmark").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(harness.ROOT).as_posix()
            assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", rel), rel


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    entry = harness.find_cell(BM, cell)
    config = harness.load_config(entry["config"])
    assert config["name"] == entry["config"]
    assert callable(harness.reference_forward(config))
    traffic = harness.load_traffic(entry["traffic"])
    loop = harness.load_loop(traffic["loop"])
    assert hasattr(loop, "Loop")
    limits = harness.load_limits(cell)
    assert limits and all(v > 0 for v in limits.values())
    conf = next(c for c in BM["configs"] if c["name"] == entry["config"])
    assert (harness.ROOT / conf["file"]) == harness.BENCH / "configs" / f"{config['name']}.json"
    for m in harness.cell_metrics(BM, cell, traced=True):
        assert callable(harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py").read)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_setup_another_e2e_and_a_per_layer_metric(cell):
    e2e = {m["name"] for m in harness.cell_metrics(BM, cell, traced=False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(BM, cell, traced=True)


def test_each_per_layer_metric_moves_what_its_cells_report():
    for m in BM["per_layer"]:
        assert m["workloads"], m["name"]
        for cell in m["workloads"]:
            e2e = {x["name"] for x in harness.cell_metrics(BM, cell, traced=False)}
            assert m["moves"] in e2e, (m["name"], cell)


def test_every_config_used_and_in_a_file_of_its_own():
    used = {w["config"] for w in BM["workloads"]}
    assert used == {c["name"] for c in BM["configs"]}
    assert len({c["file"] for c in BM["configs"]}) == len(BM["configs"])


@pytest.mark.parametrize("name, make", [
    ("resnet18-cifar10", lambda: tiny.resnet_layers(64, 32)),
    ("wrn16-4-cifar10", lambda: tiny.wrn_layers(4, 32)),
])
def test_layer_table_is_the_models(name, make):
    """The committed table is the family's table at the published widths,
    its weight count the configuration's, and the port's model holds
    exactly the tensors the table makes."""
    config = harness.load_config(name)
    assert config["layers"] == make()
    n = sum(math.prod(shape) for k, shape, _ in weight_specs(config)
            if not k.endswith((".mean", ".var")))
    assert n == config["n_params"]
    weights = make_weights(config, 1, torch.device("cpu"))
    net = build_model(config, weights, torch.device("cpu"))
    assert sum(p.numel() for p in net.parameters()) == config["n_params"]
    assert {k: tuple(v.shape) for k, v in net.state_dict().items()} == {
        k: tuple(v.shape) for k, v in weights.items()}


@pytest.mark.parametrize("conf", BM["configs"], ids=lambda c: c["name"])
def test_reduced_keys_are_the_configuration_files(conf):
    """`reduced` in `BENCHMARK.json` is the configuration file's, and each
    key it names is a key of that file, set as the run uses it."""
    config = harness.load_json(harness.ROOT / conf["file"])
    assert conf["reduced"] == config["reduced"]
    assert all(k in config for k in conf["reduced"])


def test_a_per_layer_metric_without_workloads_is_refused():
    entry = {k: v for k, v in BM["per_layer"][0].items() if k != "workloads"}
    bm = {**BM, "per_layer": [*BM["per_layer"], {**entry, "name": "unlisted"}]}
    with pytest.raises(ValueError, match="unlisted"):
        harness.cell_metrics(bm, CELLS[0], traced=True)
