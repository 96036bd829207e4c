"""Nothing a run loads may be JAX or the JAX package, and the reference
imports nothing of the port. Module names are compared by their whole
top-level name: the port's own name begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

PLAIN = sorted((ROOT / "benchmark" / "reference").glob("*.py")) + sorted(
    (ROOT / "benchmark" / "configs").glob("*.py"))


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", PLAIN, ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert imported_tops(path) <= {"__future__", "math", "torch", "benchmark"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("benchmark"):
            assert node.module.startswith("benchmark.reference"), node.module


def run_python(code: str) -> list:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_reference_alone_loads_no_port():
    loaded = run_python(
        "import json, sys\n"
        "import benchmark.reference.kfac, benchmark.reference.posterior\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert "laplace_jax_torch" not in loaded
    assert not set(loaded) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("cell", ["resnet18-cifar10.kron-fit-n512",
                                  "wrn16-4-cifar10.ll-probit-b512"])
def test_run_loads_no_jax(cell):
    """A cell's whole run on the CPU at its tiny size, then the process's
    modules."""
    loaded = run_python(
        "import json, sys\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "import tiny\n"
        "from benchmark import harness\n"
        f"r = tiny.run_tiny({cell!r}, seconds=0.2)\n"
        "print(json.dumps(harness.forbidden_modules() + [r['correct']]))")
    assert loaded == [True]


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["laplace_jax_torch", "laplace_jax_torch.ops",
                                      "jaxtyping", "flaxen.x", "torch"]) == []
    assert harness.forbidden_modules(["jax.numpy", "laplace_jax.utils", "flax", "optax",
                                      "jaxlib"]) == sorted(harness.FORBIDDEN)
