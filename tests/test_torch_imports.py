"""The PyTorch port imports nothing of JAX or of the JAX package.

An AST check over every module of `laplace_jax_torch/` and over
`chip_smoke.py`: no `import jax`, `flax`, `optax` or `laplace_jax[.*]`.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "laplace_jax")
FILES = sorted((ROOT / "laplace_jax_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_package_is_covered():
    names = {p.name for p in FILES}
    assert {"latrd.py", "latrd_v4.py", "latrd_v3.py", "latrd_v2.py", "eigh_dc.py", "syrk.py",
            "baselaplace.py", "lllaplace.py", "chip_smoke.py"} <= names
