"""The PyTorch port imports nothing of JAX or of the JAX package.

An AST check over every module of `laplace_jax_torch/`, every script of
`examples_torch/` and `chip_smoke.py`: no `import jax`, `flax`, `optax` or
`laplace_jax[.*]`.
And in a fresh interpreter, importing the package, the Lanczos module and
the flax-layer twins leaves no `jax` and no `laplace_jax` in `sys.modules`.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "laplace_jax")
FILES = (sorted((ROOT / "laplace_jax_torch").rglob("*.py"))
         + sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"])


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
    assert {"latrd.py", "latrd_v4.py", "latrd_v3.py", "latrd_v2.py", "syrk.py",
            "baselaplace.py", "lllaplace.py", "lanczos.py", "flax_layers.py", "band.py",
            "chase.py", "chip_smoke.py"} <= names
    examples = {p.name for p in FILES if p.parent.name == "examples_torch"}
    assert examples == {p.name for p in (ROOT / "examples").glob("*.py")}


@pytest.mark.parametrize("module", ["laplace_jax_torch", "laplace_jax_torch.curvature.lanczos",
                                    "laplace_jax_torch.models.flax_layers"])
def test_import_loads_no_jax(module):
    code = (f"import sys, {module}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}); print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stdout + out.stderr
