"""The port's stage-1 dispatcher (`laplace_jax_torch.ops.tridiag_eig._stage1_impl`)
against the JAX package's (`laplace_jax.ops.tridiag_eig._stage1_impl`),
mirroring `tests/test_stage1_dispatch.py`: `LAPLACE_TS_STAGE1` beats the
argument and the auto rule; it takes the JAX package's three names
(`pallas`, `pallas_v4`, `xla`, mapped onto the port's `latrd`, `latrd_v4`,
`plain`) and the port's spellings of those routes; an unknown value is
ignored, and no value reaches v3 or v2, which only `stage1=` selects.
"""

import pytest
import torch

from laplace_jax.ops.tridiag_eig import _stage1_impl as jax_stage1_impl
from laplace_jax_torch.ops import tridiag_eig
from laplace_jax_torch.ops.tridiag_eig import STAGE1_OVERRIDE, _stage1_impl

CUDA, CPU = torch.device("cuda", 0), torch.device("cpu")
JAX_TO_PORT = {"pallas": "latrd", "pallas_v4": "latrd_v4", "xla": "plain"}


@pytest.fixture
def clean_env(monkeypatch):
    monkeypatch.delenv("LAPLACE_TS_STAGE1", raising=False)


@pytest.mark.parametrize("impl", sorted(STAGE1_OVERRIDE))
def test_env_override_wins(monkeypatch, impl):
    monkeypatch.setenv("LAPLACE_TS_STAGE1", impl)
    route = STAGE1_OVERRIDE[impl]
    for device in (CUDA, CPU):
        assert _stage1_impl(4608, "auto", device) == route
        assert _stage1_impl(64, "plain", device) == route  # beats an explicit argument
        assert _stage1_impl(1152, "latrd_v3", device) == route
        assert _stage1_impl(1152, "latrd_v2", device) == route
    if impl in JAX_TO_PORT:  # the JAX package's name: the same route there
        assert JAX_TO_PORT[jax_stage1_impl(4608, "auto")] == route
        assert JAX_TO_PORT[jax_stage1_impl(64, "xla")] == route


@pytest.mark.parametrize("value", ["cuda", "latrd_v3", "latrd_v2", "pallas_v3", "pallas_v2",
                                   "auto", ""])
def test_unknown_env_value_ignored(monkeypatch, value):
    """Any other value leaves the argument and the auto rule in force; v3
    and v2 stay out of the variable's reach, as in the JAX package."""
    monkeypatch.setenv("LAPLACE_TS_STAGE1", value)
    assert _stage1_impl(64, "plain", CUDA) == "plain"
    assert _stage1_impl(4608, "auto", CUDA) == "latrd_v4"
    assert _stage1_impl(1152, "latrd_v3", CUDA) == "latrd_v3"
    assert jax_stage1_impl(64, "xla") == "xla"


@pytest.mark.parametrize("impl", ["latrd", "latrd_v4", "latrd_v3", "latrd_v2", "plain"])
def test_explicit_argument(clean_env, impl):
    assert _stage1_impl(4608, impl, CUDA) == impl
    assert set(STAGE1_OVERRIDE.values()) <= set(tridiag_eig.STAGE1)


def test_auto_on_cpu_is_plain(clean_env):
    """The CPU takes the plain stage 1 at every size (the JAX package's
    auto rule on the CPU backend takes "xla")."""
    for n in (64, 512, 4608):
        assert _stage1_impl(n, "auto", CPU) == "plain"
        assert jax_stage1_impl(n, "auto") == "xla"


def test_auto_on_cuda_table(clean_env, monkeypatch):
    """The JAX package's TPU table on CUDA: plain below 512, v1 at
    512-2303, v4 from 2304."""
    import jax

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for n in (256, 512, 1152, 2304, 4608):
        assert _stage1_impl(n, "auto", CUDA) == JAX_TO_PORT[jax_stage1_impl(n, "auto")]


def test_override_routes_a_decompose(monkeypatch):
    """`eigh_stack_ts` under the variable runs the named stage 1: on the CPU
    each kernel route takes its plain panels, so the spectra agree."""
    gen = torch.Generator().manual_seed(0)
    A = torch.randn(2, 96, 96, generator=gen, dtype=torch.float64)
    A = (A + A.mT) / 2
    ref = torch.linalg.eigvalsh(A)
    called = []
    for name in ("latrd", "latrd_v4", "plain"):
        inner = tridiag_eig.STAGE1[name]
        monkeypatch.setitem(tridiag_eig.STAGE1, name,
                            lambda *a, inner=inner, name=name, **k: called.append(name)
                            or inner(*a, **k))
    for impl, route in (("pallas", "latrd"), ("pallas_v4", "latrd_v4"), ("xla", "plain")):
        monkeypatch.setenv("LAPLACE_TS_STAGE1", impl)
        lam, _ = tridiag_eig.eigh_stack_ts(A, nb=32, stage1="latrd_v3", device="cpu")
        assert called[-1] == route
        torch.testing.assert_close(lam, ref, rtol=0, atol=1e-10)
