"""The CUDA kernels (LATRD panels, syrk) against their plain PyTorch
versions, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. Run them on a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

They import no JAX: the reference is the port's plain versions, which
`tests/test_torch_latrd.py` and `tests/test_torch_syrk.py` hold against the
JAX package on the CPU. Tolerances, relative to each output's largest
entry: float64 1e-10 (only the summation order differs); float32 2e-4 for
the panels (order, and the v4 kernel's atomics, whose order changes from
run to run) and 1e-4 for syrk (order over up to 1280 rows).
"""

import numpy as np
import pytest
import torch

from laplace_jax_torch.ops.latrd import latrd_panel, latrd_panel_plain, tridiagonalize_latrd
from laplace_jax_torch.ops.latrd_v4 import (
    latrd_panel_v4,
    latrd_panel_v4_plain,
    tridiagonalize_latrd_v4,
)
from laplace_jax_torch.ops.syrk import syrk, syrk_plain
from laplace_jax_torch.ops.tridiag import apply_q

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

PANELS = [pytest.param(latrd_panel, latrd_panel_plain, id="v1"),
          pytest.param(latrd_panel_v4, latrd_panel_v4_plain, id="v4")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _window(seed, K, m, n_valid, dtype):
    A = np.random.default_rng(seed).standard_normal((K, m, m))
    A = (A + A.transpose(0, 2, 1)) / 2
    A[:, n_valid:, :] = 0
    A[:, :, n_valid:] = 0
    return torch.as_tensor(A, dtype=dtype)


@pytest.mark.parametrize("kernel,plain", PANELS)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-4)])
@pytest.mark.parametrize("off,q_base", [(0, 0), (64, 5), (320, 5)])
def test_panel_matches_plain(cuda, kernel, plain, dtype, tol, off, q_base):
    """Panels at the window start, inside it, and at its tail, where columns
    past n_real - 2 must be exact no-ops; 5 padded rows."""
    K, m, nb = 3, 384, 64
    n_real = q_base + m - 5
    A = _window(4, K, m, m - 5, dtype)
    launches = kernel.launches
    got = kernel(A.to(cuda), off, q_base, n_real, nb)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    for g, r in zip(got, plain(A, off, q_base, n_real, nb)):
        torch.testing.assert_close(g.cpu(), r, atol=tol * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("driver", [tridiagonalize_latrd, tridiagonalize_latrd_v4])
def test_stage1_invariants(cuda, driver):
    n = 600
    A = torch.as_tensor(np.random.default_rng(5).standard_normal((2, n, n)))
    A = ((A + A.mT) / 2).to(cuda)
    d, e, V, taus = driver(A, nb=64)
    T = torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
    Q = apply_q(V, taus, torch.eye(n, dtype=A.dtype, device=cuda).expand(2, n, n), nb=64)
    torch.testing.assert_close(Q @ T @ Q.mT, A, atol=1e-10, rtol=0)
    torch.testing.assert_close(Q.mT @ Q, torch.eye(n, dtype=A.dtype, device=cuda).expand(2, n, n),
                               atol=1e-10, rtol=0)


@pytest.mark.parametrize("n,kernel", [(520, latrd_panel), (2304, latrd_panel_v4)])
def test_eigh_stack_ts_dispatches_to_kernel(cuda, n, kernel):
    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    gen = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn(2, n, n, generator=gen, device=cuda)
    A = (A + A.mT) / 2
    launches = kernel.launches
    lam, Q = eigh_stack_ts(A)
    assert kernel.launches > launches
    ref = torch.linalg.eigvalsh(A.double())
    # float32 stage 2 reads ~5e-6 here, and rarely several times that
    assert float((lam.double() - ref).abs().max() / ref.abs().max()) < 1e-4


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A = torch.zeros(2, 128, 128, device=cuda)
    with pytest.raises(TypeError):
        latrd_panel(A.half(), 0, 0, 128, 8)
    with pytest.raises(ValueError):
        latrd_panel(A.mT, 0, 0, 128, 8)  # not contiguous
    with pytest.raises(ValueError):
        latrd_panel_v4(A[:, :100, :100].contiguous(), 0, 0, 100, 8)  # m % 64


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", [(37, 130), (256, 512), (1280, 5130)], ids=str)
def test_syrk_matches_plain(cuda, dtype, tol, shape):
    """Ragged, aligned and the last-layer main-path shape; the kernel's
    output is exactly symmetric."""
    A = torch.as_tensor(np.random.default_rng(7).standard_normal(shape), dtype=dtype).to(cuda)
    launches = syrk.launches
    got = syrk(A)
    torch.cuda.synchronize()
    assert syrk.launches == launches + 1
    ref = syrk_plain(A)
    torch.testing.assert_close(got, ref, atol=tol * float(ref.abs().max()), rtol=0)
    assert torch.equal(got, got.mT)


def test_syrk_rejects_what_the_kernel_does_not_take(cuda):
    A = torch.zeros(16, 8, device=cuda)
    with pytest.raises(TypeError):
        syrk(A.half())
    with pytest.raises(ValueError):
        syrk(A.mT)  # not contiguous


@pytest.mark.parametrize("subset,hessian,width", [
    ("last_layer", "kron", 8), ("last_layer", "full", 8), ("last_layer", "diag", 8),
    ("all", "full", 1), ("all", "diag", 1)])
def test_laplace_flavor_on_card_matches_cpu(cuda, subset, hessian, width):
    """`Laplace()` flavors in float64 on ResNet-18 (width 8 for the last
    layer, width 1 for all weights): on the card a full GGN runs the float64
    syrk kernel once per batch, on the CPU the einsum."""
    from laplace_jax_torch import Laplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((16, 16, 16, 3)), rng.integers(0, 10, 16)
    net = ResNet18(width=width, generator=torch.Generator().manual_seed(0)).double()
    out = []
    for dev in ("cpu", cuda):
        la = Laplace(net, "classification", subset, hessian, device=dev)
        launches = syrk.launches
        la.fit(ArrayLoader(X, y, batch_size=8))
        out.append((float(la.log_marginal_likelihood()), la(X[:4]).cpu()))
    assert syrk.launches == launches + (2 if hessian == "full" else 0)
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-8)
    torch.testing.assert_close(out[1][1], out[0][1], atol=1e-8, rtol=0)


def test_kron_laplace_on_card_matches_cpu(cuda):
    """A width-8 ResNet-18 fit in float64: its 576 factor class runs the v1
    kernel on the card and LAPACK on the CPU."""
    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((16, 16, 16, 3)), rng.integers(0, 10, 16)
    net = ResNet18(width=8, generator=torch.Generator().manual_seed(0)).double()
    out = []
    for dev in ("cpu", cuda):
        la = KronLaplace(net, "classification", device=dev)
        launches = latrd_panel.launches
        la.fit(ArrayLoader(X, y, batch_size=8))
        out.append((float(la.log_marginal_likelihood()), la(X[:4]).cpu()))
    assert latrd_panel.launches > launches
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-8)
    torch.testing.assert_close(out[1][1], out[0][1], atol=1e-8, rtol=0)
