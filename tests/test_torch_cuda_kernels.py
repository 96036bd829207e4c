"""The CUDA kernels (LATRD panels v1, v2, v3, v4, syrk) against their plain
PyTorch versions, and the pooled spectral D&C, on the card.

These tests need a CUDA device (the kernels have no CPU mode) and skip
without one. Run them on a machine with the card:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q

They import no JAX: the reference is the port's plain versions, which
`tests/test_torch_latrd.py` and `tests/test_torch_syrk.py` hold against the
JAX package on the CPU. Tolerances, relative to each output's largest
entry: float64 1e-10 (only the summation order differs); float32 2e-4 for
the panels (order, and the v4 kernel's atomics, whose order changes from
run to run; v3 sums in one fixed order and repeats bitwise) and 1e-4 for
syrk (order over up to 1280 rows).

The v4 panel is one cooperative launch per panel with a tile schedule from
`ops/latrd_v4.panel_plan`; it is held against its plain version at every
window the ResNet-18 main path gives it (first and last panel, both
dtypes) and on windows with fewer live tiles than the card has SMs.
"""

import numpy as np
import pytest
import torch

from laplace_jax_torch.ops.latrd import latrd_panel, latrd_panel_plain, tridiagonalize_latrd
from laplace_jax_torch.ops.latrd_v2 import (
    latrd_panel_v2,
    latrd_panel_v2_plain,
    tridiagonalize_latrd_v2,
)
from laplace_jax_torch.ops.latrd_v3 import (
    latrd_panel_v3,
    latrd_panel_v3_plain,
    tridiagonalize_latrd_v3,
)
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
          pytest.param(latrd_panel_v4, latrd_panel_v4_plain, id="v4"),
          pytest.param(latrd_panel_v3, latrd_panel_v3_plain, id="v3"),
          pytest.param(latrd_panel_v2, latrd_panel_v2_plain, id="v2")]


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


# (K, m, S): the windows stage 1 visits for ResNet-18's v4 classes, 4608 x3
# and 2304 x4 (`tests/test_torch_latrd_v4_schedule.py` derives them)
V4_WINDOWS = [(3, 4608, 1152), (3, 3456, 1152), (3, 2304, 1152), (3, 1152, 1152),
              (4, 2304, 768), (4, 1536, 768), (4, 768, 768)]


def _card_window(seed, K, m, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    A = torch.randn(K, m, m, generator=gen, device=device, dtype=dtype)
    return (A + A.mT) / 2


def _assert_panel_close(got, ref, tol):
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, atol=tol * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-4)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("K,m,off", [pytest.param(K, m, off, id=f"{K}x{m}-off{off}")
                                     for K, m, S in V4_WINDOWS for off in (0, S - 64)])
def test_v4_panel_at_main_path_windows(cuda, K, m, off, dtype, tol):
    """The persistent v4 panel against its plain version (both on the card)
    at the first and the last panel of every main-path window."""
    A = _card_window(m + off, K, m, dtype, cuda)
    launches = latrd_panel_v4.launches
    got = latrd_panel_v4(A, off, 0, m, 64)
    torch.cuda.synchronize()
    assert latrd_panel_v4.launches == launches + 1
    _assert_panel_close(got, latrd_panel_v4_plain(A, off, 0, m, 64), tol)


def test_v4_panel_without_row_cache(cuda):
    """40 float64 windows of 768: a block's rows of U and W (four row blocks)
    do not fit in shared memory beside the ring, so the kernel reads them
    from UW itself."""
    from laplace_jax_torch.ops.latrd_v4 import panel_plan

    n_cta = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert panel_plan(40, 768, 0, 64, 8, n_cta)[1] == 0
    A = _card_window(11, 40, 768, torch.float64, cuda)
    for off in (0, 704):
        got = latrd_panel_v4(A, off, 0, 768, 64)
        torch.cuda.synchronize()
        _assert_panel_close(got, latrd_panel_v4_plain(A, off, 0, 768, 64), 1e-10)


@pytest.mark.parametrize("K,m,off,n_valid", [(1, 256, 192, 256), (4, 768, 704, 768),
                                             (2, 640, 576, 600), (1, 128, 0, 100)])
def test_v4_panel_with_fewer_tiles_than_blocks(cuda, K, m, off, n_valid):
    """Trailing blocks of 1 to 30 live tiles for the card's 100+ blocks:
    blocks without tiles still meet every grid barrier; padded rows too."""
    for dtype, tol in ((torch.float64, 1e-10), (torch.float32, 2e-4)):
        A = _window(9, K, m, n_valid, dtype)
        got = latrd_panel_v4(A.to(cuda), off, 0, n_valid, 64)
        torch.cuda.synchronize()
        ref = latrd_panel_v4_plain(A, off, 0, n_valid, 64)
        _assert_panel_close([g.cpu() for g in got], ref, tol)


@pytest.mark.parametrize("driver", [tridiagonalize_latrd, tridiagonalize_latrd_v4,
                                    tridiagonalize_latrd_v3, tridiagonalize_latrd_v2])
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


@pytest.mark.parametrize("n,kernel,stage1", [(520, latrd_panel, "auto"),
                                             (2304, latrd_panel_v4, "auto"),
                                             (1152, latrd_panel_v3, "latrd_v3"),
                                             (1152, latrd_panel_v2, "latrd_v2")])
def test_eigh_stack_ts_dispatches_to_kernel(cuda, n, kernel, stage1):
    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    gen = torch.Generator(device=cuda).manual_seed(n)
    A = torch.randn(2, n, n, generator=gen, device=cuda)
    A = (A + A.mT) / 2
    launches = kernel.launches
    lam, Q = eigh_stack_ts(A, stage1=stage1)
    assert kernel.launches > launches
    ref = torch.linalg.eigvalsh(A.double())
    # float32 stage 2 reads ~5e-6 here, and rarely several times that
    assert float((lam.double() - ref).abs().max() / ref.abs().max()) < 1e-4


def test_v3_repeats_bitwise(cuda):
    """Two v3 launches on one float32 window give the same bits: its
    matvec sums every tile pair in one fixed order, with no atomics."""
    A = _window(6, 3, 1152, 1150, torch.float32).to(cuda)
    first = latrd_panel_v3(A, 0, 0, 1150, 64)
    second = latrd_panel_v3(A, 0, 0, 1150, 64)
    torch.cuda.synchronize()
    for g, r in zip(first, second):
        assert torch.equal(g, r)


@pytest.mark.parametrize("lib_name", ["latrd", "latrd_v4", "latrd_v3", "latrd_v2"])
def test_panel_writes_stay_inside_the_scratch_it_declares(cuda, lib_name):
    """Each panel library sizes its own `part` and `work` scratch
    (`part_elems`, `work_elems`; v4's work holds its grid barrier's counter
    and each block's share of y.v): a guard placed past each keeps its
    bits through a whole panel, and v4's schedule table is left as it was."""
    from laplace_jax_torch.ops import _build
    from laplace_jax_torch.ops.latrd import panel_buffers
    from laplace_jax_torch.ops.latrd_v4 import _plans, _schedule_args

    K, m, nb, guard, mark = 3, 384, 64, 4096, 1234.5
    A = _window(7, K, m, m - 5, torch.float32).to(cuda)
    lib = _build.load(lib_name)
    buf = panel_buffers(lib, K, m, nb, A.dtype, cuda)
    sizes = {key: buf[key].numel() for key in ("part", "work")}
    for key, n in sizes.items():
        buf[key] = torch.full((n + guard,), mark, device=cuda)
    extra = _schedule_args(A, 0, nb) if lib_name == "latrd_v4" else ()
    table = _plans[(K, m, 0, nb, A.dtype, A.device)][0].clone() if extra else None
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.panel_f32(A.data_ptr(), *(b.data_ptr() for b in buf.values()),
                         K, m, nb, 0, 0, m - 5, *extra, stream) == 0
    torch.cuda.synchronize()
    for key, n in sizes.items():
        assert bool((buf[key][n:] == mark).all()), f"{lib_name} wrote past {key}"
    if extra:
        assert torch.equal(_plans[(K, m, 0, nb, A.dtype, A.device)][0], table)


def test_eigh_stack_dc_on_card_matches_eigvalsh(cuda):
    from laplace_jax_torch.ops.eigh_dc import eigh_stack_dc

    rng = np.random.default_rng(8)
    Q = np.linalg.qr(rng.standard_normal((2, 600, 600)))[0]
    lam = np.exp(-np.linspace(0.0, 8.0, 600))[None] * (1 + rng.random((2, 600)))
    A = torch.as_tensor(np.einsum("kij,kj,klj->kil", Q, lam, Q)).to(cuda)
    A = (A + A.mT) / 2
    vals, vecs = eigh_stack_dc(A)
    torch.testing.assert_close(vals, torch.linalg.eigvalsh(A), atol=1e-10, rtol=0)
    torch.testing.assert_close(vecs @ torch.diag_embed(vals) @ vecs.mT, A, atol=1e-10, rtol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    A = torch.zeros(2, 128, 128, device=cuda)
    with pytest.raises(TypeError):
        latrd_panel(A.half(), 0, 0, 128, 8)
    with pytest.raises(ValueError):
        latrd_panel(A.mT, 0, 0, 128, 8)  # not contiguous
    with pytest.raises(ValueError):
        latrd_panel_v4(A[:, :100, :100].contiguous(), 0, 0, 100, 8)  # m % 64
    with pytest.raises(ValueError):
        latrd_panel_v2(A, 4, 0, 128, 8)  # off % 8


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
