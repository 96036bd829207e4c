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
syrk (order over up to 1280 rows). syrk is held at every P mod 4 (its
copy width), at an unaligned address, bitwise over two launches, and its
launch geometry against `ops/syrk.syrk_plan`.

The v4 panel is one cooperative launch per panel with a tile schedule from
`ops/latrd_v4.panel_plan`; it is held against its plain version at every
window the ResNet-18 main path gives it (first and last panel, both
dtypes) and on windows with fewer live tiles than the card has SMs. The v1
panel is one cooperative launch per panel too (`ops/latrd.panel_plan`),
held against its plain version at every main-path window, first and last
panel, both dtypes, on windows whose rows it streams, and bitwise against
itself (no atomics, like v3).
"""

import ctypes

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
from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.syrk import syrk, syrk_plain, syrk_plan
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


def _assert_panel_vs_plain(got, plain, A, off, q_base, n_real, tol):
    """A persistent panel (v1, v3) against its plain version on the same
    window. Float64: within `tol` of the plain panel. Float32: against the
    plain panel computed in float64 on the same float32 input, within `tol`
    or within twice the plain float32 panel's own error there, whichever is
    larger. At a window's tail panel, where the trailing block shrinks to
    nothing inside the panel, float32 itself is further than 2e-4 off
    float64, and two float32 summation orders differ by as much (the
    four-launch kernel v1's replaced missed 2e-4 against the plain float32
    panel there too)."""
    ref = plain(A, off, q_base, n_real, 64)
    if A.dtype == torch.float64:
        _assert_panel_close(got, ref, tol)
        return
    exact = plain(A.double(), off, q_base, n_real, 64)
    for g, r, x in zip(got, ref, exact):
        scale = float(x.abs().max())
        err_kernel = float((g.double() - x).abs().max()) / scale
        err_plain = float((r.double() - x).abs().max()) / scale
        assert err_kernel <= max(tol, 2 * err_plain), (err_kernel, err_plain)


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


def _v1_windows():
    """(K, m, offs): every window stage 1 gives the v1 kernel for ResNet-18's
    classes 512 (K=6), 576 (K=5), 1152 (K=4) and KronLL's 512 (K=1), with
    its first and last panel (`tests/test_torch_latrd_v1_plan.py` derives
    the same panels)."""
    out = {}
    for K, n in ((6, 512), (5, 576), (4, 1152), (1, 512)):
        S = max(128, -(-(-(-n // 4)) // 128) * 128)
        n_pad, n_cols = -(-n // S) * S, n - 2
        for q in range(0, n_cols, S):
            last = (-(-min(S, n_cols - q) // 64) - 1) * 64
            out[(K, n_pad - q)] = sorted({0, last})
    return [(K, m, off) for (K, m), offs in sorted(out.items()) for off in offs]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-4)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("K,m,off", [pytest.param(K, m, off, id=f"{K}x{m}-off{off}")
                                     for K, m, off in _v1_windows()])
def test_v1_panel_at_main_path_windows(cuda, K, m, off, dtype, tol):
    """The persistent v1 panel against its plain version (both on the card)
    at the first and the last panel of every main-path window; (4, 1152)
    and (5, 768) at offset 0 stream their rows in float64."""
    A = _card_window(m + off + 1, K, m, dtype, cuda)
    launches = latrd_panel.launches
    got = latrd_panel(A, off, 0, m, 64)
    torch.cuda.synchronize()
    assert latrd_panel.launches == launches + 1
    _assert_panel_vs_plain(got, latrd_panel_plain, A, off, 0, m, tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-4)],
                         ids=["float64", "float32"])
def test_v1_panel_streaming_its_rows(cuda, dtype, tol):
    """40 windows of 768, 3 blocks a window of 256 rows each. In float32 a
    block keeps only its rows of U and W in shared memory, in float64
    nothing; padded rows too."""
    from laplace_jax_torch.ops.latrd import panel_plan

    n_cta = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = panel_plan(40, 768, 0, 64, torch.tensor([], dtype=dtype).element_size(), n_cta)
    assert not plan.cache_window and plan.cache_rows == (dtype == torch.float32)
    A = _window(12, 40, 768, 760, dtype).to(cuda)
    for off in (0, 704):
        got = latrd_panel(A, off, 3, 763, 64)
        torch.cuda.synchronize()
        _assert_panel_vs_plain(got, latrd_panel_plain, A, off, 3, 763, tol)


def test_v1_repeats_bitwise(cuda):
    """Two v1 launches on one float32 window give the same bits: every sum
    has one order (no atomics)."""
    A = _window(6, 4, 1152, 1150, torch.float32).to(cuda)
    first = latrd_panel(A, 0, 0, 1150, 64)
    second = latrd_panel(A, 0, 0, 1150, 64)
    torch.cuda.synchronize()
    for g, r in zip(first, second):
        assert torch.equal(g, r)


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


# (K, m, off, n_valid): the kernel row's window (3, 4608) at its first panel
# and at the last panel of its first class, the v1 row's (4, 1152) with two
# padded rows, one window, the smallest window, and a padded window whose
# trailing block has fewer tiles than the card has blocks
V3_CASES = [(3, 4608, 0, 4608), (3, 4608, 1088, 4608), (4, 1152, 0, 1150), (1, 1152, 64, 1152),
            (2, 128, 0, 128), (2, 640, 512, 600)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-4)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("K,m,off,n_valid", [pytest.param(*c, id="{}x{}-off{}-nv{}".format(*c))
                                             for c in V3_CASES])
def test_v3_panel_matches_plain_and_repeats_bitwise(cuda, K, m, off, n_valid, dtype, tol):
    """The persistent v3 panel against its plain version, and two launches
    on one window bit for bit: every sum has one order (no atomics)."""
    A = _card_window(12, K, m, dtype, cuda)
    A[:, n_valid:, :] = 0
    A[:, :, n_valid:] = 0
    launches = latrd_panel_v3.launches
    first = latrd_panel_v3(A, off, 0, n_valid, 64)
    second = latrd_panel_v3(A, off, 0, n_valid, 64)
    torch.cuda.synchronize()
    assert latrd_panel_v3.launches == launches + 2
    for g, r in zip(first, second):
        assert torch.equal(g, r)
    _assert_panel_vs_plain(first, latrd_panel_v3_plain, A, off, 0, n_valid, tol)


def test_v3_plan_matches_the_library(cuda):
    """The first launch of each window checks ops/latrd_v3.panel_plan's
    shared memory and ring against the library's own reckoning; the
    kernel's static shared memory (from `-Xptxas -v`) is within the plan's
    allowance for it."""
    import re

    from laplace_jax_torch.ops.latrd_v3 import STATIC_BYTES, _plans, _schedule_args

    for K, m, off, dtype in ((3, 4608, 0, torch.float32), (3, 4608, 0, torch.float64),
                             (40, 768, 0, torch.float64), (6, 512, 448, torch.float32)):
        A = torch.zeros(K, m, m, device=cuda, dtype=dtype)
        _schedule_args(A, off, 64)
        assert (K, m, off, 64, dtype, A.device) in _plans
    static = [int(n) for n in re.findall(r"(\d+) bytes smem", _build.build_log("latrd_v3"))]
    assert static and max(static) <= STATIC_BYTES


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
    (`part_elems`, `work_elems`; v4's, v3's and v1's work holds the grid
    barrier's counter and each block's partial sums, v3's also its slots):
    a guard placed past each keeps its bits through a whole panel, and v4's
    and v3's schedule tables are left as they were."""
    from laplace_jax_torch.ops import _build
    from laplace_jax_torch.ops.latrd import _plan_args, panel_buffers
    from laplace_jax_torch.ops import latrd_v3, latrd_v4

    K, m, nb, guard, mark = 3, 384, 64, 4096, 1234.5
    A = _window(7, K, m, m - 5, torch.float32).to(cuda)
    lib = _build.load(lib_name)
    buf = panel_buffers(lib, K, m, nb, A.dtype, cuda)
    sizes = {key: buf[key].numel() for key in ("part", "work")}
    for key, n in sizes.items():
        buf[key] = torch.full((n + guard,), mark, device=cuda)
    tiled = {"latrd_v4": latrd_v4, "latrd_v3": latrd_v3}.get(lib_name)
    extra = tiled._schedule_args(A, 0, nb) if tiled else (
        _plan_args(A, 0, nb) if lib_name == "latrd" else ())
    plan_key = (K, m, 0, nb, A.dtype, A.device)
    table = tiled._plans[plan_key][0].clone() if tiled else None
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert lib.panel_f32(A.data_ptr(), *(b.data_ptr() for b in buf.values()),
                         K, m, nb, 0, 0, m - 5, *extra, stream) == 0
    torch.cuda.synchronize()
    for key, n in sizes.items():
        assert bool((buf[key][n:] == mark).all()), f"{lib_name} wrote past {key}"
    if tiled:
        assert torch.equal(tiled._plans[plan_key][0], table)


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


# P mod 4 = 0, 1, 2, 3 around the last-layer shape (1280, 5130) and below
# one tile; a row of P float32 is 16-, 4-, 8- and 4-byte aligned, which
# picks the kernel's copy width; R = 0 gives zeros
SYRK_SHAPES = [(1280, 5128), (1280, 5129), (1280, 5130), (1279, 5131), (256, 512),
               (37, 130), (17, 125), (5, 64), (3, 7), (0, 64), (1, 1)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
@pytest.mark.parametrize("shape", SYRK_SHAPES, ids=str)
def test_syrk_matches_plain(cuda, dtype, tol, shape):
    """Every copy width, ragged and aligned shapes and the last-layer
    main-path shape: the kernel's output is exactly symmetric and the same
    bit for bit on a second launch."""
    A = torch.as_tensor(np.random.default_rng(7).standard_normal(shape), dtype=dtype).to(cuda)
    launches = syrk.launches
    got = syrk(A)
    torch.cuda.synchronize()
    assert syrk.launches == launches + 1
    ref = syrk_plain(A)
    torch.testing.assert_close(got, ref, atol=tol * float(ref.abs().max()), rtol=0)
    assert torch.equal(got, got.mT)
    assert torch.equal(syrk(A), got)


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 1e-4)])
def test_syrk_at_an_unaligned_address(cuda, dtype, tol):
    """A view one element into its storage: the kernel falls to copies of
    one element (float32) or 8 bytes (float64) and is still right."""
    R, P = 300, 260
    buf = torch.as_tensor(np.random.default_rng(8).standard_normal(R * P + 1), dtype=dtype).to(cuda)
    A = buf[1:].view(R, P)
    assert A.is_contiguous() and A.data_ptr() % 16 != 0
    got, ref = syrk(A), syrk_plain(A)
    torch.testing.assert_close(got, ref, atol=tol * float(ref.abs().max()), rtol=0)
    assert torch.equal(got, got.mT)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("P", [5128, 5129, 5130, 5131])
def test_syrk_plan_matches_the_library(cuda, dtype, P):
    """`syrk_plan` is the geometry the library launches with."""
    plan = syrk_plan(1280, P, dtype)
    out = (ctypes.c_int * 7)()
    assert _build.load("syrk").syrk_geometry(4 if dtype == torch.float32 else 8, P, out) == 0
    assert list(out) == [plan.tile, plan.threads, plan.chunk, plan.stages, plan.copy_bytes,
                         plan.smem_bytes, len(plan.tiles)]


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
