"""The CUDA kernels (LATRD panels v1, v2, v3, v4, syrk, the Jacobi leaves,
the secular solve) against their plain PyTorch versions, on the card.

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

Stage 2's Jacobi leaves (`csrc/jacobi_leaves.cu`, one launch a call) are
held against their plain version in both dtypes at m from 2 to 48 and up
to 384 leaves, on diagonal and tied inputs, on the leaves of
`tests/data/stage2_float32_tridiagonal.npz` and with a NaN: eigenvalues,
‖A V − V Λ‖ / ‖A‖ and ‖VᵀV − I‖ each within 4 times the plain version's
own level over the leaves (plus 16 ulps).

Stage 2's secular solve (`csrc/secular.cu`, one launch a merge level) is
held against its plain version at the main path's merge shapes, on merges
with every kind of deflation, from float32 and float64 merges: an active
root within 1e-12 of its gap, its origin the plain version's except where
f at mid-gap is within rounding of 0. Stage 2 with it runs against
eigvalsh, on the float32 tridiagonal and with a NaN. Stage 2's float32
polish (one Newton-Schulz step on a float64 Gram) is held to the
Householder-QR polish it replaced, at the reward cell's widths: no factor's
orthogonality or residual worse.

The v4 panel is one cooperative launch per panel with a tile schedule from
`ops/latrd_v4.panel_plan`; it is held against its plain version at every
window the ResNet-18 main path gives it (first and last panel, both
dtypes) and on windows with fewer live tiles than the card has SMs. The v1
panel is one cooperative launch per panel too (`ops/latrd.panel_plan`),
held against its plain version at every main-path window, first and last
panel, both dtypes, on windows whose rows it streams, and bitwise against
itself (no atomics, like v3). The v2 panel is v1's kernel with its row
corrections grouped by 8 columns (`ops/latrd_v2.panel_plan`): held against
its plain version and bitwise against itself at the (4, 1152) window, which
fits on the chip in float32, at the (3, 4608) window, whose rows mostly
stream through its ring, at off > 0, at K = 1, at m = 128 and with padded
rows, in both dtypes, and on windows whose blocks keep no rows of U and W.
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


# (K, m, off, n_valid): the v2 row's window (4, 1152), resident in float32,
# streaming in float64; the 4608 class's first window at its first panel and
# at the last panel of its class, both streaming; one window at off > 0; the
# smallest window; padded windows, one whose group of 8 rows c8 .. c8+7
# spans blocks and the padding
V2_CASES = [(4, 1152, 0, 1152), (3, 4608, 0, 4608), (3, 4608, 1088, 4608), (1, 1152, 64, 1152),
            (2, 128, 0, 128), (4, 1152, 0, 1150), (2, 640, 512, 600)]


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-10), (torch.float32, 2e-4)],
                         ids=["float64", "float32"])
@pytest.mark.parametrize("K,m,off,n_valid", [pytest.param(*c, id="{}x{}-off{}-nv{}".format(*c))
                                             for c in V2_CASES])
def test_v2_panel_matches_plain_and_repeats_bitwise(cuda, K, m, off, n_valid, dtype, tol):
    """The persistent v2 panel against its plain version, and two launches
    on one window bit for bit: every sum has one order (no atomics)."""
    A = _card_window(13, K, m, dtype, cuda)
    A[:, n_valid:, :] = 0
    A[:, :, n_valid:] = 0
    launches = latrd_panel_v2.launches
    first = latrd_panel_v2(A, off, 0, n_valid, 64)
    second = latrd_panel_v2(A, off, 0, n_valid, 64)
    torch.cuda.synchronize()
    assert latrd_panel_v2.launches == launches + 2
    for g, r in zip(first, second):
        assert torch.equal(g, r)
    _assert_panel_vs_plain(first, latrd_panel_v2_plain, A, off, 0, n_valid, tol)


def test_v2_streams_where_its_rows_of_u_and_w_do_not_fit(cuda):
    """Windows of 768 whose blocks keep no rows of U and W: 40 in float64
    (3 blocks a window of 256 rows, 26 of them resident) and 150 in float32
    (more windows than blocks: a block's 873 rows span windows, 45
    resident); padded rows, first and last panel."""
    from laplace_jax_torch.ops.latrd_v2 import panel_plan

    n_cta = torch.cuda.get_device_properties(cuda).multi_processor_count
    for K, dtype, tol in ((40, torch.float64, 1e-10), (150, torch.float32, 2e-4)):
        plan = panel_plan(K, 768, 0, 64, torch.tensor([], dtype=dtype).element_size(), n_cta)
        assert plan.n_res < plan.rows and not plan.cache_rows
        A = _window(14, K, 768, 760, dtype).to(cuda)
        for off in (0, 704):
            first = latrd_panel_v2(A, off, 3, 763, 64)
            second = latrd_panel_v2(A, off, 3, 763, 64)
            torch.cuda.synchronize()
            for g, r in zip(first, second):
                assert torch.equal(g, r)
            _assert_panel_vs_plain(first, latrd_panel_v2_plain, A, off, 3, 763, tol)


def test_v2_plan_matches_the_library(cuda):
    """The first launch of each window checks ops/latrd_v2.panel_plan's
    shared memory against the library's own reckoning."""
    from laplace_jax_torch.ops.latrd_v2 import _plan_args, _plans

    for K, m, off, dtype in ((3, 4608, 0, torch.float32), (3, 4608, 0, torch.float64),
                             (4, 1152, 0, torch.float32), (4, 2560, 640, torch.float64),
                             (40, 768, 0, torch.float64), (6, 128, 64, torch.float32)):
        A = torch.zeros(K, m, m, device=cuda, dtype=dtype)
        _plan_args(A, off, 64)
        assert (K, m, off, 64, dtype, A.device) in _plans


@pytest.mark.parametrize("lib_name", ["latrd", "latrd_v4", "latrd_v3", "latrd_v2"])
def test_panel_writes_stay_inside_the_scratch_it_declares(cuda, lib_name):
    """Each panel library sizes its own `part` and `work` scratch
    (`part_elems`, `work_elems`; v4's, v3's, v1's and v2's work holds the
    grid barrier's counter and each block's partial sums, v3's also its slots):
    a guard placed past each keeps its bits through a whole panel, and v4's
    and v3's schedule tables are left as they were."""
    from laplace_jax_torch.ops import _build, latrd, latrd_v2, latrd_v3, latrd_v4
    from laplace_jax_torch.ops.latrd import panel_buffers

    K, m, nb, guard, mark = 3, 384, 64, 4096, 1234.5
    A = _window(7, K, m, m - 5, torch.float32).to(cuda)
    lib = _build.load(lib_name)
    buf = panel_buffers(lib, K, m, nb, A.dtype, cuda)
    sizes = {key: buf[key].numel() for key in ("part", "work")}
    for key, n in sizes.items():
        buf[key] = torch.full((n + guard,), mark, device=cuda)
    tiled = {"latrd_v4": latrd_v4, "latrd_v3": latrd_v3}.get(lib_name)
    extra = tiled._schedule_args(A, 0, nb) if tiled else (
        {"latrd": latrd, "latrd_v2": latrd_v2}[lib_name]._plan_args(A, 0, nb))
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
# picks the kernel's copy width; R = 0 gives zeros; (640, 128) is the
# subnetwork GGN of `bench.py` config 3b (one tile in float32)
SYRK_SHAPES = [(1280, 5128), (1280, 5129), (1280, 5130), (1279, 5131), (256, 512),
               (640, 128), (37, 130), (17, 125), (5, 64), (3, 7), (0, 64), (1, 1)]


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


@pytest.mark.parametrize("hessian", ["full", "diag"])
def test_subnet_laplace_on_card_matches_cpu(cuda, hessian):
    """A subnetwork of 40 weights of a width-4 ResNet-18 in float64: on the
    card its dense GGN runs the float64 syrk kernel once per batch."""
    from laplace_jax_torch import Laplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((16, 16, 16, 3)), rng.integers(0, 10, 16)
    net = ResNet18(width=4, generator=torch.Generator().manual_seed(0)).double()
    idx = np.sort(rng.choice(sum(p.numel() for p in net.parameters()), 40, replace=False))
    out = []
    for dev in ("cpu", cuda):
        la = Laplace(net, "classification", "subnetwork", hessian, subnetwork_indices=idx,
                     device=dev)
        launches = syrk.launches
        la.fit(ArrayLoader(X, y, batch_size=8))
        out.append((la.H.cpu(), float(la.log_marginal_likelihood()), la(X[:4]).cpu()))
    assert syrk.launches == launches + (2 if hessian == "full" else 0)
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-10 * float(out[0][0].abs().max()),
                               rtol=0)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-9)
    torch.testing.assert_close(out[1][2], out[0][2], atol=1e-9, rtol=0)


@pytest.mark.parametrize("streaming", [False, True])
def test_functional_laplace_on_card_matches_cpu(cuda, streaming):
    """`FunctionalLaplace` on a 12x12 LeNet in float64, cached and streamed:
    the card against the CPU; it launches no kernel of the port."""
    from laplace_jax_torch import FunctionalLaplace
    from laplace_jax_torch.models.lenet import LeNet
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((32, 12, 12, 1)), rng.integers(0, 10, 32)
    net = LeNet(10, 1, 12, generator=torch.Generator().manual_seed(0)).double()
    out = []
    for dev in ("cpu", cuda):
        la = FunctionalLaplace(net, "classification", n_subset=12, streaming=streaming,
                               device=dev)
        launches = syrk.launches
        la.fit(ArrayLoader(X, y, batch_size=8))
        out.append((la.K_MM.cpu(), float(la.log_marginal_likelihood()), la(X[:4]).cpu()))
        assert syrk.launches == launches
    torch.testing.assert_close(out[1][0], out[0][0], atol=1e-10 * float(out[0][0].abs().max()),
                               rtol=0)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-9)
    torch.testing.assert_close(out[1][2], out[0][2], atol=1e-9, rtol=0)


@pytest.mark.parametrize("model", ["resnet18_w4", "wrn_batch"])
@pytest.mark.parametrize("backend", ["ggn", "ef"])
def test_tap_diagonal_on_card_matches_jacobian_path(cuda, model, backend):
    """The all-weights tap diagonal (GGN and EF) in float64 on the card
    against the Jacobian (or per-sample gradient) path on the card, and
    against the tap diagonal on the CPU; the WideResNet's BatchNorm leaves
    take the norm branch."""
    from laplace_jax_torch.curvature.backend import CurvatureBackend
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.models.wideresnet import WideResNet16x4
    from laplace_jax_torch.nnmodel import NNModel

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((6, 16, 16, 3)), rng.integers(0, 10, 6)
    gen = torch.Generator().manual_seed(0)
    net = (ResNet18(width=4, generator=gen) if model == "resnet18_w4"
           else WideResNet16x4(10, 1, "batch", generator=gen)).double()
    out = []
    for dev in ("cpu", cuda):
        be = CurvatureBackend(NNModel(net.to(dev)), "classification", backend)
        Xd, yd = torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)
        _, d = be.diag(Xd, yd)
        out.append(d.cpu())
    if backend == "ef":
        G, _ = be.gradients(Xd, yd)
        ref = (G * G).sum(0)
    else:
        Js, f = be.jacobians(Xd)
        ref = torch.einsum("bcp,bck,bkp->p", Js, be._functional_hessian(f), Js)
    scale = float(ref.abs().max())
    torch.testing.assert_close(out[1], ref.cpu(), atol=1e-10 * scale, rtol=0)
    torch.testing.assert_close(out[1], out[0], atol=1e-10 * scale, rtol=0)


@pytest.mark.parametrize("backend", ["ef", "mc"])
def test_ef_and_mc_kron_on_card_run_v1_and_v4(cuda, backend):
    """EF and MC `KronLaplace` fits of a width-32 ResNet-18 in float32:
    their factor classes 576 and 1152 run the v1 kernel and 2304 the v4
    kernel; eigenvalues against float64 `eigvalsh` within 1e-4 of the
    largest, a finite marglik and probit rows summing to 1. The EF fit
    matches the same fit in float64 on the CPU (1e-3, float32's limit)."""
    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((32, 8, 8, 3)).astype(np.float32), rng.integers(0, 10, 32)
    net = ResNet18(width=32, generator=torch.Generator().manual_seed(0))
    la = KronLaplace(net, "classification", backend=backend, device=cuda)
    v1, v4 = latrd_panel.launches, latrd_panel_v4.launches
    la.fit(ArrayLoader(X, y, batch_size=16))
    assert latrd_panel.launches > v1 and latrd_panel_v4.launches > v4
    for F, ls in zip(la.H_facs.kfacs, la.H.eigenvalues):
        for H, lam in zip(F, ls):
            if H.shape[0] >= 512:
                ref = torch.linalg.eigvalsh(H.double()).clamp(min=0)
                assert float((lam.double() - ref).abs().max() / ref.abs().max()) <= 1e-4
    lml = float(la.log_marginal_likelihood())
    probs = la(X[:4])
    assert np.isfinite(lml) and bool(torch.isfinite(probs).all())
    torch.testing.assert_close(probs.sum(-1).cpu(), torch.ones(4), atol=1e-5, rtol=0)
    if backend == "ef":
        ref = KronLaplace(net.double().cpu(), "classification", backend="ef", device="cpu")
        ref.fit(ArrayLoader(X.astype(np.float64), y, batch_size=16))
        np.testing.assert_allclose(lml, float(ref.log_marginal_likelihood()), rtol=1e-3)


def _count_window(n, n_used, tokens, dtype, device):
    """diag(token counts) / tokens (1, n, n): `tokens` ids drawn uniformly
    from the first `n_used` of n, so the counts tie in the dozens and the
    last n - n_used are zero (the Embed's KFAC activation factor)."""
    ids = np.random.default_rng(n).integers(0, n_used, size=tokens)
    counts = np.bincount(ids, minlength=n) / tokens
    return torch.diag(torch.as_tensor(counts, dtype=dtype, device=device))[None]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["float64", "float32"])
@pytest.mark.parametrize("kernel,plain,driver,stage1,n", [
    pytest.param(latrd_panel, latrd_panel_plain, tridiagonalize_latrd, "latrd", 1024, id="v1"),
    pytest.param(latrd_panel_v4, latrd_panel_v4_plain, tridiagonalize_latrd_v4, "latrd_v4",
                 4096, id="v4")])
def test_panels_on_an_exactly_diagonal_window(cuda, kernel, plain, driver, stage1, n, dtype):
    """An exactly diagonal window with tied and zero entries: the first
    panel equals its plain version exactly (every reflector is trivial, so
    nothing is summed), the whole stage 1 has tau = 0 and e = 0 and keeps
    the diagonal, and the two-stage solver's eigenvalues are the sorted
    diagonal exactly and eigvalsh's within 1e-12, with Q Λ Qᵀ the matrix
    and Qᵀ Q the identity (1e-12 in float64; 1e-6 in float32, where Q is
    re-orthonormalized)."""
    from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts

    A = _count_window(n, n - n // 16, 16 * n, dtype, cuda)
    launches = kernel.launches
    got = kernel(A, 0, 0, n, 64)
    torch.cuda.synchronize()
    assert kernel.launches == launches + 1
    for g, r in zip(got, plain(A, 0, 0, n, 64)):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g, r, atol=0, rtol=0)
    d, e, V, taus = driver(A)
    assert float(taus.abs().max()) == 0 and float(e.abs().max()) == 0
    torch.testing.assert_close(d, torch.diagonal(A, dim1=1, dim2=2), atol=0, rtol=0)
    lam, Q = eigh_stack_ts(A, stage1=stage1, device=cuda)
    torch.testing.assert_close(lam, torch.sort(torch.diagonal(A, dim1=1, dim2=2)).values,
                               atol=0, rtol=0)
    Q64, A64 = Q.double(), A.double()
    scale = float(A64.abs().max())
    torch.testing.assert_close(lam.double(), torch.linalg.eigvalsh(A64), atol=1e-12 * scale,
                               rtol=0)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    assert float(((Q64 * lam.double()[:, None, :]) @ Q64.mT - A64).abs().max()) <= tol * scale
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    assert float((Q64.mT @ Q64 - eye).abs().max()) <= tol


def test_reward_transformer_on_card_matches_cpu(cuda, monkeypatch):
    """The narrow reward transformer (1 block, d 16, vocab 64) in float64,
    all weights: the Kron factors under "block", the tap diagonal, and
    `eig_lowrank` (Hessian and GGN) from one start vector, the card
    against the CPU within 1e-10 relative (eigenvectors sign-aligned)."""
    from laplace_jax_torch import DiagLaplace, KronLaplace
    from laplace_jax_torch.curvature import lanczos
    from laplace_jax_torch.curvature.backend import CurvatureBackend
    from laplace_jax_torch.nnmodel import NNModel
    from laplace_jax_torch.utils.data import ArrayLoader

    from .torch_reward_twin import RewardTransformer

    rng = np.random.default_rng(0)
    ids, y = rng.integers(0, 64, size=(16, 8)), rng.integers(0, 2, 16)
    loader = ArrayLoader(ids, y, batch_size=8)
    net = RewardTransformer(64, 16, 2, 32, 1, generator=torch.Generator().manual_seed(0)).double()
    v0 = torch.randn(sum(p.numel() for p in net.parameters()), dtype=torch.float64,
                     generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(lanczos, "start_vector",
                        lambda P, dtype, device, gen: (v0 / v0.norm()).to(device))
    out = []
    for dev in ("cpu", cuda):
        kron = KronLaplace(net, "reward_modeling", backend_kwargs={"kron_unsupported": "block"},
                           device=dev)
        kron.fit(loader)
        diag = DiagLaplace(net, "reward_modeling", device=dev)
        diag.fit(loader)
        row = [(H.cpu(), False) for F in kron.H_facs.kfacs for H in F] + [(diag.H.cpu(), False)]
        for curv in ("hessian", "ggn"):
            U, lam, loss = CurvatureBackend(NNModel(net), "classification", curv).eig_lowrank(
                loader, low_rank=5)
            row += [(U.cpu(), True), (lam.cpu(), False), (loss.cpu(), False)]
        out.append(row)
        net = net.cpu()
    for (a, ritz), (b, _) in zip(*out):
        if ritz:  # eigenvectors: up to sign
            b = b * torch.sign((a * b).sum(0))
        torch.testing.assert_close(b, a, atol=1e-10 * float(a.abs().max()), rtol=0)


def test_conv_variant_kron_on_card_matches_cpu(cuda):
    """The 2-D conv-variant net of `models/conv_variants.py` (masked,
    input-dilated, circular, grouped and masked depthwise flax `Conv`
    twins) at half width on 16x16 inputs, float64, under `kron_unsupported="raise"` (every leaf
    tapped): its 576 and 1152 factor classes run the v1 kernel on the card
    and LAPACK on the CPU; the factors within 1e-10 of their largest entry,
    the marglik within 1e-8 relative, the probit 1e-8 absolute."""
    from laplace_jax_torch import KronLaplace
    from laplace_jax_torch.models.conv_variants import conv_variant_nets
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((16, 16, 16, 3)), rng.integers(0, 10, 16)
    net = conv_variant_nets(0, torch.float64, 2)["conv2d"]
    out = []
    for dev in ("cpu", cuda):
        la = KronLaplace(net, "classification", backend_kwargs={"kron_unsupported": "raise"},
                         device=dev)
        launches = latrd_panel.launches
        la.fit(ArrayLoader(X, y, batch_size=8))
        out.append(([H.cpu() for F in la.H_facs.kfacs for H in F],
                    float(la.log_marginal_likelihood()), la(X[:4]).cpu()))
    assert latrd_panel.launches > launches
    for a, b in zip(out[1][0], out[0][0]):
        torch.testing.assert_close(a, b, atol=1e-10 * float(b.abs().max()), rtol=0)
    np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-8)
    torch.testing.assert_close(out[1][2], out[0][2], atol=1e-8, rtol=0)


@pytest.mark.parametrize("backend", ["ggn", "ef"])
def test_grouped_and_masked_tap_diagonal_on_card_matches_cpu(cuda, backend):
    """The tap diagonal of the 2-D conv-variant net of
    `models/conv_variants.py` at an eighth of its width (grouped and
    depthwise kernels, mask² on the masked convs) in float64 on the card,
    against the card's Jacobian (or per-sample gradient) path and the tap
    diagonal on the CPU, within 1e-10 of the largest entry."""
    from laplace_jax_torch.models.conv_variants import conv_variant_nets
    from laplace_jax_torch.curvature.backend import CurvatureBackend
    from laplace_jax_torch.nnmodel import NNModel

    rng = np.random.default_rng(1)
    X, y = rng.standard_normal((6, 16, 16, 3)), rng.integers(0, 10, 6)
    net = conv_variant_nets(1, torch.float64, 8)["conv2d"]
    out = []
    for dev in ("cpu", cuda):
        be = CurvatureBackend(NNModel(net.to(dev)), "classification", backend)
        Xd, yd = torch.as_tensor(X, device=dev), torch.as_tensor(y, device=dev)
        _, d = be.diag(Xd, yd)
        out.append(d.cpu())
    if backend == "ef":
        G, _ = be.gradients(Xd, yd)
        ref = (G * G).sum(0)
    else:
        Js, f = be.jacobians(Xd)
        ref = torch.einsum("bcp,bck,bkp->p", Js, be._functional_hessian(f), Js)
    scale = float(ref.abs().max())
    torch.testing.assert_close(out[1], ref.cpu(), atol=1e-10 * scale, rtol=0)
    torch.testing.assert_close(out[1], out[0], atol=1e-10 * scale, rtol=0)


def test_parallel_fit_launches_what_a_plain_fit_does(cuda):
    """Under a `DataParallel` over a group of this one process (NCCL, the
    route of a multi-GPU user), float32 fits of a width-32 ResNet-18 launch
    what the same fits without it launch: v1 and v4 panels for the Kron
    fit (each rank decomposes every factor), syrk for the FullLL fit (once
    a batch); marglik and probit agree within 1e-5."""
    import torch.distributed as dist

    from laplace_jax_torch import FullLLLaplace, KronLaplace
    from laplace_jax_torch.models.resnet import ResNet18
    from laplace_jax_torch.parallel import DataParallel
    from laplace_jax_torch.utils.data import ArrayLoader

    rng = np.random.default_rng(0)
    X, y = rng.standard_normal((32, 8, 8, 3)).astype(np.float32), rng.integers(0, 10, 32)
    net = ResNet18(width=32, generator=torch.Generator().manual_seed(0))
    loader = ArrayLoader(X, y, batch_size=16)
    try:
        dp = DataParallel()
        assert dist.get_backend() == "nccl" and dp.size == 1
        for cls in (KronLaplace, FullLLLaplace):
            out = []
            for parallel in (None, dp):
                la = cls(net, "classification", device=cuda, parallel=parallel)
                before = (latrd_panel.launches, latrd_panel_v4.launches, syrk.launches)
                la.fit(loader)
                after = (latrd_panel.launches, latrd_panel_v4.launches, syrk.launches)
                out.append(([a - b for a, b in zip(after, before)],
                            float(la.log_marginal_likelihood()), la(X[:4]).cpu()))
            assert out[0][0] == out[1][0]
            assert out[0][0][2 if cls is FullLLLaplace else 0] > 0
            np.testing.assert_allclose(out[1][1], out[0][1], rtol=1e-5)
            torch.testing.assert_close(out[1][2], out[0][2], atol=1e-5, rtol=0)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def test_sbr_chain_on_card_matches_cpu(cuda):
    """The successive band reduction (`ops/band.py`, `ops/chase.py`, no
    kernel of its own) in float64 at (2, 96, 16): band -> chase -> stage 2
    -> both back-transforms on the card, against the same chain on the CPU
    within 1e-10, and an exact eigendecomposition."""
    from laplace_jax_torch.ops.band import band_reduce
    from laplace_jax_torch.ops.chase import apply_chase_q, band_to_tridiag
    from laplace_jax_torch.ops.tridiag_eig import tridiag_eigh

    X = np.random.default_rng(96).standard_normal((2, 96, 96))
    A = torch.as_tensor(X @ X.transpose(0, 2, 1) / 96)
    out = []
    for dev in (cuda, torch.device("cpu")):
        B, V1, t1 = band_reduce(A.to(dev), b=16)
        d, e, V2, t2 = band_to_tridiag(B, 16)
        lam, Ut = tridiag_eigh(d, e)
        out.append((lam.cpu(), apply_q(V1, t1, apply_chase_q(V2, t2, Ut, b=16)).cpu(), d.cpu()))
    scale = float(out[1][0].abs().max())
    torch.testing.assert_close(out[0][0], out[1][0], atol=1e-10 * scale, rtol=0)
    torch.testing.assert_close(out[0][2], out[1][2], atol=1e-10 * scale, rtol=0)
    lam, Q = out[0][:2]
    torch.testing.assert_close(Q @ torch.diag_embed(lam) @ Q.mT, A, atol=1e-10 * scale, rtol=0)
    torch.testing.assert_close(Q.mT @ Q, torch.eye(96, dtype=A.dtype).expand(2, 96, 96),
                               atol=1e-10, rtol=0)


# stage 2's Jacobi leaves (`csrc/jacobi_leaves.cu`) against their plain
# version on the card: the same rotations in the same order, so each
# reading lies within a small multiple of the plain version's own
LEAF_SHAPES = [(2, 64), (5, 64), (31, 96), (32, 96), (36, 384), (47, 64), (48, 80)]


def _leaf_levels(A, vals, vecs):
    """Eigenvalue gap to eigvalsh, ‖A V − V Λ‖ / ‖A‖ and ‖VᵀV − I‖ per leaf,
    in float64."""
    A, vals, vecs = A.double(), vals.double(), vecs.double()
    ref = torch.linalg.eigvalsh(A)
    scale = A.flatten(1).norm(dim=1).clamp(min=1e-300)
    eig = (vals - ref).abs().amax(1) / scale
    resid = (A @ vecs - vecs * vals[:, None, :]).flatten(1).norm(dim=1) / scale
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    orth = (vecs.mT @ vecs - eye).flatten(1).norm(dim=1)
    return eig, resid, orth


def _hold_leaves_to_plain(A):
    from laplace_jax_torch.ops import tridiag_eig as te

    n0 = te._jacobi_eigh.launches
    got = te._jacobi_eigh(A)
    ref = te._jacobi_eigh_plain(A)
    torch.cuda.synchronize()
    assert te._jacobi_eigh.launches == n0 + 1
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape
    assert got[0].dtype == got[1].dtype == A.dtype
    eps = torch.finfo(A.dtype).eps
    for name, g, r in zip(("eig", "resid", "orth"), _leaf_levels(A, *got), _leaf_levels(A, *ref)):
        g, r = float(g.max()), float(r.max())
        assert g <= 4 * r + 16 * eps, (name, g, r)
    return got, ref


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
@pytest.mark.parametrize("m,B", LEAF_SHAPES, ids=[f"m{m}-B{B}" for m, B in LEAF_SHAPES])
def test_jacobi_leaves_match_plain(cuda, m, B, dtype):
    X = np.random.default_rng(1000 + m).standard_normal((B, m, m))
    A = torch.as_tensor((X + X.transpose(0, 2, 1)) / 2, dtype=dtype, device=cuda)
    _hold_leaves_to_plain(A)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_jacobi_leaves_on_diagonal_and_tied_inputs(cuda, dtype):
    """A diagonal leaf (every apq under `tiny`: no rotation) comes out as
    its sorted diagonal and a permutation, ties by index, exactly as the
    plain version; leaves with tied eigenvalues (Q diag(λ) Qᵀ, λ in pairs
    and triples) as close as the plain version."""
    from laplace_jax_torch.ops.tridiag_eig import _jacobi_eigh

    rng = np.random.default_rng(7)
    diag = np.round(rng.standard_normal((16, 36)), 1)  # rounded: many ties
    D = torch.diag_embed(torch.as_tensor(diag, dtype=dtype, device=cuda))
    vals, vecs = _jacobi_eigh(D)
    order = torch.argsort(D.diagonal(dim1=1, dim2=2).cpu(), dim=1, stable=True)
    assert torch.equal(vals.cpu(), torch.gather(D.diagonal(dim1=1, dim2=2).cpu(), 1, order))
    eye = torch.eye(36, dtype=dtype).expand(16, 36, 36)
    assert torch.equal(vecs.cpu(), torch.gather(eye, 2, order[:, None, :].expand(16, 36, 36)))

    lam = np.repeat(rng.standard_normal((32, 12)), 3, axis=1)  # each eigenvalue three times
    Q = np.linalg.qr(rng.standard_normal((32, 36, 36)))[0]
    T = np.einsum("bij,bj,bkj->bik", Q, lam, Q)
    _hold_leaves_to_plain(torch.as_tensor((T + T.transpose(0, 2, 1)) / 2, dtype=dtype,
                                          device=cuda))


def test_jacobi_leaves_on_the_stage2_data(cuda):
    """The leaves that `tridiag_eigh` builds from the float32 tridiagonal of
    `tests/data/stage2_float32_tridiagonal.npz` (n = 2304: 64 leaves of 36,
    with their Cuppen corrections), kernel against plain."""
    from pathlib import Path

    from laplace_jax_torch.ops import tridiag_eig as te

    data = np.load(Path(__file__).parent / "data" / "stage2_float32_tridiagonal.npz")
    d = torch.as_tensor(data["d"], device=cuda)[None]
    e = torch.as_tensor(data["e"], device=cuda)[None]
    seen = []
    real = te._jacobi_eigh

    def record(T):
        seen.append(T.clone())
        return te._jacobi_eigh_plain(T)

    te._jacobi_eigh = record
    try:
        te.tridiag_eigh(d, e)
    finally:
        te._jacobi_eigh = real
    assert len(seen) == 1 and tuple(seen[0].shape) == (64, 36, 36)
    _hold_leaves_to_plain(seen[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["float32", "float64"])
def test_jacobi_leaves_carry_a_nan_to_the_flags(cuda, dtype):
    """A NaN in a leaf reaches that leaf's eigenvalues, which
    `utils/matrix._clip_flags` reads, sorted last (any numbers first, in
    order), and no other leaf: the others come out bit for bit as without
    it."""
    from laplace_jax_torch.ops.tridiag_eig import _jacobi_eigh

    X = np.random.default_rng(3).standard_normal((4, 36, 36))
    A = torch.as_tensor((X + X.transpose(0, 2, 1)) / 2, dtype=dtype, device=cuda)
    clean = _jacobi_eigh(A)
    A[2, 4, 17] = A[2, 17, 4] = float("nan")
    vals, vecs = _jacobi_eigh(A)
    nan = vals[2].isnan()
    assert bool(nan.any())
    num = vals[2, :int((~nan).sum())]
    assert not bool(num.isnan().any())  # the NaNs last
    assert bool((num[1:] >= num[:-1]).all())
    keep = [0, 1, 3]
    assert torch.equal(vals[keep], clean[0][keep]) and torch.equal(vecs[keep], clean[1][keep])


def test_tridiag_eigh_launches_the_leaves_once_without_a_sync(cuda):
    """Stage 2 of a (3, 4608) tridiagonal on the card: one launch of the
    leaves' kernel (384 leaves of 36), counted by the wrapper and by the
    counter `decompose.stage2.leaf_launches`, and no host sync inside the
    span `decompose.stage2.leaves`."""
    from laplace_jax_torch.ops import tridiag_eig as te
    from laplace_jax_torch.utils import spans

    rng = np.random.default_rng(4608)
    d = torch.as_tensor(rng.standard_normal((3, 4608)), dtype=torch.float32, device=cuda)
    e = torch.as_tensor(rng.standard_normal((3, 4607)), dtype=torch.float32, device=cuda)
    te.tridiag_eigh(d, e)  # loads the library
    torch.cuda.synchronize()
    n0 = te._jacobi_eigh.launches
    spans.reset()
    with spans.recording():
        lam, U = te.tridiag_eigh(d, e)
        torch.cuda.synchronize()
    s = spans.summary()
    spans.reset()
    assert te._jacobi_eigh.launches == n0 + 1
    assert s["counters"]["decompose.stage2.leaf_launches"] == 1
    assert s["spans"]["decompose.stage2.leaves"]["count"] == 1
    assert s["spans"]["decompose.stage2.leaves"]["syncs"] == 0
    assert bool(lam.isfinite().all()) and bool((lam[:, 1:] >= lam[:, :-1]).all())


def test_jacobi_leaves_reject_what_the_kernel_does_not_take(cuda):
    from laplace_jax_torch.ops.tridiag_eig import _jacobi_eigh

    with pytest.raises(ValueError):
        _jacobi_eigh(torch.zeros(2, 49, 49, device=cuda))
    with pytest.raises(ValueError):
        _jacobi_eigh(torch.zeros(2, 36, 72, device=cuda)[:, :, :36])
    with pytest.raises(TypeError):
        _jacobi_eigh(torch.zeros(2, 36, 36, dtype=torch.int32, device=cuda))


# stage 2's secular solve (`csrc/secular.cu`) against its plain version on
# the card: the same float64 operations, the sums over the poles in another
# order. So an active root agrees to 1e-12 of its gap (both end inside the
# same last bisection bracket, gap / 2**40 wide), and its origin is the
# plain version's except where f at mid-gap is within rounding of 0.
# (B, M), which take each launch shape the kernel chooses: the first level
# of a 32-factor chunk of the 2048 class, the top levels of the 4608 and
# 10,944 classes (a merge in slices of blocks), a merge that streams its
# poles through shared memory in tiles, and small stacks that pack several
# merges into a block (B odd: a block's last merge slot empty)
SECULAR_SHAPES = [(1024, 64), (3, 4608), (1, 11008), (1, 16384), (7, 64), (5, 88), (1, 2048)]


def _secular_args(B, M, dtype, seed, device):
    """The arguments `_merge_level` hands `_secular` for B merges of
    `tests/torch_merges.deflating_merge`."""
    from .torch_merges import deflating_merge, secular_args

    return secular_args(*deflating_merge(B, M, dtype, seed, device))


def _hold_secular_to_plain(args):
    from laplace_jax_torch.ops import tridiag_eig as te

    from .torch_merges import secular_against_plain

    n0 = te._secular.launches
    out = te._secular(*args)
    plain = te._secular_plain(*args)
    torch.cuda.synchronize()
    assert te._secular.launches == n0 + 1
    assert out[0].dtype == torch.float64 and out[1].dtype == torch.int64
    worst, stray = secular_against_plain(args, out, plain)
    assert stray == 0, stray
    assert worst <= 1e-12, worst
    return worst


@pytest.mark.parametrize("B,M", SECULAR_SHAPES, ids=[f"{B}x{M}" for B, M in SECULAR_SHAPES])
def test_secular_matches_plain(cuda, B, M):
    _hold_secular_to_plain(_secular_args(B, M, torch.float64, 100 + M, cuda))


@pytest.mark.parametrize("B,M", [(7, 64), (5, 88), (1, 2048)], ids=["7x64", "5x88", "1x2048"])
def test_secular_of_float32_merges_matches_plain(cuda, B, M):
    """A float32 merge hands the solve float64 arguments (it solves in
    float64), and the kernel runs them as any other."""
    args = _secular_args(B, M, torch.float32, 200 + M, cuda)
    assert all(t.dtype == torch.float64 for t in args[:4])
    _hold_secular_to_plain(args)


def test_tridiag_eigh_on_card_matches_eigvalsh(cuda):
    """Stage 2 on the card, the secular kernel in every merge (one launch a
    level, counted by the wrapper and by the counter
    `decompose.stage2.secular_launches`): float64 against eigvalsh within
    1e-10 of the spectrum, the float32 tridiagonal of
    `tests/data/stage2_float32_tridiagonal.npz` to the CPU test's limits,
    and a NaN in one tridiagonal reaching its eigenvalues only."""
    from pathlib import Path

    from laplace_jax_torch.ops import tridiag_eig as te
    from laplace_jax_torch.utils import spans

    rng = np.random.default_rng(1100)
    d = torch.as_tensor(rng.standard_normal((3, 1100)), device=cuda)
    e = torch.as_tensor(rng.standard_normal((3, 1099)), device=cuda)
    T = torch.diag_embed(d) + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
    te.tridiag_eigh(d, e)  # loads the libraries
    torch.cuda.synchronize()
    n0 = te._secular.launches
    spans.reset()
    with spans.recording():
        lam, U = te.tridiag_eigh(d, e)
        torch.cuda.synchronize()
    s = spans.summary()
    spans.reset()
    levels = s["spans"]["decompose.stage2.merge"]["count"]
    assert levels == 5  # leaves of 35, 5 merge levels to 1120
    assert te._secular.launches == n0 + levels
    assert s["counters"]["decompose.stage2.secular_launches"] == levels
    ref = torch.linalg.eigvalsh(T)
    scale = float(ref.abs().max())
    torch.testing.assert_close(lam, ref, atol=1e-10 * scale, rtol=0)
    torch.testing.assert_close(U @ torch.diag_embed(lam) @ U.mT, T, atol=1e-10 * scale, rtol=0)

    data = np.load(Path(__file__).parent / "data" / "stage2_float32_tridiagonal.npz")
    d32 = torch.as_tensor(data["d"], device=cuda)[None]
    e32 = torch.as_tensor(data["e"], device=cuda)[None]
    lam, vecs = te.tridiag_eigh(d32, e32)
    T32 = (torch.diag_embed(d32.double()) + torch.diag_embed(e32.double(), 1)
           + torch.diag_embed(e32.double(), -1))
    ref = torch.linalg.eigvalsh(T32)
    lam, vecs = lam.double(), vecs.double()
    eig = float((lam - ref).abs().max() / ref.abs().max())
    recon = float(torch.linalg.matrix_norm(vecs @ torch.diag_embed(lam) @ vecs.mT - T32)
                  / torch.linalg.matrix_norm(T32))
    orth = float((vecs.mT @ vecs - torch.eye(2304, dtype=torch.float64, device=cuda)).abs().max())
    assert eig < 1e-5 and recon < 1e-5 and orth < 1e-5, (eig, recon, orth)

    clean = torch.linalg.eigvalsh(T[[0, 2]])
    d[1, 37] = float("nan")
    lam_nan, _ = te.tridiag_eigh(d, e)
    assert bool(lam_nan[1].isnan().any())
    assert not bool(lam_nan[[0, 2]].isnan().any())
    torch.testing.assert_close(lam_nan[[0, 2]], clean, atol=1e-10 * scale, rtol=0)


def test_secular_rejects_what_the_kernel_does_not_take(cuda):
    from laplace_jax_torch.ops.tridiag_eig import _secular

    B, M = 2, 64
    ds = torch.zeros(B, M, dtype=torch.float64, device=cuda)
    nxt = torch.full((B, M), M, dtype=torch.int64, device=cuda)
    rho = torch.ones(B, dtype=torch.float64, device=cuda)
    ok = (ds, ds.clone(), rho, ds.clone(), nxt)
    n0 = _secular.launches
    with pytest.raises(TypeError):
        _secular(ds.float(), *ok[1:], 1e-300)
    with pytest.raises(TypeError):
        _secular(*ok[:4], nxt.int(), 1e-300)
    with pytest.raises(ValueError):
        _secular(torch.zeros(M, B, dtype=torch.float64, device=cuda).mT, *ok[1:], 1e-300)
    with pytest.raises(ValueError):
        _secular(ds, ds[:, :32], *ok[2:], 1e-300)
    with pytest.raises(ValueError):
        _secular(*ok[:2], rho[:1], *ok[3:], 1e-300)
    assert _secular.launches == n0


@pytest.mark.parametrize("K, n", [(4, 2048), (2, 4096)])
def test_float32_polish_on_card_is_no_worse_than_qr(cuda, monkeypatch, K, n):
    """Stage 2's float32 polish (`_orthonormalize`, one Newton-Schulz step in
    float64) on a stack at the reward cell's widths (v1 at 2048, v4 at
    4096) of rank-deficient KFAC-like factors (Grams of n / 4 ReLU rows),
    against the Householder-QR polish of the same vectors, computed here:
    each polished basis's max |VᵀV - I| within 1e-6 and no larger than the
    QR's, and `eigh_stack_ts`'s ‖AQ - QΛ‖ / ‖A‖ over the stack no larger
    than with the QR's basis back-transformed; no factor is refused. (The
    back-transform's rounding, about 1e-6 to 4e-6, sets the end-to-end
    orthogonality with either polish.)"""
    from laplace_jax_torch.ops import tridiag_eig as te

    from .torch_merges import qr_polish

    g = torch.Generator(device=cuda).manual_seed(n)
    X = torch.randn(K, n // 4, n, device=cuda, generator=g).clamp(min=0)
    A = X.mT @ X / (n // 4)
    A = (A + A.mT) / 2
    seen = {"qr": [], "step": []}
    real, real_apply_q = te._orthonormalize, te.apply_q

    def both(V):
        seen["qr"].append(qr_polish(V))
        seen["step"].append(real(V))
        return seen["step"][-1]

    def apply_both(V, taus, Ut, nb):
        seen["Q_qr"] = real_apply_q(V, taus, torch.cat(seen["qr"]), nb=nb)
        return real_apply_q(V, taus, Ut, nb=nb)

    monkeypatch.setattr(te, "_orthonormalize", both)
    monkeypatch.setattr(te, "apply_q", apply_both)
    lam, Q = te.eigh_stack_ts(A, device=cuda)
    assert lam.dtype == Q.dtype == torch.float32
    eye = torch.eye(n, dtype=torch.float64, device=cuda)
    steps, qrs = torch.cat(seen["step"]), torch.cat(seen["qr"])
    assert bool(steps.isfinite().all())
    for step, qr in zip(steps.double(), qrs.double()):
        got, ref = (float((M.mT @ M - eye).abs().max()) for M in (step, qr))
        assert got <= 1e-6 and got <= ref, (got, ref)
    A64, lam64 = A.double(), lam.double()[:, None, :]
    resid = [float(torch.linalg.vector_norm(A64 @ M.double() - M.double() * lam64)
                   / torch.linalg.vector_norm(A64)) for M in (Q, seen["Q_qr"])]
    assert resid[0] <= resid[1], resid
