"""The launch plan and the summation order of the persistent v2 panel kernel
(`ops/latrd_v2.py` `panel_plan`; `csrc/latrd_v2.cu`, the kernel of
`csrc/latrd_panel.cuh` with 8 columns a group), checked on the CPU.

- Plan: on every panel of v2's route (stage 1 through
  `tridiagonalize_latrd_v2` for the classes n >= 512 of ResNet-18's KFAC
  fit, and for every class n = 512 ... 4608 at K <= 6), in float32 and
  float64, the dynamic shared memory fits in one block's 227 KB and the
  plan keeps all it can; the Python reckoning mirrors the kernel's constants.
- Rows: each block's run of live rows splits into resident rows and rows
  its warps stream, each live row exactly once, and each warp's walk over
  its rows' chunks covers every streamed (row, chunk) once a column, in
  reverse on odd columns, starting where the previous column ended.
- Order: a torch version of the kernel's panel (`emulated_panel`: the group
  rows corrected for the earlier groups at the group's first column, at
  most 7 in-group terms a column, sums of squares and y.v from per-block
  shares in block order, y whole a row, a streamed row's chunks in the
  column's order) against `latrd_panel_v2_plain` and the JAX package's XLA
  `tridiagonalize` at 1e-9 in float64, and against the JAX Pallas v2 panel
  in interpret mode at 1e-5 (the Pallas panel rounds in float32 even on
  float64 inputs, as in `tests/test_torch_latrd_v3_v2.py`).

The kernel itself is held against `latrd_panel_v2_plain`, bit for bit over
two launches, in `tests/test_torch_cuda_kernels.py` on the card.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from laplace_jax.ops.latrd_pallas_v2 import _latrd_panel_v2 as jax_latrd_panel_v2
from laplace_jax.ops.tridiag import tridiagonalize as jax_tridiagonalize
from laplace_jax_torch.ops import latrd_v2
from laplace_jax_torch.ops.latrd import SMEM_BYTES, STATIC_BYTES, block_count
from laplace_jax_torch.ops.latrd_v2 import (
    CHUNK_BYTES,
    GROUP,
    RING_SLOTS,
    WARPS,
    latrd_panel_v2_plain,
    panel_plan,
    smem_bytes,
)
from laplace_jax_torch.ops.tridiag import _cdiv, eps_tiny, tridiagonalize_windows
from tests.test_torch_latrd import _sym_window, _unpack_pallas
from tests.test_torch_latrd_v1_plan import row_starts

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

H100_SMS = 132
NB = 64
CSRC = Path(__file__).resolve().parents[1] / "laplace_jax_torch" / "csrc"


def _route_panels(K, n, nb=NB):
    """(K, m, off) of every panel stage 1 runs for one class through
    `tridiagonalize_latrd_v2` (window classes of ~n/4 rows rounded up to
    128)."""
    S = max(nb, 128, _cdiv(_cdiv(n, 4), 128) * 128)
    n_pad, n_cols = _cdiv(n, S) * S, n - 2
    return [(K, n_pad - q, t * nb) for q in range(0, n_cols, S)
            for t in range(_cdiv(min(S, n_cols - q), nb))]


# ResNet-18's KFAC classes n >= 512 (the eigensolvers phase of chip_smoke.py)
ROUTE = [(6, 512), (5, 576), (4, 1152), (4, 2304), (3, 4608)]


def test_route_runs_143_panels_and_streams_only_the_large_classes():
    panels = [p for K, n in ROUTE for p in _route_panels(K, n)]
    assert len(panels) == 143
    streaming = {(K, m) for K, m, off in panels
                 if panel_plan(K, m, off, NB, 4, H100_SMS).n_res
                 < panel_plan(K, m, off, NB, 4, H100_SMS).rows}
    assert streaming == {(3, 4608), (3, 3456), (3, 2304), (4, 2560), (4, 1920)}


def test_constants_mirror_the_kernel():
    """The Python reckoning uses the constants the kernel is built from."""
    src = (CSRC / "latrd_panel.cuh").read_text() + (CSRC / "latrd_common.cuh").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+)", src).group(1))

    assert const("kRingSlots") == RING_SLOTS and const("kChunkBytes") == CHUNK_BYTES
    assert const("kBlock") // 32 == WARPS
    assert int(re.search(r"constexpr int kGroup = (\d+)",
                         (CSRC / "latrd_v2.cu").read_text()).group(1)) == GROUP
    assert SMEM_BYTES == 227 * 1024


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("K,n", ROUTE, ids=[f"{K}x{n}" for K, n in ROUTE])
def test_route_plans_fit_and_keep_all_they_can(K, n, itemsize):
    for _, m, off in _route_panels(K, n):
        plan = panel_plan(K, m, off, NB, itemsize, H100_SMS)
        R = plan.rows
        assert plan.n_cta == block_count(K, m - off, H100_SMS)
        assert plan.smem == smem_bytes(K, m, off, NB, plan.n_cta, plan.n_res, plan.cache_rows,
                                       itemsize)

        def fits(n_res, cache_rows):
            return STATIC_BYTES + smem_bytes(K, m, off, NB, plan.n_cta, n_res, cache_rows,
                                             itemsize) <= SMEM_BYTES

        assert fits(plan.n_res, plan.cache_rows) and 0 <= plan.n_res <= R
        if plan.n_res == R:  # all resident, no ring
            assert plan.cache_rows
        else:  # the rows of U and W kept when they fit beside the ring; then all rows that fit
            assert not fits(R, True)
            assert plan.cache_rows == fits(0, True)
            assert plan.n_res == R - 1 or not fits(plan.n_res + 1, plan.cache_rows)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
def test_every_class_up_to_4608_is_planned(itemsize):
    """Every window of every class n = 512 ... 4608 (step 64), K <= 6,
    plans within 227 KB; the first panel of a window needs the most."""
    for n in range(512, 4609, 64):
        for m in sorted({m for _, m, _ in _route_panels(1, n)}):
            for K in range(1, 7):
                plan = panel_plan(K, m, 0, NB, itemsize, H100_SMS)
                assert STATIC_BYTES + plan.smem <= SMEM_BYTES


def test_the_kernel_rows_windows():
    """(4, 1152) in float32 keeps every row on chip (the v1 row's window);
    (3, 4608) keeps a few rows a block and streams the rest; in float64 it
    keeps none but still its rows of U and W."""
    assert panel_plan(4, 1152, 0, NB, 4, H100_SMS)[1:4] == (35, 35, True)
    plan = panel_plan(3, 4608, 0, NB, 4, H100_SMS)
    assert plan.rows == 105 and 0 < plan.n_res < 10 and plan.cache_rows
    assert panel_plan(3, 4608, 0, NB, 8, H100_SMS)[2:4] == (0, True)


def test_a_window_the_kernel_cannot_hold_raises():
    with pytest.raises(ValueError):
        panel_plan(4000, 2048, 0, NB, 8, H100_SMS)


def test_cpu_stage1_never_plans():
    before = dict(latrd_v2._plans)
    A = torch.randn(2, 130, 130, dtype=torch.float64)
    latrd_v2.tridiagonalize_latrd_v2((A + A.mT) / 2, nb=16)
    assert latrd_v2._plans == before


# -- the kernel's rows and streamed chunks, mirrored ------------------------


def block_rows(K, m, off, n_cta, n_res):
    """Per block, (resident, streamed by warp): live-row numbers k L + i - off
    of the block's run (`Rows`), its first n_res resident, warp w streaming
    rows n_res + w, n_res + w + 8, ... of the run."""
    starts = row_starts(K, m, off, n_cta)
    out = []
    for a, b in zip(starts, starts[1:]):
        run = list(range(a, b))
        nres = min(n_res, len(run))
        out.append((run[:nres], [run[nres + w::WARPS] for w in range(WARPS)]))
    return out


def walk(n_rows, nch, j):
    """A warp's units in order: (its q-th row, chunk t), reversed on odd j."""
    units = [(q, t) for q in range(n_rows) for t in range(nch)]
    return units[::-1] if j & 1 else units


def _row_cases():
    out = []
    for K, n in ROUTE:
        panels = _route_panels(K, n)
        for _, m, off in (panels[0], panels[-1]):
            out.append(pytest.param(K, m, off, id=f"{K}x{m}-off{off}"))
    return out + [pytest.param(40, 768, 0, id="40x768"), pytest.param(150, 768, 64, id="150x768")]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("K,m,off", _row_cases())
def test_every_live_row_is_resident_or_streamed_once(K, m, off, itemsize):
    plan = panel_plan(K, m, off, NB, itemsize, H100_SMS)
    seen = []
    for resident, by_warp in block_rows(K, m, off, plan.n_cta, plan.n_res):
        assert len(resident) <= plan.n_res
        counts = [len(rows) for rows in by_warp]
        assert max(counts) - min(counts) <= 1  # the warps' shares differ by a row at most
        seen += resident + [r for rows in by_warp for r in rows]
    assert sorted(seen) == list(range(K * (m - off)))


@pytest.mark.parametrize("n_rows,nch", [(13, 9), (1, 1), (3, 2), (0, 5)])
def test_a_warps_walk_covers_each_chunk_once_and_turns_back(n_rows, nch):
    for j in range(4):
        units = walk(n_rows, nch, j)
        assert sorted(units) == [(q, t) for q in range(n_rows) for t in range(nch)]
        if units and j:
            assert units[0] == walk(n_rows, nch, j - 1)[-1]  # still in L2


def test_row_stream_bound_counts_the_streamed_rows():
    """chip_smoke.row_stream_bound_ms: nothing streams when every row is
    resident; with no row resident, each column c reads every row i > c
    from column vec_floor(c + 1) on."""
    plan = panel_plan(4, 1152, 0, NB, 4, H100_SMS)
    assert chip_smoke.row_stream_bound_ms(4, 1152, 0, NB, 4, plan) == 0
    K, m, off = 3, 640, 64
    none = panel_plan(K, m, off, NB, 4, H100_SMS)._replace(n_res=0)
    elems = sum(K * (m - c - 1) * (m - (c + 1) // 4 * 4) for c in range(off, off + NB))
    assert chip_smoke.row_stream_bound_ms(K, m, off, NB, 4, none) == pytest.approx(
        1e3 * elems * 4 / chip_smoke.HBM_BYTES_PER_S, rel=1e-12)


# -- the kernel's order, emulated in torch -----------------------------------


def emulated_panel(Aw, off, q_base, n_real, nb, n_cta, n_res):
    """csrc/latrd_panel.cuh's panel with NG = 8 in torch, phase by phase,
    with the order of its cross-block sums and of a streamed row's chunks
    (within a warp or a thread, torch's own order)."""
    K, m, _ = Aw.shape
    dt = Aw.dtype
    L = m - off
    vec = 16 // Aw.element_size()
    chunk = CHUNK_BYTES // Aw.element_size()
    nv = min(n_real - q_base, m)
    lend = min(_cdiv(nv, vec) * vec, m)
    # each block's own rows and the streamed ones, as (K, m) masks
    own = torch.zeros(n_cta, K, m, dtype=torch.bool)
    streamed = torch.zeros(K, m, dtype=torch.bool)
    for b, (resident, by_warp) in enumerate(block_rows(K, m, off, n_cta, n_res)):
        for g in resident + [r for rows_ in by_warp for r in rows_]:
            own[b, g // L, off + g % L] = True
        for g in (r for rows_ in by_warp for r in rows_):
            streamed[g // L, off + g % L] = True
    UW = torch.zeros(K, 2 * nb, m, dtype=dt)
    det = torch.zeros(K, 3, nb, dtype=dt)
    rows = torch.arange(m)
    live = rows < nv

    def by_block(values):
        """Per window, the blocks' shares of sum_i values[k, i] over their
        own rows, added in block order."""
        total = torch.zeros(K, dtype=dt)
        for b in range(n_cta):
            total = total + torch.where(own[b], values, 0.0).sum(1)
        return total

    for j in range(nb):
        c = off + j
        h, j8 = j % GROUP, j - j % GROUP
        ok = c + q_base < n_real - 2
        U, W = UW[:, :nb], UW[:, nb:]
        if h == 0:  # the group's rows, corrected for every earlier group at once
            rows8 = Aw[:, c:c + GROUP, :].clone()
            rows8 -= torch.einsum("kqi,kqh->khi", U[:, :j8], W[:, :j8, c:c + GROUP]) \
                + torch.einsum("kqi,kqh->khi", W[:, :j8], U[:, :j8, c:c + GROUP])
        # (a) at most 7 in-group terms
        col = rows8[:, h] - (torch.einsum("kqi,kq->ki", U[:, j8:j], W[:, j8:j, c])
                             + torch.einsum("kqi,kq->ki", W[:, j8:j], U[:, j8:j, c]))
        col = torch.where((rows >= c) & live, col, 0.0)
        sumsq = by_block(torch.where(rows > c, col * col, 0.0))
        # (b) every window's reflector, the JAX package's rules
        alpha = col[:, c + 1] if c + 1 < m else torch.zeros(K, dtype=dt)
        a2 = alpha * alpha
        xnorm2 = (sumsq - a2).clamp(min=0.0)
        anorm = torch.sqrt(a2 + xnorm2)
        beta = torch.where(alpha >= 0, -anorm, anorm)
        trivial = xnorm2 <= eps_tiny(dt) * anorm * anorm
        denom = torch.where(trivial, 1.0, alpha - beta)
        tau = torch.where(trivial | (not ok), 0.0, (beta - alpha) / torch.where(trivial, 1.0, beta))
        det[:, 0, j], det[:, 1, j], det[:, 2, j] = col[:, c], torch.where(trivial, alpha, beta), tau
        v = torch.where((rows > c) & live, col / denom[:, None], 0.0)
        if c + 1 < m:
            v[:, c + 1] = 1.0 if c + 1 < nv else 0.0
        v = v if ok else torch.zeros_like(v)
        UW[:, j] = v
        s = torch.einsum("kqi,ki->kq", U[:, :j], v)  # one warp an entry
        t = torch.einsum("kqi,ki->kq", W[:, :j], v)
        # y = A v, one warp a row: a resident row whole, a streamed row by
        # chunks from vec_floor(c + 1) in the column's order
        l0 = (c + 1) // vec * vec
        whole = torch.einsum("kil,kl->ki", Aw[:, :, l0:lend], v[:, l0:lend])
        parts = [torch.einsum("kil,kl->ki", Aw[:, :, a:min(a + chunk, lend)],
                              v[:, a:min(a + chunk, lend)]) for a in range(l0, lend, chunk)]
        by_chunks = sum(parts[::-1] if j & 1 else parts, torch.zeros(K, m, dtype=dt))
        y = torch.where((rows > c) & live, torch.where(streamed, by_chunks, whole), 0.0)
        yv = by_block(torch.where(rows > c, y * v, 0.0))
        # (c) w on every row, one thread a row (and formed apart at the
        # group's later rows by every block, with the same arithmetic)
        sdt = (s * t).sum(1)
        wv = tau * (yv - 2 * sdt)
        corr = torch.einsum("kq,kqi->ki", t, U[:, :j]) + torch.einsum("kq,kqi->ki", s, W[:, :j])
        w = tau[:, None] * (y - corr) - (0.5 * tau * wv)[:, None] * v
        UW[:, nb + j] = torch.where((rows > c) & live, w, 0.0)
    return UW, det


# (K, m, off, n_real, nb, n_cta, n_res): every row resident; the group rows
# c8 .. c8+7 of block 0 split between its resident and streamed rows, several
# chunks a row (float64: 256 columns a chunk); off > 0 and a padded window;
# a block whose run spans both windows (n_cta < K is impossible, so K = 2 on
# 3 blocks); no row resident
ORDER_CASES = [(2, 256, 0, 256, 16, 8, 64), (2, 384, 0, 384, 16, 8, 4), (2, 384, 16, 378, 16, 6, 3),
               (2, 256, 8, 250, 16, 3, 20), (2, 384, 64, 320, 16, 4, 0)]


@pytest.mark.parametrize("K,m,off,n_real,nb,n_cta,n_res", ORDER_CASES,
                         ids=["{}x{}-off{}-nr{}-nb{}-g{}-res{}".format(*c) for c in ORDER_CASES])
def test_emulated_order_matches_plain(K, m, off, n_real, nb, n_cta, n_res):
    A = torch.as_tensor(_sym_window(np.random.default_rng(30), K, m, n_real))
    for g, r in zip(emulated_panel(A, off, 0, n_real, nb, n_cta, n_res),
                    latrd_panel_v2_plain(A, off, 0, n_real, nb)):
        torch.testing.assert_close(g, r, atol=1e-9 * float(r.abs().max()), rtol=0)


def test_group_rows_straddle_resident_and_streamed_rows():
    """In the second order case the first group's rows 0 .. 7 all belong to
    block 0, whose first 4 rows are resident and the next ones streamed."""
    (resident, by_warp), *_ = block_rows(2, 384, 0, 8, 4)
    assert resident == [0, 1, 2, 3] and [rows[0] for rows in by_warp[:4]] == [4, 5, 6, 7]


@pytest.mark.parametrize("n", [256, 250])
def test_stage1_in_the_emulated_order_matches_xla_tridiagonalize(n):
    """Stage 1 with the emulated panel on 6 blocks, 3 resident rows each,
    against the JAX package's XLA formulation with the same window classes
    (S = 128: windows of 256 and 128, padded when n = 250) in float64."""
    K, nb, S = 2, 16, 128
    A = _sym_window(np.random.default_rng(31), K, n, n)
    ref = [np.asarray(a) for a in jax_tridiagonalize(jnp.asarray(A), nb=nb, n_classes=2)]
    got = tridiagonalize_windows(torch.as_tensor(A), nb, S,
                                 lambda *a: emulated_panel(*a, n_cta=6, n_res=3))
    for g, r in zip(got, ref):
        g = g.numpy()[..., : r.shape[-2], : r.shape[-1]] if g.ndim == 3 else g.numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-9 * max(1.0, np.abs(r).max()))


def test_emulated_order_matches_pallas_v2():
    """One panel against the JAX Pallas v2 kernel in interpret mode (off >
    0, padded rows, two groups of 8) at 1e-5."""
    K, m, off, nb = 2, 256, 16, 16
    n_real = m - 6
    A = _sym_window(np.random.default_rng(11), K, m, n_real)
    ref = _unpack_pallas(*jax_latrd_panel_v2(jnp.asarray(A), off, 0, n_real, K=K, m=m, nb=nb,
                                             TR=128, interpret=True), K, m, nb)
    got = emulated_panel(torch.as_tensor(A), off, 0, n_real, nb, n_cta=6, n_res=3)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5)
