"""The launch plan of the persistent v1 panel kernel (`ops/latrd.py`
`panel_plan`, `smem_bytes`): pure index arithmetic, checked on the CPU.

The kernel (`csrc/latrd.cu`, `k_panel<T, 1>` of `csrc/latrd_panel.cuh`)
gives each block the run of live rows that `Rows` there describes
(`row_starts` below is the same cut) and lays out
its shared memory as `smem_bytes` reckons it (the card checks the two agree
on first use). So every live row
must be owned by exactly one block, a block's rows lie in one window
whenever K <= the block count (else in no more windows than its shared
memory has slots for), and every window of the ResNet-18 main path must
keep its rows on chip in float32.
"""

import pytest
import torch

from laplace_jax_torch.ops import latrd
from laplace_jax_torch.ops.latrd import (
    MIN_ROWS,
    SMEM_BYTES,
    STATIC_BYTES,
    panel_plan,
    smem_bytes,
    tridiagonalize_latrd,
)
from laplace_jax_torch.ops.tridiag import _cdiv

H100_SMS = 132


def row_starts(K, m, off, n_cta):
    """Where each block's run of live rows starts, then K L (`Rows` in
    csrc/latrd_panel.cuh): live rows are window-relative rows >= off, numbered
    k L + i - off with L = m - off; with K <= n_cta each window's L rows are
    cut into n_cta // K runs of its own, else all K L rows into n_cta runs;
    the first runs of a cut are one row longer."""
    L = m - off

    def runs(total, parts):
        base, extra = divmod(total, parts)
        return [t * base + min(t, extra) for t in range(parts)]

    if K <= n_cta:
        return [k * L + x for k in range(K) for x in runs(L, n_cta // K)] + [K * L]
    return runs(K * L, n_cta) + [K * L]


def _main_path_panels():
    """(K, m, off) of every panel stage 1 runs with the v1 kernel for
    ResNet-18's classes 512 (K=6), 576 (K=5), 1152 (K=4) and KronLL's 512
    (K=1), with the class width S of `tridiagonalize_latrd`."""
    out = set()
    for K, n in ((6, 512), (5, 576), (4, 1152), (1, 512)):
        S = max(128, _cdiv(_cdiv(n, 4), 128) * 128)
        n_pad, n_cols = _cdiv(n, S) * S, n - 2
        for q in range(0, n_cols, S):
            out |= {(K, n_pad - q, t * 64) for t in range(_cdiv(min(S, n_cols - q), 64))}
    return sorted(out)


PANELS = _main_path_panels()
CASES = ([pytest.param(K, m, off, id=f"{K}x{m}-off{off}") for K, m, off in PANELS]
         + [pytest.param(K, m, off, id=f"card-{K}x{m}-off{off}")
            for K, m, off in ((3, 384, 0), (3, 384, 64), (3, 384, 320), (2, 128, 8),
                              (40, 768, 0), (1, 64, 0))]
         + [pytest.param(150, 128, 64, id="more-windows-than-sms-150x128-off64")])


def test_main_path_runs_35_panels_and_kronll_8():
    assert sum(1 for K, _, _ in PANELS if K > 1) == 35
    assert sorted({(K, m) for K, m, _ in PANELS}) == [
        (1, 128), (1, 256), (1, 384), (1, 512), (4, 384), (4, 768), (4, 1152),
        (5, 256), (5, 512), (5, 768), (6, 128), (6, 256), (6, 384), (6, 512)]


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("K,m,off", CASES)
def test_every_live_row_is_owned_by_one_block(K, m, off, itemsize):
    plan = panel_plan(K, m, off, 64, itemsize, H100_SMS)
    starts = row_starts(K, m, off, plan.n_cta)
    L = m - off
    if K <= H100_SMS:  # each window its own blocks
        assert plan.n_cta == K * min(H100_SMS // K, _cdiv(L, MIN_ROWS))
    else:
        assert plan.n_cta == min(H100_SMS, _cdiv(K * L, MIN_ROWS))
    assert len(starts) == plan.n_cta + 1
    assert starts[0] == 0 and starts[-1] == K * L
    runs = [b - a for a, b in zip(starts, starts[1:])]
    # contiguous runs, each at least one row, within one row of each other
    assert min(runs) >= 1 and max(runs) - min(runs) <= 1 and max(runs) == plan.rows
    owners = torch.repeat_interleave(torch.arange(plan.n_cta), torch.tensor(runs))
    assert owners.numel() == K * L and bool((owners[1:] >= owners[:-1]).all())


@pytest.mark.parametrize("K,m,off", CASES)
def test_no_block_touches_more_windows_than_its_slots(K, m, off):
    """The kernel stages v for each window a block's rows touch; shared
    memory has one such slot when each window has blocks of its own (K <=
    the block count), else NW = min(K, (R + L - 2) // L + 1)."""
    plan = panel_plan(K, m, off, 64, 4, H100_SMS)
    L, R = m - off, plan.rows
    starts = row_starts(K, m, off, plan.n_cta)
    touched = max((b - 1) // L - a // L + 1 for a, b in zip(starts, starts[1:]))
    if K <= plan.n_cta:
        assert touched == 1
    else:
        assert 1 < touched <= min(K, (R + L - 2) // L + 1)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("K,m,off", CASES)
def test_plan_fits_shared_memory_and_caches_all_it_can(K, m, off, itemsize):
    plan = panel_plan(K, m, off, 64, itemsize, H100_SMS)
    assert SMEM_BYTES == 227 * 1024
    assert plan.smem == smem_bytes(K, m, off, 64, plan.n_cta, plan.cache_window,
                                   plan.cache_rows, itemsize)
    assert STATIC_BYTES + plan.smem <= SMEM_BYTES
    assert plan.cache_rows or not plan.cache_window
    # the window rows are streamed only when they do not fit beside the rest
    if not plan.cache_window:
        full = smem_bytes(K, m, off, 64, plan.n_cta, True, True, itemsize)
        assert STATIC_BYTES + full > SMEM_BYTES


@pytest.mark.parametrize("K,m,off", [pytest.param(K, m, off, id=f"{K}x{m}-off{off}")
                                     for K, m, off in PANELS])
def test_main_path_windows_are_resident_in_float32(K, m, off):
    plan = panel_plan(K, m, off, 64, 4, H100_SMS)
    assert plan.cache_window and plan.cache_rows


def test_largest_window_in_float64_streams_its_rows():
    """(4, 1152) in float64: 35 rows of 9.2 KB do not fit in 227 KB, so each
    block streams its own rows from L2 and keeps its rows of U and W."""
    plan = panel_plan(4, 1152, 0, 64, 8, H100_SMS)
    assert (plan.n_cta, plan.rows) == (132, 35)
    assert not plan.cache_window and plan.cache_rows
    assert smem_bytes(4, 1152, 0, 64, 132, True, True, 8) > SMEM_BYTES
    # in float32 the same window is resident, 194,092 bytes a block
    assert panel_plan(4, 1152, 0, 64, 4, H100_SMS).smem == 194092


def test_many_windows_keep_nothing_but_their_vectors_and_huge_stacks_raise():
    plan = panel_plan(48, 1024, 0, 64, 4, H100_SMS)
    assert not plan.cache_window and not plan.cache_rows
    with pytest.raises(ValueError):
        panel_plan(4000, 2048, 0, 64, 8, H100_SMS)


def test_small_windows_take_fewer_blocks():
    """KronLL's (1, 512): 64 blocks of 8 rows, not 132 of 3 or 4."""
    assert panel_plan(1, 512, 0, 64, 4, H100_SMS).n_cta == 64
    assert panel_plan(1, 128, 64, 64, 4, H100_SMS).n_cta == 8


def test_cpu_stage1_never_plans_a_launch():
    """On the CPU stage 1 takes the plain panels; no plan is cached."""
    before = dict(latrd._plans)
    A = torch.randn(2, 130, 130, dtype=torch.float64)
    tridiagonalize_latrd((A + A.mT) / 2, nb=16)
    assert latrd._plans == before
