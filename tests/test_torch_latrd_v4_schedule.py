"""The tile schedule of the persistent v4 panel kernel (`ops/latrd_v4.py`
`panel_schedule`, `panel_plan`): pure index arithmetic, checked on the CPU.

The kernel (`csrc/latrd_v4.cu`) multiplies exactly the tiles the table
hands each block, so the table must cover every lower-triangle 64x64 tile
of the panel's trailing block once, schedule no dead tile, balance the
blocks, and leave room in shared memory for the resident tiles and the ring.
"""

import pytest
import torch

from laplace_jax_torch.ops.latrd_v4 import (
    MAX_RES,
    RING,
    SMEM_BYTES,
    STATIC_BYTES,
    TILE,
    dynamic_smem,
    panel_plan,
    panel_schedule,
    tridiagonalize_latrd_v4,
)
from laplace_jax_torch.ops.tridiag import _cdiv

H100_SMS = 132


def _main_path_windows():
    """(K, m, S) of every window stage 1 visits for ResNet-18's v4 classes
    (4608 x3, 2304 x4), with the class width S of `tridiagonalize_latrd_v4`."""
    out = []
    for K, n in ((3, 4608), (4, 2304)):
        T = 384
        S = max(T, _cdiv(_cdiv(n, 4), T) * T)
        out += [(K, n - q, S) for q in range(0, n - 2, S)]
    return out


WINDOWS = _main_path_windows()
CASES = ([pytest.param(K, m, off, id=f"{K}x{m}-off{off}")
          for K, m, S in WINDOWS for off in (0, S - 64)]
         + [pytest.param(K, m, off, id=f"card-{K}x{m}-off{off}")
            for K, m, off in ((3, 384, 0), (3, 384, 64), (3, 384, 320),
                              (1, 256, 192), (3, 640, 72), (2, 128, 8))])


def test_main_path_windows_are_the_seven_of_the_fit():
    assert sorted({(K, m) for K, m, _ in WINDOWS}) == [
        (3, 1152), (3, 2304), (3, 3456), (3, 4608), (4, 768), (4, 1536), (4, 2304)]


def _decode(table, n_cta):
    offsets = table[: n_cta + 1].long()
    codes = table[n_cta + 1 :].long()
    return offsets, codes >> 20, codes >> 10 & 1023, codes & 1023


@pytest.mark.parametrize("K,m,off", CASES)
def test_schedule_covers_the_trailing_block_once(K, m, off):
    nt, s0 = m // TILE, (off + 1) // TILE
    table = panel_schedule(K, m, off, H100_SMS)
    assert table.dtype == torch.int32
    offsets, k, r, s = _decode(table, H100_SMS)
    assert int(offsets[0]) == 0 and int(offsets[-1]) == k.numel()
    assert bool((offsets[1:] >= offsets[:-1]).all())
    # no dead tile: inside the windows, lower triangle, right of column s0
    assert bool(((k >= 0) & (k < K) & (r < nt) & (r >= s) & (s >= s0)).all())
    # every live tile exactly once
    want = {(kk, rr, ss) for kk in range(K) for rr in range(s0, nt) for ss in range(s0, rr + 1)}
    got = list(zip(k.tolist(), r.tolist(), s.tolist()))
    assert len(got) == len(set(got)) == len(want)
    assert set(got) == want


@pytest.mark.parametrize("K,m,off", CASES)
def test_schedule_balances_blocks_in_row_strips(K, m, off):
    nt = m // TILE
    offsets, k, r, s = _decode(panel_schedule(K, m, off, H100_SMS), H100_SMS)
    counts = offsets[1:] - offsets[:-1]
    assert int(counts.max() - counts.min()) <= 1
    # each block's run is in row-major order, so tiles sharing a tile row
    # (a strip) are consecutive
    key = (k * nt + r) * nt + s
    assert bool((key[1:] > key[:-1]).all())


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("K,m,off", CASES)
def test_resident_tiles_and_ring_fit_shared_memory(K, m, off, itemsize):
    nt, s0 = m // TILE, (off + 1) // TILE
    n_tiles = K * (nt - s0) * (nt - s0 + 1) // 2
    n_units = _cdiv(K * nt, H100_SMS)
    n_res, n_cache, table = panel_plan(K, m, off, 64, itemsize, H100_SMS)
    assert torch.equal(table, panel_schedule(K, m, off, H100_SMS))

    def fits(res, cache):
        used = STATIC_BYTES + dynamic_smem(K, 64, res, cache, n_units, itemsize)
        return used <= SMEM_BYTES

    assert SMEM_BYTES == 227 * 1024 and RING[itemsize] >= 2
    assert fits(n_res, n_cache)
    # every row block a block owns is cached whenever that fits
    assert n_cache == (n_units if fits(0, n_units) else 0)
    # as many resident tiles as fit, within MAX_RES and a block's share
    share = _cdiv(n_tiles, H100_SMS)
    assert 0 <= n_res <= min(share, MAX_RES)
    assert n_res == min(share, MAX_RES) or not fits(n_res + 1, n_cache)


def test_main_path_windows_cache_their_rows():
    """Every main-path window keeps its blocks' rows of U and W on chip in
    both dtypes; at (3, 4608) float32, 5 tiles a block stay resident beside
    them (132 x 5 x 16 KB = 10.8 MB of the 127 MB triangle), and from
    m <= 1152 every tile does."""
    for K, m, _ in WINDOWS:
        for itemsize in (4, 8):
            assert panel_plan(K, m, 0, 64, itemsize, H100_SMS)[1] > 0
    n_res, n_cache, _ = panel_plan(3, 4608, 0, 64, 4, H100_SMS)
    assert (n_res, n_cache) == (5, 2)
    for K, m in ((4, 768), (3, 1152)):
        nt = m // TILE
        n_res, _, _ = panel_plan(K, m, 0, 64, 4, H100_SMS)
        assert n_res * H100_SMS >= K * nt * (nt + 1) // 2


def test_schedule_rejects_windows_its_codes_cannot_hold():
    with pytest.raises(ValueError):
        panel_schedule(1, 65536 + 64, 0, H100_SMS)
    with pytest.raises(ValueError):
        panel_schedule(2049, 128, 0, H100_SMS)


def test_cpu_stage1_never_plans_a_schedule():
    """On the CPU stage 1 takes the plain panels; no table is built."""
    from laplace_jax_torch.ops import latrd_v4

    before = dict(latrd_v4._plans)
    A = torch.randn(2, 130, 130, dtype=torch.float64)
    tridiagonalize_latrd_v4((A + A.mT) / 2, nb=16)
    assert latrd_v4._plans == before
