"""The syrk kernel's launch plan (`ops/syrk.syrk_plan`) and its tiled
emulation (`ops/syrk.syrk_tiled`), on the CPU.

The plan must cover every lower-triangular output tile exactly once, and
the kernel's store rules (a tile's entries on and below the diagonal, and
their mirror) must write every entry of H exactly once. The emulation,
which computes H tile by tile in the kernel's order over the rows of A and
mirrors it the kernel's way, must equal `syrk_plain` and the JAX package's
`syrk_reference` (float64, within 1e-12 of the largest entry; the sums
differ only in order) and be exactly symmetric. The kernel itself is held
against `syrk_plain` on the card in `tests/test_torch_cuda_kernels.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.syrk import syrk_reference
from laplace_jax_torch.ops.syrk import syrk_plain, syrk_plan, syrk_tiled

torch.set_num_threads(1)

PS = [1, 63, 64, 127, 128, 129, 130, 5130]
RS = [0, 1, 17, 1280]
SMEM_PER_SM = 232_448  # dynamic shared memory an SM gives its blocks on Hopper
DTYPES = [pytest.param(torch.float32, id="float32"), pytest.param(torch.float64, id="float64")]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("P", PS)
def test_plan_covers_every_lower_tile_once(P, R, dtype):
    plan = syrk_plan(R, P, dtype)
    size = 4 if dtype == torch.float32 else 8
    n = -(-P // plan.tile)
    assert len(set(plan.tiles)) == len(plan.tiles) == n * (n + 1) // 2
    assert all(0 <= j <= i < n for i, j in plan.tiles)
    assert list(plan.tiles) == sorted(plan.tiles)  # row order: the ragged last row runs last
    assert plan.n_chunks == -(-R // plan.chunk)
    # one 16-byte vector a fragment: 8x8 float32, 4x4 float64, 256 threads a tile
    assert plan.thread_tile * size == 32 and plan.threads * plan.thread_tile ** 2 == plan.tile ** 2
    widths = [w for w in (16, 8, 4) if (P * size) % w == 0]
    assert plan.copy_bytes == widths[0]
    ring = plan.stages * 2 * plan.chunk * plan.tile * size
    # two blocks an SM
    assert plan.smem_bytes == max(ring, plan.tile * (plan.tile + 1) * size) <= SMEM_PER_SM // 2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("P", PS)
def test_store_rules_write_every_entry_once(P, dtype):
    """The kernel's epilogue: tile (i, j) writes H[r, c] for its r >= c
    (all of it below the diagonal) and the mirror H[c, r] for r > c."""
    plan = syrk_plan(1, P, dtype)
    t = plan.tile
    a, b = np.meshgrid(np.arange(t), np.arange(t), indexing="ij")
    writes = np.zeros((P + t, P + t), dtype=np.int8)
    for i, j in plan.tiles:
        r, c = i * t + a, j * t + b
        inside = (r < P) & (c < P)
        direct = inside & ((i != j) | (b <= a))
        mirror = inside & ((i != j) | (a > b))
        # no entry repeats within one tile's direct writes or its mirror
        writes[r[direct], c[direct]] += 1
        writes[c[mirror], r[mirror]] += 1
    assert (writes[:P, :P] == 1).all()
    assert writes[P:].sum() == 0 and writes[:, P:].sum() == 0


def _inputs(P, R):
    return np.random.default_rng(1000 * P + R).standard_normal((R, P))


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("P", PS[:-1])
def test_tiled_matches_plain(P, R):
    A = torch.as_tensor(_inputs(P, R))
    got, ref = syrk_tiled(A), syrk_plain(A)
    assert got.shape == (P, P)
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-12 * float(ref.abs().max()))
    assert torch.equal(got, got.mT)


@pytest.mark.parametrize("R", RS)
@pytest.mark.parametrize("P", PS[:-1])
def test_tiled_matches_jax_syrk_reference(P, R):
    A = _inputs(P, R)
    ref = np.asarray(syrk_reference(jnp.asarray(A)))
    got = syrk_tiled(torch.as_tensor(A))
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    assert torch.equal(got, got.mT)
