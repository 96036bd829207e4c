"""The port's `syrk` (CPU route: its plain version) against the JAX
package's `syrk` / `syrk_reference`, and the dense helpers around it
(`invsqrt_precision`, `normal_samples`) against `laplace_jax.utils.linalg`.

The JAX `syrk` takes its einsum route on the CPU, as in the JAX package's
own tests (`tests/test_linalg_utils.py:116`). float64; tolerance 1e-12
relative to the largest entry. The CUDA kernel is held against
`syrk_plain` on the card in `tests/test_torch_cuda_kernels.py`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.syrk import syrk as jax_syrk
from laplace_jax.ops.syrk import syrk_reference
from laplace_jax.utils.linalg import invsqrt_precision as jax_invsqrt_precision
from laplace_jax.utils.linalg import normal_samples as jax_normal_samples
from laplace_jax_torch.ops import _build
from laplace_jax_torch.ops.syrk import syrk, syrk_plain
from laplace_jax_torch.utils.linalg import (
    invsqrt_precision,
    normal_samples,
    normal_samples_from,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("shape", [(64, 256), (37, 130), (1, 1)], ids=str)
def test_syrk_matches_jax(shape):
    A = np.random.default_rng(4).standard_normal(shape)
    ref = np.asarray(syrk_reference(jnp.asarray(A)))
    np.testing.assert_allclose(np.asarray(jax_syrk(jnp.asarray(A))), ref, rtol=0, atol=1e-12)
    launches = syrk.launches
    for got in (syrk_plain(torch.as_tensor(A)), syrk(torch.as_tensor(A))):
        assert got.shape == (shape[1], shape[1])
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12 * np.abs(ref).max())
        assert torch.equal(got, got.mT)
    assert syrk.launches == launches  # the CPU route launches nothing


def test_every_source_declares_its_entry_points():
    """`_build.load` binds each library by its own signature table; the
    row-run panels (latrd, latrd_v2) declare theirs through the export
    macro of `csrc/latrd_panel.cuh`."""
    assert set(_build.SOURCES) == {"latrd", "latrd_v4", "latrd_v3", "latrd_v2", "syrk",
                                   "jacobi_leaves", "secular"}
    assert set(_build.SIGNATURES["syrk"]) == {"syrk_f32", "syrk_f64", "syrk_geometry"}
    assert set(_build.SIGNATURES["jacobi_leaves"]) == {"jacobi_leaves_f32", "jacobi_leaves_f64"}
    assert set(_build.SIGNATURES["secular"]) == {"secular_f64"}
    header = (_build.CSRC / "latrd_panel.cuh").read_text()
    macro = header[header.index("#define LATRD_ROWS_EXPORTS"):]
    for name in _build.SOURCES:
        assert (_build.CSRC / f"{name}.cu").is_file()
        src = (_build.CSRC / f"{name}.cu").read_text()
        for fn in _build.SIGNATURES[name]:
            assert fn in src or ("LATRD_ROWS_EXPORTS(" in src and f" {fn}(" in macro)


def _spd(n, seed):
    A = np.random.default_rng(seed).standard_normal((n, n))
    return A @ A.T + n * np.eye(n)


def test_invsqrt_precision_matches_jax():
    M = _spd(40, 5)
    ref = np.asarray(jax_invsqrt_precision(jnp.asarray(M)))
    got = invsqrt_precision(torch.as_tensor(M)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(got @ got.T, np.linalg.inv(M), rtol=0, atol=1e-12)
    assert np.allclose(got, np.tril(got))


@pytest.mark.parametrize("full", [False, True], ids=["diag", "full"])
def test_normal_samples_from_same_draws(full):
    rng = np.random.default_rng(6)
    mean = rng.standard_normal((3, 4))
    var = np.stack([_spd(4, s) for s in range(3)]) if full else rng.random((3, 4)) + 0.1
    key = jax.random.key(3)
    ref = np.asarray(jax_normal_samples(jnp.asarray(mean), jnp.asarray(var), 5, key))
    randn = np.array(jax.random.normal(key, (4, 5), dtype=jnp.float64))
    got = normal_samples_from(torch.as_tensor(mean), torch.as_tensor(var), torch.as_tensor(randn))
    assert got.shape == (5, 3, 4)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-12)
    with pytest.raises(ValueError):
        normal_samples_from(torch.as_tensor(mean), torch.as_tensor(var[:2]), torch.as_tensor(randn))


def test_normal_samples_uses_the_generator():
    mean, var = torch.zeros(2, 3, dtype=torch.float64), torch.ones(2, 3, dtype=torch.float64)
    a = normal_samples(mean, var, 4, torch.Generator().manual_seed(0))
    randn = torch.randn(3, 4, generator=torch.Generator().manual_seed(0), dtype=torch.float64)
    torch.testing.assert_close(a, normal_samples_from(mean, var, randn), rtol=0, atol=0)
