"""An exactly diagonal window with tied and zero entries through the v4
stage 1 and both two-stage solvers, on the CPU in float64: the Embed's
activation factor `diag(token counts) / (N T)` of the reward transformer's
all-weights KFAC fit, at a reduced size (n = 256 ids, 2048 tokens drawn
over the first 240 of them: Poisson(8.5) counts, ties in the dozens and 16
zero counts).

- The port's plain v4 panels (`tridiagonalize_latrd_v4` on the CPU) and
  the JAX package's `tridiagonalize_pallas_v4` in interpret mode: every
  reflector trivial (tau = 0), the tridiagonal's diagonal the matrix's own
  and its off-diagonal exactly zero, no NaN.
- The port's `eigh_stack_ts(stage1="latrd_v4")` and its stage 2 alone
  (`tridiag_eigh` of the diagonal with a zero off-diagonal): the
  eigenvalues equal the sorted diagonal (1e-12 relative), the
  reconstruction Q Λ Qᵀ the matrix and QᵀQ the identity (1e-12). Raw
  eigenvectors of a tied cluster are not compared: any basis of it is
  right.
- The JAX package's stage 2 (`tridiag_eigh`, `apply_q`) on its
  interpret-mode stage 1 gives the same eigenvalues. Its eigenvectors are
  not held: where a merge deflates a run of tied poles whose z weight is
  not on the run's last pole (rho = 0 here), it returns the last pole's
  unit vector for the run's survivor, a column one of the run's other
  columns already holds, so QᵀQ is not the identity there (12 entries of
  Q Λ Qᵀ off by up to 0.0063 at this seed). The port's merge leaves such
  a run unrotated, each pole with its own vector
  (`ops/tridiag_eig._merge_level`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.latrd_pallas_v4 import tridiagonalize_pallas_v4
from laplace_jax.ops.tridiag import apply_q as jax_apply_q
from laplace_jax.ops.tridiag_eig import tridiag_eigh as jax_tridiag_eigh
from laplace_jax_torch.ops.latrd_v4 import tridiagonalize_latrd_v4
from laplace_jax_torch.ops.tridiag_eig import eigh_stack_ts, tridiag_eigh

torch.set_num_threads(1)

N_IDS, TOKENS, USED, NB, TOL = 256, 2048, 240, 16, 1e-12


@pytest.fixture(scope="module")
def window():
    ids = np.random.default_rng(0).integers(0, USED, size=TOKENS)
    counts = np.bincount(ids, minlength=N_IDS).astype(np.float64)
    assert (counts == 0).sum() >= N_IDS - USED
    assert np.bincount(counts.astype(int)).max() >= 20  # ties in the dozens
    return np.diag(counts / TOKENS)[None]


def test_stage1_reflectors_are_trivial(window):
    d, e, V, taus = tridiagonalize_latrd_v4(torch.as_tensor(window), nb=NB)
    dj, ej, Vj, tj = tridiagonalize_pallas_v4(jnp.asarray(window), nb=NB, interpret=True)
    for t in (d, e, V, taus):
        assert torch.isfinite(t).all()
    assert float(taus.abs().max()) == 0.0 and float(np.abs(np.asarray(tj)).max()) == 0.0
    assert float(e.abs().max()) == 0.0 and float(np.abs(np.asarray(ej)).max()) == 0.0
    np.testing.assert_array_equal(d[0].numpy(), np.diag(window[0]))
    np.testing.assert_array_equal(np.asarray(dj)[0, :N_IDS], np.diag(window[0]))


def _check(lam, Q, A):
    lam, Q = np.asarray(lam)[0], np.asarray(Q)[0]
    assert np.isfinite(lam).all() and np.isfinite(Q).all()
    scale = np.abs(A).max()
    np.testing.assert_allclose(lam, np.sort(np.diag(A)), rtol=0, atol=TOL * scale)
    np.testing.assert_allclose((Q * lam) @ Q.T, A, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(Q.T @ Q, np.eye(len(lam)), rtol=0, atol=TOL)


def test_two_stage_solver_gives_the_sorted_diagonal(window):
    lam, Q = eigh_stack_ts(torch.as_tensor(window), nb=NB, stage1="latrd_v4", device="cpu")
    _check(lam, Q, window[0])


def test_stage2_deflates_tied_runs_with_zero_rho(window):
    d = torch.as_tensor(np.diag(window[0]))[None]
    lam, Q = tridiag_eigh(d, torch.zeros(1, d.shape[1] - 1, dtype=d.dtype))
    _check(lam, Q, window[0])


def test_jax_two_stage_solver_gives_the_same_spectrum(window):
    d, e, V, taus = tridiagonalize_pallas_v4(jnp.asarray(window), nb=NB, interpret=True)
    lam_j, Ut = jax_tridiag_eigh(d, e)
    Q = np.asarray(jax_apply_q(V[:, :N_IDS, :N_IDS], taus, Ut, nb=NB))
    lam, _ = eigh_stack_ts(torch.as_tensor(window), nb=NB, stage1="latrd_v4", device="cpu")
    np.testing.assert_allclose(np.asarray(lam_j)[0], lam[0].numpy(), rtol=0,
                               atol=TOL * np.abs(window).max())
    assert np.isfinite(Q).all()
