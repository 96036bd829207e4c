"""The port's stage 2 (`tridiag_eigh`), the two-stage driver
`eigh_stack_ts` and `Kron.decompose`'s dispatch, against the JAX package.

Eigenvalues agree to 1e-9 (relative to the spectrum's scale) in float64:
both sides run the same D&C, so the only differences are rounding.
Eigenvectors are compared by reconstruction and orthogonality, not
element-wise (signs and bases of clusters are free).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.tridiag_eig import eigh_stack_ts as jax_eigh_stack_ts
from laplace_jax.ops.tridiag_eig import tridiag_eigh as jax_tridiag_eigh
from laplace_jax_torch.ops import tridiag_eig as te
from laplace_jax_torch.ops.tridiag_eig import (
    _merge_level,
    _round_robin_pair,
    _round_robin_schedule,
    eigh_stack_ts,
    tridiag_eigh,
)
from laplace_jax_torch.utils import matrix
from laplace_jax_torch.utils.linalg import symeig
from laplace_jax_torch.utils.matrix import Kron

from .torch_merges import deflating_merge, qr_polish

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)


def _sym(seed, K, n, psd=False):
    rng = np.random.default_rng(seed)
    if psd:  # KFAC-like decaying spectrum with a near-degenerate tail
        Q = np.linalg.qr(rng.standard_normal((K, n, n)))[0]
        lam = np.exp(-np.linspace(0.0, 12.0, n))[None] * (1 + rng.random((K, n)))
        A = np.einsum("kij,kj,klj->kil", Q, lam, Q)
    else:
        A = rng.standard_normal((K, n, n))
    return (A + A.transpose(0, 2, 1)) / 2


def _check_pairs(A, lam, vecs, lam_ref, tol):
    A, lam, vecs = (torch.as_tensor(np.asarray(t), dtype=torch.float64) for t in (A, lam, vecs))
    scale = float(lam.abs().max())
    np.testing.assert_allclose(lam.numpy(), np.asarray(lam_ref), rtol=0, atol=tol * scale)
    rec = vecs @ torch.diag_embed(lam) @ vecs.mT
    assert float((rec - A).norm() / A.norm()) < 1e3 * tol
    eye = torch.eye(A.shape[-1], dtype=A.dtype)
    assert float((vecs.mT @ vecs - eye).abs().max()) < 1e3 * tol


@pytest.mark.parametrize("m", range(2, 50, 2))
def test_closed_form_pairs_are_the_round_robin_schedule(m):
    """The leaves' kernel computes its pairs from (round, slot) with the
    formula of `_round_robin_pair`: the plain schedule's pairs, slot for
    slot; each pair once over the rounds, disjoint within a round."""
    sched = _round_robin_schedule(m)
    got = [[_round_robin_pair(m, r, i) for i in range(m // 2)] for r in range(m - 1)]
    assert got == [[tuple(map(int, pq)) for pq in rnd] for rnd in sched]
    pairs = [pq for rnd in got for pq in rnd]
    assert len(set(pairs)) == len(pairs) == m * (m - 1) // 2
    assert all(len({x for pq in rnd for x in pq}) == m for rnd in got)


@pytest.mark.parametrize("n", [40, 130])
def test_tridiag_eigh_matches_jax(n):
    rng = np.random.default_rng(n)
    d, e = rng.standard_normal((2, n)), rng.standard_normal((2, n - 1))
    lam_j, U_j = jax_tridiag_eigh(jnp.asarray(d), jnp.asarray(e))
    lam, U = tridiag_eigh(torch.as_tensor(d), torch.as_tensor(e))
    T = np.stack([np.diag(d[k]) + np.diag(e[k], 1) + np.diag(e[k], -1) for k in range(2)])
    _check_pairs(T, lam, U, lam_j, 1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tridiag_eigh_in_chunks_is_the_whole_stack(monkeypatch, dtype):
    """A stack merged in chunks (a `MERGE_CHUNK_BYTES` that holds two
    130-row tridiagonals, padded to 132) gives each tridiagonal's result of
    the whole stack."""
    rng = np.random.default_rng(5)
    d = torch.as_tensor(rng.standard_normal((5, 130)), dtype=dtype)
    e = torch.as_tensor(rng.standard_normal((5, 129)), dtype=dtype)
    lam, U = tridiag_eigh(d, e)
    monkeypatch.setattr(te, "MERGE_CHUNK_BYTES", 2 * 8 * 132 ** 2)
    calls = []
    monkeypatch.setattr(te, "_merge_level", lambda D, *a: calls.append(D.shape[0])
                        or _merge_level(D, *a))
    lam_c, U_c = tridiag_eigh(d, e)
    assert calls == [4, 2, 4, 2, 2, 1]  # chunks of 2, 2, 1; 2 levels each (leaves of 33)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(lam_c, lam, rtol=0, atol=tol)
    torch.testing.assert_close(U_c, U, rtol=0, atol=tol)


@pytest.mark.parametrize("psd", [False, True], ids=["gaussian", "psd"])
@pytest.mark.parametrize("stage1", ["plain", "latrd", "latrd_v4"])
def test_eigh_stack_ts_matches_jax(stage1, psd):
    A = _sym(7, 2, 130, psd)
    lam_j, _ = jax_eigh_stack_ts(jnp.asarray(A), nb=16, stage1="xla")
    lam, vecs = eigh_stack_ts(torch.as_tensor(A), nb=16, stage1=stage1, device="cpu")
    _check_pairs(A, lam, vecs, lam_j, 1e-9)


def test_eigh_stack_ts_float32_polished():
    """float32 runs through the polish (`_orthonormalize`: one Newton-Schulz
    step on a float64 Gram, where the JAX package applies CholeskyQR2);
    eigenvalues within n * eps32 * ||A|| (~1e-5 at n = 100)."""
    A = _sym(8, 2, 100, psd=True).astype(np.float32)
    lam, vecs = eigh_stack_ts(torch.as_tensor(A), nb=16, device="cpu")
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    _check_pairs(A, lam, vecs, ref, 1e-5)


def test_float32_rank_deficient_spectrum():
    """A KFAC-like factor with a large cluster of numerically-zero
    eigenvalues: merges that solve in float32, as the JAX package's do,
    duplicate vectors inside the cluster, where its CholeskyQR2 finds no
    Cholesky factor; the port's merges solve in float64, leave no
    duplicate, and its Newton-Schulz polish returns an orthonormal basis
    and accurate pairs."""
    X = np.maximum(np.random.default_rng(10).standard_normal((2, 40, 256)), 0)
    A = np.einsum("kri,krj->kij", X, X).astype(np.float32) / 40
    lam, vecs = eigh_stack_ts(torch.as_tensor(A), nb=16, device="cpu")
    ref = np.linalg.eigvalsh(A.astype(np.float64))
    _check_pairs(A, lam, vecs, ref, 1e-5)


def _stage2_data():
    data = np.load(Path(__file__).parent / "data" / "stage2_float32_tridiagonal.npz")
    return torch.as_tensor(data["d"])[None], torch.as_tensor(data["e"])[None]


def _assert_stage2_data_solved(d, e, lam, vecs):
    """Eigenvalues, reconstruction and orthogonality of the float32
    tridiagonal's solution within 1e-5 (float64 merges read about 5e-6)."""
    T = torch.diag_embed(d.double()) + torch.diag_embed(e.double(), 1) \
        + torch.diag_embed(e.double(), -1)
    ref = torch.linalg.eigvalsh(T)
    assert lam.dtype == vecs.dtype == torch.float32
    lam, vecs = lam.double(), vecs.double()
    eig = float((lam - ref).abs().max() / ref.abs().max())
    recon = float(torch.linalg.matrix_norm(vecs @ torch.diag_embed(lam) @ vecs.mT - T)
                  / torch.linalg.matrix_norm(T))
    orth = float((vecs.mT @ vecs - torch.eye(T.shape[-1], dtype=torch.float64)).abs().max())
    assert eig < 1e-5 and recon < 1e-5 and orth < 1e-5, (eig, recon, orth)


def test_float32_merges_solve_the_secular_equation_in_float64():
    """A float32 tridiagonal (n = 2304, `band_to_tridiag` of a random
    Wishart matrix on the card) on which float32 merges settled the root
    near 2.0015 off by 1.5e-4, and its vector with it: eigenvalues 3.6e-5
    and reconstruction 2.8e-4 off, against 5e-6 and 4e-6 on its three
    siblings. Float32 merges now solve in float64."""
    d, e = _stage2_data()
    _assert_stage2_data_solved(d, e, *tridiag_eigh(d, e))


def _orth(V):
    V = V.double()
    return float((V.mT @ V - torch.eye(V.shape[-1], dtype=torch.float64)).abs().max())


def _rank_deficient(seed, n, rows):
    """Two KFAC-like float32 factors of rank at most `rows` (the Grams of
    ReLU features), as in `test_float32_rank_deficient_spectrum`."""
    X = np.maximum(np.random.default_rng(seed).standard_normal((2, rows, n)), 0)
    return torch.as_tensor(np.einsum("kri,krj->kij", X, X).astype(np.float32) / rows)


@pytest.mark.parametrize("case", ["rank-deficient-256", "rank-deficient-1024", "stage2-data"])
def test_float32_polish_is_no_worse_than_qr(monkeypatch, case):
    """The polish of stage 2's float32 vectors (about 6e-6 from orthonormal
    before it) leaves max |VᵀV - I| within 1e-6 and no larger than the
    Householder-QR polish of the same vectors, keeps each column within
    1e-5 of the QR's (order and signs kept). On the rank-deficient factors,
    `eigh_stack_ts`'s eigenpairs with either polish pass `_check_pairs` at
    float32's 1e-5 and agree within 1e-5."""
    seen = {}
    real, real_apply_q = te._orthonormalize, te.apply_q

    def both(V):
        seen["V"], seen["qr"] = V.clone(), qr_polish(V)
        seen["step"] = real(V)
        return seen["step"]

    def apply_both(V, taus, Ut, nb):
        seen["Q_qr"] = real_apply_q(V, taus, seen["qr"], nb=nb)
        return real_apply_q(V, taus, Ut, nb=nb)

    monkeypatch.setattr(te, "_orthonormalize", both)
    monkeypatch.setattr(te, "apply_q", apply_both)
    if case == "stage2-data":
        tridiag_eigh(*_stage2_data())
    else:
        n = int(case.rsplit("-", 1)[1])
        A = _rank_deficient(10, n, {256: 40, 1024: 300}[n])
        lam, Q = eigh_stack_ts(A, nb=16, device="cpu")
        ref = np.linalg.eigvalsh(A.numpy().astype(np.float64))
        _check_pairs(A.numpy(), lam, Q, ref, 1e-5)
        _check_pairs(A.numpy(), lam, seen["Q_qr"], ref, 1e-5)
        assert float((Q - seen["Q_qr"]).abs().max()) < 1e-5
    V, step, qr = seen["V"], seen["step"], seen["qr"]
    assert V.dtype == step.dtype == torch.float32
    before, got, ref_qr = _orth(V), _orth(step), _orth(qr)
    assert got <= 1e-6 and got <= ref_qr < before, (before, got, ref_qr)
    assert float((step - qr).abs().max()) < 1e-5


def test_polish_returns_nan_for_a_basis_with_equal_columns():
    """A factor whose basis repeats a column (max |VᵀV - I| about 1) leaves
    the polish as NaN, and only that factor; the others come back
    orthonormal."""
    rng = np.random.default_rng(3)
    V = torch.as_tensor(np.linalg.qr(rng.standard_normal((3, 64, 64)))[0], dtype=torch.float32)
    V[1, :, 5] = V[1, :, 6]
    out = te._orthonormalize(V)
    assert bool(out[1].isnan().all())
    assert bool(out[[0, 2]].isfinite().all())
    assert _orth(out[[0, 2]]) <= 1e-6


def test_decompose_retries_the_factor_the_polish_refuses(monkeypatch):
    """With the two-stage gate opened on the CPU for n >= 64, a float32
    basis given two equal columns in one factor of a class before the
    polish sends that factor, and only that one, through the `symeig`
    retry: `SYMEIG_RETRIES` rises by one, the retried factor's pairs are
    `symeig`'s, and every factor is reconstructed within float32's
    tolerance."""
    facs = [torch.as_tensor(_sym(s, 1, 80, psd=True)[0], dtype=torch.float32) for s in range(3)]
    H = Kron([(facs[0], facs[1]), (facs[2],)])  # one class of three 80 x 80 factors
    real = te._orthonormalize

    def duplicate_in_second(V):
        V = V.clone()
        V[1, :, 7] = V[1, :, 8]
        return real(V)

    monkeypatch.setattr(matrix, "_use_ts", lambda stack: stack.shape[-1] >= 64)
    monkeypatch.setattr(te, "_orthonormalize", duplicate_in_second)
    before = matrix.SYMEIG_RETRIES
    dec = H.decompose()
    assert matrix.SYMEIG_RETRIES == before + 1
    l_ret, Q_ret = symeig(facs[1])
    torch.testing.assert_close(dec.eigenvalues[0][1], l_ret, atol=0, rtol=0)
    torch.testing.assert_close(dec.eigenvectors[0][1], Q_ret, atol=0, rtol=0)
    for Qs, ls, F in zip(dec.eigenvectors, dec.eigenvalues, H.kfacs):
        for Q, l, M in zip(Qs, ls, F):
            assert bool(Q.isfinite().all())
            scale = float(M.abs().max())
            torch.testing.assert_close(Q @ torch.diag(l) @ Q.T, M, atol=1e-5 * scale, rtol=0)


def _check_secular_solve(args, out):
    """Each active root's mu lies in its bracket, [-gap/2, 0] from the upper
    pole or [0, gap/2] (all of the gap above the last active pole) from its
    own; and |f(mu)| is no larger than the bisection leaves it: the slope
    times the last bracket's width (gap / 2**40), plus rounding. Returns the
    roots checked."""
    ds, z2, rho, gap, nxt, tiny = args
    mu, origin = out
    B, M = ds.shape
    iota = torch.arange(M)
    assert mu.dtype == torch.float64 and origin.dtype == torch.int64
    use_up = origin != iota
    assert bool((origin[use_up] == nxt[use_up]).all())
    has_up = nxt < M
    lo = torch.where(use_up, -0.5 * gap, 0.0)
    hi = torch.where(use_up, 0.0, torch.where(has_up, 0.5 * gap, gap))
    active = z2 > 0
    assert bool(((mu >= lo) & (mu <= hi))[active].all())

    d_o = torch.gather(ds, 1, origin)
    denom = (ds[:, :, None] - d_o[:, None, :]) - mu[:, None, :]
    denom = torch.where(denom == 0, tiny, denom)
    t1 = torch.where(z2[:, :, None] > 0, rho[:, None, None] * z2[:, :, None] / denom, 0.0)
    f = 1.0 + t1.sum(1)
    slope = (t1 / denom).sum(1)
    eps = torch.finfo(torch.float64).eps
    level = slope * gap * 2.0 ** -40 + 8 * M * eps * (1.0 + t1.abs().sum(1))
    assert bool((f.abs() <= level)[active].all()), float((f.abs() / level)[active].max())
    return int(active.sum())


@pytest.mark.parametrize("case", ["m64-float64", "m64-float32", "m88-float64", "m88-float32",
                                  "m2048-float64", "m2048-float32", "stage2-data"])
def test_secular_plain_solves_every_merge(monkeypatch, case):
    """`_secular_plain`, the solve that `_merge_level` runs on the CPU and
    that the card's kernel (`csrc/secular.cu`) is held to: on merges with
    tied poles, zero-z deflation and a run whose survivor deflates, float32
    and float64 merges (both solve in float64), each active root in its
    bracket and |f(mu)| at the bisection's level. The float32 tridiagonal of
    `tests/data/stage2_float32_tridiagonal.npz` (six levels, M = 72 to
    2304) still solves to its limits."""
    seen = []
    real = te._secular

    def record(*args):
        out = real(*args)
        seen.append((args, out))
        return out

    if case == "stage2-data":
        d, e = _stage2_data()
        run = lambda: tridiag_eigh(d, e)  # noqa: E731
    else:
        M, dtype = int(case.split("-")[0][1:]), getattr(torch, case.split("-")[1])
        inputs = deflating_merge({64: 8, 88: 4, 2048: 1}[M], M, dtype, seed=M)
        run = lambda: _merge_level(*inputs)  # noqa: E731
    monkeypatch.setattr(te, "_secular", record)
    got = run()
    assert seen and all(args[0].dtype == torch.float64 for args, _ in seen)
    checked = sum(_check_secular_solve(args, out) for args, out in seen)
    assert checked > 0
    if case == "stage2-data":
        assert [args[0].shape[1] for args, _ in seen] == [72, 144, 288, 576, 1152, 2304]
        _assert_stage2_data_solved(d, e, *got)
    else:
        ds, z2 = seen[0][0][:2]
        assert bool((z2 == 0).any(1).all())  # every merge deflates
        assert bool(((ds[:, 1:] == ds[:, :-1]) & (z2[:, 1:] == 0)).any(1).all())


def test_entry_points_need_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        eigh_stack_ts(torch.eye(3)[None])


def test_decompose_cpu_uses_eigh_and_counts_retries(monkeypatch):
    facs = [torch.as_tensor(_sym(s, 1, 6, psd=True)[0]) for s in range(3)]
    H = Kron([(facs[0], facs[1]), (facs[2],)])
    dec = H.decompose()
    for Qs, ls, F in zip(dec.eigenvectors, dec.eigenvalues, H.kfacs):
        for Q, l, M in zip(Qs, ls, F):
            torch.testing.assert_close(Q @ torch.diag(l) @ Q.T, M, atol=1e-12, rtol=0)
    # a NaN from the batched solver sends that factor through the retry
    real_eigh = torch.linalg.eigh

    def nan_once(M):
        L, W = real_eigh(M)
        return (L * np.nan, W) if M.ndim == 3 and M.shape[-1] == 6 else (L, W)

    monkeypatch.setattr(torch.linalg, "eigh", nan_once)
    before = matrix.SYMEIG_RETRIES
    dec = H.decompose()
    assert matrix.SYMEIG_RETRIES == before + 3
    assert all(torch.isfinite(l).all() for ls in dec.eigenvalues for l in ls)
