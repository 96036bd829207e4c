"""The port's pooled spectral divide-and-conquer (`ops/eigh_dc.py`) and the
eigensolver choices of `Kron.decompose` against the JAX package.

Both sides run on the same inputs with the JAX package's own fixed draws
(`jax.random.key(7)` for the Ritz probe, `key(20260816)` for the split
basis), passed to the port through `draws`, and the cases of each dtype
in one pooled call (one set of JAX compiles). Eigenvalues are compared at
1e-9 in float64 and 5e-4 in float32 (the JAX package's own float32 oracle,
`tests/test_eigh_dc.py`, absolute for spectra of norm ~1); eigenvectors only
through reconstruction and orthogonality, at the same tolerances, since the
signs of base-block vectors may differ.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.eigh_dc import eigh_pooled_dc as jax_eigh_pooled_dc
from laplace_jax_torch import KronLaplace
from laplace_jax_torch.models.resnet import ResNet18
from laplace_jax_torch.ops.eigh_dc import eigh_pooled_dc, eigh_stack_dc
from laplace_jax_torch.utils import matrix
from laplace_jax_torch.utils.data import ArrayLoader
from laplace_jax_torch.utils.matrix import Kron

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)


def jax_draws(kind, rows, cols, dtype, device):
    """The JAX package's draws for a bucket width (its `G_cache`)."""
    key = jax.random.key(7 if kind == "ritz" else 20260816)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return torch.tensor(np.asarray(jax.random.normal(key, (rows, cols), jdt)), device=device)


def _psd_stack(rng, k, n, decay=8.0, dtype=np.float64):
    Q = np.linalg.qr(rng.standard_normal((k, n, n)))[0]
    lam = np.exp(-np.linspace(0.0, decay, n))[None] * (1 + rng.random((k, n)))
    A = np.einsum("kij,kj,klj->kil", Q, lam, Q)
    return ((A + np.swapaxes(A, 1, 2)) / 2).astype(dtype)


def _indefinite(rng, k, n):
    A = rng.standard_normal((k, n, n))
    return (A + np.swapaxes(A, 1, 2)) / 2


def _check(A, vals, vecs, jax_vals, tol):
    vals, vecs = vals.double(), vecs.double()
    A = torch.as_tensor(A, dtype=torch.float64)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jax_vals, np.float64), atol=tol, rtol=0)
    torch.testing.assert_close(vecs @ torch.diag_embed(vals) @ vecs.mT, A, atol=tol, rtol=0)
    eye = torch.eye(A.shape[-1], dtype=torch.float64).expand_as(A)
    torch.testing.assert_close(vecs.mT @ vecs, eye, atol=tol, rtol=0)


def _multi_class():
    """`tests/test_eigh_dc.py::test_pooled_multi_class`: several shape classes."""
    rng = np.random.default_rng(7)
    return [_psd_stack(rng, 2, 300), _psd_stack(rng, 3, 200, decay=4.0), _psd_stack(rng, 1, 410)]


# the cases of `tests/test_eigh_dc.py`, by dtype
F64_CASES = {
    "psd-f64-3x300": lambda: [_psd_stack(np.random.default_rng(0), 3, 300)],
    "indefinite-2x400": lambda: [_indefinite(np.random.default_rng(1), 2, 400)],
    "multi-class": _multi_class,
}
F32_CASES = {"psd-f32-2x384": lambda: [_psd_stack(np.random.default_rng(2), 2, 384, 6.0,
                                                  np.float32)]}
TOL = {np.float64: 1e-9, np.float32: 5e-4}


@pytest.fixture(scope="module")
def pooled():
    """Every case of one dtype through one pooled call of each package, the
    JAX package's draws passed to the port: case -> [(A, port (vals, vecs),
    JAX vals)]. One JAX call per dtype compiles each level's shapes once;
    the split quantile adapts over the whole pool on both sides alike."""
    out = {}
    for cases in (F64_CASES, F32_CASES):
        made = {name: make() for name, make in cases.items()}
        stacks = [A for As in made.values() for A in As]
        ref = jax_eigh_pooled_dc([jnp.asarray(A) for A in stacks], termination_size=128)
        got = eigh_pooled_dc([torch.as_tensor(A) for A in stacks], termination_size=128,
                             device="cpu", draws=jax_draws)
        i = 0
        for name, As in made.items():
            out[name] = [(A, got[i + t], ref[i + t][0]) for t, A in enumerate(As)]
            i += len(As)
    return out


@pytest.mark.parametrize("case", [*F64_CASES, *F32_CASES])
def test_eigh_pooled_dc_matches_jax(pooled, case):
    for A, (vals, vecs), jax_vals in pooled[case]:
        assert vals.dtype == torch.as_tensor(A).dtype
        _check(A, vals, vecs, jax_vals, TOL[A.dtype.type])


@pytest.mark.parametrize("case", ["psd-f64-3x300", "indefinite-2x400", "psd-f32-2x384"])
def test_eigh_stack_dc_matches_jax(pooled, case):
    """`eigh_stack_dc` on the stack alone, against the JAX package's
    eigenvalues of it from the pooled call."""
    [(A, _, jax_vals)] = pooled[case]
    vals, vecs = eigh_stack_dc(torch.as_tensor(A), termination_size=128, device="cpu",
                               draws=jax_draws)
    assert vals.dtype == torch.as_tensor(A).dtype
    _check(A, vals, vecs, jax_vals, TOL[A.dtype.type])


def test_float32_kfac_factors_come_back_accurate():
    """The D&C of float32 stacks, on two 576 x 576 Kronecker factors of a
    width-16 ResNet-18 fit (16 inputs), against float64 `eigvalsh`:
    eigenvalues and reconstruction within 1e-6 of the largest (they read
    4e-8 and 9e-8). Computed in float32, as the JAX package computes
    float32 stacks, the algorithm misses both bounds by orders of
    magnitude on such factors (a dominant eigenvalue; `ops/eigh_dc.py`)."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((16, 16, 16, 3)).astype(np.float32)
    y = rng.integers(0, 10, 16)
    net = ResNet18(width=16, num_classes=10, generator=torch.Generator().manual_seed(0))
    la = KronLaplace(net, "classification", device="cpu")
    la.fit(ArrayLoader(X, y, batch_size=16))
    S = torch.stack([H for F in la.H_facs.kfacs for H in F if H.shape[0] == 576][:2])
    S = (S + S.mT) / 2
    assert S.dtype == torch.float32 and S.shape == (2, 576, 576)
    [(vals, vecs)] = eigh_pooled_dc([S], device="cpu")
    assert vals.dtype == vecs.dtype == torch.float32
    Sd, vals, vecs = S.double(), vals.double(), vecs.double()
    ref = torch.linalg.eigvalsh(Sd)
    assert float(((vals - ref).abs().amax(1) / ref.abs().amax(1)).max()) <= 1e-6
    R = vecs @ torch.diag_embed(vals) @ vecs.mT
    assert float(((R - Sd).abs().amax((1, 2)) / Sd.abs().amax((1, 2))).max()) <= 1e-6


def test_default_draws_are_fixed():
    """Without `draws` the fixed CPU generators make every call alike."""
    A = torch.as_tensor(_psd_stack(np.random.default_rng(3), 1, 260))
    (v1, Q1), (v2, Q2) = (eigh_stack_dc(A, termination_size=128, device="cpu") for _ in range(2))
    assert torch.equal(v1, v2) and torch.equal(Q1, Q2)
    _check(A.numpy(), v1, Q1, np.linalg.eigvalsh(A.numpy()), 1e-9)


def test_small_stack_takes_eigh():
    A = torch.as_tensor(_psd_stack(np.random.default_rng(4), 4, 64))
    vals, vecs = eigh_stack_dc(A, termination_size=128, device="cpu")
    _check(A.numpy(), vals, vecs, np.linalg.eigvalsh(A.numpy()), 1e-10)


def _kron(seed):
    """Factor groups of sizes 300 x 20, 64 x 20 and one dense 300 block."""
    rng = np.random.default_rng(seed)
    t = lambda n, decay=8.0: torch.as_tensor(_psd_stack(rng, 1, n, decay)[0])  # noqa: E731
    return Kron([(t(300), t(20, 2.0)), (t(64), t(20, 2.0)), (t(300, 4.0),)])


def test_decompose_dc_matches_default_route(monkeypatch):
    """`EIGH_IMPLEMENTATION = "dc"` with the CUDA-only gate opened on the
    CPU (as `tests/test_ts_budget.py` opens `_use_ts`): every class goes
    through one pooled D&C call and gives the default route's
    eigenvalues."""
    kron = _kron(5)
    ref = kron.decompose()
    calls = []
    real = matrix.eigh_pooled_dc

    def pooled(stacks, **kw):
        calls.append([tuple(s.shape) for s in stacks])
        return real(stacks, **kw)

    monkeypatch.setattr(matrix, "EIGH_IMPLEMENTATION", "dc")
    monkeypatch.setattr(matrix, "_use_dc", lambda stack: True)
    monkeypatch.setattr(matrix, "eigh_pooled_dc", pooled)
    retries = matrix.SYMEIG_RETRIES
    got = kron.decompose()
    assert matrix.SYMEIG_RETRIES == retries
    assert calls == [[(2, 300, 300), (2, 20, 20), (1, 64, 64)]]
    for ls_g, ls_r in zip(got.eigenvalues, ref.eigenvalues):
        for g, r in zip(ls_g, ls_r):
            torch.testing.assert_close(g, r, atol=1e-9, rtol=0)
    torch.testing.assert_close(got.logdet(), ref.logdet(), atol=1e-9, rtol=1e-12)


def test_dc_gate_is_cuda_only(monkeypatch):
    monkeypatch.setattr(matrix, "EIGH_IMPLEMENTATION", "dc")
    assert not matrix._use_dc(torch.zeros(2, 512, 512))
    assert not matrix._use_ts(torch.zeros(2, 512, 512))


@pytest.mark.parametrize("impl", ["qdwh", "jacobi", "lapack"])
def test_decompose_rejects_solvers_the_port_lacks(monkeypatch, impl):
    monkeypatch.setattr(matrix, "EIGH_IMPLEMENTATION", impl)
    with pytest.raises(ValueError, match="XLA" if impl != "lapack" else "Unknown"):
        _kron(6).decompose()
