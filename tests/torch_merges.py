"""Stage-2 merges with deflation of every kind and the secular solve's
arguments for them, for the tests of the solve on the CPU
(`test_torch_tridiag_eig.py`) and on the card (`test_torch_cuda_kernels.py`)
and `chip_smoke.py`'s `secular` phase; and the Householder-QR polish that
both test files hold stage 2's float32 polish to. It imports no JAX."""

import numpy as np
import torch


def deflating_merge(B, M, dtype, seed, device="cpu"):
    """`_merge_level`'s inputs (D, U, rho, z) for B merges of two children's
    spectra of M / 2 each (each sorted, z a unit vector on each), U the
    identity, with a tied pair of poles in each child, a near tie (one ulp
    apart), a zero z in each child, and a run of three tied poles whose z is
    0 throughout, so that its survivor deflates."""
    rng = np.random.default_rng(seed)
    h = M // 2
    D = np.sort(rng.standard_normal((B, 2, h)), axis=-1)
    z = rng.standard_normal((B, 2, h))
    z /= np.linalg.norm(z, axis=-1, keepdims=True)
    D[:, :, 3] = D[:, :, 2]
    D[:, 1, 15] = np.nextafter(D[:, 1, 14], np.inf)
    z[:, 0, 5] = z[:, 1, 8] = 0.0
    D[:, 0, 20:23] = D[:, 0, 20:21]
    z[:, 0, 20:23] = 0.0
    rho = np.abs(rng.standard_normal(B)) + 0.1

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    U = torch.eye(M, dtype=dtype, device=device).expand(B, M, M)
    return tensor(D.reshape(B, M)), U, tensor(rho), tensor(z.reshape(B, M))


class _Recorded(Exception):
    pass


def secular_args(D, U, rho, z):
    """The arguments (ds, z2, rho, gap, nxt, tiny) that `_merge_level`
    hands `ops/tridiag_eig._secular` for the merge (D, U, rho, z); the merge
    stops there."""
    from laplace_jax_torch.ops import tridiag_eig as te

    seen = []

    def record(*args):
        seen.append(args)
        raise _Recorded

    real = te._secular
    te._secular = record
    try:
        te._merge_level(D, U, rho, z)
    except _Recorded:
        pass
    finally:
        te._secular = real
    return seen[0]


def secular_f(ds, z2, rho, d_o, mu, tiny):
    """f at lambda = d_o + mu for each root, and sum |rho z2 / denom|, by
    `_secular_plain`'s formula."""
    denom = (ds[:, :, None] - d_o[:, None, :]) - mu[:, None, :]
    denom = torch.where(denom == 0, tiny, denom)
    t1 = torch.where(z2[:, :, None] > 0, rho[:, None, None] * z2[:, :, None] / denom, 0.0)
    return 1.0 + t1.sum(1), t1.abs().sum(1)


def secular_against_plain(args, out, plain):
    """How far a solve `out` = (mu, origin) of the arguments `args` is from
    the plain solve's `plain`, over every active root: (the worst root's
    distance over its gap, the roots whose origin differs although f at
    mid-gap is not within rounding of 0). Where the origins differ, the
    roots lambda = d_origin + mu are compared, less their rounding."""
    ds, z2, rho, gap, nxt, tiny = args
    (mu, origin), (mu_p, origin_p) = out, plain
    M = ds.shape[1]
    active = z2 > 0
    eps = torch.finfo(torch.float64).eps
    f_mid, scale = secular_f(ds, z2, rho, ds, 0.5 * gap, tiny)
    near_zero = f_mid.abs() <= 8 * M * eps * (1.0 + scale)
    same = origin == origin_p
    stray = int((~same & ~near_zero & active).sum())
    lam = torch.gather(ds, 1, origin.clamp(0, M - 1)) + mu
    lam_p = torch.gather(ds, 1, origin_p) + mu_p
    err = torch.where(same, (mu - mu_p).abs(),
                      (lam - lam_p).abs() - 2 * eps * torch.maximum(lam.abs(), lam_p.abs()))
    rel = (err / gap)[active]
    # a NaN (a root left unwritten, say) reads as infinitely far
    worst = float(torch.where(rel.isnan(), torch.inf, rel).max()) if rel.numel() else 0.0
    return worst, stray


def qr_polish(V):
    """The Householder-QR polish stage 2 ran before its Newton-Schulz step:
    QR of the columns in descending-eigenvalue order, signs kept."""
    Q, R = torch.linalg.qr(V.flip(-1))
    sign = torch.where(torch.diagonal(R, dim1=-2, dim2=-1) < 0, -1.0, 1.0).to(V.dtype)
    return (Q * sign.unsqueeze(-2)).flip(-1)
