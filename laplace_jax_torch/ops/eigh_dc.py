"""Level-batched spectral divide-and-conquer eigendecomposition for factor
stacks (port of `laplace_jax/ops/eigh_dc.py`).

The host drives the recursion one level at a time and pools every
same-level subproblem of every stack (all shapes) into shared batched calls.
Each divide step splits a block at a Ritz estimate of an adaptive spectral
quantile: a capped dynamically weighted Halley iteration (QDWH in its
Cholesky form) gives the matrix sign, hence the spectral projector; a
randomized shifted CholeskyQR3 basis covers both eigenspaces; a congruence
yields the two children. Blocks at or below the termination size, and
blocks whose off-diagonal part is noise, are finished directly. Every step
is batched matmul, `torch.linalg.cholesky_ex` and `solve_triangular`, with
`torch.linalg.eigh` for the terminal blocks: library calls for work that the
JAX package also does outside any Pallas kernel. Per-subproblem bases stay
local: each level writes its transforms into a block-diagonal (n, n) matrix
per factor, and the running basis is multiplied by it once per level.

Differences from the JAX module:
- its two fixed normal draws per bucket width (`jax.random.key(7)` for the
  (Bk, 128) Ritz probe, `key(20260816)` for the (Bk, Bk) split basis) come
  from CPU `torch.Generator`s seeded 7 and 20260816, so CPU and CUDA runs
  see the same numbers (not jax.random's). `draws(kind, rows, cols, dtype,
  device)`, with `kind` "ritz" or "split", replaces them, as the tests do
  to pass the JAX package's own draws;
- every step runs in float64, whatever the stacks' dtype; results come
  back in the stacks' dtype. The TPU computes float32 stacks in float32,
  where on full-width ResNet-18 Kronecker factors this algorithm read
  eigenvalue errors up to 2e-3 of a class's largest and reconstructions up
  to 2.8e-2 (`chip_smoke.py` on the H100): each divide step's sign
  iteration and basis lose far more than float32 rounding on spectra with
  a dominant eigenvalue. NVIDIA's H100 SXM data sheet gives float64
  products on the tensor cores the peak of float32 ones outside them
  (67 TFLOP/s), and the port keeps float32 products off TF32;
- batches are not padded to powers of two (that bounded the TPU's compiled
  shapes; eager PyTorch compiles nothing);
- the `EIGH_DC_DEBUG` printing is left out.

[1] Nakatsukasa & Higham, "Stable and efficient spectral divide and conquer
    algorithms for the symmetric eigenvalue decomposition and the SVD",
    SIAM J. Sci. Comput. 35(3), 2013.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from laplace_jax_torch.utils.device import resolve_device

__all__ = ["eigh_stack_dc", "eigh_pooled_dc"]

# Weight cap of the Cholesky-form Halley update: c(a) = a + (a-1)^2/4 - 1
# <= 100 keeps I + c X^2 safely factorable
_A_CAP = 1.0 + (math.sqrt(1616.0) - 4.0) / 2.0  # ~19.0997
_SIGN_MAXIT = 40
_RITZ_DIM = 128  # random-compression size for the split-point estimate
_TERMINATION = 256
_BUCKET = 128  # blocks are padded to multiples of this width
# cold-start value of the adaptive split quantile (see `_classify`)
_Q_INIT = 0.35
# condition bound for the first (shifted) CholeskyQR pass (the JAX
# module's float64 value); see `_orth_cols`
_SHIFT_REL = 1e-9
# seeds of the fixed draws, by kind (the JAX module's PRNG keys)
_SEEDS = {"ritz": 7, "split": 20260816}


def _round_up(x: int, granularity: int) -> int:
    return ((x + granularity - 1) // granularity) * granularity


def _b(x):
    """A per-block scalar (m,) as (m, 1, 1)."""
    return x[:, None, None]


def _valid(B: int, b: torch.Tensor) -> torch.Tensor:
    """(m, B) mask of the first b[t] entries of each block."""
    return torch.arange(B, device=b.device)[None, :] < b[:, None]


def _square(mask: torch.Tensor) -> torch.Tensor:
    return mask[:, :, None] & mask[:, None, :]


def _masked(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Zero rows/cols >= b of each padded square block."""
    return torch.where(_square(_valid(H.shape[-1], b)), H, 0.0)


def _chol(M: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of the symmetrized M (as `jnp.linalg.cholesky`
    computes it), all NaN where the factorization fails."""
    L, info = torch.linalg.cholesky_ex((M + M.mT) / 2)
    return torch.where(_b(info > 0), math.nan, L)


def _solve_l(L, X):
    """L^{-1} X for lower-triangular L."""
    return torch.linalg.solve_triangular(L, X, upper=False)


def _solve_lt(L, X):
    """L^{-T} X for lower-triangular L."""
    return torch.linalg.solve_triangular(L.mT, X, upper=True)


# ---------------------------------------------------------------------------
# matrix sign via capped dynamically weighted Halley (QDWH, Cholesky form)
# ---------------------------------------------------------------------------


def _halley_weights(l):
    """Dynamically weighted Halley coefficients (Nakatsukasa & Higham eq.
    3.6) for the spectral lower bounds `l` (m,), `a` capped for Cholesky
    safety."""
    l = l.clamp(1e-30, 1.0)
    l2 = l * l
    d = torch.pow(4.0 * (1.0 - l2) / (l2 * l2), 1.0 / 3.0)
    f = 8.0 * (2.0 - l2) / (l2 * torch.sqrt(1.0 + d))
    a = torch.sqrt(1.0 + d) + 0.5 * torch.sqrt(torch.clamp_min(8.0 - 4.0 * d + f, 0.0))
    a = torch.minimum(a, torch.full_like(a, _A_CAP))
    b = (a - 1.0) ** 2 / 4.0
    c = a + b - 1.0
    return a, b, c


def _halley_step(X, eye, a, b, c):
    """X <- (b/c) X + (a - b/c) X (I + c X^2)^{-1}, and X^2."""
    X2 = X @ X
    W = _chol(eye + _b(c) * X2)
    Y = _solve_lt(W, _solve_l(W, X))
    return _b(b / c) * X + _b(a - b / c) * Y, X2


def _sign_halley(X: torch.Tensor, l0: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """sign(X) for a batch of symmetric X (m, B, B), spectra in [-1, 1],
    smallest |eigenvalue| ~ l0 (m,).

    Weighted Halley driven by the l-recurrence, each block until a 2-step
    power iteration on (X^2 - I) against the fixed probe `v` (m, B) reads
    its spectral deviation under ~sqrt(eps) or stops improving, at most
    `_SIGN_MAXIT` steps; the blocks still running are stepped together, as
    the JAX package's vmapped `while_loop` does. One unweighted Halley step
    then restores eps-level sign quality."""
    dt = X.dtype
    fi = torch.finfo(dt)
    tol = 3.0 * math.sqrt(fi.eps)
    m, B, _ = X.shape
    eye = torch.eye(B, dtype=dt, device=X.device)
    X, l = X.clone(), l0.clone()
    k = torch.zeros(m, dtype=torch.int64, device=X.device)
    est_prev = torch.full((m,), fi.max, dtype=dt, device=X.device)
    est = est_prev.clone()
    vnorm = torch.linalg.vector_norm(v, dim=-1).clamp_min(fi.tiny)
    while True:
        run = (k < _SIGN_MAXIT) & (est > tol) & ((est > 0.1) | (est < 0.5 * est_prev))
        idx = torch.nonzero(run).flatten()
        if idx.numel() == 0:
            break
        lr, vr = l[idx], v[idx]
        a, b, c = _halley_weights(lr)
        Xn, X2 = _halley_step(X[idx], eye, a, b, c)
        # X is masked to the valid block and v is zero outside it, so
        # (X^2 - I) v needs no extra masking
        w1 = (X2 @ vr[..., None])[..., 0] - vr
        w2 = (X2 @ w1[..., None])[..., 0] - w1
        n1 = torch.linalg.vector_norm(w1, dim=-1)
        est_new = torch.linalg.vector_norm(w2, dim=-1) / n1.clamp_min(fi.tiny)
        # the first application loses a sqrt(n) overlap factor: do not let
        # that report convergence while w1 itself is still large
        est_new = torch.maximum(est_new, n1 / vnorm[idx])
        X[idx] = Xn
        l[idx] = (lr * (a + b * lr * lr) / (1.0 + c * lr * lr)).clamp(0.0, 1.0)
        k[idx] += 1
        est_prev[idx] = est[idx]
        est[idx] = est_new
    X2 = X @ X
    W = _chol(eye + 3.0 * X2)
    Y = _solve_lt(W, _solve_l(W, X))
    return (1.0 / 3.0) * X + (8.0 / 3.0) * Y


# ---------------------------------------------------------------------------
# randomized shifted-CholeskyQR subspace extraction
# ---------------------------------------------------------------------------


def _cholqr_pass(Y: torch.Tensor, r: torch.Tensor, shift_rel: float,
                 fallback: bool = False) -> torch.Tensor:
    """One (optionally shifted) CholeskyQR pass on the first r[t] columns of
    each Y (m, B, B); columns >= r are zero on input and output. The
    identity padding of the Gram keeps the Cholesky PD on the masked part.

    With `fallback`, a second, heavily shifted factorization is taken for a
    block whose primary one fails (a square Gaussian sketch can push the
    Gram's smallest eigenvalue to rounding level); its kappa(V) <= ~8 lets
    the next plain pass restore orthonormality."""
    B = Y.shape[-1]
    vr = _valid(B, r)
    eye_r = torch.diag_embed(vr.to(Y.dtype))
    G = Y.mT @ Y
    tr = torch.diagonal(G, dim1=1, dim2=2).sum(-1) / r.clamp_min(1).to(Y.dtype)
    if shift_rel:
        G = G + _b(shift_rel * tr) * eye_r
    G = torch.where(_square(vr), G, torch.eye(B, dtype=Y.dtype, device=Y.device))
    L = _chol(G)
    if fallback:
        L_fb = _chol(G + _b(0.02 * tr) * eye_r)
        L = torch.where(_b(torch.isnan(L).flatten(1).any(1)), L_fb, L)
    V = torch.linalg.solve_triangular(L.mT, Y, upper=True, left=False)  # V L^T = Y
    return torch.where(vr[:, None, :], V, 0.0)


def _orth_cols(Y: torch.Tensor, r: torch.Tensor, shift_rel: float) -> torch.Tensor:
    """Orthonormalize the first r[t] columns: one shifted pass bounds the
    condition number, two plain passes reach eps-orthonormality (shifted
    CholeskyQR3, Fukaya et al. 2020); the first two carry the fallback."""
    V = _cholqr_pass(Y, r, shift_rel, fallback=True)
    V = _cholqr_pass(V, r, 0.0, fallback=True)
    return _cholqr_pass(V, r, 0.0)


# ---------------------------------------------------------------------------
# level steps, batched over the blocks of one bucket width
# ---------------------------------------------------------------------------


def _classify(H, b, H0n, G_ritz, q: float):
    """Early-exit flags and split points of the blocks H (m, B, B), sizes b.

    A block is done when its off-diagonal part is noise or its norm is
    negligible against its factor's (`H0n`). The split point is the Ritz
    value of the random `_RITZ_DIM`-dimensional compression (the pencil
    (G'HG, G'G)) at quantile `q`, which the driver retargets toward median
    splits level by level. Also returns the straddling Ritz half-gap (the
    sign iteration's bound seed) and a Ritz-extreme spectral-radius
    estimate."""
    m, B, _ = H.shape
    dt = H.dtype
    eps = torch.finfo(dt).eps
    H = _masked(H, b)
    norm = torch.linalg.matrix_norm(H)
    off = torch.linalg.matrix_norm(H - torch.diag_embed(torch.diagonal(H, dim1=1, dim2=2)))
    done = (off <= 5 * eps * norm) | (norm < eps * H0n)

    Gm = torch.where(_valid(B, b)[:, :, None], G_ritz[None], 0.0)
    A_s = Gm.mT @ (H @ Gm)
    B_s = Gm.mT @ Gm
    s = G_ritz.shape[1]
    # padding-size blocks would hand Cholesky a rank-deficient pencil: a
    # full-strength shift keeps it PD (their outputs are unused)
    tr = torch.diagonal(B_s, dim1=1, dim2=2).sum(-1) / s
    shift = torch.where(b >= s, 10 * eps * tr, tr + 1.0)
    L = _chol(B_s + _b(shift) * torch.eye(s, dtype=dt, device=H.device))
    C = _solve_l(L, _solve_l(L, A_s).mT)
    ritz = torch.linalg.eigvalsh((C + C.mT) / 2)  # ascending
    i = min(max(int(torch.tensor(q, dtype=dt) * s), 1), s - 1)
    r_lo, r_hi = ritz[:, i - 1], ritz[:, i]
    sigma = 0.5 * (r_lo + r_hi)
    gap_half = 0.5 * (r_hi - r_lo)
    alpha_est = 1.25 * torch.maximum(ritz[:, -1] - sigma, sigma - ritz[:, 0])
    return done, sigma, gap_half, alpha_est


def _split(H, b, sigma, gap_half, alpha_est, G_seed):
    """One divide step on the blocks H (m, B, B): the weighted-Halley sign
    of the shifted block gives the projector onto eigenvalues < sigma; one
    randomized CholeskyQR3 basis W = [V_minus | V_plus] covers both
    eigenspaces; the congruence W^T H W gives the children. Returns
    (H_minus, H_plus, W, rank_minus)."""
    m, B, _ = H.shape
    dt = H.dtype
    fi = torch.finfo(dt)
    H = _masked(H, b)
    vb = _valid(B, b)
    eye_b = torch.diag_embed(vb.to(dt))
    X = H - _b(sigma) * eye_b
    # ||X||_2 <= ||X||_1; the classifier's Ritz-extreme estimate is tighter
    # where it is finite
    alpha1 = X.abs().sum(1).amax(-1)
    ok = torch.isfinite(alpha_est) & (alpha_est > 0)
    alpha = torch.where(ok, torch.minimum(alpha1, alpha_est), alpha1)
    X = torch.where(_b(alpha > 0), X / _b(alpha), X)
    # spectral lower bound from the Ritz gap, halved for safety
    l0 = (0.5 * gap_half / alpha.clamp_min(fi.tiny)).clamp(16 * fi.eps, 0.9)
    v_probe = torch.where(vb, G_seed[None, :, 0], 0.0)
    S = _sign_halley(X, l0, v_probe)
    P_minus = 0.5 * (eye_b - S)
    rank = torch.round(torch.diagonal(P_minus, dim1=1, dim2=2).sum(-1)).to(torch.int64)

    # one square sketch: its first rank columns sample range(P), the rest
    # range(I - P), orthonormalized together
    cols = torch.arange(B, device=H.device)
    M = P_minus @ G_seed
    Y = torch.where(cols[None, None, :] < _b(rank), M, G_seed[None] - M)
    Y = torch.where(_square(vb), Y, 0.0)
    W = _orth_cols(Y, b, _SHIFT_REL)
    # one Newton-Schulz polar step contracts the CholQR chain's residual
    W = W @ (1.5 * eye_b - 0.5 * (W.mT @ W))

    T = W.mT @ (H @ W)
    Hm = torch.where(_square(_valid(B, rank)), T, 0.0)
    r0 = rank.clamp(0, B)
    rows = r0[:, None] + cols[None, :]  # (m, B)
    Tp = F.pad(T, (0, B, 0, B))
    Hp = torch.gather(Tp, 1, rows[:, :, None].expand(m, B, 2 * B))
    Hp = torch.gather(Hp, 2, rows[:, None, :].expand(m, B, B))
    Hp = torch.where(_square(_valid(B, b - r0)), Hp, 0.0)
    return Hm, Hp, W, rank


def _base_eigh(H, b):
    """Dense eigendecomposition of terminal blocks: rows/cols past b become
    `big * I` with `big` above the spectral radius (Frobenius bound), so the
    valid b eigenpairs come first in ascending order."""
    B = H.shape[-1]
    H = _masked(H, b)
    vb = _valid(B, b)
    big = 2.0 * torch.linalg.matrix_norm(H) + 1.0
    vals, vecs = torch.linalg.eigh(H + torch.diag_embed(torch.where(vb, 0.0, big[:, None])))
    return torch.where(vb, vals, 0.0), torch.where(vb[:, None, :], vecs, 0.0)


# ---------------------------------------------------------------------------
# host-side driver
# ---------------------------------------------------------------------------


class _Record:
    """Host-side subproblem descriptor."""

    __slots__ = ("cls", "mat", "off", "size", "src", "idx")

    def __init__(self, cls, mat, off, size, src, idx):
        self.cls = cls    # class index (shape group)
        self.mat = mat    # matrix index within the class
        self.off = off    # diagonal offset within the matrix
        self.size = size  # true block size
        self.src = src    # blockstore key of the stack holding the block
        self.idx = idx    # row in that stack


def _gather_blocks(records, width, stacks):
    """Stack each record's (width, width) top-left block; blocks of sources
    narrower than the bucket (level-0 matrices) are zero-padded."""

    def fit(arr):
        arr = arr[..., :width, :width]
        d = width - arr.shape[-1]
        return F.pad(arr, (0, d, 0, d)) if d else arr

    src = records[0].src
    if all(r.src == src for r in records):
        arr, idx = stacks[src], [r.idx for r in records]
        if idx != list(range(arr.shape[0])):
            arr = arr[torch.as_tensor(idx, device=arr.device)]
        return fit(arr)
    return torch.stack([fit(stacks[r.src][r.idx]) for r in records])


def _default_draws(kind: str, rows: int, cols: int, dtype, device):
    gen = torch.Generator().manual_seed(_SEEDS[kind])
    return torch.randn(rows, cols, generator=gen, dtype=dtype).to(device)


def eigh_pooled_dc(stacks, termination_size: int = _TERMINATION, device=None, draws=None):
    """Eigendecompose a collection of symmetric-matrix stacks together.

    `stacks` is a list of (k_c, n_c, n_c) tensors (one per factor shape) of
    one dtype. All same-level D&C subproblems across every stack run in
    shared batched calls, in float64. Runs on `device` (CUDA unless the
    caller asks for the CPU). `draws(kind, rows, cols, dtype, device)`
    replaces the fixed normal draws, made in the stacks' dtype (see the
    module docstring). Returns a list of `(eigenvalues, eigenvectors)` per
    stack in the stacks' dtype, ascending per matrix, as
    `torch.linalg.eigh`."""
    dev = resolve_device(device)
    stacks = [torch.as_tensor(s).to(dev) for s in stacks]
    for s in stacks:
        if s.ndim != 3 or s.shape[1] != s.shape[2]:
            raise ValueError(f"expected (k, n, n) stacks, got {tuple(s.shape)}")
    if not stacks:
        return []
    out_dtype = stacks[0].dtype
    if any(s.dtype != out_dtype for s in stacks):
        raise ValueError("all stacks must share one dtype; pool per dtype")
    dtype = torch.float64  # every step, whatever the stacks' dtype
    draws = _default_draws if draws is None else draws

    sym = [(s.to(dtype) + s.to(dtype).mT) / 2 for s in stacks]
    H0norms = [torch.linalg.matrix_norm(s).tolist() for s in sym]
    vals_out = [torch.zeros(s.shape[:2], dtype=dtype, device=dev) for s in sym]
    V_accs: list = [None] * len(sym)

    blockstore = {("init", ci): s for ci, s in enumerate(sym)}
    records = [_Record(ci, mi, 0, s.shape[1], ("init", ci), mi)
               for ci, s in enumerate(sym) for mi in range(s.shape[0])]
    G_cache: dict = {}

    def probe(kind, Bk, cols):
        if (kind, Bk) not in G_cache:
            G_cache[(kind, Bk)] = torch.as_tensor(
                draws(kind, Bk, cols, out_dtype, dev), dtype=dtype, device=dev)
        return G_cache[(kind, Bk)]

    # the classify pencil compresses to _RITZ_DIM dimensions: smaller active
    # blocks would make it rank-deficient, so the base case starts there
    termination_size = max(int(termination_size), _RITZ_DIM)
    q_run = _Q_INIT
    while records:
        # group by (terminal?, bucket width); routing is by size
        groups: dict = {}
        for rec in records:
            groups.setdefault((rec.size <= termination_size, _round_up(rec.size, _BUCKET)),
                              []).append(rec)
        next_records: list = []
        new_blockstore: dict = {}
        level_L: dict = {}  # class -> this level's block-diagonal transforms
        touched: set = set()

        def get_L(ci):
            if ci not in level_L:
                k_c, n_c, _ = sym[ci].shape
                level_L[ci] = torch.eye(n_c, dtype=dtype, device=dev).expand(k_c, n_c, n_c).clone()
            return level_L[ci]

        def put(rec, vals, vecs):
            """A finished block's eigenvalues, and its local basis if any."""
            o, b = rec.off, rec.size
            vals_out[rec.cls][rec.mat, o : o + b] = vals[:b]
            if vecs is not None:
                get_L(rec.cls)[rec.mat, o : o + b, o : o + b] = vecs[:b, :b]
                touched.add(rec.cls)

        splits = []
        for (is_base, Bk), recs in sorted(groups.items(), key=lambda kv: (-kv[0][1], kv[0][0])):
            subH = _gather_blocks(recs, Bk, blockstore)
            sizes = torch.as_tensor([r.size for r in recs], device=dev)
            if is_base:
                bvals, bvecs = _base_eigh(subH, sizes)
                for t, rec in enumerate(recs):
                    put(rec, bvals[t], bvecs[t])
                continue
            H0n = torch.as_tensor([H0norms[r.cls][r.mat] for r in recs], dtype=dtype, device=dev)
            done, sigmas, gap_halves, alpha_ests = _classify(
                subH, sizes, H0n, probe("ritz", Bk, _RITZ_DIM), q_run)
            done = done.tolist()
            for t, rec in enumerate(recs):
                if done[t]:  # basis unchanged: only the diagonal as values
                    put(rec, torch.diagonal(subH[t]), None)
            act = [t for t, d in enumerate(done) if not d]
            if not act:
                continue
            ia = torch.as_tensor(act, device=dev)
            subH_a = subH[ia]
            out = _split(subH_a, sizes[ia], sigmas[ia], gap_halves[ia], alpha_ests[ia],
                         probe("split", Bk, Bk))
            splits.append((Bk, [recs[t] for t in act], subH_a, *out))

        frac_num = frac_den = 0
        for Bk, recs, subH_a, Hm, Hp, W, ranks in splits:
            ranks = ranks.tolist()
            new_blockstore[("m", Bk)] = Hm
            new_blockstore[("p", Bk)] = Hp
            for j, rec in enumerate(recs):
                b, r = rec.size, ranks[j]
                if r <= 0 or r >= b:
                    # degenerate split (projector rank 0 or full): solve the
                    # block directly; rare, and guarantees progress
                    Hi = subH_a[j, :b, :b]
                    fvals, fvecs = torch.linalg.eigh((Hi + Hi.mT) / 2)
                    put(rec, fvals, fvecs)
                    continue
                frac_num += r
                frac_den += b
                get_L(rec.cls)[rec.mat, rec.off : rec.off + b, rec.off : rec.off + b] = W[j, :b, :b]
                touched.add(rec.cls)
                next_records.append(_Record(rec.cls, rec.mat, rec.off, r, ("m", Bk), j))
                next_records.append(_Record(rec.cls, rec.mat, rec.off + r, b - r, ("p", Bk), j))

        # retarget the split quantile from this level's exact fractions
        if frac_den:
            a = frac_num / frac_den
            q_run = min(max(q_run * 0.5 / max(a, 0.05), 0.08), 0.92)

        # compose this level's transforms into the running bases (a class
        # whose L stayed the identity keeps its basis)
        for ci, L in level_L.items():
            if V_accs[ci] is None:
                V_accs[ci] = L
            elif ci in touched:
                V_accs[ci] = V_accs[ci] @ L

        records = next_records
        blockstore = new_blockstore

    out = []
    for ci, s in enumerate(sym):
        k_c, n_c, _ = s.shape
        vals, vecs = vals_out[ci], V_accs[ci]
        if vecs is None:  # every block finished with the identity basis
            vecs = torch.eye(n_c, dtype=dtype, device=dev).expand(k_c, n_c, n_c)
        order = torch.argsort(vals, dim=1, stable=True)
        out.append((torch.gather(vals, 1, order).to(out_dtype),
                    torch.gather(vecs, 2, order[:, None, :].expand(k_c, n_c, n_c)).to(out_dtype)))
    return out


def eigh_stack_dc(stack, termination_size: int = _TERMINATION, device=None, draws=None):
    """Eigendecompose a (k, n, n) stack of symmetric matrices (ascending
    eigenvalues, as `torch.linalg.eigh`) with the pooled spectral D&C;
    stacks no larger than `termination_size` go to `torch.linalg.eigh`.
    Runs on `device` (CUDA unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    stack = torch.as_tensor(stack).to(dev)
    if stack.ndim != 3 or stack.shape[1] != stack.shape[2]:
        raise ValueError(f"expected (k, n, n) stack, got {tuple(stack.shape)}")
    if stack.shape[1] <= termination_size:
        return torch.linalg.eigh((stack + stack.mT) / 2)
    [(vals, vecs)] = eigh_pooled_dc([stack], termination_size=termination_size,
                                    device=dev, draws=draws)
    return vals, vecs
