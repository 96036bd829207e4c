"""The launch plan and the summation order of the persistent v3 panel kernel
(`ops/latrd_v3.py` `panel_plan`; `csrc/latrd_v3.cu`), checked on the CPU.

- Plan: on every panel of v3's route (stage 1 through
  `tridiagonalize_latrd_v3` for the classes n >= 512 of ResNet-18's KFAC
  fit, and for every class n = 512 ... 4608 at K <= 6), in float32 and
  float64, the dynamic and static shared memory fit in one block's 227 KB
  and the plan keeps all it can.
- Slot layout: the kernel's index arithmetic (`Slots`, `YTerms`), mirrored
  here, gives every strip (a block's tiles sharing a tile row) and every
  off-diagonal tile a slot of its own inside the `work` scratch, and the
  gather of each 64-row block of y reads exactly the slots written for it,
  each once.
- Order: a tiled torch version of the kernel's panel (`emulated_panel`:
  its tiles in the blocks' visiting order, the row products of each strip
  and the column products of each tile in slots, y gathered from them in
  the kernel's order, U v and W v from the row blocks' shares, y.v from the
  blocks' shares, w at row c+1 formed apart) against `latrd_panel_v3_plain`
  and the JAX package's XLA `tridiagonalize` at 1e-9 in float64, and
  against the JAX Pallas v3 panel in interpret mode at 1e-5 (the Pallas
  panel rounds in float32 even on float64 inputs, as in
  `tests/test_torch_latrd_v3_v2.py`).

The kernel itself is held against `latrd_panel_v3_plain`, bit for bit over
two launches, in `tests/test_torch_cuda_kernels.py` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from laplace_jax.ops.latrd_pallas_v3 import latrd_panel_v3 as jax_latrd_panel_v3
from laplace_jax.ops.tridiag import tridiagonalize as jax_tridiagonalize
from laplace_jax_torch.ops import latrd_v3
from laplace_jax_torch.ops.latrd_v3 import (
    STATIC_BYTES,
    dynamic_smem,
    latrd_panel_v3_plain,
    panel_plan,
)
from laplace_jax_torch.ops.latrd_v4 import MAX_RES, RING, SMEM_BYTES, TILE, slot_bytes
from laplace_jax_torch.ops.tridiag import _cdiv, eps_tiny, tridiagonalize_windows
from tests.test_torch_latrd import _sym_window, _unpack_pallas

# several test workers share the CPU: one intra-op thread each
torch.set_num_threads(1)

H100_SMS = 132
NB = 64


def _route_panels(K, n, nb=NB):
    """(K, m, off) of every panel stage 1 runs for one class through
    `tridiagonalize_latrd_v3` (window classes of T = 384 from n >= 1536,
    else 128)."""
    T = 384 if n >= 1536 else 128
    S = max(_cdiv(nb, T) * T, T, _cdiv(_cdiv(n, 4), T) * T)
    n_pad, n_cols = _cdiv(n, S) * S, n - 2
    return sorted({(K, n_pad - q, t * nb) for q in range(0, n_cols, S)
                   for t in range(_cdiv(min(S, n_cols - q), nb))})


# ResNet-18's KFAC classes n >= 512 (the eigensolvers phase of chip_smoke.py)
ROUTE = [(6, 512), (5, 576), (4, 1152), (4, 2304), (3, 4608)]


def test_route_runs_143_panels():
    assert sum(len(_route_panels(K, n)) for K, n in ROUTE) == 143


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("K,n", ROUTE, ids=[f"{K}x{n}" for K, n in ROUTE])
def test_route_plans_fit_and_keep_all_they_can(K, n, itemsize):
    for _, m, off in _route_panels(K, n):
        plan = panel_plan(K, m, off, NB, itemsize, H100_SMS)
        nt, s0 = m // TILE, (off + 1) // TILE
        n_units = _cdiv(K * nt, H100_SMS)
        share = _cdiv(K * (nt - s0) * (nt - s0 + 1) // 2, H100_SMS)

        def fits(res, cache):
            return STATIC_BYTES + dynamic_smem(K, NB, res, cache, n_units, itemsize) <= SMEM_BYTES

        assert plan.smem == dynamic_smem(K, NB, plan.n_res, plan.n_cache, n_units, itemsize)
        assert fits(plan.n_res, plan.n_cache)
        assert plan.n_cache == (n_units if fits(0, n_units) else 0)
        assert 0 <= plan.n_res <= min(share, MAX_RES)
        assert plan.n_res == min(share, MAX_RES) or not fits(plan.n_res + 1, plan.n_cache)


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
def test_every_class_up_to_4608_is_planned(itemsize):
    """Every window of every class n = 512 ... 4608 (step 64), K <= 6,
    plans within 227 KB; the first panel of a window needs the most."""
    for n in range(512, 4609, 64):
        for m in sorted({m for _, m, _ in _route_panels(1, n)}):
            for K in range(1, 7):
                plan = panel_plan(K, m, 0, NB, itemsize, H100_SMS)
                assert STATIC_BYTES + plan.smem <= SMEM_BYTES


def test_main_windows_keep_rows_and_tiles_on_chip():
    """(3, 4608) in float32: the rows of U and W of both row blocks a block
    owns and 5 resident tiles a block; (4, 1152): every tile resident."""
    plan = panel_plan(3, 4608, 0, NB, 4, H100_SMS)
    assert (plan.n_res, plan.n_cache) == (5, 2)
    plan = panel_plan(4, 1152, 0, NB, 4, H100_SMS)
    assert plan.n_res * H100_SMS >= 4 * 18 * 19 // 2
    assert SMEM_BYTES == 227 * 1024 and RING[4] >= 2


def test_a_window_the_kernel_cannot_hold_raises():
    with pytest.raises(ValueError):
        panel_plan(4000, 2048, 0, NB, 8, H100_SMS)


def test_cpu_stage1_never_plans():
    before = dict(latrd_v3._plans)
    A = torch.randn(2, 130, 130, dtype=torch.float64)
    latrd_v3.tridiagonalize_latrd_v3((A + A.mT) / 2, nb=16)
    assert latrd_v3._plans == before


# -- the kernel's index arithmetic, mirrored --------------------------------


def _tri(x):
    return x * (x + 1) // 2


class Slots:
    """`Slots` of csrc/latrd_v3.cu for one panel on `n_cta` blocks."""

    def __init__(self, K, m, off, n_cta, n_tiles):
        self.K, self.nt = K, m // TILE
        self.s0 = (off + 1) // TILE
        self.nl = self.nt - self.s0
        self.base, self.extra = divmod(n_tiles, n_cta)
        self.n_cta = n_cta

    def owner(self, x):
        big = self.extra * (self.base + 1)
        return x // (self.base + 1) if x < big else self.extra + (x - big) // self.base

    def tile_at(self, k, r, s):
        return k * _tri(self.nl) + _tri(r - self.s0) + s - self.s0

    def strip_row(self, k, r):
        return k * self.nl + r - self.s0

    def y_terms(self, k, b, t0, rl):
        """`YTerms`: the row slots, then the column slots, of y on tile row b."""
        row0 = self.tile_at(k, b, self.s0)
        g0, g1 = self.owner(row0 + t0 - self.s0), self.owner(row0 + b - self.s0)
        rows = [("row", self.strip_row(k, b) + g) for g in range(g0, g1 + 1)]
        return rows + [("col", self.tile_at(k, r, b)) for r in range(b + 1, rl + 1)]

    def rows_capacity(self):  # the `work` layout is sized for off = 0
        return self.K * self.nt + self.n_cta

    def cols_capacity(self):
        return self.K * _tri(self.nt)


def _decode(table, n_cta):
    offsets = table[: n_cta + 1].tolist()
    codes = table[n_cta + 1 :].tolist()
    return offsets, [(c >> 20, c >> 10 & 1023, c & 1023) for c in codes]


def _written_slots(K, m, off, n_cta, t0, nv):
    """The slots the matvec writes in a column with trailing tile column t0:
    each block's live strips and off-diagonal tiles."""
    offsets, tiles = _decode(panel_plan(K, m, off, NB, 4, n_cta).table, n_cta)
    sl = Slots(K, m, off, n_cta, len(tiles))
    rows, cols = {}, {}
    for g in range(n_cta):
        for x in range(offsets[g], offsets[g + 1]):
            k, r, s = tiles[x]
            assert sl.owner(x) == g and sl.tile_at(k, r, s) == x
            if s < t0 or r * TILE >= nv:
                continue
            slot = sl.strip_row(k, r) + g
            assert rows.setdefault(slot, (g, k, r)) == (g, k, r)
            if r != s:
                cols[x] = (k, r, s)
    return sl, rows, cols


def _layout_cases():
    out = []
    for K, n in ROUTE:
        panels = _route_panels(K, n)
        for _, m, off in (panels[0], panels[-1]):
            out.append(pytest.param(K, m, off, H100_SMS, m, id=f"{K}x{m}-off{off}"))
    return out + [pytest.param(*c, id="{}x{}-off{}-g{}-nv{}".format(*c)) for c in
                  ((2, 256, 0, 7, 256), (2, 256, 80, 7, 250), (3, 384, 64, 11, 384),
                   (2, 640, 512, 132, 600), (1, 128, 0, 132, 100), (40, 768, 0, 132, 700))]


@pytest.mark.parametrize("K,m,off,n_cta,nv", _layout_cases())
def test_slots_hold_every_product_once_and_the_gather_reads_each_once(K, m, off, n_cta, nv):
    rl = (nv - 1) // TILE
    for t0 in sorted({(c + 1) // TILE for c in range(off, off + NB)}):
        sl, rows, cols = _written_slots(K, m, off, n_cta, t0, nv)
        assert all(0 <= s < sl.rows_capacity() for s in rows)
        assert all(0 <= x < sl.cols_capacity() for x in cols)
        read = []
        for k in range(K):
            for b in range(t0, rl + 1):
                terms = sl.y_terms(k, b, t0, rl)
                for kind, idx in terms:
                    if kind == "row":
                        assert rows[idx][1:] == (k, b)
                    else:
                        assert cols[idx][0] == k and cols[idx][2] == b
                read += terms
        assert len(read) == len(set(read))
        assert set(read) == {("row", s) for s in rows} | {("col", x) for x in cols}


# -- the kernel's order, emulated in torch -----------------------------------


def emulated_panel(Aw, off, q_base, n_real, nb, n_cta, n_res):
    """csrc/latrd_v3.cu's panel in torch, phase by phase, with its slots and
    the order of its cross-block sums (within a tile or a warp, torch's own
    order)."""
    K, m, _ = Aw.shape
    dt = Aw.dtype
    offsets, tiles = _decode(panel_plan(K, m, off, nb, Aw.element_size(), n_cta).table, n_cta)
    sl = Slots(K, m, off, n_cta, len(tiles))
    nt = m // TILE
    nv = min(n_real - q_base, m)
    rl = (nv - 1) // TILE
    UW = torch.zeros(K, 2 * nb, m, dtype=dt)
    det = torch.zeros(K, 3, nb, dtype=dt)
    rows = torch.arange(m)
    for j in range(nb):
        c = off + j
        ok = c + q_base < n_real - 2
        t0 = (c + 1) // TILE
        U, W = UW[:, :j], UW[:, nb: nb + j]
        # (a) the corrected column (rows >= c, 0 from nv), each half row
        # block's share of its squares below c, each row block's of U x and
        # W x below c+1
        col = Aw[:, c] - torch.einsum("kq,kqi->ki", W[:, :, c], U) \
            - torch.einsum("kq,kqi->ki", U[:, :, c], W)
        col = torch.where((rows >= c) & (rows < nv), col, 0.0)
        part = torch.where(rows > c, col * col, 0.0).reshape(K, 2 * nt, TILE // 2).sum(-1)
        x = torch.where(rows > c + 1, col, 0.0)
        share_u = torch.einsum("kqbi,kbi->kbq", U.reshape(K, j, nt, TILE), x.reshape(K, nt, TILE))
        share_w = torch.einsum("kqbi,kbi->kbq", W.reshape(K, j, nt, TILE), x.reshape(K, nt, TILE))
        # (b) every window's reflector, the JAX package's rules
        sumsq = part.sum(1)
        alpha = col[:, c + 1] if c + 1 < m else torch.zeros(K, dtype=dt)
        a2 = alpha * alpha
        xnorm2 = (sumsq - a2).clamp(min=0.0)
        anorm = torch.sqrt(a2 + xnorm2)
        beta = torch.where(alpha >= 0, -anorm, anorm)
        trivial = xnorm2 <= eps_tiny(dt) * anorm * anorm
        denom = torch.where(trivial, 1.0, alpha - beta)
        tau = torch.where(trivial | (not ok), 0.0, (beta - alpha) / torch.where(trivial, 1.0, beta))
        det[:, 0, j], det[:, 1, j], det[:, 2, j] = col[:, c], torch.where(trivial, alpha, beta), tau
        v = torch.where(rows > c, col / denom[:, None], 0.0)
        if c + 1 < m:
            v[:, c + 1] = 1.0
        v = v if ok else torch.zeros_like(v)
        UW[:, j] = v
        rd = 1.0 / denom if ok else torch.zeros(K, dtype=dt)
        # U v and W v: one warp an entry over the row blocks' shares
        s = U[:, :, c + 1] + share_u.sum(1) * rd[:, None] if ok else torch.zeros(K, j, dtype=dt)
        t = W[:, :, c + 1] + share_w.sum(1) * rd[:, None] if ok else torch.zeros(K, j, dtype=dt)
        # the matvec into slots: x with x[c+1] = denom, 0 at and above c
        xt = x.clone()
        if c + 1 < m:
            xt[:, c + 1] = denom
        row_slot, col_slot = {}, {}
        yv = torch.zeros(K, dtype=dt)
        for g in range(n_cta):
            run = list(range(offsets[g], offsets[g + 1]))
            nres = min(n_res, len(run))
            streamed = run[nres:]
            order = run[:nres] + (streamed[::-1] if j & 1 else streamed)
            state = dict(key=None, again=None, acc=None)
            share = torch.zeros(K, dtype=dt)

            def flush(state=state, share=share, g=g):
                if state["key"] is None:
                    return
                k, r = state["key"]
                slot = sl.strip_row(k, r) + g
                total = state["acc"]
                share[k] += (total * xt[k, r * TILE:(r + 1) * TILE]).sum()
                if state["key"] == state["again"]:
                    total = row_slot[slot] + total
                else:
                    assert slot not in row_slot
                row_slot[slot] = total
                state["key"] = None

            for i, xi in enumerate(order):
                if i == nres:  # the resident strip flushed before the streamed tiles
                    split = state["key"]
                    flush()
                    state["again"] = split
                k, r, s_ = tiles[xi]
                if s_ < t0 or r * TILE >= nv:
                    continue
                if state["key"] != (k, r):
                    flush()
                    state.update(key=(k, r), acc=torch.zeros(TILE, dtype=dt))
                R, S = r * TILE, s_ * TILE
                tile = Aw[k, R:R + TILE, S:S + TILE]
                state["acc"] = state["acc"] + tile @ xt[k, S:S + TILE]
                if r != s_:
                    assert xi not in col_slot
                    col_slot[xi] = tile.mT @ xt[k, R:R + TILE]
                    share[k] += (col_slot[xi] * xt[k, S:S + TILE]).sum()
            if len(order) == nres:
                split = state["key"]
                flush()
                state["again"] = split
            flush()
            yv += share  # the blocks' shares in block order
        yv = yv * rd * rd
        # (c) y from the slots, each 64-row block in the kernel's order
        y = torch.zeros(K, m, dtype=dt)
        for k in range(K):
            for b in range(t0, rl + 1):
                terms = [row_slot.pop(i) if kind == "row" else col_slot.pop(i)
                         for kind, i in sl.y_terms(k, b, t0, rl)]
                parts = [sum(terms[p::4], torch.zeros(TILE, dtype=dt)) for p in range(4)]
                y[k, b * TILE:(b + 1) * TILE] = ((parts[0] + parts[1]) + (parts[2] + parts[3])) * rd[k]
        assert not row_slot and not col_slot  # every slot gathered once
        sdt = (s * t).sum(1)
        wv = tau * (yv - 2 * sdt)
        corr = torch.einsum("kq,kqi->ki", t, U) + torch.einsum("kq,kqi->ki", s, W)
        w = tau[:, None] * (y - corr) - (0.5 * tau * wv)[:, None] * v
        w = torch.where((rows > c) & (rows < nv), w, 0.0)
        if j + 1 < nb and c + 1 < nv:  # w at row c+1: formed apart by every block
            corr1 = (U[:, :, c + 1] * t).sum(1) + (W[:, :, c + 1] * s).sum(1)
            w[:, c + 1] = tau * (y[:, c + 1] - corr1) - 0.5 * tau * wv * float(ok)
        UW[:, nb + j] = w
    return UW, det


# (K, m, off, n_real, nb, n_cta, n_res): strips split between blocks and
# between resident and streamed tiles, off 0 and past a tile column, tile
# column t0 changing inside the panel, padded rows, and fewer tiles than the
# card has blocks
ORDER_CASES = [(2, 256, 0, 256, 16, 7, 1), (2, 256, 80, 250, 16, 7, 1), (2, 256, 56, 250, 16, 5, 2),
               (2, 384, 0, 378, 16, 5, 2), (2, 384, 136, 384, 64, 5, 2),
               (2, 384, 64, 320, 16, H100_SMS, 1)]


@pytest.mark.parametrize("K,m,off,n_real,nb,n_cta,n_res", ORDER_CASES,
                         ids=["{}x{}-off{}-nr{}-nb{}-g{}-res{}".format(*c) for c in ORDER_CASES])
def test_emulated_order_matches_plain(K, m, off, n_real, nb, n_cta, n_res):
    A = torch.as_tensor(_sym_window(np.random.default_rng(20), K, m, n_real))
    for g, r in zip(emulated_panel(A, off, 0, n_real, nb, n_cta, n_res),
                    latrd_panel_v3_plain(A, off, 0, n_real, nb)):
        torch.testing.assert_close(g, r, atol=1e-9 * float(r.abs().max()), rtol=0)


@pytest.mark.parametrize("n", [256, 250])
def test_stage1_in_the_emulated_order_matches_xla_tridiagonalize(n):
    """Stage 1 with the emulated panel on 7 blocks, 1 resident tile each,
    against the JAX package's XLA formulation with the same window classes
    (S = 128: windows of 256 and 128, padded when n = 250) in float64."""
    K, nb, S = 2, 16, 128
    A = _sym_window(np.random.default_rng(21), K, n, n)
    ref = [np.asarray(a) for a in jax_tridiagonalize(jnp.asarray(A), nb=nb, n_classes=2)]
    got = tridiagonalize_windows(torch.as_tensor(A), nb, S,
                                 lambda *a: emulated_panel(*a, n_cta=7, n_res=1))
    for g, r in zip(got, ref):
        g = g.numpy()[..., : r.shape[-2], : r.shape[-1]] if g.ndim == 3 else g.numpy()
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-9 * max(1.0, np.abs(r).max()))


def test_emulated_order_matches_pallas_v3():
    """One panel against the JAX Pallas v3 kernel in interpret mode (its
    tile T = 128, two tile columns, off > 0, padded rows) at 1e-5."""
    K, m, off, nb, T = 2, 256, 16, 16, 128
    n_real = m - 6
    A = _sym_window(np.random.default_rng(10), K, m, n_real)
    A2 = jnp.transpose(jnp.asarray(A).reshape(K * m, m // T, T), (1, 0, 2))
    ref = _unpack_pallas(*jax_latrd_panel_v3(jnp.asarray(A), A2, off, 0, n_real, K=K, m=m,
                                             nb=nb, T=T, interpret=True), K, m, nb)
    got = emulated_panel(torch.as_tensor(A), off, 0, n_real, nb, n_cta=7, n_res=1)
    for r, g in zip(ref, got):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5)


def test_slot_bytes_and_ring_match_v4_layout():
    """v3 takes v4's tile slots and ring; one slot is a padded tile and two
    64-long column segments."""
    assert slot_bytes(4) == (64 * 68 + 128) * 4 and slot_bytes(8) == (64 * 66 + 128) * 8
    assert RING == {4: 3, 8: 2}
