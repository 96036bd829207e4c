// LATRD panel kernel for Hopper (sm_90a): one persistent cooperative launch
// per panel, each block's rows of the window resident in shared memory.
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas.py, `latrd_panel`
// (body `_panel_kernel`): one panel of blocked Householder
// tridiagonalization on K symmetric windows, used by stage 1 of the
// two-stage eigensolver for 512 <= n < 2304 (ResNet-18 KFAC classes
// n = 512 (K=6), 576 (K=5), 1152 (K=4)), with the full trailing matvec.
//
// Design. The TPU kernel keeps the U/W panel in VMEM for the whole panel.
// Here G blocks (one per SM, fewer for small windows: ops/latrd.py
// `panel_plan`) run all nb columns in one launch. The live rows of the K
// windows (window-relative rows >= off; rows left of the panel stay zero)
// are cut into contiguous runs (`Rows`): with K <= G each window's rows
// into G / K runs of its own, else all K (m - off) of them into G runs.
// At the start of the panel each block
// copies its rows' columns from the panel on (cp.async) into shared memory,
// with their entries of window rows off .. off+nb-1, and keeps its rows of U
// and W there as the panel grows: the window does not change during a panel
// (the trailing update runs after it), so after this first touch the matvec
// reads no window bytes from L2 or HBM. Each column is three phases and two
// grid barriers (a counter in `work`, zeroed by one memset per panel;
// latrd_common.cuh's `grid_sync`):
//
//   (a) the corrected column on the block's rows (k_col's arithmetic), from
//       U[:, c] and W[:, c] already in shared memory, and the block's sum of
//       squares below c per window into its slot;            -- barrier --
//   (b) the whole corrected column of each window the block touches comes
//       in by cp.async, its blocks' sums of squares by one load a lane, and
//       U, W at row c+1 for the next column, all in flight at once; every
//       block forms its windows' reflectors itself (the owner of row c
//       writes d, e, tau), turns the staged column into v and writes v on
//       its rows; each entry of U v and W v is formed whole by one block of
//       the window (one warp, rows of U and W from L2); y = A v on own rows
//       (one warp a row); the rows' share of y.v goes into the block's
//       slot;                                                 -- barrier --
//   (c) U v, W v from the blocks that formed them, y.v from every block's
//       share in block order, then w on its rows, one thread a row (k_w's
//       arithmetic, `w_entry`). Each block also forms w at row c+1 of its
//       windows, with the same compiled code and inputs as that row's
//       owner, so the next column's (a) needs no third barrier.
//
// With blocks of its own for each window, no block does a second window's
// staging and sums while the others wait at a barrier. All loads of a phase
// are in flight before the first is used: a column's time is its barriers
// and its chain of dependent L2 round trips, not its arithmetic.
//
// Numbers. No atomics: every sum has one order (warp shuffle trees, loops
// in a fixed order, cross-block sums in block order), so two launches on
// the same window agree bit for bit. The reflector test keeps `mul_rn`.
//
// Where the rows do not fit (float64 at (4, 1152), 322 KB a block), each
// block streams its own window rows from L2 every column; where even its
// rows of U and W do not, it reads them from UW. A window whose per-window
// vectors do not fit raises.
//
// Bound. The matvec is 2 K (m-c)^2 flops a column, 0.011 ms a panel at
// (4, 1152) in float32 at the card's float32 rate; with the window on chip
// the panel is bound by its 2 nb grid barriers and the L2 round trips of
// each column (two in (b), one in (c)).

#include "latrd_common.cuh"

namespace {

using latrd::kBarrierElems;
using latrd::kBlock;
using latrd::kWarps;

// `work`: the barrier counter, then per (window, block) slots of the sums of
// squares and of y.v (2 x (K, G)), and U v, W v per window (K, 2nb); G <=
// the SM count
size_t work(int K, int, int nb) {
  return kBarrierElems + (size_t)K * (2 * latrd::sm_count() + 2 * nb);
}

// The live rows k L + (i - off), L = m - off. With K <= G each window has
// G / K blocks of its own and its L rows are cut into G / K runs; with K > G
// all K L rows are cut into G runs, so a block may touch several windows.
// Runs differ in length by at most one; block b owns [start(b), start(b+1)).
struct Rows {
  int L, gk, base, extra;  // gk: blocks per window, or 0
  __host__ __device__ Rows(int K, int L_, int G) : L(L_), gk(K <= G ? G / K : 0) {
    const int total = gk ? L : K * L, parts = gk ? gk : G;
    base = total / parts;
    extra = total % parts;
  }
  __host__ __device__ int run_start(int t) const { return t * base + (t < extra ? t : extra); }
  __host__ __device__ int run_of(int x) const {
    const int big = extra * (base + 1);
    return x < big ? x / (base + 1) : extra + (x - big) / base;
  }
  __host__ __device__ int start(int b) const {
    return gk ? b / gk * L + run_start(b % gk) : run_start(b);
  }
  __host__ __device__ int owner(int g) const { return gk ? g / L * gk + run_of(g % L) : run_of(g); }
};

// The dynamic shared memory, in elements of T: the block's window rows
// (R x LW, with cache_window), the corrected column, then v, of each window
// it touches (NW x LW), its rows of U and W (2nb x R) and of window rows
// off .. off+nb-1 (nb x R) with cache_rows, its rows' corrected column and
// y (2 x R), and per window U[:, c], W[:, c] (2nb), U v, W v, y.v (2nb + 1)
// and tau, denom, s.t, one spare value (4).
struct Layout {
  int R, NW, cb, LW;  // rows a block owns at most, windows it touches at most,
                      // first cached column, cached columns (cb .. m-1)
  size_t win, vst, uw, rowc, colr, yr, ucw, stv, scal, total;
};

template <typename T>
__host__ __device__ Layout layout(int K, int m, int off, int nb, int G, bool cache_window,
                                  bool cache_rows) {
  Layout l;
  const int L = m - off;
  if (K <= G) {
    const int gk = G / K;
    l.R = (L + gk - 1) / gk;
    l.NW = 1;
  } else {
    l.R = (K * L + G - 1) / G;
    l.NW = (l.R + L - 2) / L + 1;
    if (l.NW > K) l.NW = K;
  }
  l.cb = (off + 1) / latrd::Vec<T>::n * latrd::Vec<T>::n;
  l.LW = m - l.cb;
  size_t o = 0;
  const auto take = [&](size_t& at, size_t elems) { at = o; o += elems; };
  take(l.win, cache_window ? (size_t)l.R * l.LW : 0);
  take(l.vst, (size_t)l.NW * l.LW);
  take(l.uw, cache_rows ? (size_t)2 * nb * l.R : 0);
  take(l.rowc, cache_rows ? (size_t)nb * l.R : 0);
  take(l.colr, l.R);
  take(l.yr, l.R);
  take(l.ucw, (size_t)l.NW * 2 * nb);
  take(l.stv, (size_t)l.NW * (2 * nb + 1));
  take(l.scal, (size_t)l.NW * 4);
  l.total = o;
  return l;
}

// w at one row, by one thread: w = tau (y - sum_q U[q] t[q] + W[q] s[q]) -
// tau/2 (w.v) v with w.v = tau (y.v - 2 s.t); U[q] at ur[q rs], W[q] at
// ur[(nb + q) rs]; s, t, y.v at st[q], st[nb + q], st[2nb]; tau and s.t at
// sc[0], sc[2]. One compiled copy serves the row's owner and every block
// that forms w at row c+1 itself, so all of them get the same bits.
template <typename T>
__device__ __noinline__ T w_entry(int j, int nb, const T* ur, int rs, const T* st, const T* sc,
                                  T y, T v) {
  T cu = 0, cw = 0;  // two chains: U^T t and W^T s
  for (int q = 0; q < j; ++q) {
    cu += ur[q * rs] * st[nb + q];
    cw += ur[(nb + q) * rs] * st[q];
  }
  const T tau = sc[0];
  const T wv = tau * (st[2 * nb] - 2 * sc[2]);
  return tau * (y - (cu + cw)) - T(0.5) * tau * wv * v;
}

template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
k_panel(latrd::Panel<T> p, int off, int cache_window, int cache_rows) {
  using V = typename latrd::Vec<T>::type;
  constexpr int n = latrd::Vec<T>::n;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int G = gridDim.x, b = blockIdx.x, nb = p.nb, nb2 = 2 * nb, S1 = nb2 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = p.m - off;
  const Layout lay = layout<T>(p.K, p.m, off, nb, G, cache_window, cache_rows);
  const Rows rows(p.K, L, G);
  const int g0 = rows.start(b), nr = rows.start(b + 1) - g0;
  const int k0 = g0 / L, nw = (g0 + nr - 1) / L - k0 + 1;
  const int R = lay.R, LW = lay.LW, cb = lay.cb;
  const int live = p.lend > cb ? p.lend - cb : 0;  // staged columns of the corrected column
  T* win = sm + lay.win;    // (R, LW): own window rows, columns cb ..
  T* vst = sm + lay.vst;    // (NW, LW): corrected column, then v, columns cb ..
  T* uw = sm + lay.uw;      // (2nb, R): own rows of U and W
  T* rowc = sm + lay.rowc;  // (nb, R): own entries of window rows off ..
  T* colr = sm + lay.colr;  // (R): own rows' corrected column
  T* yr = sm + lay.yr;      // (R): own rows' y
  T* ucw = sm + lay.ucw;    // (NW, 2nb): U[:, c] and W[:, c]
  T* stv = sm + lay.stv;    // (NW, S1): U v, W v, y.v
  T* scal = sm + lay.scal;  // (NW, 4): tau, denom, s.t, sum of squares / y at c+1
  const size_t mm = p.m;
  unsigned* bar = reinterpret_cast<unsigned*>(p.work);
  T* sq_slot = p.work + kBarrierElems;     // (K, G)
  T* yv_slot = sq_slot + (size_t)p.K * G;  // (K, G)
  T* st_win = yv_slot + (size_t)p.K * G;   // (K, 2nb): U v, W v
  unsigned target = 0;

  // own row r is row i of window k; window k's rows are own rows [r0, r1)
  const auto win_of = [&](int r) { return (g0 + r) / L; };
  const auto row_of = [&](int r) { return off + (g0 + r) % L; };
  const auto first_row = [&](int k) { return k * L - g0 > 0 ? k * L - g0 : 0; };
  const auto end_row = [&](int k) { return (k + 1) * L - g0 < nr ? (k + 1) * L - g0 : nr; };
  // own rows of U and W, and window row off+jj on own rows: shared memory,
  // or UW (rows this block wrote) and Aw
  const auto uw_row = [&](int r, int k, int i) {
    return cache_rows ? uw + r : p.UW + (size_t)k * nb2 * mm + i;
  };
  const int uw_rs = cache_rows ? R : p.m;
  const auto rowc_at = [&](int jj, int r, int k, int i) {
    return cache_rows ? rowc[(size_t)jj * R + r] : p.Aw[((size_t)k * mm + off + jj) * mm + i];
  };
  // entry e of U v (e < j) and W v (j <= e < 2j): row q of UW
  const auto row_q = [&](int e, int j) { return e < j ? e : nb + e - j; };

  // rows left of the panel stay zero in U and W
  for (size_t e = (size_t)b * kBlock + threadIdx.x; e < (size_t)p.K * nb2 * off;
       e += (size_t)G * kBlock)
    p.UW[e / off * mm + e % off] = 0;
  // first touch: own window rows (columns cb ..) and the panel's window rows
  if (cache_window) {
    const int per_row = LW / n;
    for (int e = threadIdx.x; e < nr * per_row; e += kBlock) {
      const int r = e / per_row, cv = e % per_row * n;
      latrd::cp_async16(win + (size_t)r * LW + cv,
                        p.Aw + ((size_t)win_of(r) * mm + row_of(r)) * mm + cb + cv);
    }
    latrd::cp_async_commit();
  }
  if (cache_rows)
    for (int e = threadIdx.x; e < nb * nr; e += kBlock) {
      const int jj = e / nr, r = e % nr;
      rowc[(size_t)jj * R + r] = p.Aw[((size_t)win_of(r) * mm + off + jj) * mm + row_of(r)];
    }
  latrd::cp_async_wait<0>();
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int c = off + j, j2 = 2 * j;
    const bool ok = c + p.q_base < p.n_real - 2;

    // (a) the corrected column on own rows i >= c, one thread a row (U[:, c],
    // W[:, c] are in ucw since the previous column), and the block's sum of
    // squares below c per window
    for (int r = threadIdx.x; r < nr; r += kBlock) {
      const int k = win_of(r), i = row_of(r);
      if (i < c) continue;
      T val = 0;
      if (i < p.nv) {
        const T* cv = ucw + (k - k0) * nb2;
        const T* ur = uw_row(r, k, i);
        T corr = 0;
        for (int q = 0; q < j; ++q)
          corr += ur[q * uw_rs] * cv[nb + q] + ur[(nb + q) * uw_rs] * cv[q];
        val = rowc_at(j, r, k, i) - corr;
      }
      p.col[k * mm + i] = val;
      colr[r] = val;
    }
    __syncthreads();
    for (int w = warp; w < nw; w += kWarps) {
      const int k = k0 + w;
      T sq = 0;
      for (int r = first_row(k) + lane; r < end_row(k); r += 32)
        if (row_of(r) > c) sq += latrd::mul_rn(colr[r], colr[r]);
      sq = latrd::warp_sum(sq);
      if (lane == 0) sq_slot[k * G + b] = sq;
    }
    latrd::grid_sync(bar, target);

    // (b) the whole corrected column of each window (cp.async from L2), its
    // blocks' sums of squares (lanes over blocks, one fixed tree), and U, W
    // at row c+1 for the next column, all in flight at once
    {
      const int per_row = live / n;
      for (int e = threadIdx.x; e < nw * per_row; e += kBlock) {
        const int w = e / per_row, cv = e % per_row * n;
        latrd::cp_async16(vst + (size_t)w * LW + cv, p.col + (k0 + w) * mm + cb + cv);
      }
      latrd::cp_async_commit();
      for (int e = threadIdx.x; e < nw * (LW - live); e += kBlock)
        vst[(size_t)(e / (LW - live)) * LW + live + e % (LW - live)] = 0;
    }
    if (j + 1 < nb)
      for (int e = threadIdx.x; e < nw * j2; e += kBlock) {
        const int w = e / j2, q = row_q(e % j2, j);
        ucw[w * nb2 + q] = __ldcg(p.UW + ((size_t)(k0 + w) * nb2 + q) * mm + c + 1);
      }
    for (int w = warp; w < nw; w += kWarps) {
      const int k = k0 + w, b1 = rows.owner(k * L + L - 1);
      T sq = 0;
      for (int bb = rows.owner(k * L) + lane; bb <= b1; bb += 32) sq += __ldcg(sq_slot + k * G + bb);
      sq = latrd::warp_sum(sq);
      if (lane == 0) scal[w * 4 + 3] = sq;
    }
    latrd::cp_async_wait<0>();
    __syncthreads();
    // the reflector of each window; the owner of row c writes d, e, tau
    for (int w = threadIdx.x; w < nw; w += kBlock) {
      const int k = k0 + w;
      const T alpha = c + 1 < p.m ? vst[(size_t)w * LW + c + 1 - cb] : T(0);
      const T d = vst[(size_t)w * LW + c - cb];
      const latrd::Reflector<T> rf = latrd::house_from(p, c, j, k, scal[w * 4 + 3], alpha, d, false);
      scal[w * 4] = rf.tau;
      scal[w * 4 + 1] = rf.denom;
      if (rows.owner(k * L + j) == b) {
        T* det = p.det + (size_t)k * 3 * nb;
        det[j] = d;
        det[nb + j] = rf.e;
        det[2 * nb + j] = rf.tau;
      }
    }
    __syncthreads();
    // v of each window in place of its corrected column (0 past nv)
    for (int w = 0; w < nw; ++w) {
      const T denom = scal[w * 4 + 1];
      T* x = vst + (size_t)w * LW;
      for (int l = cb + threadIdx.x; l < p.m; l += kBlock)
        x[l - cb] = l < p.nv ? latrd::reflector_entry(x[l - cb], l, c, ok, denom) : T(0);
    }
    __syncthreads();
    // v on own rows (row j of U)
    for (int r = threadIdx.x; r < nr; r += kBlock) {
      const int k = win_of(r), i = row_of(r);
      const T v = vst[(size_t)(k - k0) * LW + i - cb];
      p.UW[((size_t)k * nb2 + j) * mm + i] = v;
      if (cache_rows) uw[(size_t)j * R + r] = v;
    }
    const int l0 = latrd::vec_floor<T>(c + 1) - cb;
    // U v and W v over the whole window: entry e of window k is this
    // block's when e = (b - its first block) mod (its blocks); one warp an
    // entry, rows of U and W from L2
    for (int w = 0; w < nw; ++w) {
      const int k = k0 + w, bk = rows.owner(k * L), nk = rows.owner(k * L + L - 1) - bk + 1;
      const T* v = vst + (size_t)w * LW;
      for (int e = b - bk + (kWarps - 1 - warp) * nk; e < j2; e += kWarps * nk) {
        const T* u = p.UW + ((size_t)k * nb2 + row_q(e, j)) * mm + cb;
        T acc = 0;
#pragma unroll 4
        for (int l = l0 + lane * n; l < live; l += 32 * n)
          acc += latrd::vdot(__ldcg(reinterpret_cast<const V*>(u + l)),
                             *reinterpret_cast<const V*>(v + l));
        acc = latrd::warp_sum(acc);
        if (lane == 0) st_win[(size_t)k * nb2 + row_q(e, j)] = acc;
      }
    }
    // y = A v on own rows c < i < nv, one warp a row (the last warps also
    // took the dot products above)
    for (int r = warp; r < nr; r += kWarps) {
      const int k = win_of(r), i = row_of(r);
      T y = 0;
      if (i > c && i < p.nv) {
        const T* a = cache_window ? win + (size_t)r * LW : p.Aw + ((size_t)k * mm + i) * mm + cb;
        const T* v = vst + (size_t)(k - k0) * LW;
        for (int l = l0 + lane * n; l < live; l += 32 * n)
          y += latrd::vdot(*reinterpret_cast<const V*>(a + l), *reinterpret_cast<const V*>(v + l));
        y = latrd::warp_sum(y);
      }
      if (lane == 0) {
        yr[r] = y;
        p.y[k * mm + i] = y;
      }
    }
    __syncthreads();
    // own rows' share of y.v per window, into this block's slot
    for (int w = warp; w < nw; w += kWarps) {
      const int k = k0 + w;
      T acc = 0;
      for (int r = first_row(k) + lane; r < end_row(k); r += 32) {
        const int i = row_of(r);
        if (i > c) acc += yr[r] * vst[(size_t)w * LW + i - cb];
      }
      acc = latrd::warp_sum(acc);
      if (lane == 0) yv_slot[k * G + b] = acc;
    }
    latrd::grid_sync(bar, target);

    // (c) per window: U v and W v from the blocks that formed them, y.v
    // from every block's share (lanes over blocks, one fixed tree), y at
    // row c+1, then s.t
    for (int w = warp; w < nw; w += kWarps) {
      const int k = k0 + w, b1 = rows.owner(k * L + L - 1);
      // every load in flight before the first is used: 4 entries and 5
      // blocks a lane at a time
      const T y1 = lane == 0 && j + 1 < nb && c + 1 < p.nv ? __ldcg(p.y + k * mm + c + 1) : T(0);
      for (int e0 = 0; e0 < j2; e0 += 4 * 32) {
        T st[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + lane + 32 * u;
          st[u] = e < j2 ? __ldcg(st_win + (size_t)k * nb2 + row_q(e, j)) : T(0);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + lane + 32 * u;
          if (e < j2) stv[w * S1 + row_q(e, j)] = st[u];
        }
      }
      T yv = 0;
      for (int b0 = rows.owner(k * L); b0 <= b1; b0 += 5 * 32) {
        T part[5];
#pragma unroll
        for (int u = 0; u < 5; ++u) {
          const int bb = b0 + lane + 32 * u;
          part[u] = bb <= b1 ? __ldcg(yv_slot + k * G + bb) : T(0);
        }
#pragma unroll
        for (int u = 0; u < 5; ++u) yv += part[u];
      }
      yv = latrd::warp_sum(yv);
      if (lane == 0) {
        stv[w * S1 + nb2] = yv;
        scal[w * 4 + 3] = y1;
      }
      __syncwarp();
      T sdt = 0;
      for (int q = lane; q < j; q += 32) sdt += stv[w * S1 + q] * stv[w * S1 + nb + q];
      sdt = latrd::warp_sum(sdt);
      if (lane == 0) scal[w * 4 + 2] = sdt;
    }
    __syncthreads();
    // w on own rows (row nb+j of W), one thread a row
    for (int r = threadIdx.x; r < nr; r += kBlock) {
      const int k = win_of(r), i = row_of(r), w = k - k0;
      T wi = 0;
      if (i > c && i < p.nv)
        wi = w_entry(j, nb, uw_row(r, k, i), uw_rs, stv + w * S1, scal + w * 4, yr[r],
                     vst[(size_t)w * LW + i - cb]);
      p.UW[((size_t)k * nb2 + nb + j) * mm + i] = wi;
      if (cache_rows) uw[(size_t)(nb + j) * R + r] = wi;
    }
    // U and W at row c+1 of each window for the next column: w there formed
    // here as its owner forms it, v there from the staged v
    if (j + 1 < nb)
      for (int w = kBlock - 1 - threadIdx.x; w < nw; w += kBlock) {  // the last threads
        const T v1 = vst[(size_t)w * LW + c + 1 - cb];
        ucw[w * nb2 + j] = v1;
        ucw[w * nb2 + nb + j] =
            c + 1 < p.nv ? w_entry(j, nb, ucw + w * nb2, 1, stv + w * S1, scal + w * 4,
                                   scal[w * 4 + 3], v1)
                         : T(0);
      }
    __syncthreads();
  }
}

template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, int n_cta, int cache_window, int cache_rows,
                cudaStream_t s) {
  const int L = p.m - off;
  if (n_cta < 1 || n_cta > latrd::sm_count() ||
      (p.K <= n_cta ? n_cta % p.K != 0 || n_cta / p.K > L : (long long)n_cta > (long long)p.K * L))
    return cudaErrorInvalidValue;
  void (*kernel)(latrd::Panel<T>, int, int, int) = k_panel<T>;
  const size_t smem =
      layout<T>(p.K, p.m, off, p.nb, n_cta, cache_window, cache_rows).total * sizeof(T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(p.work, 0, sizeof(unsigned), s)) != cudaSuccess) return err;
  latrd::Panel<T> pp = p;
  void* args[] = {&pp, &off, &cache_window, &cache_rows};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(n_cta),
                                    dim3(kBlock), args, smem, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The C interface: latrd_common.cuh's LATRD_EXPORTS, with the block count
// and the two caching switches of ops/latrd.py `panel_plan` before the
// stream; smem_bytes(...) is the launch's dynamic shared memory. The
// partial sums live in `work`, so `part` is empty.
#define LATRD_V1_PANEL(NAME, T)                                                            \
  extern "C" int NAME(const void* Aw, void* UW, void* det, void* col, void* part, void* y,   \
                      void* st, void* scal, void* work, int K, int m, int nb, int off,       \
                      int q_base, int n_real, int n_cta, int cache_window, int cache_rows,   \
                      void* stream) {                                                        \
    return (int)run<T>(latrd::make_panel<T>(Aw, UW, det, col, part, y, st, scal, work, K, m, \
                                            nb, q_base, n_real),                             \
                       off, n_cta, cache_window, cache_rows,                                 \
                       static_cast<cudaStream_t>(stream));                                   \
  }
LATRD_V1_PANEL(panel_f32, float)
LATRD_V1_PANEL(panel_f64, double)
extern "C" size_t work_elems(int K, int m, int nb) { return work(K, m, nb); }
extern "C" size_t part_elems(int, int) { return 0; }
extern "C" size_t smem_bytes(int K, int m, int off, int nb, int n_cta, int cache_window,
                             int cache_rows, int itemsize) {
  return itemsize == 4
             ? layout<float>(K, m, off, nb, n_cta, cache_window, cache_rows).total * 4
             : layout<double>(K, m, off, nb, n_cta, cache_window, cache_rows).total * 8;
}
extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
