// The persistent full-row LATRD panel kernel of latrd.cu (v1) and
// latrd_v2.cu (v2): one cooperative launch per panel, each block owning a
// run of live rows, templated on NG, the columns whose row corrections are
// formed together (1 for v1, 8 for v2).
//
// G blocks (one per SM, fewer for small windows: ops/latrd.py `panel_plan`,
// ops/latrd_v2.py `panel_plan`) run all nb columns in one launch. The live
// rows of the K windows (window-relative rows >= off; rows left of the panel
// stay zero) are cut into contiguous runs (`Rows`): with K <= G each
// window's rows into G / K runs of its own, else all K (m - off) of them
// into G runs. At the start of the panel each block copies the columns from
// the panel on of its first n_res rows into shared memory (cp.async) and
// keeps its rows of U and W there as the panel grows: the window does not
// change during a panel (the trailing update runs after it). Each column is
// three phases and two grid barriers (a counter in `work`, zeroed by one
// memset per panel; latrd_common.cuh's `grid_sync`):
//
//   (a) the corrected column on the block's rows, and the block's sum of
//       squares below c per window into its slot. NG = 1: the whole
//       correction sum_{q<j} U[q,i] W[q,c] + W[q,i] U[q,c] every column,
//       from the block's entries of window row c (`rowc`). NG = 8: at the
//       first column c8 of each group of 8, the corrections of every
//       earlier group to window rows c8 .. c8+7 on the block's rows as one
//       (2 j8) x 8 product (`rowc` holds the 8 rows, corrected in place);
//       then each column subtracts at most 7 in-group terms;  -- barrier --
//   (b) the whole corrected column of each window the block touches comes
//       in by cp.async, its blocks' sums of squares by one load a lane, and
//       U, W at the next group's NG rows (when column j+1 starts one) for
//       later columns, all in flight at once; every block forms its
//       windows' reflectors itself (the owner of row c writes d, e, tau),
//       turns the staged column into v and writes v on its rows; each entry
//       of U v and W v is formed whole by one block of the window (one
//       warp, rows of U and W from L2); y = A v on own rows, one warp a
//       row; the rows' share of y.v goes into the block's slot;
//                                                             -- barrier --
//   (c) U v, W v from the blocks that formed them, y.v from every block's
//       share in block order, then w on its rows, one thread a row
//       (`w_entry`). Each block also forms v and w at the rows of the
//       current group after c (or at the next group's NG rows), with the
//       same compiled code and inputs as those rows' owners, so the next
//       column's (a) needs no third barrier.
//
// Rows past n_res. NG = 1 (v1 never meets them on its route): one warp a
// row reads the row from L2 every column. NG = 8: warp w streams the rows
// n_res + w, n_res + w + 8, ... in chunks of kChunkBytes through a cp.async
// ring of its own (kRingSlots chunks, kRingSlots - 1 of them in flight, the
// first ones issued in (b) once the column has come in: they do not depend
// on v); each lane copies and reads only its own columns of a chunk, the
// columns it reads of a resident row, so no barrier paces the stream. Odd
// columns visit a warp's chunks in reverse, so that the first chunks of a
// column are the last of the previous one, still in L2. (A ring shared by
// the block's warps, deeper rings, other chunk sizes and bulk copies on
// mbarriers were slower on the card: the stream is not short of bytes in
// flight, and each ring slot costs resident rows.)
//
// Numbers. No atomics: every sum has one order (warp shuffle trees, loops
// in a fixed order, cross-block sums in block order, the chunk order fixed
// by the column's parity), so two launches on the same window agree bit
// for bit. The reflector test keeps `mul_rn`.

#pragma once

#include "latrd_common.cuh"

namespace latrd {

constexpr int kRingSlots = 2;           // streamed chunks in each warp's ring (NG > 1)
constexpr int kChunkBytes = 2048;       // a chunk: this many bytes of one row
template <typename T> constexpr int kChunk = kChunkBytes / sizeof(T);

// `work`: the barrier counter, then per (window, block) slots of the sums of
// squares and of y.v (2 x (K, G)), and U v, W v per window (K, 2nb); G <=
// the SM count
inline size_t rows_work(int K, int nb) {
  return kBarrierElems + (size_t)K * (2 * sm_count() + 2 * nb);
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

// The rows a block owns at most: L = m - off live rows a window, K windows,
// G blocks (as `Rows` cuts them)
__host__ __device__ inline int rows_per_block(int K, int L, int G) {
  return K <= G ? (L + G / K - 1) / (G / K) : (K * L + G - 1) / G;
}

// The dynamic shared memory, in elements of T: the ring of streamed chunks
// (NG > 1 with rows past n_res), the block's first n_res window rows
// (n_res x LW), the corrected column, then v, of each window it touches
// (NW x LW), its rows of U and W (2nb x R) with cache_rows, its entries of
// window rows off .. off+nb-1 (nb x R, NG = 1 with cache_rows) or of the
// current group's rows (NG x R), its rows' corrected column and y (2 x R),
// and per window U, W at the group's NG rows (NG x 2nb), U v, W v, y.v
// (2nb + 1) and tau, denom, s.t, then the sum of squares or y at NG rows
// (3 + NG).
struct Layout {
  int R, NW, cb, LW;  // rows a block owns at most, windows it touches at most,
                      // first cached column, cached columns (cb .. m-1)
  size_t ring, win, vst, uw, rowc, colr, yr, ucw, stv, scal, total;
};

template <typename T, int NG>
__host__ __device__ Layout layout(int K, int m, int off, int nb, int G, int n_res,
                                  bool cache_rows) {
  Layout l;
  const int L = m - off;
  l.R = rows_per_block(K, L, G);
  l.NW = K <= G ? 1 : (l.R + L - 2) / L + 1;
  if (l.NW > K) l.NW = K;
  l.cb = (off + 1) / Vec<T>::n * Vec<T>::n;
  l.LW = m - l.cb;
  size_t o = 0;
  const auto take = [&](size_t& at, size_t elems) { at = o; o += elems; };
  take(l.ring, NG > 1 && n_res < l.R ? (size_t)kWarps * kRingSlots * kChunk<T> : 0);
  take(l.win, (size_t)n_res * l.LW);
  take(l.vst, (size_t)l.NW * l.LW);
  take(l.uw, cache_rows ? (size_t)2 * nb * l.R : 0);
  take(l.rowc, NG > 1 ? (size_t)NG * l.R : cache_rows ? (size_t)nb * l.R : 0);
  take(l.colr, l.R);
  take(l.yr, l.R);
  take(l.ucw, (size_t)l.NW * NG * 2 * nb);
  take(l.stv, (size_t)l.NW * (2 * nb + 1));
  take(l.scal, (size_t)l.NW * (3 + NG));
  l.total = o;
  return l;
}

// w at one row, by one thread: w = tau (y - sum_q U[q] t[q] + W[q] s[q]) -
// tau/2 (w.v) v with w.v = tau (y.v - 2 s.t); U[q] at ur[q rs], W[q] at
// ur[(nb + q) rs]; s, t, y.v at st[q], st[nb + q], st[2nb]; tau and s.t at
// sc[0], sc[2]. One compiled copy serves the row's owner and every block
// that forms w at that row itself, so all of them get the same bits.
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

// the correction sum_{q0 <= q < q1} U[q,i] W[q,x] + W[q,i] U[q,x] of row x
// on own row i: U[q,i], W[q,i] at ur[q rs], ur[(nb + q) rs]; U[q,x], W[q,x]
// at cv[q], cv[nb + q]
template <typename T>
__device__ __forceinline__ T row_correction(int q0, int q1, int nb, const T* ur, int rs,
                                            const T* cv) {
  T corr = 0;
  for (int q = q0; q < q1; ++q) corr += ur[q * rs] * cv[nb + q] + ur[(nb + q) * rs] * cv[q];
  return corr;
}

template <typename T, int NG>
__global__ void __launch_bounds__(kBlock, 1)
k_panel(Panel<T> p, int off, int n_res, int cache_rows) {
  using V = typename Vec<T>::type;
  constexpr int n = Vec<T>::n, SC = 3 + NG, CH = kChunk<T>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int G = gridDim.x, b = blockIdx.x, nb = p.nb, nb2 = 2 * nb, S1 = nb2 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int L = p.m - off;
  const Layout lay = layout<T, NG>(p.K, p.m, off, nb, G, n_res, cache_rows);
  const Rows rows(p.K, L, G);
  const int g0 = rows.start(b), nr = rows.start(b + 1) - g0;
  const int k0 = g0 / L, nw = (g0 + nr - 1) / L - k0 + 1;
  const int R = lay.R, LW = lay.LW, cb = lay.cb;
  const int nres = n_res < nr ? n_res : nr;   // own rows resident in shared memory
  const int live = p.lend > cb ? p.lend - cb : 0;  // staged columns of the corrected column
  T* ring = sm + lay.ring;  // (kWarps, kRingSlots, CH): each warp's streamed chunks
  T* win = sm + lay.win;    // (n_res, LW): own window rows, columns cb ..
  T* vst = sm + lay.vst;    // (NW, LW): corrected column, then v, columns cb ..
  T* uw = sm + lay.uw;      // (2nb, R): own rows of U and W
  T* rowc = sm + lay.rowc;  // (nb or NG, R): own entries of window rows off .. or c8 ..
  T* colr = sm + lay.colr;  // (R): own rows' corrected column
  T* yr = sm + lay.yr;      // (R): own rows' y
  T* ucw = sm + lay.ucw;    // (NW, NG, 2nb): U and W at the group's rows
  T* stv = sm + lay.stv;    // (NW, S1): U v, W v, y.v
  T* scal = sm + lay.scal;  // (NW, SC): tau, denom, s.t, sum of squares / y at NG rows
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
  // NG > 1: window rows x .. x+NG-1 on own rows into rowc (cp.async)
  const auto load_group_rows = [&](int x) {
    for (int e = threadIdx.x; e < NG * nr; e += kBlock) {
      const int h = e / nr, r = e % nr;
      cp_async_elem(rowc + (size_t)h * R + r,
                    p.Aw + ((size_t)win_of(r) * mm + x + h) * mm + row_of(r));
    }
    cp_async_commit();
  };

  // rows left of the panel stay zero in U and W
  for (size_t e = (size_t)b * kBlock + threadIdx.x; e < (size_t)p.K * nb2 * off;
       e += (size_t)G * kBlock)
    p.UW[e / off * mm + e % off] = 0;
  // first touch: own resident window rows (columns cb ..) and the panel's
  // (NG = 1) or the first group's (NG > 1) window rows
  if (nres > 0) {
    const int per_row = LW / n;
    for (int e = threadIdx.x; e < nres * per_row; e += kBlock) {
      const int r = e / per_row, cv = e % per_row * n;
      cp_async16(win + (size_t)r * LW + cv,
                 p.Aw + ((size_t)win_of(r) * mm + row_of(r)) * mm + cb + cv);
    }
    cp_async_commit();
  }
  if constexpr (NG > 1) {
    load_group_rows(off);
  } else if (cache_rows) {
    for (int e = threadIdx.x; e < nb * nr; e += kBlock) {
      const int jj = e / nr, r = e % nr;
      rowc[(size_t)jj * R + r] = p.Aw[((size_t)win_of(r) * mm + off + jj) * mm + row_of(r)];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  for (int j = 0; j < nb; ++j) {
    const int c = off + j, j2 = 2 * j, h = j % NG, j8 = j - h;
    const bool ok = c + p.q_base < p.n_real - 2;

    // (a) the corrected column on own rows i >= c, one thread a row (U and W
    // at row c are in ucw since an earlier column), and the block's sum of
    // squares below c per window
    if constexpr (NG > 1) {
      if (h == 0) {  // the group's rows, corrected for every earlier group at once
        cp_async_wait<0>();
        __syncthreads();
        for (int e = threadIdx.x; e < NG * nr; e += kBlock) {
          const int hh = e / nr, r = e % nr;
          const int k = win_of(r), i = row_of(r);
          if (i < c || i >= p.nv) continue;
          rowc[(size_t)hh * R + r] -= row_correction(0, j8, nb, uw_row(r, k, i), uw_rs,
                                                     ucw + ((k - k0) * NG + hh) * nb2);
        }
        __syncthreads();
      }
    }
    for (int r = threadIdx.x; r < nr; r += kBlock) {
      const int k = win_of(r), i = row_of(r);
      if (i < c) continue;
      T val = 0;
      if (i < p.nv) {
        const T* cv = ucw + ((k - k0) * NG + h) * nb2;
        if constexpr (NG > 1)
          val = rowc[(size_t)h * R + r] - row_correction(j8, j, nb, uw_row(r, k, i), uw_rs, cv);
        else
          val = rowc_at(j, r, k, i) - row_correction(0, j, nb, uw_row(r, k, i), uw_rs, cv);
      }
      p.col[k * mm + i] = val;
      colr[r] = val;
    }
    __syncthreads();
    for (int w = warp; w < nw; w += kWarps) {
      const int k = k0 + w;
      T sq = 0;
      for (int r = first_row(k) + lane; r < end_row(k); r += 32)
        if (row_of(r) > c) sq += mul_rn(colr[r], colr[r]);
      sq = warp_sum(sq);
      if (lane == 0) sq_slot[k * G + b] = sq;
    }
    grid_sync(bar, target);

    // (b) the whole corrected column of each window (cp.async from L2), its
    // blocks' sums of squares (lanes over blocks, one fixed tree), and U, W
    // at the next group's rows, all in flight at once
    {
      const int per_row = live / n;
      for (int e = threadIdx.x; e < nw * per_row; e += kBlock) {
        const int w = e / per_row, cv = e % per_row * n;
        cp_async16(vst + (size_t)w * LW + cv, p.col + (k0 + w) * mm + cb + cv);
      }
      cp_async_commit();
      for (int e = threadIdx.x; e < nw * (LW - live); e += kBlock)
        vst[(size_t)(e / (LW - live)) * LW + live + e % (LW - live)] = 0;
    }
    const int l0 = vec_floor<T>(c + 1) - cb;
    // the streamed rows (own rows nres ..): warp w takes rows nres + w,
    // nres + w + kWarps, ... (its q-th row r_q), each in chunks t of CH
    // columns from l0, row by row and chunk by chunk, both in reverse on odd
    // columns. A lane copies, and later reads, only its own vectors of a
    // chunk (the lane's columns of a resident row), so a warp's ring needs no
    // barrier. `at` is the next chunk to copy, kRingSlots - 1 ahead of use.
    const bool rev = j & 1;
    const int nch = NG > 1 && live > l0 ? (live - l0 + CH - 1) / CH : 0;
    const int n_mine = nr - nres > warp ? (nr - nres - warp + kWarps - 1) / kWarps : 0;
    const int n_units = n_mine * nch;
    T* wring = ring + (size_t)warp * kRingSlots * CH;
    struct Chunk {
      int q, t;
      const T* src;  // the row's column cb, or null for a row that is not live
    } at{rev ? n_mine - 1 : 0, rev ? nch - 1 : 0, nullptr};
    const auto row_src = [&](int q) -> const T* {
      const int r = nres + warp + q * kWarps, i = row_of(r);
      return i > c && i < p.nv ? p.Aw + ((size_t)win_of(r) * mm + i) * mm + cb : nullptr;
    };
    const auto issue_next = [&](int u) {  // `at` into slot u % kRingSlots, then step
      if (at.t == (rev ? nch - 1 : 0)) at.src = row_src(at.q);
      if (at.src) {
        const int l = l0 + at.t * CH;
        T* dst = wring + (size_t)(u % kRingSlots) * CH;
        for (int cv = lane * n; cv < CH && l + cv < live; cv += 32 * n)
          cp_async16(dst + cv, at.src + l + cv);
      }
      if (rev ? --at.t < 0 : ++at.t == nch) {
        at.t = rev ? nch - 1 : 0;
        at.q += rev ? -1 : 1;
      }
    };
    if ((j + 1) % NG == 0 && j + 1 < nb)  // rows c+1 .. c+NG, h fastest
      for (int e = threadIdx.x; e < nw * j2 * NG; e += kBlock) {
        const int w = e / (j2 * NG), q = row_q(e / NG % j2, j), hh = e % NG;
        ucw[(w * NG + hh) * nb2 + q] =
            __ldcg(p.UW + ((size_t)(k0 + w) * nb2 + q) * mm + c + 1 + hh);
      }
    for (int w = warp; w < nw; w += kWarps) {
      const int k = k0 + w, b1 = rows.owner(k * L + L - 1);
      T sq = 0;
      for (int bb = rows.owner(k * L) + lane; bb <= b1; bb += 32) sq += __ldcg(sq_slot + k * G + bb);
      sq = warp_sum(sq);
      if (lane == 0) scal[w * SC + 3] = sq;
    }
    cp_async_wait<0>();
    __syncthreads();
    // the streamed rows' first chunks (they do not depend on v), behind the
    // column's copies
    if constexpr (NG > 1) {
      for (int u = 0; u < kRingSlots - 1; ++u) {
        if (u < n_units) issue_next(u);
        cp_async_commit();
      }
    }
    // the reflector of each window; the owner of row c writes d, e, tau
    for (int w = threadIdx.x; w < nw; w += kBlock) {
      const int k = k0 + w;
      const T alpha = c + 1 < p.m ? vst[(size_t)w * LW + c + 1 - cb] : T(0);
      const T d = vst[(size_t)w * LW + c - cb];
      const Reflector<T> rf = house_from(p, c, j, k, scal[w * SC + 3], alpha, d, false);
      scal[w * SC] = rf.tau;
      scal[w * SC + 1] = rf.denom;
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
      const T denom = scal[w * SC + 1];
      T* x = vst + (size_t)w * LW;
      for (int l = cb + threadIdx.x; l < p.m; l += kBlock)
        x[l - cb] = l < p.nv ? reflector_entry(x[l - cb], l, c, ok, denom) : T(0);
    }
    __syncthreads();
    // v on own rows (row j of U)
    for (int r = threadIdx.x; r < nr; r += kBlock) {
      const int k = win_of(r), i = row_of(r);
      const T v = vst[(size_t)(k - k0) * LW + i - cb];
      p.UW[((size_t)k * nb2 + j) * mm + i] = v;
      if (cache_rows) uw[(size_t)j * R + r] = v;
    }
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
          acc += vdot(__ldcg(reinterpret_cast<const V*>(u + l)),
                      *reinterpret_cast<const V*>(v + l));
        acc = warp_sum(acc);
        if (lane == 0) st_win[(size_t)k * nb2 + row_q(e, j)] = acc;
      }
    }
    // y = A v on own rows c < i < nv, one warp a row (the last warps also
    // took the dot products above): the resident rows, and with NG = 1 the
    // others from L2
    for (int r = warp; r < (NG > 1 ? nres : nr); r += kWarps) {
      const int k = win_of(r), i = row_of(r);
      T y = 0;
      if (i > c && i < p.nv) {
        const T* a = r < nres ? win + (size_t)r * LW : p.Aw + ((size_t)k * mm + i) * mm + cb;
        const T* v = vst + (size_t)(k - k0) * LW;
        for (int l = l0 + lane * n; l < live; l += 32 * n)
          y += vdot(*reinterpret_cast<const V*>(a + l), *reinterpret_cast<const V*>(v + l));
        y = warp_sum(y);
      }
      if (lane == 0) {
        yr[r] = y;
        p.y[k * mm + i] = y;
      }
    }
    if constexpr (NG > 1) {
      // the streamed rows through each warp's ring, a row's sum kept in each
      // lane across its chunks
      for (int qq = 0, u = 0; qq < n_mine; ++qq) {
        const int q = rev ? n_mine - 1 - qq : qq, r = nres + warp + q * kWarps;
        const int k = win_of(r), i = row_of(r);
        const T* v = vst + (size_t)(k - k0) * LW + l0;
        T y = 0;
        for (int tt = 0; tt < nch; ++tt, ++u) {
          if (u + kRingSlots - 1 < n_units) issue_next(u + kRingSlots - 1);
          cp_async_commit();
          cp_async_wait<kRingSlots - 1>();
          const int t = rev ? nch - 1 - tt : tt;
          const T* a = wring + (size_t)(u % kRingSlots) * CH;
          if (i > c && i < p.nv)
            for (int cv = lane * n; cv < CH && t * CH + cv < live - l0; cv += 32 * n)
              y += vdot(*reinterpret_cast<const V*>(a + cv),
                        *reinterpret_cast<const V*>(v + t * CH + cv));
        }
        y = warp_sum(y);
        if (lane == 0) {
          yr[r] = y;
          p.y[k * mm + i] = y;
        }
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
      acc = warp_sum(acc);
      if (lane == 0) yv_slot[k * G + b] = acc;
    }
    grid_sync(bar, target);

    // (c) per window: U v and W v from the blocks that formed them, y.v
    // from every block's share (lanes over blocks, one fixed tree), y at the
    // nn rows whose v and w this block forms below (c+1 .. ; lane h has row
    // c+1+h), then s.t
    const int hn = (j + 1) % NG, nn = j + 1 < nb ? NG - hn : 0;
    if constexpr (NG > 1) {
      if (hn == 0 && nn > 0) load_group_rows(c + 1);  // in flight until the next (a)
    }
    for (int w = warp; w < nw; w += kWarps) {
      const int k = k0 + w, b1 = rows.owner(k * L + L - 1);
      // every load in flight before the first is used: 4 entries and 5
      // blocks a lane at a time
      const T yn = lane < nn && c + 1 + lane < p.nv ? __ldcg(p.y + k * mm + c + 1 + lane) : T(0);
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
      yv = warp_sum(yv);
      if (lane == 0) stv[w * S1 + nb2] = yv;
      if (lane < nn) scal[w * SC + 3 + lane] = yn;
      __syncwarp();
      T sdt = 0;
      for (int q = lane; q < j; q += 32) sdt += stv[w * S1 + q] * stv[w * S1 + nb + q];
      sdt = warp_sum(sdt);
      if (lane == 0) scal[w * SC + 2] = sdt;
    }
    __syncthreads();
    // w on own rows (row nb+j of W), one thread a row
    for (int r = threadIdx.x; r < nr; r += kBlock) {
      const int k = win_of(r), i = row_of(r), w = k - k0;
      T wi = 0;
      if (i > c && i < p.nv)
        wi = w_entry(j, nb, uw_row(r, k, i), uw_rs, stv + w * S1, scal + w * SC, yr[r],
                     vst[(size_t)w * LW + i - cb]);
      p.UW[((size_t)k * nb2 + nb + j) * mm + i] = wi;
      if (cache_rows) uw[(size_t)(nb + j) * R + r] = wi;
    }
    // U and W at rows c+1 .. of each window whose later corrections need
    // them (group slots hn .. NG-1): w there formed here as its owner forms
    // it, v there from the staged v
    for (int e = kBlock - 1 - threadIdx.x; e < nw * nn; e += kBlock) {  // the last threads
      const int w = e / nn, x = c + 1 + e % nn;
      T* cw = ucw + (w * NG + hn + e % nn) * nb2;
      const T v1 = vst[(size_t)w * LW + x - cb];
      cw[j] = v1;
      cw[nb + j] = x < p.nv ? w_entry(j, nb, cw, 1, stv + w * S1, scal + w * SC,
                                      scal[w * SC + 3 + e % nn], v1)
                            : T(0);
    }
    __syncthreads();
  }
}

// One panel of k_panel<T, NG> on n_cta blocks, after checking the block
// count against the window (with K <= n_cta, a multiple of K and at most a
// block a live row) and n_res against the rows a block owns.
template <typename T, int NG>
cudaError_t launch_rows_panel(const Panel<T>& p, int off, int n_cta, int n_res, int cache_rows,
                              cudaStream_t s) {
  const int L = p.m - off;
  if (n_cta < 1 || n_cta > sm_count() ||
      (p.K <= n_cta ? n_cta % p.K != 0 || n_cta / p.K > L : (long long)n_cta > (long long)p.K * L))
    return cudaErrorInvalidValue;
  const Layout lay = layout<T, NG>(p.K, p.m, off, p.nb, n_cta, n_res, cache_rows);
  if (n_res < 0 || n_res > lay.R) return cudaErrorInvalidValue;
  void (*kernel)(Panel<T>, int, int, int) = k_panel<T, NG>;
  const size_t smem = lay.total * sizeof(T);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(p.work, 0, sizeof(unsigned), s)) != cudaSuccess) return err;
  Panel<T> pp = p;
  void* args[] = {&pp, &off, &n_res, &cache_rows};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(n_cta),
                                    dim3(kBlock), args, smem, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace latrd

// The C interface of latrd.cu and latrd_v2.cu: the panel contract's
// arguments, then the block count and two plan arguments of the kernel's
// `panel_plan` before the stream; RUN<T>(panel, off, n_cta, a, b, stream)
// runs it and SMEM<T>(K, m, off, nb, n_cta, a, b) is the launch's dynamic
// shared memory in bytes (`smem_bytes`). The partial sums live in `work`,
// so `part` is empty.
#define LATRD_ROWS_EXPORTS(RUN, SMEM)                                                       \
  extern "C" int panel_f32(const void* Aw, void* UW, void* det, void* col, void* part,      \
                           void* y, void* st, void* scal, void* work, int K, int m, int nb,  \
                           int off, int q_base, int n_real, int n_cta, int a, int b,         \
                           void* stream) {                                                   \
    return (int)RUN<float>(latrd::make_panel<float>(Aw, UW, det, col, part, y, st, scal,     \
                                                    work, K, m, nb, q_base, n_real),         \
                           off, n_cta, a, b, static_cast<cudaStream_t>(stream));             \
  }                                                                                          \
  extern "C" int panel_f64(const void* Aw, void* UW, void* det, void* col, void* part,      \
                           void* y, void* st, void* scal, void* work, int K, int m, int nb,  \
                           int off, int q_base, int n_real, int n_cta, int a, int b,         \
                           void* stream) {                                                   \
    return (int)RUN<double>(latrd::make_panel<double>(Aw, UW, det, col, part, y, st, scal,   \
                                                      work, K, m, nb, q_base, n_real),       \
                            off, n_cta, a, b, static_cast<cudaStream_t>(stream));            \
  }                                                                                          \
  extern "C" size_t work_elems(int K, int, int nb) { return latrd::rows_work(K, nb); }       \
  extern "C" size_t part_elems(int, int) { return 0; }                                       \
  extern "C" size_t smem_bytes(int K, int m, int off, int nb, int n_cta, int a, int b,       \
                               int itemsize) {                                               \
    return itemsize == 4 ? SMEM<float>(K, m, off, nb, n_cta, a, b)                           \
                         : SMEM<double>(K, m, off, nb, n_cta, a, b);                         \
  }                                                                                          \
  extern "C" const char* error_string(int e) {                                               \
    return cudaGetErrorString(static_cast<cudaError_t>(e));                                  \
  }
