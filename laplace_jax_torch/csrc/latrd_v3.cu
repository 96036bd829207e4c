// Symmetric-half LATRD panel kernel with a fixed-order sum, for Hopper
// (sm_90a): one persistent cooperative launch per panel.
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas_v3.py,
// `latrd_panel_v3` (body `_panel_kernel`): the panel contract of latrd.cu,
// with the trailing matvec from the lower triangle of each window in square
// tiles, each tile A[R,S] (S <= R) serving y[R] += A[R,S] v[S] and y[S] +=
// A[R,S]^T v[R]. Stage 1 takes it when asked for (`eigh_stack_ts(stage1=
// "latrd_v3")`); the automatic choice never does, as in the JAX package.
// What sets v3 apart from v4 is that every sum of the panel has one order,
// so two launches on the same window agree bit for bit.
//
// Design. latrd_v4.cu's persistent panel with its atomic sums made slots,
// and latrd.cu's two grid barriers a column. One block per SM (grid = the SM
// count, cudaLaunchCooperativeKernel) runs all nb columns. The lower-
// triangle 64x64 tiles of the panel's trailing block go to the blocks in
// contiguous row-major runs (ops/latrd_v4.py `panel_schedule`); a block's
// first n_res tiles stay in shared memory for the panel, the others stream
// through a cp.async ring of kRing slots every column, in reverse order on
// odd columns. Block `cta` owns the row blocks u = cta, cta + G, ... and,
// where they fit (ops/latrd_v3.py `panel_plan`), keeps its rows of U and W
// in shared memory. Each column is three phases and two grid barriers (a
// counter in `work`, zeroed by one memset per panel):
//
//   (a) the corrected column and its partial sums of squares on the block's
//       rows (`col_block`'s arithmetic in latrd_common.cuh; row c of the window
//       staged by cp.async during the last column), and each row block's
//       share of U x and W x (x = the corrected column below c+1) into a slot
//       of its own;
//                                                              -- barrier --
//   (b) every block forms every window's reflector itself (`house_from`;
//       block 0 writes d, e, tau) and writes v on its rows; each entry of U v
//       and W v is summed whole by one warp from the row blocks' shares; the
//       matvec (`Matvec`) writes the row products of each strip (a block's
//       tiles sharing a tile row) and the column products of each tile into
//       slots of their own, and the block's share of x.(A x) into its slot;
//                                                              -- barrier --
//   (c) per window, y.v from the blocks' shares, s.t, and y and w at row
//       c+1, formed by every block from the same slots in the same order, so
//       that the next column's (a) needs no third barrier (the row's owner
//       stores that w); then y on the block's rows, gathered from the slots
//       (`YTerms`), and w there.
//
// Matvec. Warp w holds rows 8w..8w+7 of a tile and lane l its columns 2l,
// 2l+1. Row products add up in registers along a strip and are summed over
// the lanes once per strip; a tile's column products are summed over the
// warp's rows in registers and over the 8 warps by 64 threads after the next
// block barrier (which the ring needs anyway), from one of two buffers. The
// tiles multiply x = col (v = x / denom, x[c+1] = denom, 0 at and above c);
// y and y.v are scaled by 1/denom once, after their sums.
//
// Where the order is fixed. The slot of a strip is (block, tile row), of a
// column product its tile; the schedule is fixed per panel, so y on row
// block b of window k is, in this order: the row products of the strips of
// tile row b (their blocks in order), then the column products of the tiles
// (r, b), r > b, in r order; four threads a row each add every fourth term
// and the four parts are added as ((p0 + p1) + (p2 + p3)). A strip split
// between a block's resident and streamed tiles is flushed twice, the
// streamed part added to the resident part's slot. The other cross-block
// sums (sums of squares, U v and W v, y.v) run over the row blocks or the
// blocks in one warp's order. No atomics but the barrier's counter.
//
// Bound. The panel's operations take 0.125 ms at (3, 4608) in float32 with
// the window read once (chip_smoke.py `panel_bound_ms`), but neither the
// window (255 MB) nor a column's trailing triangle (129 MB) fits in L2 (50
// MB) and shared memory (30 MB): every column streams the triangle again,
// less the 10.8 MB of resident tiles (132 blocks x 5), 7.6 GB over the
// panel, 2.26 ms at 3.35 TB/s (`stream_bound_ms`). The ring keeps kRing-1
// tiles in flight while one is multiplied; the slots add K P 64 values
// written and read a column (P the tile pairs of a window: 2 MB at (3,
// 4608)), which stay in L2. From m <= 1152 every tile is resident, and a
// column costs its two grid barriers and its phases' chains of L2 round
// trips.

#include "latrd_tiles.cuh"

namespace {

using latrd::cp_async16;
using latrd::cp_async_commit;
using latrd::cp_async_wait;
using latrd::grid_sync;
using latrd::kBarrierElems;
using latrd::kBlock;
using latrd::kRows;
using latrd::kWarps;
using latrd::sm_count;
using latrd::TileAt;
using latrd::decode;
using latrd::kLd;
using latrd::kMaxRes;
using latrd::kRing;
using latrd::kSlot;
using latrd::kTile;
using latrd::load_slot;
constexpr int kParts = latrd::kGroups;  // threads summing one entry of y
constexpr int kBatch = 16;  // loads of a gather part in flight at once
constexpr int kGather = 8;  // ... of a warp's strided sum, a lane
constexpr int kDots = 8;    // entries of U x and W x a warp reduces at once
static_assert(kParts == 4, "y and w add four parts a row");

__host__ __device__ inline size_t tri(size_t x) { return x * (x + 1) / 2; }

// `work`: the barrier counter; each block's share of x.(A x) per window
// (K, G); each row block's share of U x and W x (K, m/64, 2nb); the row
// products of each strip ((K m/64 + G, 64), strip (block g, tile row kr) at
// kr + g) and the column products of each tile (K m/64 (m/64 + 1) / 2, 64),
// sized for off = 0, the most tiles a panel has.
struct Work {
  size_t yv, dots, rows, cols, total;
};
__host__ __device__ inline Work work_layout(int K, int m, int nb, int G) {
  const size_t nt = m / kTile;
  Work w;
  w.yv = kBarrierElems;
  w.dots = w.yv + (size_t)K * G;
  w.rows = (w.dots + (size_t)K * nt * 2 * nb + kTile - 1) / kTile * kTile;
  w.cols = w.rows + ((size_t)K * nt + G) * kTile;
  w.total = w.cols + (size_t)K * tri(nt) * kTile;
  return w;
}
size_t work(int K, int m, int nb) { return work_layout(K, m, nb, sm_count()).total; }

// The dynamic shared memory: the resident tiles' and the ring's slots; the
// 2nb rows of U and W on each of the n_cache row blocks this block owns (0,
// or all n_units of them); one staged 64-row vector per owned row block; per
// window U and W at row c (then c+1) (2nb), U v, W v and y.v (2nb + 1), tau,
// denom, s.t and y at row c+1 (4), 1/denom, x.(A x), alpha, d and the sum of
// squares (5).
template <typename T>
size_t dynamic_smem(int K, int nb, int n_res, int n_cache, int n_units) {
  const size_t tail = ((size_t)K * (4 * nb + 10) * sizeof(T) + 15) / 16 * 16;
  return ((size_t)(n_res + kRing<T>) * kSlot<T> + ((size_t)n_cache * 2 * nb + n_units) * kRows) *
             sizeof(T) + tail;
}

// Where the matvec's partial products live, and whose they are: the
// schedule hands block g the tiles [g base + min(g, extra), ...) of the
// panel's tiles in row-major order, base or base + 1 of them.
template <typename T>
struct Slots {
  T* rows;  // (strips, 64): row products, strip (block g, tile row kr) at kr + g
  T* cols;  // (tiles, 64): column products, tile x of the schedule at x
  int s0;   // first tile column of the panel's trailing block
  int nl;   // tile rows of a window in the schedule, m/64 - s0
  int base, extra;

  __device__ int owner(int x) const {  // the block whose run holds tile x
    const int big = extra * (base + 1);
    return x < big ? x / (base + 1) : extra + (x - big) / base;
  }
  __device__ int tile_at(int k, int r, int s) const {
    return k * (int)tri(nl) + (int)tri(r - s0) + s - s0;
  }
  __device__ int strip_row(int k, int r) const { return k * nl + r - s0; }
};

// The terms of y at row 64 b + l of window k, before the 1/denom scaling:
// the row products of the strips of tile row b (tiles (b, t0..b); their
// blocks in order), then the column products of the tiles (r, b), r = b+1
// .. rl (the last tile row inside nv). Part g of `parts` adds every
// parts-th term from the g-th on: `load` issues its first B loads, so that
// other work can go on while they are in flight, and `sum` adds them and
// the rest, B loads at a time.
template <typename T>
struct YTerms {
  const Slots<T>& sl;
  int k, b, l, seg0, nseg, n;

  __device__ YTerms(const Slots<T>& s, int k_, int b_, int t0, int rl, int l_)
      : sl(s), k(k_), b(b_), l(l_) {
    const int row0 = sl.tile_at(k, b, sl.s0);
    const int g0 = sl.owner(row0 + t0 - sl.s0);
    nseg = sl.owner(row0 + b - sl.s0) - g0 + 1;
    seg0 = sl.strip_row(k, b) + g0;
    n = nseg + rl - b;
  }
  __device__ T at(int e) const {  // term e, or 0 past the end
    const T* src = e < nseg ? sl.rows + (size_t)(seg0 + e) * kTile
                            : sl.cols + (size_t)sl.tile_at(k, b + 1 + e - nseg, b) * kTile;
    return e < n ? __ldcg(src + l) : T(0);
  }
  template <int B>
  __device__ void load(int e0, int parts, T (&x)[B]) const {
#pragma unroll
    for (int h = 0; h < B; ++h) x[h] = at(e0 + h * parts);
  }
  template <int B>
  __device__ T sum(int g, int parts, T (&x)[B]) const {
    T acc = 0;
    for (int e0 = g;;) {
#pragma unroll
      for (int h = 0; h < B; ++h) acc += x[h];  // + 0 past the end leaves acc
      e0 += B * parts;
      if (e0 >= n) return acc;
      load(e0, parts, x);
    }
  }
};

// a[i * stride], i < n, over a warp: lane l adds i = l, l + 32, ... in
// order, then warp_sum's tree; `load` and `sum` as in YTerms.
template <typename T>
struct Strided {
  const T* a;
  int n;
  size_t stride;

  template <int B>
  __device__ void load(int i0, T (&x)[B]) const {
#pragma unroll
    for (int h = 0; h < B; ++h) {
      const int i = i0 + 32 * h;
      x[h] = i < n ? __ldcg(a + i * stride) : T(0);
    }
  }
  template <int B>
  __device__ T sum(T (&x)[B]) const {
    T acc = 0;
    for (int i0 = threadIdx.x & 31;;) {
#pragma unroll
      for (int h = 0; h < B; ++h) acc += x[h];
      i0 += 32 * B;
      if (i0 >= n) return latrd::warp_sum(acc);
      load(i0, x);
    }
  }
};

template <typename T>
__device__ __forceinline__ T warp_gather(const T* a, int n, size_t stride) {
  const Strided<T> s{a, n, stride};
  T x[kGather];
  s.load(threadIdx.x & 31, x);
  return s.sum(x);
}

// cp.async of row c of the window on the block's row blocks into `stage`
template <typename T>
__device__ __forceinline__ void stage_row(const latrd::Panel<T>& p, int c, T* stage) {
  constexpr int n = latrd::Vec<T>::n, per = kRows / n;
  const int units = p.K * p.nrb, mine = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;
  for (int e = threadIdx.x; e < mine * per; e += kBlock) {
    const int lu = e / per, u = blockIdx.x + lu * gridDim.x, cv = e % per * n;
    cp_async16(stage + lu * kRows + cv,
               p.Aw + ((size_t)(u / p.nrb) * p.m + c) * p.m + u % p.nrb * kRows + cv);
  }
  cp_async_commit();
}

template <typename T> struct Vec2;  // two consecutive entries
template <> struct Vec2<float> { using type = float2; };
template <> struct Vec2<double> { using type = double2; };

// What every tile of one column needs. Only the tiles of tile column
// (c+1)/64 see rows <= c+1; the others multiply col as it is.
template <typename T>
struct Column {
  int c, t0;
  const T* denom;  // window k's at denom[4k]
  T* yv;           // this block's share of x.(A x) per window (shared memory)
};

template <typename T>
__device__ __forceinline__ T masked_x(T x, int i, const Column<T>& col, int k) {
  return i > col.c + 1 ? x : (i == col.c + 1 ? col.denom[4 * k] : T(0));
}

// The matvec of one column, per thread. Warp w holds rows 8w..8w+7 of a
// tile and lane l its columns 2l, 2l+1. The row products of a strip (tiles
// sharing window k and tile row r) add up in registers and are summed over
// the lanes once per strip (`flush_rows`). A tile's column products are
// summed over the warp's 8 rows in registers, then over the 8 warps by 64
// threads after the next block barrier (`reduce_cols`), from one of two
// buffers in shared memory. x.(A x) adds up per thread and is summed over
// the block whenever the window changes (`commit_yv`). Every sum has one
// order: the tiles' visiting order, fixed per column.
template <typename T>
struct Matvec {
  const latrd::Panel<T>& p;
  const Slots<T>& sl;
  const Column<T>& col;
  T (&cred)[2][kWarps][kTile];  // column products per warp
  T (&cxs)[2][kTile];           // x at those columns
  T (&wred)[kWarps];
  int again = -2;               // the strip whose resident tiles were flushed first
  int key = -1, k = 0, r = 0;   // the strip (code >> 10), or key -1
  int yk = -1;                  // the window whose x.(A x) is in yv, or -1
  int pend = -1, pbuf = 0;      // schedule place of the tile whose column products wait
  T acc[8], xr[8], yv = 0;

  __device__ Matvec(const latrd::Panel<T>& p_, const Slots<T>& sl_, const Column<T>& col_,
                    T (&cred_)[2][kWarps][kTile], T (&cxs_)[2][kTile], T (&wred_)[kWarps])
      : p(p_), sl(sl_), col(col_), cred(cred_), cxs(cxs_), wred(wred_) {}

  // The waiting tile's column products, summed over the warps in order,
  // into its slot; called after a block barrier.
  __device__ void reduce_cols() {
    if (pend < 0) return;
    if (threadIdx.x < kTile) {
      const int u = threadIdx.x;
      T s = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += cred[pbuf][w][u];
      sl.cols[(size_t)pend * kTile + u] = s;
      yv += s * cxs[pbuf][u];
    }
    pend = -1;
  }

  // The strip's row products, summed over the lanes, into its slot, or
  // added to it when the strip is `again` (this thread's own earlier store).
  __device__ void flush_rows() {
    if (key < 0) return;
    // halve the rows each step: lanes in fours end with row 4 b4 + 2 b3 +
    // b2 (b the lane's bits), and x there
    const int lane = threadIdx.x & 31;
    const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
    T h4[4], h3[2], x4[4], x3[2];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      h4[u] = (b4 ? acc[u + 4] : acc[u]) +
              __shfl_xor_sync(0xffffffffu, b4 ? acc[u] : acc[u + 4], 16);
      x4[u] = b4 ? xr[u + 4] : xr[u];
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      h3[u] = (b3 ? h4[u + 2] : h4[u]) + __shfl_xor_sync(0xffffffffu, b3 ? h4[u] : h4[u + 2], 8);
      x3[u] = b3 ? x4[u + 2] : x4[u];
    }
    T sum = (b2 ? h3[1] : h3[0]) + __shfl_xor_sync(0xffffffffu, b2 ? h3[0] : h3[1], 4);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 3) == 0) {
      yv += sum * (b2 ? x3[1] : x3[0]);
      T* dst = sl.rows + (size_t)(sl.strip_row(k, r) + blockIdx.x) * kTile +
               (threadIdx.x >> 5) * 8 + 4 * b4 + 2 * b3 + b2;
      *dst = key == again ? *dst + sum : sum;
    }
    key = -1;
  }

  // x.(A x) of window yk so far, summed over the block in order, into the
  // block's share; every thread of the block calls it at once.
  __device__ void commit_yv() {
    if (yk < 0) return;
    const T s = latrd::warp_sum(yv);
    if ((threadIdx.x & 31) == 0) wred[threadIdx.x >> 5] = s;
    __syncthreads();
    if (threadIdx.x == 0) {
      T t = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) t += wred[w];
      col.yv[yk] += t;
    }
    __syncthreads();
    yv = 0;
    yk = -1;
  }

  // One tile, schedule place x, from its slot, after a block barrier since
  // its copies landed and since the last tile wrote buffer buf ^ 1.
  __device__ void step(int code, int x, const T* slot, int buf) {
    reduce_cols();
    const TileAt t = decode(code);
    const int R = t.r * kTile, S = t.s * kTile;
    if (t.s < col.t0 || R >= p.nv) return;  // left the trailing block, or padding
    using V2 = typename Vec2<T>::type;
    const int lane = threadIdx.x & 31, w8 = (threadIdx.x >> 5) * 8;
    const T* segS = slot + kTile * kLd<T>;
    if (code >> 10 != key) {
      flush_rows();
      if (t.k != yk) {
        commit_yv();
        yk = t.k;
      }
      key = code >> 10;
      k = t.k;
      r = t.r;
      const T* segR = segS + kTile;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[i] = 0;
        xr[i] = t.r == col.t0 ? masked_x(segR[w8 + i], R + w8 + i, col, t.k) : segR[w8 + i];
      }
    }
    const V2 xs2 = *reinterpret_cast<const V2*>(segS + 2 * lane);
    T xs0 = xs2.x, xs1 = xs2.y;
    if (t.s == col.t0) {
      xs0 = masked_x(xs0, S + 2 * lane, col, t.k);
      xs1 = masked_x(xs1, S + 2 * lane + 1, col, t.k);
    }
    T c0 = 0, c1 = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const V2 a = *reinterpret_cast<const V2*>(slot + (w8 + i) * kLd<T> + 2 * lane);
      acc[i] += a.x * xs0 + a.y * xs1;
      c0 += a.x * xr[i];
      c1 += a.y * xr[i];
    }
    if (R == S) return;  // the diagonal tile is read whole: no mirror term
    *reinterpret_cast<V2*>(&cred[buf][w8 / 8][2 * lane]) = V2{c0, c1};
    if (w8 == 0) *reinterpret_cast<V2*>(&cxs[buf][2 * lane]) = V2{xs0, xs1};
    pend = x;
    pbuf = buf;
  }

  // After the last tile: a block barrier, then every sum still open.
  __device__ void finish() {
    __syncthreads();
    reduce_cols();
    flush_rows();
    commit_yv();
  }
};

// The panel. `sched` is panel_schedule's table: G+1 offsets, then each
// block's tiles as codes k << 20 | r << 10 | s; n_res of each block's tiles
// stay resident. Block `cta` owns row blocks u = cta + G lu (window k = u /
// nrb, rows b = u % nrb); with n_cache > 0 it keeps their rows of U and W
// in shared memory.
template <typename T>
__global__ void __launch_bounds__(kBlock, 1)
k_panel(latrd::Panel<T> p, int off, const int* __restrict__ sched, int n_res, int n_cache) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T red[latrd::kGroups][kRows];
  __shared__ __align__(16) T cred[2][kWarps][kTile];
  __shared__ __align__(16) T cxs[2][kTile];
  __shared__ T wred[kWarps];
  __shared__ int res_codes[kMaxRes];
  const int G = gridDim.x, cta = blockIdx.x;
  const int units = p.K * p.nrb, nb = p.nb, nb2 = 2 * nb, S1 = nb2 + 1;
  const int n_units = (units + G - 1) / G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* slots = reinterpret_cast<T*>(smem_raw);
  T* ring = slots + (size_t)n_res * kSlot<T>;
  T* cache = ring + (size_t)kRing<T> * kSlot<T>;     // (n_cache, 2nb, 64)
  T* stage = cache + (size_t)n_cache * nb2 * kRows;  // (n_units, 64)
  T* vec = stage + (size_t)n_units * kRows;          // (K, 2nb): U, W at row c, then c+1
  T* stv = vec + (size_t)p.K * nb2;                  // (K, 2nb + 1): U v, W v, y.v
  T* scv = stv + (size_t)p.K * S1;                   // (K, 4): tau, denom, s.t, y at c+1
  T* rdenom = scv + 4 * p.K;
  T* yvs = rdenom + p.K;
  T* alpha = yvs + p.K;
  T* dval = alpha + p.K;
  T* sumsq = dval + p.K;

  const int beg = sched[cta], cnt = sched[cta + 1] - beg;
  const int* codes = sched + G + 1 + beg;
  const int nres = cnt < n_res ? cnt : n_res, nstream = cnt - nres;
  const size_t mm = p.m;
  const Work wl = work_layout(p.K, p.m, nb, G);
  unsigned* bar = reinterpret_cast<unsigned*>(p.work);
  T* yvpart = p.work + wl.yv;   // (K, G)
  T* dots = p.work + wl.dots;   // (K, nrb, 2nb)
  Slots<T> sl;
  sl.rows = p.work + wl.rows;
  sl.cols = p.work + wl.cols;
  sl.s0 = (off + 1) / kTile;
  sl.nl = p.m / kTile - sl.s0;
  sl.base = sched[G] / G;
  sl.extra = sched[G] % G;
  const int rl = (p.nv - 1) / kTile;  // the last tile row inside nv
  unsigned target = 0;
  // this block's rows of U and W on its lu-th row block u: the cached copy,
  // or UW itself (rows this block wrote, so plain loads see them)
  const auto rows_of = [&](int u, int lu) {
    return n_cache ? cache + (size_t)lu * nb2 * kRows
                   : p.UW + (size_t)(u / p.nrb) * nb2 * mm + u % p.nrb * kRows;
  };
  const int rs = n_cache ? kRows : p.m;
  // entry e of U v (e < j) and W v (j <= e < 2j): row q of UW
  const auto row_q = [&](int e, int j) { return e < j ? e : nb + e - j; };

  if (threadIdx.x < nres) res_codes[threadIdx.x] = codes[threadIdx.x];
  __syncthreads();
  for (int t = 0; t < nres; ++t) load_slot(p, decode(res_codes[t]), slots + t * kSlot<T>, true);
  cp_async_commit();
  stage_row(p, off, stage);

  for (int j = 0; j < nb; ++j) {
    const int c = off + j, j2 = 2 * j;
    const bool ok = c + p.q_base < p.n_real - 2;
    // (a) the corrected column on this block's rows, in place of row c of the
    // window in `stage` (copied there during the last column), from column c
    // of U and W (in vec since then): col[i] = row[i] - sum_q (U[q, i] W[q, c]
    // + W[q, i] U[q, c]), four threads a row; its squares below c summed per
    // half row block (one warp each) into `part`
    cp_async_wait<0>();
    __syncthreads();
    for (int u = cta, lu = 0; u < units; u += G, ++lu) {
      const int k = u / p.nrb, b = u % p.nrb, r = threadIdx.x % kRows, g = threadIdx.x / kRows;
      const int i = b * kRows + r;
      const T* ur = rows_of(u, lu);
      T* const xr = stage + lu * kRows;
      if ((b + 1) * kRows <= c) {  // every row above the column
        if (threadIdx.x < 2) p.part[(k * p.nrb + b) * 2 + threadIdx.x] = 0;
      } else {
        const T* cv = vec + k * nb2;
        T corr = 0;
        if (i >= c && i < p.nv)
#pragma unroll 8
          for (int q = g; q < j; q += kParts)
            corr += ur[q * rs + r] * cv[nb + q] + ur[(nb + q) * rs + r] * cv[q];
        red[g][r] = corr;
        __syncthreads();
        if (g == 0) {
          T val = 0;
          if (i >= c && i < p.nv) {
            for (int h = 1; h < kParts; ++h) corr += red[h][r];
            val = xr[r] - corr;
          }
          if (i >= c) {
            p.col[(size_t)k * mm + i] = val;
            xr[r] = val;
          }
          T sq = i > c ? latrd::mul_rn(val, val) : T(0);
          sq = latrd::warp_sum(sq);
          if (lane == 0) p.part[(k * p.nrb + b) * 2 + warp] = sq;
        }
        __syncthreads();
      }
      // this row block's share of U x and W x (x = col below c+1), one warp
      // an entry, kDots entries a warp at a time
      const int i0 = b * kRows + lane, i1 = i0 + 32;
      const T x0 = i0 > c + 1 && i0 < p.nv ? xr[lane] : T(0);
      const T x1 = i1 > c + 1 && i1 < p.nv ? xr[lane + 32] : T(0);
      for (int e0 = warp; e0 < j2; e0 += kWarps * kDots) {
        T d[kDots];
#pragma unroll
        for (int h = 0; h < kDots; ++h) {
          const int q = row_q(min(e0 + h * kWarps, j2 - 1), j);
          d[h] = ur[q * rs + lane] * x0 + ur[q * rs + lane + 32] * x1;
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)  // warp_sum's tree, kDots at a time
#pragma unroll
          for (int h = 0; h < kDots; ++h) d[h] += __shfl_down_sync(0xffffffffu, d[h], o);
        if (lane == 0)
#pragma unroll
          for (int h = 0; h < kDots; ++h)
            if (e0 + h * kWarps < j2)
              dots[((size_t)k * p.nrb + b) * nb2 + row_q(e0 + h * kWarps, j)] = d[h];
      }
    }
    grid_sync(bar, target);

    // (b) copies first: col segments of the resident tiles, the first
    // streamed tiles; odd columns stream in reverse
    const bool rev = j & 1;
    const auto place = [&](int i) { return nres + (rev ? nstream - 1 - i : i); };
    for (int t = 0; t < nres; ++t) load_slot(p, decode(res_codes[t]), slots + t * kSlot<T>, false);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kRing<T> - 1; ++i) {
      if (i < nstream) load_slot(p, decode(codes[place(i)]), ring + i * kSlot<T>, true);
      cp_async_commit();
    }
    // then every global load that the reflectors and U v, W v need, in
    // flight together: each window's alpha and d and the sum of its partial
    // sums of squares (one warp a window); U and W at row c+1, q < j, for (c)
    // and the next column; and entry e of U x and W x of window k summed
    // whole by one warp from the row blocks' shares (the K 2j entries round
    // robin over the blocks, then the warps from the last)
    const int ne = p.K * j2, kw = warp, ew = cta + G * (kWarps - 1 - warp);
    const auto uw_c1 = [&](int e) {  // U or W at row c+1 of entry e
      return __ldcg(p.UW + ((size_t)(e / j2) * nb2 + row_q(e % j2, j)) * mm + c + 1);
    };
    T vx[2], px[kGather], ex[kGather], a = 0, d = 0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * kBlock;
      vx[h] = c + 1 < p.m && e < ne ? uw_c1(e) : T(0);
    }
    const Strided<T> ps{p.part + kw * 2 * p.nrb, 2 * p.nrb, 1};
    if (kw < p.K) {
      ps.load(lane, px);
      a = c + 1 < p.m ? __ldcg(p.col + kw * mm + c + 1) : T(0);
      d = __ldcg(p.col + kw * mm + c);
    }
    const int ek = ew < ne ? ew / j2 : 0, eq = ew < ne ? row_q(ew % j2, j) : 0;
    const Strided<T> es{dots + (size_t)ek * p.nrb * nb2 + eq, p.nrb, (size_t)nb2};
    if (ew < ne) es.load(lane, ex);
    if (kw < p.K) {
      const T sq = ps.sum(px);
      if (lane == 0) {
        sumsq[kw] = sq;
        alpha[kw] = a;
        dval[kw] = d;
      }
    }
    if (ew < ne) {
      const T acc = es.sum(ex);
      if (lane == 0) p.st[ek * nb2 + eq] = acc;  // (c) adds U, W at c+1 and scales
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = threadIdx.x + h * kBlock;
      if (c + 1 < p.m && e < ne) vec[e / j2 * nb2 + row_q(e % j2, j)] = vx[h];
    }
    // the further passes: more than kWarps windows, K 2j > 2 kBlock, more
    // entries than the card's warps
    for (int k = kw + kWarps; k < p.K; k += kWarps) {
      const T ak = c + 1 < p.m ? __ldcg(p.col + k * mm + c + 1) : T(0);
      const T dk = __ldcg(p.col + k * mm + c);
      const T sq = warp_gather(p.part + k * 2 * p.nrb, 2 * p.nrb, 1);
      if (lane == 0) {
        sumsq[k] = sq;
        alpha[k] = ak;
        dval[k] = dk;
      }
    }
    if (c + 1 < p.m)
      for (int e = threadIdx.x + 2 * kBlock; e < ne; e += kBlock)
        vec[e / j2 * nb2 + row_q(e % j2, j)] = uw_c1(e);
    for (int e = ew + G * kWarps; e < ne; e += G * kWarps) {
      const int k = e / j2, q = row_q(e % j2, j);
      const T acc = warp_gather(dots + (size_t)k * p.nrb * nb2 + q, p.nrb, nb2);
      if (lane == 0) p.st[k * nb2 + q] = acc;
    }
    __syncthreads();
    for (int k = threadIdx.x; k < p.K; k += kBlock) {  // block 0 writes d, e, tau
      const latrd::Reflector<T> rf =
          latrd::house_from(p, c, j, k, sumsq[k], alpha[k], dval[k], false);
      scv[k * 4] = rf.tau;
      scv[k * 4 + 1] = rf.denom;
      rdenom[k] = ok ? T(1) / rf.denom : T(0);
      yvs[k] = 0;
      if (cta == 0) {
        T* det = p.det + (size_t)k * 3 * nb;
        det[j] = dval[k];
        det[nb + j] = rf.e;
        det[2 * nb + j] = rf.tau;
      }
    }
    __syncthreads();
    for (int u = cta, lu = 0; u < units; u += G, ++lu)  // v, row j of U, on this block's rows
      // (from the corrected column in `stage`; rows at or above c give 0)
      if (threadIdx.x < kRows) {
        const int k = u / p.nrb, i = u % p.nrb * kRows + threadIdx.x;
        const T v =
            latrd::reflector_entry(stage[lu * kRows + threadIdx.x], i, c, ok, scv[k * 4 + 1]);
        p.UW[((size_t)k * nb2 + j) * mm + i] = v;
        if (n_cache) cache[((size_t)lu * nb2 + j) * kRows + threadIdx.x] = v;
      }

    // the matvec: the resident tiles, then the rest through the ring
    const Column<T> col{c, (c + 1) / kTile, scv + 1, yvs};
    Matvec<T> mv(p, sl, col, cred, cxs, wred);
    cp_async_wait<kRing<T> - 1>();  // the resident tiles and their col segments
    for (int t = 0; t < nres; ++t) {
      __syncthreads();
      mv.step(res_codes[t], beg + t, slots + t * kSlot<T>, t & 1);
    }
    const int split = mv.key;  // the strip whose streamed tiles may come later
    mv.flush_rows();
    mv.again = split;
    for (int i = 0; i < nstream; ++i) {
      cp_async_wait<kRing<T> - 2>();  // tile i landed
      __syncthreads();                // ... for every thread; slot (i-1) % kRing is free
      if (i + kRing<T> - 1 < nstream)
        load_slot(p, decode(codes[place(i + kRing<T> - 1)]),
                  ring + (i + kRing<T> - 1) % kRing<T> * kSlot<T>, true);
      cp_async_commit();
      mv.step(codes[place(i)], beg + place(i), ring + i % kRing<T> * kSlot<T>, (nres + i) & 1);
    }
    mv.finish();
    for (int k = threadIdx.x; k < p.K; k += kBlock) yvpart[k * G + cta] = yvs[k];
    grid_sync(bar, target);

    // (c) row c+1 of the window for the next column's (a), by cp.async
    // meanwhile; per window (one warp): y.v from the blocks' shares, U v and
    // W v, s.t, and y at row c+1 summed by the whole warp from its slots
    cp_async_wait<0>();
    if (j + 1 < nb) stage_row(p, c + 1, stage);
    const int t0 = (c + 1) / kTile;
    const bool next = j + 1 < nb && c + 1 < p.nv;  // w at row c+1 is formed here
    for (int k = warp; k < p.K; k += kWarps) {
      // U v and W v (up to 128 entries a pass), y at c+1 and y.v: their loads
      // in flight together
      T sv[4], yt[4], gv[kGather];
#pragma unroll
      for (int h = 0; h < 4; ++h)
        sv[h] = j2 ? __ldcg(p.st + k * nb2 + row_q(min(lane + 32 * h, j2 - 1), j)) : T(0);
      const YTerms<T> y1t(sl, k, t0, t0, rl, (c + 1) % kTile);
      if (next) y1t.load(lane, 32, yt);
      const Strided<T> yvs_k{yvpart + k * G, G, 1};
      yvs_k.load(lane, gv);
      const T y1 = next ? y1t.sum(lane, 32, yt) : T(0);
      const T yv = yvs_k.sum(gv);
      for (int e0 = 0; e0 < j2; e0 += 128) {  // v = x / denom, v[c+1] = 1
        if (e0)
#pragma unroll
          for (int h = 0; h < 4; ++h)
            sv[h] = __ldcg(p.st + k * nb2 + row_q(min(e0 + lane + 32 * h, j2 - 1), j));
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int e = e0 + lane + 32 * h;
          if (e < j2) {
            const int q = row_q(e, j);
            stv[k * S1 + q] = ok ? vec[k * nb2 + q] + sv[h] * rdenom[k] : T(0);
          }
        }
      }
      const T y1sum = latrd::warp_sum(y1);
      if (lane == 0) {
        stv[k * S1 + nb2] = yv * rdenom[k] * rdenom[k];
        scv[k * 4 + 3] = y1sum * rdenom[k];
      }
      __syncwarp();
      T sdt = 0;
      for (int q = lane; q < j; q += 32) sdt += stv[k * S1 + q] * stv[k * S1 + nb + q];
      sdt = latrd::warp_sum(sdt);
      if (lane == 0) scv[k * 4 + 2] = sdt;
      __syncwarp();
      // w at row c+1 (lanes over q, warp_sum's tree): every block forms it
      // from the same inputs in the same order, so the next column's (a)
      // needs no third barrier; the row's owner stores this value
      if (j + 1 < nb) {
        T corr = 0;
        for (int q = lane; q < j; q += 32)
          corr += vec[k * nb2 + q] * stv[k * S1 + nb + q] + vec[k * nb2 + nb + q] * stv[k * S1 + q];
        corr = latrd::warp_sum(corr);
        if (lane == 0) {
          const T tau = scv[k * 4], wv = tau * (stv[k * S1 + nb2] - 2 * scv[k * 4 + 2]);
          vec[k * nb2 + j] = T(ok);  // v at c+1
          vec[k * nb2 + nb + j] =
              next ? tau * (scv[k * 4 + 3] - corr) - T(0.5) * tau * wv * T(ok) : T(0);
        }
      }
    }
    __syncthreads();
    // y on this block's rows and the corrections of w there (four threads a
    // row, each every fourth term), then w, one thread a row
    const int r = threadIdx.x % kRows, g = threadIdx.x / kRows;
    for (int u = cta, lu = 0; u < units; u += G, ++lu) {
      const int k = u / p.nrb, b = u % p.nrb, i = b * kRows + r;
      const bool live = b >= t0 && b * kTile < p.nv;
      const T* ur = rows_of(u, lu) + r;
      const T* sv = stv + k * S1;
      const YTerms<T> yt(sl, k, b, t0, rl, r);
      T x[kBatch], corr = 0;
      if (live) {
        yt.load(g, kParts, x);  // in flight during the corrections
        for (int q = g; q < j; q += kParts)
          corr += ur[q * rs] * sv[nb + q] + ur[(nb + q) * rs] * sv[q];
      }
      red[g][r] = live ? yt.sum(g, kParts, x) : T(0);
      cred[0][g][r] = corr;
      __syncthreads();
      if (g == 0) {
        T wi = 0;
        if (next && i == c + 1) {
          wi = vec[k * nb2 + nb + j];
        } else if (i > c && i < p.nv) {
          const T y = ((red[0][r] + red[1][r]) + (red[2][r] + red[3][r])) * rdenom[k];
          const T cw = (cred[0][0][r] + cred[0][1][r]) + (cred[0][2][r] + cred[0][3][r]);
          const T tau = scv[k * 4], wv = tau * (sv[nb2] - 2 * scv[k * 4 + 2]);
          wi = tau * (y - cw) - T(0.5) * tau * wv * ur[j * rs];
        }
        p.UW[((size_t)k * nb2 + nb + j) * mm + i] = wi;
        if (n_cache) cache[((size_t)lu * nb2 + nb + j) * kRows + r] = wi;
      }
      __syncthreads();
    }
  }
  cp_async_wait<0>();
}

template <typename T>
cudaError_t run(const latrd::Panel<T>& p, int off, const int* sched, int n_cta, int n_res,
                int n_cache, cudaStream_t s) {
  const int n_units = (p.K * p.nrb + n_cta - 1) / n_cta;
  if (p.m % kTile || n_cta < 1 || n_cta > sm_count() || n_res < 0 || n_res > kMaxRes ||
      (n_cache != 0 && n_cache != n_units))
    return cudaErrorInvalidValue;
  void (*kernel)(latrd::Panel<T>, int, const int*, int, int) = k_panel<T>;
  const size_t smem = dynamic_smem<T>(p.K, p.nb, n_res, n_cache, n_units);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(p.work, 0, sizeof(unsigned), s)) != cudaSuccess) return err;
  latrd::Panel<T> pp = p;
  void* args[] = {&pp, &off, &sched, &n_res, &n_cache};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(n_cta),
                                    dim3(kBlock), args, smem, s);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The C interface: the panel contract's arguments, then the schedule
// table, its block count, the resident tiles per block and the cached row
// blocks per block before the stream (as latrd_v4.cu); ring_slots(itemsize)
// is kRing, smem_bytes(...) the launch's dynamic shared memory; `part` holds
// two partial sums of squares per row block (one per half).
#define LATRD_V3_PANEL(NAME, T)                                                            \
  extern "C" int NAME(const void* Aw, void* UW, void* det, void* col, void* part, void* y,   \
                      void* st, void* scal, void* work, int K, int m, int nb, int off,       \
                      int q_base, int n_real, const void* sched, int n_cta, int n_res,       \
                      int n_cache, void* stream) {                                           \
    return (int)run<T>(latrd::make_panel<T>(Aw, UW, det, col, part, y, st, scal, work, K, m, \
                                            nb, q_base, n_real),                             \
                       off, static_cast<const int*>(sched), n_cta, n_res, n_cache,           \
                       static_cast<cudaStream_t>(stream));                                   \
  }
LATRD_V3_PANEL(panel_f32, float)
LATRD_V3_PANEL(panel_f64, double)
extern "C" size_t work_elems(int K, int m, int nb) { return work(K, m, nb); }
extern "C" size_t part_elems(int K, int m) { return (size_t)K * 2 * latrd::row_blocks(m); }
extern "C" int ring_slots(int itemsize) { return itemsize == 4 ? kRing<float> : kRing<double>; }
extern "C" size_t smem_bytes(int K, int nb, int n_res, int n_cache, int n_units, int itemsize) {
  return itemsize == 4 ? dynamic_smem<float>(K, nb, n_res, n_cache, n_units)
                       : dynamic_smem<double>(K, nb, n_res, n_cache, n_units);
}
extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
