// Symmetric-half LATRD panel kernel for Hopper (sm_90a): one persistent
// cooperative launch per panel.
//
// Replaces the TPU kernel laplace_jax/ops/latrd_pallas_v4.py,
// `latrd_panel_v4` (body `_panel_kernel`): the panel contract of latrd.cu,
// used by stage 1 for n >= 2304 (ResNet-18 KFAC classes n = 2304 (K=4),
// 4608 (K=3)), with the trailing matvec from the lower triangle of each
// window.
//
// Design. One block per SM (grid = the SM count, cudaLaunchCooperativeKernel)
// runs all nb columns of the panel. Block `cta` owns the row blocks (k, b)
// numbered u = cta, cta + G, ... and, where they fit (ops/latrd_v4.py
// `panel_plan`), keeps its rows of U and W in shared memory for the panel.
// Each column is three phases separated by grid barriers (a counter in
// `work`, zeroed by one memset per panel):
//
//   (a) corrected column and partial sums of squares on the block's rows
//       (latrd_common.cuh's `col_block`), with column c
//       of U and W and row c of the window staged in shared memory first;
//   (b) every block forms every window's reflector itself (`house_from`;
//       block 0 writes d, e, tau), writes v on its rows,
//       adds its rows' share of U v and W v into p.st (atomics), and runs
//       the trailing matvec y = A v over its tiles of the lower triangle;
//   (c) `w_block` on its rows, with y.v summed from the
//       blocks' shares in a fixed order and y, U v, W v staged first.
//
// Matvec. The 64x64 tiles (r, s), r >= s, of the panel's trailing block
// (s >= (off+1)/64; the window does not change during a panel) are
// assigned by `panel_schedule`: a contiguous run of the row-major tile
// order per block, so a block's tiles come in strips sharing a tile row.
// A block's first n_res tiles stay in shared memory for the whole panel;
// the rest stream through a ring of kRing slots with cp.async every column
// (kRing-1 in flight while one is multiplied), in reverse order on odd
// columns so that the previous column's last tiles are still in L2. Each
// slot also takes col[S:S+64] and col[R:R+64]. Warp w holds tile columns
// 8w..8w+7 and lane l rows l and l+32: row products add up in registers
// along a strip and go into y[R] once per strip (one block reduction);
// column products are reduced within the warp by shuffles and go into y[S]
// with 64 atomicAdds per tile, so a tile needs no block barrier. The tiles
// multiply x = col (v = x / denom, x[c+1] = denom, 0 at and above c); each
// sum is scaled by 1/denom once as it goes into y, and the block adds
// x.(A x) / denom^2 into its share of y.v.
//
// Numbers. y, y.v, U v and W v are summed with atomics in an order that
// changes from run to run, so results agree with the plain version to
// float32 rounding, not bitwise.
//
// Bound. Per column the matvec reads the lower triangle of the trailing
// block, K (m-c)^2 / 2 elements: at the 4608 class (K=3) 129 MB in float32,
// of which 10.8 MB stay in shared memory (132 blocks x 5 tiles beside the
// cached rows), so about 118 MB stream from L2/HBM each column. From
// m <= 1152 every tile is resident, and a column costs its three grid
// barriers and the phases' latency. Left for later work: tiles held in
// registers, two barriers a column (each block forming w at row c+1
// itself), TMA bulk copies.

#include "latrd_tiles.cuh"

namespace {

using latrd::kBlock;
using latrd::kRows;
using latrd::kWarps;
using latrd::cp_async16;
using latrd::cp_async_commit;
using latrd::cp_async_wait;
using latrd::grid_sync;
using latrd::kBarrierElems;
using latrd::sm_count;
using latrd::TileAt;
using latrd::decode;
using latrd::kLd;
using latrd::kMaxRes;
using latrd::kRing;
using latrd::kSlot;
using latrd::kTile;
using latrd::load_slot;

// `work`: the barrier counter, then each block's share of y.v per window (K, G)
size_t work(int K, int, int) { return kBarrierElems + (size_t)K * sm_count(); }

// The dynamic shared memory: the resident tiles' and the ring's slots; the
// 2nb rows of U and W on each of the n_cache row blocks this block owns (0,
// or all n_units of them); one staged 64-row vector per owned row block; per
// window 1/denom, y.v, alpha, d, denom, sum of squares, tau and 2nb values
// (column c of U and W, then U v and W v).
template <typename T>
size_t dynamic_smem(int K, int nb, int n_res, int n_cache, int n_units) {
  const size_t tail = ((size_t)K * (2 * nb + 7) * sizeof(T) + 15) / 16 * 16;
  return ((size_t)(n_res + kRing<T>) * kSlot<T> + ((size_t)n_cache * 2 * nb + n_units) * kRows) *
             sizeof(T) + tail;
}

__device__ __forceinline__ void load8(const float* a, float (&x)[8]) {
  const float4 q0 = *reinterpret_cast<const float4*>(a);
  const float4 q1 = *reinterpret_cast<const float4*>(a + 4);
  x[0] = q0.x, x[1] = q0.y, x[2] = q0.z, x[3] = q0.w;
  x[4] = q1.x, x[5] = q1.y, x[6] = q1.z, x[7] = q1.w;
}
__device__ __forceinline__ void load8(const double* a, double (&x)[8]) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const double2 q = *reinterpret_cast<const double2*>(a + 2 * h);
    x[2 * h] = q.x, x[2 * h + 1] = q.y;
  }
}

// The matvec runs on x = col with x[c+1] = denom and x[i] = 0 for i <= c,
// so that v = x / denom: y = (A x) / denom, each sum scaled once when it
// goes into y (and y.v = x.(A x) / denom^2). Only the tiles of tile column
// (c+1)/64 see rows <= c+1; the others multiply col as it is.
template <typename T>
struct Column {  // what every tile of one column needs
  int c, t0;
  const T* rdenom;  // 1/denom per window, 0 where the column is a no-op
  const T* denom;
  T* yv;            // this block's share of y.v per window (shared memory)
};

template <typename T>
__device__ __forceinline__ T masked_x(T x, int i, const Column<T>& col, int k) {
  return i > col.c + 1 ? x : (i == col.c + 1 ? col.denom[k] : T(0));
}

// The row products of the current strip (tiles sharing window k, tile row
// r). Warp w holds tile columns 8w..8w+7 and lane l rows l and l+32: each
// thread keeps its two rows' partial sums over its 8 columns.
template <typename T>
struct Strip {
  int key = -1;            // code >> 10 (k, r), or -1 before the first tile
  int k, R;
  T acc0, acc1, xr0, xr1;  // rows l and l+32: partial sums, x
  T yv;                    // this thread's share of the strip's x.(A x)
};

// Adds the strip's row products into y[R] (summed over the warps through
// `red`) and its y.v share into the block's.
template <typename T>
__device__ __forceinline__ void flush(const latrd::Panel<T>& p, Strip<T>& st,
                                      const Column<T>& col, T (&red)[kWarps][kTile]) {
  if (st.key < 0) return;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const T rd = col.rdenom[st.k];
  red[warp][lane] = st.acc0;
  red[warp][lane + 32] = st.acc1;
  __syncthreads();
  T part = st.yv;
  if (threadIdx.x < kTile) {
    const int l = threadIdx.x;
    T sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][l];
    atomicAdd(p.y + (size_t)st.k * p.m + st.R + l, sum * rd);
    part += sum * (warp ? st.xr1 : st.xr0);  // row l: lane l & 31 of warp l >> 5
  }
  part = latrd::warp_sum(part);
  if (lane == 0) atomicAdd(col.yv + st.k, part * rd * rd);
  __syncthreads();
  st.key = -1;
}

// One tile of the matvec from its slot (whose copies have landed and are
// visible to every thread). No block barrier: each warp reduces its own
// column products over the 64 rows with shuffles.
template <typename T>
__device__ __forceinline__ void tile_step(const latrd::Panel<T>& p, int code, const T* slot,
                                          Strip<T>& st, const Column<T>& col,
                                          T (&red)[kWarps][kTile]) {
  const TileAt t = decode(code);
  const int R = t.r * kTile, S = t.s * kTile;
  if (t.s < col.t0 || R >= p.nv) return;  // left the trailing block, or padding
  const int lane = threadIdx.x & 31, w8 = (threadIdx.x >> 5) * 8;
  const T* segS = slot + kTile * kLd<T>;
  const T* segR = segS + kTile;
  if (code >> 10 != st.key) {
    flush(p, st, col, red);
    st.key = code >> 10;
    st.k = t.k;
    st.R = R;
    st.acc0 = st.acc1 = st.yv = 0;
    st.xr0 = segR[lane];
    st.xr1 = segR[lane + 32];
    if (t.r == col.t0) {
      st.xr0 = masked_x(st.xr0, R + lane, col, t.k);
      st.xr1 = masked_x(st.xr1, R + lane + 32, col, t.k);
    }
  }
  const bool edge = t.s == col.t0;
  T xs[8], cs[8];
  load8(segS + w8, xs);
  if (edge) {
#pragma unroll
    for (int u = 0; u < 8; ++u) xs[u] = masked_x(xs[u], S + w8 + u, col, t.k);
  }
  {
    T x[8], a = 0;
    load8(slot + lane * kLd<T> + w8, x);
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a += x[u] * xs[u];
      cs[u] = x[u] * st.xr0;
    }
    st.acc0 += a;
    load8(slot + (lane + 32) * kLd<T> + w8, x);
    a = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      a += x[u] * xs[u];
      cs[u] += x[u] * st.xr1;
    }
    st.acc1 += a;
  }
  if (R == S) return;  // the diagonal tile is read whole: no mirror term
  // sum cs over the 32 lanes: halve the columns each step, then lanes in
  // fours hold column 4 b4 + 2 b3 + b2 (b the lane's bits)
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  T h4[4], h3[2];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    h4[u] = (b4 ? cs[u + 4] : cs[u]) + __shfl_xor_sync(0xffffffffu, b4 ? cs[u] : cs[u + 4], 16);
#pragma unroll
  for (int u = 0; u < 2; ++u)
    h3[u] = (b3 ? h4[u + 2] : h4[u]) + __shfl_xor_sync(0xffffffffu, b3 ? h4[u] : h4[u + 2], 8);
  T sum = (b2 ? h3[1] : h3[0]) + __shfl_xor_sync(0xffffffffu, b2 ? h3[0] : h3[1], 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if ((lane & 3) == 0) {
    const int u = 4 * b4 + 2 * b3 + b2;
    T xu = segS[w8 + u];
    if (edge) xu = masked_x(xu, S + w8 + u, col, t.k);
    atomicAdd(p.y + (size_t)t.k * p.m + S + w8 + u, sum * col.rdenom[t.k]);
    st.yv += sum * xu;
  }
}

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
  __shared__ T sh[kWarps + 1];
  __shared__ T rowred[kWarps][kTile];
  __shared__ int res_codes[kMaxRes];
  const int G = gridDim.x, cta = blockIdx.x;
  const int units = p.K * p.nrb, nb2 = 2 * p.nb, n_units = (units + G - 1) / G;
  T* slots = reinterpret_cast<T*>(smem_raw);
  T* ring = slots + (size_t)n_res * kSlot<T>;
  T* cache = ring + (size_t)kRing<T> * kSlot<T>;       // (n_cache, 2nb, 64)
  T* stage = cache + (size_t)n_cache * nb2 * kRows;    // (n_units, 64)
  T* rdenom = stage + (size_t)n_units * kRows;
  T* yvs = rdenom + p.K;
  T* alpha = yvs + p.K;
  T* dval = alpha + p.K;
  T* denom = dval + p.K;
  T* sumsq = denom + p.K;
  T* tau = sumsq + p.K;
  T* vec = tau + p.K;  // (K, 2nb): column c of U and W in (a), U v and W v in (c)

  const int beg = sched[cta], cnt = sched[cta + 1] - beg;
  const int* codes = sched + G + 1 + beg;
  const int nres = cnt < n_res ? cnt : n_res, nstream = cnt - nres;
  const size_t mm = p.m;
  unsigned* bar = reinterpret_cast<unsigned*>(p.work);
  T* yvpart = p.work + kBarrierElems;  // (K, G)
  unsigned target = 0;
  // this block's rows of U and W on its lu-th row block u: the cached copy,
  // or UW itself (rows this block wrote, so plain loads see them)
  const auto rows_of = [&](int u, int lu) {
    return n_cache ? cache + (size_t)lu * nb2 * kRows
                   : p.UW + (size_t)(u / p.nrb) * nb2 * mm + u % p.nrb * kRows;
  };
  const size_t rs = n_cache ? kRows : mm;

  if (threadIdx.x < nres) res_codes[threadIdx.x] = codes[threadIdx.x];
  __syncthreads();
  for (int t = 0; t < nres; ++t) load_slot(p, decode(res_codes[t]), slots + t * kSlot<T>, true);
  cp_async_commit();

  for (int j = 0; j < p.nb; ++j) {
    const int c = off + j;
    // (a) corrected column and partial sums of squares on this block's
    // rows, from column c of U and W and row c of the window staged first;
    // y and U v, W v zeroed for (b)'s sums
    for (int e = threadIdx.x; e < p.K * nb2; e += kBlock)
      if (e % nb2 % p.nb < j) vec[e] = __ldcg(p.UW + (size_t)e * mm + c);
    for (int u = cta, lu = 0; u < units; u += G, ++lu)
      if (threadIdx.x < kRows) {
        const int k = u / p.nrb, i = u % p.nrb * kRows + threadIdx.x;
        stage[lu * kRows + threadIdx.x] = p.Aw[((size_t)k * mm + c) * mm + i];
        p.y[k * mm + i] = 0;
      }
    if (cta == 0)
      for (int e = threadIdx.x; e < p.K * nb2; e += kBlock) p.st[e] = 0;
    __syncthreads();
    for (int u = cta, lu = 0; u < units; u += G, ++lu)
      latrd::col_block(p, c, j, stage + lu * kRows, u / p.nrb, u % p.nrb, rows_of(u, lu), rs,
                       vec + u / p.nrb * nb2, 1, red, sh);
    grid_sync(bar, target);

    // (b) copies first: col segments of the resident tiles, the first
    // streamed tiles; odd columns stream in reverse
    const bool rev = j & 1;
    const auto streamed = [&](int i) { return codes[nres + (rev ? nstream - 1 - i : i)]; };
    for (int t = 0; t < nres; ++t) load_slot(p, decode(res_codes[t]), slots + t * kSlot<T>, false);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kRing<T> - 1; ++i) {
      if (i < nstream) load_slot(p, decode(streamed(i)), ring + i * kSlot<T>, true);
      cp_async_commit();
    }
    // every window's reflector, in every block (block 0 writes d, e, tau):
    // one warp sums each window's partial sums of squares
    for (int k = threadIdx.x >> 5; k < p.K; k += kWarps) {
      T acc = 0;
      for (int b = threadIdx.x & 31; b < p.nrb; b += 32) acc += __ldcg(p.part + k * p.nrb + b);
      acc = latrd::warp_sum(acc);
      if ((threadIdx.x & 31) == 0) {
        sumsq[k] = acc;
        alpha[k] = c + 1 < p.m ? __ldcg(p.col + k * mm + c + 1) : T(0);
        dval[k] = __ldcg(p.col + k * mm + c);
      }
    }
    __syncthreads();
    const bool ok = c + p.q_base < p.n_real - 2;
    for (int k = threadIdx.x; k < p.K; k += kBlock) {
      const latrd::Reflector<T> rf =
          latrd::house_from(p, c, j, k, sumsq[k], alpha[k], dval[k], false);
      denom[k] = rf.denom;
      rdenom[k] = ok ? T(1) / rf.denom : T(0);
      tau[k] = rf.tau;
      yvs[k] = 0;
    }
    if (cta == 0 && threadIdx.x == 0)  // d, e, tau
      for (int k = 0; k < p.K; ++k) latrd::house_from(p, c, j, k, sumsq[k], alpha[k], dval[k], true);
    __syncthreads();
    for (int u = cta, lu = 0; u < units; u += G, ++lu)  // v, row j of U, on this block's rows
      if (threadIdx.x < kRows) {
        const int k = u / p.nrb, i = u % p.nrb * kRows + threadIdx.x;
        const T v = latrd::reflector_entry(__ldcg(p.col + k * mm + i), i, c, ok, denom[k]);
        p.UW[((size_t)k * nb2 + j) * mm + i] = v;
        if (n_cache) cache[((size_t)lu * nb2 + j) * kRows + threadIdx.x] = v;
      }
    __syncthreads();
    // U v and W v over this block's rows (v is 0 at and above c), one warp
    // per earlier row of U or W, added into p.st
    for (int u = cta, lu = 0; u < units; u += G, ++lu) {
      if ((u % p.nrb + 1) * kRows <= c + 1) continue;
      const T* ur = rows_of(u, lu);
      const int l = threadIdx.x & 31;
      const T v0 = ur[j * rs + l], v1 = ur[j * rs + l + 32];
      for (int q = threadIdx.x >> 5; q < 2 * j; q += kWarps) {
        const int qq = q < j ? q : p.nb + (q - j);
        T d = ur[qq * rs + l] * v0 + ur[qq * rs + l + 32] * v1;
        d = latrd::warp_sum(d);
        if (l == 0) atomicAdd(p.st + u / p.nrb * nb2 + qq, d);
      }
    }

    const Column<T> col{c, (c + 1) / kTile, rdenom, denom, yvs};
    Strip<T> st;
    cp_async_wait<kRing<T> - 1>();  // the resident tiles and their col segments
    __syncthreads();
    for (int t = 0; t < nres; ++t) tile_step(p, res_codes[t], slots + t * kSlot<T>, st, col, rowred);
    for (int i = 0; i < nstream; ++i) {
      cp_async_wait<kRing<T> - 2>();  // tile i landed
      __syncthreads();                // ... for every thread; slot (i-1) % kRing is free
      if (i + kRing<T> - 1 < nstream)
        load_slot(p, decode(streamed(i + kRing<T> - 1)),
                  ring + (i + kRing<T> - 1) % kRing<T> * kSlot<T>, true);
      cp_async_commit();
      tile_step(p, streamed(i), ring + i % kRing<T> * kSlot<T>, st, col, rowred);
    }
    flush(p, st, col, rowred);
    for (int k = threadIdx.x; k < p.K; k += kBlock) yvpart[k * G + cta] = yvs[k];
    grid_sync(bar, target);

    // (c) y.v per window from the blocks' shares (fixed order), U v and W v,
    // y on this block's rows, then w
    for (int k = threadIdx.x >> 5; k < p.K; k += kWarps) {
      T acc = 0;
      for (int g = threadIdx.x & 31; g < G; g += 32) acc += __ldcg(yvpart + k * G + g);
      acc = latrd::warp_sum(acc);
      if ((threadIdx.x & 31) == 0) yvs[k] = acc;
    }
    for (int e = threadIdx.x; e < p.K * nb2; e += kBlock)
      if (e % nb2 % p.nb < j) vec[e] = __ldcg(p.st + e);
    for (int u = cta, lu = 0; u < units; u += G, ++lu)
      if (threadIdx.x < kRows)
        stage[lu * kRows + threadIdx.x] =
            __ldcg(p.y + u / p.nrb * mm + u % p.nrb * kRows + threadIdx.x);
    __syncthreads();
    for (int u = cta, lu = 0; u < units; u += G, ++lu) {
      const int k = u / p.nrb;
      T* wr = n_cache ? cache + ((size_t)lu * nb2 + p.nb + j) * kRows : nullptr;
      latrd::w_block(p, c, j, k, u % p.nrb, yvs[k], tau[k], vec + k * nb2, stage + lu * kRows,
                     rows_of(u, lu), rs, wr, red);
      __syncthreads();
    }
    grid_sync(bar, target);
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
// blocks per block before the stream; ring_slots(itemsize) is kRing.
#define LATRD_V4_PANEL(NAME, T)                                                            \
  extern "C" int NAME(const void* Aw, void* UW, void* det, void* col, void* part, void* y,   \
                      void* st, void* scal, void* work, int K, int m, int nb, int off,       \
                      int q_base, int n_real, const void* sched, int n_cta, int n_res,       \
                      int n_cache, void* stream) {                                           \
    return (int)run<T>(latrd::make_panel<T>(Aw, UW, det, col, part, y, st, scal, work, K, m, \
                                            nb, q_base, n_real),                             \
                       off, static_cast<const int*>(sched), n_cta, n_res, n_cache,           \
                       static_cast<cudaStream_t>(stream));                                   \
  }
LATRD_V4_PANEL(panel_f32, float)
LATRD_V4_PANEL(panel_f64, double)
extern "C" size_t work_elems(int K, int m, int nb) { return work(K, m, nb); }
extern "C" size_t part_elems(int K, int m) { return (size_t)K * latrd::row_blocks(m); }
extern "C" int ring_slots(int itemsize) { return itemsize == 4 ? kRing<float> : kRing<double>; }
extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
