// Symmetric rank-k update H = A^T A for Hopper (sm_90a).
//
// Replaces the TPU kernel laplace_jax/ops/syrk.py:37, `syrk` (inner
// `kernel`): the dense GGN of FullLaplace, H = M^T M with M the (rows, P)
// square-root curvature rows of a batch (laplace_jax/curvature/backend.py:
// 389-401). On the last-layer path of ResNet-18, M is (1280, 5130) per
// batch of 128. The JAX kernel computes the lower tiles and mirrors them
// afterwards with XLA; here the mirror is fused into the epilogue.
//
// Bound. R P (P + 1) flops over the lower half against (R P + P^2) * size
// bytes: at (1280, 5130) float32, 3.37e10 flops (0.503 ms at 67 TFLOP/s of
// float32 outside the tensor cores) against 131 MB (0.04 ms at 3.35 TB/s),
// so it is bound by operations. Full float32 FMAs, no tensor cores, no
// TF32: the GGN feeds slogdet and invsqrt_precision.
//
// Design: a register-blocked, pipelined SIMT product over lower tiles. The
// kernel it replaces reached 41% of the bound: 64x64 tiles, a 4x4
// accumulator a thread (2 shared loads per 16 FMAs), 16-row chunks staged
// through registers with scalar loads and no overlap. Here:
//   - one block of 256 threads per lower-triangular tile of kTile x kTile,
//     in row order over (i >= j) (ops/syrk.syrk_plan lists them), so the
//     ragged last tile row runs last; two blocks an SM (<= 128 registers);
//   - each thread accumulates 2 x 2 blocks of S x S outputs, S * sizeof(T)
//     = 16 bytes: float32 8x8 (kTile 128), float64 4x4 (kTile 64). A warp
//     covers 16S x 8S as 8 x 4 lanes; its fragment loads are 16-byte
//     vectors that 4 (rows) or 8 (columns) lanes share. Per k a float32
//     thread makes 4 shared loads for 64 FMAs, and loads the next k's
//     fragments while it multiplies this k's;
//   - the FMAs of a k run row by row with every other row reversed, so
//     that consecutive FMAs share one operand in the reuse cache; this
//     order halved the FMAs whose other two sources share a register bank
//     (scripts/trace_syrk.py counts them in the SASS);
//   - a two-slot cp.async ring of kChunk-row slices of both strips in
//     dynamic shared memory, one __syncthreads a chunk: the copy of chunk
//     c + 1 is in flight while chunk c is multiplied. A row of A is already
//     the outer-product operand (contiguous along P), so no transpose;
//   - warps whose rows or columns all lie past P, or (diagonal tiles)
//     wholly above the diagonal, skip the products;
//   - the finished tile goes through shared memory once, so that the tile
//     and its mirror are both written with coalesced stores; a diagonal
//     tile writes its lower half and mirrors it. Every upper entry is the
//     bitwise copy of its lower twin, and with no split-K and no atomics
//     each entry sums its k in one fixed order: H is exactly symmetric and
//     the same bit for bit on every launch.
// Alignment. The copies are V-byte cp.async, V the largest of 16, 8, 4 (8
// for float64) dividing both A's address and a row's bytes, zero-filled
// past R and P (a V-byte vector lies wholly inside or outside the matrix).
// At P = 5130 a row is 20,520 bytes, 8 mod 16, so float32 takes 8-byte
// copies (cp.async.ca); P % 4 == 0 takes 16-byte cp.async.cg. No padded
// copy of A is made.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 along a tile's rows, 4 along its columns
constexpr int kChunk = 32;     // rows of A a ring slot holds
constexpr int kStages = 2;     // ring slots

template <typename T>
struct Geo {
  static constexpr int S = 16 / (int)sizeof(T);  // sub-block edge: one 16-byte vector
  static constexpr int kTile = 32 * S;           // 2 warps x 8 lanes x 2 blocks x S rows
  static constexpr int kWarpRows = kTile / 2, kWarpCols = kTile / 4;
  static constexpr int kSlot = 2 * kChunk * kTile;  // both strips of one chunk, elements
  static constexpr int kRing = kStages * kSlot;
  static constexpr int kEpi = kTile * (kTile + 1);  // the finished tile, +1 column of padding
  static constexpr int kSmem = (kRing > kEpi ? kRing : kEpi) * (int)sizeof(T);
};

template <typename T, int V>
__device__ __forceinline__ void copy_async(T* dst, const T* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? V : 0;  // 0 source bytes: the slot is zero-filled
  if constexpr (V == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(V),
                 "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int S, typename T>
__device__ __forceinline__ void load_vec(const T* p, T* v) {
  if constexpr (S == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const double2 q = *reinterpret_cast<const double2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

__device__ __forceinline__ float fma_(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_(double a, double b, double c) { return fma(a, b, c); }

// (ti, tj), ti >= tj, of the p-th lower-triangular tile in row order
__device__ __forceinline__ void tile_of(int p, int& ti, int& tj) {
  int i = (int)((sqrt(8.0 * (double)p + 1.0) - 1.0) * 0.5);
  while ((long long)(i + 1) * (i + 2) / 2 <= p) ++i;
  while ((long long)i * (i + 1) / 2 > p) --i;
  ti = i;
  tj = p - i * (i + 1) / 2;
}

// A thread's share of a chunk's copies: V-byte vectors at one column of
// each strip, every kStep-th row; neighbouring threads on neighbouring
// vectors of a row.
template <typename T, int V>
struct Loader {
  static constexpr int E = V / (int)sizeof(T);  // elements a vector
  static constexpr int kRowVecs = Geo<T>::kTile / E;
  static constexpr int kStep = kThreads / kRowVecs;
  static_assert(kThreads % kRowVecs == 0 && kChunk % kStep == 0, "whole rows a step");
  const T* src[2];  // row `row` of A at this thread's column of each strip
  bool col_ok[2];
  int row, smem_off;

  __device__ __forceinline__ Loader(const T* A, int P, int row0, int col0) {
    const int c = (threadIdx.x % kRowVecs) * E;
    row = threadIdx.x / kRowVecs;
    smem_off = row * Geo<T>::kTile + c;
    col_ok[0] = row0 + c < P;
    col_ok[1] = col0 + c < P;
    src[0] = A + (size_t)row * P + row0 + c;
    src[1] = A + (size_t)row * P + col0 + c;
  }
  // rows r0 .. r0+kChunk-1 of both strips into slot[s][r][c]
  __device__ __forceinline__ void load(T* slot, const T* A, int R, int P, int r0) const {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int q = 0; q < kChunk / kStep; ++q) {
        const bool valid = col_ok[s] && r0 + row + q * kStep < R;
        const T* p = src[s] + (size_t)(r0 + q * kStep) * P;
        copy_async<T, V>(slot + s * kChunk * Geo<T>::kTile + q * kStep * Geo<T>::kTile + smem_off,
                         valid ? p : A, valid);
      }
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads, 2)
    k_syrk(const T* __restrict__ A, T* __restrict__ H, int R, int P) {
  using G = Geo<T>;
  constexpr int S = G::S, kTile = G::kTile, TS = 2 * S;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);

  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const int row0 = ti * kTile, col0 = tj * kTile;
  const bool diag = ti == tj;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / 4, wn = warp % 4, tm = lane / 4, tn = lane % 4;
  // this thread's rows: wr + h * 8S + [0, S); columns: wc + g * 4S + [0, S); h, g < 2
  const int wr = wm * G::kWarpRows + tm * S, wc = wn * G::kWarpCols + tn * S;
  const bool idle = row0 + wm * G::kWarpRows >= P || col0 + wn * G::kWarpCols >= P ||
                    (diag && wn * G::kWarpCols > wm * G::kWarpRows + G::kWarpRows - 1);

  T acc[TS][TS];
#pragma unroll
  for (int u = 0; u < TS; ++u)
#pragma unroll
    for (int v = 0; v < TS; ++v) acc[u][v] = T(0);

  const Loader<T, V> ld(A, P, row0, col0);
  const int n_chunks = (R + kChunk - 1) / kChunk;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_chunks) ld.load(ring + s * G::kSlot, A, R, P, s * kChunk);
    cp_commit();
  }
  for (int c = 0; c < n_chunks; ++c) {
    cp_wait<kStages - 2>();  // chunk c has landed (this thread's copies) ...
    __syncthreads();         // ... everyone's, and chunk c-1's slot is free
    const int next = c + kStages - 1;
    if (next < n_chunks) ld.load(ring + (next % kStages) * G::kSlot, A, R, P, next * kChunk);
    cp_commit();
    if (idle) continue;
    const T* si = ring + (c % kStages) * G::kSlot;  // si[k][a]: strip i
    const T* sj = si + kChunk * kTile;               // sj[k][b]: strip j
    T a[2][TS], b[2][TS];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      load_vec<S>(si + wr + h * 8 * S, a[0] + h * S);
      load_vec<S>(sj + wc + h * 4 * S, b[0] + h * S);
    }
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      if (k + 1 < kChunk) {
        const int nk = (k + 1) & 1;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          load_vec<S>(si + (k + 1) * kTile + wr + h * 8 * S, a[nk] + h * S);
          load_vec<S>(sj + (k + 1) * kTile + wc + h * 4 * S, b[nk] + h * S);
        }
      }
#pragma unroll
      for (int u = 0; u < TS; ++u)
#pragma unroll
        for (int w = 0; w < TS; ++w) {
          const int v = (u & 1) ? TS - 1 - w : w;
          acc[u][v] = fma_(a[k & 1][u], b[k & 1][v], acc[u][v]);
        }
    }
  }
  cp_wait<0>();
  __syncthreads();  // every warp is done with the ring

  // the finished tile, tile[a][b] = H[row0 + a, col0 + b]
  T(*tile)[kTile + 1] = reinterpret_cast<T(*)[kTile + 1]>(ring);
#pragma unroll
  for (int u = 0; u < TS; ++u)
#pragma unroll
    for (int v = 0; v < TS; ++v)
      tile[wr + (u / S) * 8 * S + u % S][wc + (v / S) * 4 * S + v % S] = acc[u][v];
  __syncthreads();

  // the tile itself, row by row (a diagonal tile: its lower half)
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int a = e / kTile, b = e % kTile;
    const int gr = row0 + a, gc = col0 + b;
    if (gr < P && gc < P && (!diag || b <= a)) H[(size_t)gr * P + gc] = tile[a][b];
  }
  // its mirror, H[col0 + b, row0 + a] = tile[a][b], row by row of the mirror
  for (int e = threadIdx.x; e < kTile * kTile; e += kThreads) {
    const int b = e / kTile, a = e % kTile;
    const int gr = col0 + b, gc = row0 + a;
    if (gr < P && gc < P && (!diag || a > b)) H[(size_t)gr * P + gc] = tile[a][b];
  }
}

// the copy width: the largest of 16, 8, 4 bytes dividing A's address and a
// row's bytes, and at least one element
template <typename T>
int vec_bytes(uintptr_t addr, int P) {
  const uintptr_t both = addr | ((uintptr_t)P * sizeof(T));
  return both % 16 == 0 ? 16 : both % 8 == 0 ? 8 : (int)sizeof(T) <= 4 ? 4 : 0;
}

template <typename T>
long long n_tiles(int P) {
  const long long n = (P + Geo<T>::kTile - 1) / Geo<T>::kTile;
  return n * (n + 1) / 2;
}

template <typename T, int V>
int launch(const T* A, T* H, int R, int P, unsigned blocks, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      k_syrk<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, Geo<T>::kSmem);
  if (e != cudaSuccess) return (int)e;
  k_syrk<T, V><<<blocks, kThreads, Geo<T>::kSmem, stream>>>(A, H, R, P);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const void* A, void* H, int R, int P, void* stream) {
  if (R < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const long long blocks = n_tiles<T>(P);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(A);
  T* h = static_cast<T*>(H);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec_bytes<T>(reinterpret_cast<uintptr_t>(A), P)) {
    case 16: return launch<T, 16>(a, h, R, P, (unsigned)blocks, s);
    case 8: return launch<T, 8>(a, h, R, P, (unsigned)blocks, s);
    case 4:
      if constexpr (sizeof(T) == 4) return launch<T, 4>(a, h, R, P, (unsigned)blocks, s);
      [[fallthrough]];
    default: return (int)cudaErrorMisalignedAddress;
  }
}

template <typename T>
void geometry(int P, int* out) {
  const int g[7] = {Geo<T>::kTile, kThreads, kChunk, kStages, vec_bytes<T>(0, P), Geo<T>::kSmem,
                    (int)n_tiles<T>(P)};
  for (int i = 0; i < 7; ++i) out[i] = g[i];
}

}  // namespace

extern "C" int syrk_f32(const void* A, void* H, int R, int P, void* stream) {
  return run<float>(A, H, R, P, stream);
}

extern "C" int syrk_f64(const void* A, void* H, int R, int P, void* stream) {
  return run<double>(A, H, R, P, stream);
}

// The launch geometry for an element size (4 or 8) and P >= 1, with A at an
// address aligned to 16 bytes: out = {tile edge, threads, chunk rows, ring
// stages, copy bytes, dynamic shared memory bytes, blocks};
// ops/syrk.syrk_plan mirrors it.
extern "C" int syrk_geometry(int itemsize, int P, int* out) {
  if (P < 1) return (int)cudaErrorInvalidValue;
  if (itemsize == 4) {
    geometry<float>(P, out);
  } else if (itemsize == 8) {
    geometry<double>(P, out);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return 0;
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
