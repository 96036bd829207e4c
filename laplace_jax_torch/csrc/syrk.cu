// Symmetric rank-k update H = A^T A for Hopper (sm_90a).
//
// Replaces the TPU kernel laplace_jax/ops/syrk.py, `syrk` (inner `kernel`):
// the dense GGN of FullLaplace, H = M^T M with M the (rows, P) square-root
// curvature rows of a batch (laplace_jax/curvature/backend.py:389-401). On
// the last-layer path of ResNet-18, M is (1280, 5130) per batch of 128.
//
// Design. One block per lower-triangular 64x64 output tile (i >= j), so
// 81 * 82 / 2 = 3321 blocks at P = 5130. The block walks the rows of A in
// chunks of 16: it stages the chunk's two 64-column strips (i and j) in
// shared memory, and each of its 256 threads accumulates a 4x4 sub-tile
// with plain FMAs (no tensor cores, no TF32: the port keeps full float32
// products). The finished tile goes through shared memory once more, so
// that both the tile and its mirror above the diagonal are written with
// coalesced stores; a diagonal tile writes its lower half and mirrors it.
// Every upper entry is the bitwise copy of its lower twin, so H is exactly
// symmetric. Ragged edges (R or P not a multiple of the tile) load zeros
// and store nothing. The JAX kernel computes the lower tiles and mirrors
// afterwards with XLA; fusing the mirror computes the same function.
//
// Bound. 2 R P (P + 1) / 2 = R P (P + 1) flops against (R P + P^2) * size
// bytes: at (1280, 5130) float32, 3.4e10 flops (0.50 ms at 67 TFLOP/s)
// against 131 MB (0.04 ms at 3.35 TB/s), so it is bound by operations.
// Each k step costs a thread 2 vector loads from shared memory for 16 FMAs.
// Left for later work: wgmma with 3xTF32 splitting, TMA staging and double
// buffering of the strips, a persistent grid.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;     // output tile edge
constexpr int kChunk = 16;    // rows of A staged per step
constexpr int kThreads = 256; // 16 x 16 threads, 4 x 4 outputs each
constexpr int kSub = 4;

template <typename T>
struct Smem {
  // the two staged strips, later reused for the finished tile (+1 column
  // of padding so the transposed read is free of bank conflicts)
  static constexpr int kStrips = 2 * kChunk * kTile;
  static constexpr int kStage = kTile * (kTile + 1);
  static constexpr int kCount = kStrips > kStage ? kStrips : kStage;
};

// four consecutive values of a row in shared memory, as vector loads
__device__ __forceinline__ void load4(const float* p, float (&v)[kSub]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[kSub]) {
  const double2 q0 = *reinterpret_cast<const double2*>(p);
  const double2 q1 = *reinterpret_cast<const double2*>(p + 2);
  v[0] = q0.x; v[1] = q0.y; v[2] = q1.x; v[3] = q1.y;
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

template <typename T>
__global__ void __launch_bounds__(kThreads) k_syrk(const T* __restrict__ A,
                                                    T* __restrict__ H, int R,
                                                    int P) {
  __shared__ __align__(16) T smem[Smem<T>::kCount];
  T(*si)[kTile] = reinterpret_cast<T(*)[kTile]>(smem);
  T(*sj)[kTile] = reinterpret_cast<T(*)[kTile]>(smem + kChunk * kTile);

  int ti, tj;
  tile_of(blockIdx.x, ti, tj);
  const int row0 = ti * kTile, col0 = tj * kTile;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  T acc[kSub][kSub];
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int v = 0; v < kSub; ++v) acc[u][v] = T(0);

  for (int r0 = 0; r0 < R; r0 += kChunk) {
    // stage rows r0 .. r0+15 of strips i and j; neighbouring threads read
    // neighbouring columns
#pragma unroll
    for (int q = 0; q < kChunk * kTile / kThreads; ++q) {
      const int e = threadIdx.x + q * kThreads;
      const int r = e / kTile, c = e % kTile;
      const int gr = r0 + r;
      const size_t base = (size_t)gr * P;
      si[r][c] = (gr < R && row0 + c < P) ? A[base + row0 + c] : T(0);
      sj[r][c] = (gr < R && col0 + c < P) ? A[base + col0 + c] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kChunk; ++k) {
      T a[kSub], b[kSub];
      load4(&si[k][ty * kSub], a);
      load4(&sj[k][tx * kSub], b);
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int v = 0; v < kSub; ++v) acc[u][v] = fma_(a[u], b[v], acc[u][v]);
    }
    __syncthreads();
  }

  // the finished tile, tile[a][b] = H[row0 + a, col0 + b]
  T(*tile)[kTile + 1] = reinterpret_cast<T(*)[kTile + 1]>(smem);
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int v = 0; v < kSub; ++v) tile[ty * kSub + u][tx * kSub + v] = acc[u][v];
  __syncthreads();

  const bool diag = ti == tj;
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

template <typename T>
int run(const void* A, void* H, int R, int P, void* stream) {
  if (R < 0 || P < 1) return (int)cudaErrorInvalidValue;
  const long long nt = (P + kTile - 1) / kTile;
  const long long blocks = nt * (nt + 1) / 2;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  k_syrk<T><<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(H), R, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int syrk_f32(const void* A, void* H, int R, int P, void* stream) {
  return run<float>(A, H, R, P, stream);
}

extern "C" int syrk_f64(const void* A, void* H, int R, int P, void* stream) {
  return run<double>(A, H, R, P, stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
