// Batched cyclic Jacobi for the leaves of stage 2's divide and conquer, on
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's leaves (laplace_jax/ops/
// tridiag_eig.py, `_jacobi_eigh`) are jnp code that XLA compiles into one
// program. The port's plain version (ops/tridiag_eig._jacobi_eigh_plain)
// runs each tournament round as some 35 PyTorch launches, so a class's
// 12 sweeps x 35 rounds were about 14,700 launches paced by the host. Here a
// whole call is one launch.
//
// Bound. The leaves are tiny: (B, m, m) with m <= 48 (36 on ResNet-18's
// classes, B up to 384). Bytes: A in, vals and vecs out, B (2 m^2 + m)
// elements (4 MB at the 4608 class, float32: about 1.2 us at 3.35 TB/s).
// Operations: each round rotates all of A (6 flops an entry) and V (3), so
// 12 sweeps x (mp - 1) rounds x 9 mp^2 flops a leaf (1.9 GFLOP at the 4608
// class: about 28 us at 67 TFLOP/s). Neither is what bounds it: the
// 12 (mp - 1) rounds of a leaf follow one another, two block barriers each,
// so a launch is a chain of dependent shared-memory steps.
//
// Design:
//   - one block per leaf; its A and V (padded to even mp, a decoupled zero
//     row and column for odd m, as the plain version pads) stay in shared
//     memory for all the sweeps and are written out once. At m <= 48,
//     float64 takes 2 x 48 x 49 x 8 = 37.6 KB of static shared memory;
//   - the round-robin pairs come in closed form from (round, slot), the
//     pairs of the plain version's schedule (ops/tridiag_eig._round_robin_pair
//     writes the same formula), so there is no schedule to copy;
//   - a round: one thread per pair computes (c, s) with the plain version's
//     formula and rounding (`tiny`, the `cap` clamp, the tau == 0 and
//     |tau| > cap branches, c = 1 and s = 0 where |apq| <= tiny); barrier;
//     then each thread takes 2 x 2 blocks of A, (rows p, q) x (columns p',
//     q') for two pairs, and applies R^T from the left then R from the right
//     (the order of the plain version's R^T A R), or two entries of a row
//     of V and applies R; barrier. A rotation of rows p, q and columns p',
//     q' touches only that 2 x 2 block, so no entry has two writers;
//   - the eigenvalues leave in ascending order by a stable rank computed in
//     the block (ties by index, as a stable argsort; a NaN last, and the
//     ranks still a permutation, so that the caller's flags see it), and V's
//     first m columns in that order.
// Full float32 or float64 arithmetic throughout (no reduced precision; the
// compiler may fuse a product and a sum into one FMA in the rotations).

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxM = 48;          // ops/tridiag_eig.BASE_SIZE
constexpr int kLd = kMaxM + 1;     // a shared row, padded against bank conflicts
constexpr int kHalf = kMaxM / 2;   // pairs a round, at most
constexpr int kThreads = 256;

template <typename T>
struct Lim;
template <>
struct Lim<float> {
  __device__ static float tiny() { return (float)((double)FLT_MIN * 1e6); }
  __device__ static float cap() { return (float)(1.0 / sqrt((double)FLT_EPSILON)); }
  __device__ static float mul(float a, float b) { return __fmul_rn(a, b); }
  __device__ static float add(float a, float b) { return __fadd_rn(a, b); }
};
template <>
struct Lim<double> {
  __device__ static double tiny() { return DBL_MIN * 1e6; }
  __device__ static double cap() { return 1.0 / sqrt(DBL_EPSILON); }
  __device__ static double mul(double a, double b) { return __dmul_rn(a, b); }
  __device__ static double add(double a, double b) { return __dadd_rn(a, b); }
};

// slot i of round r of the round-robin over mp players (mp even): player 0
// stays, the others turn one place a round (ops/tridiag_eig._round_robin_pair)
__device__ __forceinline__ void pair_of(int mp, int r, int i, int& p, int& q) {
  const int n = mp - 1;
  const int a = i == 0 ? 0 : 1 + (i - 1 - r + n) % n;
  const int b = 1 + (n - 1 - i - r + n) % n;
  p = a < b ? a : b;
  q = a < b ? b : a;
}

// the plain version's (c, s), each product and sum rounded as its own op
template <typename T>
__device__ __forceinline__ void rotation(T app, T aqq, T apq, T& c, T& s) {
  using L = Lim<T>;
  const T tiny = L::tiny(), cap = L::cap();
  const bool zero = fabs(apq) <= tiny;
  const T tau = (aqq - app) / (zero ? T(1) : L::mul(T(2), apq));
  const T tau_c = tau < -cap ? -cap : (tau > cap ? cap : tau);  // a NaN stays NaN
  const T sgn = T((tau_c > T(0)) - (tau_c < T(0)));               // torch.sign: 0 at NaN
  T t = sgn / (fabs(tau_c) + sqrt(L::add(T(1), L::mul(tau_c, tau_c))));
  if (fabs(tau) > cap) t = T(0.5) / tau;
  if (tau == T(0)) t = T(1);
  T cc = T(1) / sqrt(L::add(T(1), L::mul(t, t)));
  T ss = L::mul(t, cc);
  c = zero ? T(1) : cc;
  s = zero ? T(0) : ss;
}

// x sorts before y: ascending, a NaN after every number, ties by index
template <typename T>
__device__ __forceinline__ bool before(T x, int i, T y, int j) {
  const bool nx = x != x, ny = y != y;  // NaN
  if (nx || ny) return (!nx && ny) || (nx && ny && i < j);
  return x < y || (x == y && i < j);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    k_leaves(const T* __restrict__ A, T* __restrict__ vals, T* __restrict__ vecs, int m,
             int sweeps) {
  __shared__ T a[kMaxM * kLd];
  __shared__ T v[kMaxM * kLd];
  __shared__ T cs[2 * kHalf];   // c of pair k at [k], s at [kHalf + k]
  __shared__ int pq[2 * kHalf];  // p of pair k at [k], q at [kHalf + k]
  __shared__ int perm[kMaxM];    // perm[rank] = the index of that eigenvalue

  const int tid = threadIdx.x;
  const int mp = m + (m & 1), half = mp / 2;
  const size_t leaf = blockIdx.x;
  const T* src = A + leaf * m * m;

  for (int idx = tid; idx < mp * mp; idx += kThreads) {
    const int i = idx / mp, j = idx - i * mp;
    a[i * kLd + j] = (i < m && j < m) ? src[i * m + j] : T(0);
    v[i * kLd + j] = i == j ? T(1) : T(0);
  }
  __syncthreads();

  const int blocks = half * half;  // 2 x 2 blocks of A, then pairs of entries of V's rows
  for (int sweep = 0; sweep < sweeps; ++sweep) {
    for (int r = 0; r < mp - 1; ++r) {
      if (tid < half) {
        int p, q;
        pair_of(mp, r, tid, p, q);
        T c, s;
        rotation(a[p * kLd + p], a[q * kLd + q], a[p * kLd + q], c, s);
        pq[tid] = p;
        pq[kHalf + tid] = q;
        cs[tid] = c;
        cs[kHalf + tid] = s;
      }
      __syncthreads();
      for (int idx = tid; idx < blocks + mp * half; idx += kThreads) {
        if (idx < blocks) {
          const int bi = idx / half, bj = idx - bi * half;
          const int p1 = pq[bi], q1 = pq[kHalf + bi], p2 = pq[bj], q2 = pq[kHalf + bj];
          const T c1 = cs[bi], s1 = cs[kHalf + bi], c2 = cs[bj], s2 = cs[kHalf + bj];
          T* rp = a + p1 * kLd;
          T* rq = a + q1 * kLd;
          const T xpp = rp[p2], xpq = rp[q2], xqp = rq[p2], xqq = rq[q2];
          // R^T A: rows p, q
          const T ypp = c1 * xpp - s1 * xqp, ypq = c1 * xpq - s1 * xqq;
          const T yqp = s1 * xpp + c1 * xqp, yqq = s1 * xpq + c1 * xqq;
          // (R^T A) R: columns p', q'
          rp[p2] = c2 * ypp - s2 * ypq;
          rp[q2] = s2 * ypp + c2 * ypq;
          rq[p2] = c2 * yqp - s2 * yqq;
          rq[q2] = s2 * yqp + c2 * yqq;
        } else {
          const int k = idx - blocks;
          const int i = k / half, bj = k - i * half;
          const int p2 = pq[bj], q2 = pq[kHalf + bj];
          const T c2 = cs[bj], s2 = cs[kHalf + bj];
          T* row = v + i * kLd;
          const T x = row[p2], y = row[q2];
          row[p2] = c2 * x - s2 * y;
          row[q2] = s2 * x + c2 * y;
        }
      }
      __syncthreads();
    }
  }

  if (tid < m) {
    const T x = a[tid * kLd + tid];
    int rank = 0;
    for (int j = 0; j < m; ++j) rank += before(a[j * kLd + j], j, x, tid);
    perm[rank] = tid;
    vals[leaf * m + rank] = x;
  }
  __syncthreads();
  T* dst = vecs + leaf * m * m;
  for (int idx = tid; idx < m * m; idx += kThreads) {
    const int i = idx / m, k = idx - i * m;
    dst[idx] = v[i * kLd + perm[k]];
  }
}

template <typename T>
int run(const void* A, void* vals, void* vecs, int B, int m, int sweeps, void* stream) {
  if (B < 0 || m < 2 || m > kMaxM || sweeps < 0) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  k_leaves<T><<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(A), static_cast<T*>(vals), static_cast<T*>(vecs), m, sweeps);
  return (int)cudaGetLastError();
}

}  // namespace

// A (B, m, m), vals (B, m), vecs (B, m, m), all contiguous on the card;
// 2 <= m <= 48. Returns cudaGetLastError() after the launch.
extern "C" int jacobi_leaves_f32(const void* A, void* vals, void* vecs, int B, int m, int sweeps,
                                 void* stream) {
  return run<float>(A, vals, vecs, B, m, sweeps, stream);
}

extern "C" int jacobi_leaves_f64(const void* A, void* vals, void* vecs, int B, int m, int sweeps,
                                 void* stream) {
  return run<double>(A, vals, vecs, B, m, sweeps, stream);
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
