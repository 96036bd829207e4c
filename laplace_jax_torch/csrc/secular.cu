// The secular roots of stage 2's merges (divide and conquer), on Hopper
// (sm_90a): for every root of every merge of one level, the origin pole
// and the root's offset mu from it, in float64.
//
// Replaces no TPU kernel: the JAX package's solve is jnp code inside
// `fori_loop`s (laplace_jax/ops/tridiag_eig.py, `_merge_level`) that XLA
// compiles into one program. The port's plain version
// (ops/tridiag_eig._secular_plain) evaluates the secular function 52 times a
// level (the origin choice, 40 bisection steps, 10 refinement steps, the
// final check), each as some eight PyTorch launches over float64 (B, M, M)
// temporaries in device memory: about 60,000 launches and 6 s of streaming a
// fit of the DeepSeek-V2-Lite reward model. Here a level is one launch.
//
// Bound. A merge of M roots and M poles needs, per (root, pole) pair, 42
// evaluations of f (a subtraction from the origin, one from mu, a division
// and an add) and 10 of f and f' (a second division and add): 228 B M^2
// operations, counting a division as one. The bytes are the poles and
// roots in and out, a few B M x 8 bytes. So operations bound it, by far: at
// (1, 11008), 27.6 GOP, 0.81 ms at 34 TFLOP/s of float64. A correctly
// rounded float64 division takes a reciprocal estimate and several FMAs, so
// the real least is a few times that.
//
// Design:
//   - one root per group of G lanes (G = 1 to 32, a power of two), its
//     state (bracket, mu, the best so far) in registers; the G lanes of a
//     root split its pole loop, strided so that they read neighbouring
//     poles, each lane two poles at a time into two partial sums (so that
//     their divisions overlap), and add their sums by a butterfly of
//     shuffles, after which every lane holds the same sums bit for bit and
//     takes the same steps;
//   - a merge's poles, (ds[t], rho z2[t]) as one double2, sit in dynamic
//     shared memory for all 52 evaluations: 16 M bytes, 176 KB at M =
//     11,008. A merge too large for a block's shared memory streams its
//     poles through it in tiles, every evaluation (M > 14,528 on the H100);
//   - the launch shape follows from (B, M) (`plan` below): G doubles while
//     the launch has fewer than 4 times the threads the card holds at once
//     and each lane keeps at least 32 poles; merges that fit P times into a
//     block of 256 threads share a block (the block rounded to whole warps),
//     a larger merge is cut into slices of T / G roots, one a block, each
//     block with the whole merge's poles, T doubling from 256 up to 1024
//     threads while the merge still spans 4 blocks: a 176 KB merge leaves
//     room for one block
//     on an SM, which at 256 threads could not hide the divisions' latency
//     (on an H100 at 700 W, 29.7 ms at (1, 11008) with 256 threads, 11.3 ms
//     with 1024);
//   - the plain version's operations, in its order and in float64: the
//     denominator (ds[t] - d_origin) - mu with 0 replaced by tiny, rho z2 /
//     denom and (rho z2 / denom) / denom, f = 1 + sum, masked poles (z2 <= 0)
//     adding nothing (their terms are computed and dropped). The sums over
//     the poles are taken in another order, the only difference. Bisection
//     steps need f alone and skip f'.
//     Division is IEEE (no fast math), and no product feeds a sum, so no
//     FMA contraction can move a value; the products are __dmul_rn all the
//     same.
// The launch does not synchronise; the C entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;   // root slots of a block of packed merges at G = 1
constexpr int kMaxThreads = 1024;
constexpr int kMaxLanes = 32;   // lanes of a root: at most a warp
constexpr int kMinPoles = 32;   // poles each lane keeps, at least
constexpr int kWaves = 4;       // threads a launch aims for, in cards-full
constexpr int kBisect = 40;     // ops/tridiag_eig.BISECT_ITERS
constexpr int kRefine = 10;     // ops/tridiag_eig.REFINE_ITERS

struct Plan {
  int G;             // lanes a root
  int P;             // merges a block
  int S;             // blocks (slices) a merge
  int T;             // threads a block
  int C;             // poles of a merge in shared memory at once (C < M: tiles)
  size_t smem;       // dynamic shared memory of a block
  long long blocks;  // the grid
};

int device_attr(cudaDeviceAttr attr) {
  int dev = 0, v = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&v, attr, dev);
  return v;
}

Plan plan(long long B, int M) {
  const long long roots = B * M;
  const long long full = (long long)device_attr(cudaDevAttrMultiProcessorCount) *
                         device_attr(cudaDevAttrMaxThreadsPerMultiProcessor);
  const int smem_max = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  Plan p;
  p.G = 1;
  while (p.G < kMaxLanes && M >= 2 * p.G * kMinPoles && roots * p.G < kWaves * full) p.G *= 2;
  if (M * p.G <= kThreads) {
    p.P = kThreads / (M * p.G);
    p.S = 1;
    p.T = (p.P * M * p.G + 31) / 32 * 32;
    p.C = M;
  } else {
    p.P = 1;
    p.T = kThreads;
    while (p.T < kMaxThreads && 8 * p.T <= M * p.G) p.T *= 2;
    const int slots = p.T / p.G;
    p.S = (M + slots - 1) / slots;
    const int fit = smem_max / (int)sizeof(double2);
    p.C = M < fit ? M : fit;
  }
  p.smem = (size_t)p.P * p.C * sizeof(double2);
  p.blocks = (long long)p.S * ((B + p.P - 1) / p.P);
  return p;
}

// where a block's threads find their merges' poles
struct Poles {
  const double* ds;
  const double* z2;
  const double* rho;
  long long B;
  int M;
  long long first;  // the block's first merge
  int P, C;
  bool tiled;
};

// poles [k0, k0 + n) of the block's P merges into shared memory: (ds[t],
// rho z2[t]), with -1 in place of rho z2 where z2 <= 0 (rho = |e| >= 0, so
// an unmasked pole's is >= 0 or NaN)
__device__ void load(double2* sm, const Poles& q, int k0, int n) {
  for (int i = threadIdx.x; i < q.P * n; i += blockDim.x) {
    const int k = i / n, t = i - k * n;
    const long long b = q.first + k < q.B ? q.first + k : q.B - 1;
    const size_t at = (size_t)b * q.M + k0 + t;
    const double z = q.z2[at];
    sm[i] = make_double2(q.ds[at], z > 0.0 ? __dmul_rn(q.rho[b], z) : -1.0);
  }
}

// one pole's terms at lambda = d_o + mu, denom = (d - d_o) - mu: rho z2 /
// denom into s1 and, with kDeriv, (rho z2 / denom) / denom into s2; a masked
// pole's are computed and dropped (a select, so that two poles' divisions
// can overlap)
template <bool kDeriv>
__device__ __forceinline__ void add_pole(double2 pole, double d_o, double mu, double tiny,
                                         double& s1, double& s2) {
  double den = (pole.x - d_o) - mu;
  if (den == 0.0) den = tiny;
  const bool masked = pole.y < 0.0;
  const double t1 = pole.y / den;
  s1 += masked ? 0.0 : t1;
  if (kDeriv) s2 += masked ? 0.0 : t1 / den;
}

// the secular sums of a root: s1 = sum rho z2 / denom and, with kDeriv, s2
// = sum (rho z2 / denom) / denom, over the merge's poles, each lane a
// strided share in two partial sums, then the lanes' butterfly
template <bool kDeriv>
__device__ void sums(double2* sm, const double2* mine, const Poles& q, int lane, int G, double d_o,
                     double mu, double tiny, double& s1, double& s2) {
  double a1 = 0.0, a2 = 0.0;
  s1 = 0.0;
  s2 = 0.0;
  for (int k0 = 0; k0 < q.M; k0 += q.C) {
    const int n = q.M - k0 < q.C ? q.M - k0 : q.C;
    if (q.tiled) {
      __syncthreads();
      load(sm, q, k0, n);
      __syncthreads();
    }
    int t = lane;
    for (; t + G < n; t += 2 * G) {
      add_pole<kDeriv>(mine[t], d_o, mu, tiny, s1, s2);
      add_pole<kDeriv>(mine[t + G], d_o, mu, tiny, a1, a2);
    }
    if (t < n) add_pole<kDeriv>(mine[t], d_o, mu, tiny, s1, s2);
  }
  s1 += a1;
  s2 += a2;
  for (int off = G >> 1; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    if (kDeriv) s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
}

__global__ void __launch_bounds__(kMaxThreads)
    k_secular(const double* __restrict__ ds, const double* __restrict__ z2,
              const double* __restrict__ rho, const double* __restrict__ gap,
              const long long* __restrict__ nxt, double* __restrict__ mu_out,
              long long* __restrict__ origin_out, long long B, int M, int G, int P, int S, int C,
              double tiny) {
  extern __shared__ double2 sm[];
  const int tid = threadIdx.x, lane = tid & (G - 1), slot = tid / G;
  const long long group = blockIdx.x / S;
  const int slice = (int)(blockIdx.x - group * S);
  int k = 0, r = slot;
  if (S == 1) {
    k = slot / M;
    r = slot - k * M;
  } else {
    r = slice * ((int)blockDim.x / G) + slot;
  }
  // a thread past the block's roots works on its last root, writes nothing,
  // and keeps its warp whole for the shuffles and its block for the barriers
  const bool valid = k < P && r < M && group * P + k < B;
  k = k < P ? k : P - 1;
  r = r < M ? r : M - 1;
  const long long b = group * P + k < B ? group * P + k : B - 1;

  const Poles q{ds, z2, rho, B, M, group * P, P, C, C < M};
  if (!q.tiled) {
    load(sm, q, 0, M);
    __syncthreads();
  }
  const double2* mine = q.tiled ? sm : sm + (size_t)k * M;
  const double* dsb = ds + (size_t)b * M;
  const size_t at = (size_t)b * M + r;
  const double g = gap[at];
  const long long up = nxt[at];
  const bool has_up = up < M;
  double s1, s2;

  // origin: the root in the upper half of its gap takes the upper pole
  sums<false>(sm, mine, q, lane, G, dsb[r], __dmul_rn(0.5, g), tiny, s1, s2);
  const bool use_up = (1.0 + s1 < 0.0) && has_up;
  const long long origin = use_up ? up : r;
  const double d_o = dsb[origin];

  double lo = use_up ? __dmul_rn(-0.5, g) : 0.0;
  double hi = use_up ? 0.0 : (has_up ? __dmul_rn(0.5, g) : g);
  double mu;
  for (int it = 0; it < kBisect; ++it) {
    mu = __dmul_rn(0.5, lo + hi);
    sums<false>(sm, mine, q, lane, G, d_o, mu, tiny, s1, s2);
    if (1.0 + s1 < 0.0) lo = mu;
    else hi = mu;
  }
  mu = __dmul_rn(0.5, lo + hi);

  // pole-dominant fixed point (laed4's rational model), Newton, halving
  const double w_o = __dmul_rn(rho[b], z2[(size_t)b * M + origin]);
  double best_mu = mu, best_af = INFINITY;
  for (int it = 0; it < kRefine; ++it) {
    sums<true>(sm, mine, q, lane, G, d_o, mu, tiny, s1, s2);
    const double f = 1.0 + s1, fp = s2;
    const double af = fabs(f);
    if (af < best_af) {
      best_mu = mu;
      best_af = af;
    }
    if (f < 0.0) lo = mu;
    else hi = mu;
    const double mu_safe = mu == 0.0 ? tiny : mu;
    const double denom = 1.0 + ((f - 1.0) + w_o / mu_safe);
    const double mu_fp = w_o / (denom == 0.0 ? tiny : denom);
    const double mu_nt = mu - f / (fp < tiny ? tiny : fp);  // clamp(min=tiny): NaN stays NaN
    if (mu_fp >= lo && mu_fp <= hi) mu = mu_fp;
    else if (mu_nt >= lo && mu_nt <= hi) mu = mu_nt;
    else mu = __dmul_rn(0.5, lo + hi);
  }
  sums<false>(sm, mine, q, lane, G, d_o, mu, tiny, s1, s2);
  if (!(fabs(1.0 + s1) <= best_af)) mu = best_mu;

  if (valid && lane == 0) {
    mu_out[at] = mu;
    origin_out[at] = origin;
  }
}

}  // namespace

// ds, z2, gap, nxt, mu, origin (B, M) and rho (B), contiguous on the card;
// ds ascending in each merge, z2 = 0 at a deflated pole, nxt the next active
// pole above each (M where none), gap the bracket's width (ops/tridiag_eig.
// _merge_level). Writes mu and origin. Returns cudaGetLastError() after the
// launch.
extern "C" int secular_f64(const void* ds, const void* z2, const void* rho, const void* gap,
                           const void* nxt, void* mu, void* origin, long long B, int M,
                           double tiny, void* stream) {
  if (B < 0 || M < 1) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Plan p = plan(B, M);
  if (p.blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(k_secular, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  k_secular<<<(unsigned)p.blocks, p.T, p.smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(ds), static_cast<const double*>(z2),
      static_cast<const double*>(rho), static_cast<const double*>(gap),
      static_cast<const long long*>(nxt), static_cast<double*>(mu),
      static_cast<long long*>(origin), B, M, p.G, p.P, p.S, p.C, tiny);
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
