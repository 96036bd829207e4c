// The tile ring of the symmetric-half persistent panel kernels
// (latrd_v4.cu, latrd_v3.cu): both walk the lower-triangle 64x64 tiles of a
// panel's trailing block in the order of ops/latrd_v4.py `panel_schedule`,
// keep a block's first n_res tiles resident in shared memory and stream the
// rest through a ring of kRing slots (ops/latrd_v4.py `slot_bytes`, `RING`,
// `MAX_RES` mirror the constants here).

#pragma once

#include "latrd_common.cuh"

namespace latrd {

constexpr int kTile = 64;
constexpr int kMaxRes = 16;  // resident tiles per block, at most

// A slot: a 64x64 tile in rows padded by 16 bytes (a warp's 16-byte reads
// of 8 consecutive rows then hit distinct banks), then col[S:S+64], col[R:R+64].
template <typename T> constexpr int kLd = kTile + 16 / sizeof(T);
template <typename T> constexpr int kSlot = kTile * kLd<T> + 2 * kTile;
template <typename T> constexpr int kRing = sizeof(T) == 4 ? 3 : 2;  // streamed-tile slots

struct TileAt {
  int k, r, s;  // window, tile row, tile column
};
// panel_schedule's code: k << 20 | r << 10 | s
__device__ __forceinline__ TileAt decode(int code) {
  return {code >> 20, (code >> 10) & 1023, code & 1023};
}

// cp.async of tile t's elements (with_tile) and of col[S:S+64], col[R:R+64]
// into a slot
template <typename T>
__device__ __forceinline__ void load_slot(const Panel<T>& p, TileAt t, T* slot,
                                          bool with_tile) {
  constexpr int n = Vec<T>::n, per_row = kTile / n;
  const size_t mm = p.m;
  const int R = t.r * kTile, S = t.s * kTile;
  if (with_tile) {
    const T* A = p.Aw + ((size_t)t.k * mm + R) * mm + S;
    for (int e = threadIdx.x; e < kTile * per_row; e += kBlock) {
      const int row = e / per_row, cv = (e % per_row) * n;
      cp_async16(slot + row * kLd<T> + cv, A + row * mm + cv);
    }
  }
  if (threadIdx.x < 2 * per_row) {
    const int seg = threadIdx.x / per_row, cv = (threadIdx.x % per_row) * n;
    cp_async16(slot + kTile * kLd<T> + seg * kTile + cv, p.col + t.k * mm + (seg ? R : S) + cv);
  }
}

}  // namespace latrd
