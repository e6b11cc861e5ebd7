// Pieces the WKV6 forward (wkv6.cu) and backward (wkv6_bwd.cu) share: the
// state tiles, the token tile, the vector loads from shared memory and the
// lane butterfly.
#pragma once

#include "common.cuh"

namespace wkv6 {

constexpr int TT = 32;  // tokens per staged tile
constexpr int U = 8;    // tokens whose sums over lanes go out together

// The forward's tiles: a thread carries an R x C tile of the state (R rows
// of C columns); the G = N / R threads of a column group are adjacent
// lanes; a block owns a slab of JC columns of one (b, h). (R, C, JC) per
// head size. The backward's row passes take the same tiles transposed.
template <int N> struct Tile;
template <> struct Tile<8> { static constexpr int R = 2, C = 1, JC = 8; };
template <> struct Tile<16> { static constexpr int R = 4, C = 1, JC = 16; };
template <> struct Tile<32> { static constexpr int R = 4, C = 4, JC = 32; };
template <> struct Tile<64> { static constexpr int R = 4, C = 4, JC = 16; };

// The M floats at src (aligned to their vector) into registers
template <int M>
__device__ __forceinline__ void load_vec(float (&dst)[M], const float* src) {
  if constexpr (M % 4 == 0) {
#pragma unroll
    for (int q = 0; q < M / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(src)[q];
      dst[4 * q] = x.x, dst[4 * q + 1] = x.y, dst[4 * q + 2] = x.z, dst[4 * q + 3] = x.w;
    }
  } else if constexpr (M % 2 == 0) {
#pragma unroll
    for (int q = 0; q < M / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(src)[q];
      dst[2 * q] = x.x, dst[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < M; ++q) dst[q] = src[q];
  }
}

// Sums a[u][c] over the G lanes of a group, for U tokens at once: a
// butterfly in which the first log2(C) steps also halve the values a lane
// carries (it keeps the entries whose bit matches its own and sends the
// others), so that lane g ends with entry g % C's sum in a[u][0]. Each
// step's U * m shuffles are independent: their latencies overlap.
template <int U, int C, int G>
__device__ __forceinline__ void group_sums(float (&a)[U][C], int g) {
#pragma unroll
  for (int o = 1, m = C; m > 1; o <<= 1, m >>= 1) {
    const bool hi = g & o;
#pragma unroll
    for (int x = 0; x < U; ++x)
#pragma unroll
      for (int q = 0; q < m / 2; ++q) {
        const float keep = hi ? a[x][2 * q + 1] : a[x][2 * q];
        const float send = hi ? a[x][2 * q] : a[x][2 * q + 1];
        a[x][q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
      }
  }
#pragma unroll
  for (int o = C; o < G; o <<= 1)
#pragma unroll
    for (int x = 0; x < U; ++x) a[x][0] += __shfl_xor_sync(0xffffffffu, a[x][0], o);
}

}  // namespace wkv6
