// 3xTF32 building blocks on mma.sync (sm_90a) shared by the float32
// attention kernels (flash_attention.cu's forward, flash_attention_bwd.cu's
// backward): TF32 rounding and the hi + lo split, the m16n8k8 product,
// shared-memory loads, and 16-byte cp.async row copies.
//
// One TF32 rounding of each operand leaves ~1e-3 of error; with each
// operand x split into hi = tf32(x) and lo = tf32(x - hi) and each product
// taken as hi·hi + hi·lo + lo·hi (lo·lo, ~2^-22 relative, dropped) the error
// is float32's own.
#pragma once

#include "common.cuh"

namespace tf32 {

// x rounded to TF32 (10 explicit mantissa bits) to nearest, ties away from
// zero, as cvt.rna.tf32.f32 rounds a finite x: a float32 whose low 13 bits
// are zero. Two integer operations, where the conversion unit would take
// one at a quarter of the rate.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to within 2^-22 |x|, hi and lo both TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// d += a·b on the tensor cores: a 16 × 8 (row) by b 8 × 8 (col), float32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// N consecutive floats from 8N-byte aligned shared memory
template <int N>
__device__ __forceinline__ void lds(const float* p, float (&x)[N]) {
  if constexpr (N == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(p);
    x[0] = a.x; x[1] = a.y;
  }
}

// The XOR swizzle of a shared-memory tile with rows of a multiple of 32
// floats: element (r, c) lives at column c ^ swz(r) of row r. It moves
// 16-byte chunks within their 128-byte line, so that both fragment loads
// of the mma patterns are free of bank conflicts: 16 bytes at (rows r,
// r + 1; columns 4·tq) and NU floats at (rows 2·tq; columns NU·gr). swz
// depends on r mod 8 only.
__device__ __forceinline__ int swz(int r) {
  return ((((r >> 1) & 3) << 1) ^ ((r & 1) << 2)) << 2;
}

// rows r0 .. r0 + ROWS - 1 of an (S, HD) float32 matrix with row stride rs
// into shared memory rows of LD floats (swizzled by swz when SWZ), 16 bytes
// a cp.async issued by THREADS threads; rows past S arrive as zeros
template <int HD, int ROWS, int LD, int THREADS, bool SWZ = false>
__device__ __forceinline__ void load_rows(float* dst, const float* src, long long rs, int r0,
                                          int S) {
  constexpr int CPR = HD / 4;  // 16-byte copies a row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = 4 * (i % CPR);
    const bool in = r0 + r < S;
    rt::cp_async16(dst + r * LD + (SWZ ? c ^ swz(r) : c),
                   in ? src + (long long)(r0 + r) * rs + c : src, in ? 16 : 0);
  }
}

}  // namespace tf32
