// Quantized payloads widened to bf16 in registers, and the tensor-core
// product they feed: shared by the decode GEMV (qgemv.cu, kernel A) and the
// quantized GEMM (qgemm.cu, kernel C).
//
// Payload types, as ops/quant.py stores them (the contraction dim k
// contiguous, [N, K] or [N, K/2]):
// - int8_t: one value a byte;
// - Fp8E4M3: torch.float8_e4m3fn, one value a byte;
// - Nib4 / Nib4G: int4, two values a byte biased by 8, byte j of a row
//   holding k = j (low nibble) and k = j + K/2 (high nibble); Nib4 has one
//   scale a column, Nib4G a scale per column and group of k.
//
// Widening reads one 32-bit word of 4 payload bytes as 4 consecutive k
// (k, k + 1, k + 2, k + 3; for nibbles, the low nibbles give 4 consecutive
// k of the row's first half and the high nibbles the same 4 of its second
// half) and gives two bf16x2 words, `lo` (k, k + 1) and `hi` (k + 2,
// k + 3), the lower k in the lower half. Exact for every value.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace widen {

struct Fp8E4M3 { uint8_t bits; };       // torch.float8_e4m3fn storage
struct Nib4 { uint8_t bits; };          // int4 pairs, one scale a column
struct Nib4G { uint8_t bits; };         // int4 pairs, group scales

template <typename W> struct Payload {
  static constexpr bool kNibbles = false;
  static constexpr bool kGrouped = false;
};
template <> struct Payload<Nib4> {
  static constexpr bool kNibbles = true;
  static constexpr bool kGrouped = false;
};
template <> struct Payload<Nib4G> {
  static constexpr bool kNibbles = true;
  static constexpr bool kGrouped = true;
};

// Four unsigned bytes u (0..255) less `bias`, as bf16: each byte placed in
// the mantissa of 2^23 (the f32 2^23 + u); less 2^23 + bias gives u - bias
// as an f32 integer, whose upper half is its bf16 (at most 8 significant
// bits).
__device__ __forceinline__ void widen_biased(uint32_t u, float bias,
                                             uint32_t& lo, uint32_t& hi) {
  const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
  const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
  const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
  const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
  lo = __byte_perm(__float_as_uint(f0 - bias), __float_as_uint(f1 - bias),
                   0x7632);
  hi = __byte_perm(__float_as_uint(f2 - bias), __float_as_uint(f3 - bias),
                   0x7632);
}

// int8: biased to u = q + 128.
__device__ __forceinline__ void widen_int8(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  widen_biased(w ^ 0x80808080u, 8388736.f, lo, hi);      // 2^23 + 128
}

// int4 nibbles, stored biased by 8: the low nibbles (the row's first half)
// or the high nibbles (its second half) of 4 bytes.
__device__ __forceinline__ void widen_nib_lo(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  widen_biased(w & 0x0F0F0F0Fu, 8388616.f, lo, hi);      // 2^23 + 8
}
__device__ __forceinline__ void widen_nib_hi(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
  widen_biased((w >> 4) & 0x0F0F0F0Fu, 8388616.f, lo, hi);
}

// e4m3 (s eeee mmm, bias 7): the sign to bf16's bit 15, eeee mmm to its
// exponent's low 4 bits and its mantissa's top 3, which reads the value
// against bf16's bias 127 (subnormals as bf16 subnormals); times 2^120,
// a product by a power of two with a normal result, so exact.
__device__ __forceinline__ uint32_t e4m3_pair(uint32_t a) {
  uint32_t r = (a & 0x80008000u) | ((a >> 4) & 0x07F007F0u);
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(r), "r"(0x7B807B80u), "r"(0x80008000u));   // 2^120, -0
  return r;
}

__device__ __forceinline__ void widen_e4m3(uint32_t w, uint32_t& lo,
                                           uint32_t& hi) {
  lo = e4m3_pair(__byte_perm(w, 0, 0x1404));   // b1 << 24 | b0 << 8
  hi = e4m3_pair(__byte_perm(w, 0, 0x3424));   // b3 << 24 | b2 << 8
}

// One word of a one-value-a-byte payload (int8 or e4m3).
template <typename W>
__device__ __forceinline__ void widen_bytes(uint32_t w, uint32_t& lo,
                                            uint32_t& hi);
template <>
__device__ __forceinline__ void widen_bytes<int8_t>(uint32_t w, uint32_t& lo,
                                                    uint32_t& hi) {
  widen_int8(w, lo, hi);
}
template <>
__device__ __forceinline__ void widen_bytes<Fp8E4M3>(uint32_t w,
                                                     uint32_t& lo,
                                                     uint32_t& hi) {
  widen_e4m3(w, lo, hi);
}

// c += a . b: a 16x16 bf16 (row-major fragment), b 16x8 bf16, c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Word q (0..3) of a 16-byte load.
__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

}  // namespace widen
