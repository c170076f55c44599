// QK-norm, RoPE and the KV-cache write of one decoder layer, for Hopper
// (sm_90a), written by hand: ONE launch takes q, k and v as the layer's
// projections leave them ([B, T, heads * D] rows), RMS-normalises q and k
// per head with q_norm / k_norm, rotates them by the step's cos/sin,
// writes q out as [B, nq, T, D] and stores K and V into layer `layer` of
// the stacked cache at keys pos .. pos + T - 1 in the cache's own format:
// the working dtype, fp8 (e4m3fn), or int4 with a bf16 scale per (token,
// head) row. No TPU kernel: XLA fuses the same chain (rms_norm, apply_rope,
// _kv_quantize or astype, dynamic_update_slice;
// qwen3_asr_tpu/models/decoder.py:132-170, 240-261) into the JAX step
// program. See qwen3_asr_tpu_torch/ops/qk_rope_kv.py for the contract.
//
// Rounding points are the JAX decoder's, and the arithmetic is unfused
// (__fmul_rn / __fadd_rn: nvcc would otherwise contract into FMAs):
//   norm: m = sum(x * x) * (1 / D) (torch's CUDA mean multiplies by the
//         reciprocal), r = rsqrtf(m + eps), y = X((x * r) * w);
//   rope: z = X(y * cos + rot(y) * sin), rot(y)_j = -y_{j+D/2} below D/2
//         and y_{j-D/2} from D/2;
//   fp8:  torch's float -> Float8_e4m3fn conversion (c10's
//         fp8e4m3fn_from_fp32_value as the card's torch has it: round to
//         nearest even; from 464 up, where the rounding carries past 448,
//         the NaN pattern 0x7f, with the input's sign);
//   int4: scale = max(absmax / 7, 1e-8) in f32, q = clip(rint(x / scale),
//         -8, 7) with IEEE division, the scale stored rounded to bf16;
//         byte j of a row = (q[2j] + 8) | (q[2j + 1] + 8) << 4.
// V is stored as it comes.
//
// The sum of squares is taken in the order of torch's CUDA mean over a
// contiguous row of f32 values (ATen's Reduce.cuh, `mean_kernel_impl`),
// so the norm's bits, and q's and K's with them, are the plain version's
// on the card. There a row of D >= 128 is read as vectors of 4 (thread t
// adds elements 4t .. 4t + 3 in turn); a shorter row takes W = the power
// of two at or below D threads (at most 32), thread t adding elements t,
// t + W, t + 2W, ... in turn. The threads' sums then meet in a tree of
// shuffles at offsets W/2, W/4, ..., 1. The sum is then multiplied by
// 1/D, as torch's mean does. (From D = 64 to 127 torch may give a row two
// warps when there are few rows; the kernel keeps one, which can differ
// by an ulp there. The model's widths are 48 and 128.)
//
// What bounds it: a decode step moves a few KB a layer, so the time is
// launch and latency, never bytes; the chain it replaces was ~38 small
// kernels a layer. Design: everything stays in registers, one warp a row
// (one token's head of q, k or v), lane l holding the elements torch's
// thread l adds (at most 4: D <= 128), so the warp's loads and stores
// are coalesced and the sum of squares and, for int4, the absmax are one
// butterfly each (every lane ends with the same bits). The rotation
// partner (dim j +- D/2) is 16 lanes away in the same slot at D = 128 and
// one shuffle per slot away otherwise. The grid covers all
// B * T * (nq + 2 nkv) rows: one launch does the layer, prefill and
// decode step alike. The position is `*pos + pos_add` when `pos` is a
// device pointer (a CUDA graph replays the decode step at a new position
// with no host integer), `pos[b] + pos_add` for row b when `pos_per_row`
// is set (the resume loop's rows sit at their own frontiers: JAX scatters
// them, qwen3_asr_tpu/models/decoder.py:249-257), and `pos_add` alone
// otherwise; a key at or past S is not written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                      // elements a lane: D <= 128
constexpr unsigned kFull = 0xffffffffu;
enum Store { kSame = 0, kFp8 = 1, kInt4 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename X> __device__ __forceinline__ X from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to X and widened again
template <typename X> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<X>(x));
}

// c10's fp8e4m3fn_from_fp32_value as torch 2.11 has it, bit for bit.
__device__ __forceinline__ uint32_t fp8_e4m3fn(float f) {
  constexpr uint32_t kMax = 1087u << 20;          // 480.0f, first overflow
  constexpr uint32_t kDenormMask = 141u << 23;
  uint32_t bits = __float_as_uint(f);
  const uint32_t sign = bits & 0x80000000u;
  bits ^= sign;
  uint32_t r;
  if (bits >= kMax) {
    r = 0x7fu;                                    // NaN
  } else if (bits < (121u << 23)) {               // below 2^-6: subnormal
    bits = __float_as_uint(__fadd_rn(__uint_as_float(bits),
                                     __uint_as_float(kDenormMask)));
    r = (bits - kDenormMask) & 0xffu;
  } else {
    const uint32_t odd = (bits >> 20) & 1u;
    bits += ((uint32_t)(7 - 127) << 23) + 0x7ffffu + odd;
    r = (bits >> 20) & 0xffu;
  }
  return r | (sign >> 24);
}

__device__ __forceinline__ uint32_t nibble(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -8.f), 7.f);
  return (uint32_t)((int)r + 8);
}

struct Args {
  const void* q;              // [B, T, nq * D] rows, token stride q_ts
  const void* k;              // [B, T, nkv * D], k_ts
  const void* v;              // [B, T, nkv * D], v_ts
  long long q_ts, k_ts, v_ts; // elements between consecutive tokens
  const void* q_norm;         // [D], X
  const void* k_norm;
  const float* cos;           // [B, T, D]
  const float* sin;
  void* q_out;                // [B, nq, T, D], X
  void* kc;                   // [L, B, nkv, S, D] (X or fp8) or
  void* vc;                   //   [L, B, nkv, S, D / 2] uint8 (int4)
  __nv_bfloat16* ks;          // [L, B, nkv, S] int4 scales, else null
  __nv_bfloat16* vs;
  const long long* pos;       // device int64 ([B] if pos_per_row) or null
  long long pos_add;
  int pos_per_row;
  float eps, inv_d;
  int layer, batch, t, nq, nkv, s_len, d;
  int width;                  // W: torch's threads a row below D = 128
};

template <typename X, int kStore>
__global__ void __launch_bounds__(kThreads) qk_rope_kv_kernel(Args a) {
  const int lane = threadIdx.x & 31;
  const int heads = a.nq + 2 * a.nkv;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)a.batch * a.t * heads) return;   // the whole warp
  const int head = (int)(row % heads);
  const long long bt = row / heads;                       // b * T + token
  const int kind = head < a.nq ? 0 : (head < a.nq + a.nkv ? 1 : 2);
  const int h = kind == 0 ? head : head - a.nq - (kind == 2 ? a.nkv : 0);
  const int d = a.d, half = d / 2, width = a.width;
  const bool vec = d == 32 * kSlots;            // torch reads vectors of 4
  // element of slot k of lane l: 4l + k, or l + W k (-1: none)
  auto elem = [&](int l, int k) {
    const int e = vec ? 4 * l + k : (l < width ? l + width * k : d);
    return e < d ? e : -1;
  };

  const X* src = static_cast<const X*>(kind == 0 ? a.q
                                       : kind == 1 ? a.k : a.v) +
                 bt * (kind == 0 ? a.q_ts : kind == 1 ? a.k_ts : a.v_ts) +
                 (long long)h * d;
  const X* norm = static_cast<const X*>(kind == 0 ? a.q_norm : a.k_norm);
  float x[kSlots], w[kSlots], c[kSlots], s[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = elem(lane, k);
    x[k] = 0.f, w[k] = c[k] = s[k] = 1.f;
    if (j >= 0) {
      x[k] = to_f32(src[j]);
      if (kind < 2) {
        w[k] = to_f32(norm[j]);
        c[k] = a.cos[bt * d + j];
        s[k] = a.sin[bt * d + j];
      }
    }
  }

  // RMS norm: the sum of squares in torch's order, then rounded to X
  float ss = 0.f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    if (elem(lane, k) >= 0) ss = __fadd_rn(ss, __fmul_rn(x[k], x[k]));
  for (int off = (vec ? 32 : width) / 2; off > 0; off >>= 1)
    ss = __fadd_rn(ss, __shfl_xor_sync(kFull, ss, off));
  ss = __shfl_sync(kFull, ss, 0);               // lanes past W hold none
  const float r = rsqrtf(__fadd_rn(__fmul_rn(ss, a.inv_d), a.eps));
  float y[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k)
    y[k] = round_to<X>(__fmul_rn(__fmul_rn(x[k], r), w[k]));

  // RoPE: element j pairs with j + D/2 (below D/2) or j - D/2, rounded
  // to X; V keeps its input
  float z[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int j = elem(lane, k);
    float other = 0.f;
    if (vec) {                                  // lane l +- 16, slot k
      other = __shfl_xor_sync(kFull, y[k], 16);
    } else {                                    // lane p % W, slot p / W
      const int p = j < 0 ? 0 : (j < half ? j + half : j - half);
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const float got = __shfl_sync(kFull, y[m], p % width);
        if (m == p / width) other = got;
      }
    }
    const float rot = j < half ? -other : other;
    z[k] = kind == 2 ? x[k]
                     : round_to<X>(__fadd_rn(__fmul_rn(y[k], c[k]),
                                             __fmul_rn(rot, s[k])));
  }

  const int b = (int)(bt / a.t);
  const int tok = (int)(bt % a.t);
  if (kind == 0) {
    X* dst = static_cast<X*>(a.q_out) +
             (((long long)b * a.nq + h) * a.t + tok) * d;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (elem(lane, k) >= 0) dst[elem(lane, k)] = from_f32<X>(z[k]);
    return;                                     // no shuffle follows
  }
  const long long p =
      (a.pos != nullptr ? a.pos[a.pos_per_row ? b : 0] : 0) + a.pos_add + tok;
  if (p < 0 || p >= a.s_len) return;            // the whole warp
  const long long key =
      (((long long)a.layer * a.batch + b) * a.nkv + h) * a.s_len + p;
  void* plane = kind == 1 ? a.kc : a.vc;
  if constexpr (kStore == kSame) {
    X* dst = static_cast<X*>(plane) + key * d;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (elem(lane, k) >= 0) dst[elem(lane, k)] = from_f32<X>(z[k]);
  } else if constexpr (kStore == kFp8) {
    uint8_t* dst = static_cast<uint8_t*>(plane) + key * d;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (elem(lane, k) >= 0)
        dst[elem(lane, k)] = (uint8_t)fp8_e4m3fn(z[k]);
  } else {
    // D = 128 (the host checks): lane l holds elements 4l .. 4l + 3, so
    // bytes 2l and 2l + 1 of the packed row
    float amax = 0.f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) amax = fmaxf(amax, fabsf(z[k]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(kFull, amax, off));
    const float scale = fmaxf(__fdiv_rn(amax, 7.f), 1e-8f);
    uint32_t packed = 0;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) packed |= nibble(z[k], scale) << (4 * k);
    *reinterpret_cast<uint16_t*>(static_cast<uint8_t*>(plane) +
                                 key * (d / 2) + 2 * lane) = (uint16_t)packed;
    if (lane == 0)
      (kind == 1 ? a.ks : a.vs)[key] = __float2bfloat16_rn(scale);
  }
}

template <typename X>
int launch(int store, const Args& a, cudaStream_t st) {
  const long long rows = (long long)a.batch * a.t * (a.nq + 2 * a.nkv);
  const unsigned blocks = (unsigned)((rows + kWarps - 1) / kWarps);
  if (store == kSame)
    qk_rope_kv_kernel<X, kSame><<<blocks, kThreads, 0, st>>>(a);
  else if (store == kFp8)
    qk_rope_kv_kernel<X, kFp8><<<blocks, kThreads, 0, st>>>(a);
  else
    qk_rope_kv_kernel<X, kInt4><<<blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16 (q, k, v, q_norm, k_norm, q_out and a
// working-dtype cache). store: 0 = the working dtype, 1 = fp8 e4m3fn, 2 =
// int4 (kc / vc the packed payload planes, ks / vs the bf16 scale planes).
// d: even, at most 128 (int4: 128). pos: a device int64 scalar added to
// pos_add (pos_per_row 0), one int64 a row (pos_per_row 1), or null.
// Returns the launch's cudaError_t.
extern "C" int qk_rope_kv_fwd(
    int x_dtype, int store, const void* q, const void* k, const void* v,
    long long q_ts, long long k_ts, long long v_ts, const void* q_norm,
    const void* k_norm, const void* cos, const void* sin, void* q_out,
    void* kc, void* vc, void* ks, void* vs, const void* pos,
    long long pos_add, int pos_per_row, float eps, int layer, int batch,
    int t, int nq, int nkv, int s_len, int d, void* stream) {
  if ((x_dtype != 0 && x_dtype != 1) || store < kSame || store > kInt4 ||
      d <= 0 || d % 2 != 0 || d > 32 * kSlots || batch <= 0 || t <= 0 ||
      nq <= 0 || nkv <= 0 || s_len <= 0 || layer < 0 ||
      (pos_per_row && pos == nullptr) ||
      (store == kInt4 && (d != 32 * kSlots || ks == nullptr ||
                          vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  int width = 1;
  while (2 * width <= d && width < 32) width *= 2;
  Args a{q, k, v, q_ts, k_ts, v_ts, q_norm, k_norm,
         static_cast<const float*>(cos), static_cast<const float*>(sin),
         q_out, kc, vc, static_cast<__nv_bfloat16*>(ks),
         static_cast<__nv_bfloat16*>(vs),
         static_cast<const long long*>(pos), pos_add, pos_per_row ? 1 : 0,
         eps, 1.0f / (float)d, layer, batch, t, nq, nkv, s_len, d, width};
  auto st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0 ? launch<float>(store, a, st)
                      : launch<__nv_bfloat16>(store, a, st);
}
