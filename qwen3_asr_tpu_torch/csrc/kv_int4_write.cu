// The int4 KV cache's write for Hopper (sm_90a), written by hand: one
// launch quantizes a layer's new K and V rows, packs them two values a
// byte and stores them, with their scales, at the write position. No TPU
// kernel: JAX's `_kv_quantize` and `dynamic_update_slice`
// (qwen3_asr_tpu/models/decoder.py:132-143, 240-261) run in XLA. See
// qwen3_asr_tpu_torch/ops/kv_int4.py for the contract:
//
//   scale = max(absmax_D(x) / 7, 1e-8) in f32; q = clip(rint(x / scale),
//   -8, 7) with the f32 scale (IEEE division, as XLA's); the scale stored
//   rounded to bf16; byte j of a row = (q[2j] + 8) | (q[2j + 1] + 8) << 4.
//
// One warp per (K or V, row, KV head, new token): lane l holds head dims
// 4l .. 4l + 3 (D = 128), so the row's max is one warp reduction and the
// lane's two packed bytes are one 2-byte store; a warp writes the row's 64
// bytes at once. The position is `*pos + pos_add` when `pos` is a device
// pointer (a decode step: a CUDA graph replays it at a new position with
// no host integer) and `pos_add` alone otherwise; a key at or past S is
// not written.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t nibble(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -8.f), 7.f);
  return (uint32_t)((int)r + 8);
}

// k_new / v_new: [batch, nkv, t, 128]; kq / vq: [L, batch, nkv, s_len, 64]
// uint8; ks / vs: [L, batch, nkv, s_len] bf16.
template <typename X>
__global__ void __launch_bounds__(kThreads)
kv_int4_write_kernel(const X* __restrict__ k_new,
                     const X* __restrict__ v_new, uint8_t* __restrict__ kq,
                     uint8_t* __restrict__ vq, __nv_bfloat16* __restrict__ ks,
                     __nv_bfloat16* __restrict__ vs,
                     const long long* __restrict__ pos, int pos_add,
                     int layer, int batch, int nkv, int t, int s_len) {
  const int lane = threadIdx.x & 31;
  const long long rows = (long long)batch * nkv * t;
  const long long g = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= 2 * rows) return;
  const bool is_v = g >= rows;
  const long long r = is_v ? g - rows : g;       // (b * nkv + h) * t + tok
  const int tok = (int)(r % t);
  const long long bh = r / t;
  const long long p = (pos != nullptr ? *pos : 0) + pos_add + tok;
  if (p < 0 || p >= s_len) return;

  const X* src = (is_v ? v_new : k_new) + r * kD + 4 * lane;
  float x[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) x[e] = to_f32(src[e]);
  float amax = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])),
                     fmaxf(fabsf(x[2]), fabsf(x[3])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float scale = fmaxf(__fdiv_rn(amax, 7.f), 1e-8f);
  const uint32_t packed = nibble(x[0], scale) | nibble(x[1], scale) << 4 |
                          nibble(x[2], scale) << 8 | nibble(x[3], scale) << 12;
  const size_t dst = ((size_t)layer * batch * nkv + bh) * s_len + p;
  uint8_t* q = is_v ? vq : kq;
  *reinterpret_cast<uint16_t*>(q + dst * (kD / 2) + 2 * lane) =
      (uint16_t)packed;
  if (lane == 0) (is_v ? vs : ks)[dst] = __float2bfloat16_rn(scale);
}

template <typename X>
int launch(const void* k_new, const void* v_new, void* kq, void* vq,
           void* ks, void* vs, const void* pos, int pos_add, int layer,
           int batch, int nkv, int t, int s_len, cudaStream_t st) {
  const long long warps = 2LL * batch * nkv * t;
  kv_int4_write_kernel<X><<<(unsigned)((warps + kWarps - 1) / kWarps),
                            kThreads, 0, st>>>(
      static_cast<const X*>(k_new), static_cast<const X*>(v_new),
      static_cast<uint8_t*>(kq), static_cast<uint8_t*>(vq),
      static_cast<__nv_bfloat16*>(ks), static_cast<__nv_bfloat16*>(vs),
      static_cast<const long long*>(pos), pos_add, layer, batch, nkv, t,
      s_len);
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16 (k_new and v_new, contiguous
// [batch, nkv, t, 128]). kq/vq: the payload planes [L, batch, nkv, s_len,
// 64] uint8; ks/vs: the scale planes [L, batch, nkv, s_len, 1] bf16. pos: a
// device int64 scalar added to pos_add, or null. Returns the launch's
// cudaError_t.
extern "C" int kv_int4_write_fwd(int x_dtype, const void* k_new,
                                 const void* v_new, void* kq, void* vq,
                                 void* ks, void* vs, const void* pos,
                                 int pos_add, int layer, int batch, int nkv,
                                 int t, int s_len, int d, void* stream) {
  if (d != kD || batch <= 0 || nkv <= 0 || t <= 0 || s_len <= 0 ||
      layer < 0)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return launch<float>(k_new, v_new, kq, vq, ks, vs, pos, pos_add, layer,
                         batch, nkv, t, s_len, st);
  if (x_dtype == 1)
    return launch<__nv_bfloat16>(k_new, v_new, kq, vq, ks, vs, pos, pos_add,
                                 layer, batch, nkv, t, s_len, st);
  return (int)cudaErrorInvalidValue;
}
