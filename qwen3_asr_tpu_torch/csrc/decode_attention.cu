// Single-token decode attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel qwen3_asr_tpu/ops/decode_attention.py `_kernel`
// (public `decode_attention`). Same function:
//
//   out[g] = softmax(q[g] * scale . k[c]) over c in [valid_from, valid_to),
//   weighted sum of v[c]; an empty range gives 0 (safe divide).
//
// The cache is one layer [B, Nkv, S, D] or the stacked cache
// [L, B, Nkv, S, D] read at `layer` through a pointer offset (no copy).
//
// Design. One block per (KV head, batch row), eight warps. The warps split
// the live key range (warp w takes keys lo + w, lo + w + 8, ...). For each
// key a warp loads the K and V rows with lanes across the head dim
// (coalesced), reduces each of the G query heads' dot products with
// shuffles, and keeps an exact online softmax (m, l, acc) in f32 registers.
// The block then combines the eight partial states in shared memory. Keys
// outside [valid_from, valid_to) are never read.
//
// What bounds it: the bytes of the live cache (2 * live keys * D * dtype
// size per head); at batch 1 there are only Nkv blocks (8 at 1.7B), far
// fewer than the 132 SMs, so this kernel is latency-bound and slow there.
// Splitting S across blocks (flash-decoding) and combining by m/l is a
// later change.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, T* __restrict__ o,
              const int* __restrict__ valid_from,
              const int* __restrict__ valid_to, int layer, int batch, int nq,
              int nkv, int s_len, int d, float sm_scale) {
  __shared__ float m_s[kWarps][kMaxG];
  __shared__ float l_s[kWarps][kMaxG];
  __shared__ float acc_s[kWarps][kMaxG * kMaxD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int group = nq / nkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  float qr[kMaxG][kDPerLane];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int dd = lane + 32 * e;
      qr[g][e] = (g < group && dd < d)
          ? to_f32(q[((size_t)b * nq + h * group + g) * d + dd]) * sm_scale
          : 0.f;
    }
  }

  float m[kMaxG], l[kMaxG], acc[kMaxG][kDPerLane];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kMaskValue;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[g][e] = 0.f;
  }

  const size_t head =
      (((size_t)layer * batch + b) * nkv + h) * (size_t)s_len * d;
  const int lo = max(valid_from[b], 0);
  const int hi = min(valid_to[b], s_len);
  for (int c = lo + warp; c < hi; c += kWarps) {
    float kr[kDPerLane], vr[kDPerLane];
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int dd = lane + 32 * e;
      kr[e] = dd < d ? to_f32(k[head + (size_t)c * d + dd]) : 0.f;
      vr[e] = dd < d ? to_f32(v[head + (size_t)c * d + dd]) : 0.f;
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < group) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) part += qr[g][e] * kr[e];
        const float s = warp_sum(part);
        const float m_new = fmaxf(m[g], s);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(s - m_new);
        l[g] = alpha * l[g] + p;
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e)
          acc[g][e] = acc[g][e] * alpha + p * vr[e];
      }
    }
  }

#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < group) {
      if (lane == 0) {
        m_s[warp][g] = m[g];
        l_s[warp][g] = l[g];
      }
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) {
        const int dd = lane + 32 * e;
        if (dd < d) acc_s[warp][g * kMaxD + dd] = acc[g][e];
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < group * d; i += kThreads) {
    const int g = i / d, dd = i - (i / d) * d;
    float m_all = kMaskValue;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_s[w][g]);
    float l_all = 0.f, o_all = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float scale = expf(m_s[w][g] - m_all);
      l_all += l_s[w][g] * scale;
      o_all += acc_s[w][g * kMaxD + dd] * scale;
    }
    const float l_safe = l_all == 0.f ? 1.f : l_all;
    store(&o[((size_t)b * nq + h * group + g) * d + dd], o_all / l_safe);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* vf, const int* vt, int layer, int batch, int nq,
           int nkv, int s_len, int d, float sm_scale, cudaStream_t stream) {
  const dim3 grid(nkv, batch);
  decode_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), vf, vt, layer, batch, nq,
      nkv, s_len, d, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. k/v point at the start of the cache
// (stacked or not); `layer` selects the layer of a stacked cache (0 for a
// single layer). Returns the launch's cudaError_t.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, void* o,
                                    const void* valid_from,
                                    const void* valid_to, int layer,
                                    int batch, int nq, int nkv, int s_len,
                                    int d, float sm_scale, void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 != 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > kMaxG || layer < 0)
    return (int)cudaErrorInvalidValue;
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, vf, vt, layer, batch, nq, nkv, s_len, d,
                         sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, vf, vt, layer, batch, nq, nkv,
                                 s_len, d, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
