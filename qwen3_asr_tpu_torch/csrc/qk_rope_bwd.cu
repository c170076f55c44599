// The backward of QK-norm + RoPE (csrc/qk_rope_kv.cu's forward on q and k)
// for Hopper (sm_90a), written by hand.
//
// No TPU kernel: the JAX decoder's rms_norm and apply_rope
// (qwen3_asr_tpu/models/decoder.py:146-170) are differentiated by XLA
// inside the training step. This kernel computes that gradient, per
// (token, head) row x of q or k, with w the head's norm weight:
//
//   forward:  r = rsqrt(mean(x^2) + eps), n = x r, y = X(n w),
//             z = X(y cos + R(y) sin),  R[y1; y2] = [-y2; y1]
//   backward: dy = X(g cos + R^T(g sin)),  R^T[u1; u2] = [u2; -u1]
//             (rounded to the input dtype X where JAX's autodiff rounds
//             it: the gradient of y's astype)
//             dn = dy w,  dx = X(r (dn - n mean(dn n))),
//             dw = sum over every row of the layer of dy n
// all in f32 from the saved x; v's rows pass their cotangent through,
// transposed back to the projections' [B, T, heads * D] layout.
//
// Design: one warp a row, lane l holding elements l, l + 32, l + 64,
// l + 96 (D <= 128); the two means are butterflies and the rotation
// partner (j +- D/2) is a shuffle away. The weight gradient is a
// reduction over B * T * heads rows: a fixed grid of blocks walks the
// rows in a fixed order (warp w of block i takes rows i * 8 + w, then a
// grid-stride on), each warp keeps its sums in registers, the block adds
// its 8 warps in order into a partial [2][D] in device memory, and a
// second launch of one block adds the partials in order. No atomics, so a
// repeat call gives the same bits.
//
// What bounds it on the H100: it moves each of x, g and dx once (a few MB
// a layer at the training shapes) and does ~20 flops an element, so it is
// bound by bytes; the time at these sizes is mostly launch and latency.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSlots = 4;                      // elements a lane: D <= 128
constexpr int kMaxD = 32 * kSlots;
constexpr unsigned kFull = 0xffffffffu;

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
template <typename X> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<X>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Args {
  const void* q;             // [B, T, nq * D] forward inputs, contiguous
  const void* k;             // [B, T, nkv * D]
  const void* q_norm;        // [D]
  const void* k_norm;
  const float* cos;          // [B, T, D]
  const float* sin;
  const void* gq;            // [B, nq, T, D] cotangents of the outputs
  const void* gk;            // [B, nkv, T, D]
  const void* gv;            // [B, nkv, T, D]
  void* dq;                  // [B, T, nq * D]
  void* dk;                  // [B, T, nkv * D]
  void* dv;                  // [B, T, nkv * D]
  float* partial;            // [gridDim.x][2][D]
  float eps, inv_d;
  int batch, t, nq, nkv, d;
};

template <typename X>
__global__ void __launch_bounds__(kThreads) qk_rope_bwd_kernel(Args a) {
  __shared__ float warp_dw[kWarps][2][kMaxD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int heads = a.nq + 2 * a.nkv;
  const int d = a.d, half = d / 2;
  const long long rows = (long long)a.batch * a.t * heads;
  float dwq[kSlots] = {0.f, 0.f, 0.f, 0.f}, dwk[kSlots] = {0.f, 0.f, 0.f, 0.f};

  for (long long row = (long long)blockIdx.x * kWarps + warp; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const int head = (int)(row % heads);
    const long long bt = row / heads;                    // b * T + token
    const int b = (int)(bt / a.t), tok = (int)(bt % a.t);
    const int kind = head < a.nq ? 0 : (head < a.nq + a.nkv ? 1 : 2);
    const int h = kind == 0 ? head : head - a.nq - (kind == 2 ? a.nkv : 0);
    const int n_heads = kind == 0 ? a.nq : a.nkv;
    const long long g_at = (((long long)b * n_heads + h) * a.t + tok) * d;
    const long long x_at = bt * (long long)n_heads * d + (long long)h * d;
    const X* g_src = static_cast<const X*>(kind == 0 ? a.gq
                                           : kind == 1 ? a.gk : a.gv) + g_at;
    X* dst = static_cast<X*>(kind == 0 ? a.dq : kind == 1 ? a.dk : a.dv) +
             x_at;
    if (kind == 2) {                              // v: the cotangent as is
      for (int j = lane; j < d; j += 32) dst[j] = g_src[j];
      continue;
    }
    const X* x_src = static_cast<const X*>(kind == 0 ? a.q : a.k) + x_at;
    const X* norm = static_cast<const X*>(kind == 0 ? a.q_norm : a.k_norm);
    float x[kSlots], g[kSlots], w[kSlots], c[kSlots], s[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + 32 * k;
      const bool in = j < d;
      x[k] = in ? to_f32(x_src[j]) : 0.f;
      g[k] = in ? to_f32(g_src[j]) : 0.f;
      w[k] = in ? to_f32(norm[j]) : 0.f;
      c[k] = in ? a.cos[bt * d + j] : 0.f;
      s[k] = in ? a.sin[bt * d + j] : 0.f;
    }
    // RoPE's transpose: partner of element j is j + D/2 below D/2 (taking
    // +u), j - D/2 above (taking -u), with u = g sin
    float dy[kSlots];
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + 32 * k;
      const int p = j < d ? (j < half ? j + half : j - half) : 0;
      float other = 0.f;
#pragma unroll
      for (int m = 0; m < kSlots; ++m) {
        const float u = __shfl_sync(kFull, g[m] * s[m], p % 32);
        if (m == p / 32) other = u;
      }
      dy[k] = j < d ? round_to<X>(g[k] * c[k] + (j < half ? other : -other))
                    : 0.f;
    }
    // RMS norm's backward from the saved x
    float ss = 0.f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) ss += x[k] * x[k];
    const float r = rsqrtf(warp_sum(ss) * a.inv_d + a.eps);
    float n[kSlots], dn[kSlots], dot = 0.f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      n[k] = x[k] * r;
      dn[k] = dy[k] * w[k];
      dot += dn[k] * n[k];
      if (kind == 0) dwq[k] += dy[k] * n[k];
      else dwk[k] += dy[k] * n[k];
    }
    const float mean_dn_n = warp_sum(dot) * a.inv_d;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int j = lane + 32 * k;
      if (j < d) dst[j] = from_f32<X>(r * (dn[k] - n[k] * mean_dn_n));
    }
  }

#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    warp_dw[warp][0][lane + 32 * k] = dwq[k];
    warp_dw[warp][1][lane + 32 * k] = dwk[k];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * d; i += kThreads) {
    const int which = i / d, j = i - which * d;
    float sum = 0.f;
    for (int v = 0; v < kWarps; ++v) sum += warp_dw[v][which][j];
    a.partial[((long long)blockIdx.x * 2 + which) * d + j] = sum;
  }
}

// one block: dw[which][j] = sum over the partials of the blocks, in order
template <typename X>
__global__ void __launch_bounds__(kThreads)
norm_grad_kernel(const float* __restrict__ partial, int blocks, int d,
                 X* __restrict__ dq_norm, X* __restrict__ dk_norm) {
  for (int i = threadIdx.x; i < 2 * d; i += kThreads) {
    float sum = 0.f;
    for (int blk = 0; blk < blocks; ++blk) sum += partial[(long long)blk * 2 * d + i];
    (i < d ? dq_norm : dk_norm)[i < d ? i : i - d] = from_f32<X>(sum);
  }
}

template <typename X>
int launch(const Args& a, int blocks, void* dq_norm, void* dk_norm,
           cudaStream_t st) {
  qk_rope_bwd_kernel<X><<<blocks, kThreads, 0, st>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_grad_kernel<X><<<1, kThreads, 0, st>>>(
      a.partial, blocks, a.d, static_cast<X*>(dq_norm),
      static_cast<X*>(dk_norm));
  return (int)cudaGetLastError();
}

}  // namespace

// x_dtype: 0 = float32, 1 = bfloat16 (q, k, the norms, the cotangents and
// every gradient). d: even, at most 128. blocks: the first launch's grid,
// which `partial` ([blocks, 2, d] f32 scratch) must hold. Two launches on
// `stream`. Returns the first launch error (cudaError_t), 0 on success.
extern "C" int qk_rope_bwd(int x_dtype, const void* q, const void* k,
                           const void* q_norm, const void* k_norm,
                           const void* cos, const void* sin, const void* gq,
                           const void* gk, const void* gv, void* dq, void* dk,
                           void* dv, void* partial, void* dq_norm,
                           void* dk_norm, float eps, int batch, int t, int nq,
                           int nkv, int d, int blocks, void* stream) {
  if ((x_dtype != 0 && x_dtype != 1) || d <= 0 || d % 2 != 0 || d > kMaxD ||
      batch <= 0 || t <= 0 || nq <= 0 || nkv <= 0 || blocks <= 0)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, q_norm, k_norm, static_cast<const float*>(cos),
         static_cast<const float*>(sin), gq, gk, gv, dq, dk, dv,
         static_cast<float*>(partial), eps, 1.0f / (float)d, batch, t, nq,
         nkv, d};
  auto st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? launch<float>(a, blocks, dq_norm, dk_norm, st)
             : launch<__nv_bfloat16>(a, blocks, dq_norm, dk_norm, st);
}
