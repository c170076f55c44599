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
// Two routes, chosen by the wrapper (ops/qk_rope_kv.py `bwd_route`) and
// counted apart: the vector route below (16-byte pieces, every head of a
// token a block) where the head dim splits over a power of two lanes, and
// the row route for other head dims (trained_ckpt's 48, trained_draft's
// 24): one warp a row, lane l holding elements l, l + 32, l + 64,
// l + 96 (D <= 128); the two means are butterflies and the rotation
// partner (j +- D/2) is found by a loop of shuffles. Its weight gradient
// is a reduction over B * T * heads rows: a fixed grid of blocks walks the
// rows in a fixed order (warp w of block i takes rows i * 8 + w, then a
// grid-stride on), each warp keeps its sums in registers, the block adds
// its 8 warps in order into a partial [2][D] in device memory, and a
// second launch of one block adds the partials in order. No atomics, so a
// repeat call gives the same bits.
//
// What bounds it on the H100: it moves each of x, g and dx once (41 MB a
// layer at the training rows, 12.2 us at 3.35 TB/s) and does ~20 flops an
// element, so it is bound by bytes: the vector route moves them in
// 16-byte pieces and reads cos/sin once a token.

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


// ---------------------------------------------------------------------------
// The vector route: head dims that split into 16-byte pieces over a power
// of two lanes (D = L * V with V = 16 / sizeof(X) elements a lane and L in
// 2..32: bf16 at D 16..256 step powers, f32 at 8..128). A block of 256
// threads takes every head of a run of whole tokens (`per_block` of them),
// so a token's cos and sin rows come from device memory once and its 24
// heads read them from L1; its threads form groups of L lanes, one row of
// the token (a q, k or v head) a group at a time. Lane `sub` of a group
// owns elements sub * V .. sub * V + V - 1 and moves them as one 16-byte
// load or store; RoPE's partner (j +- D/2) sits in lane sub ^ L/2, one
// shuffle away; the two means are butterflies over the group's lanes; v's
// rows are 16-byte copies. Each thread keeps its elements' weight-gradient
// sums in registers over its rows, the block adds its groups in order into
// a partial [2][D], and a second launch of 2 D / 32 blocks of 32 warps
// adds the partials in a fixed order (norm_grad_sum_kernel). No atomics.

constexpr int kVecThreads = 256;

template <typename X>
struct Vec;   // 16 bytes of X
template <>
struct Vec<float> {
  static constexpr int n = 4;
  __device__ static void load(const float* p, float (&o)[4]) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  __device__ static void store(float* p, const float (&o)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};
template <>
struct Vec<__nv_bfloat16> {
  static constexpr int n = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&o)[8]) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float (&o)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
      w[i] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <int kL>
__device__ __forceinline__ float group_sum(float x, unsigned mask) {
#pragma unroll
  for (int o = kL / 2; o > 0; o >>= 1) x += __shfl_xor_sync(mask, x, o);
  return x;
}

template <typename X, int kL>
__global__ void __launch_bounds__(kVecThreads)
qk_rope_bwd_vec_kernel(Args a, int per_block) {
  constexpr int kV = Vec<X>::n;
  constexpr int kD = kL * kV;
  constexpr int kGroups = kVecThreads / kL;
  __shared__ float grp_dw[kGroups][2][kD];
  const int tid = threadIdx.x, grp = tid / kL, sub = tid % kL;
  const int lane = tid & 31;
  const unsigned mask = kL == 32 ? kFull
                                 : (((1u << kL) - 1u) << (lane & ~(kL - 1)));
  const int heads = a.nq + 2 * a.nkv;
  const long long tokens = (long long)a.batch * a.t;
  const long long tok0 = (long long)blockIdx.x * per_block;
  const long long tok1 =
      tok0 + per_block < tokens ? tok0 + per_block : tokens;
  const int rows = (int)(tok1 - tok0) * heads;
  const int col = sub * kV;
  const bool low = sub < kL / 2;   // this lane's elements lie below D/2

  float wq[kV], wk[kV], dwq[kV], dwk[kV];
  Vec<X>::load(static_cast<const X*>(a.q_norm) + col, wq);
  Vec<X>::load(static_cast<const X*>(a.k_norm) + col, wk);
#pragma unroll
  for (int e = 0; e < kV; ++e) dwq[e] = dwk[e] = 0.f;

  for (int idx = grp; idx < rows; idx += kGroups) {
    const long long tok = tok0 + idx / heads;
    const int head = idx % heads;
    const int b = (int)(tok / a.t), tk = (int)(tok % a.t);
    const int kind = head < a.nq ? 0 : (head < a.nq + a.nkv ? 1 : 2);
    const int h = kind == 0 ? head : head - a.nq - (kind == 2 ? a.nkv : 0);
    const int n_heads = kind == 0 ? a.nq : a.nkv;
    const long long g_at = (((long long)b * n_heads + h) * a.t + tk) * kD;
    const long long x_at = tok * (long long)n_heads * kD + (long long)h * kD;
    const X* g_src = static_cast<const X*>(kind == 0 ? a.gq
                                           : kind == 1 ? a.gk : a.gv) + g_at;
    X* dst = static_cast<X*>(kind == 0 ? a.dq : kind == 1 ? a.dk : a.dv) +
             x_at;
    if (kind == 2) {                              // v: the cotangent as is
      *reinterpret_cast<uint4*>(dst + col) =
          *reinterpret_cast<const uint4*>(g_src + col);
      continue;
    }
    const X* x_src = static_cast<const X*>(kind == 0 ? a.q : a.k) + x_at;
    float x[kV], g[kV], c[kV], sn[kV];
    Vec<X>::load(x_src + col, x);
    Vec<X>::load(g_src + col, g);
#pragma unroll
    for (int e = 0; e < kV; e += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(a.cos + tok * kD +
                                                         col + e);
      const float4 sv = *reinterpret_cast<const float4*>(a.sin + tok * kD +
                                                         col + e);
      c[e] = cv.x; c[e + 1] = cv.y; c[e + 2] = cv.z; c[e + 3] = cv.w;
      sn[e] = sv.x; sn[e + 1] = sv.y; sn[e + 2] = sv.z; sn[e + 3] = sv.w;
    }
    // RoPE's transpose: below D/2 take +u of the partner, above -u
    float dy[kV], ss = 0.f;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      const float u = __shfl_xor_sync(mask, g[e] * sn[e], kL / 2);
      dy[e] = round_to<X>(g[e] * c[e] + (low ? u : -u));
      ss += x[e] * x[e];
    }
    const float r = rsqrtf(group_sum<kL>(ss, mask) * a.inv_d + a.eps);
    float n[kV], dn[kV], dot = 0.f;
#pragma unroll
    for (int e = 0; e < kV; ++e) {
      n[e] = x[e] * r;
      dn[e] = dy[e] * (kind == 0 ? wq[e] : wk[e]);
      dot += dn[e] * n[e];
      if (kind == 0) dwq[e] += dy[e] * n[e];
      else dwk[e] += dy[e] * n[e];
    }
    const float mean_dn_n = group_sum<kL>(dot, mask) * a.inv_d;
    float out[kV];
#pragma unroll
    for (int e = 0; e < kV; ++e) out[e] = r * (dn[e] - n[e] * mean_dn_n);
    Vec<X>::store(dst + col, out);
  }

#pragma unroll
  for (int e = 0; e < kV; ++e) {
    grp_dw[grp][0][col + e] = dwq[e];
    grp_dw[grp][1][col + e] = dwk[e];
  }
  __syncthreads();
  for (int i = tid; i < 2 * kD; i += kVecThreads) {
    const int which = i / kD, j = i - which * kD;
    float sum = 0.f;
    for (int v = 0; v < kGroups; ++v) sum += grp_dw[v][which][j];
    a.partial[((long long)blockIdx.x * 2 + which) * kD + j] = sum;
  }
}

// dw[i] = the sum of column i over the `blocks` partials, in a fixed
// order; one block of 32 warps a run of 32 columns of the [blocks][2 d]
// partials: lane j of warp w sums partials w, w + 32, ... of column j
// into four sums taken in turn (four loads in flight), adds them in
// order, and warp 0 adds the 32 warps' in order.
constexpr int kSumWarps = 32;

template <typename X>
__global__ void __launch_bounds__(kSumWarps * 32)
norm_grad_sum_kernel(const float* __restrict__ partial, int blocks, int d,
                     X* __restrict__ dq_norm, X* __restrict__ dk_norm) {
  __shared__ float warp_sum_s[kSumWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (i < 2 * d)
    for (int blk = warp; blk < blocks; blk += 4 * kSumWarps) {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int at = blk + u * kSumWarps;
        if (at < blocks) acc[u] += partial[(long long)at * 2 * d + i];
      }
    }
  warp_sum_s[warp][lane] = ((acc[0] + acc[1]) + acc[2]) + acc[3];
  __syncthreads();
  if (warp == 0 && i < 2 * d) {
    float total = 0.f;
    for (int w = 0; w < kSumWarps; ++w) total += warp_sum_s[w][lane];
    (i < d ? dq_norm : dk_norm)[i < d ? i : i - d] = from_f32<X>(total);
  }
}

template <typename X, int kL>
int launch_vec(const Args& a, int per_block, int blocks, void* dq_norm,
               void* dk_norm, cudaStream_t st) {
  qk_rope_bwd_vec_kernel<X, kL><<<blocks, kVecThreads, 0, st>>>(a, per_block);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  norm_grad_sum_kernel<X><<<(2 * a.d + 31) / 32, kSumWarps * 32, 0, st>>>(
      a.partial, blocks, a.d, static_cast<X*>(dq_norm),
      static_cast<X*>(dk_norm));
  return (int)cudaGetLastError();
}

template <typename X>
int dispatch_vec(const Args& a, int per_block, int blocks, void* dq_norm,
                 void* dk_norm, cudaStream_t st) {
  switch (a.d / Vec<X>::n) {
    case 2: return launch_vec<X, 2>(a, per_block, blocks, dq_norm, dk_norm, st);
    case 4: return launch_vec<X, 4>(a, per_block, blocks, dq_norm, dk_norm, st);
    case 8: return launch_vec<X, 8>(a, per_block, blocks, dq_norm, dk_norm, st);
    case 16:
      return launch_vec<X, 16>(a, per_block, blocks, dq_norm, dk_norm, st);
    case 32:
      return launch_vec<X, 32>(a, per_block, blocks, dq_norm, dk_norm, st);
  }
  return (int)cudaErrorInvalidValue;
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

// The vector route: as qk_rope_bwd, for d = L * (16 / element size) with L
// a power of two from 2 to 32 and every pointer 16-byte aligned; the first
// launch takes `per_block` whole tokens a block over `blocks` blocks
// (blocks * per_block >= batch * t), `partial` is [blocks, 2, d] f32.
extern "C" int qk_rope_bwd_vec(int x_dtype, const void* q, const void* k,
                               const void* q_norm, const void* k_norm,
                               const void* cos, const void* sin,
                               const void* gq, const void* gk, const void* gv,
                               void* dq, void* dk, void* dv, void* partial,
                               void* dq_norm, void* dk_norm, float eps,
                               int batch, int t, int nq, int nkv, int d,
                               int per_block, int blocks, void* stream) {
  const int v = x_dtype == 0 ? 4 : 8;
  if ((x_dtype != 0 && x_dtype != 1) || d <= 0 || d % v != 0 ||
      batch <= 0 || t <= 0 || nq <= 0 || nkv <= 0 || per_block <= 0 ||
      blocks <= 0 || (long long)per_block * blocks < (long long)batch * t)
    return (int)cudaErrorInvalidValue;
  Args a{q, k, q_norm, k_norm, static_cast<const float*>(cos),
         static_cast<const float*>(sin), gq, gk, gv, dq, dk, dv,
         static_cast<float*>(partial), eps, 1.0f / (float)d, batch, t, nq,
         nkv, d};
  auto st = static_cast<cudaStream_t>(stream);
  return x_dtype == 0
             ? dispatch_vec<float>(a, per_block, blocks, dq_norm, dk_norm, st)
             : dispatch_vec<__nv_bfloat16>(a, per_block, blocks, dq_norm,
                                           dk_norm, st);
}
