// Batch-major decode attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel qwen3_asr_tpu/ops/decode_attention_batch.py
// `_kernel` (public `decode_attention_batched`): one query token per row
// against one layer of the stacked cache [L, B, Nkv, S, 128], read at
// `layer` through a pointer offset (no copy), over the keys in
// [valid_from, valid_to). It keeps that kernel's rounding points:
//
//   qs = bf16(q * scale); K and V widened to bf16 (fp8, bf16) or rounded
//   to bf16 (f32); s = qs . k in f32; p = exp(s - m) in f32 for live keys
//   and 0 for dead ones (the finite MASK_VALUE never leaks into l);
//   l = sum p in f32; acc = sum bf16(p) * v in f32; out = acc / l, and 0
//   for a row with no live key.
//
// What it leaves behind: the TPU kernel packs rows and heads into one
// 128x128 MXU matmul with an iota mask (>= 64x redundant FLOPs), which
// exists only to fill the TPU's matrix unit. Here each block does only the
// dot products it needs, on the CUDA cores.
//
// What bounds it: the bytes of the live cache, 2 * B * Nkv * live * 128 *
// itemsize per layer (fp8 halves them against bf16); the arithmetic is
// about G = Nq / Nkv multiply-adds per byte. The TPU kernel's sequential
// S axis (a running softmax carried across grid steps) becomes a split and
// a combine: kernel 1 runs one block per (128-key block j, KV head, row),
// 384 blocks at B=8 and S=768 where csrc/decode_attention.cu has 64 (and 8
// at B=1, the latency-bound shape PERF.md measured). Each block stages its
// K and V tiles in shared memory with 16-byte loads of the live rows only,
// widens them there (nothing widened ever goes back to device memory), and
// writes the block's partial m, l and acc for its G query heads into f32
// scratch that the wrapper allocates. Blocks wholly outside
// [valid_from, valid_to) exit at once. Kernel 2 combines the partials of
// the live blocks by m and l and writes the output.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kD = 128;                 // head dim (the TPU kernel's too)
constexpr int kBlockS = 128;            // keys per block
constexpr int kThreads = 128;           // one thread per key, then per dim
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;                // query heads per KV head
constexpr int kStride = kD + 2;         // bf16 row stride in shared memory:
                                        // 65 words, so rows hit distinct banks
constexpr int kBatchLoads = 8;          // 16-byte loads in flight per tile
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;
static_assert(kThreads == kBlockS && kThreads == kD,
              "thread t takes key t, then head dim t");

struct Fp8E4M3 { uint8_t bits; };       // torch.float8_e4m3fn storage

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Widen one 16-byte chunk of cache values into bf16 pairs at `dst`.
template <typename KV> struct Widen;
template <> struct Widen<float> {
  static constexpr int kPerChunk = 4;
  __device__ static void run(const uint4& raw, __nv_bfloat162* dst) {
    dst[0] = __floats2bfloat162_rn(__uint_as_float(raw.x),
                                   __uint_as_float(raw.y));
    dst[1] = __floats2bfloat162_rn(__uint_as_float(raw.z),
                                   __uint_as_float(raw.w));
  }
};
template <> struct Widen<__nv_bfloat16> {
  static constexpr int kPerChunk = 8;
  __device__ static void run(const uint4& raw, __nv_bfloat162* dst) {
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      dst[i] = *reinterpret_cast<const __nv_bfloat162*>(&w[i]);
  }
};
template <> struct Widen<Fp8E4M3> {
  static constexpr int kPerChunk = 16;
  // Four e4m3 values; e4m3 -> f16 is exact, and so is f16 -> bf16 for
  // e4m3's values.
  __device__ static void word(uint32_t w, __nv_bfloat162* dst) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const __half2_raw hr = __nv_cvt_fp8x2_to_halfraw2(
          (__nv_fp8x2_storage_t)(w >> (16 * half)), __NV_E4M3);
      dst[half] = __float22bfloat162_rn(__half22float2(__half2(hr)));
    }
  }
  __device__ static void run(const uint4& raw, __nv_bfloat162* dst) {
    word(raw.x, dst);
    word(raw.y, dst + 2);
    word(raw.z, dst + 4);
    word(raw.w, dst + 6);
  }
};

// Stage the live rows of one [kBlockS, kD] tile into shared memory as bf16;
// dead rows become zeros. Chunk i of the tile is row i / kChunksPerRow.
template <typename KV>
__device__ __forceinline__ void stage_tiles(const KV* __restrict__ kg,
                                            const KV* __restrict__ vg,
                                            __nv_bfloat16* ks,
                                            __nv_bfloat16* vs, int row_lo,
                                            int row_hi) {
  constexpr int kPer = Widen<KV>::kPerChunk;
  constexpr int kChunksPerRow = kD / kPer;
  constexpr int kChunks = kBlockS * kChunksPerRow;
  const uint4* k4 = reinterpret_cast<const uint4*>(kg);
  const uint4* v4 = reinterpret_cast<const uint4*>(vg);
  for (int base = 0; base < kChunks; base += kThreads * kBatchLoads) {
    uint4 kr[kBatchLoads], vr[kBatchLoads];
#pragma unroll
    for (int u = 0; u < kBatchLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      const int row = i / kChunksPerRow;
      const bool live = i < kChunks && row >= row_lo && row < row_hi;
      kr[u] = live ? __ldg(k4 + i) : make_uint4(0, 0, 0, 0);
      vr[u] = live ? __ldg(v4 + i) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kBatchLoads; ++u) {
      const int i = base + u * kThreads + threadIdx.x;
      if (i < kChunks) {
        const int row = i / kChunksPerRow, col = (i % kChunksPerRow) * kPer;
        Widen<KV>::run(kr[u], reinterpret_cast<__nv_bfloat162*>(
                                  ks + row * kStride + col));
        Widen<KV>::run(vr[u], reinterpret_cast<__nv_bfloat162*>(
                                  vs + row * kStride + col));
      }
    }
  }
}

constexpr size_t kSmemBytes =
    2 * kBlockS * kStride * sizeof(__nv_bfloat16)   // K and V tiles
    + 2 * kMaxG * kBlockS * sizeof(float)           // qs and bf16(p)
    + 2 * kMaxG * kWarps * sizeof(float);           // cross-warp max, sum

// Kernel 1: grid (S / kBlockS, Nkv, B). Partials are indexed
// ((b * nkv + h) * n_blk + j) * group + g.
template <typename Q, typename KV>
__global__ void __launch_bounds__(kThreads)
partial_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
               const KV* __restrict__ v, const int* __restrict__ valid_from,
               const int* __restrict__ valid_to, float* __restrict__ m_out,
               float* __restrict__ l_out, float* __restrict__ acc_out,
               int layer, int batch, int nq, int nkv, int s_len,
               float sm_scale) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_blk = gridDim.x;
  const int group = nq / nkv;
  const int c0 = j * kBlockS;
  const int lo = max(max(valid_from[b], 0), c0);
  const int hi = min(min(valid_to[b], s_len), c0 + kBlockS);
  if (lo >= hi) return;           // no live key here: the combine skips it

  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBlockS * kStride;
  float* qs = reinterpret_cast<float*>(vs + kBlockS * kStride);  // [G][kD]
  float* ps = qs + kMaxG * kD;                                   // [G][kBlockS]
  float* red_max = ps + kMaxG * kBlockS;                         // [G][kWarps]
  float* red_sum = red_max + kMaxG * kWarps;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int i = t; i < group * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    qs[g * kD + d] = round_bf16(
        to_f32(q[((size_t)b * nq + h * group + g) * kD + d]) * sm_scale);
  }
  const size_t tile =
      ((((size_t)layer * batch + b) * nkv + h) * s_len + c0) * kD;
  stage_tiles<KV>(k + tile, v + tile, ks, vs, lo - c0, hi - c0);
  __syncthreads();

  // Scores: thread t takes key c0 + t.
  const bool live = c0 + t >= lo && c0 + t < hi;
  float s[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
  const __nv_bfloat162* krow =
      reinterpret_cast<const __nv_bfloat162*>(ks + t * kStride);
  for (int w = 0; w < kD / 2; ++w) {
    const float2 kf = __bfloat1622float2(krow[w]);
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < group) {
        const float2 qf = reinterpret_cast<const float2*>(qs + g * kD)[w];
        s[g] = fmaf(qf.x, kf.x, s[g]);
        s[g] = fmaf(qf.y, kf.y, s[g]);
      }
    }
  }

  // Block-local max and sum per query head, then bf16(p) into shared.
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < group) {
      float x = live ? s[g] : kMaskValue;
      s[g] = x;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
      if (lane == 0) red_max[g * kWarps + warp] = x;
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g < group) {
      float m = red_max[g * kWarps];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_max[g * kWarps + w]);
      const float p = live ? expf(s[g] - m) : 0.f;
      ps[g * kBlockS + t] = round_bf16(p);
      float x = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        x += __shfl_xor_sync(0xffffffffu, x, o);
      if (lane == 0) red_sum[g * kWarps + warp] = x;
      if (t == 0) m_out[((size_t)(b * nkv + h) * n_blk + j) * group + g] = m;
    }
  }
  __syncthreads();

  // acc: thread t takes head dim t, over the live rows only.
  for (int g = 0; g < group; ++g) {
    float acc = 0.f;
    for (int r = lo - c0; r < hi - c0; ++r)
      acc = fmaf(ps[g * kBlockS + r], __bfloat162float(vs[r * kStride + t]),
                 acc);
    const size_t idx = ((size_t)(b * nkv + h) * n_blk + j) * group + g;
    acc_out[idx * kD + t] = acc;
    if (t == 0) {
      float l = 0.f;
      for (int w = 0; w < kWarps; ++w) l += red_sum[g * kWarps + w];
      l_out[idx] = l;
    }
  }
}

// Kernel 2: grid (Nkv, B), thread t = head dim t. Combines the partials of
// the blocks that hold a live key (exactly those kernel 1 did not skip).
template <typename Q>
__global__ void __launch_bounds__(kD)
combine_kernel(const float* __restrict__ m_in, const float* __restrict__ l_in,
               const float* __restrict__ acc_in,
               const int* __restrict__ valid_from,
               const int* __restrict__ valid_to, Q* __restrict__ o, int nq,
               int nkv, int s_len, int n_blk) {
  const int h = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int group = nq / nkv;
  const int lo = max(valid_from[b], 0), hi = min(valid_to[b], s_len);
  const int j0 = lo / kBlockS;
  const int j1 = lo < hi ? (hi + kBlockS - 1) / kBlockS : j0;
  for (int g = 0; g < group; ++g) {
    const size_t base = (size_t)(b * nkv + h) * n_blk;
    float m_all = kMaskValue;
    for (int j = j0; j < j1; ++j)
      m_all = fmaxf(m_all, m_in[(base + j) * group + g]);
    float l_all = 0.f, acc = 0.f;
    for (int j = j0; j < j1; ++j) {
      const size_t idx = (base + j) * group + g;
      const float w = expf(m_in[idx] - m_all);
      l_all = fmaf(l_in[idx], w, l_all);
      acc = fmaf(acc_in[idx * kD + t], w, acc);
    }
    const float l_safe = l_all == 0.f ? 1.f : l_all;
    store(&o[((size_t)b * nq + h * group + g) * kD + t], acc / l_safe);
  }
}

template <typename Q, typename KV>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* vf, const int* vt, float* m, float* l, float* acc,
           int layer, int batch, int nq, int nkv, int s_len, float sm_scale,
           cudaStream_t stream) {
  // Above 48 KB only after opting in; once per instantiation, so no launch
  // (nor a graph capture) repeats it.
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t err = cudaFuncSetAttribute(
        partial_kernel<Q, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBytes);
    if (err != cudaSuccess) return (int)err;
    smem_raised = true;
  }
  const int n_blk = s_len / kBlockS;
  partial_kernel<Q, KV><<<dim3(n_blk, nkv, batch), kThreads, kSmemBytes,
                          stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), vf, vt, m, l, acc, layer, batch, nq, nkv,
      s_len, sm_scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<Q><<<dim3(nkv, batch), kD, 0, stream>>>(
      m, l, acc, vf, vt, static_cast<Q*>(o), nq, nkv, s_len, n_blk);
  return (int)cudaGetLastError();
}

template <typename Q>
int launch_q(int kv_dtype, const void* q, const void* k, const void* v,
             void* o, const int* vf, const int* vt, float* m, float* l,
             float* acc, int layer, int batch, int nq, int nkv, int s_len,
             float sm_scale, cudaStream_t st) {
  if (kv_dtype == 0)
    return launch<Q, float>(q, k, v, o, vf, vt, m, l, acc, layer, batch, nq,
                            nkv, s_len, sm_scale, st);
  if (kv_dtype == 1)
    return launch<Q, __nv_bfloat16>(q, k, v, o, vf, vt, m, l, acc, layer,
                                    batch, nq, nkv, s_len, sm_scale, st);
  if (kv_dtype == 2)
    return launch<Q, Fp8E4M3>(q, k, v, o, vf, vt, m, l, acc, layer, batch,
                              nq, nkv, s_len, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (the output's too). kv_dtype: 0 =
// float32, 1 = bfloat16, 2 = float8_e4m3fn. k/v point at the start of the
// stacked cache [L, B, nkv, s_len, 128] (L = 1 for one layer); `layer`
// selects the layer. m/l: [B, nkv, s_len / 128, nq / nkv] f32 scratch, acc
// the same with 128 more; all three written before they are read. Returns
// the first launch error (cudaError_t), 0 if both launched.
extern "C" int decode_attention_batch_fwd(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    void* o, const void* valid_from, const void* valid_to, void* m, void* l,
    void* acc, int layer, int batch, int nq, int nkv, int s_len, int d,
    float sm_scale, void* stream) {
  if (d != kD || s_len <= 0 || s_len % kBlockS != 0 || nkv <= 0 ||
      nq % nkv != 0 || nq / nkv > kMaxG || layer < 0 || batch <= 0)
    return (int)cudaErrorInvalidValue;
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto* mp = static_cast<float*>(m);
  auto* lp = static_cast<float*>(l);
  auto* ap = static_cast<float*>(acc);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(kv_dtype, q, k, v, o, vf, vt, mp, lp, ap, layer,
                           batch, nq, nkv, s_len, sm_scale, st);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(kv_dtype, q, k, v, o, vf, vt, mp, lp, ap,
                                   layer, batch, nq, nkv, s_len, sm_scale,
                                   st);
  return (int)cudaErrorInvalidValue;
}
