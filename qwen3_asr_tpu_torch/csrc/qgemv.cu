// The weight-only quantized product of decode rows for Hopper (sm_90a),
// written by hand. No TPU kernel: JAX's `qdot` (qwen3_asr_tpu/ops/quant.py)
// runs in XLA. See qwen3_asr_tpu_torch/ops/qgemv.py for the contract:
//
//   out[m, n] = round_out((sum_k bf16 x[m, k] * widen(q[n, k])) * s[n])
//
// with the payload q int8 or e4m3 (widened exactly), the sum in f32, and
// one rounding to the output's dtype (bf16, or f32 for the logits).
//
// What bounds it: the payload's N * K bytes, read once. The design:
// - Block of 8 warps; x ([rows, K] bf16, rows padded to a power of two with
//   zeros) staged in shared memory once per block.
// - Each warp takes `cols` output columns (the wrapper sizes them so the
//   grid has about two blocks an SM). For a column, lane l loads bytes
//   [16 (l + 32 i), +16) of the row, so a warp reads 512 contiguous bytes a
//   step; the 16 values are widened and multiplied into kM f32
//   accumulators against the staged x.
// - A warp reduction per row ends the column; lane m writes row m.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;
constexpr int kMaxSmem = 232448;        // 227 KB, an H100's opt-in maximum

struct Fp8E4M3 { uint8_t bits; };       // torch.float8_e4m3fn storage

// The 16 payload values of one 16-byte load, widened to f32 (exact).
template <typename W> struct Widen;
template <> struct Widen<int8_t> {
  __device__ static void run(const uint4& v, float (&f)[16]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        f[4 * i + b] = (float)(int8_t)(u[i] >> (8 * b));
  }
};
template <> struct Widen<Fp8E4M3> {
  __device__ static void run(const uint4& v, float (&f)[16]) {
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __half2_raw r = __nv_cvt_fp8x2_to_halfraw2(
            (__nv_fp8x2_storage_t)((u[i] >> (16 * h)) & 0xffffu), __NV_E4M3);
        const float2 p = __half22float2(__half2(r));
        f[4 * i + 2 * h] = p.x;
        f[4 * i + 2 * h + 1] = p.y;
      }
  }
};

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// Grid: ceil(n / (kWarps * cols)) blocks. Dynamic shared memory: kM * k
// bf16 values.
template <typename W, int kM>
__global__ void __launch_bounds__(kThreads)
qgemv_kernel(const __nv_bfloat16* __restrict__ x,
             const W* __restrict__ w, const void* __restrict__ s,
             void* __restrict__ o, int s_bf16, int out_bf16, int m, int n,
             int k, int cols) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // x into shared memory, rows m .. kM - 1 zero
  const int vec = k / 8;
  for (int i = tid; i < kM * vec; i += kThreads) {
    const int r = i / vec;
    const uint4 val = r < m ? reinterpret_cast<const uint4*>(x)[i]
                            : make_uint4(0, 0, 0, 0);
    reinterpret_cast<uint4*>(xs)[i] = val;
  }
  __syncthreads();

  const int col0 = (blockIdx.x * kWarps + warp) * cols;
  for (int c = 0; c < cols; ++c) {
    const int col = col0 + c;
    if (col >= n) break;
    const unsigned char* row =
        reinterpret_cast<const unsigned char*>(w) + (size_t)col * k;
    float acc[kM];
#pragma unroll
    for (int r = 0; r < kM; ++r) acc[r] = 0.f;
#pragma unroll 2
    for (int k0 = 16 * lane; k0 < k; k0 += 16 * 32) {
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(row + k0));
      float wf[16];
      Widen<W>::run(raw, wf);
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        const uint4* xp = reinterpret_cast<const uint4*>(xs + r * k + k0);
        const uint4 a = xp[0], b = xp[1];
        const uint32_t xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
        float sum = acc[r];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          sum = fmaf(bf16_lo(xv[e]), wf[2 * e], sum);
          sum = fmaf(bf16_hi(xv[e]), wf[2 * e + 1], sum);
        }
        acc[r] = sum;
      }
    }
#pragma unroll
    for (int r = 0; r < kM; ++r)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
    const float scale =
        s_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(s)[col])
               : static_cast<const float*>(s)[col];
#pragma unroll
    for (int r = 0; r < kM; ++r) {
      if (lane == r && r < m) {
        const float y = acc[r] * scale;
        if (out_bf16)
          static_cast<__nv_bfloat16*>(o)[(size_t)r * n + col] =
              __float2bfloat16(y);
        else
          static_cast<float*>(o)[(size_t)r * n + col] = y;
      }
    }
  }
}

template <typename W, int kM>
int launch(const void* x, const void* w, const void* s, void* o, int s_bf16,
           int out_bf16, int m, int n, int k, int cols, cudaStream_t st) {
  static bool raised[sm90::kMaxDevices] = {};
  const cudaError_t err = sm90::max_smem(qgemv_kernel<W, kM>, kMaxSmem,
                                         raised);
  if (err != cudaSuccess) return (int)err;
  const int per_block = kWarps * cols;
  qgemv_kernel<W, kM><<<(n + per_block - 1) / per_block, kThreads,
                        kM * k * 2, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const W*>(w), s, o,
      s_bf16, out_bf16, m, n, k, cols);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_w(int rows, const void* x, const void* w, const void* s, void* o,
             int s_bf16, int out_bf16, int m, int n, int k, int cols,
             cudaStream_t st) {
  auto* go = rows == 1    ? launch<W, 1>
             : rows == 2  ? launch<W, 2>
             : rows == 4  ? launch<W, 4>
             : rows == 8  ? launch<W, 8>
             : rows == 16 ? launch<W, 16>
                          : nullptr;
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  return go(x, w, s, o, s_bf16, out_bf16, m, n, k, cols, st);
}

}  // namespace

// w_dtype: 0 = int8, 1 = float8_e4m3fn; s_dtype / out_dtype: 0 = float32,
// 1 = bfloat16. x [m, k] bf16, w [n, k], s [n], out [m, n], all
// contiguous; k a multiple of 16, x and w 16-byte aligned; `rows` the
// power of two >= m the kernel is built for (1..16), rows * k * 2 bytes of
// shared memory at most 227 KB; `cols` output columns a warp. Returns the
// launch's cudaError_t.
extern "C" int qgemv_fwd(int w_dtype, int s_dtype, int out_dtype,
                         const void* x, const void* w, const void* s,
                         void* out, int m, int n, int k, int rows, int cols,
                         void* stream) {
  if (m <= 0 || m > rows || rows > kMaxRows || n <= 0 || k <= 0 ||
      k % 16 != 0 || cols <= 0 || (long long)rows * k * 2 > kMaxSmem ||
      s_dtype < 0 || s_dtype > 1 || out_dtype < 0 || out_dtype > 1)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0)
    return launch_w<int8_t>(rows, x, w, s, out, s_dtype, out_dtype, m, n, k,
                            cols, st);
  if (w_dtype == 1)
    return launch_w<Fp8E4M3>(rows, x, w, s, out, s_dtype, out_dtype, m, n,
                             k, cols, st);
  return (int)cudaErrorInvalidValue;
}
