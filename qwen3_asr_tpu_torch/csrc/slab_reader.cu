// KV slab-read probe for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel tools_perf/attn_phase.py `_slab_kernel` (built by
// `make_slab_reader`): a read-rate probe of one layer of the stacked cache
// [L, B, Nkv, S, D], streamed in batch-major slabs. Its output is exactly
// that kernel's:
//
//   o[b, :] = sum over j of (k[b, 0, j*bs, :] + v[b, 0, j*bs, :] + seed)
//
// in f32, summed in order of j, for the slabs j = 0 .. S/bs - 1.
//
// Reading every byte. On the TPU the auto-pipeline copies whole blocks into
// VMEM whatever the kernel body touches, so the sliver sum reads the whole
// cache. A GPU thread loads only what it asks for, so here every thread
// loads its share of the slab with 16-byte loads and folds every loaded
// word into an XOR. If that XOR equals `sentinel`, a value the caller
// passes at run time, the thread writes it to `sink`. The compiler cannot
// know the sentinel, so it must keep every load; a chance match costs one
// store to a scratch word and changes no output.
//
// What bounds it: bytes only, 2 * B * Nkv * S * D * itemsize per layer over
// the card's 3.35 TB/s; it does no arithmetic worth counting. Kernel 1 runs
// one block per (slab j, KV head, row), each streaming a contiguous
// [bs, D] run of K and of V. On a GPU blocks carry no sums across the grid,
// so the head-0 blocks write their sliver term to f32 scratch and kernel 2
// sums the terms over j in order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

__device__ __forceinline__ float value(const uint8_t* p, size_t i) {
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(p[i], __NV_E4M3);
  return __half2float(__half(hr));
}
__device__ __forceinline__ float value(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const T* __restrict__ k, const T* __restrict__ v,
            float* __restrict__ terms, unsigned* __restrict__ sink,
            unsigned sentinel, int layer, int batch, int nkv, int s_len,
            int d, int bs, float seed) {
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const size_t run = (((size_t)layer * batch + b) * nkv + h) * s_len +
                     (size_t)j * bs;                     // first row
  const T* kr = k + run * d;
  const T* vr = v + run * d;
  const int n16 = (int)((size_t)bs * d * sizeof(T) / 16);
  const uint4* k4 = reinterpret_cast<const uint4*>(kr);
  const uint4* v4 = reinterpret_cast<const uint4*>(vr);
  unsigned x = 0;
  for (int i = threadIdx.x; i < n16; i += kThreads * kUnroll) {
    uint4 a[kUnroll], c[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = i + u * kThreads;
      a[u] = idx < n16 ? __ldcs(k4 + idx) : make_uint4(0, 0, 0, 0);
      c[u] = idx < n16 ? __ldcs(v4 + idx) : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      x ^= a[u].x ^ a[u].y ^ a[u].z ^ a[u].w ^ c[u].x ^ c[u].y ^ c[u].z ^
           c[u].w;
  }
  if (x == sentinel) *sink = x;
  if (h == 0) {
    for (int t = threadIdx.x; t < d; t += kThreads)
      terms[((size_t)b * gridDim.x + j) * d + t] =
          (value(kr, t) + value(vr, t)) + seed;
  }
}

// grid (B), thread t = dim t: o[b, t] = sum over j in order of terms.
__global__ void sum_kernel(const float* __restrict__ terms,
                           float* __restrict__ o, int n_slab, int d) {
  const int b = blockIdx.x;
  for (int t = threadIdx.x; t < d; t += blockDim.x) {
    float acc = 0.f;
    for (int j = 0; j < n_slab; ++j)
      acc += terms[((size_t)b * n_slab + j) * d + t];
    o[(size_t)b * d + t] = acc;
  }
}

template <typename T>
int launch(const void* k, const void* v, float* terms, float* o,
           unsigned* sink, unsigned sentinel, int layer, int batch, int nkv,
           int s_len, int d, int bs, float seed, cudaStream_t st) {
  const int n_slab = s_len / bs;
  slab_kernel<T><<<dim3(n_slab, nkv, batch), kThreads, 0, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), terms, sink,
      sentinel, layer, batch, nkv, s_len, d, bs, seed);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_kernel<<<batch, 128, 0, st>>>(terms, o, n_slab, d);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float8_e4m3fn. k/v point at the start of the
// stacked cache [L, B, nkv, s_len, d]; `layer` selects the layer. terms:
// [B, s_len / bs, d] f32 scratch; o: [B, d] f32; sink: one scratch word.
// Returns the first launch error (cudaError_t), 0 if both launched.
extern "C" int slab_read_fwd(int dtype, const void* k, const void* v,
                             void* terms, void* o, void* sink,
                             unsigned sentinel, int layer, int batch, int nkv,
                             int s_len, int d, int bs, float seed,
                             void* stream) {
  const int item = dtype == 1 ? 2 : 1;
  if (batch <= 0 || nkv <= 0 || d <= 0 || bs <= 0 || s_len % bs != 0 ||
      ((size_t)bs * d * item) % 16 != 0 || layer < 0)
    return (int)cudaErrorInvalidValue;
  auto* tp = static_cast<float*>(terms);
  auto* op = static_cast<float*>(o);
  auto* sp = static_cast<unsigned*>(sink);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(k, v, tp, op, sp, sentinel, layer, batch,
                                 nkv, s_len, d, bs, seed, st);
  if (dtype == 2)
    return launch<uint8_t>(k, v, tp, op, sp, sentinel, layer, batch, nkv,
                           s_len, d, bs, seed, st);
  return (int)cudaErrorInvalidValue;
}
