// KV slab-read probe for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel tools_perf/attn_phase.py `_slab_kernel` (built by
// `make_slab_reader`): a read-rate probe of one layer of the stacked cache
// [L, B, Nkv, S, 128], streamed in batch-major slabs. Its output is exactly
// that kernel's:
//
//   o[b, :] = sum over j of (k[b, 0, j*bs, :] + v[b, 0, j*bs, :] + seed)
//
// in f32, summed in order of j, for the slabs j = 0 .. S/bs - 1.
//
// Reading every byte. On the TPU the auto-pipeline copies whole blocks into
// VMEM whatever the kernel body touches, so the sliver sum reads the whole
// cache. Here every byte of the layer lands in shared memory through 1-D
// bulk copies (`cp.async.bulk`), which the compiler cannot elide, and the
// sliver terms are read from there.
//
// What it measures: the read ceiling of csrc/decode_attention_batch.cu's
// own design. It reads the layer exactly as that kernel reads a fully live
// cache: the same plan (ops/decode_attention_batch.py `batch_plan`: the
// chunk length), grid (n_split, Nkv, B), one chunk a block, its K rows and
// its V rows by one bulk copy each onto one mbarrier, and a ticket per
// row. It does no arithmetic worth
// counting, so it is bound by bytes only: 2 * B * Nkv * S * 128 * itemsize
// per layer over the card's 3.35 TB/s.
//
// One launch: the head-0 blocks write the sliver term of every slab that
// starts in their chunk to f32 scratch; the last block of row b to
// take an acq_rel ticket sums the terms in order of j and resets the
// ticket.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = kD;            // thread t takes head dim t
constexpr int kChunkBytes = 16384;      // as csrc/decode_attention_batch.cu
constexpr int kBatch = 8;               // sliver terms loaded at once

__device__ __forceinline__ float value(const uint8_t* p, int i) {
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(p[i], __NV_E4M3);
  return __half2float(__half(hr));
}
__device__ __forceinline__ float value(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

// Grid (n_split, Nkv, B). Dynamic shared memory: [K chunk | V chunk].
template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const T* __restrict__ k, const T* __restrict__ v,
            float* __restrict__ terms, float* __restrict__ o,
            unsigned* __restrict__ tickets, int layer, int batch, int nkv,
            int s_len, int bs, int chunk, float seed) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full;
  __shared__ int last_s;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_slab = s_len / bs;
  const int tile_bytes = chunk * kD * (int)sizeof(T);
  const T* ks = reinterpret_cast<const T*>(smem);
  const T* vs = ks + chunk * kD;

  if (tid == 0) {
    const size_t first =
        (((size_t)layer * batch + b) * nkv + h) * s_len + (size_t)j * chunk;
    sm90::mbar_init(&full, 1);
    sm90::mbar_expect_tx(&full, 2 * tile_bytes);
    sm90::bulk_load(smem, k + first * kD, tile_bytes, &full);
    sm90::bulk_load(smem + tile_bytes, v + first * kD, tile_bytes, &full);
  }
  __syncthreads();   // the barrier's init
  sm90::mbar_wait(&full, 0);
  if (h == 0) {
    const int c0 = j * chunk;
    for (int i = (c0 + bs - 1) / bs; i * bs < c0 + chunk; ++i) {
      const int r = (i * bs - c0) * kD + tid;
      terms[((size_t)b * n_slab + i) * kD + tid] =
          (value(ks, r) + value(vs, r)) + seed;
    }
  }
  __syncthreads();   // the block's terms, before its ticket

  if (tid == 0)
    last_s = sm90::atomic_add_acq_rel(&tickets[b], 1u) ==
             (unsigned)(gridDim.x * nkv - 1);
  __syncthreads();
  if (!last_s) return;
  // kBatch terms in flight at once (one round trip to L2), summed in order
  const float* col = terms + (size_t)b * n_slab * kD + tid;
  float acc = 0.f;
  for (int j0 = 0; j0 < n_slab; j0 += kBatch) {
    float t[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      t[u] = j0 + u < n_slab ? __ldcg(col + (size_t)(j0 + u) * kD) : 0.f;
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u < n_slab) acc += t[u];
  }
  o[(size_t)b * kD + tid] = acc;
  if (tid == 0) tickets[b] = 0u;
}

template <typename T>
int launch(const void* k, const void* v, float* terms, float* o,
           unsigned* tickets, int layer, int batch, int nkv, int s_len,
           int bs, int chunk, float seed, cudaStream_t st) {
  const int tile_bytes = chunk * kD * (int)sizeof(T);
  if (tile_bytes > kChunkBytes) return (int)cudaErrorInvalidValue;
  static bool raised[sm90::kMaxDevices] = {};
  const cudaError_t err =
      sm90::max_smem(slab_kernel<T>, 2 * kChunkBytes, raised);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<T><<<dim3(s_len / chunk, nkv, batch), kThreads,
                   2 * tile_bytes, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), terms, o, tickets,
      layer, batch, nkv, s_len, bs, chunk, seed);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float8_e4m3fn. k/v point at the start of the
// stacked cache [L, B, nkv, s_len, 128]; `layer` selects the layer.
// `chunk` is kernel #3's for this cache. terms: [B, s_len / bs, 128] f32
// scratch; o: [B, 128] f32; tickets: B zeroed unsigned ints, left zeroed.
// Returns the launch's cudaError_t.
extern "C" int slab_read_fwd(int dtype, const void* k, const void* v,
                             void* terms, void* o, void* tickets, int layer,
                             int batch, int nkv, int s_len, int d, int bs,
                             int chunk, float seed, void* stream) {
  if (batch <= 0 || nkv <= 0 || d != kD || bs <= 0 || s_len % bs != 0 ||
      chunk < 16 || (chunk & (chunk - 1)) != 0 || s_len % chunk != 0 ||
      layer < 0)
    return (int)cudaErrorInvalidValue;
  auto* tp = static_cast<float*>(terms);
  auto* op = static_cast<float*>(o);
  auto* tk = static_cast<unsigned*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(k, v, tp, op, tk, layer, batch, nkv, s_len,
                                 bs, chunk, seed, st);
  if (dtype == 2)
    return launch<uint8_t>(k, v, tp, op, tk, layer, batch, nkv, s_len, bs,
                           chunk, seed, st);
  return (int)cudaErrorInvalidValue;
}
