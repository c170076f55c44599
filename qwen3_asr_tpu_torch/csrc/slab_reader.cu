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
// The int4 route reads the layer as kernel #3's int4 route reads it: the
// packed payload [L, B, Nkv, S, 64] uint8 (byte i of a row holds dims 2i,
// low nibble, and 2i + 1, high nibble, each as value + 8) by one bulk copy
// of the chunk's rows each for K and V, and the chunk's bf16 scale rows
// [L, B, Nkv, S, 1] by one more bulk copy each, all on one barrier. Its
// term folds the scales in, so a scale that did not land shows:
//
//   o[b, :] = sum over j of ((k * ks)[b, 0, j*bs, :] + (v * vs)[b, 0, j*bs, :]
//                            + seed)
//
// (The TPU probe's int4 shape reads a jnp.int4 array with no scales; the
// port's int4 cache always comes with them, 66 bytes a row in all.)
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
// per layer (int4: 2 * B * Nkv * S * (64 + 2)) over the card's 3.35 TB/s.
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

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int kD = 128;
constexpr int kThreads = kD;            // thread t takes head dim t
constexpr int kChunkBytes = 16384;      // as csrc/decode_attention_batch.cu
constexpr int kBatch = 8;               // sliver terms loaded at once
constexpr int kMaxChunk = 128;          // keys of one chunk (the plan's)

__device__ __forceinline__ float value(const uint8_t* p, int i) {
  const __half_raw hr = __nv_cvt_fp8_to_halfraw(p[i], __NV_E4M3);
  return __half2float(__half(hr));
}
__device__ __forceinline__ float value(const __nv_bfloat16* p, int i) {
  return __bfloat162float(p[i]);
}

struct Int4x2 { uint8_t bits; };        // two int4 values, dims 2i, 2i + 1

// dim i % 128 of row i / 128, widened (the scale is applied by the caller)
__device__ __forceinline__ float value(const Int4x2* p, int i) {
  const uint8_t byte = p[i >> 1].bits;
  return (float)((int)((i & 1) ? byte >> 4 : byte & 15) - 8);
}

template <typename T> struct RowBytes {
  static constexpr int value = kD * (int)sizeof(T);
};
template <> struct RowBytes<Int4x2> { static constexpr int value = kD / 2; };

// Grid (n_split, Nkv, B). Dynamic shared memory: [K chunk | V chunk].
template <typename T>
__global__ void __launch_bounds__(kThreads)
slab_kernel(const T* __restrict__ k, const T* __restrict__ v,
            const __nv_bfloat16* __restrict__ k_sc,
            const __nv_bfloat16* __restrict__ v_sc,
            float* __restrict__ terms, float* __restrict__ o,
            unsigned* __restrict__ tickets, int layer, int batch, int nkv,
            int s_len, int bs, int chunk, float seed) {
  constexpr bool kInt4 = std::is_same<T, Int4x2>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t full;
  __shared__ __align__(16) __nv_bfloat16 kss[kMaxChunk], vss[kMaxChunk];
  __shared__ int last_s;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int n_slab = s_len / bs;
  const int tile_bytes = chunk * RowBytes<T>::value;
  const T* ks = reinterpret_cast<const T*>(smem);
  const T* vs = reinterpret_cast<const T*>(smem + tile_bytes);

  if (tid == 0) {
    const size_t first =
        (((size_t)layer * batch + b) * nkv + h) * s_len + (size_t)j * chunk;
    const uint32_t sbytes = kInt4 ? (uint32_t)chunk * 2u : 0u;
    const unsigned char* kb = reinterpret_cast<const unsigned char*>(k);
    const unsigned char* vb = reinterpret_cast<const unsigned char*>(v);
    sm90::mbar_init(&full, 1);
    sm90::mbar_expect_tx(&full, 2 * tile_bytes + 2 * sbytes);
    sm90::bulk_load(smem, kb + first * RowBytes<T>::value, tile_bytes,
                    &full);
    sm90::bulk_load(smem + tile_bytes, vb + first * RowBytes<T>::value,
                    tile_bytes, &full);
    if (kInt4) {
      sm90::bulk_load(kss, k_sc + first, sbytes, &full);
      sm90::bulk_load(vss, v_sc + first, sbytes, &full);
    }
  }
  __syncthreads();   // the barrier's init
  sm90::mbar_wait(&full, 0);
  if (h == 0) {
    const int c0 = j * chunk;
    for (int i = (c0 + bs - 1) / bs; i * bs < c0 + chunk; ++i) {
      const int row = i * bs - c0, r = row * kD + tid;
      float kv = value(ks, r), vv = value(vs, r);
      if (kInt4) {
        kv *= __bfloat162float(kss[row]);
        vv *= __bfloat162float(vss[row]);
      }
      terms[((size_t)b * n_slab + i) * kD + tid] = (kv + vv) + seed;
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
int launch(const void* k, const void* v, const void* k_sc, const void* v_sc,
           float* terms, float* o, unsigned* tickets, int layer, int batch,
           int nkv, int s_len, int bs, int chunk, float seed,
           cudaStream_t st) {
  const int tile_bytes = chunk * RowBytes<T>::value;
  if (tile_bytes > kChunkBytes || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  static bool raised[sm90::kMaxDevices] = {};
  const cudaError_t err =
      sm90::max_smem(slab_kernel<T>, 2 * kChunkBytes, raised);
  if (err != cudaSuccess) return (int)err;
  slab_kernel<T><<<dim3(s_len / chunk, nkv, batch), kThreads,
                   2 * tile_bytes, st>>>(
      static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const __nv_bfloat16*>(k_sc),
      static_cast<const __nv_bfloat16*>(v_sc), terms, o, tickets, layer,
      batch, nkv, s_len, bs, chunk, seed);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 1 = bfloat16, 2 = float8_e4m3fn, 3 = packed int4 ([L, B, nkv,
// s_len, 64] uint8 with k_scale / v_scale, its [L, B, nkv, s_len, 1] bf16
// planes; null for the other dtypes). k/v point at the start of the
// stacked cache [L, B, nkv, s_len, 128]; `layer` selects the layer.
// `chunk` is kernel #3's for this cache. terms: [B, s_len / bs, 128] f32
// scratch; o: [B, 128] f32; tickets: B zeroed unsigned ints, left zeroed.
// Returns the launch's cudaError_t.
extern "C" int slab_read_fwd(int dtype, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
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
    return launch<__nv_bfloat16>(k, v, nullptr, nullptr, tp, op, tk, layer,
                                 batch, nkv, s_len, bs, chunk, seed, st);
  if (dtype == 2)
    return launch<uint8_t>(k, v, nullptr, nullptr, tp, op, tk, layer, batch,
                           nkv, s_len, bs, chunk, seed, st);
  if (dtype == 3) {
    if (k_scale == nullptr || v_scale == nullptr)
      return (int)cudaErrorInvalidValue;
    return launch<Int4x2>(k, v, k_scale, v_scale, tp, op, tk, layer, batch,
                          nkv, s_len, bs, chunk, seed, st);
  }
  return (int)cudaErrorInvalidValue;
}
