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
// exists only to fill the TPU's matrix unit.
//
// What bounds it: the bytes of the live cache, 2 * B * Nkv * live * 128 *
// itemsize per layer (fp8 halves them against bf16); the arithmetic is
// about G = Nq / Nkv multiply-adds per byte, far below the card's ridge.
// So the design keeps every byte of a block's chunk in flight at once and
// keeps the work after the copy lands short:
//
// - One launch, S split by a plan. Grid (n_split, Nkv, B): the wrapper
//   picks the chunk length (a power of two that divides 128) from S, B,
//   Nkv and the itemsize alone, never from the valid range, so that even
//   B = 1 fills the SMs (ops/decode_attention_batch.py `batch_plan`). A
//   block reads one chunk of one (row, KV head), and nothing if the chunk
//   holds no live key. At most 32 KB of shared memory a block, so six
//   blocks an SM keep their copies in flight at once.
// - Bulk copies of the live rows. A chunk's live K rows and its live V
//   rows are each contiguous in the cache, so each comes in one 1-D
//   `cp.async.bulk` onto a barrier of its own (the scores start while V
//   flies). fp8 and bf16 land as raw bytes: nothing widened goes back to
//   device memory.
// - Both products on tensor cores (mma.sync m16n8k16, bf16 operands, f32
//   accumulators), the small side as N: scores S^T = K_chunk [keys x 128] .
//   qs^T [128 x 8] with 16 keys a tile as M and the query group (G <= 8,
//   zero-padded) as N; output O^T = V^T [128 x keys] . bf16(P)^T [keys x 8]
//   with 16 head dims a tile as M. The contraction order is free, so the
//   scores take head dims [32p + 8t, 32p + 8t + 8) of a K row as one
//   16-byte load per lane (t = lane % 4), and P.V takes four adjacent head
//   dims of a V row as one 8-byte load, pairing two keys per register with
//   one byte permute. Tiles are widened (fp8 -> bf16 is exact) or rounded
//   (f32) to bf16 as the fragments are formed.
// - Softmax per chunk: the max over the chunk's live keys, p rounded to
//   bf16 against it; the scale folded into q. The plain version takes the
//   same max per chunk of the same plan.
// - Each block writes its chunk's partial m, l and acc to f32 scratch;
//   the last block of a (row, KV head) to take an acq_rel ticket combines
//   the live chunks in split order and resets the ticket
//   (csrc/split_combine.cuh). The output is the same bits on every run and
//   under CUDA-graph replay.
//
// The int4 route (no TPU kernel: JAX keeps int4 decode steps on XLA,
// `attend_xla` with scores-side scales, qwen3_asr_tpu/ops/attention.py):
// the cache holds two values a byte (dims 2j, 2j + 1 of a row as the low
// and high nibble, each value + 8; 64 bytes a row) with bf16 scales
// [L, B, Nkv, S, 1] per (token, head). The chunk's live payload rows come
// in as above and the chunk's K and V scale rows by one more bulk copy each
// (the whole chunk: 32-byte aligned), both on K's barrier, since the
// softmax weights P by V's scales; nibbles widen to bf16 exactly as the
// fragments are formed, and the scales ride the scores and weights:
//   s = (q . k) * scale * ks in f32 (q in bf16, not pre-scaled); p =
//   exp(s - m) per chunk; l = sum p; acc = sum bf16(p * vs) * v.
// Nothing widened is written back to device memory.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"
#include "split_combine.cuh"

namespace {

using sm90::kMaskValue;

constexpr int kD = 128;                 // head dim (the TPU kernel's too)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = split::kMaxG;     // query heads per KV head: mma's N
constexpr int kMaxChunk = 128;          // keys of one chunk: 8 tiles of 16
constexpr int kChunkBytes = 16384;      // K (or V) bytes of one chunk
constexpr int kCombineBytes = 65536;    // records a combine round stages
constexpr int kMaxSmem = kCombineBytes > 2 * kChunkBytes ? kCombineBytes
                                                         : 2 * kChunkBytes;
constexpr int kPStride = kMaxChunk + 8; // bf16 row stride of P: the rows of
                                        // a B fragment load on distinct banks
constexpr int kRec = kD + 4;            // floats per partial record

struct Fp8E4M3 { uint8_t bits; };       // torch.float8_e4m3fn storage
struct Int4x2 { uint8_t bits; };        // two int4 values, dims 2j, 2j + 1

// Bytes of one cache row (128 head dims).
template <typename KV> struct RowBytes {
  static constexpr int value = kD * (int)sizeof(KV);
};
template <> struct RowBytes<Int4x2> { static constexpr int value = kD / 2; };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}
// Two e4m3 values (the low 16 bits of w) as a bf16 pair; exact.
__device__ __forceinline__ uint32_t fp8x2_to_bf16x2(uint32_t w) {
  const __half2_raw hr =
      __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w & 0xffffu),
                                 __NV_E4M3);
  const float2 f = __half22float2(__half2(hr));
  return pack_bf16(f.x, f.y);
}

// Cache values of one row in shared memory, from head dim c on, as bf16
// pairs (the low half holds the lower dim); zeros for a dead row.
template <typename KV> struct Row;
template <> struct Row<__nv_bfloat16> {
  __device__ static uint4 eight(const unsigned char* row, int c, bool live) {
    return live ? *reinterpret_cast<const uint4*>(row + 2 * c)
                : make_uint4(0, 0, 0, 0);
  }
  __device__ static uint2 four(const unsigned char* row, int c, bool live) {
    return live ? *reinterpret_cast<const uint2*>(row + 2 * c)
                : make_uint2(0, 0);
  }
};
template <> struct Row<Fp8E4M3> {
  __device__ static uint4 eight(const unsigned char* row, int c, bool live) {
    if (!live) return make_uint4(0, 0, 0, 0);
    const uint2 w = *reinterpret_cast<const uint2*>(row + c);
    return make_uint4(fp8x2_to_bf16x2(w.x), fp8x2_to_bf16x2(w.x >> 16),
                      fp8x2_to_bf16x2(w.y), fp8x2_to_bf16x2(w.y >> 16));
  }
  __device__ static uint2 four(const unsigned char* row, int c, bool live) {
    if (!live) return make_uint2(0, 0);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c);
    return make_uint2(fp8x2_to_bf16x2(w), fp8x2_to_bf16x2(w >> 16));
  }
};
// Nibbles of one byte (value + 8 each) as a bf16 pair; exact.
__device__ __forceinline__ uint32_t int4x2_to_bf16x2(uint32_t byte) {
  return pack_bf16((float)((int)(byte & 15u) - 8),
                   (float)((int)((byte >> 4) & 15u) - 8));
}
template <> struct Row<Int4x2> {
  __device__ static uint4 eight(const unsigned char* row, int c, bool live) {
    if (!live) return make_uint4(0, 0, 0, 0);
    const uint32_t w = *reinterpret_cast<const uint32_t*>(row + c / 2);
    return make_uint4(int4x2_to_bf16x2(w), int4x2_to_bf16x2(w >> 8),
                      int4x2_to_bf16x2(w >> 16), int4x2_to_bf16x2(w >> 24));
  }
  __device__ static uint2 four(const unsigned char* row, int c, bool live) {
    if (!live) return make_uint2(0, 0);
    const uint32_t w = *reinterpret_cast<const uint16_t*>(row + c / 2);
    return make_uint2(int4x2_to_bf16x2(w), int4x2_to_bf16x2(w >> 8));
  }
};
template <> struct Row<float> {
  __device__ static uint4 eight(const unsigned char* row, int c, bool live) {
    if (!live) return make_uint4(0, 0, 0, 0);
    const float4* p = reinterpret_cast<const float4*>(row + 4 * c);
    const float4 a = p[0], b = p[1];
    return make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                      pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
  }
  __device__ static uint2 four(const unsigned char* row, int c, bool live) {
    if (!live) return make_uint2(0, 0);
    const float4 a = *reinterpret_cast<const float4*>(row + 4 * c);
    return make_uint2(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w));
  }
};

// c += a . b: a 16x16 bf16 (row-major fragment), b 16x8 bf16, c 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Grid (n_split, Nkv, B). Dynamic shared memory: [K chunk | V chunk],
// reused by the combine (`smem_bytes` in all). k_sc / v_sc: the int4
// route's scale planes (null otherwise).
template <typename Q, typename KV>
__global__ void __launch_bounds__(kThreads)
decode_batch_kernel(const Q* __restrict__ q, const KV* __restrict__ k,
                    const KV* __restrict__ v,
                    const __nv_bfloat16* __restrict__ k_sc,
                    const __nv_bfloat16* __restrict__ v_sc,
                    Q* __restrict__ o, const int* __restrict__ valid_from,
                    const int* __restrict__ valid_to,
                    float* __restrict__ part, unsigned* __restrict__ tickets,
                    int layer, int batch, int nq, int nkv, int s_len,
                    int chunk, float sm_scale, int smem_bytes) {
  constexpr int kRowBytes = RowBytes<KV>::value;
  constexpr bool kInt4 = std::is_same<KV, Int4x2>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t k_full, v_full;
  __shared__ __align__(16) __nv_bfloat16 kss[kMaxChunk], vss[kMaxChunk];
  __shared__ __align__(16) __nv_bfloat16 ps[kMaxG * kPStride];
  __shared__ float red_max[kWarps][kMaxG], red_sum[kWarps][kMaxG];

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = s_len / chunk;
  const int group = nq / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, tig = lane & 3;    // fragment row, column pair
  const int lo_all = max(valid_from[b], 0);
  const int hi_all = min(valid_to[b], s_len);
  // this block's live keys [lo, lo + n_live), row 0 of the tiles
  const int lo = max(lo_all, j * chunk);
  const int n_live = min(hi_all, j * chunk + chunk) - lo;
  const size_t bh = (size_t)b * nkv + h;
  const unsigned char* ks = smem;
  const unsigned char* vs = smem + chunk * kRowBytes;
  const int sc0 = lo - j * chunk;    // row 0's index in the chunk's scales

  if (n_live > 0) {
    // Thread 0: the live rows, K and V on barriers of their own, so the
    // scores start while V flies.
    if (tid == 0) {
      const size_t base = (((size_t)layer * batch + b) * nkv + h) * s_len;
      const size_t first = base + lo;
      const uint32_t bytes = (uint32_t)n_live * kRowBytes;
      const uint32_t sbytes = kInt4 ? (uint32_t)chunk * 2u : 0u;
      const unsigned char* kbytes = reinterpret_cast<const unsigned char*>(k);
      const unsigned char* vbytes = reinterpret_cast<const unsigned char*>(v);
      sm90::mbar_init(&k_full, 1);
      sm90::mbar_init(&v_full, 1);
      // both scale rows land with K: the softmax reads vs before P.V
      // waits for V's payload
      sm90::mbar_expect_tx(&k_full, bytes + 2 * sbytes);
      sm90::bulk_load(smem, kbytes + first * kRowBytes, bytes, &k_full);
      if (kInt4) {
        sm90::bulk_load(kss, k_sc + base + (size_t)j * chunk, sbytes,
                        &k_full);
        sm90::bulk_load(vss, v_sc + base + (size_t)j * chunk, sbytes,
                        &k_full);
      }
      sm90::mbar_expect_tx(&v_full, bytes);
      sm90::bulk_load(smem + chunk * kRowBytes, vbytes + first * kRowBytes,
                      bytes, &v_full);
    }
    // While the copies fly: the B fragments of the scores, bf16(q * scale)
    // of head gr (0 past the group) at dims [32p + 8 tig, +8), the k pairs
    // (2 tig, 2 tig + 8) of k-steps 2p and 2p + 1. The int4 route takes q
    // as it is (bf16) and scales the scores instead.
    const float q_mul = kInt4 ? 1.f : sm_scale;
    const Q* qh = q + ((size_t)b * nq + h * group + min(gr, group - 1)) * kD;
    uint4 qf[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 32 * p + 8 * tig + 2 * e;
        w[e] = gr < group ? pack_bf16(to_f32(qh[c]) * q_mul,
                                      to_f32(qh[c + 1]) * q_mul)
                          : 0u;
      }
      qf[p] = make_uint4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();   // the barriers' init

    sm90::mbar_wait(&k_full, 0);

    // Scores: warp w takes the 16-key tiles w and w + 4. sc[t] holds
    // keys r, r + 8 (r = 16 tile + gr) for heads 2 tig, 2 tig + 1.
    float sc[2][4];
    float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r = (warp + kWarps * t) * 16 + gr;
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[t][e] = 0.f;
      if (r - gr < n_live) {                 // the tile holds a live key
        const unsigned char* ra = ks + r * kRowBytes;
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint4 ka = Row<KV>::eight(ra, 32 * p + 8 * tig, r < n_live);
          const uint4 kb = Row<KV>::eight(ra + 8 * kRowBytes,
                                          32 * p + 8 * tig, r + 8 < n_live);
          mma_bf16(sc[t], ka.x, kb.x, ka.y, kb.y, qf[p].x, qf[p].y);
          mma_bf16(sc[t], ka.z, kb.z, ka.w, kb.w, qf[p].z, qf[p].w);
        }
        if (kInt4) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int rr = r + 8 * half;
            if (rr < n_live) {
              const float kscale = __bfloat162float(kss[sc0 + rr]);
              sc[t][2 * half] = sc[t][2 * half] * sm_scale * kscale;
              sc[t][2 * half + 1] = sc[t][2 * half + 1] * sm_scale * kscale;
            }
          }
        }
      }
      if (r >= n_live) sc[t][0] = sc[t][1] = kMaskValue;
      if (r + 8 >= n_live) sc[t][2] = sc[t][3] = kMaskValue;
      mx[0] = fmaxf(mx[0], fmaxf(sc[t][0], sc[t][2]));
      mx[1] = fmaxf(mx[1], fmaxf(sc[t][1], sc[t][3]));
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      mx[0] = fmaxf(mx[0], __shfl_xor_sync(0xffffffffu, mx[0], off));
      mx[1] = fmaxf(mx[1], __shfl_xor_sync(0xffffffffu, mx[1], off));
    }
    if (gr == 0) {
      red_max[warp][2 * tig] = mx[0];
      red_max[warp][2 * tig + 1] = mx[1];
    }
    __syncthreads();

    // p against the chunk's max; l sums the f32 p, P.V takes bf16(p).
    float m[2], ls[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m[e] = red_max[0][2 * tig + e];
#pragma unroll
      for (int w = 1; w < kWarps; ++w)
        m[e] = fmaxf(m[e], red_max[w][2 * tig + e]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = (warp + kWarps * t) * 16 + gr + 8 * half;
        if (r < chunk) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p =
                r < n_live ? expf(sc[t][2 * half + e] - m[e]) : 0.f;
            ls[e] += p;
            const float pw =
                kInt4 && r < n_live ? p * __bfloat162float(vss[sc0 + r]) : p;
            ps[(2 * tig + e) * kPStride + r] = __float2bfloat16(pw);
          }
        }
      }
    }
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      ls[0] += __shfl_xor_sync(0xffffffffu, ls[0], off);
      ls[1] += __shfl_xor_sync(0xffffffffu, ls[1], off);
    }
    if (gr == 0) {
      red_sum[warp][2 * tig] = ls[0];
      red_sum[warp][2 * tig + 1] = ls[1];
    }
    __syncthreads();

    sm90::mbar_wait(&v_full, 0);
    // O^T = V^T P^T: warp w takes head dims [32 w, 32 w + 32); lane
    // (gr, tig) holds dims dc .. dc + 3 (dc = 32 w + 4 gr) as rows gr and
    // gr + 8 of two 16-dim tiles. k-step kt pairs keys (k, k + 1) and
    // (k + 8, k + 9), k = 16 kt + 2 tig.
    float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const int dc = 32 * warp + 4 * gr;
    const int n_kt = (n_live + 15) / 16;
    for (int kt = 0; kt < n_kt; ++kt) {
      const int key = 16 * kt + 2 * tig;
      const unsigned char* rv = vs + key * kRowBytes;
      const uint2 va = Row<KV>::four(rv, dc, key < n_live);
      const uint2 vb = Row<KV>::four(rv + kRowBytes, dc, key + 1 < n_live);
      const uint2 vc =
          Row<KV>::four(rv + 8 * kRowBytes, dc, key + 8 < n_live);
      const uint2 vd =
          Row<KV>::four(rv + 9 * kRowBytes, dc, key + 9 < n_live);
      const __nv_bfloat16* pg = ps + gr * kPStride + key;
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(pg);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(pg + 8);
      mma_bf16(acc[0], __byte_perm(va.x, vb.x, 0x5410),
               __byte_perm(va.x, vb.x, 0x7632),
               __byte_perm(vc.x, vd.x, 0x5410),
               __byte_perm(vc.x, vd.x, 0x7632), b0, b1);
      mma_bf16(acc[1], __byte_perm(va.y, vb.y, 0x5410),
               __byte_perm(va.y, vb.y, 0x7632),
               __byte_perm(vc.y, vd.y, 0x5410),
               __byte_perm(vc.y, vd.y, 0x7632), b0, b1);
    }

    // The chunk's record (csrc/split_combine.cuh).
    float* mine = part + (bh * n_split + j) * group * kRec;
    if (2 * tig < group)
      *reinterpret_cast<float4*>(mine + 2 * tig * kRec + 4 + dc) =
          make_float4(acc[0][0], acc[0][2], acc[1][0], acc[1][2]);
    if (2 * tig + 1 < group)
      *reinterpret_cast<float4*>(mine + (2 * tig + 1) * kRec + 4 + dc) =
          make_float4(acc[0][1], acc[0][3], acc[1][1], acc[1][3]);
    if (tid < group) {
      float mm = red_max[0][tid], ll = red_sum[0][tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        mm = fmaxf(mm, red_max[w][tid]);
        ll += red_sum[w][tid];
      }
      mine[tid * kRec] = mm;
      mine[tid * kRec + 1] = ll;
    }
  }

  split::ticket_and_combine<Q, kThreads, kMaxG>(
      part, tickets, o, bh, b, h, nq, group, kD, gridDim.x, n_split, chunk,
      lo_all, hi_all, reinterpret_cast<float*>(smem), smem_bytes);
}

template <typename Q, typename KV>
int launch(const void* q, const void* k, const void* v, const void* ks,
           const void* vs, void* o, const int* vf, const int* vt,
           float* part, unsigned* tickets, int layer, int batch, int nq,
           int nkv, int s_len, int chunk, float sm_scale, int smem_bytes,
           cudaStream_t stream) {
  if (chunk * RowBytes<KV>::value > kChunkBytes ||
      smem_bytes < 2 * chunk * RowBytes<KV>::value ||
      (std::is_same<KV, Int4x2>::value && (ks == nullptr || vs == nullptr)))
    return (int)cudaErrorInvalidValue;
  static bool raised[sm90::kMaxDevices] = {};
  const cudaError_t err =
      sm90::max_smem(decode_batch_kernel<Q, KV>, kMaxSmem, raised);
  if (err != cudaSuccess) return (int)err;
  decode_batch_kernel<Q, KV><<<dim3(s_len / chunk, nkv, batch), kThreads,
                               smem_bytes, stream>>>(
      static_cast<const Q*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v), static_cast<const __nv_bfloat16*>(ks),
      static_cast<const __nv_bfloat16*>(vs), static_cast<Q*>(o), vf, vt,
      part, tickets, layer, batch, nq, nkv, s_len, chunk, sm_scale,
      smem_bytes);
  return (int)cudaGetLastError();
}

// The int4 route takes bf16 q only (its q fragments are q itself).
template <typename Q>
int launch_q(int kv_dtype, const void* q, const void* k, const void* v,
             const void* ks, const void* vs, void* o, const int* vf,
             const int* vt, float* part, unsigned* tickets, int layer,
             int batch, int nq, int nkv, int s_len, int chunk,
             float sm_scale, int smem_bytes, cudaStream_t st) {
  using Go = int (*)(const void*, const void*, const void*, const void*,
                     const void*, void*, const int*, const int*, float*,
                     unsigned*, int, int, int, int, int, int, float, int,
                     cudaStream_t);
  Go go = nullptr;
  if (kv_dtype == 0) go = launch<Q, float>;
  if (kv_dtype == 1) go = launch<Q, __nv_bfloat16>;
  if (kv_dtype == 2) go = launch<Q, Fp8E4M3>;
  if constexpr (std::is_same<Q, __nv_bfloat16>::value)
    if (kv_dtype == 3) go = launch<Q, Int4x2>;
  if (go == nullptr) return (int)cudaErrorInvalidValue;
  return go(q, k, v, ks, vs, o, vf, vt, part, tickets, layer, batch, nq,
            nkv, s_len, chunk, sm_scale, smem_bytes, st);
}

}  // namespace

// q_dtype: 0 = float32, 1 = bfloat16 (the output's too). kv_dtype: 0 =
// float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = packed int4 (bf16 q only;
// k_scale / v_scale are its [L, B, nkv, s_len, 1] bf16 planes, null for
// the others). k/v point at the start of the
// stacked cache [L, B, nkv, s_len, 128] (L = 1 for one layer); `layer`
// selects the layer. The plan: `chunk` keys a block (16, 32, 64 or 128, at
// most 16 KB of K), `smem_bytes` of dynamic shared memory (the chunk's K
// and V, and at least one combine round's records). part: f32 scratch of
// B * nkv * (s_len / chunk) * (nq / nkv) * 132 values; tickets: B * nkv
// zeroed unsigned ints, left zeroed. Returns the launch's cudaError_t.
extern "C" int decode_attention_batch_fwd(
    int q_dtype, int kv_dtype, const void* q, const void* k, const void* v,
    const void* k_scale, const void* v_scale, void* o,
    const void* valid_from, const void* valid_to, void* part,
    void* tickets, int layer, int batch, int nq, int nkv, int s_len, int d,
    int chunk, float sm_scale, int smem_bytes, void* stream) {
  if (d != kD || nkv <= 0 || nq % nkv != 0 || nq / nkv > kMaxG ||
      layer < 0 || batch <= 0 || chunk < 16 || chunk > kMaxChunk ||
      (chunk & (chunk - 1)) != 0 || s_len <= 0 || s_len % chunk != 0 ||
      smem_bytes > kMaxSmem ||
      smem_bytes < (int)sizeof(float) * (nq / nkv) * kRec)
    return (int)cudaErrorInvalidValue;
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto* pp = static_cast<float*>(part);
  auto* tk = static_cast<unsigned*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  if (q_dtype == 0)
    return launch_q<float>(kv_dtype, q, k, v, k_scale, v_scale, o, vf, vt,
                           pp, tk, layer, batch, nq, nkv, s_len, chunk,
                           sm_scale, smem_bytes, st);
  if (q_dtype == 1)
    return launch_q<__nv_bfloat16>(kv_dtype, q, k, v, k_scale, v_scale, o,
                                   vf, vt, pp, tk, layer, batch, nq, nkv,
                                   s_len, chunk, sm_scale, smem_bytes, st);
  return (int)cudaErrorInvalidValue;
}
