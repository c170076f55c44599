// Single-token decode attention for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel qwen3_asr_tpu/ops/decode_attention.py `_kernel`
// (public `decode_attention`). Same function, with the same f32 arithmetic:
//
//   out[g] = softmax(q[g] * scale . k[c]) over c in [valid_from, valid_to),
//   weighted sum of v[c]; q * scale, K, V and p in f32; an empty range
//   gives 0 (safe divide).
//
// The cache is one layer [B, Nkv, S, D] or the stacked cache
// [L, B, Nkv, S, D] read at `layer` through a pointer offset (no copy).
//
// What bounds it: the bytes of the live cache (2 * live keys * D * dtype
// size per KV head), a few hundred KB per layer at batch 1 -- well under a
// microsecond of HBM time. So the cost is latency: how many round trips to
// device memory a call waits on, and how many SMs wait on them at once.
//
// Design (split S, one launch). Grid (n_split, Nkv, B): each block takes
// one chunk of `chunk` keys of one (row, KV head); the wrapper picks the
// chunk length from the cache length S alone (never from the valid range,
// which lives on the device) so that even batch 1 fills the card's SMs.
// A block copies the live rows of its chunk of K and of V with one 1-D
// bulk copy each (`cp.async.bulk`, contiguous in the cache) onto one
// mbarrier: every byte of the chunk is in flight at once, one round trip.
// It then scores from shared memory (16 lanes across D, 16-byte reads),
// takes the chunk's max and sum per query head, accumulates p * v (one
// thread per head dim), and writes its partial m, l and acc to f32 scratch.
// A block whose chunk holds no live key loads and writes nothing. Each
// block then takes a ticket on its (row, KV head) with an acq_rel atomic;
// the block that draws the last ticket combines the live chunks' partials
// in split order and resets the ticket to 0. So the output is the same
// bits on every run, and the kernel is safe to capture in a CUDA graph.
// The combine is on the critical path (on the card it first cost more
// than the loads and the scoring together), so it reads only the live
// chunks' partials, as one contiguous span pulled into shared memory by one
// bulk copy, not as rounds of scattered loads.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using sm90::kMaskValue;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTeam = 16;                    // lanes that score one key
constexpr int kTeams = kThreads / kTeam;
constexpr int kMaxG = 8;
constexpr int kMaxD = 128;
constexpr int kMaxChunk = 128;
constexpr int kChunkBytes = 16384;           // K (or V) bytes of one chunk
constexpr int kRoundSplits = 64;             // chunks per combine round
constexpr size_t kSmemBytes =
    2 * kChunkBytes + sizeof(float) * kMaxG * kMaxChunk;

// A 16-byte word of the cache as f32 values.
template <typename T> struct Word;
template <> struct Word<float> {
  static constexpr int kPer = 4;
  __device__ static void widen(const uint4& w, float* out) {
    out[0] = __uint_as_float(w.x);
    out[1] = __uint_as_float(w.y);
    out[2] = __uint_as_float(w.z);
    out[3] = __uint_as_float(w.w);
  }
};
template <> struct Word<__nv_bfloat16> {
  static constexpr int kPer = 8;
  __device__ static void widen(const uint4& w, float* out) {
    const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f =
          __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u[i]));
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Partials: one record of d + 4 f32 per (row, KV head, chunk, query
// head), [B * nkv][n_split][G][m, l, -, -, acc[d]], so the live chunks of a
// (row, KV head) are one contiguous, 16-byte aligned span. kG >= G =
// nq / nkv sizes the registers (q, scores, acc) for the query group.
template <typename T, int kG>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    const int* __restrict__ valid_from,
                    const int* __restrict__ valid_to, float* __restrict__ part,
                    unsigned* __restrict__ tickets, int layer, int batch,
                    int nq, int nkv, int s_len, int d, int chunk,
                    float sm_scale) {
  constexpr int kPer = Word<T>::kPer;               // values per 16 bytes
  constexpr int kWordsPerLane = 8 / kPer;           // 1 (bf16) or 2 (f32)
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar, bar_c;
  __shared__ float m_s[kMaxG], l_s[kMaxG], scale_s[kMaxG];
  __shared__ float w_s[kRoundSplits * kMaxG];
  __shared__ int last_s;
  T* ks = reinterpret_cast<T*>(smem);
  T* vs = reinterpret_cast<T*>(smem + kChunkBytes);
  float* ps = reinterpret_cast<float*>(smem + 2 * kChunkBytes);  // [G][chunk]

  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_split = gridDim.x;
  const int group = nq / nkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = j * chunk;
  const int lo = max(max(valid_from[b], 0), c0);
  const int hi = min(min(valid_to[b], s_len), c0 + chunk);
  const int n_live = max(hi - lo, 0);
  const size_t bh = (size_t)b * nkv + h;
  const int rec = d + 4;                         // floats per partial
  float* mine = part + (bh * n_split + j) * group * rec;

  if (n_live > 0) {
    const uint32_t bytes = (uint32_t)n_live * d * sizeof(T);
    const size_t row0 =
        (((size_t)layer * batch + b) * nkv + h) * s_len + (size_t)lo;
    if (tid == 0) {
      sm90::mbar_init(&bar, 1);
      sm90::mbar_expect_tx(&bar, 2 * bytes);
      sm90::bulk_load(ks, k + row0 * d, bytes, &bar);
      sm90::bulk_load(vs, v + row0 * d, bytes, &bar);
    }
    __syncthreads();   // the barrier's init, before anyone waits on it

    // While the copies fly: this lane's slice of q * scale for each head.
    // Lane tl of a team holds 16-byte words tl and tl + 16 of a row.
    const int tl = tid % kTeam, team = tid / kTeam;
    const int n_words = d * (int)sizeof(T) / 16;
    float qr[kG][8];
#pragma unroll
    for (int g = 0; g < kG; ++g) {
#pragma unroll
      for (int u = 0; u < kWordsPerLane; ++u) {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int e = (tl + kTeam * u) * kPer + i;
          qr[g][u * kPer + i] =
              (g < group && e < d)
                  ? to_f32(q[((size_t)b * nq + h * group + g) * d + e]) *
                        sm_scale
                  : 0.f;
        }
      }
    }
    sm90::mbar_wait(&bar, 0);

    // Scores: team `team` takes keys team, team + kTeams, ...; both teams
    // of a warp run the same number of rounds so the shuffles converge.
    for (int r0 = (team & ~1); r0 < n_live; r0 += kTeams) {
      const int r = r0 + (team & 1);
      const bool ok = r < n_live;
      float s[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) s[g] = 0.f;
#pragma unroll
      for (int u = 0; u < kWordsPerLane; ++u) {
        const int w = tl + kTeam * u;
        if (ok && w < n_words) {
          float kf[kPer];
          Word<T>::widen(
              reinterpret_cast<const uint4*>(ks + (size_t)r * d)[w], kf);
#pragma unroll
          for (int g = 0; g < kG; ++g) {
            if (g < group) {
#pragma unroll
              for (int i = 0; i < kPer; ++i)
                s[g] = fmaf(qr[g][u * kPer + i], kf[i], s[g]);
            }
          }
        }
      }
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g < group) {
#pragma unroll
          for (int off = kTeam / 2; off > 0; off >>= 1)
            s[g] += __shfl_xor_sync(0xffffffffu, s[g], off);
          if (ok && tl == 0) ps[g * chunk + r] = s[g];
        }
      }
    }
    __syncthreads();

    // The chunk's max and sum per query head; ps becomes p.
    for (int g = warp; g < group; g += kWarps) {
      float m = kMaskValue;
      for (int r = lane; r < n_live; r += 32) m = fmaxf(m, ps[g * chunk + r]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      float l = 0.f;
      for (int r = lane; r < n_live; r += 32) {
        const float p = expf(ps[g * chunk + r] - m);
        ps[g * chunk + r] = p;
        l += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l += __shfl_xor_sync(0xffffffffu, l, off);
      if (lane == 0) {
        m_s[g] = m;
        l_s[g] = l;
      }
    }
    __syncthreads();

    // acc: thread t takes head dim t.
    if (tid < d) {
      float acc[kG];
#pragma unroll
      for (int g = 0; g < kG; ++g) acc[g] = 0.f;
#pragma unroll 4
      for (int r = 0; r < n_live; ++r) {
        const float vv = to_f32(vs[(size_t)r * d + tid]);
#pragma unroll
        for (int g = 0; g < kG; ++g)
          if (g < group) acc[g] = fmaf(ps[g * chunk + r], vv, acc[g]);
      }
#pragma unroll
      for (int g = 0; g < kG; ++g)
        if (g < group) mine[g * rec + 4 + tid] = acc[g];
    }
    if (tid < group) {
      mine[tid * rec] = m_s[tid];
      mine[tid * rec + 1] = l_s[tid];
    }
  }

  // The last block of this (row, KV head) to take a ticket combines. The
  // ticket is an acq_rel atomic after a __syncthreads(): it publishes the
  // whole block's partial, and in the last block it orders the loads below
  // after every other block's.
  __syncthreads();
  if (tid == 0)
    last_s = sm90::atomic_add_acq_rel(&tickets[bh], 1u) ==
             (unsigned)(n_split - 1);
  __syncthreads();
  if (!last_s) return;

  // Only the chunks that hold a live key wrote a partial; every block
  // derives the same range from [valid_from, valid_to). Their records are
  // one span: copy it into shared memory with one bulk copy per round of
  // up to `per_round` chunks, and fold each round into a running m, l
  // and acc in split order (the same bits on every run).
  const int lo_all = max(valid_from[b], 0), hi_all = min(valid_to[b], s_len);
  const int j0 = lo_all / chunk;
  const int n_live_split =
      lo_all < hi_all ? (hi_all + chunk - 1) / chunk - j0 : 0;
  const int per_round = min(
      kRoundSplits, (int)(kSmemBytes / (sizeof(float) * group * rec)));
  const float* span = part + (bh * n_split + j0) * group * rec;
  float* staged = reinterpret_cast<float*>(smem);
  if (tid == 0) {
    sm90::mbar_init(&bar_c, 1);
    // the other blocks' records, written through the generic proxy, are
    // read by the bulk copy's async proxy
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  if (tid < group) {
    m_s[tid] = kMaskValue;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  const int n_out = group * d;
  float acc_c[kG];
#pragma unroll
  for (int x = 0; x < kG; ++x) acc_c[x] = 0.f;
  for (int s0 = 0, round = 0; s0 < n_live_split; s0 += per_round, ++round) {
    const int cnt = min(per_round, n_live_split - s0);
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)(cnt * group * rec * sizeof(float));
      sm90::mbar_expect_tx(&bar_c, bytes);
      sm90::bulk_load(staged, span + (size_t)s0 * group * rec, bytes, &bar_c);
    }
    sm90::mbar_wait(&bar_c, round & 1);
    for (int g = warp; g < group; g += kWarps) {
      float m_r = kMaskValue;
      for (int s = lane; s < cnt; s += 32)
        m_r = fmaxf(m_r, staged[(s * group + g) * rec]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m_r = fmaxf(m_r, __shfl_xor_sync(0xffffffffu, m_r, off));
      const float m_new = fmaxf(m_s[g], m_r);
      float l_r = 0.f;
      for (int s = lane; s < cnt; s += 32) {
        const float* r = staged + (s * group + g) * rec;
        const float w = expf(r[0] - m_new);
        w_s[s * group + g] = w;
        l_r = fmaf(r[1], w, l_r);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        l_r += __shfl_xor_sync(0xffffffffu, l_r, off);
      __syncwarp();
      if (lane == 0) {
        const float scale = expf(m_s[g] - m_new);
        scale_s[g] = scale;
        l_s[g] = fmaf(l_s[g], scale, l_r);
        m_s[g] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int x = 0; x < kG; ++x) {
      const int i = tid + x * kThreads;
      if (i < n_out) {
        const int g = i / d;
        const float* col = staged + g * rec + 4 + (i - g * d);
        float a = acc_c[x] * scale_s[g];
        for (int s = 0; s < cnt; ++s)
          a = fmaf(col[(size_t)s * group * rec], w_s[s * group + g], a);
        acc_c[x] = a;
      }
    }
    __syncthreads();   // before the next round overwrites the staging
  }
#pragma unroll
  for (int x = 0; x < kG; ++x) {
    const int i = tid + x * kThreads;
    if (i < n_out) {
      const int g = i / d;
      const float l = l_s[g] == 0.f ? 1.f : l_s[g];
      store(&o[((size_t)b * nq + h * group + g) * d + (i - g * d)],
            acc_c[x] / l);
    }
  }
  if (tid == 0) tickets[bh] = 0u;
}

template <typename T, int kG>
int launch_g(const void* q, const void* k, const void* v, void* o,
             const int* vf, const int* vt, float* part, unsigned* tickets,
             int layer, int batch, int nq, int nkv, int s_len, int d,
             int chunk, float sm_scale, cudaStream_t stream) {
  const int n_split = (s_len + chunk - 1) / chunk;
  decode_split_kernel<T, kG><<<dim3(n_split, nkv, batch), kThreads,
                               kSmemBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), vf, vt, part, tickets,
      layer, batch, nq, nkv, s_len, d, chunk, sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* vf, const int* vt, float* part, unsigned* tickets,
           int layer, int batch, int nq, int nkv, int s_len, int d, int chunk,
           float sm_scale, cudaStream_t stream) {
  if (chunk * d * (int)sizeof(T) > kChunkBytes)
    return (int)cudaErrorInvalidValue;
  const int group = nq / nkv;
  auto* go = group <= 1   ? launch_g<T, 1>
             : group <= 2 ? launch_g<T, 2>
             : group <= 4 ? launch_g<T, 4>
                          : launch_g<T, 8>;
  return go(q, k, v, o, vf, vt, part, tickets, layer, batch, nq, nkv, s_len,
            d, chunk, sm_scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. k/v point at the start of the cache
// (stacked or not); `layer` selects the layer of a stacked cache (0 for a
// single layer). `part`: f32 scratch of B * nkv * n_split * G * (d + 4)
// values, n_split = ceil(s_len / chunk); `tickets`: B * nkv zeroed
// unsigned ints, left zeroed. Returns the launch's cudaError_t.
extern "C" int decode_attention_fwd(int dtype, const void* q, const void* k,
                                    const void* v, void* o,
                                    const void* valid_from,
                                    const void* valid_to, void* part,
                                    void* tickets, int layer, int batch,
                                    int nq, int nkv, int s_len, int d,
                                    int chunk, float sm_scale, void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 != 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > kMaxG || layer < 0 || batch <= 0 || s_len <= 0 ||
      chunk <= 0 || chunk > kMaxChunk)
    return (int)cudaErrorInvalidValue;
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto* pp = static_cast<float*>(part);
  auto* tk = static_cast<unsigned*>(tickets);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, vf, vt, pp, tk, layer, batch, nq, nkv,
                         s_len, d, chunk, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, vf, vt, pp, tk, layer, batch, nq,
                                 nkv, s_len, d, chunk, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
