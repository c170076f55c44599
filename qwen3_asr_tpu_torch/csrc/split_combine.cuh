// The end of a decode kernel that splits the cache length S across blocks
// (csrc/decode_attention.cu, csrc/decode_attention_batch.cu): each block
// has written one partial softmax state per chunk it read, and the last
// block of a (row, KV head) to take a ticket combines them.
//
// Partials: one record of d + 4 f32 per (row, KV head, chunk, query head),
// [B * nkv][n_split][G][m, l, -, -, acc[d]], so the chunks of a (row, KV
// head) that hold a live key are one contiguous, 16-byte aligned span. Only
// those chunks write a record; every block derives the same span from
// [valid_from, valid_to).
//
// The ticket is an acq_rel atomic after a __syncthreads(): it publishes the
// whole block's partials, and in the last block it orders the reads below
// after every other block's writes. The last block copies the live span
// into shared memory with one bulk copy per round (as many records as the
// staging holds; each record's weight goes into its spare slot), folds
// each round into a running m, l and acc in split order (so the output is
// the same bits on every run and under CUDA-graph replay), writes acc / l
// (0 for a row with no live key) and resets the ticket to 0. Every thread
// fences its shared-memory writes against the async proxy before the
// barrier that precedes a copy into the same bytes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace split {

constexpr int kMaxG = 8;          // query heads per KV head

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Called by every thread of every block, after the block's partials are
// written. `n_blocks`: blocks that share the ticket `tickets[bh]`; `chunk`:
// keys per split; `staged`: `staged_bytes` of 16-byte aligned shared memory
// that no copy is still writing. kG >= group sizes the registers.
template <typename Out, int kThreads, int kG>
__device__ void ticket_and_combine(const float* __restrict__ part,
                                   unsigned* __restrict__ tickets,
                                   Out* __restrict__ o, size_t bh, int b,
                                   int h, int nq, int group, int d,
                                   int n_blocks, int n_split, int chunk,
                                   int lo_all, int hi_all, float* staged,
                                   int staged_bytes) {
  constexpr int kWarps = kThreads / 32;
  __shared__ __align__(8) uint64_t bar;
  __shared__ float m_s[kMaxG], l_s[kMaxG], scale_s[kMaxG];
  __shared__ int last_s;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  sm90::fence_async_shared();   // the caller's writes to `staged`
  __syncthreads();
  if (tid == 0)
    last_s = sm90::atomic_add_acq_rel(&tickets[bh], 1u) ==
             (unsigned)(n_blocks - 1);
  __syncthreads();
  if (!last_s) return;

  const int rec = d + 4;
  const int j0 = lo_all / chunk;
  const int n_live_split =
      lo_all < hi_all ? (hi_all + chunk - 1) / chunk - j0 : 0;
  const int per_round = staged_bytes / (int)(sizeof(float) * group * rec);
  const float* span = part + (bh * n_split + j0) * group * rec;
  if (tid == 0) {
    sm90::mbar_init(&bar, 1);
    // the other blocks' records, written through the generic proxy, are
    // read by the bulk copy's async proxy
    asm volatile("fence.proxy.async.global;\n" ::: "memory");
  }
  if (tid < group) {
    m_s[tid] = sm90::kMaskValue;
    l_s[tid] = 0.f;
  }
  __syncthreads();
  const int n_out = group * d;
  float acc[kG];
#pragma unroll
  for (int x = 0; x < kG; ++x) acc[x] = 0.f;
  for (int s0 = 0, round = 0; s0 < n_live_split; s0 += per_round, ++round) {
    const int cnt = min(per_round, n_live_split - s0);
    if (tid == 0) {
      const uint32_t bytes = (uint32_t)(cnt * group * rec * sizeof(float));
      sm90::mbar_expect_tx(&bar, bytes);
      sm90::bulk_load(staged, span + (size_t)s0 * group * rec, bytes, &bar);
    }
    sm90::mbar_wait(&bar, round & 1);
    for (int g = warp; g < group; g += kWarps) {
      float m_r = sm90::kMaskValue;
      for (int s = lane; s < cnt; s += 32)
        m_r = fmaxf(m_r, staged[(s * group + g) * rec]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        m_r = fmaxf(m_r, __shfl_xor_sync(0xffffffffu, m_r, off));
      const float m_new = fmaxf(m_s[g], m_r);
      float l_r = 0.f;
      for (int s = lane; s < cnt; s += 32) {
        float* r = staged + (s * group + g) * rec;
        const float w = expf(r[0] - m_new);
        r[2] = w;                     // the record's spare slot
        l_r = fmaf(r[1], w, l_r);
      }
      sm90::fence_async_shared();
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
        const float* w = staged + g * rec + 2;
        const float* col = w + 2 + (i - g * d);
        float a = acc[x] * scale_s[g];
        for (int s = 0; s < cnt; ++s)
          a = fmaf(col[(size_t)s * group * rec], w[(size_t)s * group * rec],
                   a);
        acc[x] = a;
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
            acc[x] / l);
    }
  }
  if (tid == 0) tickets[bh] = 0u;
}

}  // namespace split
