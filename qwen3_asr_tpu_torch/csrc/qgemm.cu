// The weight-only quantized product of more than 16 rows (kernel C) for
// Hopper (sm_90a), written by hand: the prefill's and the encoder's
// projections, and decode steps past 16 rows. No TPU kernel: JAX's `qdot`
// (qwen3_asr_tpu/ops/quant.py:134-182) runs in XLA, which fuses the
// payload's widening and the scales into the dot. On the card it stands in
// for `widened_product` (ops/qgemm.py), which wrote a bf16 copy of the
// whole payload every call and then ran cuBLAS. See ops/qgemm.py for the
// contract and for the plan (`qgemm_plan`) this kernel is launched with:
//
//   out[m, n] = round_out((sum_k bf16 x[m, k] * widen(q[n, k])) * s[n])
//
// for int8 and e4m3 payloads [N, K] with one scale a column, and for int4
// pairs [N, K/2] (byte j holds k = j and k = j + K/2, biased by 8) with G
// groups of scales along K [N, G]:
//
//   out[m, n] = round_out(sum_g (sum_{k in g} x[m, k] * (nib - 8)) * s[n, g])
//
// f32 sums, one rounding to the output's dtype (bf16, or f32 for logits).
//
// What bounds it: at the prefill's 453 rows and more, the tensor cores
// (w_down at 453 rows: 11.4 GFLOP against 12.6 MB of int8 payload); at the
// lm_head's 32 rows, the payload's bytes. The design:
// - A block is a producer warpgroup and two consumer warpgroups. It owns
//   an output tile of 128 payload rows (output columns; 64 a consumer
//   warpgroup) by BM = 64, 128 or 256 rows of x, of one of up to three
//   payloads that share x (q, k and v; gate and up: one launch, the tiles
//   of all), and one split of K.
// - K goes in steps of 64 payload bytes (int4: the steps of the row's
//   first half, on the low nibbles, then those of its second half, on the
//   high nibbles, so step i is k [64 i, 64 i + 64) wherever K/2 is a
//   multiple of 64). One thread of the producer keeps TMA loads in flight
//   through a ring of kStages stages: x's box [BM rows][64 k] as x lies
//   (128-byte swizzle, the K-major layout wgmma reads; rows past M and k
//   past K land as zeros) and the payload tile [128 rows][64 bytes]; each
//   stage completes on its `full` mbarrier.
// - Each consumer warpgroup widens its 64 payload rows of the stage
//   (in registers, while its previous step's products run) into a
//   bf16 tile in shared memory (canonical 128-byte swizzle; two buffers,
//   alternating by step), then runs four wgmma m64nBMk16 with both
//   operands from shared memory: D[64 payload rows x BM rows of x] +=
//   A[64 x 16] (the widened payload) * B[16 x BM] (x). No register feeds a
//   wgmma but its accumulator, so the products pipeline: a warpgroup
//   commits step st with step st - 1's products still in flight, then
//   waits for step st - 1 (wgmma_wait<1>) only to give its stage back, so
//   the producer runs kStages - 1 steps ahead; the widened buffer step
//   st + 1 rewrites is st - 1's.
//   (Widening in three warps of their own beside two warpgroups that only
//   multiply, and two steps a consumer iteration, were measured slower on
//   the H100: PERF.md.)
// - int4 groups: a group's sum goes into its own accumulator, started by
//   its first product with scale-d 0 (no register zeroing), and is added
//   into the f32 sum times its column's group scale when the next group
//   starts (which waits for the group's last step: the one wait that is
//   not for a buffer). The rule, as kernel A's: K/2 and the group size are
//   multiples of 64 (or there is one group), so a step lies in one group
//   and a split (the plan's) starts on a group boundary.
// - Split K (the plan's): each split of an output tile writes its f32
//   partial (int4 group scales applied) to scratch; the last block of the
//   tile to take its ticket adds the splits in split order and resets the
//   ticket. One launch a call, no float atomics: the same bits on every
//   run and under CUDA-graph replay.
// - The epilogue stages D through shared memory as the transpose it is
//   (out [M, N] holds x rows), scaled (one scale a column) and rounded
//   once, then writes whole 16-byte pieces of out's rows.
//
// The ring's invariant (a stage is overwritten only once both warpgroups
// are done with it): a consumer warp arrives on the stage's `empty`
// mbarrier (8 arrivals: every warp of both warpgroups) only after its
// wgmma_wait<1> has retired the step that read the stage's x, and the
// producer waits on `empty` before it loads the stage again. Likewise a
// widened buffer is rewritten only after a barrier of the warpgroup that
// every warp reaches after its wait has retired the buffer's last reader. wgmma reads
// x and the widened tile asynchronously, and a wait retires only the
// thread's own warpgroup's products, so no warpgroup may release for the
// other.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"
#include "widen.cuh"
#include "wgmma.cuh"

namespace {

using widen::Fp8E4M3;
using widen::Nib4;
using widen::Nib4G;
using widen::Payload;
using widen::word;

constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kBN = 128;                   // payload rows a block
constexpr int kStep = 64;                  // payload bytes of a row a step
constexpr int kPayBytes = kBN * kStep;     // 8 KB
constexpr int kRowBytes = 128;             // x's (or the widened) 64 k
constexpr int kWideBytes = 64 * kRowBytes;  // a warpgroup's widened tile
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kMaxGroup = 3;               // payloads sharing one x

// the ring's depth by x width (ops/qgemm.py STAGES)
template <int kBM>
constexpr int kStages = kBM == 256 ? 4 : kBM == 128 ? 6 : 8;
template <int kBM>
constexpr int kXBytes = kBM * kRowBytes;
template <int kBM>
constexpr int kSlotBytes = kXBytes<kBM> + kPayBytes;
template <int kBM>
constexpr int kRingBytes = kStages<kBM> * kSlotBytes<kBM>;
// shared memory: the ring, then two widened buffers a warpgroup (all
// 1024-byte aligned); the epilogue reuses the ring
template <int kBM>
constexpr int kSmem = kRingBytes<kBM> + 2 * 2 * kWideBytes + 1024;
// the epilogue's staged tile: BM rows of 128 outputs, 16 bytes of padding
// a row (conflict-free transposed writes)
__host__ __device__ constexpr int stage_row(int esize) {
  return kBN * esize + 16;
}
static_assert(256 * stage_row(4) <= kRingBytes<256>, "staging");
static_assert(128 * stage_row(4) <= kRingBytes<128>, "staging");
static_assert(64 * stage_row(4) <= kRingBytes<64>, "staging");

struct Args {
  const void* ss[kMaxGroup];  // scales [n, ngroups]
  void* os[kMaxGroup];        // outputs [m, n]
  int ns[kMaxGroup];
  int tile0[kMaxGroup + 1];   // first column tile of each payload
  int m;
  int kb;                     // payload bytes a row: k, or k / 2
  int half_steps;             // steps of kb
  int steps;                  // of K: half_steps, or twice that for int4
  int ngroups, gsize;         // int4 scale groups, k a group
  int row_tiles, splits, per_split;
  int s_bf16, out_bf16;
  float* part;                // [tiles][row_tiles][splits][128 * BM]
  unsigned* tickets;          // [tiles * row_tiles], zero between calls
};

__device__ __forceinline__ float scale_at(const Args& a, int pi, size_t i) {
  return a.s_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(a.ss[pi])[i])
                  : static_cast<const float*>(a.ss[pi])[i];
}

// D[64 x BM] (+)= A * B, both from shared memory.
template <int kBM>
__device__ __forceinline__ void wgmma_ss(float (&d)[kBM / 2], uint64_t da,
                                         uint64_t db, int scale_d);
template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da,
                                             uint64_t db, int scale_d) {
  sm90::wgmma_ss_m64n64k16(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  sm90::wgmma_ss_m64n128k16(d, da, db, scale_d);
}
template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t da,
                                              uint64_t db, int scale_d) {
  sm90::wgmma_ss_m64n256k16(d, da, db, scale_d);
}

// Eight words of bf16 pairs (16 consecutive k) from 16 payload bytes:
// one value a byte, or the low (h = 0) or high (h = 1) nibbles.
template <typename W>
__device__ __forceinline__ void widen16(const uint4& raw, int h,
                                        uint32_t (&w)[8]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const uint32_t b = word(raw, q);
    if constexpr (Payload<W>::kNibbles) {
      if (h == 0)
        widen::widen_nib_lo(b, w[2 * q], w[2 * q + 1]);
      else
        widen::widen_nib_hi(b, w[2 * q], w[2 * q + 1]);
    } else {
      widen::widen_bytes<W>(b, w[2 * q], w[2 * q + 1]);
    }
  }
}

// The per-thread state of a consumer.
struct Consumer {
  int wg, ct, warp, lane;
  int pr[2];        // this thread's payload rows (D's rows) in the tile
};

// int4 groups: a group's finished sum times its columns' scales, into the
// f32 sum. p[4 q + 2 r + e] is payload row pr[r].
template <int kBM>
__device__ __forceinline__ void add_group_sum(float (&c)[kBM / 2],
                                              float (&p)[kBM / 2],
                                              const float (&sc)[2]) {
  sm90::fence_regs(p);
#pragma unroll
  for (int x = 0; x < kBM / 2; ++x) c[x] += p[x] * sc[(x >> 1) & 1];
}

// Step l (of the block's split; i = s0 + l of K) of a consumer warpgroup:
// wait for its stage; read and widen this thread's two 16-byte pieces of
// the payload tile (rows ct / 4 and ct / 4 + 32 of the warpgroup's 64,
// bytes [16 (ct % 4), +16)); once every warp of the warpgroup has retired
// step l - 2 (the previous step's wait), store them into widened buffer
// l % 2; then the four products into `c` (one scale a column) or, for
// int4 groups, into the group's sum `p` (a step that starts a group first
// waits for the previous step, adds the previous group's sum times its
// scales into `c` and starts `p` afresh: scale-d 0); commit, wait until
// step l - 1 has retired and give its stage back.
template <typename W, int kBM>
__device__ __forceinline__ void step(
    const Args& a, const Consumer& t, int l, int i, int n0,
    unsigned char* ring, unsigned char* wide, uint64_t* full,
    uint64_t* empty, float (&c)[kBM / 2], float (&p)[kBM / 2],
    float (&sc)[2], int& group, int pi) {
  constexpr int kS = kStages<kBM>;
  constexpr bool kGrouped = Payload<W>::kGrouped;
  const int slot = l % kS;
  sm90::mbar_wait(&full[slot], (l / kS) & 1);
  const unsigned char* xs = ring + slot * kSlotBytes<kBM>;
  const unsigned char* pay = xs + kXBytes<kBM>;
  const int h = Payload<W>::kNibbles && i >= a.half_steps ? 1 : 0;
  const int j = i - h * a.half_steps;
  const int row = t.ct >> 2, piece = t.ct & 3;
  uint4 raw[2];
#pragma unroll
  for (int v = 0; v < 2; ++v)
    raw[v] = *reinterpret_cast<const uint4*>(
        pay + (64 * t.wg + row + 32 * v) * kStep + 16 * piece);
  // int4 rows whose bytes end inside the step: the pieces past them are
  // zero bytes, which widen to -8, and the x they meet is the row's other
  // half: they must multiply as zeros
  const bool live = !Payload<W>::kNibbles || j * kStep + 16 * piece < a.kb;
  // widened in registers while step l - 1's products run
  uint32_t w[2][8];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    widen16<W>(raw[v], h, w[v]);
    if (!live) {
#pragma unroll
      for (int e = 0; e < 8; ++e) w[v][e] = 0u;
    }
  }

  // every warp has retired step l - 2, which read buffer l % 2
  sm90::named_bar_sync(2 + t.wg, 128);

  unsigned char* wb = wide + (l & 1) * kWideBytes;
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int r = row + 32 * v;
    unsigned char* dst = wb + r * kRowBytes;
    *reinterpret_cast<uint4*>(dst + (((2 * piece) ^ (r & 7)) << 4)) =
        make_uint4(w[v][0], w[v][1], w[v][2], w[v][3]);
    *reinterpret_cast<uint4*>(dst + (((2 * piece + 1) ^ (r & 7)) << 4)) =
        make_uint4(w[v][4], w[v][5], w[v][6], w[v][7]);
  }
  sm90::fence_async_shared();
  sm90::named_bar_sync(2 + t.wg, 128);   // the widened tile is complete

  bool fresh = l == 0;        // the products start their sum afresh
  if constexpr (kGrouped) {
    const int grp = (h * a.kb + j * kStep) / a.gsize;
    if (grp != group) {
      if (l > 0) {
        sm90::wgmma_wait<0>();  // the previous group's last step
        add_group_sum<kBM>(c, p, sc);
      }
      group = grp;
      fresh = true;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int col = n0 + t.pr[r];
        sc[r] = col < a.ns[pi]
                    ? scale_at(a, pi, (size_t)col * a.ngroups + grp)
                    : 0.f;
      }
    }
  }
  const uint32_t xa = sm90::smem_u32(xs), wa = sm90::smem_u32(wb);
  sm90::wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t da = sm90::desc_sw128(wa + 32 * kk, 16, 1024);
    const uint64_t db = sm90::desc_sw128(xa + 32 * kk, 16, 1024);
    if constexpr (kGrouped)
      wgmma_ss<kBM>(p, da, db, !fresh || kk > 0);
    else
      wgmma_ss<kBM>(c, da, db, !fresh || kk > 0);
  }
  sm90::wgmma_commit();
  // step l - 1 retired: its stage goes back to the producer
  sm90::wgmma_wait<1>();
  if (l >= 1 && t.lane == 0) sm90::mbar_arrive(&empty[(l - 1) % kS]);
}

// Grid: tiles * row_tiles * splits blocks (ops/qgemm.py QgemmPlan).
template <typename W, int kBM>
__global__ void __launch_bounds__(kThreads, 1)
    qgemm_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap pmap0,
                 const __grid_constant__ CUtensorMap pmap1,
                 const __grid_constant__ CUtensorMap pmap2, const Args a) {
  constexpr int kS = kStages<kBM>;
  constexpr bool kGrouped = Payload<W>::kGrouped;
  __shared__ __align__(8) uint64_t full[kS], empty[kS];
  __shared__ int last_s;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* wide = ring + kRingBytes<kBM>;

  const int bx = blockIdx.x;
  const int rt = bx % a.row_tiles, rest = bx / a.row_tiles;
  const int split = rest % a.splits, tile = rest / a.splits;
  const int pi = tile >= a.tile0[2] ? 2 : tile >= a.tile0[1] ? 1 : 0;
  const int n0 = (tile - a.tile0[pi]) * kBN, m0 = rt * kBM;
  const int s0 = split * a.per_split;
  const int n_steps = min(a.per_split, a.steps - s0);
  const int tid = threadIdx.x;

  const CUtensorMap* pmap = pi == 2 ? &pmap2 : pi == 1 ? &pmap1 : &pmap0;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 8);     // every consumer warp
    }
  } else if (tid == kConsumers) {
    sm90::prefetch_tensor_map(&xmap);
    sm90::prefetch_tensor_map(pmap);
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // the producer warpgroup: one thread keeps the ring full
    sm90::setmaxnreg_dec<kProducerRegs>();
    if (tid == kConsumers) {
      for (int l = 0; l < n_steps; ++l) {
        const int slot = l % kS;
        if (l >= kS) sm90::mbar_wait(&empty[slot], ((l / kS) - 1) & 1);
        const int i = s0 + l;
        const int h = Payload<W>::kNibbles && i >= a.half_steps ? 1 : 0;
        const int j = i - h * a.half_steps;
        unsigned char* xs = ring + slot * kSlotBytes<kBM>;
        sm90::mbar_expect_tx(&full[slot], kSlotBytes<kBM>);
        sm90::tma_load_2d(xs, &xmap, h * a.kb + j * kStep, m0, &full[slot]);
        sm90::tma_load_2d(xs + kXBytes<kBM>, pmap, j * kStep, n0,
                          &full[slot]);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<kConsumerRegs>();
  Consumer t;
  t.wg = tid >> 7;
  t.ct = tid & 127;
  t.warp = t.ct >> 5;
  t.lane = tid & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r)
    t.pr[r] = 64 * t.wg + 16 * t.warp + (t.lane >> 2) + 8 * r;
  unsigned char* my_wide = wide + t.wg * 2 * kWideBytes;

  float c[kBM / 2];
  float p[kBM / 2];          // int4 groups: the current group's sum
  float sc[2] = {};          // and its scales
  int group = -1;
  if constexpr (kGrouped) {
#pragma unroll
    for (int x = 0; x < kBM / 2; ++x) c[x] = 0.f;
  }
  for (int l = 0; l < n_steps; ++l)
    step<W, kBM>(a, t, l, s0 + l, n0, ring, my_wide, full, empty, c, p, sc,
                 group, pi);
  // the epilogue's scales (one a column), loaded while the last products
  // run
  float scale[2] = {1.f, 1.f};
  if constexpr (!kGrouped) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int col = n0 + t.pr[r];
      scale[r] = col < a.ns[pi] ? scale_at(a, pi, col) : 0.f;
    }
  }
  sm90::wgmma_wait<0>();
  if constexpr (kGrouped)
    add_group_sum<kBM>(c, p, sc);   // the last group's sum
  else
    sm90::fence_regs(c);
  // both warpgroups' products are done: the ring is free for the epilogue
  sm90::named_bar_sync(1, kConsumers);

  if (a.splits > 1) {
    // this split's partial, then the tile's ticket; the last block adds
    // the splits in split order (c[4 q .. 4 q + 3] at float4 q of thread
    // tid: coalesced, and each thread reads back what its counterparts
    // wrote)
    const size_t tile_rc = (size_t)tile * a.row_tiles + rt;
    float4* part = reinterpret_cast<float4*>(
        a.part + (tile_rc * a.splits + split) * (kBN * kBM));
#pragma unroll
    for (int q = 0; q < kBM / 8; ++q)
      __stcg(part + q * kConsumers + tid,
             make_float4(c[4 * q], c[4 * q + 1], c[4 * q + 2], c[4 * q + 3]));
    sm90::named_bar_sync(1, kConsumers);
    if (tid == 0)
      last_s = sm90::atomic_add_acq_rel(&a.tickets[tile_rc], 1u) ==
               (unsigned)(a.splits - 1);
    sm90::named_bar_sync(1, kConsumers);
    if (!last_s) return;
    // four float4s at a time, split by split (their loads in flight
    // together, and few registers beside c); c = ((p0 + p1) + p2) ...: the
    // same order whichever block is last
    const float4* all = reinterpret_cast<const float4*>(
        a.part + tile_rc * a.splits * (kBN * kBM)) + tid;
#pragma unroll
    for (int q0 = 0; q0 < kBM / 8; q0 += 4) {
      for (int sp = 0; sp < a.splits; ++sp) {
        const float4* src = all + (size_t)sp * (kBN * kBM / 4);
#pragma unroll
        for (int q = q0; q < q0 + 4; ++q) {
          const float4 u = __ldcg(src + q * kConsumers);
          if (sp == 0) {
            c[4 * q] = u.x;
            c[4 * q + 1] = u.y;
            c[4 * q + 2] = u.z;
            c[4 * q + 3] = u.w;
          } else {
            c[4 * q] += u.x;
            c[4 * q + 1] += u.y;
            c[4 * q + 2] += u.z;
            c[4 * q + 3] += u.w;
          }
        }
      }
    }
    if (tid == 0) a.tickets[tile_rc] = 0u;
  }

  // epilogue: c[4 q + 2 r + e] is output column n0 + pr[r] of row
  // m0 + 8 q + 2 (lane % 4) + e; scaled, rounded and staged as out's rows
  const int esize = a.out_bf16 ? 2 : 4;
  const int rs = stage_row(esize);
  unsigned char* staged = ring;
  const int tq = t.lane & 3;
#pragma unroll
  for (int q = 0; q < kBM / 8; ++q)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = c[4 * q + 2 * r + e] * scale[r];
        unsigned char* dst = staged + (8 * q + 2 * tq + e) * rs;
        if (a.out_bf16)
          reinterpret_cast<__nv_bfloat16*>(dst)[t.pr[r]] =
              __float2bfloat16(v);
        else
          reinterpret_cast<float*>(dst)[t.pr[r]] = v;
      }
  sm90::named_bar_sync(1, kConsumers);
  const int n = a.ns[pi];
  const int per = 16 / esize;                // outputs a 16-byte piece
  const int pieces = kBN / per;              // a staged row's
  const bool whole = (n * esize) % 16 == 0;  // every piece 16-byte aligned
  unsigned char* out = static_cast<unsigned char*>(a.os[pi]);
  for (int idx = tid; idx < kBM * pieces; idx += kConsumers) {
    const int mr = idx / pieces, pc = idx % pieces;
    const int row = m0 + mr, col = n0 + pc * per;
    if (row >= a.m || col >= n) continue;
    const unsigned char* src = staged + mr * rs + 16 * pc;
    unsigned char* dst = out + ((size_t)row * n + col) * esize;
    if (whole) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
      for (int e = 0; e < per && col + e < n; ++e)
        for (int b = 0; b < esize; ++b) dst[e * esize + b] = src[e * esize + b];
    }
  }
}

// x [m, k] bf16: boxes of 64 k x BM rows, 128-byte swizzle; q [n, kb]
// bytes: boxes of 64 bytes x 128 rows. Out of range reads as zeros.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType type, int esize,
               const void* base, int inner, int outer, int box_inner,
               int box_outer, CUtensorMapSwizzle swizzle) {
  const sm90::EncodeTiled encode = sm90::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * esize};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename W, int kBM>
int launch_bm(const Args& a, const void* x, const unsigned char* const* q,
              int count, int k, int blocks, cudaStream_t st) {
  static bool done[sm90::kMaxDevices] = {};
  const cudaError_t err =
      sm90::max_smem(qgemm_kernel<W, kBM>, kSmem<kBM>, done);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap, pmap[kMaxGroup];
  if (!encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, k, a.m, 64,
                 kBM, CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < kMaxGroup; ++i) {
    const int at = i < count ? i : 0;
    if (!encode_2d(&pmap[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q[at], a.kb,
                   a.ns[at], kStep, kBN, CU_TENSOR_MAP_SWIZZLE_NONE))
      return (int)cudaErrorInvalidValue;
  }
  qgemm_kernel<W, kBM><<<blocks, kThreads, kSmem<kBM>, st>>>(
      xmap, pmap[0], pmap[1], pmap[2], a);
  return (int)cudaGetLastError();
}

template <typename W>
int launch(const Args& a, const void* x, const unsigned char* const* q,
           int count, int k, int bm, int blocks, cudaStream_t st) {
  if (bm == 64) return launch_bm<W, 64>(a, x, q, count, k, blocks, st);
  if (bm == 128) return launch_bm<W, 128>(a, x, q, count, k, blocks, st);
  if constexpr (!Payload<W>::kGrouped) {   // two sum sets: 128 rows at most
    if (bm == 256) return launch_bm<W, 256>(a, x, q, count, k, blocks, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// w_dtype: 0 = int8, 1 = float8_e4m3fn, 2 = int4 (uint8 pairs); s_dtype /
// out_dtype: 0 = float32, 1 = bfloat16. x [m, k] bf16; `count` (1..3)
// payloads q[i] [n[i], k] (int4: [n[i], k / 2]) with scales s[i]
// [n[i], ngroups] (ngroups 1 but for int4) and outputs out[i] [m, n[i]],
// all contiguous, x and every q 16-byte aligned; k a multiple of 16 (int4:
// of 32; with ngroups > 1, k / 2 and k / ngroups multiples of 64). The
// plan (ops/qgemm.py qgemm_plan): bm rows of x a block (64, 128, or 256
// but with int4 groups), `splits` splits of `per_split` steps of K; with
// splits > 1, `part` holds blocks * 128 * bm f32 and `tickets` one zeroed
// slot per output tile. One launch for all. Returns the launch's
// cudaError_t.
extern "C" int qgemm_fwd(int w_dtype, int s_dtype, int out_dtype, int count,
                         const void* x, const void* const* q,
                         const void* const* s, void* const* out,
                         const int* n, int m, int k, int ngroups, int bm,
                         int splits, int per_split, void* part,
                         void* tickets, void* stream) {
  if (count < 1 || count > kMaxGroup || m <= 0 || k <= 0 || k % 16 != 0 ||
      ngroups <= 0 || s_dtype < 0 || s_dtype > 1 || out_dtype < 0 ||
      out_dtype > 1 || w_dtype < 0 || w_dtype > 2 ||
      (bm != 64 && bm != 128 && bm != 256) || splits <= 0 ||
      per_split <= 0 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  const bool nib = w_dtype == 2;
  if (nib ? (k % 32 != 0 || k % ngroups != 0 ||
             (ngroups > 1 &&
              ((k / 2) % kStep || (k / ngroups) % kStep || bm > 128)))
          : ngroups != 1)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  const unsigned char* qs[kMaxGroup] = {};
  int tiles = 0;
  for (int i = 0; i < kMaxGroup; ++i) {
    a.tile0[i] = tiles;
    if (i < count) {
      if (n[i] <= 0) return (int)cudaErrorInvalidValue;
      qs[i] = static_cast<const unsigned char*>(q[i]);
      a.ss[i] = s[i];
      a.os[i] = out[i];
      a.ns[i] = n[i];
      tiles += (n[i] + kBN - 1) / kBN;
    }
  }
  a.tile0[kMaxGroup] = tiles;
  a.m = m;
  a.kb = nib ? k / 2 : k;
  a.half_steps = (a.kb + kStep - 1) / kStep;
  a.steps = nib ? 2 * a.half_steps : a.half_steps;
  a.ngroups = ngroups;
  a.gsize = k / ngroups;
  a.row_tiles = (m + bm - 1) / bm;
  a.splits = splits;
  a.per_split = per_split;
  a.s_bf16 = s_dtype;
  a.out_bf16 = out_dtype;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned*>(tickets);
  // the splits cover the steps, none empty
  if ((long long)per_split * splits < a.steps ||
      (long long)per_split * (splits - 1) >= a.steps)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (long long)tiles * a.row_tiles * splits;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0)
    return launch<int8_t>(a, x, qs, count, k, bm, (int)blocks, st);
  if (w_dtype == 1)
    return launch<Fp8E4M3>(a, x, qs, count, k, bm, (int)blocks, st);
  if (ngroups > 1)
    return launch<Nib4G>(a, x, qs, count, k, bm, (int)blocks, st);
  return launch<Nib4>(a, x, qs, count, k, bm, (int)blocks, st);
}
