// The weight-only quantized product of decode rows for Hopper (sm_90a),
// written by hand. No TPU kernel: JAX's `qdot` (qwen3_asr_tpu/ops/quant.py)
// runs in XLA. See qwen3_asr_tpu_torch/ops/qgemv.py for the contract and
// the plan (`plan`) this kernel is launched with:
//
//   out[m, n] = round_out((sum_k bf16 x[m, k] * widen(q[n, k])) * s[n])
//
// with the payload q int8 or e4m3 stored [N, K] (widened exactly to bf16),
// the sum in f32, and one rounding to the output's dtype (bf16, or f32 for
// the logits). An int4 payload (two nibbles a byte, [N, K/2]) with G
// groups of scales along K takes
//
//   out[m, n] = round_out(sum_g (sum_{k in g} x[m, k] * (nib(q, n, k) - 8))
//                         * s[n, g])
//
// (G = 1 is the formula above). One launch takes up to three payloads that
// share x (q, k and v; gate and up) and writes one output each.
//
// What bounds it: the payload's bytes, read once (M <= 16 rows make about
// 16 FLOP a byte, far below the card's ridge). The design:
// - Tensor cores: mma.sync m16n8k16, bf16 in, f32 accumulators. The A
//   operand is the payload (16 output columns x 16 k), widened in
//   registers straight from 16-byte loads (csrc/widen.cuh); B is x (16 k
//   x 8 rows, rows past M zero; M > 8 takes a second 8-row tile).
// - k is permuted inside each "stretch" of 64 payload bytes the same way
//   in both operands: lane (g = lane / 4, t = lane % 4) loads bytes
//   [16 t, 16 t + 16) of the stretch from payload rows g and g + 8, and
//   mma j (0..3) takes their word j, i.e. k = 16 t + 4 j + {0, 1} into the
//   fragment's slots for k = 2 t + {0, 1} and k = 16 t + 4 j + {2, 3} into
//   those for 2 t + 8 + {0, 1}. The lane's x fragment is then
//   x[g][16 t, 16 t + 16), 32 contiguous bytes, words 2 j and 2 j + 1 for
//   mma j: no shared-memory transpose of either operand.
// - int4: byte b of a row holds k = b and k = K/2 + b, so a stretch of 64
//   bytes at byte s0 is two stretches of 64 k: [s0, s0 + 64) from the low
//   nibbles and [K/2 + s0, K/2 + s0 + 64) from the high ones, each mapped
//   to lanes as above. The lane's x comes from two places in the row,
//   x[g][s0 + 16 t, +16) and x[g][K/2 + s0 + 16 t, +16), and one payload
//   word feeds two mmas (8 a stretch). Group scales run along K, so they
//   cannot wait for the epilogue: each half-stretch's sum is taken in a
//   fresh accumulator fragment and added into the running f32 sum times
//   the scale of its column (rows g and g + 8 of the fragment: c[0..1]
//   and c[2..3]) and group. The rule this relies on: each half-stretch
//   lies in one group, i.e. the group size and K/2 are multiples of 64
//   (or there is one group); the wrapper raises, and the loader refuses,
//   elsewhere. A warp holds half as many stretches of int4 as of int8 (2,
//   or 6 with one fragment set): the same k, the same x registers.
// - A block is 8 warps on one K slice (the plan's split); each warp holds
//   the x fragments of its part of the slice in registers (up to 4
//   stretches, loaded once) and walks every column tile of the block's
//   column group with them, the next tile's payload loads issued before
//   the current tile's products (8-16 loads of 16 bytes a lane in
//   flight). A block with one tile and up to 8 rows may instead take 12
//   stretches a warp (K = 6144 unsplit, one fragment set: 24 loads a lane
//   in flight). The 8 warps' sums of a tile are added in shared memory in
//   warp order.
// - Split K: with one split the block scales, rounds and writes the tile;
//   with more, each split writes f32 partials (int4's group scales already
//   applied) to scratch and the last block of a column group to take its
//   ticket adds the splits in split order, scales, rounds, writes and
//   resets the ticket. No float atomics: the output is the same bits on
//   every run and under CUDA-graph replay.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"
#include "widen.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;
constexpr int kMaxGroup = 3;            // payloads sharing one x
constexpr int kTile = 16;               // output columns of a tile
constexpr int kStretch = 64;            // payload bytes of one stretch

using widen::Fp8E4M3;
using widen::Nib4;
using widen::Nib4G;
using widen::Payload;
using widen::mma_bf16;
using widen::word;

// A payload read once: not kept in L1; L2 fetches 256 bytes a miss.
__device__ __forceinline__ uint4 load_stream(const void* p) {
  uint4 v;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

struct Args {
  const __nv_bfloat16* x;               // [m, k]
  const unsigned char* q[kMaxGroup];    // [n_i, kb]
  const void* s[kMaxGroup];             // [n_i, ngroups]
  void* o[kMaxGroup];                   // [m, n_i]
  int n[kMaxGroup];
  int tile0[kMaxGroup + 1];             // first column tile of each payload
  int m, k;
  int kb;                               // payload bytes a row: k or k / 2
  int ngroups, gsize;                   // int4 scale groups, k a group
  int stretches, per_split, kw;         // stretches of kb, of a split, a warp
  int splits, groups, tiles;
  int s_bf16, out_bf16;
  float* part;                          // [splits][m][tiles * kTile]
  unsigned* tickets;                    // [groups], zero between calls
};

__device__ __forceinline__ int payload_of(const Args& a, int tile) {
  return tile >= a.tile0[2] ? 2 : tile >= a.tile0[1] ? 1 : 0;
}

// Scale i of payload p's scales.
__device__ __forceinline__ float scale_at(const Args& a, int p, size_t i) {
  return a.s_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(a.s[p])[i])
                  : static_cast<const float*>(a.s[p])[i];
}

// The scale the epilogue applies to one column of payload p: 1 for group
// scales, which the K loop has applied.
template <typename W>
__device__ __forceinline__ float col_scale(const Args& a, int p, int col) {
  if constexpr (Payload<W>::kGrouped)
    return 1.f;
  else
    return scale_at(a, p, col);
}

// The scaled, rounded output of one column of payload p.
__device__ __forceinline__ void write_out(const Args& a, int p, int row,
                                          int col, float acc, float scale) {
  const size_t i = (size_t)row * a.n[p] + col;
  if (a.out_bf16)
    static_cast<__nv_bfloat16*>(a.o[p])[i] = __float2bfloat16(acc * scale);
  else
    static_cast<float*>(a.o[p])[i] = acc * scale;
}

// The scale this thread's output of a tile takes (one split): thread
// (row, column) of the tile's m x 16 outputs, read before the products so
// its latency hides behind them. 0 for a thread with no output.
template <typename W>
__device__ __forceinline__ float tile_scale(const Args& a, int tile) {
  if (a.splits != 1 || (int)threadIdx.x >= a.m * kTile) return 0.f;
  const int p = payload_of(a, tile);
  const int col = (tile - a.tile0[p]) * kTile + threadIdx.x % kTile;
  return col < a.n[p] ? col_scale<W>(a, p, col) : 0.f;
}

// The payload fragments of one tile for a warp: rows g and g + 8 of the
// tile, the lane's 16 bytes of each of the warp's stretches (zero past N
// or the row's bytes); with group scales, each stretch's four scales:
// rows g and g + 8, the group of its first and of its second half.
template <typename W, int kKS>
struct Frag {
  uint4 r0[kKS], r1[kKS];
  float sc[Payload<W>::kGrouped ? kKS : 1][4];
};

template <typename W, int kKS>
__device__ __forceinline__ void load_tile(const Args& a, int tile, int kbeg,
                                          int kend, int lane,
                                          Frag<W, kKS>& f) {
  const int p = payload_of(a, tile);
  const int col = (tile - a.tile0[p]) * kTile + (lane >> 2);
  const unsigned char* base = a.q[p] + (size_t)col * a.kb;
  const bool ok0 = col < a.n[p], ok1 = col + 8 < a.n[p];
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    const int k0 = kbeg + j * kStretch + 16 * (lane & 3);
    const bool in = k0 < kend;
    f.r0[j] = in && ok0 ? load_stream(base + k0) : make_uint4(0, 0, 0, 0);
    f.r1[j] = in && ok1 ? load_stream(base + (size_t)8 * a.kb + k0)
                        : make_uint4(0, 0, 0, 0);
    if constexpr (Payload<W>::kGrouped) {
      const int st = kbeg + j * kStretch;     // the stretch's first byte
      const bool live = st < kend;
      const size_t lo = st / a.gsize, hi = (a.kb + st) / a.gsize;
      const size_t r0 = (size_t)col * a.ngroups, r1 = r0 + 8 * a.ngroups;
      f.sc[j][0] = live && ok0 ? scale_at(a, p, r0 + lo) : 0.f;
      f.sc[j][1] = live && ok0 ? scale_at(a, p, r0 + hi) : 0.f;
      f.sc[j][2] = live && ok1 ? scale_at(a, p, r1 + lo) : 0.f;
      f.sc[j][3] = live && ok1 ? scale_at(a, p, r1 + hi) : 0.f;
    }
  }
}

// x words of mma j (0..3) from the lane's 16 x values [16 t, 16 t + 16).
__device__ __forceinline__ void x_words(const uint4* xv, int j,
                                        uint32_t& b0, uint32_t& b1) {
  const uint4& v = xv[j >> 1];
  b0 = (j & 1) ? v.z : v.x;
  b1 = (j & 1) ? v.w : v.y;
}

// x fragments of a stretch: [0..1] its (first) 64 k, [2..3] for int4 the
// 64 k of the row's second half.
template <typename W>
constexpr int kXWords = Payload<W>::kNibbles ? 4 : 2;

template <typename W, int kKS, int kNT>
__device__ __forceinline__ void tile_products(
    const Frag<W, kKS>& f, const uint4 (&xf)[kKS][kNT][kXWords<W>],
    float (&c)[kNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    if constexpr (!Payload<W>::kNibbles) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t lo0, hi0, lo1, hi1;
        widen::widen_bytes<W>(word(f.r0[j], q), lo0, hi0);
        widen::widen_bytes<W>(word(f.r1[j], q), lo1, hi1);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t b0, b1;
          x_words(xf[j][nt], q, b0, b1);
          mma_bf16(c[nt], lo0, lo1, hi0, hi1, b0, b1);
        }
      }
    } else {
      // the two halves into their own fragments where their groups'
      // scales apply after the stretch, else straight into the sum
      float pl[kNT][4], ph[kNT][4];
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) pl[nt][i] = ph[nt][i] = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t w0 = word(f.r0[j], q), w1 = word(f.r1[j], q);
        uint32_t lo0, hi0, lo1, hi1;
        widen::widen_nib_lo(w0, lo0, hi0);
        widen::widen_nib_lo(w1, lo1, hi1);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t b0, b1;
          x_words(xf[j][nt], q, b0, b1);
          if constexpr (Payload<W>::kGrouped)
            mma_bf16(pl[nt], lo0, lo1, hi0, hi1, b0, b1);
          else
            mma_bf16(c[nt], lo0, lo1, hi0, hi1, b0, b1);
        }
        widen::widen_nib_hi(w0, lo0, hi0);
        widen::widen_nib_hi(w1, lo1, hi1);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          uint32_t b0, b1;
          x_words(xf[j][nt] + 2, q, b0, b1);
          if constexpr (Payload<W>::kGrouped)
            mma_bf16(ph[nt], lo0, lo1, hi0, hi1, b0, b1);
          else
            mma_bf16(c[nt], lo0, lo1, hi0, hi1, b0, b1);
        }
      }
      if constexpr (Payload<W>::kGrouped) {
        // c[0..1]: column (payload row) g; c[2..3]: g + 8
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = (i >> 1) * 2;
            c[nt][i] += pl[nt][i] * f.sc[j][r] + ph[nt][i] * f.sc[j][r + 1];
          }
      }
    }
  }
}

// The block's sum of one tile: every warp's fragment into `red`, one
// barrier, then thread (row, column) adds the warps in order and either
// writes the output (one split) or its split's partial.
template <int kNT>
__device__ __forceinline__ void reduce_tile(const Args& a, int tile,
                                            int split,
                                            const float (&c)[kNT][4],
                                            float scale, float* red,
                                            int warp, int lane) {
  constexpr int kVals = kNT * 32 * 4;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      red[warp * kVals + (nt * 32 + lane) * 4 + i] = c[nt][i];
  __syncthreads();
  const int idx = threadIdx.x;          // a.m * kTile <= kThreads
  if (idx < a.m * kTile) {
    const int row = idx / kTile, colt = idx % kTile;
    // fragment slot of (row, colt): c[nt][i] of lane g * 4 + t
    const int nt = row >> 3, rr = row & 7;
    const int lane_s = (colt & 7) * 4 + (rr >> 1);
    const int i = (colt >> 3) * 2 + (rr & 1);
    const float* src = red + (nt * 32 + lane_s) * 4 + i;
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += src[w * kVals];
    if (a.splits == 1) {
      const int p = payload_of(a, tile);
      const int col = (tile - a.tile0[p]) * kTile + colt;
      if (col < a.n[p]) write_out(a, p, row, col, acc, scale);
    } else {
      a.part[((size_t)split * a.m + row) * (a.tiles * kTile) +
             tile * kTile + colt] = acc;
    }
  }
}

// Grid: groups * splits blocks; block b takes split b / groups of column
// group b % groups, i.e. tiles c, c + groups, c + 2 groups, ...
template <typename W, int kKS, int kNT>
__global__ void __launch_bounds__(kThreads)
qgemv_kernel(const Args a) {
  __shared__ __align__(16) float red[2][kWarps * kNT * 32 * 4];
  __shared__ int last_s;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = blockIdx.x % a.groups, split = blockIdx.x / a.groups;

  // this warp's range of payload bytes: stretches [s0, s1) of the split's
  const int sp0 = split * a.per_split;
  const int sp1 = min(sp0 + a.per_split, a.stretches);
  const int s0 = min(sp0 + warp * a.kw, sp1);
  const int s1 = min(s0 + a.kw, sp1);
  const int kbeg = s0 * kStretch, kend = min(s1 * kStretch, a.kb);

  // x fragments: rows g (+ 8 nt), k [16 t, 16 t + 16) of each stretch (and
  // of its second half for int4)
  uint4 xf[kKS][kNT][kXWords<W>];
#pragma unroll
  for (int j = 0; j < kKS; ++j)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int row = nt * 8 + (lane >> 2);
      const int k0 = kbeg + j * kStretch + 16 * (lane & 3);
      const bool in = row < a.m && k0 < kend;
#pragma unroll
      for (int h = 0; h < kXWords<W> / 2; ++h) {
        const uint4* src = reinterpret_cast<const uint4*>(
            a.x + (size_t)row * a.k + h * a.kb + k0);
        xf[j][nt][2 * h] = in ? __ldg(src) : make_uint4(0, 0, 0, 0);
        xf[j][nt][2 * h + 1] = in ? __ldg(src + 1) : make_uint4(0, 0, 0, 0);
      }
    }

  float c[kNT][4];
  if constexpr (kKS > 4) {
    // a long K slice a warp (one tile a block): one fragment set
    Frag<W, kKS> fa;
    int buf = 0;
    for (int tile = group; tile < a.tiles; tile += a.groups) {
      load_tile(a, tile, kbeg, kend, lane, fa);
      const float scale = tile_scale<W>(a, tile);
      tile_products<W, kKS, kNT>(fa, xf, c);
      reduce_tile<kNT>(a, tile, split, c, scale, red[buf], warp, lane);
      buf ^= 1;
    }
  } else {
    // tiles in pairs, two fragment sets: the next tile's loads in flight
    // while this one's products run
    Frag<W, kKS> fa, fb;
    int tile = group, buf = 0;
    if (tile < a.tiles) load_tile(a, tile, kbeg, kend, lane, fa);
    while (tile < a.tiles) {
      const int next = tile + a.groups;
      if (next < a.tiles) load_tile(a, next, kbeg, kend, lane, fb);
      float scale = tile_scale<W>(a, tile);
      tile_products<W, kKS, kNT>(fa, xf, c);
      reduce_tile<kNT>(a, tile, split, c, scale, red[buf], warp, lane);
      buf ^= 1;
      if (next >= a.tiles) break;
      const int after = next + a.groups;
      if (after < a.tiles) load_tile(a, after, kbeg, kend, lane, fa);
      scale = tile_scale<W>(a, next);
      tile_products<W, kKS, kNT>(fb, xf, c);
      reduce_tile<kNT>(a, next, split, c, scale, red[buf], warp, lane);
      buf ^= 1;
      tile = after;
    }
  }
  if (a.splits == 1) return;

  // split K: the last block of the column group adds the splits in order
  // (the acq_rel ticket after the barrier publishes the block's partials)
  __syncthreads();
  if (threadIdx.x == 0)
    last_s = sm90::atomic_add_acq_rel(&a.tickets[group], 1u) ==
             (unsigned)(a.splits - 1);
  __syncthreads();
  if (!last_s) return;
  const size_t stride = (size_t)a.m * a.tiles * kTile;
  const int row = threadIdx.x / kTile, colt = threadIdx.x % kTile;
  if (row < a.m) {
    for (int t = group; t < a.tiles; t += a.groups) {
      const int p = payload_of(a, t);
      const int col = (t - a.tile0[p]) * kTile + colt;
      if (col >= a.n[p]) continue;
      const float scale = col_scale<W>(a, p, col);
      const float* src =
          a.part + (size_t)row * (a.tiles * kTile) + t * kTile + colt;
      float acc = 0.f;
      for (int j = 0; j < a.splits; ++j) acc += __ldcg(src + j * stride);
      write_out(a, p, row, col, acc, scale);
    }
  }
  if (threadIdx.x == 0) a.tickets[group] = 0u;
}

template <typename W, int kKS, int kNT>
int launch(const Args& a, cudaStream_t st) {
  qgemv_kernel<W, kKS, kNT><<<a.groups * a.splits, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// ks: the stretches a warp holds. One-byte payloads: 1, 2 or 4 (two
// fragment sets), or 12 with one 8-row tile (one set); int4: 1 or 2, or 6
// with one 8-row tile (the same k).
template <typename W>
int launch_w(int ks, int nt, const Args& a, cudaStream_t st) {
  if (ks == 1)
    return nt == 1 ? launch<W, 1, 1>(a, st) : launch<W, 1, 2>(a, st);
  if (ks == 2)
    return nt == 1 ? launch<W, 2, 1>(a, st) : launch<W, 2, 2>(a, st);
  if constexpr (Payload<W>::kNibbles) {
    if (ks == 6 && nt == 1) return launch<W, 6, 1>(a, st);
  } else {
    if (ks == 4)
      return nt == 1 ? launch<W, 4, 1>(a, st) : launch<W, 4, 2>(a, st);
    if (ks == 12 && nt == 1) return launch<W, 12, 1>(a, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// w_dtype: 0 = int8, 1 = float8_e4m3fn, 2 = int4 (uint8 pairs); s_dtype /
// out_dtype: 0 = float32, 1 = bfloat16. x [m, k] bf16; `count` (1..3)
// payloads q[i] [n[i], k] (int4: [n[i], k / 2]) with scales s[i]
// [n[i], ngroups] (ngroups 1 but for int4) and outputs out[i] [m, n[i]],
// all contiguous; k a multiple of 16 (int4: of 32; with ngroups > 1, k / 2
// and k / ngroups multiples of 64), x and every q 16-byte aligned. The
// plan (ops/qgemv.py `plan`): n_tiles 8-row tiles of x (1: m <= 8, 2: m <=
// 16), ks the stretches of 64 payload bytes a warp holds (see launch_w;
// kw <= ks of them used), per_split stretches a split, `splits` K splits
// and `groups` column groups (groups * splits blocks). With splits > 1,
// `part` holds splits * m * tiles * 16 f32 and `tickets` groups zeroed
// counters, left zeroed. Returns the launch's cudaError_t.
extern "C" int qgemv_fwd(int w_dtype, int s_dtype, int out_dtype, int count,
                         const void* x, const void* const* q,
                         const void* const* s, void* const* out,
                         const int* n, int m, int k, int ngroups,
                         int n_tiles, int ks, int kw, int per_split,
                         int splits, int groups, void* part, void* tickets,
                         void* stream) {
  if (count < 1 || count > kMaxGroup || m <= 0 || m > kMaxRows || k <= 0 ||
      k % 16 != 0 || n_tiles != (m > 8 ? 2 : 1) || kw <= 0 || kw > ks ||
      splits <= 0 || groups <= 0 || per_split <= 0 || ngroups <= 0 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)) ||
      s_dtype < 0 || s_dtype > 1 || out_dtype < 0 || out_dtype > 1 ||
      w_dtype < 0 || w_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const bool nib = w_dtype == 2;
  if (nib ? (k % 32 != 0 || k % ngroups != 0 ||
             (ngroups > 1 && ((k / 2) % kStretch || (k / ngroups) % kStretch)))
          : ngroups != 1)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  int tiles = 0;
  for (int i = 0; i < kMaxGroup; ++i) {
    a.tile0[i] = tiles;
    if (i < count) {
      if (n[i] <= 0) return (int)cudaErrorInvalidValue;
      a.q[i] = static_cast<const unsigned char*>(q[i]);
      a.s[i] = s[i];
      a.o[i] = out[i];
      a.n[i] = n[i];
      tiles += (n[i] + kTile - 1) / kTile;
    }
  }
  a.tile0[kMaxGroup] = tiles;
  for (int i = count; i < kMaxGroup; ++i) a.tile0[i] = tiles + 1;
  a.m = m;
  a.k = k;
  a.kb = nib ? k / 2 : k;
  a.ngroups = ngroups;
  a.gsize = k / ngroups;
  a.stretches = (a.kb + kStretch - 1) / kStretch;
  a.per_split = per_split;
  a.kw = kw;
  a.splits = splits;
  a.groups = groups;
  a.tiles = tiles;
  a.s_bf16 = s_dtype;
  a.out_bf16 = out_dtype;
  a.part = static_cast<float*>(part);
  a.tickets = static_cast<unsigned*>(tickets);
  if (groups > tiles || (long long)per_split * splits < a.stretches ||
      (long long)kw * kWarps < per_split)
    return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return launch_w<int8_t>(ks, n_tiles, a, st);
  if (w_dtype == 1) return launch_w<Fp8E4M3>(ks, n_tiles, a, st);
  if (ngroups > 1) return launch_w<Nib4G>(ks, n_tiles, a, st);
  return launch_w<Nib4>(ks, n_tiles, a, st);
}
