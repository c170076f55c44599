// The weight-only quantized product of decode rows for Hopper (sm_90a),
// written by hand. No TPU kernel: JAX's `qdot` (qwen3_asr_tpu/ops/quant.py)
// runs in XLA. See qwen3_asr_tpu_torch/ops/qgemv.py for the contract and
// the plan (`plan`) this kernel is launched with:
//
//   out[m, n] = round_out((sum_k bf16 x[m, k] * widen(q[n, k])) * s[n])
//
// with the payload q int8 or e4m3 stored [N, K] (widened exactly to bf16),
// the sum in f32, and one rounding to the output's dtype (bf16, or f32 for
// the logits). One launch takes up to three payloads that share x (q, k
// and v; gate and up) and writes one output each.
//
// What bounds it: the payload's bytes, read once (M <= 16 rows make about
// 16 FLOP a byte, far below the card's ridge). The design:
// - Tensor cores: mma.sync m16n8k16, bf16 in, f32 accumulators. The A
//   operand is the payload (16 output columns x 16 k), widened in
//   registers straight from 16-byte loads; B is x (16 k x 8 rows, rows
//   past M zero; M > 8 takes a second 8-row tile).
// - k is permuted inside each "stretch" of 64 k the same way in both
//   operands: lane (g = lane / 4, t = lane % 4) loads bytes [16 t, 16 t +
//   16) of the stretch from payload rows g and g + 8, and mma j (0..3)
//   takes their word j, i.e. k = 16 t + 4 j + {0, 1} into the fragment's
//   slots for k = 2 t + {0, 1} and k = 16 t + 4 j + {2, 3} into those for
//   2 t + 8 + {0, 1}. The lane's x fragment is then x[g][16 t, 16 t + 16),
//   32 contiguous bytes, word 2 j and 2 j + 1 for mma j: no shared-memory
//   transpose of either operand.
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
//   with more, each split writes f32 partials to scratch and the last
//   block of a column group to take its ticket adds the splits in split
//   order, scales, rounds, writes and resets the ticket. No float atomics:
//   the output is the same bits on every run and under CUDA-graph replay.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 16;
constexpr int kMaxGroup = 3;            // payloads sharing one x
constexpr int kTile = 16;               // output columns of a tile
constexpr int kStretch = 64;            // k of one stretch

struct Fp8E4M3 { uint8_t bits; };       // torch.float8_e4m3fn storage

// Widening: one 32-bit word of 4 payload bytes (k, k + 1, k + 2, k + 3)
// into two bf16x2 words, `lo` (k, k + 1) and `hi` (k + 2, k + 3), the
// lower k in the lower half. Exact for every value. A new payload type
// (int4 nibbles) adds a specialisation, not a kernel.
template <typename W> struct Widen;

// int8: biased to u = q + 128, placed in the mantissa of 2^23 (the f32
// 2^23 + u), less 2^23 + 128 gives q as an f32 integer, whose upper half
// is its bf16 (|q| <= 128 has at most 8 significant bits).
template <> struct Widen<int8_t> {
  __device__ __forceinline__ static void run(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
    const uint32_t u = w ^ 0x80808080u;
    const float f0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650));
    const float f1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651));
    const float f2 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652));
    const float f3 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653));
    lo = __byte_perm(__float_as_uint(f0 - 8388736.f),
                     __float_as_uint(f1 - 8388736.f), 0x7632);
    hi = __byte_perm(__float_as_uint(f2 - 8388736.f),
                     __float_as_uint(f3 - 8388736.f), 0x7632);
  }
};

// e4m3 (s eeee mmm, bias 7): the sign to bf16's bit 15, eeee mmm to its
// exponent's low 4 bits and its mantissa's top 3, which reads the value
// against bf16's bias 127 (subnormals as bf16 subnormals); times 2^120,
// a product by a power of two with a normal result, so exact.
__device__ __forceinline__ uint32_t e4m3_pair(uint32_t a) {
  uint32_t r = (a & 0x80008000u) | ((a >> 4) & 0x07F007F0u);
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
      : "=r"(r)
      : "r"(r), "r"(0x7B807B80u), "r"(0x80008000u));   // 2^120, -0
  return r;
}

template <> struct Widen<Fp8E4M3> {
  __device__ __forceinline__ static void run(uint32_t w, uint32_t& lo,
                                             uint32_t& hi) {
    lo = e4m3_pair(__byte_perm(w, 0, 0x1404));   // b1 << 24 | b0 << 8
    hi = e4m3_pair(__byte_perm(w, 0, 0x3424));   // b3 << 24 | b2 << 8
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
  const unsigned char* q[kMaxGroup];    // [n_i, k]
  const void* s[kMaxGroup];             // [n_i]
  void* o[kMaxGroup];                   // [m, n_i]
  int n[kMaxGroup];
  int tile0[kMaxGroup + 1];             // first column tile of each payload
  int m, k;
  int stretches, per_split, kw;         // stretches of K, of a split, a warp
  int splits, groups, tiles;
  int s_bf16, out_bf16;
  float* part;                          // [splits][m][tiles * kTile]
  unsigned* tickets;                    // [groups], zero between calls
};

__device__ __forceinline__ int payload_of(const Args& a, int tile) {
  return tile >= a.tile0[2] ? 2 : tile >= a.tile0[1] ? 1 : 0;
}

// The scale of one column of payload p.
__device__ __forceinline__ float scale_of(const Args& a, int p, int col) {
  return a.s_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(a.s[p])[col])
                  : static_cast<const float*>(a.s[p])[col];
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
__device__ __forceinline__ float tile_scale(const Args& a, int tile) {
  if (a.splits != 1 || (int)threadIdx.x >= a.m * kTile) return 0.f;
  const int p = payload_of(a, tile);
  const int col = (tile - a.tile0[p]) * kTile + threadIdx.x % kTile;
  return col < a.n[p] ? scale_of(a, p, col) : 0.f;
}

// The payload fragments of one tile for a warp: rows g and g + 8 of the
// tile, the lane's 16 bytes of each of the warp's stretches (zero past N
// or K).
template <int kKS>
struct Frag {
  uint4 r0[kKS], r1[kKS];
};

template <int kKS>
__device__ __forceinline__ void load_tile(const Args& a, int tile, int kbeg,
                                          int kend, int lane,
                                          Frag<kKS>& f) {
  const int p = payload_of(a, tile);
  const int col = (tile - a.tile0[p]) * kTile + (lane >> 2);
  const unsigned char* base = a.q[p] + (size_t)col * a.k;
  const bool ok0 = col < a.n[p], ok1 = col + 8 < a.n[p];
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    const int k0 = kbeg + j * kStretch + 16 * (lane & 3);
    const bool in = k0 < kend;
    f.r0[j] = in && ok0 ? load_stream(base + k0) : make_uint4(0, 0, 0, 0);
    f.r1[j] = in && ok1 ? load_stream(base + (size_t)8 * a.k + k0)
                        : make_uint4(0, 0, 0, 0);
  }
}

template <typename W, int kKS, int kNT>
__device__ __forceinline__ void tile_products(const Frag<kKS>& f,
                                              const uint4 (&xf)[kKS][kNT][2],
                                              float (&c)[kNT][4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[nt][i] = 0.f;
#pragma unroll
  for (int j = 0; j < kKS; ++j) {
    const uint32_t w0[4] = {f.r0[j].x, f.r0[j].y, f.r0[j].z, f.r0[j].w};
    const uint32_t w1[4] = {f.r1[j].x, f.r1[j].y, f.r1[j].z, f.r1[j].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t lo0, hi0, lo1, hi1;
      Widen<W>::run(w0[q], lo0, hi0);
      Widen<W>::run(w1[q], lo1, hi1);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const uint4& xv = xf[j][nt][q >> 1];
        const uint32_t b0 = (q & 1) ? xv.z : xv.x;
        const uint32_t b1 = (q & 1) ? xv.w : xv.y;
        mma_bf16(c[nt], lo0, lo1, hi0, hi1, b0, b1);
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

  // this warp's K range: stretches [s0, s1) of the split's
  const int sp0 = split * a.per_split;
  const int sp1 = min(sp0 + a.per_split, a.stretches);
  const int s0 = min(sp0 + warp * a.kw, sp1);
  const int s1 = min(s0 + a.kw, sp1);
  const int kbeg = s0 * kStretch, kend = min(s1 * kStretch, a.k);

  // x fragments: rows g (+ 8 nt), k [16 t, 16 t + 16) of each stretch
  uint4 xf[kKS][kNT][2];
#pragma unroll
  for (int j = 0; j < kKS; ++j)
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const int row = nt * 8 + (lane >> 2);
      const int k0 = kbeg + j * kStretch + 16 * (lane & 3);
      const bool in = row < a.m && k0 < kend;
      const uint4* src =
          reinterpret_cast<const uint4*>(a.x + (size_t)row * a.k + k0);
      xf[j][nt][0] = in ? __ldg(src) : make_uint4(0, 0, 0, 0);
      xf[j][nt][1] = in ? __ldg(src + 1) : make_uint4(0, 0, 0, 0);
    }

  float c[kNT][4];
  if constexpr (kKS > 4) {
    // a long K slice a warp (one tile a block): one fragment set
    Frag<kKS> fa;
    int buf = 0;
    for (int tile = group; tile < a.tiles; tile += a.groups) {
      load_tile(a, tile, kbeg, kend, lane, fa);
      const float scale = tile_scale(a, tile);
      tile_products<W, kKS, kNT>(fa, xf, c);
      reduce_tile<kNT>(a, tile, split, c, scale, red[buf], warp, lane);
      buf ^= 1;
    }
  } else {
    // tiles in pairs, two fragment sets: the next tile's loads in flight
    // while this one's products run
    Frag<kKS> fa, fb;
    int tile = group, buf = 0;
    if (tile < a.tiles) load_tile(a, tile, kbeg, kend, lane, fa);
    while (tile < a.tiles) {
      const int next = tile + a.groups;
      if (next < a.tiles) load_tile(a, next, kbeg, kend, lane, fb);
      float scale = tile_scale(a, tile);
      tile_products<W, kKS, kNT>(fa, xf, c);
      reduce_tile<kNT>(a, tile, split, c, scale, red[buf], warp, lane);
      buf ^= 1;
      if (next >= a.tiles) break;
      const int after = next + a.groups;
      if (after < a.tiles) load_tile(a, after, kbeg, kend, lane, fa);
      scale = tile_scale(a, next);
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
      const float scale = scale_of(a, p, col);
      const float* src =
          a.part + (size_t)row * (a.tiles * kTile) + t * kTile + colt;
      float acc = 0.f;
      for (int j = 0; j < a.splits; ++j) acc += __ldcg(src + j * stride);
      write_out(a, p, row, col, acc, scale);
    }
  }
  if (threadIdx.x == 0) a.tickets[group] = 0u;
}

template <typename W, int kKS>
int launch_ks(int nt, const Args& a, cudaStream_t st) {
  const int grid = a.groups * a.splits;
  if (nt == 1)
    qgemv_kernel<W, kKS, 1><<<grid, kThreads, 0, st>>>(a);
  else
    qgemv_kernel<W, kKS, 2><<<grid, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename W>
int launch_w(int ks, int nt, const Args& a, cudaStream_t st) {
  if (ks == 1) return launch_ks<W, 1>(nt, a, st);
  if (ks == 2) return launch_ks<W, 2>(nt, a, st);
  if (ks == 4) return launch_ks<W, 4>(nt, a, st);
  if (ks == 12 && nt == 1) {
    qgemv_kernel<W, 12, 1><<<a.groups * a.splits, kThreads, 0, st>>>(a);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// w_dtype: 0 = int8, 1 = float8_e4m3fn; s_dtype / out_dtype: 0 = float32,
// 1 = bfloat16. x [m, k] bf16; `count` (1..3) payloads q[i] [n[i], k] with
// scales s[i] [n[i]] and outputs out[i] [m, n[i]], all contiguous; k a
// multiple of 16, x and every q 16-byte aligned. The plan (ops/qgemv.py
// `plan`): n_tiles 8-row tiles of x (1: m <= 8, 2: m <= 16), ks the
// stretches of 64 k a warp holds (1, 2 or 4; or 12 with n_tiles 1, one
// fragment set; kw <= ks of them used),
// per_split stretches a split, `splits` K splits and `groups` column
// groups (groups * splits blocks). With splits > 1, `part` holds splits *
// m * tiles * 16 f32 and `tickets` groups zeroed counters, left zeroed.
// Returns the launch's cudaError_t.
extern "C" int qgemv_fwd(int w_dtype, int s_dtype, int out_dtype, int count,
                         const void* x, const void* const* q,
                         const void* const* s, void* const* out,
                         const int* n, int m, int k, int n_tiles, int ks,
                         int kw, int per_split, int splits, int groups,
                         void* part, void* tickets, void* stream) {
  if (count < 1 || count > kMaxGroup || m <= 0 || m > kMaxRows || k <= 0 ||
      k % 16 != 0 || n_tiles != (m > 8 ? 2 : 1) || kw <= 0 || kw > ks ||
      splits <= 0 || groups <= 0 || per_split <= 0 ||
      (splits > 1 && (part == nullptr || tickets == nullptr)) ||
      s_dtype < 0 || s_dtype > 1 || out_dtype < 0 || out_dtype > 1)
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
  a.stretches = (k + kStretch - 1) / kStretch;
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
  return (int)cudaErrorInvalidValue;
}
