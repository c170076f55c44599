// The weight-only quantized product of more than 16 rows (kernel C) for
// Hopper (sm_90a), written by hand: the prefill's and the encoder's
// projections, and decode steps past 16 rows. No TPU kernel: JAX's `qdot`
// (qwen3_asr_tpu/ops/quant.py:134-182) runs in XLA, which fuses the
// payload's widening and the scales into the dot. On the card it stands in
// for `widened_product` (ops/qgemm.py), which wrote a bf16 copy of the
// whole payload every call and then ran cuBLAS. See ops/qgemm.py for the
// contract:
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
// What bounds it: at the prefill's 453 rows and more the work is the
// tensor cores' (w_down at 453 rows: 11.4 GFLOP against 12.6 MB of int8
// payload); what it saves over the widened route is the copy, 2 bytes a
// weight written and read again per call. On the H100 the K loop's other
// work (copies, permute, widening, a barrier a stretch) sets its pace
// today, not the tensor cores (PERF.md). The design:
// - wgmma, D[64 payload rows x BM rows of x] += A[64 x 16] * B[16 x BM]:
//   A is the payload, widened in registers (csrc/widen.cuh), B is x in
//   shared memory. Widening in registers costs per payload value, and one
//   wgmma spreads each widened value over all BM rows of x (mma.sync, the
//   first version of this kernel, spread it over 32).
// - A block is two warpgroups, 128 payload rows x BM (64 or 128, the
//   wider where the grid still fills the card) rows of x, of one of up to
//   three payloads that share x (q, k and v; gate and up: one launch, the
//   blocks of all). K goes in stretches of 64 payload bytes (64 k; int4:
//   128, 64 from each half of the row) through a ring of 3 or 4 cp.async
//   stages, x as it lies and the payload tile; each stretch's x is
//   permuted (below) into one of three wgmma buffers while the previous
//   stretch's products run, one barrier a stretch. Three, because wgmma
//   reads its B operand asynchronously: at stretch st a thread has retired
//   only its own warpgroup's products of stretch st - 1, and the other
//   warpgroup's may still be reading stretch st - 1's buffer. Stretch
//   st + 1's permute goes into the buffer of stretch st - 2, which every
//   warpgroup retired (its wgmma_wait<1> in stretch st - 1) before the
//   barrier of stretch st.
// - A's fragments come straight from 16-byte shared-memory loads with
//   kernel A's k permutation (csrc/qgemv.cu): lane (g, t) reads bytes
//   [16 t, 16 t + 16) of payload rows g and g + 8, and word j feeds k16
//   slice j, k 16 t + 4 j + {0, 1} in the fragment's slots 2 t + {0, 1}
//   and 16 t + 4 j + {2, 3} in 2 t + 8 + {0, 1}. B, read by the hardware
//   in slot order, must then hold the same permutation: x's 32 words of a
//   stretch's row (4-byte k pairs) are stored transposed, real word
//   8 t + v at word 4 v + t (slice j = v / 2), in the 128-byte swizzle
//   wgmma reads (16-byte chunk c of row r at c ^ (r % 8)).
// - int4: the low nibbles pair with the stretch's first x tile and the
//   high ones with its second (k + K/2). Group scales run along K, so each
//   half-stretch's four wgmmas go into a fresh accumulator, added into the
//   sum times its column's group scale; the rule, as kernel A's: K/2 and
//   the group size are multiples of 64 (or there is one group), so a
//   half-stretch lies in one group. One scale a column waits for the
//   epilogue.
// - One launch a call, no scratch, no atomics: the same bits every run.
// Next steps, not taken here: fewer instructions and barriers a stretch,
// a TMA producer warp and multicast of x and the payload across a
// cluster, a persistent grid.

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

constexpr int kThreads = 256;            // two warpgroups
constexpr int kBN = 128;                 // payload rows a block: 64 a group
constexpr int kStretch = 64;             // payload bytes a stage
constexpr int kPayBytes = kBN * kStretch;          // 8 KB
constexpr int kRowBytes = 128;                     // x: 64 k of bf16 a row

// x tiles a stretch: its k, and for int4 also the k of the row's second
// half
template <typename W>
constexpr int kHalves = Payload<W>::kNibbles ? 2 : 1;
// stretches in flight: a ring of cp.async stages
template <typename W>
constexpr int kStages = Payload<W>::kNibbles ? 3 : 4;
template <typename W, int kBM>
constexpr int kXBytes = kHalves<W> * kBM * kRowBytes;
// wgmma x buffers: stretch st reads buffer st % 3 (see the top)
constexpr int kXBufs = 3;
// shared memory: the wgmma x buffers (1024-byte aligned), then the ring of
// stages, each the stretch's x as copied, then its payload tile
template <typename W, int kBM>
constexpr int kStageBytes = kXBytes<W, kBM> + kPayBytes;
template <typename W, int kBM>
constexpr int kSmem = kXBufs * kXBytes<W, kBM> +
                      kStages<W> * kStageBytes<W, kBM> + 1024;

constexpr int kMaxGroup = 3;            // payloads sharing one x

struct Args {
  const __nv_bfloat16* x;     // [m, k]
  // the block's payload: q [n, kb], s [n, ngroups], o [m, n]; the kernel
  // sets them from the group's below
  const unsigned char* q;
  const void* s;
  void* o;
  int n;
  const unsigned char* qs[kMaxGroup];
  const void* ss[kMaxGroup];
  void* os[kMaxGroup];
  int ns[kMaxGroup];
  int tile0[kMaxGroup + 1];   // first column block of each payload
  int m, k;
  int kb;                     // payload bytes a row: k, or k / 2
  int ngroups, gsize;         // int4 scale groups, k a group
  int stretches;              // of kb
  int s_bf16, out_bf16;
};

__device__ __forceinline__ float scale_at(const Args& a, size_t i) {
  return a.s_bf16 ? __bfloat162float(
                        static_cast<const __nv_bfloat16*>(a.s)[i])
                  : static_cast<const float*>(a.s)[i];
}

// 16 bytes into shared memory, asynchronously; zeros where !pred (the
// source is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Stretch `st` into a stage of the ring, by cp.async (zero past N, M and
// the row): its x tile(s) [kBM rows][128 bytes] as they lie in x, then
// its payload tile [128 rows][64 bytes]. One commit group, also where
// there is nothing left to copy.
template <typename W, int kBM>
__device__ __forceinline__ void load_stage(const Args& a,
                                           unsigned char* stage, int st,
                                           int n0, int m0) {
  if (st < a.stretches) {
#pragma unroll
    for (int i = 0; i < kXBytes<W, kBM> / 16 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int h = idx / (kBM * 8), r = (idx / 8) % kBM, c = idx % 8;
      const int row = m0 + r, kk = st * kStretch + 8 * c;   // k in the half
      const bool ok = row < a.m && kk < a.kb;
      cp_async16(stage + idx * 16,
                 ok ? a.x + (size_t)row * a.k + h * a.kb + kk : a.x, ok);
    }
    unsigned char* pay = stage + kXBytes<W, kBM>;
#pragma unroll
    for (int i = 0; i < kPayBytes / 16 / kThreads; ++i) {
      const int idx = threadIdx.x + i * kThreads;
      const int r = idx >> 2, c = idx & 3;
      const int col = n0 + r, byte = st * kStretch + 16 * c;
      const bool ok = col < a.n && byte < a.kb;
      cp_async16(pay + r * kStretch + 16 * c,
                 ok ? a.q + (size_t)col * a.kb + byte : a.q, ok);
    }
  }
  cp_async_commit();
}

// A stage's x, as copied, into a wgmma buffer: each row's 32 words (k
// pairs) transposed, real word 8 t + v to word 4 v + t (chunk v, word t),
// and swizzled (chunk v of row r at v ^ (r % 8)); then made visible to
// wgmma's reads (after the next barrier).
template <typename W, int kBM>
__device__ __forceinline__ void permute_x(const unsigned char* stage,
                                          unsigned char* xbuf) {
#pragma unroll
  for (int i = 0; i < kXBytes<W, kBM> / 16 / kThreads; ++i) {
    const int idx = threadIdx.x + i * kThreads;
    const int r = (idx / 8) % kBM, q = idx % 8;   // row r (of tile h), chunk q
    const uint4 v4 = *reinterpret_cast<const uint4*>(stage + idx * 16);
    // chunk q holds real words 4 q .. 4 q + 3: t = q / 2, v = 4 (q % 2) + j
    unsigned char* row = xbuf + (idx / 8) * kRowBytes + 4 * (q >> 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int v = 4 * (q & 1) + j;
      *reinterpret_cast<uint32_t*>(row + 16 * (v ^ (r & 7))) = word(v4, j);
    }
  }
  sm90::fence_async_shared();
}

// D[64 x kBM] += A[64 x 16] * B[16 x kBM], B the x tile's k16 slice at
// `desc`.
template <int kBM>
__device__ __forceinline__ void wgmma_tile(float (&d)[kBM / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_tile<64>(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc) {
  sm90::wgmma_m64n64k16<0>(d, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_tile<128>(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc) {
  sm90::wgmma_m64n128k16<0>(d, a, desc);
}

// One stretch st of a block's K loop. Its barrier: stretch st + 1 has
// landed, every thread is past stretch st - 1's permute and every
// warpgroup has retired its wgmmas of stretch st - 2; the ring's next copy
// goes out; then each half-stretch ("step": one, or two for int4) widens
// its A fragments and issues its four wgmmas, with the previous step's
// still in flight; once that one has landed, its group scales are applied
// (int4 groups) and, at the first step, stretch st + 1's x is permuted
// into buffer (st + 1) % 3, stretch st - 2's. Steps alternate two
// register buffers (A's fragments; for group scales, the step's sum and
// scales): buffer h for int4's half h, kB for one half (stretch parity).
template <typename W, int kBM, int kB>
__device__ __forceinline__ void stretch(
    const Args& a, int st, unsigned char* ring, unsigned char* xbuf, int n0,
    int m0, int pr, int t, float (&c)[kBM / 2], uint32_t (&af)[2][4][4],
    float (&p)[2][kBM / 2], float (&sc)[2][2]) {
  constexpr int kS = kStages<W>;
  cp_async_wait<kS - 3>();          // stretch st + 1
  __syncthreads();
  load_stage<W, kBM>(a, ring + ((st + kS - 1) % kS) * kStageBytes<W, kBM>,
                     st + kS - 1, n0, m0);
  const unsigned char* pay =
      ring + (st % kS) * kStageBytes<W, kBM> + kXBytes<W, kBM>;
  const uint4 p0 =
      *reinterpret_cast<const uint4*>(pay + pr * kStretch + 16 * t);
  const uint4 p1 =
      *reinterpret_cast<const uint4*>(pay + (pr + 8) * kStretch + 16 * t);
  const unsigned char* xs = xbuf + (st % kXBufs) * kXBytes<W, kBM>;
#pragma unroll
  for (int h = 0; h < kHalves<W>; ++h) {
    const int b = kHalves<W> == 2 ? h : kB;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const uint32_t w0 = word(p0, j), w1 = word(p1, j);
      if constexpr (Payload<W>::kNibbles) {
        if (h == 0) {
          widen::widen_nib_lo(w0, af[b][j][0], af[b][j][2]);
          widen::widen_nib_lo(w1, af[b][j][1], af[b][j][3]);
        } else {
          widen::widen_nib_hi(w0, af[b][j][0], af[b][j][2]);
          widen::widen_nib_hi(w1, af[b][j][1], af[b][j][3]);
        }
      } else {
        widen::widen_bytes<W>(w0, af[b][j][0], af[b][j][2]);
        widen::widen_bytes<W>(w1, af[b][j][1], af[b][j][3]);
      }
    }
    const uint32_t xt = sm90::smem_u32(xs + h * kBM * kRowBytes);
    if constexpr (Payload<W>::kGrouped) {
      // this half-stretch's sum alone, into its own buffer
      const int grp = (h * a.kb + st * kStretch) / a.gsize;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n0 + pr + 8 * i;
        sc[b][i] = col < a.n ? scale_at(a, (size_t)col * a.ngroups + grp)
                             : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kBM / 2; ++i) p[b][i] = 0.f;
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_tile<kBM>(p[b], af[b][j],
                        sm90::desc_sw128(xt + 32 * j, 16, 1024));
    } else {
      sm90::wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_tile<kBM>(c, af[b][j], sm90::desc_sw128(xt + 32 * j, 16, 1024));
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait<1>();          // the previous step has landed
    if constexpr (Payload<W>::kGrouped) {
      // its sum times its scales: p[4 q + i] is payload row pr + 8 (i / 2)
      sm90::fence_regs(p[b ^ 1]);
#pragma unroll
      for (int i = 0; i < kBM / 2; ++i)
        c[i] += p[b ^ 1][i] * sc[b ^ 1][(i >> 1) & 1];
    }
    if (h == 0 && st + 1 < a.stretches)
      permute_x<W, kBM>(ring + ((st + 1) % kS) * kStageBytes<W, kBM>,
                        xbuf + ((st + 1) % kXBufs) * kXBytes<W, kBM>);
  }
}

// Grid (the payloads' N / 128, each rounded up; M / kBM, rounded up):
// block (bx, by) writes columns [128 b, +128) of rows [kBM by, +kBM) of
// payload p, bx = tile0[p] + b; warpgroup w its columns [64 w, +64).
template <typename W, int kBM>
__global__ void __launch_bounds__(kThreads) qgemm_kernel(const Args group) {
  constexpr int kS = kStages<W>;
  // this block's payload of the group, and its column block in it
  const int bx = blockIdx.x;
  const int pi = bx >= group.tile0[2] ? 2 : bx >= group.tile0[1] ? 1 : 0;
  Args a = group;
  a.q = pi == 2 ? group.qs[2] : pi == 1 ? group.qs[1] : group.qs[0];
  a.s = pi == 2 ? group.ss[2] : pi == 1 ? group.ss[1] : group.ss[0];
  a.o = pi == 2 ? group.os[2] : pi == 1 ? group.os[1] : group.os[0];
  a.n = pi == 2 ? group.ns[2] : pi == 1 ? group.ns[1] : group.ns[0];
  const int tile0 =
      pi == 2 ? group.tile0[2] : pi == 1 ? group.tile0[1] : group.tile0[0];
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  unsigned char* xbuf = smem;                        // [kXBufs][kXBytes]
  unsigned char* ring = smem + kXBufs * kXBytes<W, kBM>;  // [kS][kStageBytes]
  const int tid = threadIdx.x, lane = tid & 31;
  const int wg = tid >> 7, warp = (tid >> 5) & 3;
  const int t = lane & 3;
  const int n0 = (bx - tile0) * kBN, m0 = blockIdx.y * kBM;
  // this thread's payload rows (A's rows g and g + 8 of its warp)
  const int pr = wg * 64 + warp * 16 + (lane >> 2);

  float c[kBM / 2];
  float p[2][kBM / 2];               // group scales: the steps' own sums
  float sc[2][2] = {};
  uint32_t af[2][4][4];
#pragma unroll
  for (int i = 0; i < kBM / 2; ++i) c[i] = p[0][i] = p[1][i] = 0.f;

#pragma unroll
  for (int st = 0; st < kS - 1; ++st)
    load_stage<W, kBM>(a, ring + st * kStageBytes<W, kBM>, st, n0, m0);
  cp_async_wait<kS - 2>();            // stretch 0
  __syncthreads();
  permute_x<W, kBM>(ring, xbuf);

  for (int st = 0; st < a.stretches; st += 2) {
    stretch<W, kBM, 0>(a, st, ring, xbuf, n0, m0, pr, t, c, af, p, sc);
    if (st + 1 < a.stretches)
      stretch<W, kBM, 1>(a, st + 1, ring, xbuf, n0, m0, pr, t, c, af, p,
                         sc);
  }
  cp_async_wait<0>();
  sm90::wgmma_wait<0>();
  if constexpr (Payload<W>::kGrouped) {
    // the last step's sum (int4: the second half, buffer 1)
    sm90::fence_regs(p[1]);
#pragma unroll
    for (int i = 0; i < kBM / 2; ++i) c[i] += p[1][i] * sc[1][(i >> 1) & 1];
  }
  sm90::fence_regs(c);

  // epilogue: c[4 q + i] is column n0 + pr + 8 (i / 2) of row
  // m0 + 8 q + 2 t + i % 2
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int col = n0 + pr + 8 * rr;
    if (col >= a.n) continue;
    float scale = 1.f;
    if constexpr (!Payload<W>::kGrouped) scale = scale_at(a, col);
#pragma unroll
    for (int q = 0; q < kBM / 8; ++q)
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int row = m0 + 8 * q + 2 * t + cc;
        if (row >= a.m) continue;
        const float v = c[4 * q + 2 * rr + cc] * scale;
        const size_t i = (size_t)row * a.n + col;
        if (a.out_bf16)
          static_cast<__nv_bfloat16*>(a.o)[i] = __float2bfloat16(v);
        else
          static_cast<float*>(a.o)[i] = v;
      }
  }
}

template <typename W, int kBM>
int launch_bm(const Args& a, cudaStream_t st) {
  static bool done[sm90::kMaxDevices] = {};
  const cudaError_t err =
      sm90::max_smem(qgemm_kernel<W, kBM>, kSmem<W, kBM>, done);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.tile0[kMaxGroup], (a.m + kBM - 1) / kBM);
  qgemm_kernel<W, kBM><<<grid, kThreads, kSmem<W, kBM>, st>>>(a);
  return (int)cudaGetLastError();
}

// 128 rows of x a block where the grid still has a block for every SM of
// an H100 (132), else 64; 64 for group scales (a thread holds two sums
// beside its accumulator).
template <typename W>
int launch(const Args& a, cudaStream_t st) {
  const long long wide = (long long)a.tile0[kMaxGroup] * ((a.m + 127) / 128);
  if constexpr (Payload<W>::kGrouped)   // two sums a thread: 64 rows only
    return launch_bm<W, 64>(a, st);
  else
    return wide >= 132 ? launch_bm<W, 128>(a, st) : launch_bm<W, 64>(a, st);
}

}  // namespace

// w_dtype: 0 = int8, 1 = float8_e4m3fn, 2 = int4 (uint8 pairs); s_dtype /
// out_dtype: 0 = float32, 1 = bfloat16. x [m, k] bf16; `count` (1..3)
// payloads q[i] [n[i], k] (int4: [n[i], k / 2]) with scales s[i]
// [n[i], ngroups] (ngroups 1 but for int4) and outputs out[i] [m, n[i]],
// all contiguous, x and every q 16-byte aligned; k a multiple of 16 (int4:
// of 32; with ngroups > 1, k / 2 and k / ngroups multiples of 64). One
// launch for all. Returns the launch's cudaError_t.
extern "C" int qgemm_fwd(int w_dtype, int s_dtype, int out_dtype, int count,
                         const void* x, const void* const* q,
                         const void* const* s, void* const* out,
                         const int* n, int m, int k, int ngroups,
                         void* stream) {
  if (count < 1 || count > kMaxGroup || m <= 0 || k <= 0 || k % 16 != 0 ||
      ngroups <= 0 || (m + 63) / 64 > 65535 || s_dtype < 0 || s_dtype > 1 ||
      out_dtype < 0 || out_dtype > 1 || w_dtype < 0 || w_dtype > 2)
    return (int)cudaErrorInvalidValue;
  const bool nib = w_dtype == 2;
  if (nib ? (k % 32 != 0 || k % ngroups != 0 ||
             (ngroups > 1 &&
              ((k / 2) % kStretch || (k / ngroups) % kStretch)))
          : ngroups != 1)
    return (int)cudaErrorInvalidValue;
  Args a = {};
  a.x = static_cast<const __nv_bfloat16*>(x);
  int blocks = 0;
  for (int i = 0; i < kMaxGroup; ++i) {
    a.tile0[i] = blocks;
    if (i < count) {
      if (n[i] <= 0) return (int)cudaErrorInvalidValue;
      a.qs[i] = static_cast<const unsigned char*>(q[i]);
      a.ss[i] = s[i];
      a.os[i] = out[i];
      a.ns[i] = n[i];
      blocks += (n[i] + kBN - 1) / kBN;
    }
  }
  a.tile0[kMaxGroup] = blocks;
  for (int i = count; i < kMaxGroup; ++i) a.tile0[i] = blocks;
  a.m = m;
  a.k = k;
  a.kb = nib ? k / 2 : k;
  a.ngroups = ngroups;
  a.gsize = k / ngroups;
  a.stretches = (a.kb + kStretch - 1) / kStretch;
  a.s_bf16 = s_dtype;
  a.out_bf16 = out_dtype;
  auto st = static_cast<cudaStream_t>(stream);
  if (w_dtype == 0) return launch<int8_t>(a, st);
  if (w_dtype == 1) return launch<Fp8E4M3>(a, st);
  if (ngroups > 1) return launch<Nib4G>(a, st);
  return launch<Nib4>(a, st);
}
