// Flash attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel qwen3_asr_tpu/ops/flash_attention.py `_kernel`
// (launched by `_flash_pallas`). Same function, not the same blocking:
//
//   out = softmax_masked(q k^T * scale) v, per KV head for its G query heads,
//   mask from indices (causal with per-row q_offset, block-diagonal window,
//   per-row [valid_from, valid_to), S tail); masked scores = MASK_VALUE and
//   p = 0 there; l == 0 rows divide by 1 (output 0); m, l returned in f32.
//
// Both routes take one block per (tile of query rows, KV head, batch row);
// the block's 64 rows are the tile's rows for ALL G query heads of the KV
// head (row r = g * block_q + t_local, block_q = 64 / G), so each K/V tile
// is read once for the whole group, and KV tiles outside the tile's live
// key range (window, causal limit, [valid_from, valid_to)) are never
// loaded. Masks inside a live tile apply per element: encoder windows of
// 50 keys do not align with the tiles.
//
// bf16 route (tensor cores). Two consumer warpgroups (128 threads each)
// and one producer warp per block. Both products run on `wgmma`: S = Q K^T
// as m64n64k16 (64 keys per tile) with Q held in registers as the A operand
// (loaded once per block), and O += P V as m64n{D}k16 with P taken from
// registers: the online softmax runs in f32 on the S fragment, which is
// then rounded to bf16 in registers -- the TPU kernel's rounding point
// (`p.astype(v.dtype)`). V is the B operand in MN-major layout through the
// instruction's transpose bit, so it is never transposed in memory. The
// producer's lane 0 loads K and V tiles with TMA (`cp.async.bulk.tensor`,
// 128-byte swizzle, a 256-byte row at D = 128 split into two 64-column
// boxes) into a 4-stage ring, with one mbarrier per tile for K, one for V
// (so Q K^T starts before V lands) and one that frees the stage. Head dims
// below the template's D (64 or 128) are zero-filled by TMA past the last
// column. The tensor maps are built on the host per call, through
// cuTensorMapEncodeTiled fetched with cudaGetDriverEntryPoint (no -lcuda;
// sm90.cuh).
// Warpgroup w takes the key tiles w, w + 2, ... of the block's rows with
// its own running m, l and O, so one group's softmax overlaps the other's
// matrix products and a long causal row walks half as many tiles in
// series; at the end group 1 parks its state in shared memory and group 0
// merges it. The softmax is lean because it runs with one warp per SM
// sub-partition and is latency-bound: the scale folds into one FMA before
// `ex2.approx`, masked scores become -inf (p = 0 with no test), and a tile
// that is live for all of a thread's rows skips the mask.
//
// f32 route (CUDA cores), the parity dtype: no tensor core computes f32 to
// 2e-5. Four warps own 16 rows each; K/V tiles of 32 keys are staged in
// shared memory as f32; lane j scores key j against the warp's rows, and
// each lane accumulates P.V for the head dims lane, lane+32, ...
//
// What bounds it: at the main path's shapes (encoder windows of 50 tokens,
// a prefill of a few hundred) the bytes and FLOPs are small (a bound of
// 1-2 microseconds), so the cost is the serial chain of key tiles a block
// walks (per tile: the K wait, Q K^T, the softmax, the V wait, P V) and the
// block's output stores; the ring keeps later tiles' loads in flight while
// a tile computes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"
#include "wgmma.cuh"

namespace {

using sm90::kMaskValue;
using sm90::smem_u32;

// ---------------------------------------------------------------------------
// f32 route: CUDA cores.

namespace core {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kBlockK = 32;                     // keys per tile, one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

size_t smem_bytes(int d) {
  return sizeof(float) * ((size_t)kRows * d + (size_t)kBlockK * (d + 1) +
                          (size_t)kBlockK * d + (size_t)kRows * kBlockK);
}

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out,
                 const int* __restrict__ valid_from,
                 const int* __restrict__ valid_to,
                 const int* __restrict__ q_offset, int nq, int nkv, int t_len,
                 int s_len, int d, int block_q, int causal, int window,
                 float sm_scale) {
  extern __shared__ float smem[];
  const int group = nq / nkv;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * block_q;
  const int dk = d + 1;  // padded K rows: lane j reads row j conflict-free
  float* q_s = smem;                     // [kRows][d]
  float* k_s = q_s + kRows * d;          // [kBlockK][d + 1]
  float* v_s = k_s + kBlockK * dk;       // [kBlockK][d]
  float* p_s = v_s + kBlockK * d;        // [kRows][kBlockK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int vf = valid_from[b], vt = valid_to[b], qoff = q_offset[b];
  const int rows_used = group * block_q;

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, dd = i - (i / d) * d;
    float x = 0.f;
    if (r < rows_used) {
      const int g = r / block_q, t = t0 + r % block_q;
      if (t < t_len)
        x = q[(((size_t)b * nq + h * group + g) * t_len + t) * d + dd];
    }
    q_s[i] = x;
  }

  // Live key range of this tile of query rows; tiles outside are skipped.
  const int t_last = min(t0 + block_q, t_len) - 1;
  const int pos_lo = t0 + qoff, pos_hi = t_last + qoff;
  int lo = max(vf, 0), hi = min(vt, s_len);
  if (causal) hi = min(hi, pos_hi + 1);
  if (window > 0) {
    lo = max(lo, (pos_lo / window) * window);
    hi = min(hi, (pos_hi / window + 1) * window);
  }

  float m_run[kRowsPerWarp], l_run[kRowsPerWarp];
  float acc[kRowsPerWarp][kDPerLane];
  int row_pos[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int t = t0 + r % block_q;
    row_ok[i] = r < rows_used && t < t_len;
    row_pos[i] = t + qoff;
    m_run[i] = kMaskValue;
    l_run[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc[i][e] = 0.f;
  }

  const size_t head = ((size_t)b * nkv + h) * (size_t)s_len * d;
  const float* k_head = k + head;
  const float* v_head = v + head;
  const float* q_warp = q_s + warp * kRowsPerWarp * d;
  float* p_warp = p_s + warp * kRowsPerWarp * kBlockK;

  for (int c0 = (lo / kBlockK) * kBlockK; lo < hi && c0 < hi; c0 += kBlockK) {
    __syncthreads();  // Q staged; the previous tile fully consumed
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int j = i / d, dd = i - (i / d) * d;
      const int c = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (c < s_len) {
        kx = k_head[(size_t)c * d + dd];
        vx = v_head[(size_t)c * d + dd];
      }
      k_s[j * dk + dd] = kx;
      v_s[j * d + dd] = vx;
    }
    __syncthreads();

    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.f;
    const float* k_row = k_s + lane * dk;
    for (int dd = 0; dd < d; ++dd) {
      const float kv = k_row[dd];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] += q_warp[i * d + dd] * kv;
    }

    const int c = c0 + lane;
    const bool col_ok = c < s_len && c >= vf && c < vt;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool live = col_ok && row_ok[i];
      if (causal) live = live && c <= row_pos[i];
      if (window > 0) live = live && (row_pos[i] / window == c / window);
      const float sc = live ? s[i] * sm_scale : kMaskValue;
      const float m_new = fmaxf(m_run[i], warp_max(sc));
      const float alpha = expf(m_run[i] - m_new);
      const float p = live ? expf(sc - m_new) : 0.f;
      l_run[i] = alpha * l_run[i] + warp_sum(p);
      m_run[i] = m_new;
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) acc[i][e] *= alpha;
      p_warp[i * kBlockK + lane] = p;
    }
    __syncwarp();

    for (int j = 0; j < kBlockK; ++j) {
      float vv[kDPerLane];
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) {
        const int dd = lane + 32 * e;
        vv[e] = dd < d ? v_s[j * d + dd] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float p = p_warp[i * kBlockK + j];
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) acc[i][e] += p * vv[e];
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    if (!row_ok[i]) continue;
    const int r = warp * kRowsPerWarp + i;
    const int g = r / block_q, t = t0 + r % block_q;
    const size_t row = ((size_t)b * nq + h * group + g) * t_len + t;
    const float l_safe = l_run[i] == 0.f ? 1.f : l_run[i];
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int dd = lane + 32 * e;
      if (dd < d) o[row * d + dd] = acc[i][e] / l_safe;
    }
    if (lane == 0) {
      m_out[row] = m_run[i];
      l_out[row] = l_run[i];
    }
  }
}

int launch(const float* q, const float* k, const float* v, float* o,
           float* m, float* l, const int* vf, const int* vt,
           const int* q_off, int b, int nq, int nkv, int t_len, int s_len,
           int d, int causal, int window, float sm_scale,
           cudaStream_t stream) {
  const int block_q = kRows / (nq / nkv);
  // Above 48 KB only after opting in; once per device, for the largest
  // head dim, so no later launch (nor a graph capture) repeats it.
  static bool raised[sm90::kMaxDevices] = {};
  const cudaError_t err =
      sm90::max_smem(flash_f32_kernel, (int)smem_bytes(kMaxD), raised);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((t_len + block_q - 1) / block_q, nkv, b);
  flash_f32_kernel<<<grid, kThreads, smem_bytes(d), stream>>>(
      q, k, v, o, m, l, vf, vt, q_off, nq, nkv, t_len, s_len, d, block_q,
      causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace core

// ---------------------------------------------------------------------------
// bf16 route: wgmma + TMA.

namespace tc {

constexpr int kRows = 64;                 // query rows per block: wgmma M
constexpr int kBlockK = 64;               // keys per tile
constexpr int kStages = 4;                // ring of K/V tiles
constexpr int kGroups = 2;                // consumer warpgroups: group w
                                          // takes key tiles w, w + 2, ...
constexpr int kConsumers = 128;           // threads of one warpgroup
constexpr int kThreads = kGroups * kConsumers + 32;  // + a producer warp
constexpr int kBox = 64;                  // columns per TMA box: 128 bytes
constexpr int kBoxBytes = kBlockK * kBox * 2;   // 8 KB, 1024-aligned
constexpr float kLog2e = 1.4426950408889634f;

template <int kD>
struct Tile {
  static constexpr int kBoxes = kD / kBox;
  static constexpr int kBytes = kBoxBytes * kBoxes;        // K or V tile
  static constexpr int kSmem = kStages * 2 * kBytes + 1024;  // + alignment
};

using sm90::desc_sw128;
using sm90::fence_regs;
using sm90::wgmma_commit;
using sm90::wgmma_fence;
using sm90::wgmma_m64n128k16;
using sm90::wgmma_m64n64k16;
using sm90::wgmma_wait_all;

// O[64 x kD] += P[64 x 16] * V[16 x kD], V read MN-major.
template <int kD>
__device__ __forceinline__ void wgmma_pv(float (&o)[kD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t desc) {
  wgmma_m64n64k16<1>(o, a, desc);
}
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc) {
  wgmma_m64n128k16<1>(o, a, desc);
}

// Box [1 head][64 rows][64 columns] of a [heads, S, d] bf16 tensor.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int col, int row, int head,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(head),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}

// The accumulator fragment of m64nNk16: thread t of the warpgroup holds,
// for each 8-column group j, d[4j], d[4j+1] at row 16*(t/32) + (t%32)/4,
// columns 8j + 2*(t%4) + {0, 1}, and d[4j+2], d[4j+3] at that row + 8. The
// register A fragment of k16 takes the same rows: {row, k0..k0+1},
// {row+8, k0..}, {row, k0+8..}, {row+8, k0+8..} with k0 = 2*(t%4).
template <int kD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  const __nv_bfloat16* __restrict__ q,
                  __nv_bfloat16* __restrict__ o, float* __restrict__ m_out,
                  float* __restrict__ l_out,
                  const int* __restrict__ valid_from,
                  const int* __restrict__ valid_to,
                  const int* __restrict__ q_offset, int nq, int nkv,
                  int t_len, int s_len, int d, int block_q, int causal,
                  int window, float sm_scale) {
  using T = Tile<kD>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_k[kStages], full_v[kStages],
      empty[kStages];
  unsigned char* tiles =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);

  const int group = nq / nkv;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * block_q;
  const int vf = valid_from[b], vt = valid_to[b], qoff = q_offset[b];

  // Live key range of this tile of query rows; tiles outside are skipped.
  const int t_last = min(t0 + block_q, t_len) - 1;
  const int pos_lo = t0 + qoff, pos_hi = t_last + qoff;
  int lo = max(vf, 0), hi = min(vt, s_len);
  if (causal) hi = min(hi, pos_hi + 1);
  if (window > 0) {
    lo = max(lo, (pos_lo / window) * window);
    hi = min(hi, (pos_hi / window + 1) * window);
  }
  const int first = (lo / kBlockK) * kBlockK;
  const int n_tiles = lo < hi ? (hi - first + kBlockK - 1) / kBlockK : 0;

  const int tid = threadIdx.x;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full_k[s], 1);
      sm90::mbar_init(&full_v[s], 1);
      sm90::mbar_init(&empty[s], kConsumers);   // the one group that reads it
    }
  }
  __syncthreads();

  if (tid >= kGroups * kConsumers) {
    // Producer: lane 0 keeps the ring full; the warp does nothing else.
    if (tid == kGroups * kConsumers) {
      const int head = b * nkv + h;
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % kStages;
        if (it >= kStages)
          sm90::mbar_wait(&empty[st], ((it / kStages) - 1) & 1);
        const int c0 = first + it * kBlockK;
        unsigned char* kt = tiles + st * 2 * T::kBytes;
        unsigned char* vtile = kt + T::kBytes;
        sm90::mbar_expect_tx(&full_k[st], T::kBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_3d(kt + x * kBoxBytes, &k_map, x * kBox, c0, head,
                      &full_k[st]);
        sm90::mbar_expect_tx(&full_v[st], T::kBytes);
#pragma unroll
        for (int x = 0; x < T::kBoxes; ++x)
          tma_load_3d(vtile + x * kBoxBytes, &v_map, x * kBox, c0, head,
                      &full_v[st]);
      }
    }
    return;
  }

  // Consumer warpgroups. Tile it sits in stage it % 4 and goes to group
  // it % 2, so each group double-buffers its own tiles.
  const int wg = tid / kConsumers;
  const int warp = (tid % kConsumers) >> 5, lane = tid & 31;
  const int cq = 2 * (lane & 3);
  const int rows_used = group * block_q;
  int row_lo[2], row_hi[2];
  bool row_ok[2];
  size_t row_idx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + (lane >> 2) + 8 * i;
    const int g = r / block_q, t = t0 + r % block_q;
    row_ok[i] = r < rows_used && t < t_len;
    row_idx[i] = row_ok[i] ? ((size_t)b * nq + h * group + g) * t_len + t : 0;
    const int pos = t + qoff;
    int rl = max(vf, 0), rh = min(vt, s_len);
    if (causal) rh = min(rh, pos + 1);
    if (window > 0) {
      rl = max(rl, (pos / window) * window);
      rh = min(rh, (pos / window + 1) * window);
    }
    row_lo[i] = row_ok[i] ? rl : 0;
    row_hi[i] = row_ok[i] ? rh : 0;
  }

  // Q as the register A operand, one k16 slice of head dims at a time.
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      const int i = x & 1;
      const int col = kk * 16 + cq + 8 * (x >> 1);
      qa[kk][x] = (row_ok[i] && col < d)
                      ? *reinterpret_cast<const uint32_t*>(
                            q + row_idx[i] * d + col)
                      : 0u;
    }
  }

  float o_acc[kD / 2];
#pragma unroll
  for (int i = 0; i < kD / 2; ++i) o_acc[i] = 0.f;
  const float scale_log2 = sm_scale * kLog2e;
  float m_run[2] = {kMaskValue, kMaskValue}, l_run[2] = {0.f, 0.f};

  for (int it = wg; it < n_tiles; it += kGroups) {
    const int st = it % kStages;
    const uint32_t par = (it / kStages) & 1;
    const int c0 = first + it * kBlockK;
    const uint32_t kt = smem_u32(tiles + st * 2 * T::kBytes);
    const uint32_t vtile = kt + T::kBytes;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    sm90::mbar_wait(&full_k[st], par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)   // K is K-major: 32 bytes a slice
      wgmma_m64n64k16<0>(
          s, qa[kk],
          desc_sw128(kt + (kk / 4) * kBoxBytes + (kk % 4) * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // Mask, then the online softmax in f32 on the fragment. A masked score
    // becomes -inf here, so it adds nothing to the max and its p is
    // 2^-inf = 0 without a test; m and l keep the TPU kernel's meaning
    // (m = MASK_VALUE while a row has seen no live key). A tile that is
    // live for both of this thread's rows skips the mask.
    if (!(row_lo[0] <= c0 && c0 + kBlockK <= row_hi[0] && row_lo[1] <= c0 &&
          c0 + kBlockK <= row_hi[1])) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int i = (x >> 1) & 1;
        const int c = c0 + 8 * (x >> 2) + cq + (x & 1);
        if (c < row_lo[i] || c >= row_hi[i]) s[x] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int x = 0; x < 32; ++x)
      mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
    float mneg[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // max(s) * scale == max(s * scale): the scale is positive
      const float m_new = fmaxf(
          m_run[i], mx[i] == -INFINITY ? kMaskValue : mx[i] * sm_scale);
      const float alpha = ex2((m_run[i] - m_new) * kLog2e);
      m_run[i] = m_new;
      l_run[i] *= alpha;
#pragma unroll
      for (int x = 2 * i; x < kD / 2; x += 4) {
        o_acc[x] *= alpha;
        o_acc[x + 1] *= alpha;
      }
      mneg[i] = m_new == kMaskValue ? -INFINITY : -m_new * kLog2e;
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int i = (x >> 1) & 1;
      s[x] = ex2(fmaf(s[x], scale_log2, mneg[i]));
      l_run[i] += s[x];
    }

    // P rounded to bf16 in registers: the A operand of P V.
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int x = 0; x < 4; ++x)
        pa[kk][x] = pack_bf16(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
    }

    sm90::mbar_wait(&full_v[st], par);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)   // V is MN-major: 16 keys = 2048 bytes
      wgmma_pv<kD>(o_acc, pa[kk],
                   desc_sw128(vtile + kk * 2048, kBoxBytes, 1024));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o_acc);
    sm90::mbar_arrive(&empty[st]);
  }

  // Merge the groups' (m, l, O): group 1 parks its state in its own ring
  // stages (1 and 3; it has waited for every tile they held), group 0
  // folds it in and writes the output.
  float l_sum[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_sum[i] = l_run[i];
    l_sum[i] += __shfl_xor_sync(0xffffffffu, l_sum[i], 1);
    l_sum[i] += __shfl_xor_sync(0xffffffffu, l_sum[i], 2);
  }
  const int ct = tid % kConsumers;
  float* park_o = reinterpret_cast<float*>(tiles + 2 * T::kBytes);
  float* park_ml = reinterpret_cast<float*>(tiles + 6 * T::kBytes);
  if (wg == 1) {
#pragma unroll
    for (int x = 0; x < kD / 2; ++x) park_o[x * kConsumers + ct] = o_acc[x];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      park_ml[i * kConsumers + ct] = m_run[i];
      park_ml[(2 + i) * kConsumers + ct] = l_sum[i];
    }
    asm volatile("bar.arrive 1, %0;\n" ::"n"(kGroups * kConsumers) : "memory");
    return;
  }
  asm volatile("bar.sync 1, %0;\n" ::"n"(kGroups * kConsumers) : "memory");
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float m1 = park_ml[i * kConsumers + ct];
    const float m = fmaxf(m_run[i], m1);
    const float a0 = ex2((m_run[i] - m) * kLog2e);
    const float a1 = ex2((m1 - m) * kLog2e);
    m_run[i] = m;
    l_sum[i] = l_sum[i] * a0 + park_ml[(2 + i) * kConsumers + ct] * a1;
#pragma unroll
    for (int x = 2 * i; x < kD / 2; x += 4) {
      o_acc[x] = o_acc[x] * a0 + park_o[x * kConsumers + ct] * a1;
      o_acc[x + 1] =
          o_acc[x + 1] * a0 + park_o[(x + 1) * kConsumers + ct] * a1;
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l = l_sum[i];
    if (!row_ok[i]) continue;
    const float l_safe = l == 0.f ? 1.f : l;
    __nv_bfloat16* orow = o + row_idx[i] * d;
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
      const int col = 8 * j + cq;
      if (col < d)
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o_acc[4 * j + 2 * i] / l_safe,
                                  o_acc[4 * j + 2 * i + 1] / l_safe);
    }
    if ((lane & 3) == 0) {
      m_out[row_idx[i]] = m_run[i];
      l_out[row_idx[i]] = l;
    }
  }
}

// K or V [heads, S, d] bf16, read in boxes of 64 rows x 64 columns with
// 128-byte swizzle; rows past S and columns past d read as zero.
bool kv_map(CUtensorMap* map, const void* base, int heads, int s_len, int d) {
  const sm90::EncodeTiled encode = sm90::tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)s_len,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)s_len * d * 2};
  const cuuint32_t box[3] = {kBox, kBlockK, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kD>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, const int* vf, const int* vt, const int* q_off, int b,
           int nq, int nkv, int t_len, int s_len, int d, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  static bool raised[sm90::kMaxDevices] = {};
  const cudaError_t err =
      sm90::max_smem(flash_bf16_kernel<kD>, Tile<kD>::kSmem, raised);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap k_map, v_map;
  if (!kv_map(&k_map, k, b * nkv, s_len, d) ||
      !kv_map(&v_map, v, b * nkv, s_len, d))
    return (int)cudaErrorInvalidValue;
  const int block_q = kRows / (nq / nkv);
  const dim3 grid((t_len + block_q - 1) / block_q, nkv, b);
  flash_bf16_kernel<kD><<<grid, kThreads, Tile<kD>::kSmem, stream>>>(
      k_map, v_map, static_cast<const __nv_bfloat16*>(q),
      static_cast<__nv_bfloat16*>(o), m, l, vf, vt, q_off, nq, nkv, t_len,
      s_len, d, block_q, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dtype: 0 = float32 (CUDA-core route), 1 = bfloat16 (wgmma + TMA route).
// Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   const void* valid_from,
                                   const void* valid_to, const void* q_offset,
                                   int b, int nq, int nkv, int t_len,
                                   int s_len, int d, int causal, int window,
                                   float sm_scale, void* stream) {
  if (d <= 0 || d > 128 || d % 8 != 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > 64 || s_len <= 0)
    return (int)cudaErrorInvalidValue;
  auto* m_f = static_cast<float*>(m);
  auto* l_f = static_cast<float*>(l);
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto* qo = static_cast<const int*>(q_offset);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return core::launch(static_cast<const float*>(q),
                        static_cast<const float*>(k),
                        static_cast<const float*>(v), static_cast<float*>(o),
                        m_f, l_f, vf, vt, qo, b, nq, nkv, t_len, s_len, d,
                        causal, window, sm_scale, st);
  if (dtype == 1 && d <= 64)
    return tc::launch<64>(q, k, v, o, m_f, l_f, vf, vt, qo, b, nq, nkv,
                          t_len, s_len, d, causal, window, sm_scale, st);
  if (dtype == 1)
    return tc::launch<128>(q, k, v, o, m_f, l_f, vf, vt, qo, b, nq, nkv,
                           t_len, s_len, d, causal, window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
