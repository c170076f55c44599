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
// Design. One block per (tile of query rows, KV head, batch row); the block's
// 64 rows are the tile's rows for ALL G query heads of the KV head
// (row r = g * block_q + t_local, block_q = 64 / G), so each K/V tile is read
// once for the whole group. Four warps own 16 rows each. K/V tiles of 32 keys
// are staged in shared memory as f32; lane j of a warp scores key j against
// the warp's rows, the warp reduces max and sum with shuffles, and each lane
// accumulates P.V for the head dims lane, lane+32, ... (up to 128). All
// arithmetic and statistics are f32. KV tiles outside the tile's live key
// range (window, causal limit, [valid_from, valid_to)) are never loaded.
//
// What bounds it: on the CUDA cores in f32, reads of the shared-memory Q
// tile dominate; the tensor cores (wgmma), TMA and a deeper pipeline are for
// a later change. The dynamic shared memory exceeds 48 KB at head_dim 128 and
// is raised once with cudaFuncSetAttribute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 16;
constexpr int kRows = kWarps * kRowsPerWarp;   // query rows per block
constexpr int kBlockK = 32;                     // keys per tile, one per lane
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr float kMaskValue = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
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
        x = to_f32(q[(((size_t)b * nq + h * group + g) * t_len + t) * d + dd]);
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
  const T* k_head = k + head;
  const T* v_head = v + head;
  const float* q_warp = q_s + warp * kRowsPerWarp * d;
  float* p_warp = p_s + warp * kRowsPerWarp * kBlockK;

  for (int c0 = (lo / kBlockK) * kBlockK; lo < hi && c0 < hi; c0 += kBlockK) {
    __syncthreads();  // Q staged; the previous tile fully consumed
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int j = i / d, dd = i - (i / d) * d;
      const int c = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (c < s_len) {
        kx = to_f32(k_head[(size_t)c * d + dd]);
        vx = to_f32(v_head[(size_t)c * d + dd]);
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
      if (dd < d) store(&o[row * d + dd], acc[i][e] / l_safe);
    }
    if (lane == 0) {
      m_out[row] = m_run[i];
      l_out[row] = l_run[i];
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* m,
           float* l, const int* vf, const int* vt, const int* q_off, int b,
           int nq, int nkv, int t_len, int s_len, int d, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  const int group = nq / nkv;
  const int block_q = kRows / group;
  // Above 48 KB only after opting in; once per instantiation, for the
  // largest head dim, so no launch (nor a graph capture) repeats it.
  static bool smem_raised = false;
  if (!smem_raised) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(kMaxD));
    if (err != cudaSuccess) return (int)err;
    smem_raised = true;
  }
  const size_t smem = smem_bytes(d);
  const dim3 grid((t_len + block_q - 1) / block_q, nkv, b);
  flash_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), m, l, vf, vt, q_off, nq,
      nkv, t_len, s_len, d, block_q, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, void* o, void* m, void* l,
                                   const void* valid_from,
                                   const void* valid_to, const void* q_offset,
                                   int b, int nq, int nkv, int t_len,
                                   int s_len, int d, int causal, int window,
                                   float sm_scale, void* stream) {
  if (d <= 0 || d > kMaxD || d % 8 != 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > kRows)
    return (int)cudaErrorInvalidValue;
  auto* m_f = static_cast<float*>(m);
  auto* l_f = static_cast<float*>(l);
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto* qo = static_cast<const int*>(q_offset);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, o, m_f, l_f, vf, vt, qo, b, nq, nkv, t_len,
                         s_len, d, causal, window, sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, o, m_f, l_f, vf, vt, qo, b, nq, nkv,
                                 t_len, s_len, d, causal, window, sm_scale,
                                 st);
  return (int)cudaErrorInvalidValue;
}
