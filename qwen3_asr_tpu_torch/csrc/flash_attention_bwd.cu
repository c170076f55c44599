// Flash attention backward for Hopper (sm_90a), written by hand.
//
// The gradient of the function csrc/flash_attention.cu computes, which
// replaces the TPU kernel qwen3_asr_tpu/ops/flash_attention.py `_kernel`.
// There the backward is not a kernel: `_flash_diff_bwd` (:186) lets XLA
// differentiate the dense restatement `_xla_forward` (:203). This kernel
// computes that same gradient blockwise, never holding the [T, S] scores
// in device memory:
//
//   s  = q k^T * scale (f32 from the inputs), masked as the forward masks
//   A  = p / l_safe,  p = exp(s - m) where live, else 0 (m, l: the
//        forward's f32 residuals; l == 0 rows have no live key and A = 0)
//   dP = dO v^T,  D = rowsum(A o dP)  (= dO . O in exact arithmetic; taken
//        from A and dP so the forward's rounding of O to bf16 stays out)
//   dS = A o (dP - D)
//   dQ = scale dS k,  dK = scale dS^T q (summed over the G query heads of
//   each KV head),  dV = A^T dO (likewise)
//
// P is recomputed in f32 and never rounded to bf16: the backward is the
// gradient of the dense restatement, not of the forward kernel's rounding.
// Masked scores never enter an exponential (the mask is a predicate, and
// the forward's m is MASK_VALUE, finite, on a row with no live key).
//
// Two launches, no atomics, so a repeat call gives the same bits:
//   1. dq_kernel: one block per (tile of query rows, KV head, batch row),
//      64 rows = the tile for all G query heads, as the forward's blocks.
//      It walks the live key tiles (the forward's range: window, causal
//      limit, [valid_from, valid_to)), and per tile scores its rows
//      against 32 keys (lane = key), then accumulates sum_j A dP k_j and
//      sum_j A k_j (lane = head dim). At the end dQ = scale (sum A dP k -
//      D sum A k), and D goes to a [B, Nq, T] f32 scratch for pass 2.
//   2. dkv_kernel: one block per (tile of 64 keys, KV head, batch row); it
//      owns its keys' dK and dV in registers and walks the G query heads
//      and the tiles of 32 query rows whose mask reaches its keys (lane =
//      query row for the scores, lane = head dim for the sums).
// Head dims are a multiple of 4 (the operands are read four at a time).
// Inputs are f32 or bf16 (staged into shared memory as f32); outputs are
// written in the inputs' dtype; all arithmetic is f32 on the CUDA cores.
//
// What bounds it on the H100: at the main path's shapes (encoder windows
// of 104 keys, a training sequence of a few hundred tokens, D <= 128)
// the work is ~8 T * S_live * D flops per head pair, a bound of tens of
// microseconds on the tensor cores; this first version runs it on the
// CUDA cores (f32 FMAs), so it is bound by operations, and every
// mask-dead key tile is skipped in both passes. Moving the four products
// to mma/wgmma is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kDPerLane = kMaxD / 32;
constexpr unsigned kFull = 0xffffffffu;

// pass 1: 64 query rows a block, 8 a warp, key tiles of 32 (one a lane)
constexpr int kRowsPerWarp = 8;
constexpr int kRows = kWarps * kRowsPerWarp;
constexpr int kBlockK = 32;
// pass 2: 64 keys a block, 8 a warp, query tiles of 32 (one a lane)
constexpr int kKeysPerWarp = 8;
constexpr int kKeys = kWarps * kKeysPerWarp;
constexpr int kBlockQ = 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename X> __device__ __forceinline__ X from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

struct Mask {
  int vf, vt, qoff, s_len, causal, window;
  __device__ __forceinline__ bool live(int pos, int c) const {
    bool ok = c >= vf && c < vt && c < s_len;
    if (causal) ok = ok && c <= pos;
    if (window > 0) ok = ok && (pos / window == c / window);
    return ok;
  }
};

// Shared-memory layout. The operand a lane owns (a key in pass 1, a query
// row in pass 2) is staged transposed with rows of kPad = 33 floats, so a
// warp reading one element of each of 32 lanes' operands, or 32 head dims
// of one operand, hits 32 banks; the operand every lane shares is kept
// row-major and read as float4 broadcasts, four head dims (or keys, rows)
// an instruction.
constexpr int kPad = 33;

size_t dq_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kRows * d + 2 * (size_t)d * kPad +
                          2 * (size_t)kRows * kBlockK);
}

size_t dkv_smem_bytes(int d) {
  return sizeof(float) * (2 * (size_t)kKeys * d + 2 * (size_t)d * kPad +
                          2 * (size_t)kKeys * kBlockQ + 3 * kBlockQ);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, const float (&b)[4],
                                      float acc) {
  acc += a.x * b[0];
  acc += a.y * b[1];
  acc += a.z * b[2];
  return acc + a.w * b[3];
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const X* __restrict__ q, const X* __restrict__ k,
          const X* __restrict__ v, const X* __restrict__ dout,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          const int* __restrict__ valid_from, const int* __restrict__ valid_to,
          const int* __restrict__ q_offset, X* __restrict__ dq,
          float* __restrict__ delta, int nq, int nkv, int t_len, int s_len,
          int d, int block_q, int causal, int window, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int group = nq / nkv;
  const int h = blockIdx.y, b = blockIdx.z;
  const int t0 = blockIdx.x * block_q;
  float* q_s = smem;                     // [kRows][d]
  float* do_s = q_s + kRows * d;         // [kRows][d]
  float* kt_s = do_s + kRows * d;        // [d][kPad]: key j at column j
  float* vt_s = kt_s + d * kPad;         // [d][kPad]
  float* a_s = vt_s + d * kPad;          // [kRows][kBlockK]: A
  float* adp_s = a_s + kRows * kBlockK;  // [kRows][kBlockK]: A dP

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Mask mk{valid_from[b], valid_to[b], q_offset[b], s_len, causal,
                window};
  const int rows_used = group * block_q;

  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, dd = i - r * d;
    float x = 0.f, g = 0.f;
    if (r < rows_used) {
      const int t = t0 + r % block_q;
      if (t < t_len) {
        const size_t at =
            (((size_t)b * nq + h * group + r / block_q) * t_len + t) * d + dd;
        x = to_f32(q[at]);
        g = to_f32(dout[at]);
      }
    }
    q_s[i] = x;
    do_s[i] = g;
  }

  // the forward's live key range of this tile of query rows
  const int t_last = min(t0 + block_q, t_len) - 1;
  const int pos_lo = t0 + mk.qoff, pos_hi = t_last + mk.qoff;
  int lo = max(mk.vf, 0), hi = min(mk.vt, s_len);
  if (causal) hi = min(hi, pos_hi + 1);
  if (window > 0) {
    lo = max(lo, (pos_lo / window) * window);
    hi = min(hi, (pos_hi / window + 1) * window);
  }

  float row_m[kRowsPerWarp], row_linv[kRowsPerWarp], dsum[kRowsPerWarp];
  float acc_adp[kRowsPerWarp][kDPerLane], acc_a[kRowsPerWarp][kDPerLane];
  int row_pos[kRowsPerWarp];
  bool row_ok[kRowsPerWarp];
  size_t row_at[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = warp * kRowsPerWarp + i;
    const int t = t0 + r % block_q;
    row_ok[i] = r < rows_used && t < t_len;
    row_pos[i] = t + mk.qoff;
    row_at[i] = row_ok[i]
                    ? ((size_t)b * nq + h * group + r / block_q) * t_len + t
                    : 0;
    row_m[i] = row_ok[i] ? m_in[row_at[i]] : 0.f;
    const float l = row_ok[i] ? l_in[row_at[i]] : 0.f;
    row_linv[i] = 1.f / (l == 0.f ? 1.f : l);
    dsum[i] = 0.f;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc_adp[i][e] = acc_a[i][e] = 0.f;
  }

  const size_t head = ((size_t)b * nkv + h) * (size_t)s_len * d;
  const float* q_warp = q_s + warp * kRowsPerWarp * d;
  const float* do_warp = do_s + warp * kRowsPerWarp * d;
  float* a_warp = a_s + warp * kRowsPerWarp * kBlockK;
  float* adp_warp = adp_s + warp * kRowsPerWarp * kBlockK;

  for (int c0 = (lo / kBlockK) * kBlockK; lo < hi && c0 < hi; c0 += kBlockK) {
    __syncthreads();  // q and dO staged; the previous tile consumed
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int j = i / d, dd = i - j * d;
      const int c = c0 + j;
      float kx = 0.f, vx = 0.f;
      if (c < s_len) {
        kx = to_f32(k[head + (size_t)c * d + dd]);
        vx = to_f32(v[head + (size_t)c * d + dd]);
      }
      kt_s[dd * kPad + j] = kx;
      vt_s[dd * kPad + j] = vx;
    }
    __syncthreads();

    // lane = key c0 + lane: its score and dP against the warp's rows
    float s[kRowsPerWarp], dp[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = dp[i] = 0.f;
    for (int dd = 0; dd < d; dd += 4) {
      float kx[4], vx[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        kx[c] = kt_s[(dd + c) * kPad + lane];
        vx[c] = vt_s[(dd + c) * kPad + lane];
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        s[i] = dot4(ld4(q_warp + i * d + dd), kx, s[i]);
        dp[i] = dot4(ld4(do_warp + i * d + dd), vx, dp[i]);
      }
    }
    const int c = c0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const bool live = row_ok[i] && mk.live(row_pos[i], c);
      const float a =
          live ? expf(s[i] * sm_scale - row_m[i]) * row_linv[i] : 0.f;
      a_warp[i * kBlockK + lane] = a;
      adp_warp[i * kBlockK + lane] = a * dp[i];
      dsum[i] += a * dp[i];
    }
    __syncwarp();
    // lane = head dims lane + 32 e: sum_j A dP k_j and sum_j A k_j
    for (int j = 0; j < kBlockK; j += 4) {
      float kk[kDPerLane][4];
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) {
        const int dd = lane + 32 * e;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          kk[e][jj] = dd < d ? kt_s[dd * kPad + j + jj] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 a4 = ld4(a_warp + i * kBlockK + j);
        const float4 p4 = ld4(adp_warp + i * kBlockK + j);
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) {
          acc_adp[i][e] = dot4(p4, kk[e], acc_adp[i][e]);
          acc_a[i][e] = dot4(a4, kk[e], acc_a[i][e]);
        }
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const float dsum_row = warp_sum(dsum[i]);   // every lane: same bits
    if (!row_ok[i]) continue;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int dd = lane + 32 * e;
      if (dd < d)
        dq[row_at[i] * d + dd] = from_f32<X>(
            sm_scale * (acc_adp[i][e] - dsum_row * acc_a[i][e]));
    }
    if (lane == 0) delta[row_at[i]] = dsum_row;
  }
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const X* __restrict__ q, const X* __restrict__ k,
           const X* __restrict__ v, const X* __restrict__ dout,
           const float* __restrict__ m_in, const float* __restrict__ l_in,
           const float* __restrict__ delta,
           const int* __restrict__ valid_from, const int* __restrict__ valid_to,
           const int* __restrict__ q_offset, X* __restrict__ dk_out,
           X* __restrict__ dv_out, int nq, int nkv, int t_len, int s_len,
           int d, int causal, int window, float sm_scale) {
  extern __shared__ __align__(16) float smem[];
  const int group = nq / nkv;
  const int h = blockIdx.y, b = blockIdx.z;
  const int c0 = blockIdx.x * kKeys;
  float* k_s = smem;                       // [kKeys][d]
  float* v_s = k_s + kKeys * d;            // [kKeys][d]
  float* qt_s = v_s + kKeys * d;           // [d][kPad]: row r at column r
  float* dot_s = qt_s + d * kPad;          // [d][kPad]
  float* a_s = dot_s + d * kPad;           // [kKeys][kBlockQ]: A
  float* ds_s = a_s + kKeys * kBlockQ;     // [kKeys][kBlockQ]: dS
  float* m_s = ds_s + kKeys * kBlockQ;     // [kBlockQ]
  float* linv_s = m_s + kBlockQ;
  float* dl_s = linv_s + kBlockQ;          // D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Mask mk{valid_from[b], valid_to[b], q_offset[b], s_len, causal,
                window};
  const size_t head = ((size_t)b * nkv + h) * (size_t)s_len * d;

  for (int i = tid; i < kKeys * d; i += kThreads) {
    const int j = i / d, dd = i - j * d;
    const int c = c0 + j;
    float kx = 0.f, vx = 0.f;
    if (c < s_len) {
      kx = to_f32(k[head + (size_t)c * d + dd]);
      vx = to_f32(v[head + (size_t)c * d + dd]);
    }
    k_s[i] = kx;
    v_s[i] = vx;
  }

  // query rows whose mask reaches a key of this block
  const int klo = max(c0, mk.vf);
  const int khi = min(min(c0 + kKeys, s_len), mk.vt);
  long long pos_lo = -(1ll << 40), pos_hi = 1ll << 40;   // [lo, hi)
  if (causal) pos_lo = klo;
  if (window > 0) {
    const long long w_lo = (long long)(klo / window) * window;
    pos_lo = pos_lo > w_lo ? pos_lo : w_lo;
    pos_hi = (long long)((khi - 1) / window + 1) * window;
  }
  const long long t_lo_ll = pos_lo - mk.qoff, t_hi_ll = pos_hi - mk.qoff;
  const int t_lo = t_lo_ll < 0 ? 0 : (int)(t_lo_ll > t_len ? t_len : t_lo_ll);
  const int t_hi = t_hi_ll > t_len ? t_len : (int)(t_hi_ll < 0 ? 0 : t_hi_ll);

  float acc_dk[kKeysPerWarp][kDPerLane], acc_dv[kKeysPerWarp][kDPerLane];
#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j)
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;

  const float* k_warp = k_s + warp * kKeysPerWarp * d;
  const float* v_warp = v_s + warp * kKeysPerWarp * d;
  float* a_warp = a_s + warp * kKeysPerWarp * kBlockQ;
  float* ds_warp = ds_s + warp * kKeysPerWarp * kBlockQ;

  for (int g = 0; klo < khi && g < group; ++g) {
    const size_t qhead = ((size_t)b * nq + h * group + g) * t_len;
    for (int tq = t_lo; tq < t_hi; tq += kBlockQ) {
      __syncthreads();  // keys staged; the previous tile consumed
      for (int i = tid; i < kBlockQ * d; i += kThreads) {
        const int r = i / d, dd = i - r * d;
        const int t = tq + r;
        float x = 0.f, gr = 0.f;
        if (t < t_hi) {
          x = to_f32(q[(qhead + t) * d + dd]);
          gr = to_f32(dout[(qhead + t) * d + dd]);
        }
        qt_s[dd * kPad + r] = x;
        dot_s[dd * kPad + r] = gr;
      }
      if (tid < kBlockQ) {
        const int t = tq + tid;
        const float l = t < t_hi ? l_in[qhead + t] : 0.f;
        m_s[tid] = t < t_hi ? m_in[qhead + t] : 0.f;
        linv_s[tid] = 1.f / (l == 0.f ? 1.f : l);
        dl_s[tid] = t < t_hi ? delta[qhead + t] : 0.f;
      }
      __syncthreads();

      // lane = query row tq + lane, against the warp's keys
      float s[kKeysPerWarp], dp[kKeysPerWarp];
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) s[j] = dp[j] = 0.f;
      for (int dd = 0; dd < d; dd += 4) {
        float qx[4], gx[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          qx[c] = qt_s[(dd + c) * kPad + lane];
          gx[c] = dot_s[(dd + c) * kPad + lane];
        }
#pragma unroll
        for (int j = 0; j < kKeysPerWarp; ++j) {
          s[j] = dot4(ld4(k_warp + j * d + dd), qx, s[j]);
          dp[j] = dot4(ld4(v_warp + j * d + dd), gx, dp[j]);
        }
      }
      const int t = tq + lane;
      const bool row_ok = t < t_hi;
      const int pos = t + mk.qoff;
#pragma unroll
      for (int j = 0; j < kKeysPerWarp; ++j) {
        const int c = c0 + warp * kKeysPerWarp + j;
        const bool live = row_ok && mk.live(pos, c);
        const float a =
            live ? expf(s[j] * sm_scale - m_s[lane]) * linv_s[lane] : 0.f;
        a_warp[j * kBlockQ + lane] = a;
        ds_warp[j * kBlockQ + lane] = a * (dp[j] - dl_s[lane]);
      }
      __syncwarp();

      // lane = head dims lane + 32 e: dV += A^T dO, dK += dS^T q, four
      // rows at a time (rows past the tile's end hold zeros)
      const int rows = min(kBlockQ, t_hi - tq);
      for (int r = 0; r < rows; r += 4) {
        float qv[kDPerLane][4], gv[kDPerLane][4];
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) {
          const int dd = lane + 32 * e;
#pragma unroll
          for (int rr = 0; rr < 4; ++rr) {
            qv[e][rr] = dd < d ? qt_s[dd * kPad + r + rr] : 0.f;
            gv[e][rr] = dd < d ? dot_s[dd * kPad + r + rr] : 0.f;
          }
        }
#pragma unroll
        for (int j = 0; j < kKeysPerWarp; ++j) {
          const float4 a4 = ld4(a_warp + j * kBlockQ + r);
          const float4 ds4 = ld4(ds_warp + j * kBlockQ + r);
#pragma unroll
          for (int e = 0; e < kDPerLane; ++e) {
            acc_dv[j][e] = dot4(a4, gv[e], acc_dv[j][e]);
            acc_dk[j][e] = dot4(ds4, qv[e], acc_dk[j][e]);
          }
        }
      }
      __syncwarp();
    }
  }

#pragma unroll
  for (int j = 0; j < kKeysPerWarp; ++j) {
    const int c = c0 + warp * kKeysPerWarp + j;
    if (c >= s_len) continue;
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int dd = lane + 32 * e;
      if (dd < d) {
        dk_out[head + (size_t)c * d + dd] = from_f32<X>(sm_scale * acc_dk[j][e]);
        dv_out[head + (size_t)c * d + dd] = from_f32<X>(acc_dv[j][e]);
      }
    }
  }
}

template <typename X>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* m, const float* l, const int* vf, const int* vt,
           const int* q_off, void* dq, void* dk, void* dv, float* delta, int b,
           int nq, int nkv, int t_len, int s_len, int d, int causal,
           int window, float sm_scale, cudaStream_t stream) {
  // Above 48 KB only after opting in; once per device, for the largest
  // head dim, so no later launch (nor a graph capture) repeats it.
  static bool raised_dq[sm90::kMaxDevices] = {};
  static bool raised_dkv[sm90::kMaxDevices] = {};
  cudaError_t err =
      sm90::max_smem(dq_kernel<X>, (int)dq_smem_bytes(kMaxD), raised_dq);
  if (err == cudaSuccess)
    err = sm90::max_smem(dkv_kernel<X>, (int)dkv_smem_bytes(kMaxD),
                         raised_dkv);
  if (err != cudaSuccess) return (int)err;
  const X* qx = static_cast<const X*>(q);
  const X* kx = static_cast<const X*>(k);
  const X* vx = static_cast<const X*>(v);
  const X* gx = static_cast<const X*>(dout);
  const int block_q = kRows / (nq / nkv);
  const dim3 grid_q((t_len + block_q - 1) / block_q, nkv, b);
  dq_kernel<X><<<grid_q, kThreads, dq_smem_bytes(d), stream>>>(
      qx, kx, vx, gx, m, l, vf, vt, q_off, static_cast<X*>(dq), delta, nq,
      nkv, t_len, s_len, d, block_q, causal, window, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((s_len + kKeys - 1) / kKeys, nkv, b);
  dkv_kernel<X><<<grid_k, kThreads, dkv_smem_bytes(d), stream>>>(
      qx, kx, vx, gx, m, l, delta, vf, vt, q_off, static_cast<X*>(dk),
      static_cast<X*>(dv), nq, nkv, t_len, s_len, d, causal, window,
      sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout, dq, dk, dv); m, l and
// the delta scratch ([B, Nq, T]) are f32. Two launches on `stream`.
// Returns the first launch error (cudaError_t), 0 on success.
extern "C" int flash_attention_bwd(int dtype, const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* m, const void* l,
                                   const void* valid_from,
                                   const void* valid_to, const void* q_offset,
                                   void* dq, void* dk, void* dv, void* delta,
                                   int b, int nq, int nkv, int t_len,
                                   int s_len, int d, int causal, int window,
                                   float sm_scale, void* stream) {
  if (d <= 0 || d > kMaxD || d % 4 != 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > kRows || s_len <= 0 || t_len <= 0 || b <= 0)
    return (int)cudaErrorInvalidValue;
  auto* m_f = static_cast<const float*>(m);
  auto* l_f = static_cast<const float*>(l);
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto* qo = static_cast<const int*>(q_offset);
  auto* dl = static_cast<float*>(delta);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, dout, m_f, l_f, vf, vt, qo, dq, dk, dv, dl,
                         b, nq, nkv, t_len, s_len, d, causal, window,
                         sm_scale, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, m_f, l_f, vf, vt, qo, dq, dk,
                                 dv, dl, b, nq, nkv, t_len, s_len, d, causal,
                                 window, sm_scale, st);
  return (int)cudaErrorInvalidValue;
}
