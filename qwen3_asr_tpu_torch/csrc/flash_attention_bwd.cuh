// Flash attention backward for Hopper (sm_90a): the kernels and their
// launchers, shared by flash_attention_bwd.cu (the entries without
// cotangents on m and l) and flash_attention_bwd_ml.cu (the m/l route),
// two sources so that nvcc builds the two sets of instantiations in
// parallel. flash_attention_bwd.cu says what the kernels compute.

#pragma once

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

template <typename X, bool kML>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const X* __restrict__ q, const X* __restrict__ k,
          const X* __restrict__ v, const X* __restrict__ dout,
          const float* __restrict__ m_in, const float* __restrict__ l_in,
          const int* __restrict__ valid_from, const int* __restrict__ valid_to,
          const int* __restrict__ q_offset, X* __restrict__ dq,
          float* __restrict__ delta, const float* __restrict__ dl_in,
          const float* __restrict__ tie_dq, int nq, int nkv, int t_len,
          int s_len, int d, int block_q, int causal, int window,
          float sm_scale) {
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
    float dsum_row = warp_sum(dsum[i]);   // every lane: same bits
    if (!row_ok[i]) continue;
    if constexpr (kML) {
      // D' = D - dl l: the cotangent on l, folded into D
      if (dl_in != nullptr)
        dsum_row -= dl_in[row_at[i]] * l_in[row_at[i]];
    }
#pragma unroll
    for (int e = 0; e < kDPerLane; ++e) {
      const int dd = lane + 32 * e;
      if (dd < d) {
        float x = sm_scale * (acc_adp[i][e] - dsum_row * acc_a[i][e]);
        if constexpr (kML) x += tie_dq[row_at[i] * d + dd];
        dq[row_at[i] * d + dd] = from_f32<X>(x);
      }
    }
    if (lane == 0) delta[row_at[i]] = dsum_row;
  }
}

template <typename X, bool kML>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(const X* __restrict__ q, const X* __restrict__ k,
           const X* __restrict__ v, const X* __restrict__ dout,
           const float* __restrict__ m_in, const float* __restrict__ l_in,
           const float* __restrict__ delta,
           const int* __restrict__ valid_from, const int* __restrict__ valid_to,
           const int* __restrict__ q_offset, X* __restrict__ dk_out,
           X* __restrict__ dv_out, const float* __restrict__ tie_dk, int nq,
           int nkv, int t_len, int s_len, int d, int causal, int window,
           float sm_scale) {
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
        float x = sm_scale * acc_dk[j][e];
        if constexpr (kML) x += tie_dk[head + (size_t)c * d + dd];
        dk_out[head + (size_t)c * d + dd] = from_f32<X>(x);
        dv_out[head + (size_t)c * d + dd] = from_f32<X>(acc_dv[j][e]);
      }
    }
  }
}

template <typename X, bool kML = false>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* m, const float* l, const int* vf, const int* vt,
           const int* q_off, void* dq, void* dk, void* dv, float* delta, int b,
           int nq, int nkv, int t_len, int s_len, int d, int causal,
           int window, float sm_scale, cudaStream_t stream,
           const float* dl = nullptr, const float* tie_dq = nullptr,
           const float* tie_dk = nullptr) {
  // Above 48 KB only after opting in; once per device, for the largest
  // head dim, so no later launch (nor a graph capture) repeats it.
  static bool raised_dq[sm90::kMaxDevices] = {};
  static bool raised_dkv[sm90::kMaxDevices] = {};
  cudaError_t err = sm90::max_smem(dq_kernel<X, kML>,
                                   (int)dq_smem_bytes(kMaxD), raised_dq);
  if (err == cudaSuccess)
    err = sm90::max_smem(dkv_kernel<X, kML>, (int)dkv_smem_bytes(kMaxD),
                         raised_dkv);
  if (err != cudaSuccess) return (int)err;
  const X* qx = static_cast<const X*>(q);
  const X* kx = static_cast<const X*>(k);
  const X* vx = static_cast<const X*>(v);
  const X* gx = static_cast<const X*>(dout);
  const int block_q = kRows / (nq / nkv);
  const dim3 grid_q((t_len + block_q - 1) / block_q, nkv, b);
  dq_kernel<X, kML><<<grid_q, kThreads, dq_smem_bytes(d), stream>>>(
      qx, kx, vx, gx, m, l, vf, vt, q_off, static_cast<X*>(dq), delta, dl,
      tie_dq, nq, nkv, t_len, s_len, d, block_q, causal, window, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_k((s_len + kKeys - 1) / kKeys, nkv, b);
  dkv_kernel<X, kML><<<grid_k, kThreads, dkv_smem_bytes(d), stream>>>(
      qx, kx, vx, gx, m, l, delta, vf, vt, q_off, static_cast<X*>(dk),
      static_cast<X*>(dv), tie_dk, nq, nkv, t_len, s_len, d, causal, window,
      sm_scale);
  return (int)cudaGetLastError();
}


// The keys a query position's mask keeps: every mask of the forward
// (valid range, the S tail, causal, window block) is an interval of keys,
// so their intersection [lo, hi) is one too; a pair is live iff
// lo <= key < hi. Computed once a row, so no element divides by the
// window.
struct Span {
  int lo, hi;
};
__device__ __forceinline__ Span live_span(const Mask& mk, int pos) {
  int lo = max(mk.vf, 0), hi = min(mk.vt, mk.s_len);
  if (mk.causal) hi = min(hi, pos + 1);
  if (mk.window > 0) {
    const int w0 = (pos / mk.window) * mk.window;
    lo = max(lo, w0);
    hi = min(hi, w0 + mk.window);
  }
  return {lo, hi};
}

// ---------------------------------------------------------------------------
// Cotangents on the residuals m and l (the m/l route). JAX differentiates
// all three outputs of its dense restatement; with dm, dl the cotangents
// on m, l (absent = 0) and A = p / l, the gradient on a live score is
//
//   dS_ij = A_ij (dP_ij - D_i + dl_i l_i) + (dm_i - dl_i l_i) [s_ij = m_i] / c_i
//
// (c_i the row's tied maxima, as jnp.max's derivative splits its
// cotangent; rows with l = 0 get nothing). The first term is the usual
// backward with D' = D - dl l in place of D, so passes 1 and 2 take it by
// folding dl l into D. The second reaches dQ_i (scale coef_i sum of the
// tied keys) and each tied key's dK (scale coef_i q_i), coef_i = (dm_i -
// dl_i l_i) / c_i. Two more launches, ahead of the passes, find the ties
// from the backward's own scores (not the forward's m, which the
// tensor-core forward need not reproduce bit for bit) and write these two
// terms to f32 scratch, which pass 1 and pass 2 add before their one
// rounding:
//   tie_rows_kernel: a warp a query row walks its live keys, keeps the row
//     maximum, its count and the sum of its tied keys, and writes (max,
//     coef) and the dQ term;
//   tie_keys_kernel: a warp a key walks the query rows whose mask reaches
//     it, in a fixed order, and adds coef_i q_i where the row's score
//     equals its maximum: the key owns its dK term, so no two warps write
//     one key and no atomics are needed.
// Both score a (row, key) pair with one function (warp_dot, the lanes
// over the head dim, a butterfly sum), so they find the same ties.

__device__ __forceinline__ float warp_dot(const float (&a)[kDPerLane],
                                          const float (&b)[kDPerLane]) {
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) acc = fmaf(a[e], b[e], acc);
  return warp_sum(acc);   // every lane: same bits
}

template <typename X>
__device__ __forceinline__ void load_row(const X* __restrict__ p, int d,
                                         int lane, float (&r)[kDPerLane]) {
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) {
    const int dd = lane + 32 * e;
    r[e] = dd < d ? to_f32(p[dd]) : 0.f;
  }
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
tie_rows_kernel(const X* __restrict__ q, const X* __restrict__ k,
                const float* __restrict__ l_in, const float* __restrict__ dm,
                const float* __restrict__ dl,
                const int* __restrict__ valid_from,
                const int* __restrict__ valid_to,
                const int* __restrict__ q_offset, float2* __restrict__ tie_row,
                float* __restrict__ tie_dq, int batch, int nq, int nkv,
                int t_len, int s_len, int d, int causal, int window,
                float sm_scale) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= (long long)batch * nq * t_len) return;
  const int t = (int)(row % t_len);
  const int head = (int)((row / t_len) % nq), b = (int)(row / t_len / nq);
  const int h = head / (nq / nkv);
  const Mask mk{valid_from[b], valid_to[b], q_offset[b], s_len, causal,
                window};
  const Span sp = live_span(mk, t + mk.qoff);
  const X* kh = k + ((size_t)b * nkv + h) * (size_t)s_len * d;
  float qv[kDPerLane], sum_k[kDPerLane];
  load_row(q + (size_t)row * d, d, lane, qv);
  float mx = -INFINITY;
  int count = 0;
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) sum_k[e] = 0.f;
  for (int c = sp.lo; c < sp.hi; ++c) {
    float kv[kDPerLane];
    load_row(kh + (size_t)c * d, d, lane, kv);
    const float s = warp_dot(qv, kv);
    if (s > mx) {
      mx = s;
      count = 1;
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) sum_k[e] = kv[e];
    } else if (s == mx) {
      ++count;
#pragma unroll
      for (int e = 0; e < kDPerLane; ++e) sum_k[e] += kv[e];
    }
  }
  const float l = l_in[row];
  float coef = 0.f;
  if (count > 0 && l != 0.f)
    coef = ((dm != nullptr ? dm[row] : 0.f) -
            (dl != nullptr ? dl[row] * l : 0.f)) / (float)count;
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) {
    const int dd = lane + 32 * e;
    if (dd < d) tie_dq[(size_t)row * d + dd] = sm_scale * coef * sum_k[e];
  }
  if (lane == 0) tie_row[row] = make_float2(mx, coef);
}

template <typename X>
__global__ void __launch_bounds__(kThreads)
tie_keys_kernel(const X* __restrict__ q, const X* __restrict__ k,
                const float2* __restrict__ tie_row,
                const int* __restrict__ valid_from,
                const int* __restrict__ valid_to,
                const int* __restrict__ q_offset, float* __restrict__ tie_dk,
                int batch, int nq, int nkv, int t_len, int s_len, int d,
                int causal, int window, float sm_scale) {
  const int lane = threadIdx.x & 31;
  const long long key = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (key >= (long long)batch * nkv * s_len) return;
  const int c = (int)(key % s_len);
  const int h = (int)((key / s_len) % nkv), b = (int)(key / s_len / nkv);
  const int group = nq / nkv;
  const Mask mk{valid_from[b], valid_to[b], q_offset[b], s_len, causal,
                window};
  float kv[kDPerLane], acc[kDPerLane];
  load_row(k + (size_t)key * d, d, lane, kv);
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) acc[e] = 0.f;
  // the query positions whose mask can reach key c, as pass 2 bounds them
  long long pos_lo = -(1ll << 40), pos_hi = 1ll << 40;
  if (causal) pos_lo = c;
  if (window > 0) {
    const long long w_lo = (long long)(c / window) * window;
    pos_lo = pos_lo > w_lo ? pos_lo : w_lo;
    pos_hi = w_lo + window;
  }
  const long long lo_ll = pos_lo - mk.qoff, hi_ll = pos_hi - mk.qoff;
  const int t_lo = lo_ll < 0 ? 0 : (int)(lo_ll > t_len ? t_len : lo_ll);
  const int t_hi = hi_ll > t_len ? t_len : (int)(hi_ll < 0 ? 0 : hi_ll);
  const bool key_ok = c >= mk.vf && c < mk.vt;
  for (int g = 0; key_ok && g < group; ++g) {
    const size_t qhead = ((size_t)b * nq + h * group + g) * t_len;
    for (int t = t_lo; t < t_hi; ++t) {
      const float2 tr = tie_row[qhead + t];   // (row max, coef)
      if (tr.y == 0.f) continue;
      const Span sp = live_span(mk, t + mk.qoff);
      if (c < sp.lo || c >= sp.hi) continue;
      float qv[kDPerLane];
      load_row(q + (qhead + t) * d, d, lane, qv);
      if (warp_dot(qv, kv) == tr.x) {
#pragma unroll
        for (int e = 0; e < kDPerLane; ++e) acc[e] = fmaf(tr.y, qv[e], acc[e]);
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kDPerLane; ++e) {
    const int dd = lane + 32 * e;
    if (dd < d) tie_dk[(size_t)key * d + dd] = sm_scale * acc[e];
  }
}

// The two tie launches; then the passes take dl and the scratch.
template <typename X>
int launch_ties(const X* q, const X* k, const float* l, const float* dm,
                const float* dl, const int* vf, const int* vt,
                const int* q_off, float2* tie_row, float* tie_dq,
                float* tie_dk, int b, int nq, int nkv, int t_len, int s_len,
                int d, int causal, int window, float sm_scale,
                cudaStream_t stream) {
  const long long rows = (long long)b * nq * t_len;
  tie_rows_kernel<X><<<(unsigned)((rows + kWarps - 1) / kWarps), kThreads, 0,
                       stream>>>(q, k, l, dm, dl, vf, vt, q_off, tie_row,
                                 tie_dq, b, nq, nkv, t_len, s_len, d, causal,
                                 window, sm_scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long keys = (long long)b * nkv * s_len;
  tie_keys_kernel<X><<<(unsigned)((keys + kWarps - 1) / kWarps), kThreads, 0,
                       stream>>>(q, k, tie_row, vf, vt, q_off, tie_dk, b, nq,
                                 nkv, t_len, s_len, d, causal, window,
                                 sm_scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 inputs, head dims a multiple of 16 up to 128.
//
// The same two passes, every product on mma.sync m16n8k16 (bf16 operands,
// f32 sums). QK^T and dO V^T take the bf16 inputs as they are: their
// products are exact in f32, so only the order of the f32 sums differs
// from the CUDA-core route. The three products with A or dS (pass 1: sum_j
// A dP k_j and sum_j A k_j; pass 2: dV = A^T dO and dK = dS^T q) split the
// f32 operand into hi = bf16(x) and lo = bf16(x - hi) and take both
// products against the bf16 input, so A and dS keep ~16 bits and are never
// rounded to bf16 as SDPA's and FlashAttention-2's backward round them.
// Operands reach the tensor cores by ldmatrix from shared memory rows
// padded by 16 bytes (the 8 rows of an 8x8 matrix on 8 distinct bank
// groups); a score tile's accumulators become the next product's A
// operand in registers (the m16n8 C layout is the m16k16 A layout).
//   pass 1 (tc_dq_kernel): 4 warps x 16 query rows (the tile for all G
//     heads, as the CUDA-core route); q and dO stay in shared memory; key
//     tiles of 32 stream through a two-stage cp.async ring.
//   pass 2 (tc_dkv_kernel): 64 keys a block, 16 a warp, in two streams
//     of 4 warps that take alternate tiles of 32 query rows (the G query
//     heads' in turn), so the longest walk (the first key block under the
//     causal mask) is half as long; K and V stay in shared memory, pairs
//     of tiles (and their D, m, l and live keys) stream through a
//     two-stage cp.async ring, and the second stream's sums are added to
//     the first's through shared memory at the end, in a fixed order.
// The grid is one-dimensional and launches the longest blocks first: under
// the causal mask a low key block (pass 2) or a high query tile (pass 1)
// walks the most tiles, so the block index counts (b, KV head) fastest and
// the tile by descending work slowest; when the grid is more than one wave
// the short blocks fill in behind the long ones. ops/flash_attention.py
// `bwd_plan` restates this order and each block's walk; a CPU test holds
// it to cover every live (query row, key) pair once in each pass.

namespace tc {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxD = 128;
constexpr int kNT = kMaxD / 8;     // m16n8 tiles across the head dim
constexpr int kKS = kMaxD / 16;    // k16 steps across the head dim
constexpr int kPad = 8;            // bf16 elements of padding a row
constexpr int kRows = kWarps * 16; // pass 1: query rows a block
constexpr int kBlockK = 32;        // pass 1: keys a tile
constexpr int kKeys = kWarps * 16; // pass 2: keys a block
constexpr int kBlockQ = 32;        // pass 2: query rows a tile
constexpr int kDkvThreads = 2 * kThreads;   // pass 2: two tile streams
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

// 16 bytes from device to shared memory, or 16 zero bytes where !pred
__device__ __forceinline__ void cp16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp8(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   sm90::smem_u32(dst)),
               "l"(src), "r"(pred ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kLeft>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kLeft) : "memory");
}

__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
__device__ __forceinline__ void split(float x0, float x1, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = pack(h);
  lo = pack(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// The A operand (16 rows x 16 of k) of k-step kk from m16n8 accumulators
// whose columns are that k: tiles 2 kk and 2 kk + 1, split hi / lo.
__device__ __forceinline__ void a_split(const float (&c)[4][4], int kk,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

size_t dq_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(d + kPad) * (2 * kRows + 4 * kBlockK);
}
size_t dkv_smem_bytes(int d) {
  return sizeof(bf16) * (size_t)(d + kPad) * (2 * kKeys + 8 * kBlockQ) +
         (sizeof(float2) + sizeof(int) * 2) * 4 * kBlockQ;
}

template <bool kML>
__global__ void __launch_bounds__(kThreads, 2)
tc_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ m_in, const float* __restrict__ l_in,
             const int* __restrict__ valid_from,
             const int* __restrict__ valid_to, const int* __restrict__ q_offset,
             bf16* __restrict__ dq, float2* __restrict__ delta,
             const float* __restrict__ dl_in, const float* __restrict__ tie_dq,
             int batch, int nq, int nkv, int t_len, int s_len, int d,
             int block_q, int causal, int window, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = d + kPad;
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kRows][stride]
  bf16* do_s = q_s + kRows * stride;               // [kRows][stride]
  bf16* k_s = do_s + kRows * stride;               // [2][kBlockK][stride]
  bf16* v_s = k_s + 2 * kBlockK * stride;          // [2][kBlockK][stride]

  const int group = nq / nkv;
  const int tiles = (t_len + block_q - 1) / block_q;
  const int hb = blockIdx.x % (nkv * batch), rank = blockIdx.x / (nkv * batch);
  const int h = hb % nkv, b = hb / nkv;
  // under the causal mask the last query tile walks the most keys: first
  const int t0 = (causal ? tiles - 1 - rank : rank) * block_q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g8 = lane >> 2, t4 = lane & 3;
  const Mask mk{valid_from[b], valid_to[b], q_offset[b], s_len, causal,
                window};
  const int rows_used = group * block_q;
  const int chunks = d / 8;   // 16-byte pieces a row

  // q and dO of the block's rows (G heads x block_q positions)
  for (int i = tid; i < kRows * chunks; i += kThreads) {
    const int r = i / chunks, c = i - r * chunks;
    const int t = t0 + r % block_q;
    const bool ok = r < rows_used && t < t_len;
    const size_t at =
        ok ? ((((size_t)b * nq + h * group + r / block_q) * t_len + t) * d +
              c * 8)
           : 0;
    cp16(q_s + r * stride + c * 8, q + at, ok);
    cp16(do_s + r * stride + c * 8, dout + at, ok);
  }
  cp_commit();

  // the forward's live key range of this tile of query rows
  const int t_last = min(t0 + block_q, t_len) - 1;
  const int pos_lo = t0 + mk.qoff, pos_hi = t_last + mk.qoff;
  int lo = max(mk.vf, 0), hi = min(mk.vt, s_len);
  if (causal) hi = min(hi, pos_hi + 1);
  if (window > 0) {
    lo = max(lo, (pos_lo / window) * window);
    hi = min(hi, (pos_hi / window + 1) * window);
  }
  const int c_first = (lo / kBlockK) * kBlockK;
  const int n_tiles = lo < hi ? (hi - c_first + kBlockK - 1) / kBlockK : 0;
  const size_t head = ((size_t)b * nkv + h) * (size_t)s_len * d;

  auto load_kv = [&](int it) {
    const int c0 = c_first + it * kBlockK;
    bf16* ks = k_s + (it & 1) * kBlockK * stride;
    bf16* vs = v_s + (it & 1) * kBlockK * stride;
    for (int i = tid; i < kBlockK * chunks; i += kThreads) {
      const int j = i / chunks, c = i - j * chunks;
      const bool ok = c0 + j < s_len;
      const size_t at = ok ? head + (size_t)(c0 + j) * d + c * 8 : 0;
      cp16(ks + j * stride + c * 8, k + at, ok);
      cp16(vs + j * stride + c * 8, v + at, ok);
    }
    cp_commit();
  };

  // this thread's two rows: warp * 16 + g8 and + 8; A = exp2(s scale
  // log2e - row_m) with row_m = m log2e + log2(l_safe)
  bool row_ok[2];
  Span row_span[2];
  size_t row_at[2];
  float row_m[2], dsum[2] = {0.f, 0.f};
  const float scale2 = sm_scale * kLog2e;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g8 + 8 * i;
    const int t = t0 + r % block_q;
    row_ok[i] = r < rows_used && t < t_len;
    row_span[i] = row_ok[i] ? live_span(mk, t + mk.qoff) : Span{0, 0};
    row_at[i] = row_ok[i]
                    ? ((size_t)b * nq + h * group + r / block_q) * t_len + t
                    : 0;
    const float l = row_ok[i] ? l_in[row_at[i]] : 0.f;
    row_m[i] = row_ok[i] ? m_in[row_at[i]] * kLog2e +
                               log2f(l == 0.f ? 1.f : l)
                         : 0.f;
  }

  float acc_x[kNT][4], acc_y[kNT][4];   // sum A dP k, sum A k
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_x[n][e] = acc_y[n][e] = 0.f;

  const int nks = d / 16;
  if (n_tiles > 0) load_kv(0);
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      load_kv(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const bf16* ks = k_s + (it & 1) * kBlockK * stride;
    const bf16* vs = v_s + (it & 1) * kBlockK * stride;
    const int c0 = c_first + it * kBlockK;

    // scores and dP of the warp's 16 rows against the tile's 32 keys
    float s[4][4], dp[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks16 = 0; ks16 < kKS; ++ks16) {
      if (ks16 < nks) {
        uint32_t qa[4], ga[4];
        const int arow = warp * 16 + (lane & 15), acol = ks16 * 16 +
                                                         (lane >> 4) * 8;
        ldsm4(qa, q_s + arow * stride + acol);
        ldsm4(ga, do_s + arow * stride + acol);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4], vb[4];
          const int brow = np * 16 + (lane & 7) + ((lane >> 4) << 3);
          const int bcol = ks16 * 16 + ((lane >> 3) & 1) * 8;
          ldsm4(kb, ks + brow * stride + bcol);
          ldsm4(vb, vs + brow * stride + bcol);
          mma(s[2 * np], qa, kb[0], kb[1]);
          mma(s[2 * np + 1], qa, kb[2], kb[3]);
          mma(dp[2 * np], ga, vb[0], vb[1]);
          mma(dp[2 * np + 1], ga, vb[2], vb[3]);
        }
      }
    }
    // A = mask exp(s - m) / l and A dP, in place
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int c = c0 + n * 8 + 2 * t4 + (e & 1);
        const bool live = c >= row_span[i].lo && c < row_span[i].hi;
        const float a = live ? exp2f(s[n][e] * scale2 - row_m[i]) : 0.f;
        s[n][e] = a;
        dp[n][e] *= a;
        dsum[i] += dp[n][e];
      }
    // acc_x += (A dP) K, acc_y += A K over the tile's two k16 steps
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
      uint32_t ah[4], al[4], ph[4], pl[4];
      a_split(s, kk, ah, al);
      a_split(dp, kk, ph, pl);
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        if (np < nks) {
          uint32_t kb[4];
          const int brow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
          ldsm4t(kb, ks + brow * stride + np * 16 + (lane >> 4) * 8);
          mma(acc_x[2 * np], ph, kb[0], kb[1]);
          mma(acc_x[2 * np], pl, kb[0], kb[1]);
          mma(acc_x[2 * np + 1], ph, kb[2], kb[3]);
          mma(acc_x[2 * np + 1], pl, kb[2], kb[3]);
          mma(acc_y[2 * np], ah, kb[0], kb[1]);
          mma(acc_y[2 * np], al, kb[0], kb[1]);
          mma(acc_y[2 * np + 1], ah, kb[2], kb[3]);
          mma(acc_y[2 * np + 1], al, kb[2], kb[3]);
        }
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
  }
  cp_wait<0>();        // q and dO, where no key tile was live

  // D of each row: the quad's four column sums, in a fixed order
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    dsum[i] += __shfl_xor_sync(kFull, dsum[i], 1);
    dsum[i] += __shfl_xor_sync(kFull, dsum[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    if constexpr (kML) {
      // D' = D - dl l: the cotangent on l, folded into D
      if (dl_in != nullptr) dsum[i] -= dl_in[row_at[i]] * l_in[row_at[i]];
    }
    bf16* dst = dq + row_at[i] * d;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n < 2 * nks) {
        float x0 = sm_scale * (acc_x[n][2 * i] - dsum[i] * acc_y[n][2 * i]);
        float x1 = sm_scale * (acc_x[n][2 * i + 1] -
                               dsum[i] * acc_y[n][2 * i + 1]);
        if constexpr (kML) {
          const float2 t2 = *reinterpret_cast<const float2*>(
              tie_dq + row_at[i] * d + n * 8 + 2 * t4);
          x0 += t2.x;
          x1 += t2.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(dst + n * 8 + 2 * t4) =
            __floats2bfloat162_rn(x0, x1);
      }
    }
    if (t4 == 0) delta[row_at[i]] = make_float2(dsum[i], row_m[i]);
  }
}

template <bool kML>
__global__ void __launch_bounds__(kDkvThreads, 1)
tc_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float2* __restrict__ delta,
              const int* __restrict__ valid_from,
              const int* __restrict__ valid_to,
              const int* __restrict__ q_offset, bf16* __restrict__ dk_out,
              bf16* __restrict__ dv_out, const float* __restrict__ tie_dk,
              int batch, int nq, int nkv, int t_len, int s_len, int d,
              int causal, int window, float sm_scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stride = d + kPad;
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // [kKeys][stride]
  bf16* v_s = k_s + kKeys * stride;                // [kKeys][stride]
  // [2 stages][2 streams][kBlockQ][stride] each
  bf16* q_s = v_s + kKeys * stride;
  bf16* do_s = q_s + 4 * kBlockQ * stride;
  // [2 stages][2 streams][kBlockQ]: (D, m log2e + log2 l_safe) from pass
  // 1, and each row's live keys
  float2* st_s = reinterpret_cast<float2*>(do_s + 4 * kBlockQ * stride);
  Span* span_s = reinterpret_cast<Span*>(st_s + 4 * kBlockQ);
  // after the walk, the second stream's sums (aliasing q_s and do_s)
  float* red_s = reinterpret_cast<float*>(q_s);

  const int group = nq / nkv;
  const int hb = blockIdx.x % (nkv * batch), rank = blockIdx.x / (nkv * batch);
  const int h = hb % nkv, b = hb / nkv;
  // under the causal mask the first key block walks the most rows: first
  const int c0 = rank * kKeys;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kw = warp & 3, stream = warp >> 2;   // 16 keys; tile stream
  const int g8 = lane >> 2, t4 = lane & 3;
  const Mask mk{valid_from[b], valid_to[b], q_offset[b], s_len, causal,
                window};
  const size_t head = ((size_t)b * nkv + h) * (size_t)s_len * d;
  const int chunks = d / 8;

  for (int i = tid; i < kKeys * chunks; i += kDkvThreads) {
    const int j = i / chunks, c = i - j * chunks;
    const bool ok = c0 + j < s_len;
    const size_t at = ok ? head + (size_t)(c0 + j) * d + c * 8 : 0;
    cp16(k_s + j * stride + c * 8, k + at, ok);
    cp16(v_s + j * stride + c * 8, v + at, ok);
  }
  cp_commit();

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
  const int per_head = t_lo < t_hi ? (t_hi - t_lo + kBlockQ - 1) / kBlockQ : 0;
  const int n_tiles = klo < khi ? group * per_head : 0;
  const int n_pairs = (n_tiles + 1) / 2;

  // pair p: tile 2p into stream 0's slot, 2p + 1 into stream 1's
  auto load_pair = [&](int p) {
    const int stage = p & 1;
    for (int i = tid; i < 2 * kBlockQ * chunks; i += kDkvThreads) {
      const int slot = i / (kBlockQ * chunks);
      const int rc = i - slot * kBlockQ * chunks;
      const int r = rc / chunks, c = rc - r * chunks;
      const int tile = 2 * p + slot;
      const int gq = tile / max(per_head, 1);
      const int tq = t_lo + (tile - gq * per_head) * kBlockQ;
      const bool ok = tile < n_tiles && tq + r < t_hi;
      const size_t at =
          ok ? (((size_t)b * nq + h * group + gq) * t_len + tq + r) * d +
                   c * 8
             : 0;
      const int row = (stage * 2 + slot) * kBlockQ + r;
      cp16(q_s + row * stride + c * 8, q + at, ok);
      cp16(do_s + row * stride + c * 8, dout + at, ok);
    }
    if (tid < 2 * kBlockQ) {
      const int slot = tid / kBlockQ, r = tid - slot * kBlockQ;
      const int tile = 2 * p + slot;
      const int gq = tile / max(per_head, 1);
      const int tq = t_lo + (tile - gq * per_head) * kBlockQ;
      const bool ok = tile < n_tiles && tq + r < t_hi;
      const size_t at =
          ok ? ((size_t)b * nq + h * group + gq) * t_len + tq + r : 0;
      const int row = (stage * 2 + slot) * kBlockQ + r;
      cp8(st_s + row, delta + at, ok);
      span_s[row] = ok ? live_span(mk, tq + r + mk.qoff) : Span{0, 0};
    }
    cp_commit();
  };

  float acc_dk[kNT][4], acc_dv[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  const int nks = d / 16;
  const float scale2 = sm_scale * kLog2e;
  int key[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) key[i] = c0 + kw * 16 + g8 + 8 * i;

  if (n_pairs > 0) load_pair(0);
  for (int it = 0; it < n_pairs; ++it) {
    if (it + 1 < n_pairs) {
      load_pair(it + 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (2 * it + stream < n_tiles) {
      const int slot_row = ((it & 1) * 2 + stream) * kBlockQ;
      const bf16* qs = q_s + slot_row * stride;
      const bf16* gs = do_s + slot_row * stride;
      const float2* sts = st_s + slot_row;
      const Span* spans = span_s + slot_row;

      // S^T and dP^T: the warp's 16 keys against the tile's 32 rows
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int ks16 = 0; ks16 < kKS; ++ks16) {
        if (ks16 < nks) {
          uint32_t ka[4], va[4];
          const int arow = kw * 16 + (lane & 15), acol = ks16 * 16 +
                                                        (lane >> 4) * 8;
          ldsm4(ka, k_s + arow * stride + acol);
          ldsm4(va, v_s + arow * stride + acol);
#pragma unroll
          for (int np = 0; np < 2; ++np) {
            uint32_t qb[4], gb[4];
            const int brow = np * 16 + (lane & 7) + ((lane >> 4) << 3);
            const int bcol = ks16 * 16 + ((lane >> 3) & 1) * 8;
            ldsm4(qb, qs + brow * stride + bcol);
            ldsm4(gb, gs + brow * stride + bcol);
            mma(s[2 * np], ka, qb[0], qb[1]);
            mma(s[2 * np + 1], ka, qb[2], qb[3]);
            mma(dp[2 * np], va, gb[0], gb[1]);
            mma(dp[2 * np + 1], va, gb[2], gb[3]);
          }
        }
      }
      // A^T and dS^T = A^T (dP^T - D), in place
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = n * 8 + 2 * t4 + (e & 1);
          const Span sp = spans[r];
          const float2 st = sts[r];   // (D, m log2e + log2 l_safe)
          const int c = key[e >> 1];
          const bool live = c >= sp.lo && c < sp.hi;
          const float a = live ? exp2f(s[n][e] * scale2 - st.y) : 0.f;
          s[n][e] = a;
          dp[n][e] = a * (dp[n][e] - st.x);
        }
      // dV += A^T dO, dK += dS^T q over the tile's two k16 steps
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t ah[4], al[4], sh[4], sl[4];
        a_split(s, kk, ah, al);
        a_split(dp, kk, sh, sl);
#pragma unroll
        for (int np = 0; np < kNT / 2; ++np) {
          if (np < nks) {
            uint32_t ob[4], qb[4];
            const int brow = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
            const int bcol = np * 16 + (lane >> 4) * 8;
            ldsm4t(ob, gs + brow * stride + bcol);
            ldsm4t(qb, qs + brow * stride + bcol);
            mma(acc_dv[2 * np], ah, ob[0], ob[1]);
            mma(acc_dv[2 * np], al, ob[0], ob[1]);
            mma(acc_dv[2 * np + 1], ah, ob[2], ob[3]);
            mma(acc_dv[2 * np + 1], al, ob[2], ob[3]);
            mma(acc_dk[2 * np], sh, qb[0], qb[1]);
            mma(acc_dk[2 * np], sl, qb[0], qb[1]);
            mma(acc_dk[2 * np + 1], sh, qb[2], qb[3]);
            mma(acc_dk[2 * np + 1], sl, qb[2], qb[3]);
          }
        }
      }
    }
    __syncthreads();   // the stage is refilled two pairs on
  }
  cp_wait<0>();        // K and V, where no query tile was live
  __syncthreads();

  // the second stream's sums into shared memory, thread-major; the first
  // stream adds them to its own (a fixed order) and stores
  const int rt = tid & (kDkvThreads / 2 - 1);
  if (stream == 1) {
#pragma unroll
    for (int n = 0; n < kNT; ++n)
      if (n < 2 * nks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          red_s[(n * 4 + e) * (kDkvThreads / 2) + rt] =
              acc_dk[n][e];
          red_s[((2 * nks + n) * 4 + e) * (kDkvThreads / 2) + rt] =
              acc_dv[n][e];
        }
  }
  __syncthreads();
  if (stream == 1) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= s_len) continue;
    bf16* dkr = dk_out + head + (size_t)key[i] * d;
    bf16* dvr = dv_out + head + (size_t)key[i] * d;
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      if (n < 2 * nks) {
        const int col = n * 8 + 2 * t4;
        float x[2], y[2];
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int e = 2 * i + j;
          x[j] = acc_dk[n][e] +
                 red_s[(n * 4 + e) * (kDkvThreads / 2) + rt];
          y[j] = acc_dv[n][e] +
                 red_s[((2 * nks + n) * 4 + e) * (kDkvThreads / 2) + rt];
        }
        float k0 = sm_scale * x[0], k1 = sm_scale * x[1];
        if constexpr (kML) {
          const float2 t2 = *reinterpret_cast<const float2*>(
              tie_dk + head + (size_t)key[i] * d + col);
          k0 += t2.x;
          k1 += t2.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(dkr + col) =
            __floats2bfloat162_rn(k0, k1);
        *reinterpret_cast<__nv_bfloat162*>(dvr + col) =
            __floats2bfloat162_rn(y[0], y[1]);
      }
    }
  }
}

template <bool kML = false>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
           const float* m, const float* l, const int* vf, const int* vt,
           const int* q_off, bf16* dq, bf16* dk, bf16* dv, float2* delta,
           int b, int nq, int nkv, int t_len, int s_len, int d, int causal,
           int window, float sm_scale, cudaStream_t stream,
           const float* dl = nullptr, const float* tie_dq = nullptr,
           const float* tie_dk = nullptr) {
  static bool raised_dq[sm90::kMaxDevices] = {};
  static bool raised_dkv[sm90::kMaxDevices] = {};
  cudaError_t err = sm90::max_smem(tc_dq_kernel<kML>,
                                   (int)dq_smem_bytes(kMaxD), raised_dq);
  if (err == cudaSuccess)
    err = sm90::max_smem(tc_dkv_kernel<kML>, (int)dkv_smem_bytes(kMaxD),
                         raised_dkv);
  if (err != cudaSuccess) return (int)err;
  const int block_q = kRows / (nq / nkv);
  const int tiles_q = (t_len + block_q - 1) / block_q;
  tc_dq_kernel<kML><<<tiles_q * nkv * b, kThreads, dq_smem_bytes(d),
                      stream>>>(
      q, k, v, dout, m, l, vf, vt, q_off, dq, delta, dl, tie_dq, b, nq, nkv,
      t_len, s_len, d, block_q, causal, window, sm_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int blocks_k = (s_len + kKeys - 1) / kKeys;
  tc_dkv_kernel<kML><<<blocks_k * nkv * b, kDkvThreads, dkv_smem_bytes(d),
                       stream>>>(
      q, k, v, dout, delta, vf, vt, q_off, dk, dv, tie_dk, b, nq, nkv, t_len,
      s_len, d, causal, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace
