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
// Two routes of these two passes, chosen by the wrapper
// (ops/flash_attention.py `bwd_route`) and counted apart:
//   - the CUDA cores (flash_attention_bwd): f32 or bf16 inputs, staged
//     into shared memory as f32, all arithmetic f32 FMAs; head dims a
//     multiple of 4. It serves f32, the parity dtype (no tensor-core
//     product keeps f32 to 2e-5), and head dims that are not a multiple
//     of 16 (trained_draft's 24).
//   - the tensor cores (flash_attention_bwd_tc, namespace tc): bf16
//     at head dims a multiple of 16 up to 128, the training path's.
// Outputs are written in the inputs' dtype.
//
// Cotangents on the residuals m and l (the context-parallel combine's
// inputs) take flash_attention_bwd_ml (flash_attention_bwd_ml.cu, its
// own library so that nvcc builds it beside this one), on either route:
// two launches ahead of the passes find each row's tied maxima and write
// the terms they add to dQ and dK in f32, and the passes, instantiated
// with kML, fold dl l into D and add those terms before their one
// rounding (the tie kernels in flash_attention_bwd.cuh say how). With
// dm = dl = None the wrapper calls this file's two entries, whose kernels
// are unchanged. The kernels are in flash_attention_bwd.cuh.
//
// What bounds it on the H100: at the training shape (B=8, 16 query / 8 KV
// heads x 128, T = 217, causal) the five products over the live (row,
// key) pairs are 3.5 GFLOP, 3.5 us at the tensor cores' bf16 peak, while
// q, k, v, dO in and dq, dk, dv out are ~36 MB, 10.7 us at 3.35 TB/s: it
// is bound by bytes. The CUDA-core route is bound by its f32 FMAs (67
// TFLOP/s at best); the tensor-core route reads each operand tile once a
// block from L2 into shared memory, so its time is the latency of the
// longest block's chain of tiles. Every mask-dead tile is skipped in both
// passes and on both routes.

#include "flash_attention_bwd.cuh"


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

// The tensor-core route: bf16 q, k, v, dout, dq, dk, dv; head dim a
// multiple of 16 up to 128; every pointer 16-byte aligned; `delta` a
// [B, Nq, T, 2] f32 scratch. Two launches on `stream`, as
// flash_attention_bwd. Returns the first launch error.
extern "C" int flash_attention_bwd_tc(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* m, const void* l,
                                      const void* valid_from,
                                      const void* valid_to,
                                      const void* q_offset, void* dq,
                                      void* dk, void* dv, void* delta, int b,
                                      int nq, int nkv, int t_len, int s_len,
                                      int d, int causal, int window,
                                      float sm_scale, void* stream) {
  if (d <= 0 || d > tc::kMaxD || d % 16 != 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > tc::kRows || s_len <= 0 || t_len <= 0 || b <= 0)
    return (int)cudaErrorInvalidValue;
  using tc::bf16;
  return tc::launch(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<const int*>(valid_from), static_cast<const int*>(valid_to),
      static_cast<const int*>(q_offset), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<float2*>(delta), b, nq, nkv, t_len, s_len, d, causal,
      window, sm_scale, static_cast<cudaStream_t>(stream));
}
