// Flash attention backward for Hopper (sm_90a) with cotangents on the
// residuals m and l: the m/l route of flash_attention_bwd.cu, whose
// header comment says what it computes; the kernels are in
// flash_attention_bwd.cuh, instantiated here with kML.

#include "flash_attention_bwd.cuh"

// The m/l route: cotangents `dm` and `dl` ([B, Nq, T] f32; either may be
// null, not both) beside dout. route: 0 = f32 on the CUDA cores, 1 = bf16
// on the CUDA cores, 2 = bf16 on the tensor cores (the conditions of
// flash_attention_bwd.cu's two entries). Scratch: `delta` as the route's ([B, Nq, T] f32, or
// [B, Nq, T, 2] on the tensor cores), `tie_row` [B, Nq, T, 2] f32,
// `tie_dq` [B, Nq, T, D] f32, `tie_dk` [B, Nkv, S, D] f32. Four launches
// on `stream` (the tie rows, the tie keys, pass 1, pass 2). Returns the
// first launch error.
extern "C" int flash_attention_bwd_ml(
    int route, const void* q, const void* k, const void* v, const void* dout,
    const void* m, const void* l, const void* dm, const void* dl,
    const void* valid_from, const void* valid_to, const void* q_offset,
    void* dq, void* dk, void* dv, void* delta, void* tie_row, void* tie_dq,
    void* tie_dk, int b, int nq, int nkv, int t_len, int s_len, int d,
    int causal, int window, float sm_scale, void* stream) {
  if (d <= 0 || d > kMaxD || d % 4 != 0 || nkv <= 0 || nq % nkv != 0 ||
      nq / nkv > kRows || s_len <= 0 || t_len <= 0 || b <= 0 ||
      route < 0 || route > 2 || (route == 2 && d % 16 != 0) ||
      (dm == nullptr && dl == nullptr))
    return (int)cudaErrorInvalidValue;
  auto* m_f = static_cast<const float*>(m);
  auto* l_f = static_cast<const float*>(l);
  auto* dm_f = static_cast<const float*>(dm);
  auto* dl_f = static_cast<const float*>(dl);
  auto* vf = static_cast<const int*>(valid_from);
  auto* vt = static_cast<const int*>(valid_to);
  auto* qo = static_cast<const int*>(q_offset);
  auto* tr = static_cast<float2*>(tie_row);
  auto* tq = static_cast<float*>(tie_dq);
  auto* tk = static_cast<float*>(tie_dk);
  auto st = static_cast<cudaStream_t>(stream);
  int err;
  if (route == 0) {
    err = launch_ties(static_cast<const float*>(q),
                      static_cast<const float*>(k), l_f, dm_f, dl_f, vf, vt,
                      qo, tr, tq, tk, b, nq, nkv, t_len, s_len, d, causal,
                      window, sm_scale, st);
    if (err) return err;
    return launch<float, true>(q, k, v, dout, m_f, l_f, vf, vt, qo, dq, dk,
                               dv, static_cast<float*>(delta), b, nq, nkv,
                               t_len, s_len, d, causal, window, sm_scale, st,
                               dl_f, tq, tk);
  }
  using tc::bf16;
  err = launch_ties(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                    l_f, dm_f, dl_f, vf, vt, qo, tr, tq, tk, b, nq, nkv,
                    t_len, s_len, d, causal, window, sm_scale, st);
  if (err) return err;
  if (route == 1)
    return launch<bf16, true>(q, k, v, dout, m_f, l_f, vf, vt, qo, dq, dk,
                              dv, static_cast<float*>(delta), b, nq, nkv,
                              t_len, s_len, d, causal, window, sm_scale, st,
                              dl_f, tq, tk);
  return tc::launch<true>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout), m_f, l_f,
      vf, vt, qo, static_cast<bf16*>(dq), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), static_cast<float2*>(delta), b, nq, nkv, t_len,
      s_len, d, causal, window, sm_scale, st, dl_f, tq, tk);
}
