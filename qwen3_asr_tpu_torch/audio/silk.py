"""The SILK decoder of Opus (RFC 6716 §4.2), as libopus 1.3.1 decodes it:
integer arithmetic, so its 16-bit output is the reference's bit for bit.

``decode`` runs one Opus frame's SILK part (10-60 ms, 1-3 SILK frames)
on the frame's range decoder: the VAD and LBRR flags (LBRR frames are
parsed and skipped: a whole upload loses no packet), per SILK frame and
channel the stereo prediction, the indices (signal type, gains, the
two-stage NLSF for NB/MB and WB, interpolation, pitch lags and contour,
the LTP filter and scaling, the seed) and the pulses (shell coder, LSBs,
signs); then the NLSFs to LPC (stabilised, bandwidth-expanded where
unstable), ``decode_core``'s LTP and LPC synthesis, mid/side to left/
right, and the resampler to 48 kHz (2x all-pass upsampler and a 12-phase
FIR) with its delay. The output is int16 [samples, channels] at 48 kHz.

The plain version is this module; ``silk_frame`` in
``csrc/audio_dsp.cpp`` is the C++ one (``audio/native.py``), which keeps
its state in a C++ object and decodes to the same bits.
"""
from __future__ import annotations

import weakref
from typing import List, Optional

import numpy as np

from . import silk_tables as T
from .opus_range import RangeDecoder

MAX_LPC_ORDER = 16
LTP_ORDER = 5
TYPE_NO_VOICE, TYPE_UNVOICED, TYPE_VOICED = 0, 1, 2
CODE_INDEPENDENTLY, CODE_NO_LTP_SCALING, CODE_CONDITIONALLY = 0, 1, 2
SHELL_LEN = 16
MAX_PULSES = 16
NLSF_QUANT_MAX = 4
NLSF_QUANT_LEVEL_ADJ_Q10 = 102
QUANT_LEVEL_ADJUST_Q10 = 80
STEREO_INTERP_MS = 8
OFFSET_Q7 = 2090  # (MIN_QGAIN_DB * 128) / 6 + 16 * 128
INV_SCALE_Q16 = 1907825
A_LIMIT_Q24 = 16773022  # SILK_FIX_CONST(0.99975, 24)
MIN_INV_GAIN_Q30 = 107374  # SILK_FIX_CONST(1 / 1e4, 30)


# -- fixed-point helpers (silk/SigProc_FIX.h, macros.h, Inlines.h) ----------


def w32(x: int) -> int:
    x &= 0xFFFFFFFF
    return x - 0x100000000 if x & 0x80000000 else x


def i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def smulwb(a: int, b: int) -> int:
    return (a * i16(b)) >> 16


def smlawb(a: int, b: int, c: int) -> int:
    return a + ((b * i16(c)) >> 16)


def smulww(a: int, b: int) -> int:
    return w32((a * b) >> 16)


def smulbb(a: int, b: int) -> int:
    return i16(a) * i16(b)


def smmul(a: int, b: int) -> int:
    return (a * b) >> 32


def rshift_round(a: int, s: int) -> int:
    if s == 1:
        return (a >> 1) + (a & 1)
    return ((a >> (s - 1)) + 1) >> 1


def sat16(x: int) -> int:
    return -32768 if x < -32768 else 32767 if x > 32767 else x


def sat32(x: int) -> int:
    return -0x80000000 if x < -0x80000000 else (
        0x7FFFFFFF if x > 0x7FFFFFFF else x)


def lshift_sat32(a: int, s: int) -> int:
    lo, hi = -0x80000000 >> s, 0x7FFFFFFF >> s
    return (lo if a < lo else hi if a > hi else a) << s


def clz32(x: int) -> int:
    return 32 - (x & 0xFFFFFFFF).bit_length() if x else 32


def tdiv(a: int, b: int) -> int:
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def limit(a: int, l1: int, l2: int) -> int:
    if l1 > l2:
        return l1 if a > l1 else (l2 if a < l2 else a)
    return l2 if a > l2 else (l1 if a < l1 else a)


def div32_varq(a32: int, b32: int, qres: int) -> int:
    a_head = clz32(abs(a32)) - 1
    a_nrm = w32(a32 << a_head)
    b_head = clz32(abs(b32)) - 1
    b_nrm = w32(b32 << b_head)
    b_inv = tdiv(0x7FFFFFFF >> 2, b_nrm >> 16)
    result = smulwb(a_nrm, b_inv)
    a_nrm = w32(a_nrm - w32(smmul(b_nrm, result) << 3))
    result = smlawb(result, a_nrm, b_inv)
    lshift = 29 + a_head - b_head - qres
    if lshift < 0:
        return lshift_sat32(result, -lshift)
    return result >> lshift if lshift < 32 else 0


def inverse32_varq(b32: int, qres: int) -> int:
    b_head = clz32(abs(b32)) - 1
    b_nrm = w32(b32 << b_head)
    b_inv = tdiv(0x7FFFFFFF >> 2, b_nrm >> 16)
    result = w32(b_inv << 16)
    err_q32 = w32(((1 << 29) - smulwb(b_nrm, b_inv)) << 3)
    result = w32(result + smulww(err_q32, b_inv))
    lshift = 61 - b_head - qres
    if lshift <= 0:
        return lshift_sat32(result, -lshift)
    return result >> lshift if lshift < 32 else 0


def log2lin(in_q7: int) -> int:
    if in_q7 < 0:
        return 0
    if in_q7 >= 3967:
        return 0x7FFFFFFF
    out = 1 << (in_q7 >> 7)
    frac = in_q7 & 0x7F
    poly = smlawb(frac, smulbb(frac, 128 - frac), -174)
    if in_q7 < 2048:
        return out + ((out * poly) >> 7)
    return out + (out >> 7) * poly


def silk_rand(seed: int) -> int:
    return w32(907633515 + seed * 196314165)


# -- the codebooks ------------------------------------------------------------


class NlsfCodebook:
    def __init__(self, wb: bool):
        p = "NLSF_WB_" if wb else "NLSF_NB_MB_"
        self.order = 16 if wb else 10
        self.n_vectors = 32
        self.step_q16 = 9830 if wb else 11796
        self.cb1 = getattr(T, p + "CB1_Q8")
        self.wght = getattr(T, p + "CB1_WGHT_Q9")
        self.cb1_icdf = getattr(T, p + "CB1_ICDF")
        self.select = getattr(T, p + "CB2_SELECT")
        self.cb2_icdf = getattr(T, p + "CB2_ICDF")
        self.pred = getattr(T, p + "PRED_Q8")
        self.delta_min = getattr(T, p + "DELTA_MIN_Q15")


CB_NB_MB = NlsfCodebook(False)
CB_WB = NlsfCodebook(True)
LTP_VQ = (T.LTP_VQ_0, T.LTP_VQ_1, T.LTP_VQ_2)
LTP_GAIN_ICDF = (T.LTP_GAIN_ICDF_0, T.LTP_GAIN_ICDF_1, T.LTP_GAIN_ICDF_2)
SHELL_TABLES = (T.SHELL_CODE_TABLE0, T.SHELL_CODE_TABLE1, T.SHELL_CODE_TABLE2,
                T.SHELL_CODE_TABLE3)


def _icdf_at(rd: RangeDecoder, table, offset: int) -> int:
    return rd.icdf(table[offset:], 8)


# -- NLSF ---------------------------------------------------------------------


def nlsf_unpack(cb: NlsfCodebook, idx: int):
    ec_ix = [0] * cb.order
    pred = [0] * cb.order
    sel = idx * cb.order // 2
    for i in range(0, cb.order, 2):
        entry = cb.select[sel]
        sel += 1
        ec_ix[i] = ((entry >> 1) & 7) * (2 * NLSF_QUANT_MAX + 1)
        pred[i] = cb.pred[i + (entry & 1) * (cb.order - 1)]
        ec_ix[i + 1] = ((entry >> 5) & 7) * (2 * NLSF_QUANT_MAX + 1)
        pred[i + 1] = cb.pred[i + ((entry >> 4) & 1) * (cb.order - 1) + 1]
    return ec_ix, pred


def nlsf_stabilize(nlsf: List[int], dmin, n: int) -> None:
    for _ in range(20):
        min_diff = nlsf[0] - dmin[0]
        ii = 0
        for i in range(1, n):
            diff = nlsf[i] - (nlsf[i - 1] + dmin[i])
            if diff < min_diff:
                min_diff = diff
                ii = i
        diff = (1 << 15) - (nlsf[n - 1] + dmin[n])
        if diff < min_diff:
            min_diff = diff
            ii = n
        if min_diff >= 0:
            return
        if ii == 0:
            nlsf[0] = dmin[0]
        elif ii == n:
            nlsf[n - 1] = (1 << 15) - dmin[n]
        else:
            min_center = sum(dmin[:ii]) + (dmin[ii] >> 1)
            max_center = (1 << 15) - sum(dmin[ii + 1:n + 1]) - (dmin[ii] >> 1)
            center = i16(limit(rshift_round(nlsf[ii - 1] + nlsf[ii], 1),
                               min_center, max_center))
            nlsf[ii - 1] = center - (dmin[ii] >> 1)
            nlsf[ii] = nlsf[ii - 1] + dmin[ii]
    nlsf.sort()
    nlsf[0] = max(nlsf[0], dmin[0])
    for i in range(1, n):
        nlsf[i] = max(nlsf[i], sat16(nlsf[i - 1] + dmin[i]))
    nlsf[n - 1] = min(nlsf[n - 1], (1 << 15) - dmin[n])
    for i in range(n - 2, -1, -1):
        nlsf[i] = min(nlsf[i], nlsf[i + 1] - dmin[i + 1])


def nlsf_decode(cb: NlsfCodebook, indices: List[int]) -> List[int]:
    ec_ix, pred = nlsf_unpack(cb, indices[0])
    order = cb.order
    res = [0] * order
    out = 0
    for i in range(order - 1, -1, -1):
        pred_q10 = (smulbb(out, pred[i])) >> 8
        out = indices[i + 1] << 10
        if out > 0:
            out -= NLSF_QUANT_LEVEL_ADJ_Q10
        elif out < 0:
            out += NLSF_QUANT_LEVEL_ADJ_Q10
        out = smlawb(pred_q10, out, cb.step_q16)
        res[i] = out
    base = indices[0] * order
    nlsf = []
    for i in range(order):
        v = tdiv(res[i] << 14, cb.wght[base + i]) + (cb.cb1[base + i] << 7)
        nlsf.append(max(0, min(32767, v)))
    nlsf_stabilize(nlsf, cb.delta_min, order)
    return nlsf


def bwexpander_32(ar: List[int], d: int, chirp: int) -> None:
    minus1 = chirp - 65536
    for i in range(d - 1):
        ar[i] = smulww(chirp, ar[i])
        chirp += rshift_round(chirp * minus1, 16)
    ar[d - 1] = smulww(chirp, ar[d - 1])


def lpc_fit(a_qin: List[int], qout: int, qin: int, d: int) -> List[int]:
    idx = 0
    i = 0
    while i < 10:
        maxabs = 0
        for k in range(d):
            absval = abs(a_qin[k])
            if absval > maxabs:
                maxabs = absval
                idx = k
        maxabs = rshift_round(maxabs, qin - qout)
        if maxabs > 32767:
            maxabs = min(maxabs, 163838)
            chirp = 65470 - tdiv((maxabs - 32767) << 14,
                                 (maxabs * (idx + 1)) >> 2)
            bwexpander_32(a_qin, d, chirp)
        else:
            break
        i += 1
    if i == 10:
        out = [sat16(rshift_round(a, qin - qout)) for a in a_qin[:d]]
        for k in range(d):
            a_qin[k] = out[k] << (qin - qout)
        return out
    return [i16(rshift_round(a, qin - qout)) for a in a_qin[:d]]


def _inverse_pred_gain_qa(a: List[int], order: int) -> int:
    inv_gain = 1 << 30
    for k in range(order - 1, 0, -1):
        if a[k] > A_LIMIT_Q24 or a[k] < -A_LIMIT_Q24:
            return 0
        rc_q31 = w32(-(a[k] << 7))
        rc_mult1 = (1 << 30) - smmul(rc_q31, rc_q31)
        inv_gain = w32(smmul(inv_gain, rc_mult1) << 2)
        if inv_gain < MIN_INV_GAIN_Q30:
            return 0
        mult2q = 32 - clz32(abs(rc_mult1))
        rc_mult2 = inverse32_varq(rc_mult1, mult2q + 30)
        for n in range((k + 1) >> 1):
            tmp1 = a[n]
            tmp2 = a[k - n - 1]
            t = rshift_round(sat32(tmp1 - rshift_round(tmp2 * rc_q31, 31))
                             * rc_mult2, mult2q)
            if t > 0x7FFFFFFF or t < -0x80000000:
                return 0
            a[n] = t
            t = rshift_round(sat32(tmp2 - rshift_round(tmp1 * rc_q31, 31))
                             * rc_mult2, mult2q)
            if t > 0x7FFFFFFF or t < -0x80000000:
                return 0
            a[k - n - 1] = t
    if a[0] > A_LIMIT_Q24 or a[0] < -A_LIMIT_Q24:
        return 0
    rc_q31 = w32(-(a[0] << 7))
    rc_mult1 = (1 << 30) - smmul(rc_q31, rc_q31)
    inv_gain = w32(smmul(inv_gain, rc_mult1) << 2)
    if inv_gain < MIN_INV_GAIN_Q30:
        return 0
    return inv_gain


def lpc_inverse_pred_gain(a_q12: List[int], order: int) -> int:
    if sum(a_q12[:order]) >= 4096:
        return 0
    return _inverse_pred_gain_qa([v << 12 for v in a_q12[:order]], order)


_ORDERING16 = (0, 15, 8, 7, 4, 11, 12, 3, 2, 13, 10, 5, 6, 9, 14, 1)
_ORDERING10 = (0, 9, 6, 3, 4, 5, 8, 1, 2, 7)


def _find_poly(c: List[int], off: int, dd: int) -> List[int]:
    out = [0] * (dd + 1)
    out[0] = 1 << 16
    out[1] = -c[off]
    for k in range(1, dd):
        f = c[off + 2 * k]
        out[k + 1] = (out[k - 1] << 1) - rshift_round(f * out[k], 16)
        for n in range(k, 1, -1):
            out[n] += out[n - 2] - rshift_round(f * out[n - 1], 16)
        out[1] -= f
    return out


def nlsf2a(nlsf: List[int], d: int) -> List[int]:
    ordering = _ORDERING16 if d == 16 else _ORDERING10
    cos_qa = [0] * d
    tab = T.LSF_COS_TAB_Q12
    for k in range(d):
        f_int = nlsf[k] >> 8
        f_frac = nlsf[k] - (f_int << 8)
        cos_val = tab[f_int]
        delta = tab[f_int + 1] - cos_val
        cos_qa[ordering[k]] = rshift_round((cos_val << 8) + delta * f_frac, 4)
    dd = d >> 1
    p = _find_poly(cos_qa, 0, dd)
    q = _find_poly(cos_qa, 1, dd)
    a32 = [0] * d
    for k in range(dd):
        ptmp = p[k + 1] + p[k]
        qtmp = q[k + 1] - q[k]
        a32[k] = -qtmp - ptmp
        a32[d - k - 1] = qtmp - ptmp
    a_q12 = lpc_fit(a32, 12, 17, d)
    i = 0
    while lpc_inverse_pred_gain(a_q12, d) == 0 and i < 16:
        bwexpander_32(a32, d, 65536 - (2 << i))
        a_q12 = [i16(rshift_round(a, 5)) for a in a32]
        i += 1
    return a_q12


# -- state --------------------------------------------------------------------


class Resampler:
    """silk_resampler from 8/12/16 kHz to 48 kHz (the decoder's)."""

    def __init__(self, fs_in: int, fs_out: int = 48000):
        rate_id = {8000: 0, 12000: 1, 16000: 2, 24000: 3, 48000: 4}
        self.input_delay = T.DELAY_MATRIX_DEC[rate_id[fs_in] * 5
                                              + rate_id[fs_out]]
        self.fs_in_khz = fs_in // 1000
        self.fs_out_khz = fs_out // 1000
        self.batch = self.fs_in_khz * 10
        self.up2_only = fs_out == 2 * fs_in
        self.copy = fs_out == fs_in
        up2x = 0 if (self.up2_only or self.copy) else 1
        inv = ((fs_in << (14 + up2x)) // fs_out) << 2
        while smulww(inv, fs_out) < fs_in << up2x:
            inv += 1
        self.inv_ratio_q16 = inv
        self.iir = [0] * 6
        self.fir = [0] * 8
        self.delay_buf = [0] * 48


def up2_hq(s: List[int], inp: List[int]) -> List[int]:
    c0, c1 = T.RESAMPLER_UP2_HQ_0, T.RESAMPLER_UP2_HQ_1
    out = [0] * (2 * len(inp))
    for k, x in enumerate(inp):
        in32 = x << 10
        y = in32 - s[0]
        xx = smulwb(y, c0[0])
        o1 = s[0] + xx
        s[0] = in32 + xx
        y = o1 - s[1]
        xx = smulwb(y, c0[1])
        o2 = s[1] + xx
        s[1] = o1 + xx
        y = o2 - s[2]
        xx = smlawb(y, y, c0[2])
        o1 = s[2] + xx
        s[2] = o2 + xx
        out[2 * k] = sat16(rshift_round(o1, 10))
        y = in32 - s[3]
        xx = smulwb(y, c1[0])
        o1 = s[3] + xx
        s[3] = in32 + xx
        y = o1 - s[4]
        xx = smulwb(y, c1[1])
        o2 = s[4] + xx
        s[4] = o1 + xx
        y = o2 - s[5]
        xx = smlawb(y, y, c1[2])
        o1 = s[5] + xx
        s[5] = o2 + xx
        out[2 * k + 1] = sat16(rshift_round(o1, 10))
    return out


def _iir_fir(r: Resampler, out: List[int], inp: List[int]) -> None:
    fir = T.RESAMPLER_FRAC_FIR_12
    buf = list(r.fir)
    pos = 0
    n_left = len(inp)
    while True:
        n = min(n_left, r.batch)
        buf[8:] = up2_hq(r.iir, inp[pos:pos + n])
        max_index = n << 17
        index = 0
        while index < max_index:
            t = smulwb(index & 0xFFFF, 12)
            p = index >> 16
            a = fir[4 * t:4 * t + 4]
            b = fir[4 * (11 - t):4 * (11 - t) + 4]
            res = buf[p] * a[0] + buf[p + 1] * a[1] + buf[p + 2] * a[2] \
                + buf[p + 3] * a[3] + buf[p + 4] * b[3] + buf[p + 5] * b[2] \
                + buf[p + 6] * b[1] + buf[p + 7] * b[0]
            out.append(sat16(rshift_round(res, 15)))
            index += r.inv_ratio_q16
        pos += n
        n_left -= n
        if n_left > 0:
            buf = buf[n << 1:(n << 1) + 8]
        else:
            break
    r.fir = buf[n << 1:(n << 1) + 8]


def resample(r: Resampler, inp: List[int]) -> List[int]:
    n_in = r.fs_in_khz - r.input_delay
    r.delay_buf[r.input_delay:r.input_delay + n_in] = inp[:n_in]
    out: List[int] = []
    first = r.delay_buf[:r.fs_in_khz]
    rest = inp[n_in:len(inp) - r.input_delay]
    if r.copy:
        out = first + rest
    elif r.up2_only:
        out = up2_hq(r.iir, first) + up2_hq(r.iir, rest)
    else:
        _iir_fir(r, out, first)
        _iir_fir(r, out, rest)
    r.delay_buf[:r.input_delay] = inp[len(inp) - r.input_delay:]
    return out


class ChannelState:
    """silk_decoder_state."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.fs_khz = 0
        self.fs_api = 0
        self.nb_subfr = 0
        self.frame_length = 0
        self.subfr_length = 0
        self.ltp_mem_length = 0
        self.lpc_order = 0
        self.prev_nlsf = [0] * MAX_LPC_ORDER
        self.first_frame_after_reset = 1
        self.lag_low_icdf = None
        self.contour_icdf = None
        self.frames_decoded = 0
        self.frames_per_packet = 0
        self.ec_prev_signal_type = 0
        self.ec_prev_lag_index = 0
        self.vad_flags = [0, 0, 0]
        self.lbrr_flag = 0
        self.lbrr_flags = [0, 0, 0]
        self.resampler = None
        self.cb = None
        self.s_lpc = [0] * MAX_LPC_ORDER
        self.out_buf = [0] * 480
        self.lag_prev = 100
        self.last_gain_index = 10
        self.prev_signal_type = 0
        self.prev_gain_q16 = 65536
        self.exc_q14 = [0] * 320
        self.loss_cnt = 0
        # silk_PLC_struct
        self.plc_fs_khz = 0
        self.plc_pitch_q8 = 0
        self.plc_ltp = [0] * 5
        self.plc_lpc = [0] * MAX_LPC_ORDER
        self.plc_ltp_scale = 0
        self.plc_gain = [65536, 65536]
        self.plc_subfr_length = 20
        self.plc_nb_subfr = 2
        self.plc_rand_seed = 0
        self.plc_rand_scale = 0
        self.plc_conc_energy = 0
        self.plc_conc_shift = 0
        self.plc_last_lost = False
        # silk_CNG_struct
        self.cng_fs_khz = 0
        self.cng_nlsf = [0] * MAX_LPC_ORDER
        self.cng_gain = 0
        self.cng_seed = 0
        self.cng_exc = [0] * 320
        self.cng_synth = [0] * MAX_LPC_ORDER
        # the current frame's indices
        self.signal_type = 0
        self.quant_offset = 0
        self.gains_idx = [0] * 4
        self.nlsf_idx = [0] * (MAX_LPC_ORDER + 1)
        self.interp_q2 = 4
        self.lag_index = 0
        self.contour = 0
        self.per_index = 0
        self.ltp_index = [0] * 4
        self.ltp_scale_index = 0
        self.seed = 0

    def set_fs(self, fs_khz: int, fs_api: int) -> None:
        self.subfr_length = 5 * fs_khz
        frame_length = self.nb_subfr * self.subfr_length
        if self.fs_khz != fs_khz or self.fs_api != fs_api:
            self.resampler = Resampler(fs_khz * 1000, fs_api)
            self.fs_api = fs_api
        if self.fs_khz != fs_khz or frame_length != self.frame_length:
            if fs_khz == 8:
                self.contour_icdf = T.PITCH_CONTOUR_NB_ICDF \
                    if self.nb_subfr == 4 else T.PITCH_CONTOUR_10MS_NB_ICDF
            else:
                self.contour_icdf = T.PITCH_CONTOUR_ICDF \
                    if self.nb_subfr == 4 else T.PITCH_CONTOUR_10MS_ICDF
            if self.fs_khz != fs_khz:
                self.ltp_mem_length = 20 * fs_khz
                if fs_khz in (8, 12):
                    self.lpc_order = 10
                    self.cb = CB_NB_MB
                else:
                    self.lpc_order = 16
                    self.cb = CB_WB
                self.lag_low_icdf = {16: T.UNIFORM8_ICDF, 12: T.UNIFORM6_ICDF,
                                     8: T.UNIFORM4_ICDF}[fs_khz]
                self.first_frame_after_reset = 1
                self.lag_prev = 100
                self.last_gain_index = 10
                self.prev_signal_type = TYPE_NO_VOICE
                self.out_buf = [0] * 480
                self.s_lpc = [0] * MAX_LPC_ORDER
            self.fs_khz = fs_khz
            self.frame_length = frame_length


class SilkDecoder:
    """silk_decoder: two channel states and the stereo state. With the C++
    helper ``lib``, the state lives in its object ``handle`` instead."""

    def __init__(self, channels_api: int, lib=None):
        self.channels_api = channels_api
        self.lib = lib
        self.handle = None
        if lib is not None:
            self.handle = lib.silk_new(channels_api)
            self._free = weakref.finalize(self, lib.silk_free, self.handle)
        self.ch = [ChannelState(), ChannelState()]
        self.n_internal = 0
        self.n_api = 0
        self.pred_prev = [0, 0]
        self.s_mid = [0, 0]
        self.s_side = [0, 0]
        self.prev_decode_only_middle = 0

    def reset(self) -> None:
        """silk_InitDecoder (the channel counts stay)."""
        if self.handle is not None:
            self.lib.silk_reset(self.handle)
        for c in self.ch:
            c.reset()
        self.pred_prev = [0, 0]
        self.s_mid = [0, 0]
        self.s_side = [0, 0]
        self.prev_decode_only_middle = 0


# -- indices and pulses -------------------------------------------------------


def decode_indices(st: ChannelState, rd: RangeDecoder, frame: int,
                   lbrr: bool, cond: int) -> None:
    if lbrr or st.vad_flags[frame]:
        ix = rd.icdf(T.TYPE_OFFSET_VAD_ICDF, 8) + 2
    else:
        ix = rd.icdf(T.TYPE_OFFSET_NO_VAD_ICDF, 8)
    st.signal_type = ix >> 1
    st.quant_offset = ix & 1
    if cond == CODE_CONDITIONALLY:
        st.gains_idx[0] = rd.icdf(T.DELTA_GAIN_ICDF, 8)
    else:
        st.gains_idx[0] = rd.icdf(
            T.GAIN_ICDF[8 * st.signal_type:8 * st.signal_type + 8], 8) << 3
        st.gains_idx[0] += rd.icdf(T.UNIFORM8_ICDF, 8)
    for i in range(1, st.nb_subfr):
        st.gains_idx[i] = rd.icdf(T.DELTA_GAIN_ICDF, 8)
    cb = st.cb
    st.nlsf_idx[0] = _icdf_at(rd, cb.cb1_icdf,
                              (st.signal_type >> 1) * cb.n_vectors)
    ec_ix, _ = nlsf_unpack(cb, st.nlsf_idx[0])
    for i in range(cb.order):
        ix = _icdf_at(rd, cb.cb2_icdf, ec_ix[i])
        if ix == 0:
            ix -= rd.icdf(T.NLSF_EXT_ICDF, 8)
        elif ix == 2 * NLSF_QUANT_MAX:
            ix += rd.icdf(T.NLSF_EXT_ICDF, 8)
        st.nlsf_idx[i + 1] = ix - NLSF_QUANT_MAX
    if st.nb_subfr == 4:
        st.interp_q2 = rd.icdf(T.NLSF_INTERP_ICDF, 8)
    else:
        st.interp_q2 = 4
    if st.signal_type == TYPE_VOICED:
        absolute = True
        if cond == CODE_CONDITIONALLY and \
                st.ec_prev_signal_type == TYPE_VOICED:
            delta = rd.icdf(T.PITCH_DELTA_ICDF, 8)
            if delta > 0:
                st.lag_index = i16(st.ec_prev_lag_index + delta - 9)
                absolute = False
        if absolute:
            st.lag_index = rd.icdf(T.PITCH_LAG_ICDF, 8) * (st.fs_khz >> 1)
            st.lag_index += rd.icdf(st.lag_low_icdf, 8)
        st.ec_prev_lag_index = st.lag_index
        st.contour = rd.icdf(st.contour_icdf, 8)
        st.per_index = rd.icdf(T.LTP_PER_INDEX_ICDF, 8)
        for k in range(st.nb_subfr):
            st.ltp_index[k] = rd.icdf(LTP_GAIN_ICDF[st.per_index], 8)
        if cond == CODE_INDEPENDENTLY:
            st.ltp_scale_index = rd.icdf(T.LTPSCALE_ICDF, 8)
        else:
            st.ltp_scale_index = 0
    st.ec_prev_signal_type = st.signal_type
    st.seed = rd.icdf(T.UNIFORM4_ICDF, 8)


def shell_decode(rd: RangeDecoder, out: List[int], at: int,
                 pulses4: int) -> None:
    def split(p: int, table) -> tuple:
        if p > 0:
            a = _icdf_at(rd, table, T.SHELL_CODE_TABLE_OFFSETS[p])
            return a, p - a
        return 0, 0

    t0, t1, t2, t3 = SHELL_TABLES
    p3 = split(pulses4, t3)
    p2 = [0] * 4
    p1 = [0] * 8
    p2[0], p2[1] = split(p3[0], t2)
    p1[0], p1[1] = split(p2[0], t1)
    out[at + 0], out[at + 1] = split(p1[0], t0)
    out[at + 2], out[at + 3] = split(p1[1], t0)
    p1[2], p1[3] = split(p2[1], t1)
    out[at + 4], out[at + 5] = split(p1[2], t0)
    out[at + 6], out[at + 7] = split(p1[3], t0)
    p2[2], p2[3] = split(p3[1], t2)
    p1[4], p1[5] = split(p2[2], t1)
    out[at + 8], out[at + 9] = split(p1[4], t0)
    out[at + 10], out[at + 11] = split(p1[5], t0)
    p1[6], p1[7] = split(p2[3], t1)
    out[at + 12], out[at + 13] = split(p1[6], t0)
    out[at + 14], out[at + 15] = split(p1[7], t0)


def decode_pulses(rd: RangeDecoder, signal_type: int, quant_offset: int,
                  frame_length: int) -> List[int]:
    rate = rd.icdf(T.RATE_LEVELS_ICDF[9 * (signal_type >> 1):
                                      9 * (signal_type >> 1) + 9], 8)
    n_blocks = frame_length >> 4
    if n_blocks * SHELL_LEN < frame_length:
        n_blocks += 1
    pulses = [0] * (n_blocks * SHELL_LEN)
    sums = [0] * n_blocks
    shifts = [0] * n_blocks
    ppb = T.PULSES_PER_BLOCK_ICDF
    for i in range(n_blocks):
        sums[i] = _icdf_at(rd, ppb, 18 * rate)
        while sums[i] == MAX_PULSES + 1:
            shifts[i] += 1
            sums[i] = _icdf_at(rd, ppb, 18 * 9 + (shifts[i] == 10))
    for i in range(n_blocks):
        if sums[i] > 0:
            shell_decode(rd, pulses, i * SHELL_LEN, sums[i])
    for i in range(n_blocks):
        if shifts[i] > 0:
            for k in range(SHELL_LEN):
                q = pulses[i * SHELL_LEN + k]
                for _ in range(shifts[i]):
                    q = (q << 1) + rd.icdf(T.LSB_ICDF, 8)
                pulses[i * SHELL_LEN + k] = q
            sums[i] |= shifts[i] << 5
    # signs
    base = 7 * (quant_offset + (signal_type << 1))
    n_sign = (frame_length + SHELL_LEN // 2) >> 4
    for i in range(n_sign):
        p = sums[i]
        if p > 0:
            icdf = (T.SIGN_ICDF[base + min(p & 0x1F, 6)], 0)
            for j in range(SHELL_LEN):
                k = i * SHELL_LEN + j
                if pulses[k] > 0:
                    pulses[k] *= (rd.icdf(icdf, 8) << 1) - 1
    return pulses


# -- parameters and synthesis -------------------------------------------------


def gains_dequant(st: ChannelState, conditional: bool) -> List[int]:
    gains = []
    prev = st.last_gain_index
    for k in range(st.nb_subfr):
        ind = st.gains_idx[k]
        if k == 0 and not conditional:
            prev = max(ind, prev - 16)
        else:
            ind_tmp = ind - 4
            thresh = 2 * 36 - 64 + prev
            if ind_tmp > thresh:
                prev += (ind_tmp << 1) - thresh
            else:
                prev += ind_tmp
        prev = max(0, min(63, prev))
        gains.append(log2lin(min(smulwb(INV_SCALE_Q16, prev) + OFFSET_Q7,
                                 3967)))
    st.last_gain_index = prev
    return gains


def decode_pitch(lag_index: int, contour: int, fs_khz: int,
                 nb_subfr: int) -> List[int]:
    if fs_khz == 8:
        if nb_subfr == 4:
            cb, size = T.CB_LAGS_STAGE2, 11
        else:
            cb, size = T.CB_LAGS_STAGE2_10MS, 3
    else:
        if nb_subfr == 4:
            cb, size = T.CB_LAGS_STAGE3, 34
        else:
            cb, size = T.CB_LAGS_STAGE3_10MS, 12
    min_lag = 2 * fs_khz
    max_lag = 18 * fs_khz
    lag = min_lag + lag_index
    return [max(min_lag, min(max_lag, lag + cb[k * size + contour]))
            for k in range(nb_subfr)]


class _Ctrl:
    __slots__ = ("gains", "pred", "pitch", "ltp", "ltp_scale")


def decode_parameters(st: ChannelState, cond: int) -> _Ctrl:
    ctrl = _Ctrl()
    ctrl.gains = gains_dequant(st, cond == CODE_CONDITIONALLY)
    nlsf = nlsf_decode(st.cb, st.nlsf_idx)
    a1 = nlsf2a(nlsf, st.lpc_order)
    if st.first_frame_after_reset == 1:
        st.interp_q2 = 4
    if st.interp_q2 < 4:
        nlsf0 = [st.prev_nlsf[i] + ((st.interp_q2 * (nlsf[i]
                                                     - st.prev_nlsf[i])) >> 2)
                 for i in range(st.lpc_order)]
        a0 = nlsf2a(nlsf0, st.lpc_order)
    else:
        a0 = list(a1)
    st.prev_nlsf[:st.lpc_order] = nlsf
    if st.loss_cnt:
        bwexpander(a0, st.lpc_order, BWE_AFTER_LOSS_Q16)
        bwexpander(a1, st.lpc_order, BWE_AFTER_LOSS_Q16)
    ctrl.pred = (a0, a1)
    if st.signal_type == TYPE_VOICED:
        ctrl.pitch = decode_pitch(st.lag_index, st.contour, st.fs_khz,
                                  st.nb_subfr)
        vq = LTP_VQ[st.per_index]
        ctrl.ltp = []
        for k in range(st.nb_subfr):
            ix = st.ltp_index[k]
            ctrl.ltp += [v << 7 for v in vq[ix * 5:ix * 5 + 5]]
        ctrl.ltp_scale = T.LTP_SCALES_Q14[st.ltp_scale_index]
    else:
        ctrl.pitch = [0] * st.nb_subfr
        ctrl.ltp = [0] * (5 * st.nb_subfr)
        st.per_index = 0
        ctrl.ltp_scale = 0
    return ctrl


def lpc_analysis_filter(inp: List[int], at: int, b: List[int], length: int,
                        d: int) -> List[int]:
    """silk_LPC_analysis_filter over inp[at:at + length]."""
    out = [0] * length
    for ix in range(d, length):
        p = at + ix - 1
        acc = 0
        for j in range(d):
            acc = w32(acc + i16(inp[p - j]) * i16(b[j]))
        acc = w32((i16(inp[p + 1]) << 12) - acc)
        out[ix] = sat16(rshift_round(acc, 12))
    return out


def decode_core(st: ChannelState, ctrl: _Ctrl, pulses: List[int]) -> List[int]:
    L = st.frame_length
    sub = st.subfr_length
    ltp_mem = st.ltp_mem_length
    order = st.lpc_order
    offset_q10 = T.QUANT_OFFSETS_Q10[2 * (st.signal_type >> 1)
                                     + st.quant_offset]
    interp = st.interp_q2 < 4
    seed = st.seed
    exc = st.exc_q14
    for i in range(L):
        seed = silk_rand(seed)
        e = pulses[i] << 14
        if e > 0:
            e -= QUANT_LEVEL_ADJUST_Q10 << 4
        elif e < 0:
            e += QUANT_LEVEL_ADJUST_Q10 << 4
        e += offset_q10 << 4
        if seed < 0:
            e = -e
        exc[i] = e
        seed = w32(seed + pulses[i])
    s_lpc = list(st.s_lpc) + [0] * sub
    xq = [0] * L
    s_ltp_q15 = [0] * (ltp_mem + L)
    s_ltp = [0] * ltp_mem
    buf_idx = ltp_mem
    lag = 0
    for k in range(st.nb_subfr):
        a_q12 = ctrl.pred[k >> 1]
        b_q14 = ctrl.ltp[k * 5:k * 5 + 5]
        signal_type = st.signal_type
        gain = ctrl.gains[k]
        gain_q10 = gain >> 6
        inv_gain = inverse32_varq(gain, 47)
        if gain != st.prev_gain_q16:
            gain_adj = div32_varq(st.prev_gain_q16, gain, 16)
            for i in range(MAX_LPC_ORDER):
                s_lpc[i] = smulww(gain_adj, s_lpc[i])
        else:
            gain_adj = 1 << 16
        st.prev_gain_q16 = gain
        if st.loss_cnt and st.prev_signal_type == TYPE_VOICED and \
                st.signal_type != TYPE_VOICED and k < 2:
            b_q14 = [0, 0, 4096, 0, 0]
            signal_type = TYPE_VOICED
            ctrl.pitch[k] = st.lag_prev
        if signal_type == TYPE_VOICED:
            lag = ctrl.pitch[k]
            if k == 0 or (k == 2 and interp):
                start = ltp_mem - lag - order - LTP_ORDER // 2
                if k == 2:
                    st.out_buf[ltp_mem:ltp_mem + 2 * sub] = xq[:2 * sub]
                s_ltp[start:] = lpc_analysis_filter(
                    st.out_buf, start + k * sub, a_q12, ltp_mem - start,
                    order)
                if k == 0:
                    inv_gain = w32(smulwb(inv_gain, ctrl.ltp_scale) << 2)
                for i in range(lag + LTP_ORDER // 2):
                    s_ltp_q15[buf_idx - i - 1] = smulwb(
                        inv_gain, s_ltp[ltp_mem - i - 1])
            elif gain_adj != 1 << 16:
                for i in range(lag + LTP_ORDER // 2):
                    s_ltp_q15[buf_idx - i - 1] = smulww(
                        gain_adj, s_ltp_q15[buf_idx - i - 1])
        base = k * sub
        if signal_type == TYPE_VOICED:
            res = [0] * sub
            p = buf_idx - lag + LTP_ORDER // 2
            for i in range(sub):
                pred = 2
                pred = smlawb(pred, s_ltp_q15[p], b_q14[0])
                pred = smlawb(pred, s_ltp_q15[p - 1], b_q14[1])
                pred = smlawb(pred, s_ltp_q15[p - 2], b_q14[2])
                pred = smlawb(pred, s_ltp_q15[p - 3], b_q14[3])
                pred = smlawb(pred, s_ltp_q15[p - 4], b_q14[4])
                p += 1
                res[i] = exc[base + i] + (pred << 1)
                s_ltp_q15[buf_idx] = res[i] << 1
                buf_idx += 1
        else:
            res = exc[base:base + sub]
        for i in range(sub):
            pred = order >> 1
            at = MAX_LPC_ORDER + i
            for j in range(order):
                pred = smlawb(pred, s_lpc[at - 1 - j], a_q12[j])
            s_lpc[at] = sat32(res[i] + lshift_sat32(pred, 4))
            xq[base + i] = sat16(rshift_round(smulww(s_lpc[at], gain_q10),
                                              8))
        s_lpc = s_lpc[sub:sub + MAX_LPC_ORDER] + [0] * sub
    st.s_lpc = s_lpc[:MAX_LPC_ORDER]
    return xq


def decode_frame(st: ChannelState, rd: RangeDecoder, cond: int,
                 lost: bool = False) -> List[int]:
    """silk_decode_frame: a frame from ``rd``, or (``lost``) its
    concealment."""
    if st.fs_khz != st.plc_fs_khz:
        plc_reset(st)
        st.plc_fs_khz = st.fs_khz
    if not lost:
        decode_indices(st, rd, st.frames_decoded, False, cond)
        pulses = decode_pulses(rd, st.signal_type, st.quant_offset,
                               st.frame_length)
        ctrl = decode_parameters(st, cond)
        out = decode_core(st, ctrl, pulses)
        plc_update(st, ctrl)
        st.loss_cnt = 0
        st.prev_signal_type = st.signal_type
        st.first_frame_after_reset = 0
    else:
        st.signal_type = st.prev_signal_type
        ctrl = _Ctrl()
        out = plc_conceal(st, ctrl)
        st.loss_cnt += 1
    L = st.frame_length
    mv = st.ltp_mem_length - L
    st.out_buf[:mv] = st.out_buf[L:L + mv]
    st.out_buf[mv:mv + L] = out
    cng(st, ctrl, out)
    plc_glue_frames(st, out)
    st.lag_prev = ctrl.pitch[st.nb_subfr - 1]
    return out


# -- loss concealment and comfort noise (silk/PLC.c, silk/CNG.c) -------------

HARM_ATT_Q15 = (32440, 31130)
PLC_RAND_ATTENUATE_V_Q15 = (31130, 26214)
PLC_RAND_ATTENUATE_UV_Q15 = (32440, 29491)
V_PITCH_GAIN_START_MIN_Q14 = 11469
V_PITCH_GAIN_START_MAX_Q14 = 15565
BWE_COEF_Q16 = 64881
BWE_AFTER_LOSS_Q16 = 63570
PITCH_DRIFT_FAC_Q16 = 655
CNG_GAIN_SMTH_Q16 = 4634
CNG_NLSF_SMTH_Q16 = 16348


def plc_reset(st: ChannelState) -> None:
    st.plc_pitch_q8 = st.frame_length << 7
    st.plc_gain = [65536, 65536]
    st.plc_subfr_length = 20
    st.plc_nb_subfr = 2


def plc_update(st: ChannelState, ctrl: _Ctrl) -> None:
    """silk_PLC_update: what a good frame leaves for a concealment."""
    gain = 0
    if st.signal_type == TYPE_VOICED:
        j = 0
        while j * st.subfr_length < ctrl.pitch[st.nb_subfr - 1]:
            if j == st.nb_subfr:
                break
            k = st.nb_subfr - 1 - j
            tmp = sum(ctrl.ltp[k * 5:k * 5 + 5])
            if tmp > gain:
                gain = tmp
                st.plc_pitch_q8 = ctrl.pitch[k] << 8
            j += 1
        st.plc_ltp = [0, 0, gain, 0, 0]
        if gain < V_PITCH_GAIN_START_MIN_Q14:
            scale = (V_PITCH_GAIN_START_MIN_Q14 << 10) // max(gain, 1)
            st.plc_ltp = [smulbb(v, scale) >> 10 for v in st.plc_ltp]
        elif gain > V_PITCH_GAIN_START_MAX_Q14:
            scale = (V_PITCH_GAIN_START_MAX_Q14 << 14) // max(gain, 1)
            st.plc_ltp = [smulbb(v, scale) >> 14 for v in st.plc_ltp]
    else:
        st.plc_pitch_q8 = smulbb(st.fs_khz, 18) << 8
        st.plc_ltp = [0] * 5
    st.plc_lpc = list(ctrl.pred[1][:st.lpc_order]) \
        + [0] * (MAX_LPC_ORDER - st.lpc_order)
    st.plc_ltp_scale = ctrl.ltp_scale
    st.plc_gain = list(ctrl.gains[st.nb_subfr - 2:st.nb_subfr])
    st.plc_subfr_length = st.subfr_length
    st.plc_nb_subfr = st.nb_subfr


def bwexpander(ar: List[int], d: int, chirp: int) -> None:
    minus1 = chirp - 65536
    for i in range(d - 1):
        ar[i] = i16(rshift_round(chirp * ar[i], 16))
        chirp += rshift_round(chirp * minus1, 16)
    ar[d - 1] = i16(rshift_round(chirp * ar[d - 1], 16))


def sum_sqr_shift(x: List[int]):
    n = len(x)
    shft = 31 - clz32(n)
    nrg = n
    for i in range(0, n - 1, 2):
        nrg += ((x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFF) >> shft
    if n & 1:
        nrg += (x[n - 1] * x[n - 1]) >> shft
    shft = max(0, shft + 3 - clz32(nrg))
    nrg = 0
    for i in range(0, n - 1, 2):
        nrg += ((x[i] * x[i] + x[i + 1] * x[i + 1]) & 0xFFFFFFFF) >> shft
    if n & 1:
        nrg += (x[n - 1] * x[n - 1]) >> shft
    return w32(nrg), shft


def plc_conceal(st: ChannelState, ctrl: _Ctrl) -> List[int]:
    """silk_PLC_conceal: a lost frame from the last good one's LTP and LPC
    filters and its excitation."""
    L = st.frame_length
    sub = st.subfr_length
    ltp_mem = st.ltp_mem_length
    order = st.lpc_order
    prev_gain_q10 = [g >> 6 for g in st.plc_gain]
    if st.first_frame_after_reset:
        st.plc_lpc = [0] * MAX_LPC_ORDER
    bufs = []
    for k in range(2):
        base = (k + st.nb_subfr - 2) * sub
        bufs.append([sat16(smulww(st.exc_q14[base + i], prev_gain_q10[k])
                           >> 8) for i in range(sub)])
    e1, s1 = sum_sqr_shift(bufs[0])
    e2, s2 = sum_sqr_shift(bufs[1])
    if (e1 >> s2) < (e2 >> s1):
        rand_at = max(0, (st.plc_nb_subfr - 1) * st.plc_subfr_length - 128)
    else:
        rand_at = max(0, st.plc_nb_subfr * st.plc_subfr_length - 128)
    b_q14 = st.plc_ltp
    rand_scale = st.plc_rand_scale
    harm_gain = HARM_ATT_Q15[min(1, st.loss_cnt)]
    if st.prev_signal_type == TYPE_VOICED:
        rand_gain = PLC_RAND_ATTENUATE_V_Q15[min(1, st.loss_cnt)]
    else:
        rand_gain = PLC_RAND_ATTENUATE_UV_Q15[min(1, st.loss_cnt)]
    bwexpander(st.plc_lpc, order, BWE_COEF_Q16)
    a_q12 = list(st.plc_lpc[:order])
    if st.loss_cnt == 0:
        rand_scale = 1 << 14
        if st.prev_signal_type == TYPE_VOICED:
            for v in b_q14:
                rand_scale -= v
            rand_scale = max(3277, rand_scale)
            rand_scale = i16(smulbb(rand_scale, st.plc_ltp_scale) >> 14)
        else:
            inv_gain = lpc_inverse_pred_gain(st.plc_lpc, order)
            down = min((1 << 30) >> 3, inv_gain)
            down = max((1 << 30) >> 8, down)
            down = w32(down << 3)
            rand_gain = smulwb(down, rand_gain) >> 14
    seed = st.plc_rand_seed
    lag = rshift_round(st.plc_pitch_q8, 8)
    buf_idx = ltp_mem
    idx = ltp_mem - lag - order - 2
    s_ltp = [0] * ltp_mem
    s_ltp[idx:] = lpc_analysis_filter(st.out_buf, idx, a_q12, ltp_mem - idx,
                                      order)
    inv_gain = min(inverse32_varq(st.plc_gain[1], 46), 0x7FFFFFFF >> 1)
    s_ltp_q14 = [0] * (ltp_mem + L)
    for i in range(idx + order, ltp_mem):
        s_ltp_q14[i] = smulwb(inv_gain, s_ltp[i])
    rand = st.exc_q14
    for k in range(st.nb_subfr):
        p = buf_idx - lag + 2
        for i in range(sub):
            pred = 2
            pred = smlawb(pred, s_ltp_q14[p], b_q14[0])
            pred = smlawb(pred, s_ltp_q14[p - 1], b_q14[1])
            pred = smlawb(pred, s_ltp_q14[p - 2], b_q14[2])
            pred = smlawb(pred, s_ltp_q14[p - 3], b_q14[3])
            pred = smlawb(pred, s_ltp_q14[p - 4], b_q14[4])
            p += 1
            seed = silk_rand(seed)
            j = (seed >> 25) & 127
            s_ltp_q14[buf_idx] = w32(smlawb(pred, rand[rand_at + j],
                                            rand_scale) << 2)
            buf_idx += 1
        b_q14 = [smulbb(harm_gain, v) >> 15 for v in b_q14]
        if st.signal_type != TYPE_NO_VOICE:
            rand_scale = smulbb(rand_scale, rand_gain) >> 15
        st.plc_pitch_q8 = smlawb(st.plc_pitch_q8, st.plc_pitch_q8,
                                 PITCH_DRIFT_FAC_Q16)
        st.plc_pitch_q8 = min(st.plc_pitch_q8, smulbb(18, st.fs_khz) << 8)
        lag = rshift_round(st.plc_pitch_q8, 8)
    st.plc_ltp = b_q14
    # LPC synthesis over the state at ltp_mem - 16
    base = ltp_mem - MAX_LPC_ORDER
    s_ltp_q14[base:ltp_mem] = st.s_lpc
    out = [0] * L
    for i in range(L):
        pred = order >> 1
        at = base + MAX_LPC_ORDER + i
        for j in range(order):
            pred = smlawb(pred, s_ltp_q14[at - 1 - j], a_q12[j])
        s_ltp_q14[at] = sat32(s_ltp_q14[at] + lshift_sat32(pred, 4))
        out[i] = sat16(rshift_round(smulww(s_ltp_q14[at], prev_gain_q10[1]),
                                    8))
    st.s_lpc = s_ltp_q14[base + L:base + L + MAX_LPC_ORDER]
    st.plc_rand_seed = seed
    st.plc_rand_scale = rand_scale
    ctrl.pitch = [lag] * 4
    return out


def plc_glue_frames(st: ChannelState, frame: List[int]) -> None:
    """silk_PLC_glue_frames: a good frame after concealed ones fades in
    from the concealment's energy where it is louder."""
    if st.loss_cnt:
        st.plc_conc_energy, st.plc_conc_shift = sum_sqr_shift(frame)
        st.plc_last_lost = True
        return
    if st.plc_last_lost:
        energy, shift = sum_sqr_shift(frame)
        conc = st.plc_conc_energy
        if shift > st.plc_conc_shift:
            conc >>= shift - st.plc_conc_shift
        elif shift < st.plc_conc_shift:
            energy >>= st.plc_conc_shift - shift
        if energy > conc:
            lz = clz32(conc) - 1
            conc = w32(conc << lz)
            energy >>= max(24 - lz, 0)
            frac = tdiv(conc, max(energy, 1))
            gain = _sqrt_approx(frac) << 4
            slope = tdiv((1 << 16) - gain, len(frame)) << 2
            for i in range(len(frame)):
                frame[i] = smulwb(gain, frame[i])
                gain += slope
                if gain > 1 << 16:
                    break
        st.plc_conc_energy = conc
    st.plc_last_lost = False


def _sqrt_approx(x: int) -> int:
    if x <= 0:
        return 0
    lz = clz32(x)
    rot = (24 - lz) & 31
    u = x & 0xFFFFFFFF
    frac = (((u >> rot) | (u << (32 - rot))) & 0xFFFFFFFF) & 0x7F \
        if rot else u & 0x7F
    y = 32768 if lz & 1 else 46214
    y >>= lz >> 1
    return smlawb(y, y, smulbb(213, frac))


def cng(st: ChannelState, ctrl: _Ctrl, frame: List[int]) -> None:
    """silk_CNG: the comfort noise's parameters from frames of no voice
    activity, and the noise added to a concealed frame."""
    order = st.lpc_order
    if st.fs_khz != st.cng_fs_khz:
        step = 0x7FFF // (order + 1)
        st.cng_nlsf = [step * (i + 1) for i in range(order)] \
            + [0] * (MAX_LPC_ORDER - order)
        st.cng_gain = 0
        st.cng_seed = 3176576
        st.cng_fs_khz = st.fs_khz
    if st.loss_cnt == 0 and st.prev_signal_type == TYPE_NO_VOICE:
        for i in range(order):
            st.cng_nlsf[i] += smulwb(st.prev_nlsf[i] - st.cng_nlsf[i],
                                     CNG_NLSF_SMTH_Q16)
        max_gain, subfr = 0, 0
        for i in range(st.nb_subfr):
            if ctrl.gains[i] > max_gain:
                max_gain, subfr = ctrl.gains[i], i
        sub = st.subfr_length
        n = (st.nb_subfr - 1) * sub
        st.cng_exc[sub:sub + n] = st.cng_exc[:n]
        st.cng_exc[:sub] = st.exc_q14[subfr * sub:(subfr + 1) * sub]
        for i in range(st.nb_subfr):
            st.cng_gain += smulwb(ctrl.gains[i] - st.cng_gain,
                                  CNG_GAIN_SMTH_Q16)
    if not st.loss_cnt:
        st.cng_synth[:order] = [0] * order
        return
    L = len(frame)
    g = smulww(st.plc_rand_scale, st.plc_gain[1])
    if g >= 1 << 21 or st.cng_gain > 1 << 23:
        g = (g >> 16) * (g >> 16)
        g = w32(((st.cng_gain >> 16) * (st.cng_gain >> 16)) - (g << 5))
        g = w32(_sqrt_approx(g) << 16)
    else:
        g = smulww(g, g)
        g = w32(smulww(st.cng_gain, st.cng_gain) - (g << 5))
        g = w32(_sqrt_approx(g) << 8)
    gain_q10 = g >> 6
    mask = 255
    while mask > L:
        mask >>= 1
    seed = st.cng_seed
    sig = list(st.cng_synth) + [0] * L
    for i in range(L):
        seed = silk_rand(seed)
        sig[MAX_LPC_ORDER + i] = st.cng_exc[(seed >> 24) & mask]
    st.cng_seed = seed
    a_q12 = nlsf2a(st.cng_nlsf[:order], order)
    for i in range(L):
        at = MAX_LPC_ORDER + i
        pred = order >> 1
        for j in range(order):
            pred = smlawb(pred, sig[at - 1 - j], a_q12[j])
        sig[at] = sat32(sig[at] + lshift_sat32(pred, 4))
        frame[i] = sat16(frame[i] + sat16(rshift_round(
            smulww(sig[at], gain_q10), 8)))
    st.cng_synth = sig[L:L + MAX_LPC_ORDER]


# -- stereo -------------------------------------------------------------------


def stereo_decode_pred(rd: RangeDecoder) -> List[int]:
    n = rd.icdf(T.STEREO_PRED_JOINT_ICDF, 8)
    ix = [[0, 0, n // 5], [0, 0, n - 5 * (n // 5)]]
    for k in range(2):
        ix[k][0] = rd.icdf(T.UNIFORM3_ICDF, 8)
        ix[k][1] = rd.icdf(T.UNIFORM5_ICDF, 8)
    pred = [0, 0]
    q = T.STEREO_PRED_QUANT_Q13
    for k in range(2):
        ix[k][0] += 3 * ix[k][2]
        low = q[ix[k][0]]
        step = smulwb(q[ix[k][0] + 1] - low, 6554)
        pred[k] = low + i16(step) * i16(2 * ix[k][1] + 1)
    pred[0] -= pred[1]
    return pred


def stereo_ms_to_lr(dec: SilkDecoder, x1: List[int], x2: List[int],
                    pred: List[int], fs_khz: int, n: int) -> None:
    x1[0:2] = dec.s_mid
    x2[0:2] = dec.s_side
    dec.s_mid = x1[n:n + 2]
    dec.s_side = x2[n:n + 2]
    p0, p1 = dec.pred_prev
    interp = STEREO_INTERP_MS * fs_khz
    denom = (1 << 16) // interp
    d0 = rshift_round(smulbb(pred[0] - dec.pred_prev[0], denom), 16)
    d1 = rshift_round(smulbb(pred[1] - dec.pred_prev[1], denom), 16)
    for k in range(n):
        if k < interp:
            p0 += d0
            p1 += d1
        else:
            p0, p1 = pred
        s = ((x1[k] + x1[k + 2]) + (x1[k + 1] << 1)) << 9
        s = smlawb(x2[k + 1] << 8, s, p0)
        s = smlawb(s, x1[k + 1] << 11, p1)
        x2[k + 1] = sat16(rshift_round(s, 8))
    dec.pred_prev = list(pred)
    for k in range(n):
        a, b = x1[k + 1], x2[k + 1]
        x1[k + 1] = sat16(a + b)
        x2[k + 1] = sat16(a - b)


# -- one Opus frame -----------------------------------------------------------


def silk_decode_call(dec: SilkDecoder, rd: RangeDecoder, n_internal: int,
                     internal_rate: int, payload_ms: int, new_packet: bool,
                     lost: bool = False) -> List[List[int]]:
    """One silk_Decode call (one SILK frame of each channel, or with
    ``lost`` its concealment) -> the 48 kHz output of each API channel."""
    chs = dec.ch
    if new_packet:
        for n in range(n_internal):
            chs[n].frames_decoded = 0
    if n_internal > dec.n_internal:
        chs[1].reset()
    stereo_to_mono = n_internal == 1 and dec.n_internal == 2 and \
        internal_rate == 1000 * chs[0].fs_khz
    if chs[0].frames_decoded == 0:
        for n in range(n_internal):
            per, sub = {10: (1, 2), 20: (1, 4), 40: (2, 4),
                        60: (3, 4)}[payload_ms]
            chs[n].frames_per_packet = per
            chs[n].nb_subfr = sub
            chs[n].set_fs((internal_rate >> 10) + 1, 48000)
    if dec.channels_api == 2 and n_internal == 2 and (
            dec.n_api == 1 or dec.n_internal == 1):
        dec.pred_prev = [0, 0]
        dec.s_side = [0, 0]
        chs[1].resampler = _copy_resampler(chs[0].resampler)
    dec.n_api = dec.channels_api
    dec.n_internal = n_internal
    decode_only_middle = 0
    if not lost and chs[0].frames_decoded == 0:
        for n in range(n_internal):
            for i in range(chs[n].frames_per_packet):
                chs[n].vad_flags[i] = rd.bit_logp(1)
            chs[n].lbrr_flag = rd.bit_logp(1)
        for n in range(n_internal):
            chs[n].lbrr_flags = [0, 0, 0]
            if chs[n].lbrr_flag:
                if chs[n].frames_per_packet == 1:
                    chs[n].lbrr_flags[0] = 1
                else:
                    icdf = T.LBRR_FLAGS_2_ICDF \
                        if chs[n].frames_per_packet == 2 \
                        else T.LBRR_FLAGS_3_ICDF
                    sym = rd.icdf(icdf, 8) + 1
                    for i in range(chs[n].frames_per_packet):
                        chs[n].lbrr_flags[i] = (sym >> i) & 1
        # LBRR frames are parsed and skipped
        for i in range(chs[0].frames_per_packet):
            for n in range(n_internal):
                if chs[n].lbrr_flags[i]:
                    if n_internal == 2 and n == 0:
                        stereo_decode_pred(rd)
                        if chs[1].lbrr_flags[i] == 0:
                            rd.icdf(T.STEREO_ONLY_MID_ICDF, 8)
                    cond = CODE_CONDITIONALLY if (
                        i > 0 and chs[n].lbrr_flags[i - 1]) \
                        else CODE_INDEPENDENTLY
                    decode_indices(chs[n], rd, i, True, cond)
                    decode_pulses(rd, chs[n].signal_type,
                                  chs[n].quant_offset, chs[n].frame_length)
    ms_pred = [0, 0]
    if n_internal == 2:
        if lost:
            ms_pred = list(dec.pred_prev)
        else:
            ms_pred = stereo_decode_pred(rd)
            if chs[1].vad_flags[chs[0].frames_decoded] == 0:
                decode_only_middle = rd.icdf(T.STEREO_ONLY_MID_ICDF, 8)
    if n_internal == 2 and decode_only_middle == 0 and \
            dec.prev_decode_only_middle == 1:
        c1 = chs[1]
        c1.out_buf = [0] * 480
        c1.s_lpc = [0] * MAX_LPC_ORDER
        c1.lag_prev = 100
        c1.last_gain_index = 10
        c1.prev_signal_type = TYPE_NO_VOICE
        c1.first_frame_after_reset = 1
    frame_len = chs[0].frame_length
    outs = [[0] * (frame_len + 2), [0] * (frame_len + 2)]
    has_side = not (dec.prev_decode_only_middle if lost
                    else decode_only_middle)
    n_dec = frame_len
    for n in range(n_internal):
        if n == 0 or has_side:
            fi = chs[0].frames_decoded - n
            if fi <= 0:
                cond = CODE_INDEPENDENTLY
            elif n > 0 and dec.prev_decode_only_middle:
                cond = CODE_NO_LTP_SCALING
            else:
                cond = CODE_CONDITIONALLY
            y = decode_frame(chs[n], rd, cond, lost)
            n_dec = len(y)
            outs[n][2:2 + n_dec] = y
        chs[n].frames_decoded += 1
    if dec.channels_api == 2 and n_internal == 2:
        stereo_ms_to_lr(dec, outs[0], outs[1], ms_pred, chs[0].fs_khz, n_dec)
    else:
        outs[0][0:2] = dec.s_mid
        dec.s_mid = outs[0][n_dec:n_dec + 2]
    result = []
    for n in range(min(dec.channels_api, n_internal)):
        result.append(resample(chs[n].resampler, outs[n][1:1 + n_dec]))
    if dec.channels_api == 2 and n_internal == 1:
        if stereo_to_mono:
            result.append(resample(chs[1].resampler, outs[0][1:1 + n_dec]))
        else:
            result.append(list(result[0]))
    if lost:
        for n in range(n_internal):
            chs[n].last_gain_index = 10
    else:
        dec.prev_decode_only_middle = decode_only_middle
    return result


def _copy_resampler(r: Resampler) -> Resampler:
    c = Resampler.__new__(Resampler)
    c.__dict__.update({k: (list(v) if isinstance(v, list) else v)
                       for k, v in r.__dict__.items()})
    return c


def decode(dec: SilkDecoder, rd: Optional[RangeDecoder], n_internal: int,
           internal_rate: int, payload_ms: int, frame_size: int
           ) -> np.ndarray:
    """An Opus frame's SILK part -> int16-valued float64 [frame_size,
    channels] at 48 kHz, through the helper where ``dec`` has one. With no
    ``rd``, the concealment of a lost frame (libopus decodes one at a mode
    switch that carries no redundancy frame)."""
    if dec.handle is not None:
        from .native import silk_frame
        return silk_frame(dec.lib, dec, rd, n_internal, internal_rate,
                          payload_ms, frame_size)
    pieces = []
    done = 0
    while done < frame_size:
        out = silk_decode_call(dec, rd, n_internal, internal_rate,
                               payload_ms, done == 0, rd is None)
        pieces.append(np.asarray(out, np.float64).T)
        done += len(out[0])
    return np.concatenate(pieces)[:frame_size]
