"""The CELT decoder of Opus (RFC 6716 §4.3 with the fixes of RFC 8251), as
libopus 1.3.1 decodes its 48 kHz mode.

A frame decodes in three steps:

* ``frame_spectrum``: everything that reads
  the range coder, in order: silence, the pitch post-filter's parameters,
  the transient flag, coarse energy (Laplace-coded, predicted across time
  and frequency), the TF changes, spreading, dynamic allocation, the
  allocation trim, ``compute_allocation`` (its search, skipped bands,
  intensity and dual stereo), fine energy, every band's PVQ vector
  (band splitting with theta, stereo, folding, noise fill), anti-collapse
  and the final energy bits; then the bands denormalised into MDCT
  coefficients. State: the band energies of the last frames and the
  folding's random seed.
* ``synthesize``: the inverse MDCT of each block (one long block or 2-8
  short ones) through a mixed-radix FFT (``fft``), and the overlap-add
  with the 120-sample low-overlap window.
* ``postfilter_deemphasis``: the pitch post-filter, an IIR comb
  cross-faded between the last frame's parameters and this one's over the
  window, and the de-emphasis filter, scaled to [-1, 1].

These are the plain versions; ``celt_frame`` in ``csrc/audio_dsp.cpp``
runs all three in one call (``audio/native.py`` ``celt_decode``). The
arithmetic is double precision where the reference's is single; the C++
helper computes in the same order, with the same tables (``synth_blob``),
and decodes to the same bits. ``decode_lost`` conceals a frame with no
payload (pitch- or noise-based, as ``celt_decode_lost``), one version for
both paths.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np

from . import celt_tables as T
from .opus_range import BITRES, RangeDecoder

NB = T.NB_EBANDS
EB = T.EBANDS
DECODE_HISTORY = 2048  # the decoder's memory (DECODE_BUFFER_SIZE)
SPREAD_NONE, SPREAD_LIGHT, SPREAD_NORMAL, SPREAD_AGGRESSIVE = 0, 1, 2, 3
FINE_OFFSET = 21
MAX_FINE_BITS = 8
QTHETA_OFFSET = 4
QTHETA_OFFSET_TWOPHASE = 16
LOG_MAX_PSEUDO = 6
ALLOC_STEPS = 6
EPSILON = 1e-15
NORM_SCALING = 1.0
VERY_SMALL = float(np.float32(1e-30))
LPC_ORDER = 24
MAX_PERIOD = 1024
PLC_PITCH_LAG_MAX = 720
PLC_PITCH_LAG_MIN = 100
HAAR = float(np.float32(0.70710678))


class CeltError(ValueError):
    pass


@dataclass
class CeltState:
    """A CELT decoder's state between frames. ``channels`` is the
    decoder's (1 or 2); ``stream_channels``, ``start`` and ``end`` are set
    by the Opus layer for each frame."""
    channels: int
    stream_channels: int = 0
    start: int = 0
    end: int = NB
    disable_inv: bool = False
    rng: int = 0
    energy: np.ndarray = field(default=None)  # [4, 2 * NB]: old, log, log2, bg
    postfilter: np.ndarray = field(default=None)  # period, gain, tapset, old
    history: np.ndarray = field(default=None)  # [ch, DECODE_HISTORY + 60]
    preemph: np.ndarray = field(default=None)  # [2]

    def __post_init__(self):
        if self.stream_channels == 0:
            self.stream_channels = self.channels
        self.disable_inv = self.channels == 1
        self.reset()

    def reset(self) -> None:
        """OPUS_RESET_STATE: silence everything, the log energies to -28."""
        self.rng = 0
        self.loss_count = 0
        self.skip_plc = True
        self.last_pitch_index = 0
        self.lpc = np.zeros((self.channels, LPC_ORDER))
        self.energy = np.zeros((4, 2 * NB))
        self.energy[1:3] = -28.0
        # [period, gain, tapset, period_old, gain_old, tapset_old]
        self.postfilter = np.zeros(6)
        self.history = np.zeros((self.channels, DECODE_HISTORY + 60))
        self.preemph = np.zeros(2)


# -- small integer helpers ---------------------------------------------------


def _tdiv(a: int, b: int) -> int:
    """C's signed division: truncation toward zero."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b > 0) else -q


def _i16(x: int) -> int:
    x &= 0xFFFF
    return x - 0x10000 if x & 0x8000 else x


def frac_mul16(a: int, b: int) -> int:
    return (16384 + _i16(a) * _i16(b)) >> 15


def bitexact_cos(x: int) -> int:
    tmp = (4096 + x * x) >> 13
    x2 = _i16(tmp)
    x2 = (32767 - x2) + frac_mul16(x2, (-7651 + frac_mul16(
        x2, (8277 + frac_mul16(-626, x2)))))
    return 1 + _i16(x2)


def bitexact_log2tan(isin: int, icos: int) -> int:
    lc = icos.bit_length()
    ls = isin.bit_length()
    icos <<= 15 - lc
    isin <<= 15 - ls
    return (ls - lc) * (1 << 11) \
        + frac_mul16(isin, frac_mul16(isin, -2597) + 7932) \
        - frac_mul16(icos, frac_mul16(icos, -2597) + 7932)


def lcg_rand(seed: int) -> int:
    return (1664525 * seed + 1013904223) & 0xFFFFFFFF


def _s32(x: int) -> int:
    return x - (1 << 32) if x & 0x80000000 else x


@lru_cache(maxsize=None)
def pvq_u(n: int, k: int) -> int:
    """U(n, k) of the PVQ codebook size recursion: V(n, k) = U(n, k) +
    U(n, k + 1)."""
    if n == 0:
        return 1 if k == 0 else 0
    if k == 0:
        return 0
    return pvq_u(n - 1, k) + pvq_u(n, k - 1) + pvq_u(n - 1, k - 1)


def pvq_v(n: int, k: int) -> int:
    return pvq_u(n, k) + pvq_u(n, k + 1)


def cwrsi(n: int, k: int, i: int, y: List[int]) -> float:
    """The PVQ vector of index ``i`` (``n`` dimensions, ``k`` pulses)
    into ``y``; returns its squared norm."""
    yy = 0.0
    pos = 0
    while n > 2:
        if k >= n:
            p = pvq_u(n, k + 1)
            s = -int(i >= p)
            i -= p & s
            k0 = k
            q = pvq_u(n, n)
            if q > i:
                k = n
                while True:
                    k -= 1
                    p = pvq_u(k, n)
                    if p <= i:
                        break
            else:
                p = pvq_u(n, k)
                while p > i:
                    k -= 1
                    p = pvq_u(n, k)
            i -= p
            val = (k0 - k + s) ^ s
            y[pos] = val
            pos += 1
            yy += val * val
        else:
            p = pvq_u(k, n)
            q = pvq_u(k + 1, n)
            if p <= i < q:
                i -= p
                y[pos] = 0
                pos += 1
            else:
                s = -int(i >= q)
                i -= q & s
                k0 = k
                while True:
                    k -= 1
                    p = pvq_u(k, n)
                    if p <= i:
                        break
                i -= p
                val = (k0 - k + s) ^ s
                y[pos] = val
                pos += 1
                yy += val * val
        n -= 1
    p = 2 * k + 1
    s = -int(i >= p)
    i -= p & s
    k0 = k
    k = (i + 1) >> 1
    if k:
        i -= 2 * k - 1
    val = (k0 - k + s) ^ s
    y[pos] = val
    pos += 1
    yy += val * val
    s = -i
    val = (k + s) ^ s
    y[pos] = val
    yy += val * val
    return yy


# -- energy ----------------------------------------------------------------


def laplace_decode(rd: RangeDecoder, fs: int, decay: int) -> int:
    val = 0
    fm = rd.decode_bin(15)
    fl = 0
    if fm >= fs:
        val += 1
        fl = fs
        fs = (((32768 - 32 - fs) * (16384 - decay)) >> 15) + 1
        while fs > 1 and fm >= fl + 2 * fs:
            fs *= 2
            fl += fs
            fs = (((fs - 2) * decay) >> 15) + 1
            val += 1
        if fs <= 1:
            di = (fm - fl) >> 1
            val += di
            fl += 2 * di
        if fm < fl + fs:
            val = -val
        else:
            fl += fs
    rd.update(fl, min(fl + fs, 32768), 32768)
    return val


def unquant_coarse_energy(rd: RangeDecoder, old: List[float], start: int,
                          end: int, intra: int, C: int, LM: int) -> None:
    prob = T.E_PROB_MODEL[(LM * 2 + intra) * 42:(LM * 2 + intra + 1) * 42]
    if intra:
        coef, beta = 0.0, T.BETA_INTRA
    else:
        coef, beta = T.PRED_COEF[LM], T.BETA_COEF[LM]
    prev = [0.0, 0.0]
    budget = rd.storage * 8
    for i in range(start, end):
        for c in range(C):
            tell = rd.tell()
            if budget - tell >= 15:
                pi = 2 * min(i, 20)
                qi = laplace_decode(rd, prob[pi] << 7, prob[pi + 1] << 6)
            elif budget - tell >= 2:
                qi = rd.icdf(T.SMALL_ENERGY_ICDF, 2)
                qi = (qi >> 1) ^ -(qi & 1)
            elif budget - tell >= 1:
                qi = -rd.bit_logp(1)
            else:
                qi = -1
            q = float(qi)
            k = i + c * NB
            old[k] = max(-9.0, old[k])
            tmp = coef * old[k] + prev[c] + q
            old[k] = tmp
            prev[c] = prev[c] + q - beta * q


def unquant_fine_energy(rd: RangeDecoder, old: List[float], start: int,
                        end: int, fine: List[int], C: int) -> None:
    for i in range(start, end):
        if fine[i] <= 0:
            continue
        for c in range(C):
            q2 = rd.bits(fine[i])
            offset = (q2 + 0.5) * (1 << (14 - fine[i])) * (1.0 / 16384) - 0.5
            old[i + c * NB] += offset


def unquant_energy_finalise(rd: RangeDecoder, old: List[float], start: int,
                            end: int, fine: List[int], prio: List[int],
                            bits_left: int, C: int) -> None:
    for p in range(2):
        i = start
        while i < end and bits_left >= C:
            if fine[i] >= MAX_FINE_BITS or prio[i] != p:
                i += 1
                continue
            for c in range(C):
                q2 = rd.bits(1)
                offset = (q2 - 0.5) * (1 << (14 - fine[i] - 1)) * (1.0 / 16384)
                old[i + c * NB] += offset
                bits_left -= 1
            i += 1


# -- TF and allocation -------------------------------------------------------


def tf_decode(rd: RangeDecoder, start: int, end: int, transient: int,
              LM: int) -> List[int]:
    tf_res = [0] * NB
    budget = rd.storage * 8
    tell = rd.tell()
    logp = 2 if transient else 4
    tf_select_rsv = int(LM > 0 and tell + logp + 1 <= budget)
    budget -= tf_select_rsv
    tf_changed = curr = 0
    for i in range(start, end):
        if tell + logp <= budget:
            curr ^= rd.bit_logp(logp)
            tell = rd.tell()
            tf_changed |= curr
        tf_res[i] = curr
        logp = 4 if transient else 5
    tf_select = 0
    tab = T.TF_SELECT[LM]
    if tf_select_rsv and tab[4 * transient + tf_changed] != \
            tab[4 * transient + 2 + tf_changed]:
        tf_select = rd.bit_logp(1)
    for i in range(start, end):
        tf_res[i] = tab[4 * transient + 2 * tf_select + tf_res[i]]
    return tf_res


def init_caps(LM: int, C: int) -> List[int]:
    cap = []
    for i in range(NB):
        n = (EB[i + 1] - EB[i]) << LM
        cap.append(((T.CACHE_CAPS[NB * (2 * LM + C - 1) + i] + 64) * C * n)
                   >> 2)
    return cap


def _interp_bits2pulses(rd, start, end, skip_start, bits1, bits2, thresh,
                        cap, total, skip_rsv, intensity_rsv, dual_rsv, C,
                        LM):
    alloc_floor = C << BITRES
    stereo = int(C > 1)
    log_m = LM << BITRES
    lo, hi = 0, 1 << ALLOC_STEPS
    for _ in range(ALLOC_STEPS):
        mid = (lo + hi) >> 1
        psum = 0
        done = False
        for j in range(end - 1, start - 1, -1):
            tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS)
            if tmp >= thresh[j] or done:
                done = True
                psum += min(tmp, cap[j])
            elif tmp >= alloc_floor:
                psum += alloc_floor
        if psum > total:
            hi = mid
        else:
            lo = mid
    psum = 0
    done = False
    bits = [0] * NB
    for j in range(end - 1, start - 1, -1):
        tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS)
        if tmp < thresh[j] and not done:
            tmp = alloc_floor if tmp >= alloc_floor else 0
        else:
            done = True
        tmp = min(tmp, cap[j])
        bits[j] = tmp
        psum += tmp
    coded = end
    while True:
        j = coded - 1
        if j <= skip_start:
            total += skip_rsv
            break
        left = total - psum
        percoeff = left // (EB[coded] - EB[start])
        left -= (EB[coded] - EB[start]) * percoeff
        rem = max(left - (EB[j] - EB[start]), 0)
        band_width = EB[coded] - EB[j]
        band_bits = bits[j] + percoeff * band_width + rem
        if band_bits >= max(thresh[j], alloc_floor + (1 << BITRES)):
            if rd.bit_logp(1):
                break
            psum += 1 << BITRES
            band_bits -= 1 << BITRES
        psum -= bits[j] + intensity_rsv
        if intensity_rsv > 0:
            intensity_rsv = T.LOG2_FRAC[j - start]
        psum += intensity_rsv
        if band_bits >= alloc_floor:
            psum += alloc_floor
            bits[j] = alloc_floor
        else:
            bits[j] = 0
        coded -= 1
    if intensity_rsv > 0:
        intensity = start + rd.uint(coded + 1 - start)
    else:
        intensity = 0
    if intensity <= start:
        total += dual_rsv
        dual_rsv = 0
    dual = rd.bit_logp(1) if dual_rsv > 0 else 0
    left = total - psum
    percoeff = left // (EB[coded] - EB[start])
    left -= (EB[coded] - EB[start]) * percoeff
    for j in range(start, coded):
        bits[j] += percoeff * (EB[j + 1] - EB[j])
    for j in range(start, coded):
        tmp = min(left, EB[j + 1] - EB[j])
        bits[j] += tmp
        left -= tmp
    ebits = [0] * NB
    prio = [0] * NB
    balance = 0
    j = start
    while j < coded:
        n0 = EB[j + 1] - EB[j]
        n = n0 << LM
        bit = bits[j] + balance
        if n > 1:
            excess = max(bit - cap[j], 0)
            bits[j] = bit - excess
            den = C * n + (1 if (C == 2 and n > 2 and not dual
                                 and j < intensity) else 0)
            nclogn = den * (T.LOGN[j] + log_m)
            offset = (nclogn >> 1) - den * FINE_OFFSET
            if n == 2:
                offset += (den << BITRES) >> 2
            if bits[j] + offset < (den * 2) << BITRES:
                offset += nclogn >> 2
            elif bits[j] + offset < (den * 3) << BITRES:
                offset += nclogn >> 3
            e = max(0, bits[j] + offset + (den << (BITRES - 1)))
            e = (e // den) >> BITRES
            if C * e > (bits[j] >> BITRES):
                e = bits[j] >> stereo >> BITRES
            e = min(e, MAX_FINE_BITS)
            ebits[j] = e
            prio[j] = int(e * (den << BITRES) >= bits[j] + offset)
            bits[j] -= (C * e) << BITRES
        else:
            excess = max(0, bit - (C << BITRES))
            bits[j] = bit - excess
            ebits[j] = 0
            prio[j] = 1
        if excess > 0:
            extra_fine = min(excess >> (stereo + BITRES),
                             MAX_FINE_BITS - ebits[j])
            ebits[j] += extra_fine
            extra_bits = (extra_fine * C) << BITRES
            prio[j] = int(extra_bits >= excess - balance)
            excess -= extra_bits
        balance = excess
        j += 1
    while j < end:
        ebits[j] = bits[j] >> stereo >> BITRES
        bits[j] = 0
        prio[j] = int(ebits[j] < 1)
        j += 1
    return coded, bits, ebits, prio, balance, intensity, dual


def compute_allocation(rd, start, end, offsets, cap, trim, total, C, LM):
    """clt_compute_allocation (decoder side) -> (coded bands, pulses,
    fine bits, fine priority, balance, intensity, dual stereo)."""
    total = max(total, 0)
    skip_start = start
    skip_rsv = 1 << BITRES if total >= 1 << BITRES else 0
    total -= skip_rsv
    intensity_rsv = dual_rsv = 0
    if C == 2:
        intensity_rsv = T.LOG2_FRAC[end - start]
        if intensity_rsv > total:
            intensity_rsv = 0
        else:
            total -= intensity_rsv
            dual_rsv = 1 << BITRES if total >= 1 << BITRES else 0
            total -= dual_rsv
    thresh = [0] * NB
    trim_offset = [0] * NB
    for j in range(start, end):
        n = EB[j + 1] - EB[j]
        thresh[j] = max(C << BITRES, (3 * n << LM << BITRES) >> 4)
        trim_offset[j] = (C * n * (trim - 5 - LM) * (end - j - 1)
                          * (1 << (LM + BITRES))) >> 6
        if n << LM == 1:
            trim_offset[j] -= C << BITRES
    lo, hi = 1, 11 - 1
    while True:
        done = False
        psum = 0
        mid = (lo + hi) >> 1
        for j in range(end - 1, start - 1, -1):
            n = EB[j + 1] - EB[j]
            bitsj = (C * n * T.ALLOC_VECTORS[mid * NB + j] << LM) >> 2
            if bitsj > 0:
                bitsj = max(0, bitsj + trim_offset[j])
            bitsj += offsets[j]
            if bitsj >= thresh[j] or done:
                done = True
                psum += min(bitsj, cap[j])
            elif bitsj >= C << BITRES:
                psum += C << BITRES
        if psum > total:
            hi = mid - 1
        else:
            lo = mid + 1
        if lo > hi:
            break
    hi = lo
    lo -= 1
    bits1 = [0] * NB
    bits2 = [0] * NB
    for j in range(start, end):
        n = EB[j + 1] - EB[j]
        b1 = (C * n * T.ALLOC_VECTORS[lo * NB + j] << LM) >> 2
        b2 = cap[j] if hi >= 11 else \
            (C * n * T.ALLOC_VECTORS[hi * NB + j] << LM) >> 2
        if b1 > 0:
            b1 = max(0, b1 + trim_offset[j])
        if b2 > 0:
            b2 = max(0, b2 + trim_offset[j])
        if lo > 0:
            b1 += offsets[j]
        b2 += offsets[j]
        if offsets[j] > 0:
            skip_start = j
        b2 = max(0, b2 - b1)
        bits1[j] = b1
        bits2[j] = b2
    return _interp_bits2pulses(rd, start, end, skip_start, bits1, bits2,
                               thresh, cap, total, skip_rsv, intensity_rsv,
                               dual_rsv, C, LM)


# -- PVQ and the bands -------------------------------------------------------


def get_pulses(i: int) -> int:
    return i if i < 8 else (8 + (i & 7)) << ((i >> 3) - 1)


def _cache(LM: int, band: int) -> int:
    return T.CACHE_INDEX[(LM + 1) * NB + band]


def bits2pulses(band: int, LM: int, bits: int) -> int:
    c = _cache(LM, band)
    cache = T.CACHE_BITS
    lo, hi = 0, cache[c]
    bits -= 1
    for _ in range(LOG_MAX_PSEUDO):
        mid = (lo + hi + 1) >> 1
        if cache[c + mid] >= bits:
            hi = mid
        else:
            lo = mid
    if bits - (-1 if lo == 0 else cache[c + lo]) <= cache[c + hi] - bits:
        return lo
    return hi


def pulses2bits(band: int, LM: int, pulses: int) -> int:
    return 0 if pulses == 0 else T.CACHE_BITS[_cache(LM, band) + pulses] + 1


def exp_rotation1(x: List[float], off: int, length: int, stride: int,
                  c: float, s: float) -> None:
    ms = -s
    for i in range(length - stride):
        x1 = x[off + i]
        x2 = x[off + i + stride]
        x[off + i + stride] = c * x2 + s * x1
        x[off + i] = c * x1 + ms * x2
    for i in range(length - 2 * stride - 1, -1, -1):
        x1 = x[off + i]
        x2 = x[off + i + stride]
        x[off + i + stride] = c * x2 + s * x1
        x[off + i] = c * x1 + ms * x2


def exp_rotation(x: List[float], off: int, length: int, stride: int, k: int,
                 spread: int) -> None:
    """The decoder's direction of PVQ spreading."""
    if 2 * k >= length or spread == SPREAD_NONE:
        return
    factor = (15, 10, 5)[spread - 1]
    gain = length / (length + factor * k)
    theta = 0.5 * (gain * gain)
    c = math.cos(0.5 * math.pi * theta)
    s = math.cos(0.5 * math.pi * (1.0 - theta))
    stride2 = 0
    if length >= 8 * stride:
        stride2 = 1
        while (stride2 * stride2 + stride2) * stride + (stride >> 2) < length:
            stride2 += 1
    length //= stride
    for i in range(stride):
        if stride2:
            exp_rotation1(x, off + i * length, length, stride2, s, c)
        exp_rotation1(x, off + i * length, length, 1, c, s)


def alg_unquant(rd: RangeDecoder, x: List[float], off: int, n: int, k: int,
                spread: int, b: int, gain: float) -> int:
    iy = [0] * n
    ryy = cwrsi(n, k, rd.uint(pvq_v(n, k)), iy)
    g = (1.0 / math.sqrt(ryy)) * gain
    for i in range(n):
        x[off + i] = g * iy[i]
    exp_rotation(x, off, n, b, k, spread)
    if b <= 1:
        return 1
    n0 = n // b
    mask = 0
    for i in range(b):
        if any(iy[i * n0:(i + 1) * n0]):
            mask |= 1 << i
    return mask


def renormalise(x: List[float], off: int, n: int, gain: float) -> None:
    e = EPSILON
    for i in range(n):
        e += x[off + i] * x[off + i]
    g = (1.0 / math.sqrt(e)) * gain
    for i in range(n):
        x[off + i] = g * x[off + i]


def haar1(x: List[float], off: int, n0: int, stride: int) -> None:
    h = HAAR
    n0 >>= 1
    for i in range(stride):
        for j in range(n0):
            a = off + stride * 2 * j + i
            b = off + stride * (2 * j + 1) + i
            t1 = h * x[a]
            t2 = h * x[b]
            x[a] = t1 + t2
            x[b] = t1 - t2


_ORDERY = (1, 0, 3, 0, 2, 1, 7, 0, 4, 3, 6, 1, 5, 2, 15, 0, 8, 7, 12, 3, 11,
           4, 14, 1, 9, 6, 13, 2, 10, 5)


def deinterleave_hadamard(x: List[float], off: int, n0: int, stride: int,
                          hadamard: bool) -> None:
    n = n0 * stride
    tmp = [0.0] * n
    if hadamard:
        o = stride - 2
        for i in range(stride):
            for j in range(n0):
                tmp[_ORDERY[o + i] * n0 + j] = x[off + j * stride + i]
    else:
        for i in range(stride):
            for j in range(n0):
                tmp[i * n0 + j] = x[off + j * stride + i]
    x[off:off + n] = tmp


def interleave_hadamard(x: List[float], off: int, n0: int, stride: int,
                        hadamard: bool) -> None:
    n = n0 * stride
    tmp = [0.0] * n
    if hadamard:
        o = stride - 2
        for i in range(stride):
            for j in range(n0):
                tmp[j * stride + i] = x[off + _ORDERY[o + i] * n0 + j]
    else:
        for i in range(stride):
            for j in range(n0):
                tmp[j * stride + i] = x[off + i * n0 + j]
    x[off:off + n] = tmp


_BIT_INTERLEAVE = (0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3)
_BIT_DEINTERLEAVE = (0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F, 0xC0,
                     0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF)
_EXP2_TABLE8 = (16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048)


def compute_qn(n: int, b: int, offset: int, pulse_cap: int,
               stereo: int) -> int:
    n2 = 2 * n - 1
    if stereo and n == 2:
        n2 -= 1
    qb = _tdiv(b + n2 * offset, n2)
    qb = min(b - pulse_cap - (4 << BITRES), qb)
    qb = min(8 << BITRES, qb)
    if qb < (1 << BITRES >> 1):
        return 1
    qn = _EXP2_TABLE8[qb & 0x7] >> (14 - (qb >> BITRES))
    return (qn + 1) >> 1 << 1


class _Band:
    """quant_all_bands' context (``band_ctx``), decoder side."""
    __slots__ = ("rd", "i", "intensity", "spread", "tf_change",
                 "remaining_bits", "seed", "disable_inv", "avoid_split_noise")


def compute_theta(ctx: _Band, n: int, b: int, B: int, B0: int, LM: int,
                  stereo: int, fill: int):
    rd = ctx.rd
    i = ctx.i
    pulse_cap = T.LOGN[i] + LM * (1 << BITRES)
    offset = (pulse_cap >> 1) - (QTHETA_OFFSET_TWOPHASE if stereo and n == 2
                                 else QTHETA_OFFSET)
    qn = compute_qn(n, b, offset, pulse_cap, stereo)
    if stereo and i >= ctx.intensity:
        qn = 1
    tell = rd.tell_frac()
    itheta = 0
    inv = 0
    if qn != 1:
        if stereo and n > 2:
            p0 = 3
            x0 = qn // 2
            ft = p0 * (x0 + 1) + x0
            fs = rd.decode(ft)
            if fs < (x0 + 1) * p0:
                x = fs // p0
            else:
                x = x0 + 1 + (fs - (x0 + 1) * p0)
            if x <= x0:
                rd.update(p0 * x, p0 * (x + 1), ft)
            else:
                rd.update((x - 1 - x0) + (x0 + 1) * p0,
                          (x - x0) + (x0 + 1) * p0, ft)
            itheta = x
        elif B0 > 1 or stereo:
            itheta = rd.uint(qn + 1)
        else:
            ft = ((qn >> 1) + 1) * ((qn >> 1) + 1)
            fm = rd.decode(ft)
            if fm < ((qn >> 1) * ((qn >> 1) + 1) >> 1):
                itheta = (math.isqrt(8 * fm + 1) - 1) >> 1
                fs = itheta + 1
                fl = itheta * (itheta + 1) >> 1
            else:
                itheta = (2 * (qn + 1)
                          - math.isqrt(8 * (ft - fm - 1) + 1)) >> 1
                fs = qn + 1 - itheta
                fl = ft - ((qn + 1 - itheta) * (qn + 2 - itheta) >> 1)
            rd.update(fl, fl + fs, ft)
        itheta = (itheta * 16384) // qn
    elif stereo:
        if b > 2 << BITRES and ctx.remaining_bits > 2 << BITRES:
            inv = rd.bit_logp(2)
        if ctx.disable_inv:
            inv = 0
        itheta = 0
    qalloc = rd.tell_frac() - tell
    b -= qalloc
    if itheta == 0:
        imid, iside = 32767, 0
        fill &= (1 << B) - 1
        delta = -16384
    elif itheta == 16384:
        imid, iside = 0, 32767
        fill &= ((1 << B) - 1) << B
        delta = 16384
    else:
        imid = bitexact_cos(itheta)
        iside = bitexact_cos(16384 - itheta)
        delta = frac_mul16((n - 1) << 7, bitexact_log2tan(iside, imid))
    return b, fill, inv, imid, iside, delta, itheta, qalloc


def quant_partition(ctx: _Band, x: List[float], off: int, n: int, b: int,
                    B: int, lowband: Optional[List[float]], lb_off: int,
                    LM: int, gain: float, fill: int) -> int:
    i = ctx.i
    B0 = B
    c = T.CACHE_INDEX[(LM + 1) * NB + i]
    cache = T.CACHE_BITS
    if LM != -1 and b > cache[c + cache[c]] + 12 and n > 2:
        n >>= 1
        yoff = off + n
        LM -= 1
        if B == 1:
            fill = (fill & 1) | (fill << 1)
        B = (B + 1) >> 1
        b, fill, _, imid, iside, delta, itheta, qalloc = compute_theta(
            ctx, n, b, B, B0, LM, 0, fill)
        mid = (1.0 / 32768) * imid
        side = (1.0 / 32768) * iside
        if B0 > 1 and (itheta & 0x3fff):
            if itheta > 8192:
                delta -= delta >> (4 - LM)
            else:
                delta = min(0, delta + (n << BITRES >> (5 - LM)))
        mbits = max(0, min(b, _tdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        lb2 = lb_off + n
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_partition(ctx, x, off, n, mbits, B, lowband, lb_off,
                                 LM, gain * mid, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, x, yoff, n, sbits, B, lowband, lb2,
                                  LM, gain * side, fill >> B) << (B0 >> 1)
        else:
            cm = quant_partition(ctx, x, yoff, n, sbits, B, lowband, lb2,
                                 LM, gain * side, fill >> B) << (B0 >> 1)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_partition(ctx, x, off, n, mbits, B, lowband, lb_off,
                                  LM, gain * mid, fill)
        return cm
    q = bits2pulses(i, LM, b)
    curr = pulses2bits(i, LM, q)
    ctx.remaining_bits -= curr
    while ctx.remaining_bits < 0 and q > 0:
        ctx.remaining_bits += curr
        q -= 1
        curr = pulses2bits(i, LM, q)
        ctx.remaining_bits -= curr
    if q != 0:
        return alg_unquant(ctx.rd, x, off, n, get_pulses(q), ctx.spread, B,
                           gain)
    cm_mask = (1 << B) - 1
    fill &= cm_mask
    if not fill:
        for j in range(n):
            x[off + j] = 0.0
        return 0
    if lowband is None:
        for j in range(n):
            ctx.seed = lcg_rand(ctx.seed)
            x[off + j] = float(_s32(ctx.seed) >> 20)
        cm = cm_mask
    else:
        for j in range(n):
            ctx.seed = lcg_rand(ctx.seed)
            tmp = 1.0 / 256 if ctx.seed & 0x8000 else -1.0 / 256
            x[off + j] = lowband[lb_off + j] + tmp
        cm = fill
    renormalise(x, off, n, gain)
    return cm


def quant_band_n1(ctx: _Band, x: List[float], xoff: int,
                  y: Optional[List[float]], yoff: int,
                  lowband_out: Optional[List[float]], lo_off: int) -> int:
    for arr, o in ((x, xoff), (y, yoff)):
        if arr is None:
            continue
        sign = 0
        if ctx.remaining_bits >= 1 << BITRES:
            sign = ctx.rd.bits(1)
            ctx.remaining_bits -= 1 << BITRES
        arr[o] = -NORM_SCALING if sign else NORM_SCALING
    if lowband_out is not None:
        lowband_out[lo_off] = x[xoff]
    return 1


def quant_band(ctx: _Band, x: List[float], off: int, n: int, b: int, B: int,
               lowband: Optional[List[float]], lb_off: int, LM: int,
               lowband_out: Optional[List[float]], lo_off: int, gain: float,
               scratch: Optional[List[float]], fill: int) -> int:
    n0 = n
    n_b = n
    B0 = B
    time_divide = 0
    recombine = 0
    long_blocks = B0 == 1
    n_b //= B
    if n == 1:
        return quant_band_n1(ctx, x, off, None, 0, lowband_out, lo_off)
    tf_change = ctx.tf_change
    if tf_change > 0:
        recombine = tf_change
    if scratch is not None and lowband is not None and (
            recombine or ((n_b & 1) == 0 and tf_change < 0) or B0 > 1):
        scratch[:n] = lowband[lb_off:lb_off + n]
        lowband, lb_off = scratch, 0
    for k in range(recombine):
        if lowband is not None:
            haar1(lowband, lb_off, n >> k, 1 << k)
        fill = _BIT_INTERLEAVE[fill & 0xF] | _BIT_INTERLEAVE[fill >> 4] << 2
    B >>= recombine
    n_b <<= recombine
    while (n_b & 1) == 0 and tf_change < 0:
        if lowband is not None:
            haar1(lowband, lb_off, n_b, B)
        fill |= fill << B
        B <<= 1
        n_b >>= 1
        time_divide += 1
        tf_change += 1
    B0 = B
    n_b0 = n_b
    if B0 > 1 and lowband is not None:
        deinterleave_hadamard(lowband, lb_off, n_b >> recombine,
                              B0 << recombine, long_blocks)
    cm = quant_partition(ctx, x, off, n, b, B, lowband, lb_off, LM, gain,
                         fill)
    if B0 > 1:
        interleave_hadamard(x, off, n_b >> recombine, B0 << recombine,
                            long_blocks)
    n_b = n_b0
    B = B0
    for k in range(time_divide):
        B >>= 1
        n_b <<= 1
        cm |= cm >> B
        haar1(x, off, n_b, B)
    for k in range(recombine):
        cm = _BIT_DEINTERLEAVE[cm]
        haar1(x, off, n0 >> k, 1 << k)
    B <<= recombine
    if lowband_out is not None:
        nn = math.sqrt(n0)
        for j in range(n0):
            lowband_out[lo_off + j] = nn * x[off + j]
    return cm & ((1 << B) - 1)


def stereo_merge(x: List[float], xo: int, y: List[float], yo: int,
                 mid: float, n: int) -> None:
    xp = 0.0
    side = 0.0
    for j in range(n):
        xp += y[yo + j] * x[xo + j]
        side += y[yo + j] * y[yo + j]
    xp = mid * xp
    mid2 = mid
    el = mid2 * mid2 + side - 2 * xp
    er = mid2 * mid2 + side + 2 * xp
    if er < 6e-4 or el < 6e-4:
        y[yo:yo + n] = x[xo:xo + n]
        return
    lgain = 1.0 / math.sqrt(el)
    rgain = 1.0 / math.sqrt(er)
    for j in range(n):
        l = mid * x[xo + j]
        r = y[yo + j]
        x[xo + j] = lgain * (l - r)
        y[yo + j] = rgain * (l + r)


def quant_band_stereo(ctx: _Band, x: List[float], xo: int, y: List[float],
                      yo: int, n: int, b: int, B: int,
                      lowband: Optional[List[float]], lb_off: int, LM: int,
                      lowband_out: Optional[List[float]], lo_off: int,
                      scratch: Optional[List[float]], fill: int) -> int:
    if n == 1:
        return quant_band_n1(ctx, x, xo, y, yo, lowband_out, lo_off)
    orig_fill = fill
    b, fill, inv, imid, iside, delta, itheta, qalloc = compute_theta(
        ctx, n, b, B, B, LM, 1, fill)
    mid = (1.0 / 32768) * imid
    side = (1.0 / 32768) * iside
    if n == 2:
        mbits = b
        sbits = 0
        if itheta != 0 and itheta != 16384:
            sbits = 1 << BITRES
        mbits -= sbits
        c = itheta > 8192
        ctx.remaining_bits -= qalloc + sbits
        x2, x2o, y2, y2o = (y, yo, x, xo) if c else (x, xo, y, yo)
        sign = 0
        if sbits:
            sign = ctx.rd.bits(1)
        sign = 1 - 2 * sign
        cm = quant_band(ctx, x2, x2o, n, mbits, B, lowband, lb_off, LM,
                        lowband_out, lo_off, 1.0, scratch, orig_fill)
        y2[y2o] = -sign * x2[x2o + 1]
        y2[y2o + 1] = sign * x2[x2o]
        x[xo] = mid * x[xo]
        x[xo + 1] = mid * x[xo + 1]
        y[yo] = side * y[yo]
        y[yo + 1] = side * y[yo + 1]
        tmp = x[xo]
        x[xo] = tmp - y[yo]
        y[yo] = tmp + y[yo]
        tmp = x[xo + 1]
        x[xo + 1] = tmp - y[yo + 1]
        y[yo + 1] = tmp + y[yo + 1]
    else:
        mbits = max(0, min(b, _tdiv(b - delta, 2)))
        sbits = b - mbits
        ctx.remaining_bits -= qalloc
        rebalance = ctx.remaining_bits
        if mbits >= sbits:
            cm = quant_band(ctx, x, xo, n, mbits, B, lowband, lb_off, LM,
                            lowband_out, lo_off, 1.0, scratch, fill)
            rebalance = mbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 0:
                sbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, y, yo, n, sbits, B, None, 0, LM, None, 0,
                             side, None, fill >> B)
        else:
            cm = quant_band(ctx, y, yo, n, sbits, B, None, 0, LM, None, 0,
                            side, None, fill >> B)
            rebalance = sbits - (rebalance - ctx.remaining_bits)
            if rebalance > 3 << BITRES and itheta != 16384:
                mbits += rebalance - (3 << BITRES)
            cm |= quant_band(ctx, x, xo, n, mbits, B, lowband, lb_off, LM,
                             lowband_out, lo_off, 1.0, scratch, fill)
    if n != 2:
        stereo_merge(x, xo, y, yo, mid, n)
    if inv:
        for j in range(n):
            y[yo + j] = -y[yo + j]
    return cm


def quant_all_bands(rd: RangeDecoder, start: int, end: int, X: List[float],
                    Y: Optional[List[float]], pulses: List[int],
                    short_blocks: int, spread: int, dual: int,
                    intensity: int, tf_res: List[int], total_bits: int,
                    balance: int, LM: int, coded: int, seed: int,
                    disable_inv: bool) -> Tuple[List[int], int]:
    M = 1 << LM
    B = M if short_blocks else 1
    C = 2 if Y is not None else 1
    norm_offset = M * EB[start]
    nlen = M * EB[NB - 1] - norm_offset
    norm = [0.0] * nlen
    norm2 = [0.0] * nlen
    # quant_band's copy of the low band (the reference lends it the last
    # band's bins, which are decoded after it and never read before)
    scratch_buf = [0.0] * (M * (EB[NB] - EB[NB - 1]))
    masks = [0] * (C * NB)
    ctx = _Band()
    ctx.rd = rd
    ctx.intensity = intensity
    ctx.spread = spread
    ctx.seed = seed
    ctx.disable_inv = disable_inv
    ctx.avoid_split_noise = B > 1
    lowband_offset = 0
    update_lowband = True
    for i in range(start, end):
        ctx.i = i
        last = i == end - 1
        xo = M * EB[i]
        n = M * EB[i + 1] - M * EB[i]
        tell = rd.tell_frac()
        if i != start:
            balance -= tell
        remaining = total_bits - tell - 1
        ctx.remaining_bits = remaining
        if i <= coded - 1:
            curr_balance = _tdiv(balance, min(3, coded - i))
            b = max(0, min(16383, remaining + 1, pulses[i] + curr_balance))
        else:
            b = 0
        if (M * EB[i] - n >= M * EB[start] or i == start + 1) and (
                update_lowband or lowband_offset == 0):
            lowband_offset = i
        if i == start + 1:
            n1 = M * (EB[start + 1] - EB[start])
            n2 = M * (EB[start + 2] - EB[start + 1])
            norm[n1:n2] = norm[2 * n1 - n2:n1]
            if dual:
                norm2[n1:n2] = norm2[2 * n1 - n2:n1]
        tf_change = tf_res[i]
        ctx.tf_change = tf_change
        scratch = None if last else scratch_buf
        effective_lowband = -1
        if lowband_offset != 0 and (spread != SPREAD_AGGRESSIVE or B > 1
                                    or tf_change < 0):
            effective_lowband = max(0, M * EB[lowband_offset] - norm_offset
                                    - n)
            fold_start = lowband_offset
            while True:
                fold_start -= 1
                if M * EB[fold_start] <= effective_lowband + norm_offset:
                    break
            fold_end = lowband_offset - 1
            while True:
                fold_end += 1
                if not (fold_end < i and M * EB[fold_end]
                        < effective_lowband + norm_offset + n):
                    break
            x_cm = y_cm = 0
            fi = fold_start
            while True:
                x_cm |= masks[fi * C]
                y_cm |= masks[fi * C + C - 1]
                fi += 1
                if fi >= fold_end:
                    break
        else:
            x_cm = y_cm = (1 << B) - 1
        if dual and i == intensity:
            dual = 0
            for j in range(M * EB[i] - norm_offset):
                norm[j] = 0.5 * (norm[j] + norm2[j])
        lb = effective_lowband if effective_lowband != -1 else None
        out_off = M * EB[i] - norm_offset
        if dual:
            x_cm = quant_band(ctx, X, xo, n, b // 2, B,
                              norm if lb is not None else None, lb or 0, LM,
                              None if last else norm, out_off, 1.0,
                              scratch, x_cm)
            y_cm = quant_band(ctx, Y, xo, n, b // 2, B,
                              norm2 if lb is not None else None, lb or 0, LM,
                              None if last else norm2, out_off, 1.0,
                              scratch, y_cm)
        else:
            if Y is not None:
                x_cm = quant_band_stereo(
                    ctx, X, xo, Y, xo, n, b, B,
                    norm if lb is not None else None, lb or 0, LM,
                    None if last else norm, out_off, scratch, x_cm | y_cm)
            else:
                x_cm = quant_band(ctx, X, xo, n, b, B,
                                  norm if lb is not None else None, lb or 0,
                                  LM, None if last else norm, out_off, 1.0,
                                  scratch, x_cm | y_cm)
            y_cm = x_cm
        masks[i * C] = x_cm & 0xFF
        masks[i * C + C - 1] = y_cm & 0xFF
        balance += pulses[i] + tell
        update_lowband = b > (n << BITRES)
        ctx.avoid_split_noise = False
    return masks, ctx.seed


# -- the frame ---------------------------------------------------------------

LN2 = 0.6931471805599453094
SQRT2 = float(np.float32(1.41421356))
BG_INCREASE = float(np.float32(0.001))


def exp2(x: float) -> float:
    return math.exp(LN2 * x)


def anti_collapse(xs: List[List[float]], masks: List[int], LM: int, C: int,
                  start: int, end: int, old: List[float], log1: List[float],
                  log2: List[float], pulses: List[int], seed: int) -> None:
    for i in range(start, end):
        n0 = EB[i + 1] - EB[i]
        depth = ((1 + pulses[i]) // n0) >> LM
        thresh = 0.5 * exp2(-0.125 * depth)
        sqrt_1 = 1.0 / math.sqrt(n0 << LM)
        for c in range(C):
            prev1 = log1[c * NB + i]
            prev2 = log2[c * NB + i]
            if C == 1:
                prev1 = max(prev1, log1[NB + i])
                prev2 = max(prev2, log2[NB + i])
            ediff = max(0.0, old[c * NB + i] - min(prev1, prev2))
            r = 2.0 * exp2(-ediff)
            if LM == 3:
                r *= SQRT2
            r = min(thresh, r)
            r = r * sqrt_1
            x = xs[c]
            off = EB[i] << LM
            renorm = False
            for k in range(1 << LM):
                if not masks[i * C + c] & (1 << k):
                    for j in range(n0):
                        seed = lcg_rand(seed)
                        x[off + (j << LM) + k] = r if seed & 0x8000 else -r
                    renorm = True
            if renorm:
                renormalise(x, off, n0 << LM, 1.0)


def denormalise(x: List[float], old: List[float], c: int, start: int,
                end: int, M: int, n: int, silence: int) -> np.ndarray:
    freq = np.zeros(n)
    if silence:
        return freq
    for i in range(start, end):
        g = exp2(min(32.0, old[c * NB + i] + T.E_MEANS[i]))
        a, b = M * EB[i], M * EB[i + 1]
        freq[a:b] = [v * g for v in x[a:b]]
    return freq


@dataclass
class Spectrum:
    """What ``frame_spectrum`` hands the synthesis: the MDCT coefficients
    of each coded channel, the block count, and the post-filter's new
    period, gain and tapset."""
    freq: np.ndarray      # [C, N]
    transient: int
    pitch: int
    gain: float
    tapset: int


def frame_spectrum(rd: RangeDecoder, st: CeltState, n: int) -> Spectrum:
    """The plain version of ``celt_frame``: one frame's symbols from
    ``rd`` (its storage is the frame's length) into MDCT coefficients;
    updates ``st``'s energies and seed."""
    LM = {120: 0, 240: 1, 480: 2, 960: 3}[n]
    M = 1 << LM
    C = st.stream_channels
    start, end = st.start, st.end
    eff_end = min(end, NB)
    old, log1, log2, bg = (list(map(float, row)) for row in st.energy)
    if C == 1:
        for i in range(NB):
            old[i] = max(old[i], old[NB + i])
    length = rd.storage
    total_bits = length * 8
    tell = rd.tell()
    if tell >= total_bits:
        silence = 1
    elif tell == 1:
        silence = rd.bit_logp(15)
    else:
        silence = 0
    if silence:
        tell = length * 8
        rd.nbits_total += tell - rd.tell()
    pf_gain = 0.0
    pf_pitch = 0
    pf_tapset = 0
    if start == 0 and tell + 16 <= total_bits:
        if rd.bit_logp(1):
            octave = rd.uint(6)
            pf_pitch = (16 << octave) + rd.bits(4 + octave) - 1
            qg = rd.bits(3)
            if rd.tell() + 2 <= total_bits:
                pf_tapset = rd.icdf(T.TAPSET_ICDF, 2)
            pf_gain = 0.09375 * (qg + 1)
        tell = rd.tell()
    transient = 0
    if LM > 0 and tell + 3 <= total_bits:
        transient = rd.bit_logp(3)
        tell = rd.tell()
    short_blocks = M if transient else 0
    intra = rd.bit_logp(3) if tell + 3 <= total_bits else 0
    unquant_coarse_energy(rd, old, start, end, intra, C, LM)
    tf_res = tf_decode(rd, start, end, transient, LM)
    tell = rd.tell()
    spread = SPREAD_NORMAL
    if tell + 4 <= total_bits:
        spread = rd.icdf(T.SPREAD_ICDF, 5)
    cap = init_caps(LM, C)
    offsets = [0] * NB
    dynalloc_logp = 6
    total_bits <<= BITRES
    tell = rd.tell_frac()
    for i in range(start, end):
        width = (C * (EB[i + 1] - EB[i])) << LM
        quanta = min(width << BITRES, max(6 << BITRES, width))
        loop_logp = dynalloc_logp
        boost = 0
        while tell + (loop_logp << BITRES) < total_bits and boost < cap[i]:
            flag = rd.bit_logp(loop_logp)
            tell = rd.tell_frac()
            if not flag:
                break
            boost += quanta
            total_bits -= quanta
            loop_logp = 1
        offsets[i] = boost
        if boost > 0:
            dynalloc_logp = max(2, dynalloc_logp - 1)
    trim = rd.icdf(T.TRIM_ICDF, 7) \
        if tell + (6 << BITRES) <= total_bits else 5
    bits = ((length * 8) << BITRES) - rd.tell_frac() - 1
    ac_rsv = 1 << BITRES if (transient and LM >= 2
                             and bits >= (LM + 2) << BITRES) else 0
    bits -= ac_rsv
    coded, pulses, fine, prio, balance, intensity, dual = compute_allocation(
        rd, start, end, offsets, cap, trim, bits, C, LM)
    unquant_fine_energy(rd, old, start, end, fine, C)
    xs = [[0.0] * n for _ in range(C)]
    masks, seed = quant_all_bands(
        rd, start, end, xs[0], xs[1] if C == 2 else None, pulses,
        short_blocks, spread, dual, intensity, tf_res,
        length * (8 << BITRES) - ac_rsv, balance, LM, coded, st.rng,
        st.disable_inv)
    ac_on = rd.bits(1) if ac_rsv > 0 else 0
    unquant_energy_finalise(rd, old, start, end, fine, prio,
                            length * 8 - rd.tell(), C)
    if ac_on:
        anti_collapse(xs, masks, LM, C, start, end, old, log1, log2, pulses,
                      seed)
    if silence:
        for i in range(C * NB):
            old[i] = -28.0
    freq = np.stack([denormalise(xs[c], old, c, start, eff_end, M, n,
                                 silence) for c in range(C)])
    if C == 1:
        old[NB:] = old[:NB]
    if not transient:
        log2 = list(log1)
        log1 = list(old)
        inc = M * BG_INCREASE if st.loss_count < 10 else 1.0
        bg = [min(b + inc, o) for b, o in zip(bg, old)]
    else:
        log1 = [min(a, o) for a, o in zip(log1, old)]
    for c in range(2):
        for i in list(range(start)) + list(range(end, NB)):
            old[c * NB + i] = 0.0
            log1[c * NB + i] = log2[c * NB + i] = -28.0
    st.energy[:] = (old, log1, log2, bg)
    st.rng = rd.rng
    return Spectrum(freq, transient, pf_pitch, pf_gain, pf_tapset)


# -- synthesis ----------------------------------------------------------------

N4_SIZES = (60, 120, 240, 480)  # the complex FFT sizes of the four MDCTs


def fft_radices(n: int) -> Tuple[int, ...]:
    """n's radices, 2s first, then 3 and 5 (n = 2^a 3 5 here)."""
    out = []
    for r in (2, 3, 5):
        while n % r == 0:
            out.append(r)
            n //= r
    if n != 1:
        raise ValueError("an FFT size other than 2^a 3^b 5^c")
    return tuple(out)


@lru_cache(maxsize=None)
def fft_plan(n: int):
    """Each stage of the n-point Stockham FFT: (radix R, the stage's
    sub-transform length Ns, the twiddles' cosines and sines [R, n / R])."""
    stages = []
    ns = 1
    for r in fft_radices(n):
        k = np.arange(n // r) % ns
        ang = -2 * np.pi * np.outer(np.arange(r), k) / (ns * r)
        stages.append((r, ns, np.cos(ang), np.sin(ang)))
        ns *= r
    return stages


DFT_W = {r: (np.cos(-2 * np.pi * np.arange(r) / r),
             np.sin(-2 * np.pi * np.arange(r) / r)) for r in (3, 5)}


def fft(re: np.ndarray, im: np.ndarray):
    """The forward, unscaled DFT over the last axis (self-sorting Stockham,
    radices 2, 3 and 5): the C++ helper's ``opus_fft`` computes it with the
    same operations in the same order, so the two agree bit for bit."""
    n = re.shape[-1]
    for r, ns, twr, twi in fft_plan(n):
        m = n // r
        j = np.arange(m)
        vr = [re[..., q * m:(q + 1) * m] for q in range(r)]
        vi = [im[..., q * m:(q + 1) * m] for q in range(r)]
        for q in range(1, r):
            a, b = vr[q], vi[q]
            vr[q] = a * twr[q] - b * twi[q]
            vi[q] = a * twi[q] + b * twr[q]
        if r == 2:
            outr = (vr[0] + vr[1], vr[0] - vr[1])
            outi = (vi[0] + vi[1], vi[0] - vi[1])
        else:
            cr, ci = DFT_W[r]
            outr, outi = [], []
            for q in range(r):
                ar, ai = vr[0], vi[0]
                for t in range(1, r):
                    w = (t * q) % r
                    ar = ar + (vr[t] * cr[w] - vi[t] * ci[w])
                    ai = ai + (vr[t] * ci[w] + vi[t] * cr[w])
                outr.append(ar)
                outi.append(ai)
        at = (j // ns) * ns * r + (j % ns)
        yr = np.empty_like(re)
        yi = np.empty_like(im)
        for q in range(r):
            yr[..., at + q * ns] = outr[q]
            yi[..., at + q * ns] = outi[q]
        re, im = yr, yi
    return re, im


_TRIG = {n: T.mdct_trig(n) for n in (240, 480, 960, 1920)}


def synth_blob() -> np.ndarray:
    """float64: the tables the C++ synthesis reads, in its order: the DFT
    constants of radix 3 and 5 (cosines, sines), the window, and for each
    FFT size of ``N4_SIZES`` the MDCT's rotation and each stage's twiddles
    (cosines, sines)."""
    parts = [DFT_W[3][0], DFT_W[3][1], DFT_W[5][0], DFT_W[5][1], T.WINDOW]
    for n4 in N4_SIZES:
        parts.append(_TRIG[4 * n4])
        for _, _, twr, twi in fft_plan(n4):
            parts += [twr.reshape(-1), twi.reshape(-1)]
    return np.ascontiguousarray(np.concatenate(parts))


def imdct_fold(coef: np.ndarray) -> np.ndarray:
    """[..., N2] MDCT coefficients -> [..., N2] folded outputs: the
    reference's pre-rotation, N2 / 2-point complex FFT and post-rotation
    (``clt_mdct_backward`` before its window)."""
    n2 = coef.shape[-1]
    n4 = n2 // 2
    t = _TRIG[2 * n2]
    x1 = coef[..., 0::2]
    x2 = coef[..., ::-1][..., 0::2]
    ta, tb = t[:n4], t[n4:n2]
    zr, zi = fft(x1 * ta - x2 * tb, x2 * ta + x1 * tb)
    out = np.empty(coef.shape)
    out[..., 0::2] = zi * ta + zr * tb
    out[..., ::-1][..., 0::2] = zi * tb - zr * ta
    return out


def synthesize(freq: np.ndarray, tail: np.ndarray, transient: int
               ) -> np.ndarray:
    """The plain version of ``celt_frame``'s synthesis: one channel's MDCT
    coefficients [N] and the last frame's folded tail [60] -> [N + 60]:
    N samples and the next tail."""
    n = len(freq)
    B = n // 120 if transient else 1
    nb = n // B
    folded = imdct_fold(freq.reshape(nb, B).T)  # [B, nb]
    out = np.empty(n + 60)
    out[:60] = tail
    w = T.WINDOW
    wr = w[::-1]
    for b in range(B):
        base = nb * b
        out[base + 60:base + 60 + nb] = folded[b]
        seg = out[base:base + 120]
        x2 = seg[:60].copy()
        x1 = seg[::-1][:60].copy()
        seg[:60] = wr[:60] * x2 - w[:60] * x1
        seg[::-1][:60] = w[:60] * x2 + wr[:60] * x1
    return out


# -- post-filter and de-emphasis ----------------------------------------------

COMB_MINPERIOD = 15


def comb_filter(x: np.ndarray, at: int, t0: int, t1: int, n: int, g0: float,
                g1: float, tap0: int, tap1: int) -> None:
    """The pitch post-filter on x[at:at + n], in place (an IIR comb: it
    reads its own output T samples back)."""
    if g0 == 0 and g1 == 0:
        return
    t0 = max(t0, COMB_MINPERIOD)
    t1 = max(t1, COMB_MINPERIOD)
    ga, gb = T.COMB_GAINS[tap0], T.COMB_GAINS[tap1]
    g00, g01, g02 = g0 * ga[0], g0 * ga[1], g0 * ga[2]
    g10, g11, g12 = g1 * gb[0], g1 * gb[1], g1 * gb[2]
    overlap = 120
    if g0 == g1 and t0 == t1 and tap0 == tap1:
        overlap = 0
    w = T.WINDOW
    i = 0
    while i < overlap:
        f = w[i] * w[i]
        p = at + i
        x[p] = x[p] + ((1.0 - f) * g00) * x[p - t0] \
            + ((1.0 - f) * g01) * (x[p - t0 + 1] + x[p - t0 - 1]) \
            + ((1.0 - f) * g02) * (x[p - t0 + 2] + x[p - t0 - 2]) \
            + (f * g10) * x[p - t1] \
            + (f * g11) * (x[p - t1 + 1] + x[p - t1 - 1]) \
            + (f * g12) * (x[p - t1 + 2] + x[p - t1 - 2])
        i += 1
    if g1 == 0:
        return
    while i < n:
        p = at + i
        x[p] = x[p] + g10 * x[p - t1] + g11 * (x[p - t1 + 1] + x[p - t1 - 1]) \
            + g12 * (x[p - t1 + 2] + x[p - t1 - 2])
        i += 1


def postfilter_deemphasis(st: CeltState, out: np.ndarray, spec: Spectrum,
                          n: int) -> np.ndarray:
    """The plain version of ``celt_frame``'s last step: [CC, N] synthesized
    samples -> [N, CC] output in [-1, 1] (before the Opus layer's gain);
    updates the post-filter's and the de-emphasis filter's state and the
    history the comb reads."""
    pf = st.postfilter
    LM = {120: 0, 240: 1, 480: 2, 960: 3}[n]
    h = DECODE_HISTORY
    pcm = np.empty((n, st.channels))
    pf[0] = max(pf[0], COMB_MINPERIOD)
    pf[3] = max(pf[3], COMB_MINPERIOD)
    for c in range(st.channels):
        buf = np.concatenate([st.history[c, :h], out[c]]).tolist()
        comb_filter(buf, h, int(pf[3]), int(pf[0]), 120, pf[4], pf[1],
                    int(pf[5]), int(pf[2]))
        if LM != 0:
            comb_filter(buf, h + 120, int(pf[0]), spec.pitch, n - 120, pf[1],
                        spec.gain, int(pf[2]), spec.tapset)
        st.history[c, :h] = buf[-h:]
        m = st.preemph[c]
        col = pcm[:, c]
        for j in range(n):
            tmp = buf[h + j] + VERY_SMALL + m
            m = T.PREEMPH * tmp
            col[j] = tmp * (1.0 / 32768)
        st.preemph[c] = m
    pf[3:6] = pf[0:3]
    pf[0:3] = (spec.pitch, spec.gain, spec.tapset)
    if LM != 0:
        pf[3:6] = pf[0:3]
    return pcm


def decode_frame(st: CeltState, rd: RangeDecoder, n: int,
                 lib=None) -> np.ndarray:
    """One CELT frame of ``n`` samples (120-960) from ``rd`` -> float64
    [n, channels] in [-1, 1]. ``lib`` is the C++ helper (``celt_frame``
    runs all three steps in one call), or None for the plain versions."""
    if rd.storage <= 1:
        raise CeltError("a CELT frame of one byte (packet loss "
                        "concealment) is not supported")
    st.skip_plc = st.loss_count != 0
    if lib is not None:
        from .native import celt_decode
        pcm = celt_decode(lib, rd, st, n)
        st.loss_count = 0
        return pcm
    spec = frame_spectrum(rd, st, n)
    st.loss_count = 0
    C, CC = st.stream_channels, st.channels
    freq = spec.freq
    if CC == 2 and C == 1:
        freq = np.concatenate([freq, freq])
    elif CC == 1 and C == 2:
        freq = (0.5 * freq[0] + 0.5 * freq[1])[None]
    out = np.empty((CC, n))
    for c in range(CC):
        y = synthesize(freq[c], st.history[c, DECODE_HISTORY:], spec.transient)
        out[c] = y[:n]
        st.history[c, DECODE_HISTORY:] = y[n:]
    return postfilter_deemphasis(st, out, spec, n)


def _lpc(ac: np.ndarray, p: int) -> np.ndarray:
    """_celt_lpc: Levinson-Durbin, stopped at 30 dB of prediction gain."""
    lpc = [0.0] * p
    error = ac[0]
    if ac[0] != 0:
        for i in range(p):
            rr = 0.0
            for j in range(i):
                rr += lpc[j] * ac[i - j]
            rr += ac[i + 1]
            r = -rr / error
            lpc[i] = r
            for j in range((i + 1) >> 1):
                t1, t2 = lpc[j], lpc[i - 1 - j]
                lpc[j] = t1 + r * t2
                lpc[i - 1 - j] = t2 + r * t1
            error = error - r * r * error
            if error < 0.001 * ac[0]:
                break
    return np.asarray(lpc)


def _autocorr(x: np.ndarray, lag: int) -> np.ndarray:
    n = len(x)
    return np.asarray([float(np.dot(x[:n - k], x[k:]))
                       for k in range(lag + 1)])


def _best_pitch(xcorr: np.ndarray, y: np.ndarray, length: int,
                max_pitch: int):
    """find_best_pitch: the two lags of highest normalized correlation."""
    syy = 1.0 + float(np.dot(y[:length], y[:length]))
    best_num = [-1.0, -1.0]
    best_den = [0.0, 0.0]
    best = [0, 1]
    for i in range(max_pitch):
        if xcorr[i] > 0:
            x16 = xcorr[i] * 1e-12
            num = x16 * x16
            if num * best_den[1] > best_num[1] * syy:
                if num * best_den[0] > best_num[0] * syy:
                    best_num[1], best_den[1], best[1] = \
                        best_num[0], best_den[0], best[0]
                    best_num[0], best_den[0], best[0] = num, syy, i
                else:
                    best_num[1], best_den[1], best[1] = num, syy, i
        syy += y[i + length] * y[i + length] - y[i] * y[i]
        syy = max(1.0, syy)
    return best


def plc_pitch_search(hist: np.ndarray) -> int:
    """celt_plc_pitch_search over the decoder's memory [channels, 2048]."""
    n = hist.shape[1] // 2
    x_lp = np.empty(n)
    for c in range(hist.shape[0]):
        x = hist[c]
        lp = np.empty(n)
        lp[1:] = 0.5 * (0.5 * (x[1:2 * n - 1:2] + x[3:2 * n:2]) + x[2::2])
        lp[0] = 0.5 * (0.5 * x[1] + x[0])
        x_lp = lp if c == 0 else x_lp + lp
    ac = _autocorr(x_lp, 4)
    ac[0] *= 1.0001
    for i in range(1, 5):
        ac[i] -= ac[i] * (0.008 * i) * (0.008 * i)
    lpc = _lpc(ac, 4)
    tmp = 1.0
    for i in range(4):
        tmp = 0.9 * tmp
        lpc[i] = lpc[i] * tmp
    num = (lpc[0] + 0.8, lpc[1] + 0.8 * lpc[0], lpc[2] + 0.8 * lpc[1],
           lpc[3] + 0.8 * lpc[2], 0.8 * lpc[3])
    y = x_lp.copy()
    for i in range(n):
        acc = x_lp[i]
        for k in range(5):
            if i - 1 - k >= 0:
                acc += num[k] * x_lp[i - 1 - k]
        y[i] = acc
    length = 2 * n - PLC_PITCH_LAG_MAX
    max_pitch = PLC_PITCH_LAG_MAX - PLC_PITCH_LAG_MIN
    x = y[PLC_PITCH_LAG_MAX >> 1:]
    x4 = x[:(length >> 2) * 2:2]
    y4 = y[:((length + max_pitch) >> 2) * 2:2]
    xcorr = np.asarray([float(np.dot(x4, y4[i:i + len(x4)]))
                        for i in range(max_pitch >> 2)])
    best = _best_pitch(xcorr, y4, length >> 2, max_pitch >> 2)
    xcorr = np.zeros(max_pitch >> 1)
    half = length >> 1
    for i in range(max_pitch >> 1):
        if abs(i - 2 * best[0]) > 2 and abs(i - 2 * best[1]) > 2:
            continue
        xcorr[i] = max(-1.0, float(np.dot(x[:half], y[i:i + half])))
    best = _best_pitch(xcorr, y, half, max_pitch >> 1)
    offset = 0
    if 0 < best[0] < (max_pitch >> 1) - 1:
        a, b, c = xcorr[best[0] - 1], xcorr[best[0]], xcorr[best[0] + 1]
        if (c - a) > 0.7 * (b - a):
            offset = 1
        elif (a - c) > 0.7 * (b - c):
            offset = -1
    return PLC_PITCH_LAG_MAX - (2 * best[0] - offset)


def _iir(x: np.ndarray, den: np.ndarray, mem: List[float]) -> np.ndarray:
    """celt_iir: y[i] = x[i] - sum_k den[k] y[i - 1 - k], mem[0] = y[-1]."""
    order = len(den)
    past = list(reversed(mem)) + [0.0] * len(x)
    d = den.tolist()
    for i in range(len(x)):
        acc = float(x[i])
        at = order + i
        for k in range(order):
            acc -= d[k] * past[at - 1 - k]
        past[at] = acc
    return np.asarray(past[order:])


def decode_lost(st: CeltState, n: int) -> np.ndarray:
    """celt_decode_lost: ``n`` samples of concealment -> float64 [n,
    channels]. Noise-based after 5 losses, off band 0 (hybrid) or after a
    reset: the band energies decay towards the background and the bands are
    filled from the folding LCG and synthesized. Otherwise pitch-based: the
    LPC excitation of the last two pitch periods is repeated, decaying, and
    filtered back, then folded for the next frame's overlap. Neither runs
    the post-filter. One version serves both paths: it runs only for empty
    (DTX) packets and 5 ms at a mode switch with no redundancy frame."""
    LM = {120: 0, 240: 1, 480: 2, 960: 3}[n]
    M = 1 << LM
    CC = st.channels
    h = DECODE_HISTORY
    out = np.empty((CC, n))
    if st.loss_count >= 5 or st.start != 0 or st.skip_plc:
        start, end = st.start, st.end
        eff_end = max(start, min(end, NB))
        old = st.energy[0]
        bg = st.energy[3]
        decay = 1.5 if st.loss_count == 0 else 0.5
        for c in range(CC):
            for i in range(start, end):
                k = c * NB + i
                old[k] = max(bg[k], old[k] - decay)
        seed = st.rng
        for c in range(CC):
            x = [0.0] * n
            for i in range(start, eff_end):
                off = EB[i] << LM
                blen = (EB[i + 1] - EB[i]) << LM
                for j in range(blen):
                    seed = lcg_rand(seed)
                    x[off + j] = float(_s32(seed) >> 20)
                renormalise(x, off, blen, 1.0)
            freq = denormalise(x, list(old), c, start, eff_end, M, n, 0)
            y = synthesize(freq, st.history[c, h:], 0)
            out[c] = y[:n]
            st.history[c, h:] = y[n:]
            st.history[c, :h] = np.concatenate([st.history[c, n:h], y[:n]])
        st.rng = seed
    else:
        fade = 1.0
        if st.loss_count == 0:
            st.last_pitch_index = plc_pitch_search(st.history[:, :h])
        else:
            fade = F32_08
        pitch = st.last_pitch_index
        exc_length = min(2 * pitch, MAX_PERIOD)
        w = T.WINDOW
        pf = st.postfilter
        for c in range(CC):
            buf = np.concatenate([st.history[c, :h], np.zeros(120)])
            exc = buf[h - MAX_PERIOD - LPC_ORDER:h].copy()  # exc[-24:1024]
            if st.loss_count == 0:
                xx = exc[LPC_ORDER:].copy()
                xx[:120] = xx[:120] * w
                xx[-120:][::-1] = xx[-120:][::-1] * w
                ac = _autocorr(xx, LPC_ORDER)
                ac[0] *= F32_10001
                for i in range(1, LPC_ORDER + 1):
                    ac[i] -= ac[i] * LAG_WINDOW * i * i
                st.lpc[c] = _lpc(ac, LPC_ORDER)
            lpc = st.lpc[c]
            a = LPC_ORDER + MAX_PERIOD - exc_length
            fir = exc[a:a + exc_length].copy()
            for i in range(exc_length):
                acc = exc[a + i]
                for k in range(LPC_ORDER):
                    acc += lpc[k] * exc[a + i - 1 - k]
                fir[i] = acc
            exc[a:a + exc_length] = fir
            e = exc[LPC_ORDER:]
            dl = exc_length >> 1
            e1 = 1.0 + float(np.sum(e[MAX_PERIOD - dl:] ** 2))
            e2 = 1.0 + float(np.sum(e[MAX_PERIOD - 2 * dl:MAX_PERIOD - dl]
                                    ** 2))
            e1 = min(e1, e2)
            decay = math.sqrt(e1 / e2)
            buf[:h - n] = buf[n:h].copy()
            offset = MAX_PERIOD - pitch
            length = n + 120
            att = fade * decay
            s1 = 0.0
            j = 0
            for i in range(length):
                if j >= pitch:
                    j -= pitch
                    att = att * decay
                buf[h - n + i] = att * e[offset + j]
                tmp = buf[h - MAX_PERIOD - n + offset + j]
                s1 += tmp * tmp
                j += 1
            mem = [buf[h - n - 1 - i] for i in range(LPC_ORDER)]
            buf[h - n:h - n + length] = _iir(buf[h - n:h - n + length], lpc,
                                            mem)
            seg = buf[h - n:h - n + length]
            s2 = float(np.sum(seg * seg))
            if not s1 > F32_02 * s2:
                seg[:] = 0.0
            elif s1 < s2:
                ratio = math.sqrt((s1 + 1) / (s2 + 1))
                seg[:120] = (1.0 - w * (1.0 - ratio)) * seg[:120]
                seg[120:] = ratio * seg[120:]
            etmp = buf[h:h + 120].copy()
            comb_filter_into(etmp, buf, h, int(pf[0]), -pf[1], int(pf[2]))
            for i in range(60):
                buf[h + i] = w[i] * etmp[119 - i] + w[119 - i] * etmp[i]
            out[c] = buf[h - n:h]
            st.history[c, :h] = buf[:h]
            st.history[c, h:] = buf[h:h + 60]
    pcm = np.empty((n, CC))
    for c in range(CC):
        m = st.preemph[c]
        for j in range(n):
            tmp = float(out[c, j]) + VERY_SMALL + m
            m = T.PREEMPH * tmp
            pcm[j, c] = tmp * (1.0 / 32768)
        st.preemph[c] = m
    st.loss_count += 1
    return pcm


F32_02 = float(np.float32(0.2))
F32_08 = float(np.float32(0.8))
F32_10001 = float(np.float32(1.0001))
LAG_WINDOW = float(np.float32(np.float32(0.008) * np.float32(0.008)))


def comb_filter_into(y: np.ndarray, x: np.ndarray, at: int, t: int,
                     g: float, tap: int) -> None:
    """The constant comb filter from x[at:] into y (not in place): the
    pre-filter a pitch concealment applies to its overlap."""
    if g == 0:
        y[:] = x[at:at + len(y)]
        return
    t = max(t, COMB_MINPERIOD)
    ga = T.COMB_GAINS[tap]
    g0, g1, g2 = g * ga[0], g * ga[1], g * ga[2]
    for i in range(len(y)):
        p = at + i
        y[i] = x[p] + g0 * x[p - t] + g1 * (x[p - t + 1] + x[p - t - 1]) \
            + g2 * (x[p - t + 2] + x[p - t - 2])
