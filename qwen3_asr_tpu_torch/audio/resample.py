"""Polyphase FIR resampling on the host (numpy).

Counterpart of ``qwen3_asr_tpu/audio/resample.py`` (``resample``,
``StreamingResampler``) and the vectorized path of
``audio/native.resample_poly``: a Kaiser-windowed sinc low-pass evaluated
as a true polyphase filter, O(n_out · taps/up), never materializing the
zero-stuffed signal.
"""
from __future__ import annotations

from math import gcd

import numpy as np


def _kaiser_lowpass(up: int, down: int, ntaps_per_phase: int = 10,
                    beta: float = 5.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass, scipy.resample_poly-compatible defaults."""
    max_rate = max(up, down)
    f_c = 1.0 / max_rate           # normalized cutoff (Nyquist of lower rate)
    half_len = ntaps_per_phase * max_rate
    n = np.arange(-half_len, half_len + 1)
    h = f_c * np.sinc(f_c * n)
    h *= np.kaiser(2 * half_len + 1, beta)
    h /= np.sum(h)  # firwin-style: unity gain at DC
    h *= up
    return h.astype(np.float32)


def resample_poly(x: np.ndarray, up: int, down: int,
                  h: np.ndarray) -> np.ndarray:
    """Upsample by ``up``, filter with ``h``, downsample by ``down``. Output
    is computed in blocks so the [block, taps] temporaries stay small."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    h = np.ascontiguousarray(h, dtype=np.float32)
    n_out = int(np.ceil(len(x) * up / down))
    pad = (len(h) - 1) // 2
    taps_pp = -(-len(h) // up)
    out = np.empty(n_out, np.float32)
    block = max(1, (1 << 22) // max(taps_pp, 1))  # ~4M temp elements
    j = np.arange(taps_pp, dtype=np.int64) * up
    for lo in range(0, n_out, block):
        hi = min(lo + block, n_out)
        p = np.arange(lo, hi, dtype=np.int64) * down - pad
        k = ((-p) % up)[:, None] + j
        src = (p[:, None] + k) // up
        valid = (k < len(h)) & (src >= 0) & (src < len(x))
        prod = np.where(valid,
                        x[np.clip(src, 0, len(x) - 1)]
                        * h[np.minimum(k, len(h) - 1)], np.float32(0))
        out[lo:hi] = prod.sum(axis=1)
    return out


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Resample float32 audio between sample rates with a polyphase FIR."""
    if orig_sr == target_sr:
        return np.asarray(audio, dtype=np.float32)
    g = gcd(orig_sr, target_sr)
    up, down = target_sr // g, orig_sr // g
    return resample_poly(np.asarray(audio, dtype=np.float32), up, down,
                         _kaiser_lowpass(up, down))


class StreamingResampler:
    """Stateful integer-factor upsampler for a stream of frames (a WS
    client at 8 kHz). It keeps enough input history across calls that
    every output sample is computed from real neighbouring samples, as
    resampling the whole stream at once would, with no seam at a message
    boundary. Takes target_sr = L × orig_sr."""

    def __init__(self, orig_sr: int, target_sr: int):
        if target_sr % orig_sr:
            raise ValueError(f"integer upsampling factors only, got "
                             f"{orig_sr} -> {target_sr}")
        self.up = target_sr // orig_sr
        self.h = _kaiser_lowpass(self.up, 1)
        self.pad = (len(self.h) - 1) // 2           # high-rate group delay
        # history so consecutive exact regions overlap (K >= 2P/L)
        self.keep = 2 * (-(-self.pad // self.up))
        self._tail = np.zeros(0, np.float32)
        self._in_count = 0                           # inputs consumed
        self._out_emitted = 0                        # outputs emitted
        self._byte_carry = b""                       # odd-length PCM frames

    def process(self, samples: np.ndarray) -> np.ndarray:
        """Feed a block of float32 samples; returns the finalized output."""
        samples = np.asarray(samples, dtype=np.float32)
        if len(samples) == 0:
            return np.zeros(0, np.float32)
        x = np.concatenate([self._tail, samples])
        g0 = (self._in_count - len(self._tail)) * self.up
        out_full = resample_poly(x, self.up, 1, self.h)
        exact_end = len(x) * self.up - self.pad      # outputs final so far
        lo = self._out_emitted - g0
        out = out_full[max(lo, 0):max(exact_end, 0)]
        self._out_emitted = max(self._out_emitted, g0 + exact_end)
        self._in_count += len(samples)
        self._tail = x[-self.keep:] if len(x) >= self.keep else x
        return out

    def process_pcm(self, pcm_bytes: bytes) -> bytes:
        """s16le bytes in, s16le bytes out; a frame of odd length carries
        its dangling byte into the next."""
        data = self._byte_carry + pcm_bytes
        usable = len(data) - (len(data) % 2)
        self._byte_carry = data[usable:]
        samples = np.frombuffer(data[:usable], dtype=np.int16).astype(
            np.float32)
        out = self.process(samples)
        return np.clip(out, -32768, 32767).astype(np.int16).tobytes()
