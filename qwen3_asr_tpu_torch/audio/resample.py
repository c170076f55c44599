"""Polyphase FIR resampling on the host (numpy).

Counterpart of ``qwen3_asr_tpu/audio/resample.py`` ``resample`` and the
vectorized path of ``audio/native.resample_poly``: a Kaiser-windowed sinc
low-pass evaluated as a true polyphase filter, O(n_out · taps/up), never
materializing the zero-stuffed signal.
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
