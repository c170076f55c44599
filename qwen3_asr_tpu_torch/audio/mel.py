"""Mel filterbank construction (numpy, done once at model build).

Slaney-scale, slaney-normalized triangular filters — the exact semantics of
HuggingFace's ``mel_filter_bank(..., norm="slaney", mel_scale="slaney")``
used by the Whisper/Qwen audio feature extractors. Verified against
``transformers.WhisperFeatureExtractor`` in tests/test_audio_frontend.py.
"""
from __future__ import annotations

import numpy as np


def hertz_to_mel_slaney(freq):
    freq = np.asarray(freq, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = 27.0 / np.log(6.4)
    mels = 3.0 * freq / 200.0
    safe = np.maximum(freq, 1e-10)  # avoid log(0) for the DC bin
    return np.where(freq >= min_log_hertz,
                    min_log_mel + np.log(safe / min_log_hertz) * logstep,
                    mels)


def mel_to_hertz_slaney(mels):
    mels = np.asarray(mels, dtype=np.float64)
    min_log_hertz = 1000.0
    min_log_mel = 15.0
    logstep = np.log(6.4) / 27.0
    freq = 200.0 * mels / 3.0
    return np.where(mels >= min_log_mel,
                    min_log_hertz * np.exp(logstep * (mels - min_log_mel)),
                    freq)


def mel_filter_bank(num_frequency_bins: int, num_mel_filters: int,
                    min_frequency: float, max_frequency: float,
                    sampling_rate: int) -> np.ndarray:
    """Triangular mel filterbank [num_frequency_bins, num_mel_filters]."""
    fft_freqs = np.linspace(0.0, sampling_rate / 2.0, num_frequency_bins)
    mel_min = hertz_to_mel_slaney(min_frequency)
    mel_max = hertz_to_mel_slaney(max_frequency)
    mel_pts = np.linspace(mel_min, mel_max, num_mel_filters + 2)
    filter_freqs = mel_to_hertz_slaney(mel_pts)

    filter_diff = np.diff(filter_freqs)
    slopes = np.expand_dims(filter_freqs, 0) - np.expand_dims(fft_freqs, 1)
    down_slopes = -slopes[:, :-2] / filter_diff[:-1]
    up_slopes = slopes[:, 2:] / filter_diff[1:]
    fb = np.maximum(np.zeros(1), np.minimum(down_slopes, up_slopes))

    # Slaney normalization: equal energy per channel
    enorm = 2.0 / (filter_freqs[2:num_mel_filters + 2] - filter_freqs[:num_mel_filters])
    fb *= np.expand_dims(enorm, 0)
    return fb.astype(np.float32)
