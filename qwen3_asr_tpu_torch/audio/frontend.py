"""Audio frontend in PyTorch: PCM → STFT → Whisper-style log-mel, and the
host DSP of a WS tick (s16 → f32, the telephony bandpass).

Counterpart of ``qwen3_asr_tpu/audio/frontend.py`` (``hann_window``,
``fir_bandpass_kernel``, ``_log_mel_impl``) and of the numpy paths of
``audio/native.py`` (``pcm16_to_f32``, ``fir_same``). Log-mel: n_fft=400, hop=160, periodic Hann, slaney mel, log10,
the max-8 clamp with its max taken over ``max_frames``, (x+4)/4, and padded
frames forced to the floor value.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from .mel import mel_filter_bank

N_FFT = 400
HOP_LENGTH = 160
SAMPLE_RATE = 16000


def hann_window(n: int = N_FFT) -> np.ndarray:
    """Periodic Hann window (matches torch.hann_window / np.hanning(n+1)[:-1])."""
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(np.float32)


def fir_bandpass_kernel(low_hz: float = 300.0, high_hz: float = 3400.0,
                        sr: int = 16000, numtaps: int = 201) -> np.ndarray:
    """Linear-phase windowed-sinc bandpass FIR (Hamming window), the WS
    tick's 300-3400 Hz telephony filter (``qwen3_asr_tpu/audio/
    frontend.py:41-55``)."""
    if numtaps % 2 != 1:
        raise ValueError(f"numtaps must be odd, got {numtaps}")
    m = np.arange(numtaps) - (numtaps - 1) / 2.0

    def sinc_lp(fc):
        x = 2.0 * fc / sr
        return x * np.sinc(x * m)
    h = sinc_lp(high_hz) - sinc_lp(low_hz)
    h *= np.hamming(numtaps)
    # Normalize passband gain to 1.0 at the geometric center frequency.
    fc = np.sqrt(low_hz * high_hz)
    gain = np.abs(np.sum(h * np.exp(-2j * np.pi * fc / sr
                                    * np.arange(numtaps))))
    return (h / gain).astype(np.float32)


def pcm16_to_f32(pcm) -> np.ndarray:
    """s16le bytes (or int16 samples) → float32 / 32768: the numpy
    reference path of ``qwen3_asr_tpu/audio/native.py``."""
    x = (np.frombuffer(pcm, dtype=np.int16)
         if isinstance(pcm, (bytes, bytearray))
         else np.ascontiguousarray(pcm, dtype=np.int16))
    return x.astype(np.float32) / 32768.0


def fir_same(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """``x`` filtered by the odd-length FIR ``h``, output aligned with the
    input ("same"): the numpy reference path of ``audio/native.py``."""
    x = np.ascontiguousarray(x, dtype=np.float32)
    h = np.ascontiguousarray(h, dtype=np.float32)
    pad = (len(h) - 1) // 2
    return np.convolve(np.pad(x, (pad, pad)), h, mode="valid").astype(
        np.float32)


def log_mel(audio: torch.Tensor, n_valid: Union[int, torch.Tensor],
            window: torch.Tensor, mel_fb: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """audio: [B, N] float32 (bucket-padded); n_valid: true sample count
    (int or [B]); window [n_fft]; mel_fb [n_fft//2+1, n_mels].

    Returns (log_mel [B, n_mels, T], valid_frames [B]) with T = N // hop.
    """
    b, n = audio.shape
    t = n // HOP_LENGTH
    dev = audio.device
    # a host int becomes a device fill, not a host-to-device copy (which a
    # CUDA graph capture refuses)
    n_valid = (n_valid.to(dev, torch.int64).expand(b)[:, None]
               if torch.is_tensor(n_valid) else
               torch.full((b, 1), int(n_valid), dtype=torch.int64,
                          device=dev))
    audio = torch.where(torch.arange(n, device=dev)[None, :] < n_valid,
                        audio, torch.zeros((), dtype=audio.dtype, device=dev))

    pad = N_FFT // 2
    padded = torch.nn.functional.pad(audio[:, None, :], (pad, pad),
                                     mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP_LENGTH)[:, :t] * window  # [B,T,n_fft]
    spec = torch.fft.rfft(frames, n=N_FFT, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2                     # [B,T,201]
    mel = power @ mel_fb                                         # [B,T,n_mels]
    log_spec = torch.log10(torch.clamp(mel, min=1e-10))

    frame_idx = torch.arange(t, device=dev)[None, :, None]
    valid_frames = torch.clamp((n_valid + HOP_LENGTH - 1) // HOP_LENGTH,
                               max=t)                            # [B,1]
    max_frames = torch.clamp((n_valid + pad + HOP_LENGTH - 1) // HOP_LENGTH,
                             max=t)
    masked = torch.where(frame_idx < max_frames[:, :, None], log_spec,
                         torch.full_like(log_spec, -1e30))
    global_max = masked.amax(dim=(1, 2), keepdim=True)          # per row
    log_spec = torch.maximum(log_spec, global_max - 8.0)
    log_spec = (log_spec + 4.0) / 4.0
    floor = (torch.clamp(global_max - 8.0, min=-10.0) + 4.0) / 4.0
    log_spec = torch.where(frame_idx < valid_frames[:, :, None], log_spec,
                           floor)
    return log_spec.transpose(1, 2), valid_frames[:, 0]


class LogMelFrontend:
    """Whisper-compatible log-mel extractor with its constants on a device."""

    def __init__(self, n_mels: int, device: Union[str, torch.device]):
        self.n_mels = n_mels
        self.window = torch.from_numpy(hann_window()).to(device)
        self.mel_fb = torch.from_numpy(mel_filter_bank(
            N_FFT // 2 + 1, n_mels, 0.0, SAMPLE_RATE / 2.0, SAMPLE_RATE
        ).astype(np.float32)).to(device)

    def __call__(self, audio: torch.Tensor,
                 n_valid: Union[int, torch.Tensor, None] = None):
        """audio: float32 [B, N] on the frontend's device."""
        if n_valid is None:
            n_valid = audio.shape[-1]
        return log_mel(audio, n_valid, self.window, self.mel_fb)
