"""Voice-activity detection for the WS session, in PyTorch on the
engine's device.

Counterpart of ``qwen3_asr_tpu/audio/vad.py``: ``is_speech(float32) ->
bool`` at a 0.5 threshold, assuming speech if the detector fails (the
failure is logged and counted in ``failures``, so it is never silent).
Every entry point runs on the card unless the caller passes
``device="cpu"``. Two backends, picked by ``active_backend``:

- ``learned`` (``audio/vad_model.py``), when its packaged weights are
  present and ``ASR_VAD`` is not ``spectral``;
- ``spectral``: an analytic score, the weighted product of four cues over
  25 ms frames (an energy gate with an adaptive noise floor, speech-band
  dominance, spectral flatness, and 2-9 Hz envelope modulation).

Both pad the clip to a ladder of frame counts (``_BUCKETS``) as the JAX
package does; the spectral envelope's spectrum runs over the padded
length, so the ladder is part of the function.
"""
from __future__ import annotations

import functools
import logging
import os
import threading

import numpy as np
import torch

from ..utils.device import resolve_device

log = logging.getLogger(__name__)

FRAME = 400       # 25 ms @ 16 kHz
HOP = 160         # 10 ms
SR = 16000

_BUCKETS = (50, 100, 200, 400, 600, 1000, 3000)  # frames (0.5 s .. 30 s)

# is_speech calls whose detector raised (answered "speech"), this process
failures = 0
_failures_lock = threading.Lock()


def _bucket(n_frames: int) -> int:
    for b in _BUCKETS:
        if n_frames <= b:
            return b
    return _BUCKETS[-1]


def _rfftfreq(n: int, d: float, device) -> torch.Tensor:
    return torch.arange(n // 2 + 1, dtype=torch.float32,
                        device=device) / (n * d)


def vad_features(frames: torch.Tensor, frame_mask: torch.Tensor
                 ) -> torch.Tensor:
    """frames [T, FRAME] f32 (Hann applied), frame_mask [T] bool → the
    speech probability in [0, 1] (0-d), ``_vad_features`` of the JAX
    package."""
    t = frames.shape[0]
    dev = frames.device
    valid = frame_mask.float()
    n_valid = valid.sum().clamp(min=1.0)

    spec = torch.fft.rfft(frames, dim=-1)                 # [T, 201]
    power = spec.real ** 2 + spec.imag ** 2
    freqs = _rfftfreq(FRAME, 1.0 / SR, dev)

    frame_energy = torch.sqrt(power.mean(-1) + 1e-12)
    frame_energy = torch.where(frame_mask, frame_energy,
                               torch.zeros_like(frame_energy))

    # 1) absolute + adaptive energy gate
    sorted_e = torch.sort(torch.where(
        frame_mask, frame_energy,
        torch.full_like(frame_energy, float("inf")))).values
    idx10 = (n_valid * 0.1).to(torch.int32).clamp(0, t - 1).long()
    noise_floor = sorted_e[idx10].clamp(min=1e-6)
    active = frame_mask & (frame_energy > torch.clamp(3.0 * noise_floor,
                                                      min=3e-4))
    active_f = active.float()
    n_active = active_f.sum()
    p_energy = (n_active / n_valid / 0.1).clamp(0.0, 1.0)
    w_active = active_f / n_active.clamp(min=1.0)

    # 2) speech-band dominance
    band = ((freqs >= 250.0) & (freqs <= 3800.0)).float()
    band_energy = (power * band[None, :]).sum(-1)
    total_energy = power.sum(-1) + 1e-12
    band_ratio = (w_active * band_energy / total_energy).sum()
    p_band = ((band_ratio - 0.35) / 0.3).clamp(0.0, 1.0)

    # 3) spectral flatness (geometric / arithmetic mean of power)
    log_p = torch.log(power + 1e-12)
    flatness = torch.exp(log_p.mean(-1)) / (power.mean(-1) + 1e-12)
    mean_flat = (w_active * flatness).sum()
    p_tonal = ((0.35 - mean_flat) / 0.3).clamp(0.0, 1.0)

    # 4) syllable-rate envelope modulation (2-9 Hz), frame rate 100 Hz
    env = frame_energy - (frame_energy * valid).sum() / n_valid
    env = torch.where(frame_mask, env, torch.zeros_like(env))
    env_spec = torch.fft.rfft(env).abs()
    env_freqs = _rfftfreq(t, 1.0 / 100.0, dev)
    mod_band = ((env_freqs >= 2.0) & (env_freqs <= 9.0)).float()
    lo_band = (env_freqs <= 50.0).float()
    mod_ratio = ((env_spec ** 2 * mod_band).sum()
                 / ((env_spec ** 2 * lo_band).sum() + 1e-12))
    p_mod = (mod_ratio / 0.25).clamp(0.0, 1.0)

    # energy is a hard gate; the rest vote
    p_struct = 0.45 * p_band + 0.25 * p_tonal + 0.30 * p_mod
    return p_energy * (p_struct / 0.5).clamp(0.0, 1.0)


@functools.lru_cache(maxsize=8)
def _window(device: torch.device) -> torch.Tensor:
    from .frontend import hann_window
    return torch.from_numpy(hann_window(FRAME)).to(device)


@torch.inference_mode()
def spectral_probability(audio_float32: np.ndarray, device=None) -> float:
    """The spectral speech probability of a mono f32 clip at 16 kHz, on
    ``device`` (the card unless asked for the CPU)."""
    device = resolve_device(device)
    x = np.asarray(audio_float32, dtype=np.float32)
    if len(x) < FRAME:
        x = np.pad(x, (0, FRAME - len(x)))
    n_frames = 1 + (len(x) - FRAME) // HOP
    tb = _bucket(n_frames)
    need = FRAME + (tb - 1) * HOP
    if len(x) < need:
        x = np.pad(x, (0, need - len(x)))
    xt = torch.from_numpy(np.ascontiguousarray(x)).to(device)
    idx = (torch.arange(tb, device=device)[:, None] * HOP
           + torch.arange(FRAME, device=device)[None, :])
    frames = xt[idx] * _window(device)[None, :]
    mask = torch.arange(tb, device=device) < n_frames
    return float(vad_features(frames, mask))


def active_backend() -> str:
    """"learned" when the packaged weights are present and ``ASR_VAD`` is
    not ``spectral``, else "spectral"; ``ASR_VAD=learned`` with no weights
    raises."""
    choice = os.getenv("ASR_VAD", "").lower()
    if choice == "spectral":
        return "spectral"
    from . import vad_model
    if vad_model.load_params() is not None:
        return "learned"
    if choice == "learned":
        raise FileNotFoundError("ASR_VAD=learned but no VAD weights found")
    return "spectral"


def default_flush_ticks() -> int:
    """The WS flush debounce's default: 1 silent tick with the learned VAD,
    2 with the spectral one (the JAX package's measured mid-speech
    false-silence rates: <1% and 6.4%)."""
    try:
        return 1 if active_backend() == "learned" else 2
    except Exception:
        return 2


def speech_probability(audio_float32: np.ndarray, device=None) -> float:
    """The active backend's speech probability for a mono f32 clip at
    16 kHz, computed on ``device`` (the card unless asked for the CPU)."""
    if active_backend() == "learned":
        from . import vad_model
        p = vad_model.speech_probability(audio_float32, device)
        if p is not None:
            return p
    return spectral_probability(audio_float32, device)


def is_speech(audio_float32: np.ndarray, threshold: float = 0.5,
              device=None) -> bool:
    """True if the clip holds speech; True as well if the detector fails
    (assume speech, as the JAX package does), which is logged and counted
    in ``failures``."""
    global failures
    try:
        return speech_probability(audio_float32, device) >= threshold
    except Exception:  # a session must keep running; the count shows it
        with _failures_lock:
            failures += 1
        log.exception("VAD failed on %s; assuming speech", device)
        return True
