"""The learned voice-activity model in PyTorch: a small dilated-conv net
over absolute log-mel.

Counterpart of ``qwen3_asr_tpu/audio/vad_model.py``: absolute (not
max-normalized) 32-bin log-mel at 25 ms / 10 ms framing → three dilated
1-D convs → a speech logit per frame → the masked max ("does any frame
carry speech"), so the same weights judge a 450 ms tail and a 6.6 s flush
window. The trained weights (~7k) ship in this package as
``vad_weights.npz``, a copy of the JAX package's file in its layout
(``w{i}`` [K, C_in, C_out], ``b{i}``, ``w_head``, ``b_head``);
``params_from_jax`` turns such a dict into the port's module.

The input is padded to the JAX package's frame buckets (``vad._BUCKETS``)
as it pads: the padded frames are masked out of the max, but the convs
see them at the window's end, so the bucket is part of the function.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve_device

N_MELS = 32
FRAME = 400      # 25 ms @ 16 kHz
HOP = 160        # 10 ms
SR = 16000

_LAYERS = (      # (kernel, c_in, c_out, dilation)
    (5, N_MELS, 24, 1),
    (5, 24, 16, 2),
    (3, 16, 8, 1),
)

WEIGHTS_PATH = os.path.join(os.path.dirname(__file__), "vad_weights.npz")


class VadNet(torch.nn.Module):
    """The three dilated convs (SAME padding, ReLU) and the linear head."""

    def __init__(self):
        super().__init__()
        self.convs = torch.nn.ModuleList(
            torch.nn.Conv1d(cin, cout, k, dilation=dil,
                            padding=(k - 1) * dil // 2)
            for k, cin, cout, dil in _LAYERS)
        self.head = torch.nn.Linear(_LAYERS[-1][2], 1)

    def frame_logits(self, feats: torch.Tensor) -> torch.Tensor:
        """feats [T, N_MELS] → a speech logit per frame [T]."""
        x = feats.T[None]
        for conv in self.convs:
            x = F.relu(conv(x))
        return self.head(x[0].T)[:, 0]

    def forward(self, feats: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """The speech probability: sigmoid of the max logit over the
        frames ``mask`` keeps."""
        lg = self.frame_logits(feats)
        return torch.sigmoid(torch.where(mask, lg,
                                         torch.full_like(lg, -1e9)).max())


def params_from_jax(params: Dict[str, np.ndarray],
                    device=None) -> VadNet:
    """The JAX package's parameter dict (numpy, its layout) → ``VadNet``
    on ``device`` (the card unless asked for the CPU), in f32."""
    device = resolve_device(device)
    net = VadNet()
    with torch.no_grad():
        for i, conv in enumerate(net.convs):
            conv.weight.copy_(torch.from_numpy(
                np.asarray(params[f"w{i}"], np.float32)).permute(2, 1, 0))
            conv.bias.copy_(torch.from_numpy(
                np.asarray(params[f"b{i}"], np.float32)))
        net.head.weight.copy_(torch.from_numpy(
            np.asarray(params["w_head"], np.float32))[None])
        net.head.bias.copy_(torch.from_numpy(
            np.asarray(params["b_head"], np.float32)).reshape(1))
    return net.to(device).eval()


def load_params(path: Optional[str] = None
                ) -> Optional[Dict[str, np.ndarray]]:
    """The packaged weights as numpy (``ASR_VAD_WEIGHTS`` names another
    file); None when the file is absent."""
    path = path or os.getenv("ASR_VAD_WEIGHTS", WEIGHTS_PATH)
    if not os.path.isfile(path):
        return None
    return _read(path)


@functools.lru_cache(maxsize=4)
def _read(path: str) -> Dict[str, np.ndarray]:
    blob = np.load(path)
    return {k: np.asarray(blob[k]) for k in blob.files}


@functools.lru_cache(maxsize=8)
def _model(path: str, device: torch.device) -> VadNet:
    return params_from_jax(_read(path), device)


@functools.lru_cache(maxsize=8)
def _consts(device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    from .frontend import hann_window
    from .mel import mel_filter_bank
    fb = mel_filter_bank(FRAME // 2 + 1, N_MELS, 0.0, SR / 2.0, SR)
    return (torch.from_numpy(hann_window(FRAME)).to(device),
            torch.from_numpy(fb).to(device))


def pad_for(audio: np.ndarray, n_frames_padded: int) -> Tuple[np.ndarray,
                                                               int]:
    """Audio padded to the bucket's sample count, and its real frames."""
    x = np.asarray(audio, dtype=np.float32)
    if len(x) < FRAME:
        x = np.pad(x, (0, FRAME - len(x)))
    n_frames = min(1 + (len(x) - FRAME) // HOP, n_frames_padded)
    need = FRAME + (n_frames_padded - 1) * HOP
    if len(x) < need:
        x = np.pad(x, (0, need - len(x)))
    return x[:need], n_frames


def featurize(x: torch.Tensor, n_frames_padded: int, n_frames: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Padded audio [need] on the device → (absolute log-mel [Tb, N_MELS],
    mask [Tb])."""
    window, mel_fb = _consts(x.device)
    idx = (torch.arange(n_frames_padded, device=x.device)[:, None] * HOP
           + torch.arange(FRAME, device=x.device)[None, :])
    spec = torch.fft.rfft(x[idx] * window[None, :], dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    feats = (torch.log10(power @ mel_fb + 1e-10) + 5.0) / 3.0
    mask = torch.arange(n_frames_padded, device=x.device) < n_frames
    return feats, mask


@torch.inference_mode()
def speech_probability(audio_float32: np.ndarray, device=None
                       ) -> Optional[float]:
    """The learned speech probability of a mono f32 clip at 16 kHz, on
    ``device`` (the card unless asked for the CPU); None when no weights
    are available."""
    from .vad import _BUCKETS
    path = os.getenv("ASR_VAD_WEIGHTS", WEIGHTS_PATH)
    if not os.path.isfile(path):
        return None
    device = resolve_device(device)
    x = np.asarray(audio_float32, dtype=np.float32)
    n_frames = max(1, 1 + (max(len(x), FRAME) - FRAME) // HOP)
    bucket = next((b for b in _BUCKETS if n_frames <= b), _BUCKETS[-1])
    padded, n_frames = pad_for(x, bucket)
    feats, mask = featurize(torch.from_numpy(padded).to(device), bucket,
                            n_frames)
    return float(_model(path, device)(feats, mask))
