"""Train the learned VAD on local data (no downloads), on the card.

Counterpart of ``qwen3_asr_tpu/tools/train_vad.py``. The dataset is built
as JAX builds it, from the same ``np.random.default_rng(0)`` draws:

* positives: 1 s windows of the real clips (``e2e/data/real``; two held
  out), each also scaled, band-passed as the WS tick band-passes
  (``audio/frontend.py``) and with noise added; plus the synthetic
  speech-like family the unit tests use;
* negatives: silence, white and pink noise, tones, chirps, mains hum,
  click trains.

The objective is the mean sigmoid binary cross-entropy of the window's
masked-max frame logit (``audio/vad_model.py``), trained with optax's
``adam`` arithmetic (``runtime/optim.py`` ``adamw`` at weight decay 0) on
batches of 256 drawn by ``np.random.default_rng(seed).integers``. The
weights start from torch's generator seeded with ``--seed``, so they are
not JAX's. After training, ``b_head`` moves to a margin above the hardest
training negative, the train-set error is reported, the weights are saved
as an npz of JAX's key names (both packages read it), and the file is
reloaded through the serving VAD to measure the mid-speech flap rate.

    python -m qwen3_asr_tpu_torch.tools.train_vad --data-dir e2e/data/real \\
        --output /tmp/vad_weights.npz [--device cpu]

``--output`` defaults to the package's own ``audio/vad_weights.npz``, which
serving reads, as JAX's tool does.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import time
from pathlib import Path

import numpy as np

log = logging.getLogger(__name__)

HELD_OUT = ("japanese_02", "thai_02")
WIN_S = 1.0
BATCH = 256


# the synthetic fixtures of the unit tests (the reference's E2E
# generators), kept here so the package imports nothing from tests/
def tone(duration_s=1.0, freq=440.0, sr=16000, amplitude=0.5):
    t = np.linspace(0, duration_s, int(sr * duration_s), endpoint=False)
    return (amplitude * np.sin(2 * np.pi * freq * t)).astype(np.float32)


def speech_like(duration_s=2.0, sr=16000, seed=0):
    """Modulated formant-like signal."""
    rng = np.random.default_rng(seed)
    n = int(sr * duration_s)
    t = np.linspace(0, duration_s, n, endpoint=False)
    signal = 0.05 * rng.standard_normal(n)
    for f in [150, 300, 600, 1200]:
        signal = signal + 0.1 * np.sin(2 * np.pi * f * t) * (
            0.5 + 0.5 * np.sin(2 * np.pi * 5 * t))
    signal = signal * (0.3 + 0.7 * np.abs(np.sin(2 * np.pi * 4 * t)))
    peak = np.abs(signal).max()
    return (signal / peak * 0.9).astype(np.float32)


def _pink_noise(n, rng, amplitude=0.1):
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f = np.maximum(np.fft.rfftfreq(n), 1.0 / n)
    pink = np.fft.irfft(spec / np.sqrt(f), n)
    return (amplitude * pink / (np.abs(pink).max() + 1e-9)).astype(np.float32)


def _click_train(n, rng, rate_hz=8.0, sr=16000):
    x = np.zeros(n, np.float32)
    step = int(sr / rate_hz)
    for i in range(0, n, step):
        x[i:i + 8] = rng.uniform(0.3, 0.8)
    return x


def read_clips(data_dir: str, sr: int = 16000) -> dict:
    """{stem: mono float32 audio at ``sr``} of every WAV in ``data_dir``."""
    from ..audio.codec import decode_audio
    from ..audio.resample import resample
    clips = {}
    for wav in sorted(Path(data_dir).glob("*.wav")):
        with open(wav, "rb") as f:
            audio, csr = decode_audio(f.read())
        clips[wav.stem] = resample(audio, csr, sr) if csr != sr else audio
    return clips


def build_dataset(data_dir: str, sr: int = 16000):
    """Returns (windows [N, n], labels [N], train_clip_names, eval_clips)."""
    from ..audio.frontend import fir_bandpass_kernel, fir_same

    n_win = int(WIN_S * sr)
    rng = np.random.default_rng(0)
    bp = fir_bandpass_kernel()
    windows, labels = [], []

    def add(x, label):
        windows.append(x[:n_win].astype(np.float32))
        labels.append(label)

    # -- real speech positives ----------------------------------------------
    clips, eval_clips = {}, {}
    for name, audio in read_clips(data_dir, sr).items():
        (eval_clips if name in HELD_OUT else clips)[name] = audio

    hop = int(0.25 * sr)
    for name, audio in clips.items():
        for start in range(0, len(audio) - n_win, hop):
            w = audio[start:start + n_win]
            if float(np.sqrt(np.mean(w ** 2))) < 0.004:
                continue  # leading/trailing silence: not a speech window
            add(w, 1)
            gain = rng.choice([0.08, 0.25, 1.4])
            add(w * gain, 1)
            add(fir_same(w.astype(np.float32), bp), 1)  # the WS path's shape
            noise = rng.standard_normal(n_win).astype(np.float32)
            snr_scale = float(np.sqrt(np.mean(w ** 2))) / 6.0
            add(w + noise * snr_scale, 1)

    # synthetic speech-like family (the unit-test contract)
    for seed in range(12):
        clip = speech_like(4.0, seed=seed)
        for start in range(0, len(clip) - n_win, n_win // 2):
            add(clip[start:start + n_win], 1)
            add(clip[start:start + n_win] * 0.15, 1)

    # -- negatives -----------------------------------------------------------
    for _ in range(30):
        add(np.zeros(n_win, np.float32), 0)
        for amp in (0.005, 0.01, 0.05, 0.1, 0.3):
            add((amp * rng.standard_normal(n_win)).astype(np.float32), 0)
        add(_pink_noise(n_win, rng, amplitude=rng.uniform(0.05, 0.4)), 0)
        freq = rng.uniform(80, 4000)
        add(tone(WIN_S, freq, amplitude=rng.uniform(0.05, 0.8)), 0)
        t = np.linspace(0, WIN_S, n_win, endpoint=False)
        f0, f1 = sorted(rng.uniform(100, 3000, 2))      # chirp
        add((0.4 * np.sin(2 * np.pi * (f0 + (f1 - f0) * t / WIN_S / 2) * t)
             ).astype(np.float32), 0)
        add((0.3 * np.sin(2 * np.pi * 50 * t)
             + 0.1 * np.sin(2 * np.pi * 150 * t)).astype(np.float32), 0)
        add(_click_train(n_win, rng, rate_hz=rng.uniform(2, 20)), 0)

    return (np.stack(windows), np.asarray(labels, np.float32),
            sorted(clips), eval_clips)


def featurize_windows(windows: np.ndarray, device, chunk: int = 512):
    """1 s windows [N, n] → absolute log-mel [N, T, N_MELS] on ``device``
    (every window has all its frames, so no mask)."""
    import torch

    from ..audio import vad_model
    window, mel_fb = vad_model._consts(device)
    n_frames = 1 + (windows.shape[1] - vad_model.FRAME) // vad_model.HOP
    idx = (torch.arange(n_frames, device=device)[:, None] * vad_model.HOP
           + torch.arange(vad_model.FRAME, device=device)[None, :])
    feats = []
    for i in range(0, len(windows), chunk):
        x = torch.from_numpy(windows[i:i + chunk]).to(device)
        spec = torch.fft.rfft(x[:, idx] * window, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2
        feats.append((torch.log10(power @ mel_fb + 1e-10) + 5.0) / 3.0)
    return torch.cat(feats)


def init_params(seed: int, device) -> dict:
    """Weights in JAX's layout and scales (``w{i}`` [K, C_in, C_out] at
    sqrt(2 / (K C_in)), ``w_head`` at 0.1, biases 0), drawn from torch's
    generator seeded with ``seed``."""
    import torch

    from ..audio.vad_model import _LAYERS
    gen = torch.Generator().manual_seed(seed)
    params = {}
    for i, (k, cin, cout, _) in enumerate(_LAYERS):
        params[f"w{i}"] = (torch.randn((k, cin, cout), generator=gen)
                           * (2.0 / (k * cin)) ** 0.5)
        params[f"b{i}"] = torch.zeros((cout,))
    params["w_head"] = torch.randn((_LAYERS[-1][2],), generator=gen) * 0.1
    params["b_head"] = torch.zeros(())
    return {k: v.to(device) for k, v in params.items()}


def window_logits(params: dict, feats):
    """[N, T, N_MELS] → the windows' max frame logits [N] (JAX's
    ``window_logit`` with every frame kept)."""
    import torch.nn.functional as F

    from ..audio.vad_model import _LAYERS
    x = feats.transpose(1, 2)
    for i, (k, _, _, dil) in enumerate(_LAYERS):
        x = F.relu(F.conv1d(x, params[f"w{i}"].permute(2, 1, 0),
                            params[f"b{i}"], padding=(k - 1) * dil // 2,
                            dilation=dil))
    lg = x.transpose(1, 2) @ params["w_head"] + params["b_head"]
    return lg.amax(dim=1)


def sigmoid_bce(logits, labels):
    """optax's ``sigmoid_binary_cross_entropy``, averaged."""
    import torch
    return (torch.relu(logits) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


def train(params: dict, feats, labels, steps: int, lr: float, seed: int,
          log_every: int = 200) -> tuple:
    """``steps`` Adam steps on batches of ``BATCH`` drawn with
    ``default_rng(seed)``; returns the trained params and each step's loss
    (a tensor on the device: no host read a step)."""
    import torch

    from ..runtime.optim import adamw, apply_updates
    optimizer = adamw(lr, weight_decay=0.0)
    state = optimizer.init(params)
    y = torch.as_tensor(labels, device=feats.device)
    rng = np.random.default_rng(seed)
    losses = []
    for step in range(1, steps + 1):
        sel = torch.as_tensor(rng.integers(0, len(feats), BATCH),
                              device=feats.device)
        p = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = sigmoid_bce(window_logits(p, feats[sel]), y[sel])
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        with torch.no_grad():
            updates, state = optimizer.update(grads, state, params)
            params = apply_updates(params, updates)
        losses.append(loss.detach())
        if log_every and step % log_every == 0:
            log.info("step %d | loss %.4f", step, float(loss))
    return params, losses


def _logits(params: dict, feats) -> np.ndarray:
    import torch
    with torch.no_grad():
        return torch.cat([window_logits(params, feats[i:i + 512])
                          for i in range(0, len(feats), 512)]).cpu().numpy()


def _rates(logits: np.ndarray, labels: np.ndarray) -> tuple:
    pred = logits > 0
    n_pos, n_neg = int(labels.sum()), int((1 - labels).sum())
    fp = float(((pred == 1) & (labels == 0)).sum() / max(n_neg, 1))
    fn = float(((pred == 0) & (labels == 1)).sum() / max(n_pos, 1))
    return fp, fn


def error_rates(params: dict, feats, labels: np.ndarray) -> tuple:
    """(false-positive rate, false-negative rate) of ``params`` at their
    own boundary (logit 0)."""
    return _rates(_logits(params, feats), labels)


def calibrate(params: dict, feats, labels: np.ndarray) -> tuple:
    """Move ``b_head`` to 2 above the hardest training negative's logit:
    (params, offset, logits after it, train FP rate, train FN rate)."""
    logits = _logits(params, feats)
    neg_max = float(logits[labels == 0].max())
    offset = -(neg_max + 2.0)
    params = dict(params)
    params["b_head"] = params["b_head"] + offset
    logits = logits + np.float32(offset)
    return (params, offset, logits) + _rates(logits, labels)


def save_params(params: dict, path: str) -> None:
    """The npz of JAX's key names and layout."""
    np.savez(path, **{k: v.detach().cpu().numpy() for k, v in params.items()})


def use_weights(path: str) -> None:
    """Serve the learned VAD from ``path`` (the env and the caches)."""
    from ..audio import vad_model
    os.environ["ASR_VAD"] = "learned"
    os.environ["ASR_VAD_WEIGHTS"] = path
    vad_model._read.cache_clear()
    vad_model._model.cache_clear()


def evaluate(clips: dict, sr: int = 16000, device=None) -> dict:
    """Sliding 1 s windows over each clip's loudest 6 s: the fraction
    gated as speech (the mid-speech flap metric)."""
    from ..audio.vad import is_speech
    out = {}
    for name, audio in clips.items():
        win6 = 6 * sr
        if len(audio) > win6:
            rms = np.convolve(audio ** 2, np.ones(1600) / 1600, "same")
            centers = np.arange(0, len(audio) - win6, 1600)
            best = centers[int(np.argmax(
                [rms[c:c + win6].mean() for c in centers]))]
            audio = audio[best:best + win6]
        hits = total = 0
        for start in range(0, len(audio) - sr, 1600):  # 0.1 s hop
            total += 1
            hits += bool(is_speech(audio[start:start + sr], device=device))
        out[name] = {"windows": total, "speech_gated": hits,
                     "flap_rate": round(1.0 - hits / max(total, 1), 4)}
    return out


def report(data_dir: str, weights: str, device, train_names=(),
           fp=None, fn=None) -> dict:
    """Reload ``weights`` through the serving VAD and measure every clip's
    flap rate; the report JAX's tool prints."""
    use_weights(weights)
    table = evaluate(read_clips(data_dir), device=device)
    worst = max(table.values(), key=lambda r: r["flap_rate"])
    out = {"train_clips": list(train_names), "held_out": list(HELD_OUT)}
    if fp is not None:
        out.update(train_fp=round(fp, 4), train_fn=round(fn, 4))
    out.update(flap_table=table, worst_flap_rate=worst["flap_rate"])
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--data-dir", default="e2e/data/real")
    parser.add_argument("--output", default=None)
    parser.add_argument("--steps", type=int, default=1500)
    parser.add_argument("--lr", type=float, default=3e-3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu; f32 on both")
    args = parser.parse_args(argv)

    from ..audio import vad_model
    from ..utils.device import resolve_device
    from ..utils.logging import setup_logging

    setup_logging()
    dev = resolve_device(args.device)
    t0 = time.time()
    windows, labels, train_names, _ = build_dataset(args.data_dir)
    log.info("VAD dataset: %d windows (%d pos / %d neg), held out: %s",
             len(labels), int(labels.sum()), int((1 - labels).sum()),
             ",".join(HELD_OUT))
    feats = featurize_windows(windows, dev)
    params = init_params(args.seed, dev)
    params, _ = train(params, feats, labels, args.steps, args.lr, args.seed)
    params, offset, _, fp, fn = calibrate(params, feats, labels)
    log.info("calibration: boundary offset %+.2f", offset)
    log.info("train-set: false-positive %.2f%%, false-negative %.2f%%",
             100 * fp, 100 * fn)
    out_path = args.output or vad_model.WEIGHTS_PATH
    save_params(params, out_path)
    log.info("saved weights to %s (%.1f s)", out_path, time.time() - t0)
    out = report(args.data_dir, out_path, dev, train_names, fp, fn)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
