"""Audio inspection CLI: decode a file, print its statistics, optionally
resample, and give the VAD's speech probability.

Counterpart of ``qwen3_asr_tpu/tools/debug_audio.py``, through the port's
codec, resampler and VAD; the VAD runs on the card unless ``--device cpu``
is given:

    python -m qwen3_asr_tpu_torch.tools.debug_audio file.wav \\
        [--resample 16000] [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np


def describe(path: str, target_sr: int = None, device="cuda") -> dict:
    from ..audio.codec import decode_audio
    with open(path, "rb") as f:
        data = f.read()
    audio, sr = decode_audio(data)
    info = {
        "path": path,
        "bytes": len(data),
        "sample_rate": sr,
        "samples": len(audio),
        "duration_s": round(len(audio) / sr, 3),
        "dtype": str(audio.dtype),
        "peak": round(float(np.max(np.abs(audio))), 5) if len(audio) else 0.0,
        "rms": round(float(np.sqrt(np.mean(audio ** 2))), 5)
        if len(audio) else 0.0,
        "dc_offset": round(float(np.mean(audio)), 6) if len(audio) else 0.0,
    }
    if target_sr and target_sr != sr:
        from ..audio.resample import resample
        res = resample(audio, sr, target_sr)
        info["resampled_to"] = target_sr
        info["resampled_samples"] = len(res)
        audio, sr = res, target_sr
    if len(audio) >= 400:
        from ..audio.vad import speech_probability
        info["speech_probability"] = round(speech_probability(
            audio[:16000 * 30], device), 3)
    return info


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("file")
    parser.add_argument("--resample", type=int, default=None)
    parser.add_argument("--device", default="cuda",
                        help="where the VAD runs: cuda (the default) or cpu")
    args = parser.parse_args(argv)
    info = describe(args.file, args.resample, args.device)
    for k, v in info.items():
        print(f"{k:>20}: {v}")


if __name__ == "__main__":
    main()
