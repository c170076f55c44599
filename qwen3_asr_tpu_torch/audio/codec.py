"""Audio container decode — pure numpy. WAV only in this slice.

Counterpart of ``qwen3_asr_tpu/audio/codec.py``: the WAV family (RIFF,
RIFX, RF64; PCM 8/16/24/32-bit and float32/float64) decodes here. Every
other container is recognized and refused with ``UnsupportedFormatError``
(the server answers 422 AUDIO_DECODE_FAILED); anything unrecognized raises
``AudioDecodeError``. Decoded audio is mono float32 in [-1, 1] plus the
sample rate.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


class AudioDecodeError(Exception):
    """Input bytes could not be decoded as audio."""


class UnsupportedFormatError(AudioDecodeError):
    """Recognized container, but the codec is not supported natively."""


# Containers carry the sample rate as a raw (sometimes signed/80-bit) field;
# an hostile header can claim sr=0 / negative / 2^32-ish, which would crash or
# OOM the polyphase resampler downstream instead of returning the contractual
# AUDIO_DECODE_FAILED. Bound it to the real-world range libsndfile accepts.
_MAX_SAMPLE_RATE = 768_000
_MAX_CHANNELS = 1024


def check_stream_params(sr: int, channels: int | None = None) -> int:
    """Validate header-declared stream parameters; returns sr unchanged."""
    if not 1 <= int(sr) <= _MAX_SAMPLE_RATE:
        raise AudioDecodeError(f"implausible sample rate in header: {sr}")
    if channels is not None and not 1 <= int(channels) <= _MAX_CHANNELS:
        raise AudioDecodeError(f"implausible channel count in header: {channels}")
    return int(sr)


def _pcm_to_float(data: np.ndarray, sampwidth: int, signed: bool = True) -> np.ndarray:
    if data.dtype.kind == "f":
        return data.astype(np.float32)
    scale = float(2 ** (8 * sampwidth - 1))
    out = data.astype(np.float32)
    if not signed:  # 8-bit WAV PCM is unsigned
        out = out - scale
    return out / scale


def _to_mono(x: np.ndarray, channels: int) -> np.ndarray:
    if channels <= 1:
        return x
    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels).mean(axis=1)


def _decode_pcm_block(raw: bytes, sampwidth: int, channels: int, fmt: str,
                      big_endian: bool) -> np.ndarray:
    """fmt: 'pcm' | 'float'. Returns mono float32."""
    order = ">" if big_endian else "<"
    if fmt == "float":
        dtype = np.dtype(f"{order}f4") if sampwidth == 4 else np.dtype(f"{order}f8")
        n = (len(raw) // dtype.itemsize) * dtype.itemsize
        data = np.frombuffer(raw[:n], dtype=dtype).astype(np.float32)
        return _to_mono(data, channels)
    if sampwidth == 1:
        data = np.frombuffer(raw, dtype=np.uint8)
        return _to_mono(_pcm_to_float(data, 1, signed=False), channels)
    if sampwidth == 2:
        n = (len(raw) // 2) * 2
        data = np.frombuffer(raw[:n], dtype=np.dtype(f"{order}i2"))
        return _to_mono(_pcm_to_float(data, 2), channels)
    if sampwidth == 3:
        n = (len(raw) // 3) * 3
        b = np.frombuffer(raw[:n], dtype=np.uint8).reshape(-1, 3)
        if big_endian:
            b = b[:, ::-1]
        vals = (b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16))
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        return _to_mono(_pcm_to_float(vals, 3), channels)
    if sampwidth == 4:
        n = (len(raw) // 4) * 4
        data = np.frombuffer(raw[:n], dtype=np.dtype(f"{order}i4"))
        return _to_mono(_pcm_to_float(data, 4), channels)
    raise AudioDecodeError(f"unsupported sample width: {sampwidth}")


# --- WAV (RIFF / RIFX / RF64 / W64) -----------------------------------------

_WAVE_FORMAT_PCM = 0x0001
_WAVE_FORMAT_IEEE_FLOAT = 0x0003
_WAVE_FORMAT_EXTENSIBLE = 0xFFFE


def _decode_wav(buf: bytes) -> Tuple[np.ndarray, int]:
    big_endian = buf[:4] == b"RIFX"
    is_rf64 = buf[:4] == b"RF64"
    order = ">" if big_endian else "<"
    if buf[8:12] != b"WAVE":
        raise AudioDecodeError("not a WAVE file")
    pos = 12
    fmt_tag = None
    channels = sr = sampwidth = None
    data = None
    ds64_data_size = None
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        (csize,) = struct.unpack(order + "I", buf[pos + 4:pos + 8])
        if is_rf64 and csize == 0xFFFFFFFF and ds64_data_size is not None \
                and cid == b"data":
            csize = ds64_data_size
        body = buf[pos + 8:pos + 8 + csize]
        if cid == b"ds64" and len(body) >= 24:
            # RF64 64-bit sizes: riffSize, dataSize, sampleCount
            _, ds64_data_size, _ = struct.unpack(order + "QQQ", body[:24])
        elif cid == b"fmt ":
            if len(body) < 16:
                raise AudioDecodeError("truncated fmt chunk")
            fmt_tag, channels, sr, _, _, bits = struct.unpack(order + "HHIIHH", body[:16])
            if fmt_tag == _WAVE_FORMAT_EXTENSIBLE and len(body) >= 26:
                (sub_fmt,) = struct.unpack(order + "H", body[24:26])
                fmt_tag = sub_fmt
            sampwidth = (bits + 7) // 8
        elif cid == b"data":
            data = body
        pos += 8 + csize + (csize & 1)  # chunks are word-aligned
    if fmt_tag is None or data is None:
        raise AudioDecodeError("missing fmt or data chunk")
    return _wave_to_audio(fmt_tag, sampwidth, channels, sr, data, big_endian)


def _wave_to_audio(fmt_tag, sampwidth, channels, sr, data,
                   big_endian) -> Tuple[np.ndarray, int]:
    """Shared WAVE-family tail (RIFF/RF64/W64): fmt fields + data → audio."""
    check_stream_params(sr, channels)
    if fmt_tag == _WAVE_FORMAT_IEEE_FLOAT:
        audio = _decode_pcm_block(data, sampwidth, channels, "float", big_endian)
    elif fmt_tag == _WAVE_FORMAT_PCM:
        audio = _decode_pcm_block(data, sampwidth, channels, "pcm", big_endian)
    else:
        raise UnsupportedFormatError(f"WAV codec 0x{fmt_tag:04x} not supported")
    return audio, sr


# --- public API ---------------------------------------------------------------

# Containers the JAX package decodes that this slice does not yet.
_NOT_YET = ((b"riff", "W64"), (b"FORM", "AIFF"), (b".snd", "AU"),
            (b"caff", "CAF"), (b"fLaC", "FLAC"), (b"OggS", "OGG"),
            (b"ID3", "MP3"))
_SUPPORTED = "supported formats: WAV, RF64"


def decode_audio(audio_bytes: bytes) -> Tuple[np.ndarray, int]:
    """Decode audio bytes. Returns (mono float32 ndarray in [-1,1], sample_rate).

    Raises AudioDecodeError/UnsupportedFormatError on failure."""
    if len(audio_bytes) < 16:
        raise AudioDecodeError(f"input too short to be audio ({len(audio_bytes)} bytes)")
    head = audio_bytes[:4]
    if head in (b"RIFF", b"RIFX", b"RF64"):
        try:
            return _decode_wav(audio_bytes)
        except (struct.error, IndexError, ValueError) as e:
            raise AudioDecodeError(f"corrupt audio container: {e}") from e
    kind = next((name for magic, name in _NOT_YET
                 if audio_bytes.startswith(magic)), None)
    if kind is None and audio_bytes[0] == 0xFF \
            and (audio_bytes[1] & 0xE0) == 0xE0:
        kind = "MP3"  # raw MPEG frame sync, no ID3 tag
    if kind is not None:
        raise UnsupportedFormatError(f"{kind} is not supported yet; {_SUPPORTED}")
    raise AudioDecodeError(f"unknown audio format; {_SUPPORTED}")


def encode_wav(audio: np.ndarray, sr: int) -> bytes:
    """Encode mono float audio to 16-bit PCM WAV bytes (for tests/tools)."""
    audio = np.asarray(audio, dtype=np.float32)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm
