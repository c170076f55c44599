"""Audio container decode — numpy, no libsndfile or ffmpeg.

Counterpart of ``qwen3_asr_tpu/audio/codec.py``: WAV (RIFF, RIFX, RF64;
PCM 8/16/24/32-bit and float32/float64), W64 (Sony Wave64), AIFF/AIFC
(uncompressed, ``sowt`` and float), AU/SND, CAF (LPCM) and FLAC
(``audio/flac.py``) decode here to the JAX package's samples, rate, error
classes and messages. MPEG audio (Layer I, II and III), Ogg Vorbis and
Ogg Opus, which JAX decodes through pygame's SDL_mixer, go to the port's
own decoders (``audio/compressed.py``) from the same magic bytes; what
those refuse (MP3 intensity stereo, Vorbis floor 0, chained Ogg streams,
Opus channel mapping family 255, more than 8 channels) raises
``UnsupportedFormatError`` (the server answers 422 AUDIO_DECODE_FAILED);
anything unrecognized raises ``AudioDecodeError``. Decoded audio is mono float32 in [-1, 1] plus the
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
# Samples over all channels that an MP3 or Ogg Vorbis upload may decode to:
# 3.4 h of 44.1 kHz stereo. Their headers make a few bytes decode to
# thousands of samples, so the decoders refuse more before they allocate.
MAX_DECODED_SAMPLES = 1 << 29


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


# --- W64 (Sony Wave64) ---------------------------------------------------------

def _decode_w64(buf: bytes) -> Tuple[np.ndarray, int]:
    """Sony Wave64: the RIFF layout with 16-byte GUID chunk ids and int64
    sizes (which INCLUDE the 24-byte chunk header), 8-byte aligned. The
    GUID's first four bytes are the classic FourCC ('riff', 'wave',
    'fmt ', 'data'); fmt body is byte-identical to WAV's."""
    if buf[:4] != b"riff" or buf[24:28] != b"wave":
        raise AudioDecodeError("not a Wave64 file")
    pos = 40
    fmt_tag = channels = sr = sampwidth = None
    data = None
    while pos + 24 <= len(buf):
        cid = buf[pos:pos + 4]
        (csize,) = struct.unpack("<q", buf[pos + 16:pos + 24])
        if csize < 24:
            raise AudioDecodeError("corrupt Wave64 chunk size")
        body = buf[pos + 24:pos + csize]
        if cid == b"fmt ":
            if len(body) < 16:
                raise AudioDecodeError("truncated fmt chunk")
            fmt_tag, channels, sr, _, _, bits = struct.unpack("<HHIIHH",
                                                              body[:16])
            if fmt_tag == _WAVE_FORMAT_EXTENSIBLE and len(body) >= 26:
                (fmt_tag,) = struct.unpack("<H", body[24:26])
            sampwidth = (bits + 7) // 8
        elif cid == b"data":
            data = body
        pos += (csize + 7) & ~7  # chunks are 8-byte aligned
    if fmt_tag is None or data is None:
        raise AudioDecodeError("missing fmt or data chunk")
    return _wave_to_audio(fmt_tag, sampwidth, channels, sr, data,
                          big_endian=False)


# --- AIFF / AIFC -------------------------------------------------------------

def _read_ext_float80(b: bytes) -> float:
    """IEEE 754 80-bit extended float (AIFF sample rate encoding)."""
    (expon,) = struct.unpack(">H", b[:2])
    (hi, lo) = struct.unpack(">II", b[2:10])
    sign = -1.0 if expon & 0x8000 else 1.0
    expon &= 0x7FFF
    mant = (hi << 32) | lo
    if expon == 0 and mant == 0:
        return 0.0
    return sign * mant * 2.0 ** (expon - 16383 - 63)


def _decode_aiff(buf: bytes) -> Tuple[np.ndarray, int]:
    form_type = buf[8:12]
    if form_type not in (b"AIFF", b"AIFC"):
        raise AudioDecodeError("not an AIFF file")
    pos = 12
    channels = sr = sampwidth = None
    comp = b"NONE"
    data = None
    while pos + 8 <= len(buf):
        cid = buf[pos:pos + 4]
        (csize,) = struct.unpack(">I", buf[pos + 4:pos + 8])
        body = buf[pos + 8:pos + 8 + csize]
        if cid == b"COMM":
            channels, _nframes = struct.unpack(">HI", body[:6])
            (bits,) = struct.unpack(">H", body[6:8])
            sampwidth = (bits + 7) // 8
            sr = int(round(_read_ext_float80(body[8:18])))
            if form_type == b"AIFC" and len(body) >= 22:
                comp = body[18:22]
        elif cid == b"SSND":
            (offset, _block) = struct.unpack(">II", body[:8])
            data = body[8 + offset:]
        pos += 8 + csize + (csize & 1)
    if channels is None or data is None:
        raise AudioDecodeError("missing COMM or SSND chunk")
    check_stream_params(sr, channels)
    if comp in (b"NONE", b"twos"):
        audio = _decode_pcm_block(data, sampwidth, channels, "pcm", big_endian=True)
    elif comp == b"sowt":
        audio = _decode_pcm_block(data, sampwidth, channels, "pcm", big_endian=False)
    elif comp in (b"fl32", b"FL32"):
        audio = _decode_pcm_block(data, 4, channels, "float", big_endian=True)
    elif comp in (b"fl64", b"FL64"):
        audio = _decode_pcm_block(data, 8, channels, "float", big_endian=True)
    else:
        raise UnsupportedFormatError(f"AIFC compression {comp!r} not supported")
    return audio, sr


# --- CAF (Apple Core Audio Format) --------------------------------------------

def _decode_caf(buf: bytes) -> Tuple[np.ndarray, int]:
    """Core Audio Format, LPCM only. Big-endian chunked container: 8-byte file header ('caff', version, flags), then
    (type[4], int64 size) chunks. 'desc' is the stream description;
    'data' begins with a uint32 edit count; a size of -1 on the final
    data chunk means "to EOF" (streaming writers)."""
    if buf[:4] != b"caff":
        raise AudioDecodeError("not a CAF file")
    pos = 8
    sr = channels = sampwidth = None
    fmt = "pcm"
    big_endian = True
    data = None
    while pos + 12 <= len(buf):
        ctype = buf[pos:pos + 4]
        (csize,) = struct.unpack(">q", buf[pos + 4:pos + 12])
        if csize < 0:
            if ctype != b"data":
                raise AudioDecodeError("open-ended non-data CAF chunk")
            csize = len(buf) - (pos + 12)
        body = buf[pos + 12:pos + 12 + csize]
        if ctype == b"desc":
            (srate,) = struct.unpack(">d", body[:8])
            fmt_id = body[8:12]
            flags, _bpp, _fpp, ch, bits = struct.unpack(">IIIII", body[12:32])
            if fmt_id != b"lpcm":
                raise UnsupportedFormatError(
                    f"CAF codec {fmt_id!r} not supported (LPCM only)")
            if bits < 16:
                raise UnsupportedFormatError(
                    f"CAF {bits}-bit LPCM not supported")
            sr = int(round(srate))
            channels = ch
            sampwidth = (bits + 7) // 8
            fmt = "float" if flags & 0x1 else "pcm"   # kCAF...IsFloat
            big_endian = not (flags & 0x2)            # kCAF...IsLittleEndian
        elif ctype == b"data":
            data = body[4:]  # uint32 edit count precedes the samples
        pos += 12 + csize
    if sr is None or data is None:
        raise AudioDecodeError("missing desc or data chunk")
    check_stream_params(sr, channels)
    audio = _decode_pcm_block(data, sampwidth, channels, fmt,
                              big_endian=big_endian)
    return audio, sr


# --- AU / SND ----------------------------------------------------------------

_AU_ENCODINGS = {2: (1, "pcm"), 3: (2, "pcm"), 4: (3, "pcm"), 5: (4, "pcm"),
                 6: (4, "float"), 7: (8, "float")}


def _decode_au(buf: bytes) -> Tuple[np.ndarray, int]:
    magic, hdr_size, _data_size, encoding, sr, channels = struct.unpack(
        ">IIIIII", buf[:24])
    if magic != 0x2E736E64:  # ".snd"
        raise AudioDecodeError("not an AU file")
    if encoding not in _AU_ENCODINGS:
        raise UnsupportedFormatError(f"AU encoding {encoding} not supported")
    check_stream_params(sr, channels)
    sampwidth, fmt = _AU_ENCODINGS[encoding]
    audio = _decode_pcm_block(buf[hdr_size:], sampwidth, channels, fmt,
                              big_endian=True)
    return audio, sr


# --- public API ---------------------------------------------------------------

_COMPRESSED = ((b"OggS", "OGG"), (b"ID3", "MP3"))
_SUPPORTED = ("supported formats: WAV, W64, RF64, AIFF/AIFC, AU/SND, CAF, "
              "FLAC, MP3, OGG")


def decode_audio(audio_bytes: bytes) -> Tuple[np.ndarray, int]:
    """Decode audio bytes. Returns (mono float32 ndarray in [-1,1], sample_rate).

    Raises AudioDecodeError/UnsupportedFormatError on failure."""
    if len(audio_bytes) < 16:
        raise AudioDecodeError(f"input too short to be audio ({len(audio_bytes)} bytes)")
    head = audio_bytes[:4]
    try:
        if head in (b"RIFF", b"RIFX", b"RF64"):
            return _decode_wav(audio_bytes)
        if head == b"riff":  # Wave64 uses a lowercase GUID FourCC
            return _decode_w64(audio_bytes)
        if head == b"FORM":
            return _decode_aiff(audio_bytes)
        if head == b".snd":
            return _decode_au(audio_bytes)
        if head == b"caff":
            return _decode_caf(audio_bytes)
        if head == b"fLaC":
            from .flac import decode_flac
            return decode_flac(audio_bytes)
    except (struct.error, IndexError, ValueError) as e:
        raise AudioDecodeError(f"corrupt audio container: {e}") from e
    kind = next((name for magic, name in _COMPRESSED
                 if audio_bytes.startswith(magic)), None)
    if kind is None and audio_bytes[0] == 0xFF \
            and (audio_bytes[1] & 0xE0) == 0xE0:
        kind = "MP3"  # raw MPEG frame sync, no ID3 tag
    if kind is not None:
        from .compressed import decode_compressed
        return decode_compressed(audio_bytes, kind)
    raise AudioDecodeError(f"unknown audio format; {_SUPPORTED}")


def encode_wav(audio: np.ndarray, sr: int) -> bytes:
    """Encode mono float audio to 16-bit PCM WAV bytes (for tests/tools)."""
    audio = np.asarray(audio, dtype=np.float32)
    pcm = np.clip(audio * 32767.0, -32768, 32767).astype("<i2").tobytes()
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    return hdr + pcm
