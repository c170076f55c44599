"""MPEG audio, Ogg Vorbis and Ogg Opus uploads through the port's own
decoders.

Counterpart of ``qwen3_asr_tpu/audio/compressed.py``, which decodes these
formats through pygame's SDL_mixer (mpg123, libvorbisfile and opusfile over
libopus behind it). The port links no codec library: MPEG audio Layer III
decodes in ``audio/mp3.py`` and Layer I/II in ``audio/mpa.py``, Ogg Vorbis
in ``audio/ogg.py`` and ``audio/vorbis.py``, and Ogg Opus in
``audio/ogg_opus.py`` (``audio/opus.py``, ``audio/celt.py``,
``audio/silk.py``), their bit loops in C++ (``audio/native.py``).

``decode_compressed`` takes JAX's steps in JAX's order: sniff the stream's
rate from its first header (``sniff_mp3``, ``sniff_ogg``: the port's
copies of JAX's), check it, decode, average to mono (block by block, as the
decoders go), and refuse an empty stream. The samples are
JAX's: 16-bit values over 32768, stereo averaged in float32; a Vorbis or
Opus stream of 3-8 channels is folded to stereo with the weights of SDL's
conversion (``SDL_STEREO_LEFT``) before the mean. Opus decodes at 48 kHz;
its 16-bit values are opusfile's (soft clip, noise-shaped dither). The rate returned is
the stream's own (JAX returns the sniffed one, which SDL converts to;
they differ only where the first header is not the stream's).

What the port refuses with ``UnsupportedFormatError``, naming the feature:
MP3 intensity stereo, Vorbis floor 0, chained Ogg streams, Opus channel
mapping family 255 and more than 8 channels. It decodes an MPEG Layer I/II
stream with no ID3v2 tag in front, which SDL_mixer does not recognise.
"""
from __future__ import annotations

import struct
from typing import Optional, Tuple

import numpy as np

from .codec import _SUPPORTED, AudioDecodeError, check_stream_params

# MPEG audio sample-rate table, indexed by version bits (header bits 19-20):
# 0 = MPEG2.5, 2 = MPEG2, 3 = MPEG1 (1 is reserved).
_MPEG_SR = {
    3: (44100, 48000, 32000),
    2: (22050, 24000, 16000),
    0: (11025, 12000, 8000),
}

# SDL's conversion of 3-8 channels to stereo: for each of its layouts
# (2.1, quad, 4.1, 5.1, 6.1, 7.1) the weights of the left output on the
# channels, in SDL's order; the right output mirrors them (FL <-> FR and
# the other pairs). SDL_mixer hands SDL a Vorbis stream's channels in
# Vorbis's order, which SDL reads as its own, so the weights apply to the
# file's channel positions as they stand.
SDL_STEREO_LEFT = {
    3: ((0, 0.8), (2, 0.2)),
    4: ((0, 0.421000004), (2, 0.578999996)),
    5: ((0, 0.374222219), (2, 0.111111112), (3, 0.514666677)),
    6: ((0, 0.294545455), (2, 0.208181820), (3, 0.090909094),
        (4, 0.406363636)),
    7: ((0, 0.247384623), (2, 0.174461529), (3, 0.076923080),
        (4, 0.174461529), (5, 0.326769233)),
    8: ((0, 0.211866662), (2, 0.150266662), (3, 0.066666670),
        (4, 0.292133331), (6, 0.280000001)),
}
# the channel each left weight's channel mirrors to, per layout
_SDL_MIRROR = {3: {0: 1}, 4: {0: 1, 2: 3}, 5: {0: 1, 3: 4},
               6: {0: 1, 4: 5}, 7: {0: 1, 5: 6}, 8: {0: 1, 4: 5, 6: 7}}


def sniff_mp3(data: bytes, scan_limit: int = 1 << 16
              ) -> Optional[Tuple[int, int]]:
    """Parse the first valid MPEG audio frame header → (sample_rate,
    channels), or None. Pure header math — no decoding."""
    pos = 0
    if data[:3] == b"ID3" and len(data) >= 10:
        tag_size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        pos = 10 + tag_size
    end = min(len(data) - 4, pos + scan_limit)
    while pos < end:
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            version = (data[pos + 1] >> 3) & 3
            layer = (data[pos + 1] >> 1) & 3
            bitrate_idx = (data[pos + 2] >> 4) & 15
            sr_idx = (data[pos + 2] >> 2) & 3
            mode = (data[pos + 3] >> 6) & 3
            if version != 1 and layer != 0 and 0 < bitrate_idx < 15 \
                    and sr_idx != 3:
                return _MPEG_SR[version][sr_idx], (1 if mode == 3 else 2)
        pos += 1
    return None


def sniff_ogg(data: bytes) -> Optional[Tuple[int, int]]:
    """Parse the first Ogg page's codec identification header →
    (sample_rate, channels), or None. Handles Vorbis and Opus (Opus always
    DECODES at 48 kHz regardless of the original input rate)."""
    if data[:4] != b"OggS" or len(data) < 28:
        return None
    n_segments = data[26]
    payload = 27 + n_segments
    ident = data[payload:payload + 8]
    if ident.startswith(b"\x01vorbis") and len(data) >= payload + 16:
        channels = data[payload + 11]
        (sr,) = struct.unpack("<I", data[payload + 12:payload + 16])
        return sr, channels
    if ident.startswith(b"OpusHead") and len(data) >= payload + 10:
        channels = data[payload + 9]
        return 48000, channels  # Opus output rate is always 48 kHz
    return None


def _is_opus(data: bytes) -> bool:
    if data[:4] != b"OggS" or len(data) < 28:
        return False
    payload = 27 + data[26]
    return data[payload:payload + 8] == b"OpusHead"


def to_mono(pcm: np.ndarray) -> np.ndarray:
    """[n, channels] float32 → mono as JAX's decode makes it: one channel
    as it is, two averaged in float32, 3-8 folded to stereo as SDL folds
    them (float32 sums, then rounded to 16 bits at 32767 a unit) and then
    averaged."""
    ch = pcm.shape[1]
    if ch == 1:
        return pcm[:, 0]
    if ch == 2:
        return pcm.mean(axis=1)
    x = pcm.astype(np.float32)
    sides = []
    for right in (False, True):
        acc = np.zeros(len(x), np.float32)
        for c, w in SDL_STEREO_LEFT[ch]:
            if right:
                c = _SDL_MIRROR[ch].get(c, c)
            acc += x[:, c] * np.float32(w)
        acc = np.clip(acc, -1.0, 1.0) * np.float32(32767.0)
        sides.append(np.round(acc).astype(np.float32) / np.float32(32768.0))
    return np.stack(sides, 1).mean(axis=1)


def decode_compressed(data: bytes, kind: str) -> Tuple[np.ndarray, int]:
    """Decode MP3/OGG bytes → (mono float32 in [-1, 1], native sample rate).

    kind: "MP3" | "OGG" (from the container magic — see codec.decode_audio).
    """
    sniffed = sniff_mp3(data) if kind == "MP3" else sniff_ogg(data)
    sr, _ = sniffed if sniffed else (44100, 2)
    check_stream_params(sr)  # sniffed rate is attacker-controlled header data
    try:
        if kind == "MP3":
            from .mp3 import decode_mp3
            audio, sr = decode_mp3(data, fold=to_mono)
        else:
            if _is_opus(data):
                from .ogg_opus import decode_ogg_opus
                audio, sr = decode_ogg_opus(data, fold=to_mono)
            else:
                from .vorbis import decode_vorbis
                audio, sr = decode_vorbis(data, fold=to_mono)
        check_stream_params(sr)
    except AudioDecodeError:
        raise
    except (struct.error, IndexError, ValueError, OverflowError,
            MemoryError) as e:
        raise AudioDecodeError(
            f"corrupt {kind} stream: {e}; {_SUPPORTED}") from e
    if audio.size == 0:
        raise AudioDecodeError(f"empty {kind} stream")
    return audio, sr
