"""MP3 and Ogg fixtures written through ctypes, for the compressed-upload
tests and for the committed files of ``e2e/data/compressed/``.

MP3 comes from the system's ``libmp3lame`` and Ogg Vorbis and Ogg Opus from
the ``libsndfile`` that the pygame wheel bundles (``pygame.libs/``). Each
writer returns the file's bytes, or raises ``OSError`` when its library is
absent; ``lame()`` and ``sndfile()`` return None then, for skip marks.

Regenerate the committed files with ``python -m tests.compressed_fixtures``
(from the root of the repo).
"""
from __future__ import annotations

import ctypes
import ctypes.util
import glob
import os
import struct
import tempfile
import wave
from typing import Optional

import numpy as np

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REAL = os.path.join(ROOT, "e2e", "data", "real")
COMPRESSED = os.path.join(ROOT, "e2e", "data", "compressed")

_libs = {}


def _load(name: str, finder) -> Optional[ctypes.CDLL]:
    if name not in _libs:
        lib = None
        for path in finder():
            try:
                lib = ctypes.CDLL(path)
                break
            except OSError:
                continue
        _libs[name] = lib
    return _libs[name]


def lame() -> Optional[ctypes.CDLL]:
    def paths():
        found = ctypes.util.find_library("mp3lame")
        return ([found] if found else []) + ["libmp3lame.so.0"]
    lib = _load("lame", paths)
    if lib is not None and not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.lame_init.restype = vp
        for fn in ("lame_set_in_samplerate", "lame_set_out_samplerate",
                   "lame_set_num_channels", "lame_set_brate", "lame_set_mode",
                   "lame_set_VBR", "lame_set_VBR_q", "lame_set_quality",
                   "lame_set_error_protection", "lame_set_bWriteVbrTag",
                   "lame_init_params", "lame_close"):
            getattr(lib, fn).argtypes = [vp] + ([ctypes.c_int]
                                                if "set" in fn else [])
        lib.lame_encode_buffer_interleaved.argtypes = [
            vp, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.lame_encode_buffer.argtypes = [
            vp, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        lib.lame_encode_flush.argtypes = [vp, ctypes.c_void_p, ctypes.c_int]
        lib.lame_get_lametag_frame.argtypes = [vp, ctypes.c_void_p,
                                               ctypes.c_size_t]
        lib.lame_get_lametag_frame.restype = ctypes.c_size_t
        lib._typed = True
    return lib


def sndfile() -> Optional[ctypes.CDLL]:
    def paths():
        try:
            import pygame
        except ImportError:
            return []
        libs = os.path.join(os.path.dirname(pygame.__file__), "..",
                            "pygame.libs")
        return sorted(glob.glob(os.path.join(libs, "libsndfile-*.so*")))
    lib = _load("sndfile", paths)
    if lib is not None and not getattr(lib, "_typed", False):
        lib.sf_open.restype = ctypes.c_void_p
        lib.sf_open.argtypes = [ctypes.c_char_p, ctypes.c_int,
                                ctypes.POINTER(_SFInfo)]
        lib.sf_command.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_int]
        lib.sf_writef_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_int64]
        lib.sf_writef_float.restype = ctypes.c_int64
        lib.sf_close.argtypes = [ctypes.c_void_p]
        lib.sf_strerror.restype = ctypes.c_char_p
        lib.sf_strerror.argtypes = [ctypes.c_void_p]
        lib._typed = True
    return lib


class _SFInfo(ctypes.Structure):
    _fields_ = [("frames", ctypes.c_int64), ("samplerate", ctypes.c_int),
                ("channels", ctypes.c_int), ("format", ctypes.c_int),
                ("sections", ctypes.c_int), ("seekable", ctypes.c_int)]


# -- signals -------------------------------------------------------------------


def real_clip(name: str) -> np.ndarray:
    """A 16 kHz mono clip of ``e2e/data/real`` as float32."""
    with wave.open(os.path.join(REAL, name), "rb") as w:
        pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
    return pcm.astype(np.float32) / 32768.0


def resample_linear(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    n = int(round(len(x) * sr_out / sr_in))
    t = np.arange(n) * (sr_in / sr_out)
    return np.interp(t, np.arange(len(x)), x).astype(np.float32)


def make_signal(sr: int, seconds: float, channels: int, seed: int = 0,
                clicks: bool = False) -> np.ndarray:
    """[n, channels] float32: a FLEURS clip resampled to ``sr`` under tones
    and a little noise, each channel different; ``clicks`` adds sharp
    transients every 0.25 s, which make the encoder switch to short
    blocks."""
    rng = np.random.default_rng(seed)
    n = int(round(sr * seconds))
    speech = resample_linear(real_clip("english_01.wav"), 16000, sr)
    speech = np.resize(speech, n)
    t = np.arange(n) / sr
    out = np.empty((n, channels), np.float32)
    for c in range(channels):
        f = 220.0 * (1 + c) + 37.0 * c
        x = 0.6 * np.roll(speech, 97 * c) + 0.15 * np.sin(2 * np.pi * f * t) \
            + 0.01 * rng.standard_normal(n)
        if clicks:
            for k in range(int(seconds * 4)):
                at = int((k + 0.5) * sr / 4) + 13 * c
                x[at:at + 8] += 0.8 * np.sign(rng.standard_normal(8))
        out[:, c] = x
    return np.clip(out, -0.99, 0.99)


# -- MP3 through libmp3lame ---------------------------------------------------


MODES = {"stereo": 0, "joint": 1, "mono": 3}


def encode_mp3(x: np.ndarray, sr: int, bitrate: int = 128,
               mode: str = "joint", vbr: bool = False, crc: bool = False,
               tag: bool = True, quality: int = 2, vbr_q: int = 4) -> bytes:
    """``x`` [n, channels] float in [-1, 1] → an MP3 file. ``tag`` writes
    LAME's Xing/Info frame (the gapless delay and padding) over the first
    frame, as the lame front end does."""
    lib = lame()
    if lib is None:
        raise OSError("libmp3lame not found")
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    pcm = np.ascontiguousarray(np.clip(np.round(x * 32767), -32768, 32767)
                               .astype(np.int16))
    g = lib.lame_init()
    try:
        lib.lame_set_in_samplerate(g, sr)
        lib.lame_set_out_samplerate(g, sr)
        lib.lame_set_num_channels(g, ch)
        lib.lame_set_mode(g, MODES["mono" if ch == 1 else mode])
        lib.lame_set_quality(g, quality)
        lib.lame_set_error_protection(g, int(crc))
        lib.lame_set_bWriteVbrTag(g, int(tag))
        if vbr:
            lib.lame_set_VBR(g, 4)
            lib.lame_set_VBR_q(g, vbr_q)
        else:
            lib.lame_set_VBR(g, 0)
            lib.lame_set_brate(g, bitrate)
        if lib.lame_init_params(g) < 0:
            raise ValueError(f"lame refused sr={sr} ch={ch} "
                             f"bitrate={bitrate}")
        cap = int(1.25 * n + 7200) * 2
        buf = ctypes.create_string_buffer(cap)
        if ch == 1:
            got = lib.lame_encode_buffer(g, pcm.ctypes.data, pcm.ctypes.data,
                                         n, buf, cap)
        else:
            got = lib.lame_encode_buffer_interleaved(g, pcm.ctypes.data, n,
                                                     buf, cap)
        if got < 0:
            raise ValueError(f"lame_encode_buffer: {got}")
        out = bytearray(buf.raw[:got])
        got = lib.lame_encode_flush(g, buf, cap)
        out += buf.raw[:got]
        if tag:
            frame = ctypes.create_string_buffer(4096)
            size = lib.lame_get_lametag_frame(g, frame, 4096)
            if 0 < size <= len(out):
                out[:size] = frame.raw[:size]
        return bytes(out)
    finally:
        lib.lame_close(g)


def id3v2(body_size: int = 300, footer: bool = False) -> bytes:
    """An ID3v2.4 tag of one TIT2 frame padded to ``body_size`` bytes."""
    text = b"\x03fixture title"
    frame = b"TIT2" + struct.pack(">I", len(text)) + b"\x00\x00" + text
    body = frame + bytes(body_size - len(frame))
    size = bytes([(body_size >> 21) & 0x7F, (body_size >> 14) & 0x7F,
                  (body_size >> 7) & 0x7F, body_size & 0x7F])
    flags = 0x10 if footer else 0
    out = b"ID3\x04\x00" + bytes([flags]) + size + body
    if footer:
        out += b"3DI\x04\x00" + bytes([flags]) + size
    return out


def id3v1() -> bytes:
    return b"TAG" + b"fixture".ljust(30, b"\x00") + bytes(95)


# -- Ogg through libsndfile ------------------------------------------------------


SF_FORMAT_OGG, SF_FORMAT_VORBIS, SF_FORMAT_OPUS = 0x200000, 0x0060, 0x0064
SFC_SET_VBR_ENCODING_QUALITY = 0x1300


def encode_ogg(x: np.ndarray, sr: int, codec: str = "vorbis",
               quality: float = 0.4) -> bytes:
    """``x`` [n, channels] float → an Ogg Vorbis (or Opus) file.
    ``quality`` is libsndfile's VBR quality in [0, 1]."""
    lib = sndfile()
    if lib is None:
        raise OSError("libsndfile not found")
    x = np.ascontiguousarray(np.asarray(x, np.float32))
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    sub = SF_FORMAT_VORBIS if codec == "vorbis" else SF_FORMAT_OPUS
    info = _SFInfo(0, sr, ch, SF_FORMAT_OGG | sub, 0, 0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "x.ogg").encode()
        f = lib.sf_open(path, 0x20, ctypes.byref(info))
        if not f:
            raise ValueError(f"sf_open: {lib.sf_strerror(None).decode()}")
        try:
            q = ctypes.c_double(quality)
            lib.sf_command(f, SFC_SET_VBR_ENCODING_QUALITY,
                           ctypes.byref(q), 8)
            if lib.sf_writef_float(f, x.ctypes.data, n) != n:
                raise ValueError("sf_writef_float wrote short")
        finally:
            lib.sf_close(f)
        with open(path, "rb") as fh:
            return fh.read()


# -- Ogg Vorbis written by hand ---------------------------------------------------


def _ogg_crc(page: bytes) -> int:
    """Ogg's CRC-32: polynomial 0x04C11DB7, MSB first, no final xor."""
    crc = 0
    for b in page:
        crc ^= b << 24
        for _ in range(8):
            crc = ((crc << 1) ^ 0x04C11DB7) if crc & 0x80000000 else crc << 1
            crc &= 0xFFFFFFFF
    return crc


def ogg_stream(packets, serial: int = 1, granule: int = 0) -> bytes:
    """One logical stream: the first packet alone on a beginning-of-stream
    page, the rest on pages of up to 255 lacing values, the last page
    marked end of stream with granule position ``granule`` (the others
    -1)."""
    pages, lacing, body = [[packets[0]]], [], []
    for p in packets[1:]:
        need = len(p) // 255 + 1
        if len(lacing) + need > 255:
            pages.append(body)
            lacing, body = [], []
        lacing += [255] * (len(p) // 255) + [len(p) % 255]
        body.append(p)
    pages.append(body)
    out = bytearray()
    for seq, page in enumerate(pages):
        lace = b"".join(bytes([255] * (len(p) // 255) + [len(p) % 255])
                        for p in page)
        flags = (2 if seq == 0 else 0) | (4 if seq == len(pages) - 1 else 0)
        gran = granule if seq == len(pages) - 1 else -1
        head = b"OggS" + bytes([0, flags]) + struct.pack(
            "<qIII", gran, serial, seq, 0) + bytes([len(lace)]) + lace
        raw = head + b"".join(page)
        out += raw[:22] + struct.pack("<I", _ogg_crc(raw)) + raw[26:]
    return bytes(out)


class _BitWriter:
    """Vorbis's bit packing: LSB first."""

    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> "_BitWriter":
        self.bits += [(value >> k) & 1 for k in range(n)]
        return self

    def bytes(self) -> bytes:
        b = self.bits + [0] * (-len(self.bits) % 8)
        return bytes(sum(b[i + k] << k for k in range(8))
                     for i in range(0, len(b), 8))


def vorbis_silence(channels: int, packets: int, rate: int = 44100,
                   blocksizes=(256, 2048)) -> bytes:
    """An Ogg Vorbis file of ``packets`` long blocks of silence, each audio
    packet one byte: a setup of one two-entry codebook, a floor 1 with no
    partitions, one residue 1 that codes nothing, one mapping and one long
    mode, and packets whose floors are all unused. ``packets`` long blocks
    return (packets - 1) * blocksize / 2 samples; the header allows any
    channel count up to 255."""
    b0, b1 = (int(np.log2(b)) for b in blocksizes)
    ident = b"\x01vorbis" + struct.pack("<IBIiii", 0, channels, rate, 0, 0,
                                        0) + bytes([b1 << 4 | b0, 1])
    comment = b"\x03vorbis" + struct.pack("<II", 0, 0) + b"\x01"
    w = _BitWriter()
    w.put(0, 8)  # one codebook
    w.put(0x564342, 24).put(1, 16).put(2, 24).put(0, 1).put(0, 1)
    w.put(0, 5).put(0, 5).put(0, 4)  # lengths 1 and 1, no lookup
    w.put(0, 6).put(0, 16)  # one time-domain transform
    w.put(0, 6).put(1, 16)  # one floor 1:
    w.put(0, 5).put(0, 2).put(8, 4)  # no partitions, multiplier 1
    w.put(0, 6).put(1, 16)  # one residue 1:
    w.put(0, 24).put(0, 24).put(0, 24).put(0, 6).put(0, 8).put(0, 3).put(0, 1)
    w.put(0, 6).put(0, 16).put(0, 1).put(0, 1).put(0, 2)  # one mapping
    w.put(0, 8).put(0, 8).put(0, 8)  # its submap: floor 0, residue 0
    w.put(0, 6).put(1, 1).put(0, 16).put(0, 16).put(0, 8)  # one long mode
    w.put(1, 1)  # framing
    setup = b"\x05vorbis" + w.bytes()
    samples = (packets - 1) * blocksizes[1] // 2
    return ogg_stream([ident, comment, setup] + [b"\x00"] * packets,
                      granule=samples)


# -- the committed files -------------------------------------------------------


# chip_smoke.py phase 16 (a'): (a)'s clips (every third of e2e/data/real)
# as MP3 and Ogg Vorbis at their own 16 kHz, mono; (b'): ~29.5 s of the
# clips at 44.1 kHz stereo.
SMOKE_CLIPS = tuple(sorted(f for f in os.listdir(REAL)
                           if f.endswith(".wav"))[::3])
LONG_SOURCES = ("english_01.wav", "english_02.wav", "chinese_01.wav",
                "hindi_01.wav", "japanese_01.wav", "cantonese_01.wav")


def long_stereo(seconds: float = 29.5, sr: int = 44100) -> np.ndarray:
    """[n, 2]: FLEURS clips one after another, resampled to ``sr``; the
    right channel is the left one 0.35 s later, a little quieter."""
    x = np.concatenate([real_clip(c) for c in LONG_SOURCES])
    x = resample_linear(x, 16000, sr)
    n = int(seconds * sr)
    x = np.resize(x, n)
    right = 0.8 * np.roll(x, int(0.35 * sr))
    return np.clip(np.stack([x, right], 1), -0.99, 0.99)


def write_committed() -> None:
    os.makedirs(COMPRESSED, exist_ok=True)
    for clip in SMOKE_CLIPS:
        x = real_clip(clip)
        stem = clip[:-4]
        with open(os.path.join(COMPRESSED, stem + ".mp3"), "wb") as f:
            f.write(encode_mp3(x, 16000, bitrate=32))
        with open(os.path.join(COMPRESSED, stem + ".ogg"), "wb") as f:
            f.write(encode_ogg(x, 16000, quality=0.2))
    y = long_stereo()
    with open(os.path.join(COMPRESSED, "long_44k_stereo.mp3"), "wb") as f:
        f.write(encode_mp3(y, 44100, bitrate=64, mode="joint"))
    with open(os.path.join(COMPRESSED, "long_44k_stereo.ogg"), "wb") as f:
        f.write(encode_ogg(y, 44100, quality=0.0))


if __name__ == "__main__":
    write_committed()
