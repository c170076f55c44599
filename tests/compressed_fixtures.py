"""MPEG audio and Ogg fixtures written through ctypes, for the
compressed-upload tests and for the committed files of
``e2e/data/compressed/``.

MP3 comes from the system's ``libmp3lame``, MPEG Layer II from
``libtwolame``, Ogg Vorbis and Ogg Opus from the ``libsndfile`` that the
pygame wheel bundles (``pygame.libs/``), and Ogg Opus of a chosen mode and
layout from that wheel's libopus into RFC 7845 pages; Layer I and Vorbis
silence are written by hand. Each writer returns the file's bytes, or
raises ``OSError`` when its library is absent; ``lame()``, ``sndfile()``,
``twolame()`` and ``opus()`` return None then, for skip marks.

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


# -- MPEG audio Layer II through libtwolame, Layer I by hand ---------------------


def twolame() -> Optional[ctypes.CDLL]:
    def paths():
        found = ctypes.util.find_library("twolame")
        return ([found] if found else []) + ["libtwolame.so.0"]
    lib = _load("twolame", paths)
    if lib is not None and not getattr(lib, "_typed", False):
        vp = ctypes.c_void_p
        lib.twolame_init.restype = vp
        for fn in ("twolame_set_num_channels", "twolame_set_in_samplerate",
                   "twolame_set_out_samplerate", "twolame_set_bitrate",
                   "twolame_set_mode", "twolame_set_version",
                   "twolame_set_error_protection", "twolame_init_params"):
            getattr(lib, fn).argtypes = [vp] + ([ctypes.c_int]
                                                if "set" in fn else [])
        lib.twolame_encode_buffer_interleaved.argtypes = [
            vp, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int]
        lib.twolame_encode_flush.argtypes = [vp, ctypes.c_void_p,
                                             ctypes.c_int]
        lib.twolame_close.argtypes = [ctypes.POINTER(vp)]
        lib._typed = True
    return lib


def encode_mp2(x: np.ndarray, sr: int, bitrate: int = 128,
               mode: str = "joint", crc: bool = False) -> bytes:
    """``x`` [n, channels] float in [-1, 1] → an MPEG audio Layer II
    stream: MPEG-1 at 32, 44.1 and 48 kHz, MPEG-2 LSF at 16, 22.05 and
    24 kHz; ``mode`` as ``encode_mp3``'s."""
    lib = twolame()
    if lib is None:
        raise OSError("libtwolame not found")
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    pcm = np.ascontiguousarray(np.clip(np.round(x * 32767), -32768, 32767)
                               .astype(np.int16))
    g = ctypes.c_void_p(lib.twolame_init())
    try:
        lib.twolame_set_num_channels(g, ch)
        lib.twolame_set_in_samplerate(g, sr)
        lib.twolame_set_out_samplerate(g, sr)
        lib.twolame_set_version(g, 1 if sr >= 32000 else 0)
        lib.twolame_set_mode(g, MODES["mono" if ch == 1 else mode])
        lib.twolame_set_bitrate(g, bitrate)
        lib.twolame_set_error_protection(g, int(crc))
        if lib.twolame_init_params(g) != 0:
            raise ValueError(f"twolame refused sr={sr} ch={ch} "
                             f"bitrate={bitrate}")
        cap = n * 2 + 16384
        buf = ctypes.create_string_buffer(cap)
        got = lib.twolame_encode_buffer_interleaved(g, pcm.ctypes.data, n,
                                                    buf, cap)
        if got < 0:
            raise ValueError(f"twolame_encode_buffer: {got}")
        out = bytearray(buf.raw[:got])
        got = lib.twolame_encode_flush(g, buf, cap)
        out += buf.raw[:max(got, 0)]
        return bytes(out)
    finally:
        lib.twolame_close(ctypes.byref(g))


_L1_BITRATES = {0: (0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352,
                    384, 416, 448),
                1: (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192,
                    224, 256)}
_MPA_RATES = {44100: (3, 0), 48000: (3, 1), 32000: (3, 2), 22050: (2, 0),
              24000: (2, 1), 16000: (2, 2)}


def mpa_crc(data: bytes, n_bits: int, crc: int = 0xFFFF) -> int:
    """The MPEG audio frame CRC: polynomial 0x8005, MSB first, over the
    first ``n_bits`` of ``data``."""
    for k in range(n_bits):
        bit = (data[k >> 3] >> (7 - (k & 7))) & 1
        top = (crc >> 15) & 1
        crc = (crc << 1) & 0xFFFF
        if top ^ bit:
            crc ^= 0x8005
    return crc


class _MsbWriter:
    def __init__(self):
        self.bits = []

    def put(self, value: int, n: int) -> "_MsbWriter":
        self.bits += [(value >> (n - 1 - k)) & 1 for k in range(n)]
        return self

    def bytes(self, size: int) -> bytes:
        b = self.bits + [0] * (8 * size - len(self.bits))
        return bytes(sum(b[i + k] << (7 - k) for k in range(8))
                     for i in range(0, len(b), 8))


def layer1_stream(frames: int, sr: int = 32000, channels: int = 2,
                  bitrate_index: int = 12, joint_bound: Optional[int] = None,
                  crc: bool = False, seed: int = 0) -> bytes:
    """A Layer I stream written by hand: ``frames`` frames of seeded
    random bit allocations (0-14), scale factors (0-62) and sample codes
    (never all ones), each frame filled up to its size. ``joint_bound``
    (4, 8, 12 or 16) writes joint stereo with that intensity bound;
    MPEG-1 at 32-48 kHz, MPEG-2 LSF below."""
    rng = np.random.default_rng(seed)
    version, sr_idx = _MPA_RATES[sr]
    lsf = int(version == 2)
    bitrate = _L1_BITRATES[lsf][bitrate_index]
    if channels == 1:
        mode, ext, bound = 3, 0, 32
    elif joint_bound is None:
        mode, ext, bound = 0, 0, 32
    else:
        mode, ext, bound = 1, joint_bound // 4 - 1, joint_bound
    out = bytearray()
    for f in range(frames):
        pad = f % 3 == 1 and sr == 44100
        size = (12 * bitrate * 1000 // sr + pad) * 4
        head = bytes([0xFF, 0xE0 | version << 3 | 3 << 1 | (0 if crc else 1),
                      bitrate_index << 4 | sr_idx << 2 | pad << 1,
                      mode << 6 | ext << 4])
        budget = 8 * (size - 4 - 2 * crc)
        w = _MsbWriter()
        alloc = np.zeros((32, channels), int)
        for sb in range(32):
            for c in range(channels if sb < bound else 1):
                alloc[sb, c] = rng.integers(0, 15) if rng.random() < 0.7 \
                    else 0
            if sb >= bound:
                alloc[sb, 1:] = alloc[sb, 0]
        # fewer bits where the frame cannot hold them
        while True:
            need = sum(4 * (channels if sb < bound else 1)
                       for sb in range(32))
            need += 6 * int((alloc > 0).sum())
            need += 12 * sum(int(alloc[sb, c] + 1) if alloc[sb, c] else 0
                             for sb in range(32)
                             for c in range(channels if sb < bound else 1))
            if need <= budget:
                break
            alloc = np.maximum(alloc - 1, 0)
        for sb in range(32):
            for c in range(channels if sb < bound else 1):
                w.put(int(alloc[sb, c]), 4)
        n_crc = 16 + len(w.bits)
        for sb in range(32):
            for c in range(channels):
                if alloc[sb, c]:
                    w.put(int(rng.integers(0, 63)), 6)
        for _ in range(12):
            for sb in range(32):
                for c in range(channels if sb < bound else 1):
                    nb = int(alloc[sb, c])
                    if nb:
                        w.put(int(rng.integers(0, (1 << (nb + 1)) - 1)),
                              nb + 1)
        body = w.bytes(size - 4 - 2 * crc)
        if crc:
            c16 = mpa_crc(head[2:] + body, n_crc)
            out += head + struct.pack(">H", c16) + body
        else:
            out += head + body
    return bytes(out)


# -- Ogg Opus through libopus ------------------------------------------------------


def opus() -> Optional[ctypes.CDLL]:
    """The libopus of ``pygame.libs`` (1.3.1, the one opusfile decodes
    with for JAX), or the system's."""
    def paths():
        out = []
        try:
            import pygame
            libs = os.path.join(os.path.dirname(pygame.__file__), "..",
                                "pygame.libs")
            out += sorted(glob.glob(os.path.join(libs, "libopus-*.so*")))
        except ImportError:
            pass
        return out + ["libopus.so.0"]
    lib = _load("opus", paths)
    if lib is not None and not getattr(lib, "_typed", False):
        vp, ip = ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)
        lib.opus_encoder_create.restype = vp
        lib.opus_encoder_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_int, ip]
        lib.opus_encode_float.argtypes = [vp, ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_void_p, ctypes.c_int32]
        lib.opus_encoder_destroy.argtypes = [vp]
        lib.opus_multistream_surround_encoder_create.restype = vp
        lib.opus_multistream_surround_encoder_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ip, ip,
            ctypes.c_void_p, ctypes.c_int, ip]
        lib.opus_multistream_encode_float.argtypes = [
            vp, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_int32]
        lib.opus_multistream_encoder_destroy.argtypes = [vp]
        lib.opus_decoder_create.restype = vp
        lib.opus_decoder_create.argtypes = [ctypes.c_int, ctypes.c_int, ip]
        lib.opus_decode_float.argtypes = [vp, ctypes.c_void_p, ctypes.c_int32,
                                          ctypes.c_void_p, ctypes.c_int,
                                          ctypes.c_int]
        lib.opus_decoder_destroy.argtypes = [vp]
        lib.opus_multistream_decoder_create.restype = vp
        lib.opus_multistream_decoder_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ip]
        lib.opus_multistream_decode_float.argtypes = [
            vp, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int]
        lib.opus_multistream_decoder_destroy.argtypes = [vp]
        lib._typed = True
    return lib


OPUS_APPLICATIONS = {"voip": 2048, "audio": 2049, "lowdelay": 2051}
_OPUS_MODES = {"silk": 1000, "hybrid": 1001, "celt": 1002}
_OPUS_BANDWIDTHS = {"nb": 1101, "mb": 1102, "wb": 1103, "swb": 1104,
                    "fb": 1105}
_OPUS_FRAMES = {2.5: 5001, 5: 5002, 10: 5003, 20: 5004, 40: 5005, 60: 5006}


def _opus_ctl(lib, enc, multi: bool, request: int, *args) -> None:
    fn = lib.opus_multistream_encoder_ctl if multi else lib.opus_encoder_ctl
    ret = fn(ctypes.c_void_p(enc), ctypes.c_int(request),
             *[ctypes.c_int(a) if isinstance(a, int) else a for a in args])
    if ret != 0:
        raise ValueError(f"opus ctl {request}: {ret}")


def opus_packets(x: np.ndarray, sr: int, application: str = "audio",
                 bitrate: int = 64000, frame_ms: float = 20,
                 mode: Optional[str] = None, bandwidth: Optional[str] = None,
                 vbr: bool = True, complexity: int = 10, dtx: bool = False):
    """``x`` [n, channels] float → (packets, pre-skip, family, streams,
    coupled, mapping): one libopus packet every ``frame_ms``; 1-2
    channels through one encoder (family 0), 3-6 through the multistream
    surround encoder (family 1). ``mode`` and ``bandwidth`` force the
    encoder's (``silk``, ``hybrid``, ``celt``; ``nb`` to ``fb``); ``dtx``
    lets it send packets of no payload through silence."""
    lib = opus()
    if lib is None:
        raise OSError("libopus not found")
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    n, ch = x.shape
    err = ctypes.c_int(0)
    multi = ch > 2
    app = OPUS_APPLICATIONS[application]
    if multi:
        streams, coupled = ctypes.c_int(0), ctypes.c_int(0)
        mapping = (ctypes.c_ubyte * ch)()
        enc = lib.opus_multistream_surround_encoder_create(
            sr, ch, 1, ctypes.byref(streams), ctypes.byref(coupled),
            mapping, app, ctypes.byref(err))
        family, layout = 1, (streams.value, coupled.value, bytes(mapping))
    else:
        enc = lib.opus_encoder_create(sr, ch, app, ctypes.byref(err))
        family, layout = 0, (1, ch - 1, bytes(range(ch)))
    if not enc or err.value:
        raise ValueError(f"opus encoder: {err.value}")
    try:
        _opus_ctl(lib, enc, multi, 4002, bitrate)
        _opus_ctl(lib, enc, multi, 4006, int(vbr))
        _opus_ctl(lib, enc, multi, 4010, complexity)
        _opus_ctl(lib, enc, multi, 4040, _OPUS_FRAMES[frame_ms])
        if dtx:
            _opus_ctl(lib, enc, multi, 4016, 1)
        if mode:
            _opus_ctl(lib, enc, multi, 11002, _OPUS_MODES[mode])
        if bandwidth:
            _opus_ctl(lib, enc, multi, 4008, _OPUS_BANDWIDTHS[bandwidth])
        look = ctypes.c_int(0)
        _opus_ctl(lib, enc, multi, 4027, ctypes.byref(look))
        pre_skip = look.value * 48000 // sr
        step = int(round(sr * frame_ms / 1000))
        pad = np.zeros((-n % step + step, ch), np.float32)
        x = np.concatenate([x, pad])
        buf = ctypes.create_string_buffer(4000 * max(1, ch))
        packets = []
        encode = (lib.opus_multistream_encode_float if multi
                  else lib.opus_encode_float)
        for a in range(0, len(x), step):
            frame = np.ascontiguousarray(x[a:a + step])
            got = encode(ctypes.c_void_p(enc), frame.ctypes.data, step, buf,
                         len(buf))
            if got < 0:
                raise ValueError(f"opus encode: {got}")
            packets.append(buf.raw[:got])
        return packets, pre_skip, family, layout, n * 48000 // sr
    finally:
        (lib.opus_multistream_encoder_destroy if multi
         else lib.opus_encoder_destroy)(ctypes.c_void_p(enc))


def opus_switching_packets(x: np.ndarray, sr: int, segments,
                           application: str = "audio") -> list:
    """``x`` [n, channels] through one libopus encoder whose mode and
    bitrate change between segments: [(seconds, mode or None, bitrate)],
    20 ms a packet. The encoder switches with its redundancy frames."""
    lib = opus()
    if lib is None:
        raise OSError("libopus not found")
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    err = ctypes.c_int(0)
    enc = lib.opus_encoder_create(sr, x.shape[1],
                                  OPUS_APPLICATIONS[application],
                                  ctypes.byref(err))
    if not enc or err.value:
        raise ValueError(f"opus encoder: {err.value}")
    try:
        _opus_ctl(lib, enc, False, 4040, _OPUS_FRAMES[20])
        step = sr // 50
        buf = ctypes.create_string_buffer(4000)
        packets, pos = [], 0
        for seconds, mode, bitrate in segments:
            _opus_ctl(lib, enc, False, 11002,
                      _OPUS_MODES[mode] if mode else -1000)
            _opus_ctl(lib, enc, False, 4002, bitrate)
            end = min(len(x), pos + int(seconds * sr))
            while pos + step <= end:
                frame = np.ascontiguousarray(x[pos:pos + step])
                got = lib.opus_encode_float(ctypes.c_void_p(enc),
                                            frame.ctypes.data, step, buf,
                                            len(buf))
                if got < 0:
                    raise ValueError(f"opus encode: {got}")
                packets.append(buf.raw[:got])
                pos += step
        return packets
    finally:
        lib.opus_encoder_destroy(ctypes.c_void_p(enc))


def _opus_size(n: int) -> bytes:
    if n < 252:
        return bytes([n])
    first = 252 + (n & 3)
    return bytes([first, (n - first) >> 2])


def opus_combine(packets, code: int, pad: int = 0) -> list:
    """Single-frame packets regrouped into code 1 (two frames of one
    length), code 2 (two frames, the first's length written) or code 3
    (three frames, VBR lengths, ``pad`` bytes of padding) packets, RFC 6716
    §3.2; frames that cannot pair stay as they were."""
    per = 2 if code in (1, 2) else 3
    out, i = [], 0
    while i + per <= len(packets):
        group = packets[i:i + per]
        frames = [p[1:] for p in group]
        toc = group[0][0] & ~3
        if any(p[0] & 3 for p in group) or any(p[0] & ~3 != toc
                                               for p in group) or (
                code == 1 and len({len(f) for f in frames}) != 1):
            out.append(group[0])
            i += 1
            continue
        if code == 1:
            out.append(bytes([toc | 1]) + b"".join(frames))
        elif code == 2:
            out.append(bytes([toc | 2]) + _opus_size(len(frames[0]))
                       + b"".join(frames))
        else:
            padding = b""
            left = pad
            if pad:
                while left >= 255:
                    padding += b"\xff"
                    left -= 254
                padding += bytes([left])
            out.append(bytes([toc | 3, per | 0x80 | (0x40 if pad else 0)])
                       + padding + b"".join(_opus_size(len(f))
                                            for f in frames[:-1])
                       + b"".join(frames) + bytes(pad))
        i += per
    return out + list(packets[i:])


def opus_packet_samples(packet: bytes) -> int:
    """A packet's samples at 48 kHz, from its TOC (RFC 6716 §3.1)."""
    toc = packet[0]
    config = toc >> 3
    if config < 12:
        size = (480, 960, 1920, 2880)[config & 3]
    elif config < 16:
        size = (480, 960)[config & 1]
    else:
        size = (120, 240, 480, 960)[config & 3]
    code = toc & 3
    count = 1 if code == 0 else 2 if code in (1, 2) else packet[1] & 63
    return size * count


def ogg_opus_stream(packets, channels: int, pre_skip: int = 312,
                    samples: Optional[int] = None, serial: int = 1,
                    gain: int = 0, rate: int = 48000, family: int = 0,
                    layout=None, start: int = 0,
                    page_ms: float = 1000) -> bytes:
    """An Ogg Opus file laid out as RFC 7845 §3 asks: OpusHead alone on
    the first page, OpusTags alone on the second, the audio from the third
    on, about ``page_ms`` of packets a page, each page's granule position
    the samples of the packets it completes (plus ``start``, a starting
    granule), the last page's ``start + pre_skip + samples`` (the end
    trim). ``gain`` is the header's output gain in Q7.8 dB."""
    head = b"OpusHead" + struct.pack("<BBHIhB", 1, channels, pre_skip, rate,
                                     gain, family)
    if family:
        streams, coupled, mapping = layout
        head += bytes([streams, coupled]) + bytes(mapping)
    tags = b"OpusTags" + struct.pack("<I", 7) + b"fixture" \
        + struct.pack("<I", 0)
    pages = [(head, 0), (tags, 0)]
    out = bytearray()
    gran, body = start, []
    per_page = max(1, int(page_ms * 48))
    acc = 0
    for i, p in enumerate(packets):
        body.append(p)
        gran += opus_packet_samples(p)
        acc += opus_packet_samples(p)
        last = i == len(packets) - 1
        lacing = sum(len(q) // 255 + 1 for q in body)
        if last or acc >= per_page or lacing > 200:
            g = gran
            if last and samples is not None:
                g = start + pre_skip + samples
            pages.append((body, g))
            body, acc = [], 0
    for seq, (page, g) in enumerate(pages):
        page = [page] if isinstance(page, bytes) else page
        lace = b"".join(bytes([255] * (len(p) // 255) + [len(p) % 255])
                        for p in page)
        flags = (2 if seq == 0 else 0) | (4 if seq == len(pages) - 1 else 0)
        raw = b"OggS" + bytes([0, flags]) + struct.pack(
            "<qIII", g, serial, seq, 0) + bytes([len(lace)]) + lace \
            + b"".join(page)
        out += raw[:22] + struct.pack("<I", _ogg_crc(raw)) + raw[26:]
    return bytes(out)


def encode_opus(x: np.ndarray, sr: int, application: str = "audio",
                bitrate: int = 64000, channels: Optional[int] = None,
                frame_ms: float = 20, serial: int = 1, gain: int = 0,
                start: int = 0, **kw) -> bytes:
    """``x`` [n, channels] float → an Ogg Opus file (``opus_packets``
    into ``ogg_opus_stream``); ``channels`` keeps that many of ``x``'s."""
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    if channels is not None:
        x = x[:, :channels]
    packets, pre_skip, family, layout, samples = opus_packets(
        x, sr, application, bitrate, frame_ms, **kw)
    return ogg_opus_stream(packets, x.shape[1], pre_skip, samples, serial,
                           gain, sr, family, layout, start)


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


def _write(name: str, make) -> None:
    """Write e2e/data/compressed/<name> unless it is there: libsndfile's
    Ogg writer draws a random serial number, so a file it wrote never comes
    out the same twice."""
    path = os.path.join(COMPRESSED, name)
    if not os.path.exists(path):
        with open(path, "wb") as f:
            f.write(make())


def long_opus() -> bytes:
    """(b')'s Ogg Opus: ``long_stereo`` at 48 kHz, 48 kbit/s."""
    return encode_opus(long_stereo(sr=48000), 48000, bitrate=48000,
                       serial=0x2951)


def write_committed() -> None:
    """The committed files that are missing: per smoke clip an MP3, an Ogg
    Vorbis, three Ogg Opus (SILK at 16 kHz VOIP 16 kbit/s, a voice note;
    CELT by libsndfile; hybrid at 48 kHz 20 kbit/s) and an MPEG-2 Layer II
    at 16 kHz behind an ID3v2 tag; (b')'s long stereo MP3, Ogg Vorbis, Ogg
    Opus and Layer II."""
    os.makedirs(COMPRESSED, exist_ok=True)
    for k, clip in enumerate(SMOKE_CLIPS):
        x = real_clip(clip)
        stem = clip[:-4]
        _write(stem + ".mp3", lambda: encode_mp3(x, 16000, bitrate=32))
        _write(stem + ".ogg", lambda: encode_ogg(x, 16000, quality=0.2))
        _write(stem + "_silk.opus", lambda: encode_opus(
            x, 16000, application="voip", bitrate=16000, serial=0x51C0 + k))
        _write(stem + "_celt.opus", lambda: encode_ogg(x, 16000,
                                                       codec="opus"))
        _write(stem + "_hybrid.opus", lambda: encode_opus(
            resample_linear(x, 16000, 48000), 48000, bitrate=20000,
            serial=0x4B1D + k))
        _write(stem + ".mp2", lambda: id3v2() + encode_mp2(
            x, 16000, bitrate=32))
    y = long_stereo()
    _write("long_44k_stereo.mp3", lambda: encode_mp3(y, 44100, bitrate=64,
                                                     mode="joint"))
    _write("long_44k_stereo.ogg", lambda: encode_ogg(y, 44100, quality=0.0))
    _write("long_48k_stereo.opus", long_opus)
    _write("long_44k_stereo.mp2", lambda: id3v2() + encode_mp2(
        y, 44100, bitrate=192, mode="joint"))


if __name__ == "__main__":
    write_committed()
