"""MPEG audio Layer I and II: MPEG-1 (32-48 kHz) and MPEG-2 LSF
(16-24 kHz), numpy.

``decode_mpa`` takes the frames ``mp3.decode_mp3`` found, by the layer of
the stream's first header. Each block of frames' bit loop (bit
allocation, Layer II's scfsi, the scale factors and the sample codes, the
3-, 5- and 9-level codes split into their three digits) runs in one call
of C++ (``csrc/audio_dsp.cpp`` ``mpa_frames``, through ``audio/native.py``),
with ``frames_plain`` as its plain version; the requantization, in single
precision as mpg123 computes it (``mpa_tables.MULS``), and Layer III's
polyphase synthesis (``mp3.synthesize``) run in numpy over the block.

Joint stereo is intensity stereo from the bound the mode extension sets:
above it one code serves both channels, each with its own scale factors.
A frame's CRC (ISO/IEC 11172-3 §2.4.3.1: the header's last 16 bits, the
allocation and Layer II's scfsi) is skipped, not checked: mpg123 decodes a
frame whose CRC fails as it reads, a grouped code past its levels' cube
giving zeros, and so does the port (``tests/test_torch_opus.py``). No
samples are trimmed: mpg123 trims no delay from a Layer I/II stream.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np

from . import mpa_tables as T
from .mp3 import Header, Mp3Error, synthesize

BLOCK_FRAMES = 256
INVALID_DIGIT = 9  # a grouped code's digit past its levels: the sample is 0


def slots(layer: int) -> int:
    """Subband samples a frame carries per subband: 12 or 36."""
    return 12 if layer == 1 else 36


class _Bits:
    """MSB-first reader of one frame; past its end it reads zero bits."""
    __slots__ = ("data", "pos", "end")

    def __init__(self, data: bytes, pos: int, end: int):
        self.data = data
        self.pos = pos * 8
        self.end = end * 8

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            p = self.pos
            bit = (self.data[p >> 3] >> (7 - (p & 7))) & 1 \
                if p < self.end else 0
            v = (v << 1) | bit
            self.pos = p + 1
        return v


def _bound(mode: int, mode_ext: int, sblimit: int) -> int:
    """The intensity bound: the first subband whose code both channels
    share (joint stereo), or ``sblimit``."""
    if mode == 1:
        return min(sblimit, 4 * mode_ext + 4)
    return sblimit


def frames_plain(data: bytes, table: np.ndarray, layer: int, nch: int):
    """The plain version of ``mpa_frames``: for the frames of ``table``
    ([F, 6]: offset, CRC flag, mode, mode extension, size, Layer II's
    allocation table), each subband's quantization class int32 [F, nch,
    32] (``mpa_tables.CLASSES``), scale factor indices int32 [F, nch, 32,
    3] and codes int32 [F, S, nch, 32] (S = ``slots(layer)``): an
    ungrouped code less 2**(bits-1) - 1, or a grouped code's digit
    (``INVALID_DIGIT`` for each of a code past the levels' cube)."""
    n = len(table)
    s = slots(layer)
    cls = np.zeros((n, nch, 32), np.int32)
    scf = np.zeros((n, nch, 32, 3), np.int32)
    code = np.zeros((n, s, nch, 32), np.int32)
    for f, (pos, crc, mode, mode_ext, size, tab) in enumerate(
            table.tolist()):
        r = _Bits(data, pos + 4 + 2 * crc, pos + size)
        if layer == 1:
            sblimit = 32
            bound = _bound(mode, mode_ext, 32) if nch == 2 else 32
            for sb in range(32):
                for c in range(nch if sb < bound else 1):
                    a = r.read(4)
                    cls[f, c, sb] = T.layer1_class(a) if a else 0
                if sb >= bound:
                    cls[f, 1, sb] = cls[f, 0, sb]
            for sb in range(32):
                for c in range(nch):
                    if cls[f, c, sb]:
                        scf[f, c, sb, :] = r.read(6)
        else:
            alloc = T.ALLOC[tab]
            sblimit = len(alloc)
            bound = _bound(mode, mode_ext, sblimit) if nch == 2 \
                else sblimit
            for sb in range(sblimit):
                nbal, levels = alloc[sb]
                for c in range(nch if sb < bound else 1):
                    a = r.read(nbal)
                    cls[f, c, sb] = T.CLASS_OF_LEVELS[levels[a - 1]] if a \
                        else 0
                if sb >= bound:
                    cls[f, 1, sb] = cls[f, 0, sb]
            scfsi = np.zeros((nch, 32), np.int32)
            for sb in range(sblimit):
                for c in range(nch):
                    if cls[f, c, sb]:
                        scfsi[c, sb] = r.read(2)
            for sb in range(sblimit):
                for c in range(nch):
                    if not cls[f, c, sb]:
                        continue
                    k = scfsi[c, sb]
                    if k == 0:
                        v = (r.read(6), r.read(6), r.read(6))
                    elif k == 1:
                        a = r.read(6)
                        v = (a, a, r.read(6))
                    elif k == 2:
                        a = r.read(6)
                        v = (a, a, a)
                    else:
                        a = r.read(6)
                        b = r.read(6)
                        v = (a, b, b)
                    scf[f, c, sb] = v
        per = 1 if layer == 1 else 3
        for g in range(12):
            for sb in range(sblimit):
                for c in range(nch if sb < bound else 1):
                    k = cls[f, c, sb]
                    if not k:
                        continue
                    bits, lv = T.CLASSES[k]
                    if lv:
                        v = r.read(bits)
                        for j in range(3):
                            # a code past lv^3 reads as zeros, as mpg123's
                            # tables have it
                            code[f, g * 3 + j, c, sb] = v % lv \
                                if v < lv ** 3 else INVALID_DIGIT
                            v //= lv
                    else:
                        off = (1 << (bits - 1)) - 1
                        for j in range(per):
                            code[f, g * per + j, c, sb] = r.read(bits) - off
                if sb >= bound:
                    code[f, g * per:(g + 1) * per, 1, sb] = \
                        code[f, g * per:(g + 1) * per, 0, sb]
    return cls, scf, code


def frames_native(lib, data: bytes, table: np.ndarray, layer: int, nch: int):
    """``frames_plain``'s outputs from the C++ helper (``mpa_frames``)."""
    n = len(table)
    cls = np.zeros((n, nch, 32), np.int32)
    scf = np.zeros((n, nch, 32, 3), np.int32)
    code = np.zeros((n, slots(layer), nch, 32), np.int32)
    buf = np.frombuffer(data, np.uint8)
    got = lib.mpa_frames(buf, len(buf), np.ascontiguousarray(table), n,
                         layer, nch, T.PACKED_ALLOC, T.PACKED_CLASSES, cls,
                         scf, code)
    if got < 0:
        raise Mp3Error("corrupt MPEG audio Layer I/II frame")
    return cls, scf, code


def _group_lut() -> np.ndarray:
    """int32 [len(CLASSES), 10]: a grouped class's digit -> its MULS row
    (``INVALID_DIGIT`` -> row 0, which is zeros)."""
    lut = np.zeros((len(T.CLASSES), INVALID_DIGIT + 1), np.int32)
    for k, (_, lv) in enumerate(T.CLASSES):
        if lv:
            lut[k, :lv] = T.GROUP_BASE[lv]
    return lut


_GROUP_LUT = _group_lut()
_BITS = np.asarray([b for b, _ in T.CLASSES], np.int32)
_GROUPED = np.asarray([lv > 0 for _, lv in T.CLASSES])


def requantize(cls: np.ndarray, scf: np.ndarray, code: np.ndarray,
               layer: int) -> np.ndarray:
    """float32 [F, S, nch, 32] subband samples, in single precision as
    mpg123 computes them."""
    s = code.shape[1]
    part = (np.arange(s) // 12) if layer == 2 else np.zeros(s, int)
    sf = scf.transpose(0, 3, 1, 2)[:, part]          # [F, S, nch, 32]
    k = np.broadcast_to(cls[:, None], code.shape)
    grouped = _GROUPED[k]
    row = np.where(grouped, _GROUP_LUT[k, np.clip(code, 0, INVALID_DIGIT)],
                   _BITS[k])
    scale = T.MULS[row, sf]
    out = np.where(grouped, scale, code.astype(np.float32) * scale)
    out[k == 0] = 0.0
    return out.astype(np.float32)


def decode_mpa(data: bytes, table: np.ndarray, first: Header,
               native: bool = True,
               fold: Optional[Callable[[np.ndarray], np.ndarray]] = None
               ) -> Tuple[np.ndarray, int]:
    """Decode the Layer I/II frames of ``table`` ([F, 6], as
    ``frames_plain`` takes it) -> (float32 [n, channels], or [n] through
    ``fold``, sample_rate)."""
    from . import native as native_mod
    lib = native_mod.get_lib() if native else None
    nch, layer = first.channels, first.layer
    spf = 32 * slots(layer)
    out = np.zeros((len(table) * spf,) if fold else (len(table) * spf, nch),
                   np.float32)
    history = np.zeros((nch, 15, 32), np.float32)
    for a in range(0, len(table), BLOCK_FRAMES):
        b = min(len(table), a + BLOCK_FRAMES)
        if lib is not None:
            cls, scf, code = frames_native(lib, data, table[a:b], layer, nch)
        else:
            cls, scf, code = frames_plain(data, table[a:b], layer, nch)
        sub = requantize(cls, scf, code, layer)
        pcm = np.empty(((b - a) * spf, nch), np.float32)
        for ch in range(nch):
            pcm[:, ch], history[ch] = synthesize(
                np.ascontiguousarray(sub[:, :, ch].transpose(0, 2, 1)),
                history[ch])
        pcm = np.clip(np.round(pcm * np.float32(32768.0)), -32768, 32767) \
            / np.float32(32768.0)
        out[a * spf:b * spf] = fold(pcm) if fold else pcm
    return out, first.sample_rate
