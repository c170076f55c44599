"""MPEG audio Layer III decoder: MPEG-1, MPEG-2 and MPEG-2.5, numpy.

``decode_mp3(bytes) -> (float32 [n, channels], sample_rate)``. The frame
scan, the tags and the gapless trim are Python; a stream whose first
header is Layer I or II goes on to ``audio/mpa.py`` with its frames. The rest runs over blocks
of frames (``BLOCK_ROWS`` granule rows), the filterbanks' state carried
from one block to the next: each block's bit loops (side information, the
bit reservoir, scale factors and the Huffman decode of each granule's
big_values and count1 regions) run in one call of C++ (``csrc/audio_dsp.cpp``
``mp3_frames``, through ``audio/native.py``), with ``granules_plain`` as
their plain version, from the frames before the block that its reservoir
reaches into; requantization, the stereo, the antialias butterflies, the
IMDCT with its overlap-add and the polyphase synthesis run in numpy, in
single precision, over every granule of the block at once. A stream that
decodes to more than ``MAX_DECODED_SAMPLES`` samples is refused before
anything is decoded.

What the decoder follows where the standard leaves room, as mpg123 (the
decoder behind SDL_mixer) does:

* ID3v2 tags in front (the footer flag too) and ID3v1 / APE tags at the
  end are skipped; junk between frames is skipped by resynchronising on a
  header of the stream's own layer whose next frame also syncs.
* A first frame that carries a Xing/Info tag is not audio. When LAME's
  extension of that tag is intact (its CRC matches), the encoder delay plus
  529 samples of decoder delay are cut at the start and the padding less
  529 at the end; with no such tag every frame's samples come out.
* A frame whose bit reservoir (``main_data_begin``) reaches before the
  first frame read is not decoded; it gives a frame of silence and leaves
  the filterbanks' state as it was.
* Samples are rounded to 16 bits and clipped, as the 16-bit output that
  SDL_mixer asks mpg123 for.

Intensity stereo raises ``UnsupportedFormatError``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import mp3_tables as T
from . import mpa_tables as MPA
from .codec import (MAX_DECODED_SAMPLES, AudioDecodeError,
                    UnsupportedFormatError)

GAPLESS_DELAY = 529  # the polyphase filterbank's delay, in samples
MAX_FRAMES = 1 << 22  # ~30 h at 44.1 kHz; a header cannot ask for more
BLOCK_ROWS = 1024  # granule-channel rows (of 576 lines) a block of the decode


class Mp3Error(AudioDecodeError):
    pass


# -- Huffman trees ------------------------------------------------------------


def _build_trees() -> Tuple[np.ndarray, np.ndarray]:
    """Every code table as a binary tree in one int32 array: node n's
    children are ``tree[2n]`` (bit 0) and ``tree[2n + 1]`` (bit 1); a child
    >= 0 is a node, a child < 0 the leaf ``-child - 1`` (x * 16 + y, or
    vwxy). ``start[t]`` is table t's root, -1 where it has no codes."""
    tree: List[int] = []
    start = np.full(34, -1, np.int32)
    built = {}
    for t in range(1, 34):
        if t not in T.HUFFMAN:
            continue
        xlen, hlen, hcod = T.HUFFMAN[t]
        key = id(T.HUFFMAN[t])
        if key in built:
            start[t] = built[key]
            continue
        root = len(tree) // 2
        tree += [0, 0]
        for idx, (ln, code) in enumerate(zip(hlen, hcod)):
            value = (idx // xlen) * 16 + idx % xlen if t < 32 else idx
            node = root
            for b in range(ln - 1, -1, -1):
                bit = (code >> b) & 1
                if b == 0:
                    tree[2 * node + bit] = -value - 1
                else:
                    nxt = tree[2 * node + bit]
                    if nxt <= 0:
                        nxt = len(tree) // 2
                        tree += [0, 0]
                        tree[2 * node + bit] = nxt
                    node = nxt
        built[key] = start[t] = root
    return np.asarray(tree, np.int32), start


TREE, TREE_START = _build_trees()
LINBITS = np.asarray(T.LINBITS + (0, 0), np.int32)


def _huffman_granule(data: bytes, p, out: np.ndarray) -> None:
    """One granule's big_values and count1 regions into ``out`` (int32
    [576]). ``p``: start bit, end bit, big_values, table_select[3], region1
    and region2 starts (lines), count1 table (32 or 33). A read past the
    end of ``data`` gives zero bits."""
    n_bits = len(data) * 8
    pos, end, big, t0, t1, t2, r1, r2, c1 = (int(v) for v in p)
    tree = TREE

    def bit() -> int:
        nonlocal pos
        b = (data[pos >> 3] >> (7 - (pos & 7))) & 1 if pos < n_bits else 0
        pos += 1
        return b

    def bits(n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | bit()
        return v

    def leaf(t: int) -> int:
        node = int(TREE_START[t])
        while True:
            node = int(tree[2 * node + bit()])
            if node < 0:
                return -node - 1

    out[:] = 0
    i = 0
    while i < 2 * big:
        t = t0 if i < r1 else (t1 if i < r2 else t2)
        if TREE_START[t] < 0:
            i += 2
            continue
        v = leaf(t)
        lb = int(LINBITS[t])
        for x in (v >> 4, v & 15):
            if lb and x == 15:
                x += bits(lb)
            if x and bit():
                x = -x
            out[i] = x
            i += 1
    while i < 576 and pos < end:
        v = leaf(c1)
        quad = [(v >> 3) & 1, (v >> 2) & 1, (v >> 1) & 1, v & 1]
        for k in range(4):
            if quad[k] and bit():
                quad[k] = -1
        if pos > end:
            break
        for k in range(4):
            if i + k < 576:
                out[i + k] = quad[k]
        i += 4


# -- headers and tags ---------------------------------------------------------


@dataclass
class Header:
    lsf: int        # 0 MPEG-1, 1 MPEG-2 and 2.5
    mpeg25: int
    layer: int      # 1, 2 or 3
    crc: int
    bitrate: int    # kbit/s
    sr_index: int   # into SAMPLE_RATES
    padding: int
    mode: int       # 0 stereo, 1 joint, 2 dual, 3 mono
    mode_ext: int
    size: int       # bytes, header included

    @property
    def sample_rate(self) -> int:
        return T.SAMPLE_RATES[self.sr_index]

    @property
    def channels(self) -> int:
        return 1 if self.mode == 3 else 2

    @property
    def granules(self) -> int:
        return 1 if self.lsf else 2

    @property
    def side_info_size(self) -> int:
        if self.lsf:
            return 9 if self.mode == 3 else 17
        return 17 if self.mode == 3 else 32


def parse_header(data: bytes, pos: int) -> Optional[Header]:
    """The frame header at ``pos``, or None where the bytes are not one
    (bad sync, reserved version, layer, bitrate or rate, free format)."""
    if pos + 4 > len(data):
        return None
    b1, b2, b3 = data[pos + 1], data[pos + 2], data[pos + 3]
    if data[pos] != 0xFF or (b1 & 0xE0) != 0xE0:
        return None
    version = (b1 >> 3) & 3
    layer = 4 - ((b1 >> 1) & 3)
    br_idx = b2 >> 4
    sr_idx = (b2 >> 2) & 3
    if version == 1 or layer == 4 or br_idx in (0, 15) or sr_idx == 3:
        return None
    lsf = 0 if version == 3 else 1
    mpeg25 = int(version == 0)
    sr_index = sr_idx + 3 * (lsf + mpeg25)
    padding = (b2 >> 1) & 1
    sr = T.SAMPLE_RATES[sr_index]
    if layer == 3:
        bitrate = T.BITRATES[lsf][br_idx]
        size = (144 if not lsf else 72) * bitrate * 1000 // sr + padding
    elif mpeg25:
        return None  # Layer I and II have no MPEG-2.5
    else:
        bitrate = MPA.BITRATES[layer][lsf][br_idx]
        size = (12 * bitrate * 1000 // sr + padding) * 4 if layer == 1 \
            else 144 * bitrate * 1000 // sr + padding
    return Header(lsf, mpeg25, layer, (b1 & 1) ^ 1, bitrate, sr_index,
                  padding, b3 >> 6, (b3 >> 4) & 3, size)


def _same_stream(a: Header, b: Header) -> bool:
    return (a.lsf, a.mpeg25, a.layer, a.sr_index, a.channels) == \
        (b.lsf, b.mpeg25, b.layer, b.sr_index, b.channels)


def _tag_bounds(data: bytes) -> Tuple[int, int]:
    """[start, end) of the MPEG frames: past ID3v2 tags in front, before an
    ID3v1 tag and an APE tag at the end."""
    start = 0
    while data[start:start + 3] == b"ID3" and start + 10 <= len(data):
        size = 0
        for b in data[start + 6:start + 10]:
            size = (size << 7) | (b & 0x7F)
        footer = 10 if data[start + 5] & 0x10 else 0
        start += 10 + size + footer
    end = len(data)
    if end - start >= 128 and data[end - 128:end - 125] == b"TAG":
        end -= 128
    if end - start >= 32 and data[end - 32:end - 24] == b"APETAGEX":
        size = int.from_bytes(data[end - 20:end - 16], "little")
        flags = int.from_bytes(data[end - 12:end - 8], "little")
        size += 32 if flags & 0x80000000 else 0  # a header in front too
        end = max(start, end - size)
    return start, end


def _sync(data: bytes, pos: int, end: int,
          like: Optional[Header]) -> Tuple[int, Optional[Header]]:
    """The first position at or past ``pos`` where a header sits (of
    ``like``'s stream, its layer included, when given) whose next frame
    also syncs or ends the data. Returns (end, None) where there is
    none."""
    while pos + 4 <= end:
        pos = data.find(b"\xff", pos, end - 3)
        if pos < 0:
            break
        h = parse_header(data, pos)
        if h is not None and (like is None or _same_stream(h, like)):
            nxt = pos + h.size
            if nxt + 4 > end:
                if nxt <= end:
                    return pos, h
            else:
                h2 = parse_header(data, nxt)
                if h2 is not None and _same_stream(h, h2):
                    return pos, h
        pos += 1
    return end, None


def _crc16(data: bytes) -> int:
    """CRC-16 (polynomial 0x8005, reflected, initial 0): LAME's tag CRC."""
    crc = 0
    for b in data:
        crc ^= b
        for _ in range(8):
            crc = (crc >> 1) ^ 0xA001 if crc & 1 else crc >> 1
    return crc


@dataclass
class Gapless:
    frames: int       # audio frames the tag counts (0: unknown)
    delay: int = -1   # LAME's encoder delay; -1 where no intact extension
    padding: int = 0


def parse_info_tag(data: bytes, pos: int, h: Header) -> Optional[Gapless]:
    """The Xing/Info tag in the frame at ``pos``, or None. LAME writes it
    right after the side information's place as if the frame had no CRC
    (over the CRC's two bytes where it has one)."""
    off = pos + 4 + h.side_info_size
    if data[off:off + 4] not in (b"Xing", b"Info"):
        off += 2 * h.crc
        if data[off:off + 4] not in (b"Xing", b"Info"):
            return None
    flags = int.from_bytes(data[off + 4:off + 8], "big")
    p = off + 8
    frames = 0
    if flags & 1:
        frames = int.from_bytes(data[p:p + 4], "big")
        p += 4
    p += 4 * bool(flags & 2) + 100 * bool(flags & 4) + 4 * bool(flags & 8)
    tag = Gapless(frames)
    lame = data[p:p + 36]
    if len(lame) == 36 and p + 36 <= pos + h.size:
        stored = int.from_bytes(lame[34:36], "big")
        if _crc16(data[pos:p + 34]) == stored:
            d = lame[21:24]
            tag.delay = (d[0] << 4) | (d[1] >> 4)
            tag.padding = ((d[1] & 15) << 8) | d[2]
    return tag


# -- side information and scale factors ---------------------------------------


class _Bits:
    """MSB-first reader over ``data`` from bit ``pos``; past the end it
    reads zero bits."""
    __slots__ = ("data", "pos", "n_bits")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.n_bits = len(data) * 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p, e = self.pos, self.pos + n
        self.pos = e
        if e > self.n_bits:
            v = 0
            for q in range(p, e):
                v = (v << 1) | (((self.data[q >> 3] >> (7 - (q & 7))) & 1)
                                if q < self.n_bits else 0)
            return v
        last = (e + 7) >> 3
        v = int.from_bytes(self.data[p >> 3:last], "big")
        return (v >> (last * 8 - e)) & ((1 << n) - 1)


@dataclass
class Granule:
    part2_3: int = 0
    big_values: int = 0
    global_gain: int = 0
    sf_compress: int = 0
    block_type: int = 0
    mixed: int = 0
    table_select: Tuple[int, int, int] = (0, 0, 0)
    subblock_gain: Tuple[int, int, int] = (0, 0, 0)
    region1: int = 576
    region2: int = 576
    preflag: int = 0
    sf_scale: int = 0
    count1_table: int = 32
    sf_long: List[int] = field(default_factory=lambda: [0] * 22)
    sf_short: List[List[int]] = field(
        default_factory=lambda: [[0, 0, 0] for _ in range(13)])


def _region_starts(h: Header, g: Granule, r0c: int, r1c: int,
                   switching: bool) -> None:
    sfb = T.SFB_LONG[h.sr_index]
    if switching:
        g.region2 = 576
        if h.mpeg25:
            g.region1 = sfb[6 if g.block_type == 2 and not g.mixed else 8]
        elif not h.lsf or g.block_type == 2:
            g.region1 = 36
        else:
            g.region1 = 54
    else:
        g.region1 = sfb[min(r0c + 1, 22)]
        g.region2 = sfb[min(r0c + r1c + 2, 22)]


def parse_side_info(data: bytes, pos: int, h: Header
                    ) -> Tuple[int, List[int], List[List[Granule]]]:
    """(main_data_begin, scfsi per channel (4 bits), granules[gr][ch])."""
    r = _Bits(data, 8 * pos)
    nch = h.channels
    if h.lsf:
        main_data_begin = r.read(8)
        r.read(1 if nch == 1 else 2)
        scfsi = [0] * nch
    else:
        main_data_begin = r.read(9)
        r.read(5 if nch == 1 else 3)
        scfsi = [r.read(4) for _ in range(nch)]
    grans: List[List[Granule]] = []
    for _ in range(h.granules):
        row = []
        for _ in range(nch):
            g = Granule()
            g.part2_3 = r.read(12)
            g.big_values = min(r.read(9), 288)
            g.global_gain = r.read(8)
            g.sf_compress = r.read(9 if h.lsf else 4)
            if r.read(1):
                g.block_type = r.read(2)
                g.mixed = r.read(1)
                g.table_select = (r.read(5), r.read(5), 0)
                g.subblock_gain = (r.read(3), r.read(3), r.read(3))
                if g.block_type == 0:
                    raise Mp3Error("window switching with block type 0")
                _region_starts(h, g, 0, 0, True)
            else:
                g.table_select = (r.read(5), r.read(5), r.read(5))
                r0c, r1c = r.read(4), r.read(3)
                _region_starts(h, g, r0c, r1c, False)
            if not h.lsf:
                g.preflag = r.read(1)
            g.sf_scale = r.read(1)
            g.count1_table = 32 + r.read(1)
            row.append(g)
        grans.append(row)
    return main_data_begin, scfsi, grans


def read_scalefactors_mpeg1(r: _Bits, g: Granule, scfsi: int, gr: int,
                            prev: Optional[Granule]) -> None:
    slen1, slen2 = T.SLEN[g.sf_compress]
    if g.block_type == 2:
        if g.mixed:
            for sfb in range(8):
                g.sf_long[sfb] = r.read(slen1)
            first = 3
        else:
            first = 0
        for sfb in range(first, 12):
            n = slen1 if sfb < 6 else slen2
            g.sf_short[sfb] = [r.read(n), r.read(n), r.read(n)]
        return
    for band, (lo, hi) in enumerate(((0, 6), (6, 11), (11, 16), (16, 21))):
        n = slen1 if band < 2 else slen2
        if gr == 1 and prev is not None and scfsi & (8 >> band):
            g.sf_long[lo:hi] = prev.sf_long[lo:hi]
        else:
            for sfb in range(lo, hi):
                g.sf_long[sfb] = r.read(n)


def read_scalefactors_lsf(r: _Bits, g: Granule) -> None:
    sfc = g.sf_compress
    if sfc < 400:
        slen = ((sfc >> 4) // 5, (sfc >> 4) % 5, (sfc & 15) >> 2, sfc & 3)
        table = 0
    elif sfc < 500:
        sfc -= 400
        slen = ((sfc >> 2) // 5, (sfc >> 2) % 5, sfc & 3, 0)
        table = 1
    else:
        sfc -= 500
        slen = (sfc // 3, sfc % 3, 0, 0)
        table = 2
        g.preflag = 1
    block = 0 if g.block_type != 2 else (2 if g.mixed else 1)
    values = []
    for part in range(4):
        n = T.NR_OF_SFB[table][block][part]
        values += [r.read(slen[part]) for _ in range(n)]
    if block == 0:
        g.sf_long[:21] = values[:21]
        return
    k = 0
    if block == 2:
        g.sf_long[:6] = values[:6]
        k, first = 6, 3
    else:
        first = 0
    for sfb in range(first, 12):
        g.sf_short[sfb] = values[k:k + 3]
        k += 3


# -- the spectrum and the filterbanks -----------------------------------------


POW43 = np.arange(8207, dtype=np.float64) ** (4.0 / 3.0)
_CI = np.asarray(T.ANTIALIAS_CI)
CS = (1.0 / np.sqrt(1.0 + _CI ** 2)).astype(np.float32)
CA = (_CI / np.sqrt(1.0 + _CI ** 2)).astype(np.float32)

_I36 = np.arange(36)
_K18 = np.arange(18)
IMDCT36 = np.cos(np.pi / 72 * np.outer(2 * _K18 + 1, 2 * _I36 + 1 + 18)
                 ).astype(np.float32)
_I12 = np.arange(12)
_K6 = np.arange(6)
IMDCT12 = np.cos(np.pi / 24 * np.outer(2 * _K6 + 1, 2 * _I12 + 1 + 6)
                 ).astype(np.float32)


def _windows() -> np.ndarray:
    """The IMDCT windows by block type, [4, 36] (type 2 holds the 12-point
    window in its first 12 taps)."""
    w = np.zeros((4, 36))
    long = np.sin(np.pi / 36 * (_I36 + 0.5))
    short = np.sin(np.pi / 12 * (_I12 + 0.5))
    w[0] = long
    w[1, :18] = long[:18]
    w[1, 18:24] = 1.0
    w[1, 24:30] = short[6:]
    w[3, 6:12] = short[:6]
    w[3, 12:18] = 1.0
    w[3, 18:] = long[18:]
    w[2, :12] = short
    return w


WINDOWS = _windows().astype(np.float32)
SYNTH_N = np.cos((16 + np.arange(64))[:, None]
                 * (2 * np.arange(32) + 1)[None, :] * np.pi / 64)
SYNTH_D = np.asarray(T.SYNTH_WINDOW_Q16, np.float64) / 65536.0


def _line_maps(sr_index: int):
    """For one rate: the long band of each line, and for the lines of a
    short spectrum in bitstream order their band, window and frequency."""
    lon = T.SFB_LONG[sr_index]
    band_long = np.zeros(576, np.int64)
    for b in range(22):
        band_long[lon[b]:lon[b + 1]] = b
    sho = T.SFB_SHORT[sr_index]
    band_s = np.zeros(576, np.int64)
    win_s = np.zeros(576, np.int64)
    freq_s = np.zeros(576, np.int64)
    j = 0
    for b in range(13):
        width = sho[b + 1] - sho[b]
        for w in range(3):
            band_s[j:j + width] = b
            win_s[j:j + width] = w
            freq_s[j:j + width] = sho[b] + np.arange(width)
            j += width
    return band_long, band_s, win_s, freq_s


INFO_FIELDS = ("part2_3", "big_values", "global_gain", "sf_compress",
               "block_type", "mixed", "tsel0", "tsel1", "tsel2", "sbg0",
               "sbg1", "sbg2", "region1", "region2", "preflag", "sf_scale",
               "count1_table")
F = {name: k for k, name in enumerate(INFO_FIELDS)}


def requantize(ix: np.ndarray, info: np.ndarray, sf_long: np.ndarray,
               sf_short: np.ndarray, h: Header) -> np.ndarray:
    """xr, float64 [G, 576], in bitstream order (short spectra are not yet
    reordered), for every granule at once."""
    band_long, band_s, win_s, _ = _line_maps(h.sr_index)
    gain = 0.25 * (info[:, F["global_gain"]] - 210.0)
    sfm = 0.5 * (1.0 + info[:, F["sf_scale"]])
    pretab = np.asarray(T.PRETAB, np.float64)
    # the gains by band, then by line
    g_long = np.exp2(gain[:, None] - sfm[:, None]
                     * (sf_long + info[:, F["preflag"], None] * pretab))
    scale = g_long[:, band_long]
    short = info[:, F["block_type"]] == 2
    if short.any():
        sbg = info[short][:, [F["sbg0"], F["sbg1"], F["sbg2"]]]
        g_short = np.exp2(gain[short, None, None] - 2.0 * sbg[:, None, :]
                          - sfm[short, None, None] * sf_short[short])
        gs = g_short[:, band_s, win_s]
        boundary = T.SFB_LONG[h.sr_index][6 if h.lsf else 8]
        long_part = (info[short, F["mixed"], None] == 1) \
            & (np.arange(576)[None] < boundary)
        scale[short] = np.where(long_part, scale[short], gs)
    mag = POW43[np.minimum(np.abs(ix), 8206)]
    return (np.copysign(mag, ix) * scale).astype(np.float32)


def _antialias(x: np.ndarray, first_only: bool) -> None:
    """In place on [G, 32, 18]: the butterflies between subbands (only
    between 0 and 1 for mixed blocks)."""
    hi = 2 if first_only else 32
    a = x[:, 0:hi - 1, 17:9:-1].copy()
    b = x[:, 1:hi, 0:8].copy()
    x[:, 0:hi - 1, 17:9:-1] = a * CS - b * CA
    x[:, 1:hi, 0:8] = b * CS + a * CA


def imdct(xr: np.ndarray, info: np.ndarray, h: Header) -> np.ndarray:
    """[G, 32, 36]: each granule's windowed IMDCT outputs by subband."""
    n = len(info)
    bt = info[:, F["block_type"]]
    mixed = info[:, F["mixed"]] == 1
    y = np.zeros((n, 32, 36), np.float32)
    longs = np.flatnonzero(bt != 2)
    if longs.size:
        x = xr[longs].reshape(-1, 32, 18)
        _antialias(x, False)
        y[longs] = (x @ IMDCT36) * WINDOWS[bt[longs]][:, None, :]
    shorts = np.flatnonzero(bt == 2)
    if shorts.size:
        _, _, win_s, freq_s = _line_maps(h.sr_index)
        xs = np.zeros((shorts.size, 3, 192), np.float32)
        xs[:, win_s, freq_s] = xr[shorts]
        # [g, sb, w, 6] -> 12-point IMDCTs, windowed, at 6 + 6w
        z = xs.reshape(-1, 3, 32, 6).transpose(0, 2, 1, 3) @ IMDCT12
        z *= WINDOWS[2, :12]
        ys = np.zeros((shorts.size, 32, 36), np.float32)
        for w in range(3):
            ys[:, :, 6 + 6 * w:18 + 6 * w] += z[:, :, w]
        mix = mixed[shorts]
        if mix.any():
            x = xr[shorts[mix]].reshape(-1, 32, 18)[:, :2].copy()
            full = np.zeros((x.shape[0], 32, 18), np.float32)
            full[:, :2] = x
            _antialias(full, True)
            ys[mix, :2] = (full[:, :2] @ IMDCT36) * WINDOWS[0]
        y[shorts] = ys
    return y


def overlap_add(y: np.ndarray, tail: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
    """[n, 32, 36] of one channel in time order, and the second half of the
    granule before them ([32, 18]) -> [n, 32, 18] subband samples,
    frequency inversion applied, and the last granule's second half."""
    out = y[:, :, :18].copy()
    out[0] += tail
    out[1:] += y[:-1, :, 18:]
    out[:, 1::2, 1::2] *= -1
    return out, y[-1, :, 18:].copy()


def _synthesis_matrix() -> np.ndarray:
    """[16 * 32, 32]: the polyphase synthesis as one product. Output j of
    time slot t is sum_{i<8} D[64i + j] V[t - 2i][j] + D[64i + 32 + j]
    V[t - 2i - 1][32 + j], V[t] = N S[t]; row q * 32 + k weighs subband
    sample k of slot t - 15 + q."""
    d = SYNTH_D.reshape(8, 2, 32)
    m = np.zeros((16, 32, 32))
    for i in range(8):
        m[15 - 2 * i] = SYNTH_N[:32].T * d[i, 0][None, :]
        m[15 - 2 * i - 1] = SYNTH_N[32:].T * d[i, 1][None, :]
    return m.reshape(512, 32)


SYNTH_M = _synthesis_matrix().astype(np.float32)


def synthesize(sub: np.ndarray, history: np.ndarray, rows: int = 4096
               ) -> Tuple[np.ndarray, np.ndarray]:
    """[n, 32, 18] subband samples of one channel, and the 15 time slots
    before them ([15, 32]) -> [n * 576] PCM, and the last 15 slots: each
    time slot's 16 slots of history against ``SYNTH_M``, ``rows`` slots a
    product."""
    s = sub.transpose(0, 2, 1).reshape(-1, 32)
    t = s.shape[0]
    pad = np.concatenate([history, s])
    win = np.lib.stride_tricks.sliding_window_view(pad, (16, 32))[:, 0]
    out = np.empty((t, 32), np.float32)
    for a in range(0, t, rows):
        b = min(t, a + rows)
        out[a:b] = np.ascontiguousarray(win[a:b]).reshape(b - a, 512) \
            @ SYNTH_M
    return out.reshape(-1), pad[-15:].copy()


# -- the decoder --------------------------------------------------------------


def granules_plain(data: bytes, table: np.ndarray, first: Header):
    """The plain version of ``mp3_frames``: for the frames of ``table``
    ([F, 5]: offset, CRC flag, mode, mode extension, size), which were
    decoded (bool [F]; not where the bit reservoir reaches before the first
    frame), and for every granule and channel row (G = F * granules *
    channels): side information int32 [G, 17] (``INFO_FIELDS``), long and
    short scale factors int32 [G, 22] and [G, 39], quantized lines int32
    [G, 576]. Rows of frames not decoded are zeros."""
    nch, ngr = first.channels, first.granules
    n = len(table) * ngr * nch
    decoded = np.zeros(len(table), bool)
    info = np.zeros((n, len(INFO_FIELDS)), np.int32)
    sf_long = np.zeros((n, 22), np.int32)
    sf_short = np.zeros((n, 39), np.int32)
    ix = np.zeros((n, 576), np.int32)
    reservoir = bytearray()
    work = []  # (row, granule, start bit, scfsi, frame's mode extension)
    for fi, (fpos, crc, mode, mode_ext, size) in enumerate(table.tolist()):
        si = fpos + 4 + 2 * crc
        main = si + first.side_info_size
        if main > fpos + size:
            continue
        if mode == 1 and mode_ext & 1:
            raise UnsupportedFormatError(
                "MP3 intensity stereo is not supported")
        md_begin, scfsi, gr_rows = parse_side_info(data, si, first)
        begin = len(reservoir) - md_begin
        reservoir += data[main:fpos + size]
        if begin < 0:
            continue  # the reservoir reaches before the first frame read
        decoded[fi] = True
        bit = 8 * begin
        for gr in range(ngr):
            for ch in range(nch):
                g = gr_rows[gr][ch]
                work.append(((fi * ngr + gr) * nch + ch, g, bit, scfsi[ch]))
                bit += g.part2_3
    res = bytes(reservoir)
    done = {}
    for row, g, start, scfsi in work:
        r = _Bits(res, start)
        if first.lsf:
            read_scalefactors_lsf(r, g)
        else:
            gr = (row // nch) % ngr
            read_scalefactors_mpeg1(r, g, scfsi, gr, done.get(row - nch))
        done[row] = g
        info[row] = (g.part2_3, g.big_values, g.global_gain, g.sf_compress,
                     g.block_type, g.mixed, *g.table_select,
                     *g.subblock_gain, g.region1, g.region2, g.preflag,
                     g.sf_scale, g.count1_table)
        sf_long[row] = g.sf_long
        sf_short[row] = np.asarray(g.sf_short[:13]).reshape(-1)
        _huffman_granule(res, (r.pos, start + g.part2_3, g.big_values,
                               *g.table_select, g.region1, g.region2,
                               g.count1_table), ix[row])
    return decoded, info, sf_long, sf_short, ix


def granules_native(lib, data: bytes, table: np.ndarray, first: Header):
    """``granules_plain``'s outputs from the C++ helper (``mp3_frames``)."""
    nch, ngr = first.channels, first.granules
    n = len(table) * ngr * nch
    decoded = np.zeros(len(table), np.uint8)
    info = np.zeros((n, len(INFO_FIELDS)), np.int32)
    sf_long = np.zeros((n, 22), np.int32)
    sf_short = np.zeros((n, 39), np.int32)
    ix = np.zeros((n, 576), np.int32)
    buf = np.frombuffer(data, np.uint8)
    got = lib.mp3_frames(buf, len(buf), np.ascontiguousarray(table),
                         len(table), first.lsf, first.mpeg25, nch,
                         np.asarray(T.SFB_LONG[first.sr_index], np.int32),
                         TREE, len(TREE), TREE_START, LINBITS, decoded, info,
                         sf_long, sf_short, ix)
    if got == -2:
        raise UnsupportedFormatError("MP3 intensity stereo is not supported")
    if got < 0:
        raise Mp3Error("corrupt MP3 side information")
    return decoded.astype(bool), info, sf_long, sf_short, ix


def decode_mp3(data: bytes, native: bool = True,
               fold: Optional[Callable[[np.ndarray], np.ndarray]] = None
               ) -> Tuple[np.ndarray, int]:
    """Decode an MPEG audio stream -> (float32 [n, channels],
    sample_rate). ``native=False`` takes the plain Huffman decode even
    where the C++ helper is built. ``fold`` maps each block of samples
    ([k, channels]) to [k], and the output is then [n]: the upload's mono
    fold, made block by block so that no array of the whole upload holds
    more than one value a sample."""
    from . import native as native_mod
    lib = native_mod.get_lib() if native else None
    data = bytes(data)
    start, end = _tag_bounds(data)
    pos, first = _sync(data, start, end, None)
    if first is None:
        raise Mp3Error("no MPEG audio frame found")
    rows: List[Tuple[int, ...]] = []
    gapless: Optional[Gapless] = None
    while pos < end and len(rows) < MAX_FRAMES:
        h = parse_header(data, pos)
        if h is None or not _same_stream(h, first):
            pos, h = _sync(data, pos + 1, end, first)
            if h is None:
                break
        if pos + h.size > end:
            break  # a truncated last frame is not decoded
        if first.layer != 3:
            rows.append((pos, h.crc, h.mode, h.mode_ext, h.size,
                         MPA.alloc_table(h.lsf, h.sr_index, h.channels,
                                         (data[pos + 2] >> 4))))
            pos += h.size
            continue
        if not rows:
            gapless = parse_info_tag(data, pos, h)
        rows.append((pos, h.crc, h.mode, h.mode_ext, h.size))
        pos += h.size
    if not rows:
        raise Mp3Error("no complete MPEG audio frame")
    if first.layer != 3:
        from .mpa import decode_mpa, slots
        if len(rows) * 32 * slots(first.layer) * first.channels \
                > MAX_DECODED_SAMPLES:
            raise Mp3Error(f"the stream decodes to more than "
                           f"{MAX_DECODED_SAMPLES} samples")
        return decode_mpa(data, np.asarray(rows, np.int64).reshape(-1, 6),
                          first, native, fold)
    if gapless is not None:
        rows = rows[1:]
    nch, ngr = first.channels, first.granules
    spf = 576 * ngr
    if len(rows) * spf * nch > MAX_DECODED_SAMPLES:
        raise Mp3Error(f"the stream decodes to more than "
                       f"{MAX_DECODED_SAMPLES} samples")
    table = np.asarray(rows, np.int64).reshape(-1, 5)
    out = np.zeros((len(table) * spf,) if fold else (len(table) * spf, nch),
                   np.float32)
    tails = np.zeros((nch, 32, 18), np.float32)
    history = np.zeros((nch, 15, 32), np.float32)
    # each frame's main data, which the next frames' reservoirs reach into
    main = np.maximum(table[:, 4] - 4 - 2 * table[:, 1]
                      - first.side_info_size, 0)
    per = max(1, BLOCK_ROWS // (ngr * nch))
    for a in range(0, len(table), per):
        b = min(len(table), a + per)
        w, carried = a, 0
        while w > 0 and carried < 512:  # a reservoir reaches <= 511 bytes
            w -= 1
            carried += int(main[w])
        if lib is not None:
            decoded, info, sf_long, sf_short, ix = granules_native(
                lib, data, table[w:b], first)
        else:
            decoded, info, sf_long, sf_short, ix = granules_plain(
                data, table[w:b], first)
        skip = (a - w) * ngr * nch  # the frames before the block's
        decoded = decoded[a - w:]
        keep = np.flatnonzero(decoded)
        if not keep.size:
            continue
        rows_g = skip + np.flatnonzero(np.repeat(decoded, ngr * nch))
        xr = requantize(ix[rows_g], info[rows_g],
                        sf_long[rows_g].astype(np.float64),
                        sf_short[rows_g].reshape(-1, 13, 3).astype(
                            np.float64), first).reshape(-1, ngr, nch, 576)
        fr = a + keep
        ms = (table[fr, 2] == 1) & (table[fr, 3] & 2 > 0)
        if nch == 2 and ms.any():
            m, s = xr[ms, :, 0].copy(), xr[ms, :, 1].copy()
            xr[ms, :, 0] = (m + s) * np.float32(math.sqrt(0.5))
            xr[ms, :, 1] = (m - s) * np.float32(math.sqrt(0.5))
        y = imdct(xr.reshape(-1, 576), info[rows_g], first).reshape(
            -1, ngr, nch, 32, 36)
        pcm = np.empty((keep.size * spf, nch), np.float32)
        for ch in range(nch):
            sub, tails[ch] = overlap_add(y[:, :, ch].reshape(-1, 32, 36),
                                         tails[ch])
            pcm[:, ch], history[ch] = synthesize(sub, history[ch])
        pcm = np.clip(np.round(pcm * np.float32(32768.0)), -32768, 32767) \
            / np.float32(32768.0)
        at = slice(a * spf, b * spf) if keep.size == b - a else (
            fr[:, None] * spf + np.arange(spf)[None]).reshape(-1)
        out[at] = fold(pcm) if fold else pcm
    if gapless is not None and gapless.delay >= 0:
        begin = gapless.delay + GAPLESS_DELAY
        stop = (gapless.frames * spf - gapless.padding + GAPLESS_DELAY
                if gapless.frames else len(out))
        out = out[begin:max(begin, stop)]
    return out, first.sample_rate
