"""Vorbis I decoder (the Xiph.Org Vorbis I specification), numpy.

``decode_vorbis(bytes) -> (float32 [n, channels], sample_rate)`` for an Ogg
Vorbis file (``audio/ogg.py`` reads its pages). The three headers are read
in Python: codebooks (lengths, sparse books, the codeword assignment from
lengths, VQ lookup types 1 and 2), floor 1, residues 0, 1 and 2, mappings
with coupling and submaps, and modes, and so is each audio packet's
header (``packet_header``). The rest of every packet (the floor-1 values
and curve, integer ``render_line``; the residues, their classifications
and VQ lookups; the inverse coupling) runs in one call of C++ for each
block of packets (``csrc/audio_dsp.cpp`` ``vorbis_packets``, through
``audio/native.py``), with ``decode_body`` (``floor1_values``,
``floor1_curve``, ``residue_decode``) as its plain version; the IMDCT (by
FFT, batched over the block's packets of each block size), the windows'
slopes and the overlap-add run in numpy, the overlap carried from one
block to the next.

What follows libvorbis and libvorbisfile (the decoder behind SDL_mixer):

* A packet that ends early ends its floor (the channel is then silent) or
  its residue (the values decoded so far stay), as the end-of-packet rule
  of the specification says. A packet that is not audio, or names a mode
  the setup lacks, is skipped.
* The granule positions trim the output: at the first page that ends with
  one, samples beyond it are cut from the start of that packet's output
  (from its end when that packet ends the stream), and the stream's last
  granule position cuts its end.
* Samples are rounded to 16 bits and clipped, as the 16-bit output that
  SDL_mixer asks libvorbisfile for.

Floor type 0 and more than 8 channels raise ``UnsupportedFormatError``,
before anything is allocated for them, and so does a stream that decodes
to more than ``MAX_DECODED_SAMPLES`` samples; ``audio/compressed.py``
folds 3-8 channels to stereo as SDL does.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import ogg
from .codec import (_SUPPORTED, MAX_DECODED_SAMPLES, AudioDecodeError,
                    UnsupportedFormatError)

MAX_CHANNELS = 8        # SDL folds at most 8 to stereo (audio/compressed.py)
MAX_ENTRIES = 1 << 16   # codebook entries; libvorbis writes at most a few k
MAX_DIMS = 64           # codebook dimensions (vectors of a residue book)
# all books of a setup together: entries, and VQ values (float64)
MAX_TOTAL_ENTRIES = 1 << 20
MAX_TOTAL_VALUES = 1 << 22


class VorbisError(AudioDecodeError):
    pass


class _EOP(Exception):
    """The packet ended."""


class Reader:
    """LSB-first bit reader over one packet, from bit ``pos``. A read past
    the end raises ``_EOP``."""
    __slots__ = ("data", "pos", "n_bits")

    def __init__(self, data: bytes, pos: int = 0):
        self.data = data
        self.pos = pos
        self.n_bits = len(data) * 8

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p, e = self.pos, self.pos + n
        if e > self.n_bits:
            self.pos = self.n_bits
            raise _EOP()
        self.pos = e
        v = int.from_bytes(self.data[p >> 3:(e + 7) >> 3], "little")
        return (v >> (p & 7)) & ((1 << n) - 1)

    def bit(self) -> int:
        p = self.pos
        if p >= self.n_bits:
            raise _EOP()
        self.pos = p + 1
        return (self.data[p >> 3] >> (p & 7)) & 1


def ilog(x: int) -> int:
    return x.bit_length() if x > 0 else 0


def float32_unpack(x: int) -> float:
    mantissa = x & 0x1FFFFF
    exponent = (x & 0x7FE00000) >> 21
    if x & 0x80000000:
        mantissa = -mantissa
    return float(np.float32(mantissa * 2.0 ** (exponent - 788)))


def lookup1_values(entries: int, dims: int) -> int:
    """The largest r with r ** dims <= entries, exactly."""
    r = int(round(entries ** (1.0 / dims)))
    while r ** dims > entries:
        r -= 1
    while (r + 1) ** dims <= entries:
        r += 1
    return r


# -- codebooks ---------------------------------------------------------------


@dataclass
class Codebook:
    dims: int
    entries: int
    root: int                       # into the stream's tree array
    values: Optional[np.ndarray]    # float64 [entries, dims], or None
    value_off: int = -1             # into the stream's value array


def codewords(lengths: List[int]) -> List[int]:
    """Vorbis's codeword assignment: each entry in entry order takes the
    lowest free codeword of its length (not canonical Huffman). Raises on
    an over- or (but for a single-entry book) under-specified tree."""
    marker = [0] * 33
    out = [0] * len(lengths)
    used = sum(1 for ln in lengths if ln > 0)
    for i, length in enumerate(lengths):
        if length <= 0:
            continue
        entry = marker[length]
        if length < 32 and entry >> length:
            raise VorbisError("over-specified codebook lengths")
        out[i] = entry
        for j in range(length, 0, -1):
            if marker[j] & 1:
                marker[j] = marker[1] + 1 if j == 1 else marker[j - 1] << 1
                break
            marker[j] += 1
        for j in range(length + 1, 33):
            if marker[j] >> 1 == entry:
                entry = marker[j]
                marker[j] = marker[j - 1] << 1
            else:
                break
    if used != 1:
        for i in range(1, 33):
            if marker[i] & (0xFFFFFFFF >> (32 - i)):
                raise VorbisError("under-specified codebook lengths")
    return out


def _add_tree(tree: List[int], lengths: List[int], words: List[int]) -> int:
    """Append one book's decode tree to ``tree`` (node k's children at
    2k and 2k + 1; > 0 a node, < 0 the leaf ``-child - 1``, 0 no code);
    returns its root."""
    root = len(tree) // 2
    tree += [0, 0]
    for entry, (length, word) in enumerate(zip(lengths, words)):
        if length <= 0:
            continue
        node = root
        for b in range(length - 1, -1, -1):
            bit = (word >> b) & 1
            slot = 2 * node + bit
            if b == 0:
                tree[slot] = -entry - 1
            else:
                if tree[slot] <= 0:
                    tree[slot] = len(tree) // 2
                    tree += [0, 0]
                node = tree[slot]
    return root


def read_codebook(r: Reader, tree: List[int]) -> Codebook:
    if r.read(24) != 0x564342:
        raise VorbisError("bad codebook sync")
    dims = r.read(16)
    entries = r.read(24)
    if not 1 <= dims <= MAX_DIMS or not 1 <= entries <= MAX_ENTRIES:
        raise VorbisError(f"codebook of {entries} entries x {dims} "
                          f"dimensions out of range")
    lengths = [0] * entries
    if r.read(1) == 0:
        sparse = r.read(1)
        for i in range(entries):
            if not sparse or r.read(1):
                lengths[i] = r.read(5) + 1
    else:
        length = r.read(5) + 1
        i = 0
        while i < entries:
            count = r.read(ilog(entries - i))
            if i + count > entries or length > 32:
                raise VorbisError("bad ordered codebook lengths")
            lengths[i:i + count] = [length] * count
            i += count
            length += 1
    root = _add_tree(tree, lengths, codewords(lengths))
    lookup = r.read(4)
    values = None
    if lookup in (1, 2):
        minimum = float32_unpack(r.read(32))
        delta = float32_unpack(r.read(32))
        bits = r.read(4) + 1
        seq = r.read(1)
        n_mult = lookup1_values(entries, dims) if lookup == 1 \
            else entries * dims
        if n_mult * bits > r.n_bits - r.pos:
            raise VorbisError("truncated codebook lookup table")
        mult = np.asarray([r.read(bits) for _ in range(n_mult)], np.float64)
        if lookup == 1:
            e = np.arange(entries)[:, None]
            idx = (e // (n_mult ** np.arange(dims))[None]) % n_mult
        else:
            idx = np.arange(entries * dims).reshape(entries, dims)
        vals = (mult[idx] * delta + minimum).astype(np.float32)
        if seq:
            vals = np.cumsum(vals.astype(np.float64), axis=1)
        values = vals.astype(np.float32).astype(np.float64)
    elif lookup != 0:
        raise VorbisError(f"codebook lookup type {lookup}")
    return Codebook(dims, entries, root, values)


def decode_scalar(r: Reader, tree: np.ndarray, root: int) -> int:
    """One entry number; -1 at the end of the packet or on a bit string
    that is no codeword (libvorbis's decode answers -1 to both)."""
    node = root
    try:
        for _ in range(33):
            node = int(tree[2 * node + r.bit()])
            if node < 0:
                return -node - 1
            if node == 0:
                return -1
    except _EOP:
        return -1
    return -1


# -- floor 1 ------------------------------------------------------------------


@dataclass
class Floor1:
    partition_class: List[int]
    class_dims: List[int]
    class_subs: List[int]
    class_book: List[int]
    sub_books: List[List[int]]
    mult: int
    xs: List[int]                 # post x values, in header order
    lo: List[int] = field(default_factory=list)
    hi: List[int] = field(default_factory=list)
    order: List[int] = field(default_factory=list)  # posts sorted by x

    @property
    def range_q(self) -> int:
        return (256, 128, 86, 64)[self.mult - 1]


def read_floor(r: Reader, n_books: int) -> Floor1:
    kind = r.read(16)
    if kind == 0:
        raise UnsupportedFormatError("Vorbis floor type 0 is not supported "
                                     "(libvorbis writes floor 1)")
    if kind != 1:
        raise VorbisError(f"bad floor type {kind}")
    partitions = r.read(5)
    pclass = [r.read(4) for _ in range(partitions)]
    n_class = max(pclass) + 1 if pclass else 0
    dims, subs, books, sub_books = [], [], [], []
    for _ in range(n_class):
        dims.append(r.read(3) + 1)
        subs.append(r.read(2))
        books.append(r.read(8) if subs[-1] else -1)
        sub_books.append([r.read(8) - 1 for _ in range(1 << subs[-1])])
    for b in books + [s for row in sub_books for s in row]:
        if b >= n_books:
            raise VorbisError("floor names a missing codebook")
    mult = r.read(2) + 1
    bits = r.read(4)
    xs = [0, 1 << bits]
    for c in pclass:
        xs += [r.read(bits) for _ in range(dims[c])]
    if len(xs) > 65 or len(set(xs)) != len(xs):
        raise VorbisError("bad floor 1 posts")
    f = Floor1(pclass, dims, subs, books, sub_books, mult, xs)
    for i in range(2, len(xs)):
        lo = max((j for j in range(i) if xs[j] < xs[i]), key=lambda j: xs[j])
        hi = min((j for j in range(i) if xs[j] > xs[i]), key=lambda j: xs[j])
        f.lo.append(lo)
        f.hi.append(hi)
    f.order = sorted(range(len(xs)), key=lambda j: xs[j])
    return f


def floor1_values(r: Reader, f: Floor1, books: List[Codebook],
                  tree: np.ndarray) -> Optional[List[int]]:
    """One channel's raw post values (``vorbis_packets``' floor, plain),
    or None where the floor is unused or the packet ends inside it."""
    try:
        if r.read(1) == 0:
            return None
        bits = ilog(f.range_q - 1)
        y = [r.read(bits), r.read(bits)]
    except _EOP:
        return None
    for c in f.partition_class:
        cdim, csub = f.class_dims[c], f.class_subs[c]
        cval = 0
        if csub:
            cval = decode_scalar(r, tree, books[f.class_book[c]].root)
            if cval < 0:
                return None
        for _ in range(cdim):
            book = f.sub_books[c][cval & ((1 << csub) - 1)]
            cval >>= csub
            if book >= 0:
                v = decode_scalar(r, tree, books[book].root)
                if v < 0:
                    return None
                y.append(v)
            else:
                y.append(0)
    return y


def _render_point(x0: int, x1: int, y0: int, y1: int, x: int) -> int:
    dy = y1 - y0
    off = abs(dy) * (x - x0) // (x1 - x0)
    return y0 - off if dy < 0 else y0 + off


def floor1_curve(f: Floor1, raw: List[int], n: int) -> np.ndarray:
    """The floor's amplitude curve over ``n`` (half the block) from the
    packet's raw post values: the specification's step 1 (the amplitude
    prediction and unwrap) and step 2 (``render_line``), integer exact."""
    q = f.range_q
    y = list(raw)
    used = [True, True] + [False] * (len(y) - 2)
    for i in range(2, len(y)):
        lo, hi = f.lo[i - 2], f.hi[i - 2]
        pred = _render_point(f.xs[lo], f.xs[hi], y[lo], y[hi], f.xs[i])
        val = y[i]
        hiroom, loroom = q - pred, pred
        room = min(hiroom, loroom) * 2
        if val:
            used[lo] = used[hi] = used[i] = True
            if val >= room:
                val = val - loroom if hiroom > loroom else -1 - (val - hiroom)
            else:
                val = -((val + 1) >> 1) if val & 1 else val >> 1
            y[i] = (val + pred) & 0x7FFF
            y[lo] &= 0x7FFF
            y[hi] &= 0x7FFF
        else:
            y[i] = pred
    # render: lines between consecutive used posts, in x order, as
    # render_line's integer steps: y = y0 + k * base + sign * (k * ady // adx)
    xs = [f.xs[j] for j in f.order if used[j]]
    ys = [min(max(y[j] * f.mult, 0), 255) for j in f.order if used[j]]
    x0 = np.asarray(xs[:-1], np.int64)
    x1 = np.asarray(xs[1:], np.int64)
    y0 = np.asarray(ys[:-1], np.int64)
    dy = np.asarray(ys[1:], np.int64) - y0
    adx = x1 - x0
    base = np.sign(dy) * (np.abs(dy) // adx)   # C's division, toward zero
    ady = np.abs(dy) - np.abs(base * adx)
    step = np.where(dy < 0, -1, 1)
    length = np.clip(np.minimum(x1, n) - x0, 0, None)
    seg = np.repeat(np.arange(len(x0)), length)
    k = np.arange(seg.size) - np.repeat(np.cumsum(length) - length, length)
    idx = np.empty(n, np.int64)
    idx[x0[seg] + k] = y0[seg] + k * base[seg] \
        + step[seg] * ((k * ady[seg]) // adx[seg])
    last = min(xs[-1], n)
    idx[last:] = ys[-1]
    return FLOOR1_DB[idx]


# -- residues -----------------------------------------------------------------


@dataclass
class Residue:
    kind: int
    begin: int
    end: int
    grouping: int
    classifications: int
    classbook: int
    cascade: List[int]
    books: List[List[int]]          # [class][stage], -1 where unused

    @property
    def stages(self) -> int:
        return max((ilog(c) for c in self.cascade), default=0)


def read_residue(r: Reader, books: List[Codebook]) -> Residue:
    kind = r.read(16)
    if kind > 2:
        raise VorbisError(f"bad residue type {kind}")
    begin, end = r.read(24), r.read(24)
    grouping = r.read(24) + 1
    classes = r.read(6) + 1
    classbook = r.read(8)
    cascade = []
    for _ in range(classes):
        low = r.read(3)
        high = r.read(5) if r.read(1) else 0
        cascade.append(high * 8 + low)
    rbooks = [[r.read(8) if c & (1 << s) else -1 for s in range(8)]
              for c in cascade]
    if classbook >= len(books) or classes ** books[classbook].dims > 1 << 40:
        raise VorbisError("residue names a missing or oversized classbook")
    for row in rbooks:
        for b in row:
            if b >= len(books) or (b >= 0 and books[b].values is None):
                raise VorbisError("residue names a codebook without values")
    return Residue(kind, begin, end, grouping, classes, classbook, cascade,
                   rbooks)


def residue_decode(r: Reader, res: Residue, books: List[Codebook],
                   tree: np.ndarray, vecs: np.ndarray,
                   decode: List[bool], n: int) -> None:
    """Add one submap's residue (``vorbis_packets``' residue, plain) into
    ``vecs`` (float64 [channels of the submap, n / 2]) as libvorbis does,
    stopping where the packet ends."""
    ch = vecs.shape[0]
    if res.kind == 2:
        if not any(decode):
            return
        flat = vecs  # interleaved through decodevv below
        limit = n * ch // 2
        chans = [0]
    else:
        chans = [c for c in range(ch) if decode[c]]
        if not chans:
            return
        limit = n // 2
    end = min(res.end, limit)
    size = end - res.begin
    if size <= 0:
        return
    per = res.grouping
    partvals = size // per
    cb = books[res.classbook]
    ppw = cb.dims
    n_words = res.classifications ** ppw
    words: List[List[List[int]]] = [[] for _ in chans]
    for s in range(res.stages):
        i = 0
        word = 0
        while i < partvals:
            if s == 0:
                for j in range(len(chans)):
                    temp = decode_scalar(r, tree, cb.root)
                    if temp < 0 or temp >= n_words:
                        return
                    digits = []
                    for _ in range(ppw):
                        digits.append(temp % res.classifications)
                        temp //= res.classifications
                    words[j].append(digits[::-1])
            for k in range(ppw):
                if i >= partvals:
                    break
                for j, c in enumerate(chans):
                    cls = words[j][word][k]
                    b = res.books[cls][s]
                    if b < 0:
                        continue
                    off = res.begin + i * per
                    book = books[b]
                    if res.kind == 2:
                        ok = _decode_vv(r, book, tree, flat, off, per)
                    elif res.kind == 1:
                        ok = _decode_v(r, book, tree, vecs[c], off, per)
                    else:
                        ok = _decode_vs(r, book, tree, vecs[c], off, per)
                    if not ok:
                        return
                i += 1
            word += 1


def _decode_v(r, book, tree, a, off, n) -> bool:
    i = 0
    while i < n:
        e = decode_scalar(r, tree, book.root)
        if e < 0:
            return False
        for v in book.values[e][:n - i]:
            a[off + i] += v
            i += 1
    return True


def _decode_vs(r, book, tree, a, off, n) -> bool:
    step = n // book.dims
    entries = []
    for _ in range(step):
        e = decode_scalar(r, tree, book.root)
        if e < 0:
            return False
        entries.append(e)
    for i in range(book.dims):
        for j in range(step):
            if i * step + j < n:
                a[off + i * step + j] += book.values[entries[j]][i]
    return True


def _decode_vv(r, book, tree, vecs, off, n) -> bool:
    ch = vecs.shape[0]
    i = off // ch
    stop = (off + n) // ch
    c = 0
    while i < stop:
        e = decode_scalar(r, tree, book.root)
        if e < 0:
            return False
        for v in book.values[e]:
            if i >= stop:
                break
            vecs[c, i] += v
            c += 1
            if c == ch:
                c = 0
                i += 1
    return True


# -- setup -------------------------------------------------------------------


@dataclass
class Mapping:
    coupling: List[Tuple[int, int]]
    mux: List[int]
    floors: List[int]       # by submap
    residues: List[int]     # by submap


@dataclass
class Setup:
    channels: int
    rate: int
    blocksizes: Tuple[int, int]
    books: List[Codebook]
    tree: np.ndarray
    values: np.ndarray
    floors: List[Floor1]
    residues: List[Residue]
    mappings: List[Mapping]
    modes: List[Tuple[int, int]]    # (blockflag, mapping)


def read_identification(p: bytes) -> Tuple[int, int, Tuple[int, int]]:
    if len(p) < 30 or p[:7] != b"\x01vorbis":
        raise VorbisError("missing Vorbis identification header")
    r = Reader(p, 56)
    version, channels, rate = r.read(32), r.read(8), r.read(32)
    r.read(32), r.read(32), r.read(32)
    b0, b1 = 1 << r.read(4), 1 << r.read(4)
    if version != 0 or channels == 0 or rate == 0 or not (
            64 <= b0 <= b1 <= 8192) or not r.read(1):
        raise VorbisError("bad Vorbis identification header")
    if channels > MAX_CHANNELS:
        raise UnsupportedFormatError(
            f"{channels} channels are not supported (at most "
            f"{MAX_CHANNELS}); {_SUPPORTED}")
    return channels, rate, (b0, b1)


def read_setup(p: bytes, channels: int, rate: int,
               blocksizes: Tuple[int, int]) -> Setup:
    if p[:7] != b"\x05vorbis":
        raise VorbisError("missing Vorbis setup header")
    r = Reader(p, 56)
    try:
        tree: List[int] = [0, 0]  # node 0 is never a child
        books = []
        for _ in range(r.read(8) + 1):
            books.append(read_codebook(r, tree))
            if sum(b.entries for b in books) > MAX_TOTAL_ENTRIES or sum(
                    b.values.size for b in books
                    if b.values is not None) > MAX_TOTAL_VALUES:
                raise VorbisError("Vorbis codebooks too large")
        for _ in range(r.read(6) + 1):
            if r.read(16) != 0:
                raise VorbisError("bad time-domain transform")
        floors = [read_floor(r, len(books)) for _ in range(r.read(6) + 1)]
        residues = [read_residue(r, books) for _ in range(r.read(6) + 1)]
        mappings = []
        for _ in range(r.read(6) + 1):
            if r.read(16) != 0:
                raise VorbisError("bad mapping type")
            submaps = r.read(4) + 1 if r.read(1) else 1
            coupling = []
            if r.read(1):
                bits = ilog(channels - 1)
                for _ in range(r.read(8) + 1):
                    m, a = r.read(bits), r.read(bits)
                    if m == a or m >= channels or a >= channels:
                        raise VorbisError("bad channel coupling")
                    coupling.append((m, a))
            if r.read(2):
                raise VorbisError("bad mapping reserved bits")
            mux = [r.read(4) for _ in range(channels)] if submaps > 1 \
                else [0] * channels
            fl, rs = [], []
            for _ in range(submaps):
                r.read(8)
                fl.append(r.read(8))
                rs.append(r.read(8))
            if max(mux) >= submaps or max(fl) >= len(floors) \
                    or max(rs) >= len(residues):
                raise VorbisError("mapping names a missing floor or residue")
            mappings.append(Mapping(coupling, mux, fl, rs))
        modes = []
        for _ in range(r.read(6) + 1):
            flag = r.read(1)
            if r.read(16) or r.read(16):
                raise VorbisError("bad mode window or transform type")
            m = r.read(8)
            if m >= len(mappings):
                raise VorbisError("mode names a missing mapping")
            modes.append((flag, m))
        if not r.read(1):
            raise VorbisError("bad setup header framing bit")
    except _EOP:
        raise VorbisError("truncated Vorbis setup header") from None
    value_rows = []
    off = 0
    for b in books:
        if b.values is not None:
            b.value_off = off
            value_rows.append(b.values.reshape(-1))
            off += b.values.size
    values = np.concatenate(value_rows) if value_rows else np.zeros(1)
    return Setup(channels, rate, blocksizes, books,
                 np.asarray(tree, np.int32), values, floors, residues,
                 mappings, modes)


# -- the transform and the windows --------------------------------------------


def imdct(x: np.ndarray) -> np.ndarray:
    """[..., N/2] -> [..., N]: y[n] = sum_k x[k] cos(2 pi / N (n + 1/2 +
    N/4) (k + 1/2)), by a complex FFT of length N: with n0 = (N/2 + 1)/2,
    y[n] = Re(e^{i pi (n + n0) / N} sum_k x[k] e^{i 2 pi n0 k / N}
    e^{i 2 pi n k / N}). In single precision, as libvorbis computes it."""
    n = 2 * x.shape[-1]
    pre, post = _twiddles(n)
    z = np.fft.ifft(x.astype(np.float32) * pre, n, axis=-1)
    return (z * post).real


@functools.lru_cache(maxsize=4)
def _twiddles(n: int):
    n0 = (n / 2 + 1) / 2
    pre = np.exp(2j * np.pi * n0 * np.arange(n // 2) / n)
    post = np.exp(1j * np.pi * (np.arange(n) + n0) / n) * n
    return pre.astype(np.complex64), post.astype(np.complex64)


def _slope(n: int) -> np.ndarray:
    i = np.arange(n)
    return np.sin(np.pi / 2 * np.sin((i + 0.5) / n * np.pi / 2) ** 2)


@functools.lru_cache(maxsize=16)
def window(n: int, left: int, right: int) -> np.ndarray:
    """The block's window: slopes of ``left`` and ``right`` samples."""
    w = np.zeros(n, np.float32)
    ls = n // 4 - left // 2
    rs = 3 * n // 4 - right // 2
    w[ls:ls + left] = _slope(left)
    w[ls + left:rs] = 1.0
    w[rs:rs + right] = _slope(right)[::-1]
    w.flags.writeable = False  # one cached array for every caller
    return w


# -- the decoder --------------------------------------------------------------


IMDCT_BATCH = 128  # packets an FFT batch
BLOCK_VALUES = 1 << 19  # spectrum values (float64) a block of packets


def decode_vorbis(data: bytes, native: bool = True,
                  fold: Optional[Callable[[np.ndarray], np.ndarray]] = None
                  ) -> Tuple[np.ndarray, int]:
    """Decode an Ogg Vorbis file -> (float32 [n, channels], sample_rate).
    ``native=False`` takes the plain packet decode (``decode_body``) even
    where the C++ helper is built. ``fold`` maps each block of samples
    ([k, channels]) to [k], and the output is then [n]. The packets decode
    in blocks of ``BLOCK_VALUES`` spectrum values, each block's overlap-add
    carried to the next, so that no array of the whole upload holds more
    than the output."""
    from . import native as native_mod
    lib = native_mod.get_lib() if native else None
    data = bytes(data)
    packets, _ = ogg.read_packets(data)
    if len(packets) < 3:
        raise VorbisError("missing Vorbis headers")
    channels, rate, bs = read_identification(packets[0].data)
    if packets[1].data[:7] != b"\x03vorbis":
        raise VorbisError("missing Vorbis comment header")
    s = read_setup(packets[2].data, channels, rate, bs)
    audio = []  # (packet, (flag, prev, next, mode, header bits))
    for p in packets[3:]:
        head = packet_header(p.data, s)
        if head is not None:
            audio.append((p, head))
    if not audio:
        raise VorbisError("no Vorbis audio packets")
    halves = np.asarray([s.blocksizes[h[0]] // 2 for _, h in audio], np.int64)
    if int(halves.sum()) * channels > MAX_DECODED_SAMPLES:
        raise VorbisError(f"the stream decodes to more than "
                          f"{MAX_DECODED_SAMPLES} samples")
    blob = _blob(s) if lib is not None else None

    def spectra(part):
        """The packets' spectra, float64, packet k's [channels, n / 2] from
        offset k."""
        off = np.concatenate([[0], np.cumsum(
            [s.blocksizes[h[0]] // 2 * channels for _, h in part])])
        spec = np.zeros(int(off[-1]))
        if lib is not None:
            _decode_native(lib, part, s, blob, spec, off)
        else:
            for k, (p, (_, _, _, mode, pos)) in enumerate(part):
                decode_body(p.data, pos, mode, s,
                            spec[off[k]:off[k + 1]].reshape(channels, -1))
        return spec, off

    return _synthesize(audio, s, spectra, fold), rate


def packet_header(data: bytes, s: Setup):
    """(blockflag, previous and next window flags, mode, the bit position
    after them) of an audio packet, or None where it is skipped (not
    audio, a mode the setup lacks, or too short)."""
    r = Reader(data)
    try:
        if r.read(1):
            return None
        mode = r.read(ilog(len(s.modes) - 1))
        if mode >= len(s.modes):
            return None
        flag = s.modes[mode][0]
        prev = nxt = flag
        if flag:
            prev, nxt = r.read(1), r.read(1)
    except _EOP:
        return None
    return flag, prev, nxt, mode, r.pos


def decode_body(data: bytes, pos: int, mode: int, s: Setup,
                spec: np.ndarray) -> None:
    """The plain version of ``vorbis_packets`` for one packet: floors,
    residues, the inverse coupling and the floor curves, from bit ``pos``
    into ``spec`` (float64 [channels, n / 2], zeros)."""
    flag, mi = s.modes[mode]
    n = s.blocksizes[flag]
    m = s.mappings[mi]
    ch = s.channels
    r = Reader(data, pos)
    raw: List[Optional[List[int]]] = []
    for c in range(ch):
        raw.append(floor1_values(r, s.floors[m.floors[m.mux[c]]], s.books,
                                 s.tree))
    nonzero = [v is not None for v in raw]
    for a, b in m.coupling:
        if nonzero[a] or nonzero[b]:
            nonzero[a] = nonzero[b] = True
    for sm, ri in enumerate(m.residues):
        chans = [c for c in range(ch) if m.mux[c] == sm]
        vecs = np.zeros((len(chans), n // 2))
        residue_decode(r, s.residues[ri], s.books, s.tree, vecs,
                       [nonzero[c] for c in chans], n)
        spec[chans] = vecs
    for a, b in reversed(m.coupling):
        mag, ang = spec[a].copy(), spec[b].copy()
        pos_m, pos_a = mag > 0, ang > 0
        spec[a] = np.where(pos_a, mag, np.where(pos_m, mag + ang, mag - ang))
        spec[b] = np.where(pos_a, np.where(pos_m, mag - ang, mag + ang), mag)
    for c in range(ch):
        if raw[c] is None:
            spec[c] = 0.0
        else:
            f = s.floors[m.floors[m.mux[c]]]
            spec[c] *= floor1_curve(f, raw[c], n // 2)


def _decode_native(lib, audio, s: Setup, blob: np.ndarray, spec: np.ndarray,
                   spec_off: np.ndarray) -> None:
    """``decode_body`` for every packet of ``audio`` in one call of the C++
    helper; ``blob`` is ``_blob(s)``."""
    bodies = [p.data for p, _ in audio]
    starts = np.concatenate([[0], np.cumsum([len(b) for b in bodies])])
    table = np.asarray([(starts[k], len(bodies[k]), h[4], h[3])
                        for k, (_, h) in enumerate(audio)], np.int64)
    buf = np.frombuffer(b"".join(bodies) or b"\x00", np.uint8)
    if lib.vorbis_packets(buf, len(buf), table, len(table), blob, len(blob),
                          s.tree, len(s.tree), s.values, len(s.values),
                          FLOOR1_DB, np.ascontiguousarray(spec_off[:-1]),
                          spec, len(spec)) != 0:
        raise VorbisError("corrupt Vorbis setup")


def _blob(s: Setup) -> np.ndarray:
    """The setup as the C++ helper reads it: a header (channels, block
    sizes, counts, offsets), each book (root, dims, value offset), each
    floor (partitions and their classes; per class its dims, subclass bits,
    master book and 8 sub books; multiplier, posts, x values, neighbours,
    x order), residue (type, begin, end, grouping, classifications,
    classbook, stages, 8 books a class), mapping (coupling pairs, submaps,
    mux, floor and residue a submap) and mode (block flag, mapping)."""
    books = [v for b in s.books for v in (b.root, b.dims, b.value_off)]
    floors = []
    for f in s.floors:
        classes = []
        for c in range(len(f.class_dims)):
            subs = f.sub_books[c] + [-1] * (8 - len(f.sub_books[c]))
            classes += [f.class_dims[c], f.class_subs[c], f.class_book[c],
                        *subs]
        floors.append([len(f.partition_class), *f.partition_class,
                       len(f.class_dims), *classes, f.mult, len(f.xs),
                       *f.xs, *f.lo, *f.hi, *f.order])
    residues = [[r.kind, r.begin, r.end, r.grouping, r.classifications,
                 r.classbook, r.stages, *[b for row in r.books for b in row]]
                for r in s.residues]
    mappings = [[len(m.coupling), *[v for pair in m.coupling for v in pair],
                 len(m.residues), *m.mux,
                 *[v for fr in zip(m.floors, m.residues) for v in fr]]
                for m in s.mappings]
    modes = [v for mode in s.modes for v in mode]
    out = [0] * 13
    out[:8] = [s.channels, s.blocksizes[0], s.blocksizes[1], len(s.modes),
               len(s.books), len(s.floors), len(s.residues), len(s.mappings)]

    def table(parts):
        at = len(out)
        out.extend([0] * len(parts))
        for k, part in enumerate(parts):
            out[at + k] = len(out)
            out.extend(part)
        return at

    out[8] = len(out)
    out.extend(books)
    out[9] = table(floors)
    out[10] = table(residues)
    out[11] = table(mappings)
    out[12] = len(out)
    out.extend(modes)
    return np.asarray(out, np.int32)


def _spans(audio, centers: np.ndarray) -> List[Tuple[int, int]]:
    """The part of the overlap-add that each packet returns, as
    libvorbisfile returns it: from the previous packet's centre to its own,
    less what the granule positions trim."""
    spans = []
    count = -1
    gp = -1
    for k, (p, _) in enumerate(audio):
        if k == 0:
            lo = hi = int(centers[0])
            ret = 0
            count = 0
        else:
            lo, hi = int(centers[k - 1]), int(centers[k])
            ret = hi - lo
            count += ret
        if gp == -1:
            if p.granule != -1:
                gp = p.granule
                if count > gp:
                    extra = count - gp
                    if p.eos:
                        hi -= min(extra, ret)
                    else:
                        lo = min(lo + extra, hi)
        else:
            gp += ret
            if p.granule != -1 and gp != p.granule:
                if gp > p.granule and p.eos:
                    hi -= min(gp - p.granule, ret)
                gp = p.granule
        spans.append((lo, hi))
    return spans


def _synthesize(audio, s: Setup, spectra, fold) -> np.ndarray:
    """IMDCT, windows and overlap-add, block by block of packets
    (``spectra(packets)`` decodes a block), then the granule positions'
    trims: float32 [n, channels] rounded to 16 bits, or ``fold``'s [n]."""
    ch = s.channels
    bs0, bs1 = s.blocksizes
    sizes = np.asarray([s.blocksizes[h[0]] for _, h in audio], np.int64)
    centers = np.full(len(audio), bs1 // 2, np.int64)  # room for a long
    centers[1:] += np.cumsum(sizes[:-1] // 4 + sizes[1:] // 4)  # left half
    starts = centers - sizes // 2
    # reach[k]: the first position that packet k or a later one adds to;
    # every position before it is final once the packets before k are in
    reach = np.minimum.accumulate(starts[::-1])[::-1]
    spans = _spans(audio, centers)
    total = sum(hi - lo for lo, hi in spans)
    out = np.zeros((total,) if fold else (total, ch), np.float32)
    base = 0  # buf[:, i] is position base + i
    buf = np.zeros((ch, 0), np.float32)
    at = 0  # samples written to out
    span = 0  # the next span to write, from position max(its lo, cursor)
    cursor = 0
    k0 = 0
    while k0 < len(audio):
        k1, values = k0 + 1, int(sizes[k0]) // 2 * ch
        while k1 < len(audio) and values + sizes[k1] // 2 * ch <= BLOCK_VALUES:
            values += int(sizes[k1]) // 2 * ch
            k1 += 1
        spec, off = spectra(audio[k0:k1])
        top = int((centers[k0:k1] + sizes[k0:k1] // 2).max())
        if top > base + buf.shape[1]:
            buf = np.concatenate([buf, np.zeros(
                (ch, top - base - buf.shape[1]), np.float32)], axis=1)
        for flag in (0, 1):
            idx = [k for k in range(k0, k1) if audio[k][1][0] == flag]
            n = s.blocksizes[flag]
            for a in range(0, len(idx), IMDCT_BATCH):
                part = idx[a:a + IMDCT_BATCH]
                y = imdct(np.stack([spec[off[k - k0]:off[k - k0 + 1]].reshape(
                    ch, n // 2) for k in part]))
                for j, k in enumerate(part):
                    _, prev, nxt, _, _ = audio[k][1]
                    left = bs1 // 2 if flag and prev else bs0 // 2
                    right = bs1 // 2 if flag and nxt else bs0 // 2
                    start = int(starts[k]) - base
                    buf[:, start:start + n] += y[j] * window(n, left, right)
        safe = int(reach[k1]) if k1 < len(audio) else base + buf.shape[1]
        pieces = []
        while span < len(spans):
            lo, hi = spans[span]
            lo = max(lo, cursor)
            stop = min(hi, safe)
            if stop > lo:
                pieces.append(buf[:, lo - base:stop - base])
            if hi > safe:
                cursor = max(lo, safe)
                break
            span += 1
        if pieces:
            pcm = np.clip(np.round(np.concatenate(pieces, axis=1).T
                                   * np.float32(32768.0)), -32768, 32767
                          ) / np.float32(32768.0)
            out[at:at + len(pcm)] = fold(pcm) if fold else pcm
            at += len(pcm)
        buf = buf[:, safe - base:].copy()
        base = safe
        k0 = k1
    return out


# Floor 1's inverse dB table (the specification's floor1_inverse_dB_table),
# float32 as libvorbis holds it.
FLOOR1_DB = np.asarray([
    1.0649863e-07, 1.1341951e-07, 1.2079015e-07, 1.2863978e-07, 1.369995e-07,
    1.459025e-07, 1.5538409e-07, 1.6548181e-07, 1.7623574e-07, 1.8768856e-07,
    1.998856e-07, 2.1287531e-07, 2.2670913e-07, 2.4144197e-07, 2.5713223e-07,
    2.7384212e-07, 2.9163792e-07, 3.1059022e-07, 3.307741e-07, 3.5226967e-07,
    3.7516213e-07, 3.995423e-07, 4.2550681e-07, 4.5315863e-07, 4.8260745e-07,
    5.1397001e-07, 5.4737063e-07, 5.8294188e-07, 6.2082472e-07, 6.6116939e-07,
    7.0413591e-07, 7.4989464e-07, 7.9862701e-07, 8.5052631e-07, 9.0579829e-07,
    9.6466215e-07, 1.0273513e-06, 1.0941144e-06, 1.1652161e-06, 1.2409384e-06,
    1.3215816e-06, 1.4074654e-06, 1.4989305e-06, 1.5963394e-06, 1.7000785e-06,
    1.8105592e-06, 1.9282195e-06, 2.053526e-06, 2.1869757e-06, 2.3290977e-06,
    2.4804558e-06, 2.6416496e-06, 2.813319e-06, 2.9961443e-06, 3.1908505e-06,
    3.3982101e-06, 3.6190449e-06, 3.8542307e-06, 4.1047006e-06, 4.3714472e-06,
    4.6555283e-06, 4.9580708e-06, 5.2802739e-06, 5.6234162e-06, 5.9888571e-06,
    6.3780467e-06, 6.7925284e-06, 7.2339453e-06, 7.7040477e-06, 8.2047e-06,
    8.7378876e-06, 9.3057251e-06, 9.9104636e-06, 1.0554501e-05, 1.1240392e-05,
    1.1970856e-05, 1.2748789e-05, 1.3577278e-05, 1.4459606e-05, 1.5399271e-05,
    1.6400005e-05, 1.7465769e-05, 1.8600793e-05, 1.9809577e-05, 2.1096914e-05,
    2.2467912e-05, 2.3928002e-05, 2.5482977e-05, 2.7139005e-05, 2.890265e-05,
    3.078091e-05, 3.2781227e-05, 3.4911533e-05, 3.7180282e-05, 3.9596467e-05,
    4.2169668e-05, 4.4910092e-05, 4.7828602e-05, 5.0936775e-05, 5.4246932e-05,
    5.7772202e-05, 6.1526567e-05, 6.552491e-05, 6.9783084e-05, 7.4317984e-05,
    7.9147583e-05, 8.4291038e-05, 8.976875e-05, 9.5602423e-05, 0.00010181521,
    0.00010843174, 0.00011547824, 0.00012298267, 0.00013097477, 0.00013948625,
    0.00014855085, 0.00015820454, 0.00016848555, 0.00017943469, 0.00019109536,
    0.00020351382, 0.0002167393, 0.00023082423, 0.00024582449, 0.00026179955,
    0.00027881275, 0.00029693157, 0.00031622787, 0.00033677815, 0.00035866388,
    0.00038197188, 0.00040679457, 0.00043323037, 0.0004613841, 0.00049136748,
    0.00052329927, 0.00055730622, 0.00059352309, 0.00063209358, 0.00067317061,
    0.00071691698, 0.00076350628, 0.00081312325, 0.00086596457, 0.00092223985,
    0.00098217221, 0.0010459992, 0.0011139743, 0.0011863665, 0.0012634633,
    0.0013455702, 0.0014330129, 0.0015261382, 0.0016253153, 0.0017309374,
    0.0018434235, 0.0019632196, 0.0020908006, 0.0022266726, 0.0023713743,
    0.0025254795, 0.0026895993, 0.0028643848, 0.0030505287, 0.0032487691,
    0.0034598925, 0.0036847359, 0.0039241905, 0.0041792067, 0.0044507948,
    0.0047400328, 0.0050480668, 0.0053761187, 0.005725489, 0.0060975635,
    0.0064938175, 0.0069158226, 0.0073652514, 0.0078438874, 0.0083536273,
    0.0088964924, 0.009474637, 0.010090352, 0.01074608, 0.011444421,
    0.012188144, 0.012980198, 0.013823725, 0.014722068, 0.015678791,
    0.016697686, 0.017782796, 0.018938422, 0.020169148, 0.021479854,
    0.022875736, 0.024362329, 0.025945531, 0.027631618, 0.029427277,
    0.031339627, 0.03337625, 0.035545226, 0.037855156, 0.0403152, 0.042935107,
    0.045725275, 0.048696756, 0.051861349, 0.05523159, 0.058820851,
    0.062643364, 0.066714279, 0.07104975, 0.075666964, 0.080584228,
    0.085821047, 0.09139818, 0.097337745, 0.1036633, 0.11039993, 0.11757434,
    0.12521498, 0.13335215, 0.14201812, 0.15124726, 0.16107617, 0.17154381,
    0.18269168, 0.19456401, 0.20720787, 0.22067343, 0.23501402, 0.25028655,
    0.26655158, 0.28387362, 0.30232131, 0.32196787, 0.34289113, 0.36517414,
    0.3889052, 0.41417846, 0.44109413, 0.4697589, 0.50028646, 0.53279793,
    0.56742209, 0.60429639, 0.64356697, 0.68538958, 0.72993004, 0.77736503,
    0.82788259, 0.88168305, 0.9389798, 1], np.float32).astype(np.float64)
