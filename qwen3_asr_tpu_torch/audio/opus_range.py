"""The Opus range decoder (RFC 6716 §4.1), the plain version.

Every symbol of a SILK or CELT frame comes through one ``RangeDecoder``
over the frame's bytes: ``decode``/``update`` for a frequency table,
``bit_logp`` for a binary symbol of probability 2**-logp, ``icdf`` for an
inverse-CDF table of 8-bit entries, ``uint`` for a uniform integer, and
``bits`` for raw bits, which are read from the end of the frame backwards.
``tell`` and ``tell_frac`` count the bits used so far (whole, and in 1/8
bits), as the encoder counted them.

The C++ helper (``csrc/audio_dsp.cpp``) has the same decoder (``OpusRange``)
and decodes to the same bits.
"""
from __future__ import annotations

SYM_BITS = 8
CODE_BITS = 32
SYM_MAX = (1 << SYM_BITS) - 1
CODE_TOP = 1 << (CODE_BITS - 1)
CODE_BOT = CODE_TOP >> SYM_BITS
CODE_EXTRA = (CODE_BITS - 2) % SYM_BITS + 1
WINDOW_SIZE = 32
UINT_BITS = 8
BITRES = 3


def ilog(x: int) -> int:
    """The number of bits of ``x`` (0 for 0)."""
    return x.bit_length()


class RangeDecoder:
    __slots__ = ("buf", "storage", "offs", "end_offs", "end_window",
                 "nend_bits", "nbits_total", "rng", "val", "rem", "ext",
                 "error")

    def __init__(self, buf: bytes, storage: int = -1):
        self.buf = buf
        self.storage = len(buf) if storage < 0 else storage
        self.end_offs = 0
        self.end_window = 0
        self.nend_bits = 0
        self.nbits_total = CODE_BITS + 1 - (
            (CODE_BITS - CODE_EXTRA) // SYM_BITS) * SYM_BITS
        self.offs = 0
        self.rng = 1 << CODE_EXTRA
        self.rem = self._byte()
        self.val = self.rng - 1 - (self.rem >> (SYM_BITS - CODE_EXTRA))
        self.ext = 0
        self.error = 0
        self._normalize()

    def _byte(self) -> int:
        if self.offs < self.storage:
            b = self.buf[self.offs]
            self.offs += 1
            return b
        return 0

    def _byte_from_end(self) -> int:
        if self.end_offs < self.storage:
            self.end_offs += 1
            return self.buf[self.storage - self.end_offs]
        return 0

    def _normalize(self) -> None:
        while self.rng <= CODE_BOT:
            self.nbits_total += SYM_BITS
            self.rng = (self.rng << SYM_BITS) & 0xFFFFFFFF
            sym = self.rem
            self.rem = self._byte()
            sym = ((sym << SYM_BITS) | self.rem) >> (SYM_BITS - CODE_EXTRA)
            self.val = ((self.val << SYM_BITS) + (SYM_MAX & ~sym)) \
                & (CODE_TOP - 1)

    def decode(self, ft: int) -> int:
        self.ext = self.rng // ft
        s = self.val // self.ext
        return ft - min(s + 1, ft)

    def decode_bin(self, bits: int) -> int:
        self.ext = self.rng >> bits
        s = self.val // self.ext
        return (1 << bits) - min(s + 1, 1 << bits)

    def update(self, fl: int, fh: int, ft: int) -> None:
        s = self.ext * (ft - fh)
        self.val -= s
        self.rng = self.ext * (fh - fl) if fl > 0 else self.rng - s
        self._normalize()

    def bit_logp(self, logp: int) -> int:
        r, d = self.rng, self.val
        s = r >> logp
        ret = int(d < s)
        if not ret:
            self.val = d - s
        self.rng = s if ret else r - s
        self._normalize()
        return ret

    def icdf(self, icdf, ftb: int) -> int:
        s, d = self.rng, self.val
        r = s >> ftb
        ret = -1
        while True:
            t = s
            ret += 1
            s = r * icdf[ret]
            if d >= s:
                break
        self.val = d - s
        self.rng = t - s
        self._normalize()
        return ret

    def uint(self, ft: int) -> int:
        ft -= 1
        ftb = ilog(ft)
        if ftb > UINT_BITS:
            ftb -= UINT_BITS
            f = (ft >> ftb) + 1
            s = self.decode(f)
            self.update(s, s + 1, f)
            t = (s << ftb) | self.bits(ftb)
            if t <= ft:
                return t
            self.error = 1
            return ft
        ft += 1
        s = self.decode(ft)
        self.update(s, s + 1, ft)
        return s

    def bits(self, n: int) -> int:
        window, available = self.end_window, self.nend_bits
        if available < n:
            while True:
                window |= self._byte_from_end() << available
                available += SYM_BITS
                if available > WINDOW_SIZE - SYM_BITS:
                    break
        ret = window & ((1 << n) - 1)
        self.end_window = window >> n
        self.nend_bits = available - n
        self.nbits_total += n
        return ret

    def tell(self) -> int:
        return self.nbits_total - ilog(self.rng)

    def tell_frac(self) -> int:
        nbits = self.nbits_total << BITRES
        lg = ilog(self.rng)
        r = self.rng >> (lg - 16)
        for _ in range(BITRES):
            r = (r * r) >> 15
            b = r >> 16
            lg = (lg << 1) | b
            r >>= b
        return nbits - lg
