"""Tables of MPEG audio Layer I and II (ISO/IEC 11172-3 §2.4.3.1-2 and
Annex B; ISO/IEC 13818-3 Annex B for the half rates).

* ``BITRATES[layer][lsf]``: kbit/s by the header's bitrate index
  (Table B.1 of 11172-3; Table B.1 of 13818-3 for 16-24 kHz).
* ``ALLOC``: Layer II's possible quantizations (Tables B.2a-d of 11172-3,
  B.1 of 13818-3): for each table the number of levels each allocation
  index of each subband means, ``nbal`` bits of index a subband; the
  number of subbands (``sblimit``) is the table's length.
* ``CLASSES``: every quantization as (bits of a code, levels of a grouped
  code or 0): 3, 5 and 9 levels pack three samples into one code, the rest
  take ``bits`` a sample. ``CLASS_OF_LEVELS`` maps Layer II's level
  counts to their classes; Layer I's allocation n takes n + 1 bits,
  ungrouped (``layer1_class``).
* ``MULMUL`` and ``GROUP_BASE``: the requantization as mpg123 computes
  it. An ungrouped code c of k bits is (c - 2**(k-1) + 1) * MULMUL[k]; a
  grouped code's digits d (least significant first) are
  MULMUL[GROUP_BASE[levels][d]]; both then times 2**((3 - sf) / 3) for
  the scale factor index sf (63 gives 0).
"""
from __future__ import annotations

import numpy as np

BITRATES = {
    1: ((0, 32, 64, 96, 128, 160, 192, 224, 256, 288, 320, 352, 384, 416,
         448),
        (0, 32, 48, 56, 64, 80, 96, 112, 128, 144, 160, 176, 192, 224, 256)),
    2: ((0, 32, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320, 384),
        (0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160)),
}

_HIGH = (3, 7, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383,
         32767, 65535)
_MID = (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
        65535)
_LOW = (3, 5, 7, 9, 15, 31, 65535)
_TOP = (3, 5, 65535)
_C_HIGH = (3, 5, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191, 16383,
           32767)
_C_LOW = (3, 5, 9, 15, 31, 63, 127)
_LSF_HIGH = (3, 5, 7, 9, 15, 31, 63, 127, 255, 511, 1023, 2047, 4095, 8191,
             16383)

# each table: per subband (nbal, levels of allocation index 1..)
ALLOC = (
    # B.2a: 27 subbands
    ((4, _HIGH),) * 3 + ((4, _MID),) * 8 + ((3, _LOW),) * 12
    + ((2, _TOP),) * 4,
    # B.2b: 30 subbands
    ((4, _HIGH),) * 3 + ((4, _MID),) * 8 + ((3, _LOW),) * 12
    + ((2, _TOP),) * 7,
    # B.2c: 8 subbands
    ((4, _C_HIGH),) * 2 + ((3, _C_LOW),) * 6,
    # B.2d: 12 subbands
    ((4, _C_HIGH),) * 2 + ((3, _C_LOW),) * 10,
    # 13818-3 B.1: the half rates, 30 subbands
    ((4, _LSF_HIGH),) * 4 + ((3, _C_LOW),) * 7 + ((2, (3, 5, 9)),) * 19,
)

# mpg123's choice of table for MPEG-1 by rate (44.1, 48, 32 kHz), channel
# count (stereo, mono) and the header's bitrate index
_TRANSLATE = (
    ((0, 2, 2, 2, 2, 2, 2, 0, 0, 0, 1, 1, 1, 1, 1, 0),
     (0, 2, 2, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0)),
    ((0, 2, 2, 2, 2, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0),
     (0, 2, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)),
    ((0, 3, 3, 3, 3, 3, 3, 0, 0, 0, 1, 1, 1, 1, 1, 0),
     (0, 3, 3, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0)),
)


def alloc_table(lsf: int, sr_index: int, channels: int,
                bitrate_index: int) -> int:
    """The index into ``ALLOC`` of a Layer II frame's table."""
    if lsf:
        return 4
    return _TRANSLATE[sr_index][2 - channels][bitrate_index]


CLASSES = ((0, 0), (5, 3), (7, 5), (10, 9)) + tuple(
    (k, 0) for k in range(2, 17))
# Layer II's classes by level count: 3, 5 and 9 levels are grouped
CLASS_OF_LEVELS = {**{(1 << k) - 1: k + 2 for k in range(3, 17)},
                   3: 1, 5: 2, 9: 3}


def layer1_class(a: int) -> int:
    """The class of Layer I's allocation ``a`` (1-15): a + 1 bits."""
    return a + 3


MULMUL = (0.0, -2.0 / 3.0, 2.0 / 3.0, 2.0 / 7.0, 2.0 / 15.0, 2.0 / 31.0,
          2.0 / 63.0, 2.0 / 127.0, 2.0 / 255.0, 2.0 / 511.0, 2.0 / 1023.0,
          2.0 / 2047.0, 2.0 / 4095.0, 2.0 / 8191.0, 2.0 / 16383.0,
          2.0 / 32767.0, 2.0 / 65535.0, -4.0 / 5.0, -2.0 / 5.0, 2.0 / 5.0,
          4.0 / 5.0, -8.0 / 9.0, -4.0 / 9.0, -2.0 / 9.0, 2.0 / 9.0,
          4.0 / 9.0, 8.0 / 9.0)
GROUP_BASE = {3: (1, 0, 2), 5: (17, 18, 0, 19, 20),
              9: (21, 1, 22, 23, 0, 24, 25, 2, 26)}


def _muls() -> np.ndarray:
    m = np.zeros((27, 64), np.float32)
    for k in range(27):
        m[k, :63] = [MULMUL[k] * 2.0 ** ((3 - i) / 3.0) for i in range(63)]
    return m


MULS = _muls()
"""float32 [27, 64]: MULMUL[k] * 2**((3 - sf) / 3), mpg123's ``muls``."""


def packed_alloc() -> np.ndarray:
    """int32 [5, 32, 17]: for each table and subband, nbal (0 past the
    table's subbands) and the class of each allocation index, for the
    C++ helper."""
    out = np.zeros((len(ALLOC), 32, 17), np.int32)
    for t, table in enumerate(ALLOC):
        for sb, (nbal, levels) in enumerate(table):
            out[t, sb, 0] = nbal
            for i, lv in enumerate(levels):
                out[t, sb, 2 + i] = CLASS_OF_LEVELS[lv]
    return out


PACKED_ALLOC = packed_alloc()
PACKED_CLASSES = np.asarray(CLASSES, np.int32)
