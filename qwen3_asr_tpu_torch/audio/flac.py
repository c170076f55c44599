"""FLAC decoder and a small encoder — numpy, no libFLAC.

Counterpart of ``qwen3_asr_tpu/audio/flac.py``:

* ``decode_flac(bytes) -> (mono float32, sample_rate)``: STREAMINFO,
  fixed, LPC, constant and verbatim subframes, Rice and Rice2 residual
  partitions (escape codes too), wasted bits, and left/side, right/side
  and mid/side stereo, with JAX's samples, errors and messages. The
  per-sample work (Rice and raw residuals, the prediction recurrence) runs
  in C++ (``csrc/audio_dsp.cpp`` through ``audio/native.py``), handed an
  absolute bit offset by the Python ``_BitReader``; the Python loops are
  its plain version, taken when the helper cannot be built or when the
  caller asks for them (``native=False``).
* ``encode_flac(float32, sr, ...)``: JAX's encoder (fixed predictors of
  order 0-2 on one Rice partition, the stereo modes, and the test writer's
  LPC, multi-partition, Rice2, escape, verbatim and wasted-bits
  subframes), byte for byte, with numpy packing each frame's bit fields
  at once; for tests and fixtures.
"""
from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

from .codec import AudioDecodeError


class FlacError(AudioDecodeError):
    pass


# -- bit reader ------------------------------------------------------------------


class _BitReader:
    __slots__ = ("data", "byte_pos", "bit_buf", "bit_cnt")

    def __init__(self, data: bytes, byte_pos: int = 0):
        self.data = data
        self.byte_pos = byte_pos
        self.bit_buf = 0
        self.bit_cnt = 0

    def read(self, n: int) -> int:
        """Read n bits, MSB-first, unsigned."""
        while self.bit_cnt < n:
            if self.byte_pos >= len(self.data):
                raise FlacError("unexpected end of FLAC stream")
            self.bit_buf = (self.bit_buf << 8) | self.data[self.byte_pos]
            self.byte_pos += 1
            self.bit_cnt += 8
        self.bit_cnt -= n
        out = self.bit_buf >> self.bit_cnt
        self.bit_buf &= (1 << self.bit_cnt) - 1
        return out

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >> (n - 1) else v

    def read_unary(self) -> int:
        """Count 0-bits until the terminating 1-bit."""
        q = 0
        while True:
            if self.bit_cnt == 0:
                if self.byte_pos >= len(self.data):
                    raise FlacError("unexpected end of FLAC stream")
                self.bit_buf = self.data[self.byte_pos]
                self.byte_pos += 1
                self.bit_cnt = 8
            if self.bit_buf == 0:  # whole remaining buffer is zeros
                q += self.bit_cnt
                self.bit_cnt = 0
                continue
            top = self.bit_buf.bit_length()
            q += self.bit_cnt - top
            # consume the zeros and the 1-bit
            self.bit_cnt = top - 1
            self.bit_buf &= (1 << self.bit_cnt) - 1
            return q

    def align(self) -> None:
        self.bit_cnt = 0
        self.bit_buf = 0

    def bit_pos(self) -> int:
        """Absolute bit offset into the stream (for the C++ hand-off)."""
        return self.byte_pos * 8 - self.bit_cnt

    def seek(self, abs_bit: int) -> None:
        """Resume reading at an absolute bit offset."""
        self.byte_pos = abs_bit >> 3
        self.bit_buf = 0
        self.bit_cnt = 0
        if abs_bit & 7:
            self.read(abs_bit & 7)


# -- decoder ---------------------------------------------------------------------

_BLOCKSIZE_TABLE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_BPS_TABLE = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}
_FIXED_COEFFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _read_utf8_number(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise FlacError("invalid UTF-8 coded number")
    val = b0 & (mask - 1)
    for _ in range(n_extra):
        b = br.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("invalid UTF-8 continuation")
        val = (val << 6) | (b & 0x3F)
    return val


def _stream(br: _BitReader) -> np.ndarray:
    return np.frombuffer(br.data, np.uint8)


def _read_raw(br: _BitReader, n: int, bits: int, lib) -> np.ndarray:
    """n two's-complement values of ``bits`` bits -> int64 array."""
    out = np.empty(n, np.int64)
    if n == 0:
        return out
    if lib is not None:
        data = _stream(br)
        new = lib.flac_raw_decode(data, len(data), br.bit_pos(), n, bits, out)
        if new < 0:
            raise FlacError("unexpected end of FLAC stream")
        br.seek(new)
    else:
        for i in range(n):
            out[i] = br.read_signed(bits)
    return out


def _read_residual(br: _BitReader, blocksize: int, order: int,
                   lib) -> np.ndarray:
    method = br.read(2)
    if method > 1:
        raise FlacError(f"reserved residual method {method}")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    po = br.read(4)
    n_parts = 1 << po
    if blocksize % n_parts:
        raise FlacError("partition order does not divide block size")
    part_samples = blocksize >> po
    if part_samples < order or (part_samples == order and n_parts == 1):
        # partition 0 holds part_samples - order residuals: fewer than none
        # (or none and no later partition) is malformed
        raise FlacError("invalid partition size")
    data = _stream(br) if lib is not None else None
    out = np.empty(blocksize - order, np.int64)
    pos = 0
    read, read_unary = br.read, br.read_unary
    for part in range(n_parts):
        n = part_samples - (order if part == 0 else 0)
        param = read(plen)
        seg = out[pos:pos + n]
        pos += n
        if param == escape:
            raw_bits = read(5)
            if raw_bits == 0:
                seg[:] = 0
            elif lib is not None:
                new = lib.flac_raw_decode(data, len(data), br.bit_pos(), n,
                                          raw_bits, seg)
                if new < 0:
                    raise FlacError("unexpected end of FLAC stream")
                br.seek(new)
            else:
                sign = 1 << (raw_bits - 1)
                full = 1 << raw_bits
                for i in range(n):
                    v = read(raw_bits)
                    seg[i] = v - full if v & sign else v
        elif lib is not None:
            new = lib.flac_rice_decode(data, len(data), br.bit_pos(), n,
                                       param, seg)
            if new < 0:
                raise FlacError("unexpected end of FLAC stream")
            br.seek(new)
        else:
            for i in range(n):
                u = (read_unary() << param) | (read(param) if param else 0)
                seg[i] = (u >> 1) ^ -(u & 1)
    return out


def _predict(warm: np.ndarray, resid: np.ndarray, coeffs: np.ndarray,
             shift: int, lib) -> np.ndarray:
    """Samples from warm-up + residual by the prediction recurrence
    (buf[i] += (coeffs · history) >> shift)."""
    order = len(coeffs)
    buf = np.empty(order + len(resid), np.int64)
    buf[:order] = warm
    buf[order:] = resid
    if order == 0:
        return buf
    if lib is not None:
        lib.flac_predict(buf, len(buf),
                         np.ascontiguousarray(coeffs, np.int32), order, shift)
        return buf
    b = buf.tolist()  # plain ints: the recurrence in exact arithmetic
    cs = [int(c) for c in coeffs]
    for i in range(order, len(b)):
        pred = 0
        for j in range(order):
            pred += cs[j] * b[i - 1 - j]
        b[i] += pred >> shift
    return np.array(b, np.int64)


def _decode_subframe(br: _BitReader, blocksize: int, bps: int,
                     lib) -> np.ndarray:
    if br.read(1):
        raise FlacError("invalid subframe padding bit")
    sf_type = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = br.read_unary() + 1
    bps -= wasted
    if bps <= 0:
        raise FlacError("wasted bits exceed sample size")

    if sf_type == 0:  # CONSTANT
        samples = np.full(blocksize, br.read_signed(bps), np.int64)
    elif sf_type == 1:  # VERBATIM
        samples = _read_raw(br, blocksize, bps, lib)
    elif 8 <= sf_type <= 12:  # FIXED, order = sf_type - 8
        order = sf_type - 8
        warm = _read_raw(br, order, bps, lib)
        resid = _read_residual(br, blocksize, order, lib)
        samples = _predict(warm, resid,
                           np.array(_FIXED_COEFFS[order], np.int64), 0, lib)
    elif sf_type >= 32:  # LPC, order = (sf_type & 31) + 1
        order = (sf_type & 31) + 1
        warm = _read_raw(br, order, bps, lib)
        precision = br.read(4) + 1
        if precision == 16:
            raise FlacError("invalid LPC precision")
        shift = br.read_signed(5)
        if shift < 0:
            raise FlacError("negative LPC shift")
        coeffs = np.array([br.read_signed(precision) for _ in range(order)],
                          np.int64)
        resid = _read_residual(br, blocksize, order, lib)
        samples = _predict(warm, resid, coeffs, shift, lib)
    else:
        raise FlacError(f"reserved subframe type {sf_type}")

    if wasted:
        samples = samples << wasted
    return samples


def _parse_streaminfo(data: bytes) -> dict:
    if data[:4] != b"fLaC":
        raise FlacError("missing fLaC magic")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        hdr = struct.unpack(">I", data[pos:pos + 4])[0]
        last = hdr >> 31
        btype = (hdr >> 24) & 0x7F
        blen = hdr & 0xFFFFFF
        body = data[pos + 4:pos + 4 + blen]
        if btype == 0:
            if blen < 34:
                raise FlacError("short STREAMINFO")
            br = _BitReader(body)
            info = {
                "min_blocksize": br.read(16), "max_blocksize": br.read(16),
                "min_framesize": br.read(24), "max_framesize": br.read(24),
                "sample_rate": br.read(20),
                "channels": br.read(3) + 1,
                "bps": br.read(5) + 1,
                "total_samples": br.read(36),
            }
        pos += 4 + blen
        if last:
            break
    if info is None:
        raise FlacError("no STREAMINFO block")
    if info["sample_rate"] == 0:
        raise FlacError("invalid sample rate")
    info["audio_start"] = pos
    return info


def decode_flac(data: bytes, native: bool = True) -> Tuple[np.ndarray, int]:
    """Decode a FLAC stream -> (mono float32 in [-1,1], sample_rate).
    ``native=False`` takes the Python loops (the plain version) even where
    the C++ helper is built."""
    from . import native as native_mod
    lib = native_mod.get_lib() if native else None
    info = _parse_streaminfo(data)
    sr, n_ch, bps0 = info["sample_rate"], info["channels"], info["bps"]
    br = _BitReader(data, info["audio_start"])
    chans: List[List[np.ndarray]] = [[] for _ in range(n_ch)]
    total = info["total_samples"]
    got = 0

    while br.byte_pos < len(data) and (total == 0 or got < total):
        try:
            sync = br.read(14)
        except FlacError:
            break
        if sync != 0x3FFE:
            if total == 0 and got:
                # unknown stream length (total_samples = 0): trailing
                # padding or tags after the last frame end the stream
                break
            raise FlacError(f"lost frame sync at byte {br.byte_pos}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_code = br.read(4)
        sr_code = br.read(4)
        ch_code = br.read(4)
        bps_code = br.read(3)
        br.read(1)  # reserved
        _read_utf8_number(br)
        if bs_code == 0:
            raise FlacError("reserved block size code")
        elif bs_code == 6:
            blocksize = br.read(8) + 1
        elif bs_code == 7:
            blocksize = br.read(16) + 1
        else:
            blocksize = _BLOCKSIZE_TABLE[bs_code]
        if sr_code == 12:
            br.read(8)
        elif sr_code in (13, 14):
            br.read(16)
        elif sr_code == 15:
            raise FlacError("invalid sample rate code")
        bps = _BPS_TABLE.get(bps_code, bps0) if bps_code else bps0
        br.read(8)  # header CRC-8 (not verified)

        if ch_code < 8:
            if ch_code + 1 != n_ch:
                raise FlacError("channel count changed mid-stream")
            subs = [_decode_subframe(br, blocksize, bps, lib)
                    for _ in range(n_ch)]
        elif ch_code in (8, 9, 10):
            if n_ch != 2:
                raise FlacError("stereo decorrelation in non-stereo stream")
            bps_a = bps + (1 if ch_code == 9 else 0)
            bps_b = bps + (1 if ch_code in (8, 10) else 0)
            a = _decode_subframe(br, blocksize, bps_a, lib)
            b = _decode_subframe(br, blocksize, bps_b, lib)
            if ch_code == 8:      # left/side
                subs = [a, a - b]
            elif ch_code == 9:    # right/side: a=side, b=right
                subs = [b + a, b]
            else:                 # mid/side
                mid2 = (a << 1) | (b & 1)
                subs = [(mid2 + b) >> 1, (mid2 - b) >> 1]
        else:
            raise FlacError(f"reserved channel assignment {ch_code}")

        br.align()
        br.read(16)  # frame CRC-16 (not verified)
        for c in range(n_ch):
            chans[c].append(subs[c])
        got += blocksize

    if not chans[0]:
        raise FlacError("no audio frames decoded")
    pcm = np.stack([np.concatenate(c) for c in chans], axis=1)
    if total:
        pcm = pcm[:total]
    mono = pcm.mean(axis=1)
    return (mono / float(1 << (bps0 - 1))).astype(np.float32), sr


# -- encoder ---------------------------------------------------------------------


class _Fields:
    """A run of bit fields (value, width), MSB first, packed at once.
    A value is cut to its width, as JAX's ``_BitWriter.write`` does."""

    def __init__(self):
        self._vals: List[np.ndarray] = []
        self._widths: List[np.ndarray] = []

    def add(self, value, width) -> None:
        self._vals.append(np.atleast_1d(np.asarray(value, np.int64)))
        self._widths.append(np.broadcast_to(
            np.asarray(width, np.int64), self._vals[-1].shape))

    def unary(self, q: np.ndarray) -> None:
        """Each q as q zero bits and a one."""
        self.add(np.ones_like(q), q + 1)

    def rice(self, resid: np.ndarray, param: int) -> None:
        """Zigzag Rice codes of ``resid`` with parameter ``param``."""
        e = np.asarray(resid, np.int64)
        u = np.where(e >= 0, e << 1, ((-e) << 1) - 1)
        vals = np.stack([np.ones_like(u), u & ((1 << param) - 1)], 1)
        widths = np.stack([(u >> param) + 1, np.full_like(u, param)], 1)
        self.add(vals.ravel(), widths.ravel())

    def pack(self) -> bytes:
        """The fields' bits, zero-padded to a whole byte."""
        if not self._vals:
            return b""
        widths = np.concatenate(self._widths)
        vals = np.concatenate(self._vals).astype(np.uint64)
        small = widths < 64
        mask = np.where(small, (np.uint64(1) << np.where(
            small, widths, 0).astype(np.uint64)) - np.uint64(1),
            np.uint64(0xFFFFFFFFFFFFFFFF))
        vals &= mask
        ends = np.cumsum(widths)
        total = int(ends[-1]) if len(ends) else 0
        bits = np.zeros((total + 7) // 8 * 8, np.uint8)
        top = int(vals.max()).bit_length() if len(vals) else 0
        for k in range(top):
            on = ((vals >> np.uint64(k)) & np.uint64(1)).astype(bool)
            bits[ends[on] - 1 - k] = 1
        return np.packbits(bits).tobytes()


def _crc_table(poly: int, width: int) -> List[int]:
    top, full = 1 << (width - 1), (1 << width) - 1
    table = []
    for byte in range(256):
        crc = byte << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) & full if crc & top else \
                (crc << 1) & full
        table.append(crc)
    return table


_CRC8 = _crc_table(0x07, 8)
_CRC16 = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC8[crc ^ b]
    return crc


def _crc16(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = ((crc << 8) & 0xFFFF) ^ _CRC16[(crc >> 8) ^ b]
    return crc


def _utf8_number(fields: _Fields, val: int) -> None:
    if val < 0x80:
        fields.add(val, 8)
        return
    limits = [(1, 11), (2, 16), (3, 21), (4, 26), (5, 31), (6, 36)]
    for n_extra, bits in limits:
        if val < (1 << bits):
            break
    lead = (0xFF << (7 - n_extra)) & 0xFF
    fields.add(lead | (val >> (6 * n_extra)), 8)
    for i in range(n_extra - 1, -1, -1):
        fields.add(0x80 | ((val >> (6 * i)) & 0x3F), 8)


def _best_rice_param(resid: np.ndarray, plen: int) -> int:
    if len(resid) == 0:
        return 0
    u = np.abs(resid.astype(np.int64)) * 2
    mean = max(float(u.mean()), 0.1)
    param = max(0, int(np.log2(mean)))
    return min(param, (1 << plen) - 2)


def _write_subframe(f: _Fields, x: np.ndarray, bps: int) -> None:
    """The cheapest of fixed orders 0-2 on one Rice partition."""
    x = x.astype(np.int64)
    best_order, best_cost, best_resid = 0, None, x
    for order in (0, 1, 2):
        if len(x) <= order:
            break
        resid = np.diff(x, n=order) if order else x.copy()
        param = _best_rice_param(resid, 4)
        u = (np.abs(resid) * 2 - (resid < 0).astype(np.int64))
        cost = int((u >> param).sum()) + len(resid) * (1 + param) + order * bps
        if best_cost is None or cost < best_cost:
            best_order, best_cost, best_resid = order, cost, resid
    order, resid = best_order, best_resid
    f.add([0, 8 + order, 0], [1, 6, 1])   # pad, FIXED type, no wasted bits
    f.add(x[:order], bps)                 # warm-up
    param = _best_rice_param(resid, 4)
    f.add([0, 0, param], [2, 4, 4])       # Rice, partition order 0
    f.rice(resid, param)


def _rice_residual(f: _Fields, resid: np.ndarray, order: int,
                   partition_order: int, rice2: bool, escape: bool) -> None:
    """Residual section: method and partition header, then each
    partition's codes."""
    plen = 5 if rice2 else 4
    f.add([1 if rice2 else 0, partition_order], [2, 4])
    n_parts = 1 << partition_order
    part_samples = (len(resid) + order) >> partition_order
    pos = 0
    for part in range(n_parts):
        n = part_samples - (order if part == 0 else 0)
        seg = resid[pos:pos + n]
        pos += n
        if escape:
            peak = int(np.abs(seg).max()) if len(seg) else 0
            raw_bits = max(peak.bit_length() + 1, 2)
            f.add([(1 << plen) - 1, raw_bits], [plen, 5])
            f.add(seg, raw_bits)
        else:
            param = _best_rice_param(seg, plen)
            f.add(param, plen)
            f.rice(seg, param)


def _wasted_bits(f: _Fields, wasted: int) -> None:
    if wasted:
        f.add(1, 1)
        f.unary(np.array([wasted - 1]))
    else:
        f.add(0, 1)


def _write_subframe_ex(f: _Fields, x: np.ndarray, bps: int, *,
                       mode: str = "fixed", fixed_order: int = 1,
                       lpc_coeffs: Tuple[int, ...] = (7, -3),
                       lpc_shift: int = 2, lpc_precision: int = 5,
                       partition_order: int = 0, rice2: bool = False,
                       wasted: int = 0, escape: bool = False) -> None:
    """JAX's test writer: LPC subframes, multi-partition Rice, Rice2,
    escape partitions, verbatim subframes and wasted bits."""
    x = x.astype(np.int64)
    if wasted:
        x = x >> wasted   # the samples lose low bits; the decoder shifts back
    eff_bps = bps - wasted
    f.add(0, 1)  # pad
    if mode == "verbatim":
        f.add(1, 6)
        _wasted_bits(f, wasted)
        f.add(x, eff_bps)
        return
    if mode == "lpc":
        order = len(lpc_coeffs)
        f.add(32 + (order - 1), 6)
        _wasted_bits(f, wasted)
        f.add(x[:order], eff_bps)
        f.add([lpc_precision - 1, lpc_shift & 0x1F], [4, 5])
        f.add(list(lpc_coeffs), lpc_precision)
        n = len(x)
        pred = np.zeros(n - order, np.int64)
        for j, c in enumerate(lpc_coeffs):
            pred += int(c) * x[order - 1 - j:n - 1 - j]
        resid = x[order:] - (pred >> lpc_shift)
    else:
        order = fixed_order
        f.add(8 + order, 6)
        _wasted_bits(f, wasted)
        f.add(x[:order], eff_bps)
        resid = np.diff(x, n=order) if order else x.copy()
    _rice_residual(f, resid, order, partition_order, rice2, escape)


def encode_flac(audio: np.ndarray, sr: int, bps: int = 16,
                blocksize: int = 4096, stereo_mode: str = "independent",
                channels: Optional[np.ndarray] = None,
                subframe_opts: Optional[dict] = None) -> bytes:
    """Encode float32 [-1,1] (mono, or [N, C] via ``channels``) to FLAC,
    the JAX package's ``encode_flac`` bytes for the same arguments.

    stereo_mode: independent | left_side | right_side | mid_side.
    subframe_opts: keyword arguments of ``_write_subframe_ex`` (LPC,
    multi-partition Rice, Rice2, escape, verbatim, wasted bits)."""
    if channels is not None:
        pcm = np.clip(channels, -1.0, 1.0)
    else:
        pcm = np.clip(np.asarray(audio, np.float64), -1.0, 1.0)[:, None]
    n_ch = pcm.shape[1]
    scale = (1 << (bps - 1)) - 1
    ints = np.round(pcm * scale).astype(np.int64)
    n = len(ints)

    si = _Fields()
    si.add([blocksize, blocksize, 0, 0, sr, n_ch - 1, bps - 1, n],
           [16, 16, 24, 24, 20, 3, 5, 36])
    body = si.pack() + b"\x00" * 16  # 18 bytes of fields + unset md5
    out = bytearray(b"fLaC")
    out += struct.pack(">I", (1 << 31) | len(body))
    out += body

    if n_ch == 2 and stereo_mode != "independent":
        ch_code = {"left_side": 8, "right_side": 9, "mid_side": 10}[
            stereo_mode]
    else:
        ch_code = n_ch - 1
    bps_code = {8: 1, 12: 2, 16: 4, 20: 5, 24: 6, 32: 7}[bps]
    for frame_idx, start in enumerate(range(0, n, blocksize)):
        block = ints[start:start + blocksize]
        bs = len(block)
        hdr = _Fields()
        # sync, reserved, fixed blocking, 16-bit block size and 16-bit
        # rate (Hz) at the header's end, channels, sample size, reserved
        hdr.add([0x3FFE, 0, 0, 7, 13, ch_code, bps_code, 0],
                [14, 1, 1, 4, 4, 4, 3, 1])
        _utf8_number(hdr, frame_idx)
        hdr.add([bs - 1, sr & 0xFFFF], [16, 16])
        header = hdr.pack()
        sub = _Fields()
        if ch_code < 8:
            for c in range(n_ch):
                if subframe_opts is not None:
                    _write_subframe_ex(sub, block[:, c], bps,
                                       **subframe_opts)
                else:
                    _write_subframe(sub, block[:, c], bps)
        else:
            left, right = block[:, 0], block[:, 1]
            side = left - right
            if ch_code == 8:
                _write_subframe(sub, left, bps)
                _write_subframe(sub, side, bps + 1)
            elif ch_code == 9:
                _write_subframe(sub, side, bps + 1)
                _write_subframe(sub, right, bps)
            else:
                _write_subframe(sub, (left + right) >> 1, bps)
                _write_subframe(sub, side, bps + 1)
        frame = header + bytes([_crc8(header)]) + sub.pack()
        out += frame + struct.pack(">H", _crc16(frame))
    return bytes(out)
