"""The Opus packet layer (RFC 6716 §3-4.5): the TOC, frame packing codes
0-3 (padding, code 3's VBR sizes), self-delimited framing for multistream
(Appendix B), and the decoder that sends each frame to SILK, CELT or both
(hybrid: SILK below 8 kHz, CELT from band 17, on one range coder), with
the redundancy frames and cross-fades of mode switches (§4.5) and the
header's output gain, as libopus 1.3.1's ``opus_decode_float`` decodes.

``MultistreamDecoder`` is channel mapping family 0 and 1's decoder
(RFC 7845 §5.1.1): one stream a packet's part, coupled streams first,
their channels placed by the mapping table.

The output is float64 in [-1, 1] at 48 kHz (beyond it where a stream is
that loud), before opusfile's 16-bit conversion (``audio/ogg_opus.py``).
Packet loss concealment runs where libopus runs it on a whole stream: a
frame with no payload (DTX) and a mode switch that carries no redundancy
frame (5 ms of the last mode's concealment to fade from).
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from . import celt as celt_mod
from .codec import AudioDecodeError
from .opus_range import RangeDecoder

MODE_SILK, MODE_HYBRID, MODE_CELT = 1000, 1001, 1002
NARROWBAND, MEDIUMBAND, WIDEBAND, SUPERWIDEBAND, FULLBAND = \
    1101, 1102, 1103, 1104, 1105
F20, F10, F5, F2_5 = 960, 480, 240, 120
GAIN_LOG = float(np.float32(6.48814081e-4))


class OpusError(AudioDecodeError):
    pass


def toc_info(toc: int) -> Tuple[int, int, int, int]:
    """(mode, bandwidth, samples a frame at 48 kHz, channels) of a TOC
    byte."""
    config = toc >> 3
    if config < 12:
        mode = MODE_SILK
        bandwidth = NARROWBAND + (config >> 2)
        size = (480, 960, 1920, 2880)[config & 3]
    elif config < 16:
        mode = MODE_HYBRID
        bandwidth = SUPERWIDEBAND + ((config >> 1) & 1)
        size = (480, 960)[config & 1]
    else:
        mode = MODE_CELT
        b = (config >> 2) & 3
        bandwidth = NARROWBAND if b == 0 else WIDEBAND + b - 1
        size = (120, 240, 480, 960)[config & 3]
    return mode, bandwidth, size, 2 if toc & 4 else 1


def _size(data: bytes, pos: int, end: int) -> Tuple[int, int]:
    """A frame length (1 or 2 bytes) at ``pos`` -> (length, bytes), or
    (-1, -1)."""
    if end - pos < 1:
        return -1, -1
    if data[pos] < 252:
        return data[pos], 1
    if end - pos < 2:
        return -1, -1
    return 4 * data[pos + 1] + data[pos], 2


def parse_packet(data: bytes, pos: int, end: int, self_delimited: bool
                 ) -> Tuple[int, List[Tuple[int, int]], int]:
    """The packet at data[pos:end] -> (TOC, [(offset, length)] of its
    frames, the offset past the packet and its padding).
    ``opus_packet_parse_impl``."""
    if end - pos < 1:
        raise OpusError("an empty Opus packet")
    framesize = toc_info(data[pos])[2]
    toc = data[pos]
    p = pos + 1
    length = end - p
    last_size = length
    pad = 0
    cbr = False
    sizes = []
    code = toc & 3
    if code == 0:
        count = 1
    elif code == 1:
        count = 2
        cbr = True
        if not self_delimited:
            if length & 1:
                raise OpusError("an odd code 1 packet")
            last_size = length // 2
            sizes = [last_size]
    elif code == 2:
        count = 2
        s, nb = _size(data, p, end)
        length -= nb
        if s < 0 or s > length:
            raise OpusError("a bad code 2 frame length")
        p += nb
        sizes = [s]
        last_size = length - s
    else:
        if length < 1:
            raise OpusError("a code 3 packet without its count")
        ch = data[p]
        p += 1
        count = ch & 0x3F
        if count <= 0 or framesize * count > 5760:
            raise OpusError("a bad code 3 frame count")
        length -= 1
        if ch & 0x40:
            while True:
                if length <= 0:
                    raise OpusError("bad Opus padding")
                v = data[p]
                p += 1
                length -= 1
                tmp = 254 if v == 255 else v
                length -= tmp
                pad += tmp
                if v != 255:
                    break
        if length < 0:
            raise OpusError("bad Opus padding")
        cbr = not (ch & 0x80)
        if not cbr:
            last_size = length
            for _ in range(count - 1):
                s, nb = _size(data, p, end)
                length -= nb
                if s < 0 or s > length:
                    raise OpusError("a bad code 3 frame length")
                p += nb
                sizes.append(s)
                last_size -= nb + s
            if last_size < 0:
                raise OpusError("a bad code 3 frame length")
        elif not self_delimited:
            last_size = length // count
            if last_size * count != length:
                raise OpusError("a bad code 3 CBR length")
            sizes = [last_size] * (count - 1)
    if self_delimited:
        s, nb = _size(data, p, end)
        length -= nb
        if s < 0 or s > length:
            raise OpusError("a bad self-delimited frame length")
        p += nb
        if cbr:
            if s * count > length:
                raise OpusError("a bad self-delimited CBR length")
            sizes = [s] * count
        else:
            if nb + s > last_size:
                raise OpusError("a bad self-delimited frame length")
            sizes.append(s)
    else:
        if last_size > 1275:
            raise OpusError("an Opus frame longer than 1275 bytes")
        sizes.append(last_size)
    frames = []
    for s in sizes:
        frames.append((p, s))
        p += s
    return toc, frames, p + pad


def packet_samples(packet: bytes) -> int:
    """A packet's samples at 48 kHz (0 for a malformed one)."""
    if not packet:
        return 0
    size = toc_info(packet[0])[2]
    code = packet[0] & 3
    if code == 0:
        return size
    if code in (1, 2):
        return 2 * size
    if len(packet) < 2:
        return 0
    return size * (packet[1] & 0x3F)


def _end_band(bandwidth: int) -> int:
    return {NARROWBAND: 13, MEDIUMBAND: 17, WIDEBAND: 17,
            SUPERWIDEBAND: 19, FULLBAND: 21}[bandwidth]


def smooth_fade(in1: np.ndarray, in2: np.ndarray, n: int) -> np.ndarray:
    """[n, ch] cross-fade from in1 to in2 over the squared window."""
    w = celt_mod.T.WINDOW[:n]
    w = (w * w)[:, None]
    return w * in2[:n] + (1.0 - w) * in1[:n]


class OpusDecoder:
    """One Opus stream's decoder (``OpusDecoder`` of libopus) at 48 kHz,
    1 or 2 channels."""

    def __init__(self, channels: int, lib=None):
        self.channels = channels
        self.lib = lib
        self.celt = celt_mod.CeltState(channels)
        self.silk = None
        self.prev_mode = 0
        self.prev_redundancy = False
        self.mode = 0
        self.bandwidth = 0
        self.frame_size = 0
        self.stream_channels = channels
        self.decode_gain = 0
        self.silk_control = (channels, 16000)  # SILK's channels and rate

    def _silk(self):
        from . import silk as silk_mod
        if self.silk is None:
            self.silk = silk_mod.SilkDecoder(self.channels, self.lib)
        return silk_mod

    def decode_frame(self, data: bytes, pos: int, length: int) -> np.ndarray:
        """One frame -> float64 [frame_size, channels]."""
        ch = self.channels
        if length <= 1:
            # no payload (DTX): libopus conceals the frame
            return self._conceal_frames(self.frame_size)
        audiosize = self.frame_size
        mode = self.mode
        bandwidth = self.bandwidth
        rd = RangeDecoder(data[pos:pos + length])
        frame_size = audiosize
        transition = False
        if self.prev_mode > 0 and (
                (mode == MODE_CELT and self.prev_mode != MODE_CELT
                 and not self.prev_redundancy)
                or (mode != MODE_CELT and self.prev_mode == MODE_CELT)):
            transition = True
        pcm_transition = None
        if transition and mode == MODE_CELT:
            pcm_transition = self._conceal(min(F5, audiosize))
        pcm_silk = None
        if mode != MODE_CELT:
            silk_mod = self._silk()
            if self.prev_mode == MODE_CELT:
                self.silk.reset()
            internal = {NARROWBAND: 8000, MEDIUMBAND: 12000,
                        WIDEBAND: 16000}.get(bandwidth, 16000) \
                if mode == MODE_SILK else 16000
            self.silk_control = (self.stream_channels, internal)
            pcm_silk = silk_mod.decode(self.silk, rd, self.stream_channels,
                                       internal, max(10, audiosize // 48),
                                       frame_size)
        start_band = 0
        redundancy = 0
        celt_to_silk = 0
        redundancy_bytes = 0
        if mode != MODE_CELT and rd.tell() + 17 + 20 * (
                self.mode == MODE_HYBRID) <= 8 * length:
            redundancy = rd.bit_logp(12) if mode == MODE_HYBRID else 1
            if redundancy:
                celt_to_silk = rd.bit_logp(1)
                redundancy_bytes = rd.uint(256) + 2 if mode == MODE_HYBRID \
                    else length - ((rd.tell() + 7) >> 3)
                length -= redundancy_bytes
                if length * 8 < rd.tell():
                    length = 0
                    redundancy_bytes = 0
                    redundancy = 0
                rd.storage -= redundancy_bytes
        if mode != MODE_CELT:
            start_band = 17
        if redundancy:
            transition = False
        if transition and mode != MODE_CELT:
            pcm_transition = self._conceal(min(F5, audiosize))
        if bandwidth:
            self.celt.end = _end_band(bandwidth)
        self.celt.stream_channels = self.stream_channels
        redundant = None
        if redundancy and celt_to_silk:
            self.celt.start = 0
            redundant = self._redundant(data, pos + length, redundancy_bytes)
        self.celt.start = start_band
        if mode != MODE_SILK:
            celt_frame = min(F20, frame_size)
            if mode != self.prev_mode and self.prev_mode > 0 \
                    and not self.prev_redundancy:
                self.celt.reset()
            pcm = celt_mod.decode_frame(self.celt, rd, celt_frame, self.lib)
        else:
            pcm = np.zeros((frame_size, ch))
            if self.prev_mode == MODE_HYBRID and not (
                    redundancy and celt_to_silk and self.prev_redundancy):
                self.celt.start = 0
                pcm[:F2_5] = celt_mod.decode_frame(
                    self.celt, RangeDecoder(b"\xff\xff"), F2_5, self.lib)
        if mode != MODE_CELT:
            pcm = pcm + (1.0 / 32768) * pcm_silk
        if redundancy and not celt_to_silk:
            self.celt.reset()
            self.celt.start = 0
            redundant = self._redundant(data, pos + length, redundancy_bytes)
            a = frame_size - F2_5
            pcm[a:] = smooth_fade(pcm[a:], redundant[F2_5:], F2_5)
        if redundancy and celt_to_silk:
            pcm[:F2_5] = redundant[:F2_5]
            pcm[F2_5:F5] = smooth_fade(redundant[F2_5:], pcm[F2_5:], F2_5)
        if transition:
            if audiosize >= F5:
                pcm[:F2_5] = pcm_transition[:F2_5]
                pcm[F2_5:F5] = smooth_fade(pcm_transition[F2_5:],
                                           pcm[F2_5:], F2_5)
            else:
                pcm[:F2_5] = smooth_fade(pcm_transition, pcm, F2_5)
        if self.decode_gain:
            gain = math.exp(celt_mod.LN2 * (GAIN_LOG * self.decode_gain))
            pcm = pcm * gain
        self.prev_mode = mode
        self.prev_redundancy = bool(redundancy and not celt_to_silk)
        return pcm

    def _redundant(self, data: bytes, pos: int, n: int) -> np.ndarray:
        return celt_mod.decode_frame(
            self.celt, RangeDecoder(data[pos:pos + n]), F5, self.lib)

    def _conceal_frames(self, n: int) -> np.ndarray:
        """``opus_decode_frame(NULL)`` for a frame of ``n`` samples with
        no payload: 20 ms at a time, and a shorter frame as 10 or 5 ms."""
        if n > F20:
            return np.concatenate([self._conceal(min(F20, n - a))
                                   for a in range(0, n, F20)])
        if F10 < n < F20:
            n = F10
        elif self.prev_mode != MODE_SILK and F5 < n < F10:
            n = F5
        return self._conceal(n)

    def _conceal(self, n: int) -> np.ndarray:
        """``opus_decode_frame(NULL)``: ``n`` samples of the last mode's
        loss concealment, which a mode switch with no redundancy frame
        fades from (5 ms) and a frame with no payload (DTX) is: SILK's (its
        PLC and comfort noise), CELT's (pitch- or noise-based), or both."""
        ch = self.channels
        mode = self.prev_mode
        if mode == 0:
            return np.zeros((n, ch))
        if mode != MODE_SILK:
            self.celt.start = 0 if mode == MODE_CELT else 17
            pcm = celt_mod.decode_lost(self.celt, min(F20, n))
        else:
            pcm = np.zeros((n, ch))
        if mode != MODE_CELT:
            silk_mod = self._silk()
            pcm = pcm + (1.0 / 32768) * silk_mod.decode(
                self.silk, None, *self.silk_control, max(10, n // 48), n)
        if self.decode_gain:
            pcm = pcm * math.exp(celt_mod.LN2 * (GAIN_LOG * self.decode_gain))
        self.prev_redundancy = False
        return pcm

    def decode(self, data: bytes, pos: int = 0, end: Optional[int] = None,
               self_delimited: bool = False) -> Tuple[np.ndarray, int]:
        """One packet -> (float64 [samples, channels], the offset past
        it)."""
        end = len(data) if end is None else end
        toc, frames, after = parse_packet(data, pos, end, self_delimited)
        mode, bandwidth, size, stream_channels = toc_info(toc)
        self.mode, self.bandwidth = mode, bandwidth
        self.frame_size, self.stream_channels = size, stream_channels
        out = [self.decode_frame(data, p, n) for p, n in frames]
        return np.concatenate(out), after


class MultistreamDecoder:
    """Channel mapping family 0 or 1: ``streams`` streams, the first
    ``coupled`` of them stereo, ``mapping[c]`` the stream channel of
    output channel c (255: silence)."""

    def __init__(self, channels: int, streams: int, coupled: int,
                 mapping: bytes, lib=None, gain: int = 0):
        self.channels = channels
        self.streams = streams
        self.coupled = coupled
        self.mapping = bytes(mapping)
        self.decoders = [OpusDecoder(2 if s < coupled else 1, lib)
                         for s in range(streams)]
        for d in self.decoders:
            d.decode_gain = gain

    def decode(self, packet: bytes) -> np.ndarray:
        """One packet -> float64 [samples, channels]."""
        outs = []
        pos = 0
        for s, d in enumerate(self.decoders):
            last = s == self.streams - 1
            pcm, pos = d.decode(packet, pos, len(packet), not last)
            outs.append(pcm)
        n = len(outs[0])
        if any(len(o) != n for o in outs):
            raise OpusError("the streams of a packet differ in duration")
        out = np.zeros((n, self.channels))
        for c, m in enumerate(self.mapping):
            if m == 255:
                continue
            if m < 2 * self.coupled:
                out[:, c] = outs[m // 2][:, m & 1]
            else:
                out[:, c] = outs[m - self.coupled][:, 0]
        return out
