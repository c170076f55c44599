"""Ogg Opus (RFC 7845) to the 16-bit samples SDL_mixer reads from
opusfile's ``op_read``.

The container: OpusHead (version, channels, pre-skip, output gain in Q7.8
dB, channel mapping families 0 and 1) and OpusTags, then the audio
packets. The first page that completes a packet sets the stream's starting
granule (its granule less its packets' samples); the pre-skip is cut after
it; an end-of-stream page's granule cuts the end (``kept_samples``). The
header's output gain is applied as libopus applies ``OPUS_SET_GAIN``.

The 16-bit conversion is opusfile's, in single precision: as ``op_read``
returns each piece of a packet (512 samples a channel at most, SDL_mixer's
buffer, or the whole packet where it fits), ``opus_pcm_soft_clip`` bends
samples past +-1 back under it, and a noise-shaped dither (a 4-tap error
filter and two draws of an LCG seeded with the stream's serial number a
sample) rounds them to 16 bits; the dither mutes after 17 exactly silent
samples. ``pcm16`` in C++ (``csrc/audio_dsp.cpp``) and ``pcm16_plain`` here
convert to the same bits.

Refused with ``UnsupportedFormatError``: channel mapping families other
than 0 and 1 (255 included) and more than 8 channels.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import ogg
from .codec import (MAX_DECODED_SAMPLES, AudioDecodeError,
                    UnsupportedFormatError)
from .opus import MultistreamDecoder, packet_samples

READ_SAMPLES = 512  # op_read's piece: SDL_mixer's buffer, a channel
BLOCK_SAMPLES = 1 << 16  # samples a channel folded at once
F32 = np.float32
GAIN = F32(32753.0)
PRNG_GAIN = F32(1.0) / F32(0xFFFFFFFF)
FCOEF_B = (F32(2.2374), F32(-0.7339), F32(-0.1251), F32(-0.6033))
FCOEF_A = (F32(0.9030), F32(0.0116), F32(-0.5853), F32(-0.2571))


class OggOpusError(AudioDecodeError):
    pass


@dataclass
class OpusHead:
    channels: int
    pre_skip: int
    rate: int
    gain: int
    family: int
    streams: int
    coupled: int
    mapping: bytes


def read_head(p: bytes) -> OpusHead:
    if len(p) < 19 or p[:8] != b"OpusHead":
        raise OggOpusError("missing OpusHead")
    version, ch, pre_skip, rate, gain, family = struct.unpack_from(
        "<BBHIhB", p, 8)
    if version >> 4:
        raise OggOpusError(f"Ogg Opus version {version}")
    if ch == 0:
        raise OggOpusError("an Opus stream of no channels")
    if family == 0:
        if ch > 2:
            raise OggOpusError("mapping family 0 with more than 2 channels")
        return OpusHead(ch, pre_skip, rate, gain, 0, 1, ch - 1,
                        bytes(range(ch)))
    if family != 1:
        raise UnsupportedFormatError(
            f"Ogg Opus channel mapping family {family} is not supported "
            f"(families 0 and 1 are)")
    if ch > 8:
        raise UnsupportedFormatError(
            "Ogg Opus with more than 8 channels is not supported")
    if len(p) < 21 + ch:
        raise OggOpusError("a short OpusHead mapping table")
    streams, coupled = p[19], p[20]
    mapping = p[21:21 + ch]
    if streams == 0 or coupled > streams or streams + coupled > 255 or any(
            m != 255 and m >= streams + coupled for m in mapping):
        raise OggOpusError("a bad OpusHead mapping table")
    return OpusHead(ch, pre_skip, rate, gain, 1, streams, coupled, mapping)


class Pcm16State:
    """opusfile's conversion state: the soft clip's memory, the dither's
    error filter, its mute count and seed."""

    def __init__(self, channels: int, seed: int):
        self.clip = np.zeros(channels, np.float32)
        self.a = np.zeros(channels * 4, np.float32)
        self.b = np.zeros(channels * 4, np.float32)
        self.mute = 65
        self.seed = seed & 0xFFFFFFFF


def soft_clip_plain(x: np.ndarray, mem: np.ndarray) -> None:
    """``opus_pcm_soft_clip`` in place on float32 [n, ch]."""
    n, ch = x.shape
    if n < 1:
        return
    np.clip(x, F32(-2.0), F32(2.0), out=x)
    for c in range(ch):
        col = x[:, c]
        a = F32(mem[c])
        for i in range(n):
            if col[i] * a >= 0:
                break
            col[i] = col[i] + a * col[i] * col[i]
        curr = 0
        x0 = col[0]
        while True:
            i = curr
            while i < n and -1 <= col[i] <= 1:
                i += 1
            if i == n:
                a = F32(0.0)
                break
            peak = i
            start = end = i
            maxval = abs(col[i])
            while start > 0 and col[i] * col[start - 1] >= 0:
                start -= 1
            while end < n and col[i] * col[end] >= 0:
                if abs(col[end]) > maxval:
                    maxval = abs(col[end])
                    peak = end
                end += 1
            special = start == 0 and col[i] * col[0] >= 0
            a = (maxval - F32(1.0)) / (maxval * maxval)
            a = a + a * F32(2.4e-7)
            if col[i] > 0:
                a = -a
            for j in range(start, end):
                col[j] = col[j] + a * col[j] * col[j]
            if special and peak >= 2:
                offset = x0 - col[0]
                delta = offset / F32(peak)
                for j in range(curr, peak):
                    offset = offset - delta
                    col[j] = col[j] + offset
                    col[j] = max(F32(-1.0), min(F32(1.0), col[j]))
            curr = end
            if curr == n:
                break
        mem[c] = a


def dither_plain(x: np.ndarray, st: Pcm16State) -> np.ndarray:
    """opusfile's ``op_shaped_dither16``: float32 [n, ch] -> int16, every
    operation in single precision (numpy float32 scalars)."""
    n, ch = x.shape
    out = np.empty((n, ch), np.int16)
    mute, seed = st.mute, st.seed
    if mute > 64:
        st.a[:] = 0
    da = [list(st.a[c * 4:c * 4 + 4]) for c in range(ch)]
    db = [list(st.b[c * 4:c * 4 + 4]) for c in range(ch)]
    b0, b1, b2, b3 = FCOEF_B
    a0, a1, a2, a3 = FCOEF_A
    zero, lo, hi = F32(0.0), F32(-32768.0), F32(32767.0)
    elo, ehi = F32(-1.5), F32(1.5)
    rows = list(x)
    for i in range(n):
        row = rows[i]
        silent = True
        for c in range(ch):
            s = row[c]
            silent = silent and s == 0
            s = s * GAIN
            a, b = da[c], db[c]
            err = zero + (b0 * b[0] - a0 * a[0])
            err = err + (b1 * b[1] - a1 * a[1])
            err = err + (b2 * b[2] - a2 * a[2])
            err = err + (b3 * b[3] - a3 * a[3])
            a[3], a[2], a[1], a[0] = a[2], a[1], a[0], err
            b[3], b[2], b[1] = b[2], b[1], b[0]
            s = s - err
            if mute > 16:
                r = zero
            else:
                seed = (seed * 96314165 + 907633515) & 0xFFFFFFFF
                r = F32(seed) * PRNG_GAIN
                seed = (seed * 96314165 + 907633515) & 0xFFFFFFFF
                r = r - F32(seed) * PRNG_GAIN
            v = s + r
            v = lo if v < lo else hi if v > hi else v
            si = int(np.rint(v))
            out[i, c] = si
            if mute > 16:
                b[0] = zero
            else:
                e = F32(si) - s
                b[0] = elo if e < elo else ehi if e > ehi else e
        mute += 1
        if not silent:
            mute = 0
    for c in range(ch):
        st.a[c * 4:c * 4 + 4] = da[c]
        st.b[c * 4:c * 4 + 4] = db[c]
    st.mute = min(mute, 65)
    st.seed = seed
    return out


def pcm16_plain(x: np.ndarray, st: Pcm16State) -> np.ndarray:
    """One ``op_read`` piece: float32 [n, ch] (changed in place by the
    soft clip) -> int16 [n, ch]."""
    soft_clip_plain(x, st.clip)
    return dither_plain(x, st)


def kept_samples(packets) -> List[int]:
    """The samples ``op_read`` returns of each audio packet before the
    pre-skip. The stream starts at the first page that completes a packet:
    its granule less its packets' samples. Only the end-of-stream page is
    cut: from the granule of the page before it, its packets run up to its
    own granule, the one that crosses it is cut there and the rest are
    dropped (all of them where its granule is below the page before's).
    Where the first page is also the last one and its granule is below its
    samples, the stream starts at 0."""
    durations = [packet_samples(p.data) for p in packets]
    marked = [i for i, p in enumerate(packets) if p.granule != -1]
    if not marked or not packets[-1].eos or packets[-1].granule == -1:
        return durations
    first = marked[0]
    start = packets[first].granule - sum(durations[:first + 1])
    last = packets[-1].granule
    keep = list(durations)
    if start < 0:
        if first != len(packets) - 1:
            raise OggOpusError("an Ogg Opus starting granule below the "
                               "samples of its first page")
        start = 0
    j = marked[-2] if len(marked) > 1 else -1
    pos = packets[j].granule - start if j >= 0 else 0
    end = last - start
    for i in range(j + 1, len(packets)):
        keep[i] = max(0, min(durations[i], end - pos))
        pos += durations[i]
    return keep


def decode_ogg_opus(data: bytes, native: bool = True,
                    fold: Optional[Callable[[np.ndarray], np.ndarray]] = None
                    ) -> Tuple[np.ndarray, int]:
    """Decode an Ogg Opus file -> (float32 [n, channels] of 16-bit values
    over 32768, or [n] through ``fold``, 48000). ``native=False`` takes the
    plain versions of the C++ helper's loops."""
    from . import native as native_mod
    lib = native_mod.get_lib() if native else None
    data = bytes(data)
    packets, serial = ogg.read_packets(data)
    if len(packets) < 2:
        raise OggOpusError("missing Ogg Opus headers")
    head = read_head(packets[0].data)
    if packets[1].data[:8] != b"OpusTags":
        raise OggOpusError("missing OpusTags")
    audio = packets[2:]
    ch = head.channels
    keep = kept_samples(audio)
    total = max(0, sum(keep) - head.pre_skip)
    if total * ch > MAX_DECODED_SAMPLES:
        raise OggOpusError(f"the stream decodes to more than "
                           f"{MAX_DECODED_SAMPLES} samples")
    dec = MultistreamDecoder(ch, head.streams, head.coupled, head.mapping,
                             lib, head.gain)
    st = Pcm16State(ch, serial)
    out = np.empty((total,) if fold else (total, ch), np.float32)
    skip = head.pre_skip
    at = 0
    block = []
    pending = 0
    for p, k in zip(audio, keep):
        if at + pending >= total:
            break
        pcm = dec.decode(p.data).astype(np.float32)
        n = len(pcm)
        lo = min(skip, k)
        skip -= lo
        hi = k
        piece = READ_SAMPLES if n > READ_SAMPLES else n
        for a in range(lo, hi, piece):
            chunk = np.ascontiguousarray(pcm[a:min(hi, a + piece)])
            if lib is not None:
                q = native_mod.pcm16(lib, chunk, st)
            else:
                q = pcm16_plain(chunk, st)
            block.append(q)
            pending += len(q)
        if pending >= BLOCK_SAMPLES:
            at = _flush(out, at, block, fold)
            block, pending = [], 0
    at = _flush(out, at, block, fold)
    if at != total:
        out = out[:at]
    return out, 48000


def _flush(out: np.ndarray, at: int, block, fold) -> int:
    if not block:
        return at
    q = np.concatenate(block).astype(np.float32) / np.float32(32768.0)
    out[at:at + len(q)] = fold(q) if fold else q
    return at + len(q)
