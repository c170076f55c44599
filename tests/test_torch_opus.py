"""The port's Ogg Opus and MPEG Layer I/II decoders against the JAX
package's SDL_mixer decode (opusfile over libopus 1.3.1, and mpg123) on the
same bytes, and their parts on their own.

Fixtures are written here through ctypes (``tests/compressed_fixtures.py``):
Opus by the libopus of ``pygame.libs`` into RFC 7845 pages, Layer II by
``libtwolame``, Layer I by hand. Every decode has JAX's rate and exact
length. SILK-only streams, silent streams and Layer I/II are within
``TOL_LSB`` and ``MIN_SNR_DB`` of JAX's samples (SILK and silence are
equal bit for bit). CELT and hybrid streams are held at
``DITHER_TOL_LSB`` and ``DITHER_MIN_SNR_DB``: opusfile's 16-bit output
adds a noise-shaped dither whose error feedback turns a float difference
of one part in 10^7 (the reference's single precision, the port's double
and numpy's FFT) into a different dither sequence, so the port's float
output is held instead to ``FLOAT_MIN_SNR_DB`` against libopus's own
``opus_decode_float``. The C++ helper decodes as the plain Python loops,
bit for bit; the range decoder, the PVQ codebook index and the SILK
resampler are tested alone; cut and bit-flipped streams decode or raise in
a subprocess with a time limit.
"""
import ctypes
import json
import os
import struct
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

import jax  # noqa: F401  (the port's tests import both frameworks)
import torch  # noqa: F401

from qwen3_asr_tpu.audio.codec import AudioDecodeError as JaxAudioDecodeError
from qwen3_asr_tpu.audio.codec import decode_audio as jax_decode_audio
from qwen3_asr_tpu_torch.audio import (celt, mp3, native, ogg_opus, opus,
                                       opus_range, silk)
from qwen3_asr_tpu_torch.audio.codec import (AudioDecodeError,
                                             UnsupportedFormatError,
                                             decode_audio)
from qwen3_asr_tpu_torch.audio.compressed import decode_compressed, to_mono

from tests import compressed_fixtures as F
from tests.test_torch_compressed import (MIN_SNR_DB, TOL_LSB, _Worker,
                                         needs_pygame)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
DITHER_TOL_LSB = 12.0
DITHER_MIN_SNR_DB = 60.0
FLOAT_MIN_SNR_DB = 90.0

needs_opus = pytest.mark.skipif(F.opus() is None,
                                reason="libopus is not present")
needs_twolame = pytest.mark.skipif(F.twolame() is None,
                                   reason="libtwolame is not present")


def _snr(want: np.ndarray, got: np.ndarray) -> float:
    err = float(np.sum((got.astype(np.float64) - want) ** 2))
    return 10 * np.log10(float(np.sum(want.astype(np.float64) ** 2))
                         / max(err, 1e-30))


def _agree(data: bytes, tol: float, min_snr: float):
    """Decode with both packages: JAX's rate and length, and the bound.
    Returns (port, JAX) samples."""
    want, sr_want = jax_decode_audio(data)
    kind = "OGG" if data[:4] == b"OggS" else "MP3"
    got, sr = decode_compressed(data, kind)
    assert (sr, len(got), got.dtype) == (sr_want, len(want), np.float32)
    diff = np.abs(got.astype(np.float64) - want) * 32768
    snr = _snr(want, got)
    assert diff.max() <= tol, (diff.max(), snr)
    assert snr >= min_snr, (diff.max(), snr)
    return got, want


# -- Ogg Opus against JAX -----------------------------------------------------


def _sig(sr, seconds, ch, seed, **kw):
    return F.make_signal(sr, seconds, ch, seed=seed, **kw)


def _switching():
    x = _sig(48000, 1.2, 1, 60)
    return F.ogg_opus_stream(F.opus_switching_packets(
        x, 48000, [(0.3, "silk", 12000), (0.3, "hybrid", 24000),
                   (0.3, "celt", 64000), (0.3, "hybrid", 32000)]), 1,
        samples=len(x))


def _switching_without_redundancy():
    """Stereo at 6 kbit/s between faster segments: some SILK -> CELT
    switches carry no redundancy frame, and libopus fades them in from
    5 ms of SILK's loss concealment."""
    x = _sig(48000, 2.4, 2, 67)
    return F.opus_switching_packets(
        x, 48000, [(0.1, None, (6000, 24000, 128000)[i % 3])
                   for i in range(24)])


def _dtx_signal(ch: int) -> np.ndarray:
    """Speech with 1.5 s of digital silence, which a VOIP encoder with DTX
    sends as packets of no payload."""
    x = _sig(16000, 2.5, 1, 68)
    x[12000:36000] = 0.0
    return np.repeat(x, ch, 1)


def _resampled_dtx(ch: int) -> np.ndarray:
    x = _dtx_signal(ch)
    return np.stack([F.resample_linear(x[:, c], 16000, 48000)
                     for c in range(ch)], 1)


def _combined(code, pad=0):
    x = _sig(48000, 0.6, 2, 61)
    pk, pre, fam, layout, n = F.opus_packets(x, 48000, mode="celt",
                                             bitrate=96000, vbr=code != 1)
    return F.ogg_opus_stream(F.opus_combine(pk, code, pad), 2, pre, n)


# name -> (a writer of the file's bytes, bit-exact to JAX)
OPUS_CASES = {
    "celt_nb_20": (lambda: F.encode_opus(_sig(48000, 0.5, 1, 40), 48000,
                                         mode="celt", bandwidth="nb",
                                         bitrate=16000), False),
    "celt_wb_10": (lambda: F.encode_opus(_sig(48000, 0.5, 1, 41), 48000,
                                         mode="celt", bandwidth="wb",
                                         frame_ms=10), False),
    "celt_swb_5": (lambda: F.encode_opus(_sig(48000, 0.5, 1, 42), 48000,
                                         mode="celt", bandwidth="swb",
                                         frame_ms=5), False),
    "celt_fb_2_5_clicks": (lambda: F.encode_opus(
        _sig(48000, 0.5, 2, 43, clicks=True), 48000, mode="celt",
        frame_ms=2.5, bitrate=96000), False),
    "celt_fb_20_stereo": (lambda: F.encode_opus(
        _sig(48000, 0.5, 2, 44), 48000, mode="celt", bitrate=96000), False),
    "celt_40_code2": (lambda: F.encode_opus(_sig(48000, 0.5, 1, 45), 48000,
                                            mode="celt", frame_ms=40), False),
    "celt_60_code3": (lambda: F.encode_opus(_sig(48000, 0.5, 1, 46), 48000,
                                            mode="celt", frame_ms=60), False),
    "celt_libsndfile": (lambda: F.encode_ogg(_sig(48000, 0.5, 1, 47), 48000,
                                             codec="opus"), False),
    "code1_cbr": (lambda: _combined(1), False),
    "code2_vbr": (lambda: _combined(2), False),
    "code3_padding": (lambda: _combined(3, 300), False),
    "silk_nb_20": (lambda: F.encode_opus(_sig(8000, 0.5, 1, 48), 8000,
                                         application="voip",
                                         bitrate=12000), True),
    "silk_mb_10": (lambda: F.encode_opus(_sig(12000, 0.5, 1, 49), 12000,
                                         application="voip", mode="silk",
                                         bitrate=12000, frame_ms=10), True),
    "silk_wb_20_voice_note": (lambda: F.encode_opus(
        _sig(16000, 0.5, 1, 50), 16000, application="voip",
        bitrate=16000), True),
    "silk_wb_40": (lambda: F.encode_opus(_sig(16000, 0.5, 1, 51), 16000,
                                         application="voip", bitrate=16000,
                                         frame_ms=40), True),
    "silk_wb_60": (lambda: F.encode_opus(_sig(16000, 0.5, 1, 52), 16000,
                                         application="voip", bitrate=16000,
                                         frame_ms=60), True),
    "silk_wb_stereo": (lambda: F.encode_opus(_sig(16000, 0.5, 2, 53), 16000,
                                             application="voip",
                                             bitrate=32000), True),
    "hybrid_swb_10": (lambda: F.encode_opus(_sig(48000, 0.5, 1, 54), 48000,
                                            mode="hybrid", bandwidth="swb",
                                            bitrate=24000, frame_ms=10),
                      False),
    "hybrid_fb_20": (lambda: F.encode_opus(_sig(48000, 0.5, 1, 55), 48000,
                                           bitrate=20000), False),
    "hybrid_fb_stereo": (lambda: F.encode_opus(_sig(48000, 0.5, 2, 56),
                                               48000, mode="hybrid",
                                               bitrate=40000), False),
    "silk_dtx_20": (lambda: F.encode_opus(_dtx_signal(1), 16000,
                                          application="voip", bitrate=16000,
                                          dtx=True), True),
    "silk_dtx_60_stereo": (lambda: F.encode_opus(
        _dtx_signal(2), 16000, application="voip", bitrate=24000,
        frame_ms=60, dtx=True), True),
    "celt_dtx_stereo": (lambda: F.encode_opus(
        _resampled_dtx(2), 48000, mode="celt", frame_ms=10, dtx=True),
        False),
    "mode_switches": (_switching, False),
    "mode_switches_without_redundancy": (lambda: F.ogg_opus_stream(
        _switching_without_redundancy(), 2), False),
    "family1_3ch": (lambda: F.encode_opus(_sig(48000, 0.4, 3, 57), 48000,
                                          bitrate=128000), False),
    "family1_4ch": (lambda: F.encode_opus(_sig(48000, 0.4, 4, 58), 48000,
                                          bitrate=160000), False),
    "family1_5ch": (lambda: F.encode_opus(_sig(48000, 0.4, 5, 59), 48000,
                                          bitrate=192000), False),
    "family1_6ch": (lambda: F.encode_opus(_sig(48000, 0.4, 6, 62), 48000,
                                          bitrate=192000), False),
    "gain_minus_6db_silk": (lambda: F.encode_opus(
        _sig(16000, 0.5, 1, 63), 16000, application="voip", bitrate=16000,
        gain=-1536), False),
    "gain_plus_9db_loud_clip": (lambda: F.encode_opus(
        np.clip(_sig(16000, 0.5, 1, 64) * 3, -1, 1), 16000,
        application="voip", bitrate=24000, gain=2304), False),
    "start_granule": (lambda: F.encode_opus(_sig(16000, 0.5, 1, 65), 16000,
                                            application="voip",
                                            bitrate=16000, start=480000),
                      True),
    "one_page_end_trim": (lambda: F.encode_opus(
        _sig(16000, 0.5, 1, 66), 16000, application="voip", bitrate=16000,
        frame_ms=60), True),
}


@needs_pygame
@needs_opus
@pytest.mark.parametrize("name", sorted(OPUS_CASES))
def test_opus_matrix_as_jax(name):
    make, exact = OPUS_CASES[name]
    data = make()
    if exact:
        got, want = _agree(data, TOL_LSB, MIN_SNR_DB)
        np.testing.assert_array_equal(got, want)
    else:
        _agree(data, DITHER_TOL_LSB, DITHER_MIN_SNR_DB)


@needs_pygame
@needs_opus
@pytest.mark.parametrize("serial", [1, 0x5EED1234])
def test_a_silent_stream_is_opusfiles_dither_bit_for_bit(serial):
    """A CELT stream of silence decodes to samples of ~1e-34, which the
    dither does not mute: JAX's output is opusfile's dither alone, seeded
    with the serial number, and the port's equals it."""
    data = F.encode_opus(np.zeros((48000, 1), np.float32), 48000,
                         mode="celt", serial=serial)
    got, want = _agree(data, TOL_LSB, MIN_SNR_DB)
    np.testing.assert_array_equal(got, want)
    assert np.count_nonzero(want) > 30000


@needs_pygame
@needs_opus
def test_the_serial_number_seeds_the_dither():
    x = np.zeros((24000, 1), np.float32)
    a, _ = decode_audio(F.encode_opus(x, 48000, mode="celt", serial=7))
    b, _ = decode_audio(F.encode_opus(x, 48000, mode="celt", serial=8))
    assert np.mean(a == b) < 0.5


# -- the float output against libopus -----------------------------------------


def _libopus_float(packets, channels: int) -> np.ndarray:
    lib = F.opus()
    err = ctypes.c_int(0)
    dec = lib.opus_decoder_create(48000, channels, ctypes.byref(err))
    buf = (ctypes.c_float * (5760 * channels))()
    out = []
    try:
        for p in packets:
            n = lib.opus_decode_float(ctypes.c_void_p(dec), p, len(p), buf,
                                      5760, 0)
            assert n > 0, n
            out.append(np.frombuffer(buf, np.float32, n * channels)
                       .reshape(n, channels).copy())
    finally:
        lib.opus_decoder_destroy(ctypes.c_void_p(dec))
    return np.concatenate(out)


FLOAT_CASES = {
    "celt_fb_20_stereo": dict(sr=48000, ch=2, mode="celt", bitrate=96000),
    "celt_2_5": dict(sr=48000, ch=1, mode="celt", frame_ms=2.5),
    "celt_nb_10": dict(sr=48000, ch=1, mode="celt", bandwidth="nb",
                       frame_ms=10),
    "hybrid_fb": dict(sr=48000, ch=2, bitrate=32000),
    "silk_wb": dict(sr=16000, ch=1, application="voip", bitrate=16000),
    "silk_nb_stereo_60": dict(sr=8000, ch=2, application="voip",
                              bitrate=24000, frame_ms=60),
    "silk_dtx_10": dict(sr=16000, ch=1, application="voip", bitrate=16000,
                        frame_ms=10, dtx=True),
    "celt_dtx_20_stereo": dict(sr=48000, ch=2, mode="celt", dtx=True),
}


@needs_opus
def test_a_switch_without_redundancy_fades_from_silks_concealment():
    """Where a SILK -> CELT switch carries no redundancy frame, the port
    decodes 5 ms of SILK's loss concealment (and comfort noise) to fade
    from, as libopus does: within ``FLOAT_MIN_SNR_DB`` of its float output,
    the helper and the plain loops alike."""
    packets = _switching_without_redundancy()
    want = _libopus_float(packets, 2)
    d = opus.OpusDecoder(2)
    got = []
    switches = 0
    for p in packets:
        mode = opus.toc_info(p[0])[0]
        if mode == opus.MODE_CELT and d.prev_mode == opus.MODE_SILK \
                and not d.prev_redundancy:
            switches += 1
        got.append(d.decode(p)[0])
    assert switches >= 1
    got = np.concatenate(got)
    assert _snr(want, got) >= FLOAT_MIN_SNR_DB
    n = opus.OpusDecoder(2, native.get_lib())
    np.testing.assert_array_equal(
        np.concatenate([n.decode(p)[0] for p in packets]), got)


@needs_opus
@pytest.mark.parametrize("name", sorted(FLOAT_CASES))
def test_float_output_against_libopus(name):
    """Before the 16-bit step: CELT and hybrid within ``FLOAT_MIN_SNR_DB``
    of ``opus_decode_float`` on every packet, SILK equal; DTX packets of no
    payload too (SILK's loss concealment and comfort noise, CELT's pitch-
    and noise-based concealment)."""
    kw = dict(FLOAT_CASES[name])
    sr, ch = kw.pop("sr"), kw.pop("ch")
    x = (_dtx_signal(ch) if sr == 16000 else _resampled_dtx(ch)) \
        if kw.get("dtx") else _sig(sr, 0.5, ch, 70)
    packets = F.opus_packets(x, sr, **kw)[0]
    if kw.get("dtx"):
        assert sum(len(p) == 1 for p in packets) > 20
    want = _libopus_float(packets, ch)
    dec = opus.OpusDecoder(ch, native.get_lib())
    got = np.concatenate([dec.decode(p)[0] for p in packets])
    assert got.shape == want.shape
    if name.startswith("silk"):
        np.testing.assert_array_equal(got.astype(np.float32), want)
    else:
        assert _snr(want, got) >= FLOAT_MIN_SNR_DB


# -- MPEG audio Layer I and II against JAX ------------------------------------


def _bad_crc(body: bytes) -> bytes:
    """A bit of frame 5's allocation flipped under its CRC: mpg123 decodes
    the frame as it reads (a grouped code past its levels as zeros)."""
    b = bytearray(body)
    pos = 0
    for _ in range(5):
        pos += mp3.parse_header(bytes(b), pos).size
    b[pos + 7] ^= 0x10
    return bytes(b)


LAYER12_CASES = {
    "l2_mpeg1_44k_joint": lambda: F.encode_mp2(
        _sig(44100, 0.5, 2, 80), 44100, bitrate=192),
    "l2_mpeg1_44k_joint_96_crc": lambda: F.encode_mp2(
        _sig(44100, 0.5, 2, 81), 44100, bitrate=96, crc=True),
    "l2_mpeg1_48k_stereo_384": lambda: F.encode_mp2(
        _sig(48000, 0.5, 2, 82), 48000, bitrate=384, mode="stereo"),
    "l2_mpeg1_48k_mono_64": lambda: F.encode_mp2(
        _sig(48000, 0.5, 1, 83), 48000, bitrate=64),
    "l2_mpeg1_32k_mono_48": lambda: F.encode_mp2(
        _sig(32000, 0.5, 1, 84), 32000, bitrate=48),
    "l2_mpeg1_32k_stereo_256": lambda: F.encode_mp2(
        _sig(32000, 0.5, 2, 85), 32000, bitrate=256, mode="stereo"),
    "l2_mpeg1_44k_mono_160": lambda: F.encode_mp2(
        _sig(44100, 0.5, 1, 86), 44100, bitrate=160),
    "l2_lsf_16k_mono": lambda: F.encode_mp2(
        _sig(16000, 0.5, 1, 87), 16000, bitrate=64),
    "l2_lsf_22k_joint_crc": lambda: F.encode_mp2(
        _sig(22050, 0.5, 2, 88), 22050, bitrate=64, crc=True),
    "l2_lsf_24k_stereo": lambda: F.encode_mp2(
        _sig(24000, 0.5, 2, 89), 24000, bitrate=96, mode="stereo"),
    "l2_mpeg1_44k_crc_mismatch": lambda: _bad_crc(F.encode_mp2(
        _sig(44100, 0.5, 2, 90), 44100, bitrate=128, crc=True)),
    "l1_32k_stereo": lambda: F.layer1_stream(20, 32000),
    "l1_44k_crc_mismatch": lambda: _bad_crc(F.layer1_stream(
        20, 44100, joint_bound=8, crc=True, seed=5)),
    "l1_44k_joint_crc": lambda: F.layer1_stream(20, 44100, joint_bound=8,
                                                crc=True, seed=1),
    "l1_48k_joint_16": lambda: F.layer1_stream(20, 48000, joint_bound=16,
                                               seed=2),
    "l1_lsf_16k_mono": lambda: F.layer1_stream(20, 16000, channels=1,
                                               bitrate_index=8, seed=3),
    "l1_lsf_24k_joint": lambda: F.layer1_stream(20, 24000, joint_bound=4,
                                                bitrate_index=10, seed=4),
}


@needs_pygame
@pytest.mark.parametrize("name", sorted(LAYER12_CASES))
def test_layer12_matrix_as_jax(name):
    """Behind an ID3v2 tag, where SDL_mixer hands the stream to mpg123."""
    if name.startswith("l2") and F.twolame() is None:
        pytest.skip("libtwolame is not present")
    _agree(F.id3v2() + LAYER12_CASES[name](), TOL_LSB, MIN_SNR_DB)


@needs_pygame
@needs_twolame
def test_an_untagged_layer2_stream_decodes_where_jax_refuses_it():
    """The divergence kept on purpose: without an ID3v2 tag SDL_mixer does
    not recognise a Layer II stream (JAX answers AudioDecodeError); the
    port decodes it, to the tagged stream's samples."""
    body = LAYER12_CASES["l2_lsf_16k_mono"]()
    with pytest.raises(JaxAudioDecodeError):
        jax_decode_audio(body)
    got, sr = decode_audio(body)
    tagged, _ = decode_audio(F.id3v2() + body)
    assert sr == 16000
    np.testing.assert_array_equal(got, tagged)


@needs_pygame
@needs_twolame
def test_layer2_syncs_only_onto_frames_of_its_own_layer():
    """A frame's payload holds two Layer III headers a Layer III frame
    apart, which a search for Layer III alone takes for the stream: the
    port syncs on the stream's first header, Layer II, and decodes as JAX
    (mpg123) does."""
    body = bytearray(LAYER12_CASES["l2_mpeg1_44k_mono_160"]())
    pos = 0
    for _ in range(3):
        pos += mp3.parse_header(bytes(body), pos).size
    fake = b"\xff\xfb\x90\x64" + bytes(413) + b"\xff\xfb\x90\x64"
    h = mp3.parse_header(fake, 0)
    assert (h.layer, h.size) == (3, 417)
    at = pos + 40
    assert at + len(fake) < pos + mp3.parse_header(bytes(body), pos).size
    body[at:at + len(fake)] = fake
    data = F.id3v2() + bytes(body)
    got, _ = _agree(data, TOL_LSB, MIN_SNR_DB)
    assert len(got) == len(decode_audio(F.id3v2() + LAYER12_CASES[
        "l2_mpeg1_44k_mono_160"]())[0])


def test_layer1_class_table_and_bitrates():
    from qwen3_asr_tpu_torch.audio import mpa_tables as T
    assert [T.CLASSES[T.layer1_class(a)][0] for a in range(1, 16)] == \
        list(range(2, 17))
    assert T.CLASSES[T.CLASS_OF_LEVELS[3]] == (5, 3)
    assert T.CLASSES[T.CLASS_OF_LEVELS[7]] == (3, 0)
    assert [len(t) for t in T.ALLOC] == [27, 30, 8, 12, 30]
    h = mp3.parse_header(F.layer1_stream(1, 44100), 0)
    assert (h.layer, h.bitrate, h.size) == (1, 384, (12 * 384000 // 44100) * 4)


# -- the parts on their own ---------------------------------------------------


class _RangeEncoder:
    """libopus's range encoder (RFC 6716 §5.1), for the decoder's test."""

    def __init__(self, size: int = 4096):
        self.buf = bytearray(size)
        self.storage = size
        self.offs = self.end_offs = self.end_window = self.nend_bits = 0
        self.nbits_total = 33
        self.rng = 1 << 31
        self.rem = -1
        self.val = 0
        self.ext = 0

    def _carry_out(self, c: int) -> None:
        if c != 255:
            carry = c >> 8
            if self.rem >= 0:
                self.buf[self.offs] = (self.rem + carry) & 255
                self.offs += 1
            while self.ext > 0:
                self.buf[self.offs] = (255 + carry) & 255
                self.offs += 1
                self.ext -= 1
            self.rem = c & 255
        else:
            self.ext += 1

    def _normalize(self) -> None:
        while self.rng <= 1 << 23:
            self._carry_out(self.val >> 23)
            self.val = (self.val << 8) & 0x7FFFFFFF
            self.rng <<= 8
            self.nbits_total += 8

    def encode(self, fl: int, fh: int, ft: int) -> None:
        r = self.rng // ft
        if fl > 0:
            self.val += self.rng - r * (ft - fl)
            self.rng = r * (fh - fl)
        else:
            self.rng -= r * (ft - fh)
        self._normalize()

    def bit_logp(self, v: int, logp: int) -> None:
        s = self.rng >> logp
        r = self.rng - s
        if v:
            self.val += r
        self.rng = s if v else r
        self._normalize()

    def icdf(self, s: int, icdf, ftb: int) -> None:
        r = self.rng >> ftb
        if s > 0:
            self.val += self.rng - r * icdf[s - 1]
            self.rng = r * (icdf[s - 1] - icdf[s])
        else:
            self.rng -= r * icdf[s]
        self._normalize()

    def bits(self, v: int, n: int) -> None:
        window, used = self.end_window, self.nend_bits
        if used + n > 32:
            while used >= 8:
                self.end_offs += 1
                self.buf[self.storage - self.end_offs] = window & 255
                window >>= 8
                used -= 8
        window |= v << used
        self.end_window, self.nend_bits = window, used + n
        self.nbits_total += n

    def uint(self, v: int, ft: int) -> None:
        ft -= 1
        ftb = ft.bit_length()
        if ftb > 8:
            ftb -= 8
            f = (ft >> ftb) + 1
            fl = v >> ftb
            self.encode(fl, fl + 1, f)
            self.bits(v & ((1 << ftb) - 1), ftb)
        else:
            self.encode(v, v + 1, ft + 1)

    def tell(self) -> int:
        return self.nbits_total - self.rng.bit_length()

    def done(self) -> bytes:
        lg = 32 - self.rng.bit_length()
        msk = 0x7FFFFFFF >> lg
        end = (self.val + msk) & ~msk
        if (end | msk) >= self.val + self.rng:
            lg += 1
            msk >>= 1
            end = (self.val + msk) & ~msk
        while lg > 0:
            self._carry_out(end >> 23)
            end = (end << 8) & 0x7FFFFFFF
            lg -= 8
        if self.rem >= 0 or self.ext > 0:
            self._carry_out(0)
        window, used = self.end_window, self.nend_bits
        while used >= 8:
            self.end_offs += 1
            self.buf[self.storage - self.end_offs] = window & 255
            window >>= 8
            used -= 8
        if used > 0:
            self.buf[self.storage - self.end_offs - 1] |= window
        return bytes(self.buf)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.integers(0, 4), st.integers(0, 1 << 30)),
                min_size=1, max_size=120))
def test_range_decoder_reads_what_the_encoder_wrote(ops):
    """Frequency tables, binary symbols, inverse CDFs, uniform integers
    (one byte and more) and raw bits, mixed; every symbol comes back and
    the decoder's ``tell`` equals the encoder's after each one."""
    icdf = (250, 200, 120, 60, 20, 3, 0)
    enc = _RangeEncoder()
    written = []
    for kind, v in ops:
        if kind == 0:
            ft = 3 + v % 300
            fl = v % ft
            enc.encode(fl, fl + 1, ft)
            written.append((kind, ft, fl))
        elif kind == 1:
            logp = 1 + v % 15
            enc.bit_logp(v >> 4 & 1, logp)
            written.append((kind, logp, v >> 4 & 1))
        elif kind == 2:
            s = v % len(icdf)
            enc.icdf(s, icdf, 8)
            written.append((kind, 8, s))
        elif kind == 3:
            ft = 2 + v % (1 << (2 + v % 28))
            enc.uint(v % ft, ft)
            written.append((kind, ft, v % ft))
        else:
            n = 1 + v % 24
            enc.bits(v & ((1 << n) - 1), n)
            written.append((kind, n, v & ((1 << n) - 1)))
        written[-1] += (enc.tell(),)
    rd = opus_range.RangeDecoder(enc.done())
    for kind, p, want, tell in written:
        if kind == 0:
            got = rd.decode(p)
            rd.update(got, got + 1, p)
        elif kind == 1:
            got = rd.bit_logp(p)
        elif kind == 2:
            got = rd.icdf(icdf, 8)
        elif kind == 3:
            got = rd.uint(p)
        else:
            got = rd.bits(p)
        assert (got, rd.tell()) == (want, tell)
        assert rd.tell_frac() <= rd.tell() * 8 and rd.tell_frac() > \
            (rd.tell() - 1) * 8


@pytest.mark.parametrize("n,k", [(2, 1), (2, 5), (3, 3), (4, 2), (5, 4),
                                 (8, 2), (3, 9)])
def test_cwrs_index_is_a_bijection_onto_the_pvq_codebook(n, k):
    """Every index below V(n, k) decodes to a distinct integer vector of n
    components whose magnitudes sum to k, with its squared norm: all of
    them, as counted by brute force."""
    seen = set()
    for i in range(celt.pvq_v(n, k)):
        y = [0] * n
        yy = celt.cwrsi(n, k, i, y)
        assert sum(abs(v) for v in y) == k and yy == sum(v * v for v in y)
        seen.add(tuple(y))

    def count(n, k):
        if n == 0:
            return int(k == 0)
        return sum(count(n - 1, k - abs(v)) for v in range(-k, k + 1))
    assert len(seen) == celt.pvq_v(n, k) == count(n, k)


@pytest.mark.parametrize("fs_in", [8000, 12000, 16000])
def test_silk_resampler_to_48k(fs_in):
    """A sine through the resampler in 10 ms calls comes out as that sine
    at 48 kHz, delayed and scaled a little, with 20 ms calls giving the
    same samples; 480 samples a 10 ms call."""
    t = np.arange(fs_in // 2)
    x = np.round(8000 * np.sin(2 * np.pi * 440 * t / fs_in)).astype(int)
    outs = []
    for step in (fs_in // 100, fs_in // 50):
        r = silk.Resampler(fs_in)
        out = []
        for a in range(0, len(x), step):
            y = silk.resample(r, x[a:a + step].tolist())
            assert len(y) == 480 * step // (fs_in // 100)
            out += y
        outs.append(np.asarray(out))
    np.testing.assert_array_equal(outs[0], outs[1])
    y = outs[0][2400:]
    ref = 8000 * np.sin(2 * np.pi * 440 * (np.arange(len(outs[0])) / 48000))
    lags = range(0, 200)
    best = max(lags, key=lambda d: np.dot(y, ref[2400 - d:2400 - d + len(y)]))
    fit = np.dot(y, ref[2400 - best:2400 - best + len(y)]) \
        / np.dot(ref[2400 - best:2400 - best + len(y)],
                 ref[2400 - best:2400 - best + len(y)])
    err = y - fit * ref[2400 - best:2400 - best + len(y)]
    assert 0.9 < fit < 1.1 and np.sqrt(np.mean(err ** 2)) < 400


# -- the helper against the plain loops ---------------------------------------


HELPER_CASES = ("silk_wb_stereo", "silk_mb_10", "hybrid_fb_stereo",
                "celt_fb_2_5_clicks", "family1_5ch", "mode_switches",
                "mode_switches_without_redundancy",
                "gain_plus_9db_loud_clip", "code3_padding")


@needs_opus
@pytest.mark.parametrize("name", HELPER_CASES)
def test_helper_decodes_opus_as_the_plain_loops(name):
    assert native.get_lib() is not None
    data = OPUS_CASES[name][0]()
    a, sr = ogg_opus.decode_ogg_opus(data)
    b, _ = ogg_opus.decode_ogg_opus(data, native=False)
    assert sr == 48000 and len(a) > 0
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["l2_mpeg1_44k_joint_96_crc",
                                  "l2_lsf_22k_joint_crc", "l1_44k_joint_crc",
                                  "l1_lsf_16k_mono"])
def test_helper_decodes_layer12_as_the_plain_loops(name):
    if name.startswith("l2") and F.twolame() is None:
        pytest.skip("libtwolame is not present")
    data = LAYER12_CASES[name]()
    a, sr = mp3.decode_mp3(data)
    b, _ = mp3.decode_mp3(data, native=False)
    np.testing.assert_array_equal(a, b)


def test_committed_opus_and_layer2_files_decode_with_the_helper_as_plain():
    names = [n for n in sorted(os.listdir(F.COMPRESSED))
             if n.endswith((".opus", ".mp2"))]
    assert len(names) >= 5
    from qwen3_asr_tpu_torch.audio import ogg
    for name in names:
        with open(os.path.join(F.COMPRESSED, name), "rb") as f:
            data = f.read()
        kind = "OGG" if data[:4] == b"OggS" else "MP3"
        if kind == "OGG":
            # the first second: the plain loops take ~1 s a second
            packets, serial = ogg.read_packets(data)
            head = ogg_opus.read_head(packets[0].data)
            data = F.ogg_opus_stream([p.data for p in packets[2:52]],
                                     head.channels, head.pre_skip,
                                     serial=serial)
            a = ogg_opus.decode_ogg_opus(data)[0]
            b = ogg_opus.decode_ogg_opus(data, native=False)[0]
        else:
            data = data[:8000]
            a = mp3.decode_mp3(data)[0]
            b = mp3.decode_mp3(data, native=False)[0]
        np.testing.assert_array_equal(a, b, err_msg=name)


# -- limits, refusals, corrupt streams ----------------------------------------


def _opus_head(channels: int, family: int, extra: bytes = b"") -> bytes:
    return b"OpusHead" + struct.pack("<BBHIhB", 1, channels, 312, 48000, 0,
                                     family) + extra


def test_mapping_family_255_and_more_than_8_channels_are_refused():
    tags = b"OpusTags" + bytes(8)
    for head, match in (
            (_opus_head(2, 255, bytes([2, 0, 0, 1])), "family 255"),
            (_opus_head(9, 1, bytes([9, 0]) + bytes(range(9))),
             "more than 8 channels")):
        data = F.ogg_stream([head, tags, bytes([0xF8, 0xFF, 0xFE])])
        with pytest.raises(UnsupportedFormatError, match=match):
            decode_audio(data)


def test_an_opus_stream_past_the_decoded_limit_is_refused_before_decoding(
        monkeypatch):
    """The samples are counted from the packets' TOCs before anything is
    decoded: ten packets of six 20 ms CELT frames of no bytes, 57600
    samples less the pre-skip (with no frame before them, their
    concealment is silence)."""
    packet = bytes([(31 << 3) | 3, 6])
    data = F.ogg_opus_stream([packet] * 10, 1)
    monkeypatch.setattr(ogg_opus, "MAX_DECODED_SAMPLES", 57600 - 312 - 1)
    with pytest.raises(AudioDecodeError, match="decodes to more than"):
        ogg_opus.decode_ogg_opus(data)
    monkeypatch.setattr(ogg_opus, "MAX_DECODED_SAMPLES", 57600 - 312)
    out, sr = ogg_opus.decode_ogg_opus(data)
    assert out.shape == (57600 - 312, 1) and not out.any()


@needs_twolame
def test_layer2_decoded_limit_counts_frames_samples_and_channels(
        monkeypatch):
    data = LAYER12_CASES["l2_mpeg1_44k_joint"]()
    full, _ = mp3.decode_mp3(data)
    frames = len(full) // 1152
    monkeypatch.setattr(mp3, "MAX_DECODED_SAMPLES", frames * 1152 * 2)
    np.testing.assert_array_equal(mp3.decode_mp3(data)[0], full)
    monkeypatch.setattr(mp3, "MAX_DECODED_SAMPLES", frames * 1152 * 2 - 1)
    with pytest.raises(AudioDecodeError, match="decodes to more than"):
        mp3.decode_mp3(data)


@pytest.fixture(scope="module")
def worker():
    w = _Worker()
    yield w
    w.close()


@pytest.fixture(scope="module")
def fuzz_sources():
    out = {}
    if F.opus() is not None:
        out["silk"] = F.ogg_opus_stream(*_packets_for_fuzz("silk"))
        out["celt"] = F.ogg_opus_stream(*_packets_for_fuzz("celt"))
        out["hybrid"] = F.ogg_opus_stream(*_packets_for_fuzz("hybrid"))
    if F.twolame() is not None:
        out["mp2"] = F.id3v2() + LAYER12_CASES["l2_lsf_22k_joint_crc"]()
    out["mp1"] = F.layer1_stream(6, 32000, joint_bound=8, crc=True)
    return out


def _packets_for_fuzz(mode: str):
    sr = 16000 if mode == "silk" else 48000
    x = _sig(sr, 0.6, 2, 91)
    kw = dict(application="voip", bitrate=24000) if mode == "silk" else \
        dict(mode=mode, bitrate=40000)
    pk, pre, fam, layout, n = F.opus_packets(x, sr, **kw)
    return pk, 2, pre, n, 1, 0, sr, fam, layout, 0, 200


@settings(max_examples=60, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(codec=st.sampled_from(["silk", "celt", "hybrid", "mp2", "mp1"]),
       cut=st.floats(0.0, 1.0),
       flips=st.lists(st.tuples(st.floats(0.0, 1.0), st.integers(0, 7)),
                      max_size=6))
def test_cut_and_flipped_opus_and_layer12_decode_or_raise(
        worker, fuzz_sources, codec, cut, flips):
    """In a subprocess that must neither crash nor hang: each cut or
    bit-flipped stream decodes to samples in [-1, 1] or raises
    AudioDecodeError. A flipped Ogg page fails its CRC, so the Opus flips
    land in the packets of pages whose CRC is then recomputed."""
    assume(codec in fuzz_sources)
    data = bytearray(fuzz_sources[codec])
    if codec in ("silk", "celt", "hybrid"):
        data = bytearray(_flip_opus_packets(bytes(data), flips))
    else:
        for at, bit in flips:
            i = min(int(at * len(data)), len(data) - 1)
            data[i] ^= 1 << bit
    data = bytes(data[:max(16, int(cut * len(data)))])
    line = worker.decode(data)
    assert line.startswith(("ok", "err")), line
    if line.startswith("ok"):
        assert line.endswith("True"), line


def _flip_opus_packets(data: bytes, flips) -> bytes:
    from qwen3_asr_tpu_torch.audio import ogg
    packets, serial = ogg.read_packets(data)
    raw = [bytearray(p.data) for p in packets]
    for at, bit in flips:
        k = 2 + min(int(at * (len(raw) - 2)), len(raw) - 3)
        pk = raw[k]
        i = min(int(at * 7919) % len(pk), len(pk) - 1)
        pk[i] ^= 1 << bit
    head = bytes(raw[0])
    return F.ogg_opus_stream([bytes(p) for p in raw[2:]], head[9],
                             struct.unpack_from("<H", head, 10)[0],
                             serial=serial)


def _long_upload(codec: str) -> bytes:
    """~5 minutes: the CELT packets of the committed 29.5 s Opus (its
    first second is hybrid) eleven times over, or the committed Layer II's
    frames ten times over."""
    if codec == "opus":
        from qwen3_asr_tpu_torch.audio import ogg
        with open(os.path.join(F.COMPRESSED, "long_48k_stereo.opus"),
                  "rb") as f:
            packets, _ = ogg.read_packets(f.read())
        head = ogg_opus.read_head(packets[0].data)
        celt_only = [p.data for p in packets[2:]
                     if opus.toc_info(p.data[0])[0] == opus.MODE_CELT]
        return F.ogg_opus_stream(celt_only * 11, 2, head.pre_skip)
    with open(os.path.join(F.COMPRESSED, "long_44k_stereo.mp2"), "rb") as f:
        data = f.read()
    start, _ = mp3._tag_bounds(data)
    return data[start:] * 10


@pytest.mark.parametrize("codec", ["opus", "mp2"])
def test_long_upload_peak_memory_stays_near_its_output(codec):
    """A ~5 min stereo upload's decode (``tests/decode_peak.py`` in a
    process of its own, ``tracemalloc``) allocates at most twice its mono
    float32 output plus 64 MiB: the decoders work in blocks and fold to
    mono as they go."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "decode_peak.py"),
         "--repeats", "1"],
        input=_long_upload(codec), capture_output=True, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), timeout=240)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    got = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    sr = 48000 if codec == "opus" else 44100
    assert got["sr"] == sr and got["samples"] > 290 * sr
    assert got["peak"] <= 2 * got["out"] + (64 << 20), got


def test_to_mono_is_the_fold_of_opus_uploads():
    """Decoded alone, the decoder returns every channel; the upload's mono
    is ``compressed.to_mono`` of it."""
    if F.opus() is None:
        pytest.skip("libopus is not present")
    data = F.encode_opus(_sig(48000, 0.3, 5, 92), 48000, bitrate=160000)
    full, _ = ogg_opus.decode_ogg_opus(data)
    mono, _ = decode_compressed(data, "OGG")
    assert full.shape[1] == 5
    np.testing.assert_array_equal(to_mono(full), mono)
