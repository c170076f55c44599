"""The port's lossless codecs against the JAX package's on the same bytes:
W64, AIFF/AIFC, AU, CAF and FLAC decode bit-equal to
``qwen3_asr_tpu.audio.codec.decode_audio`` over bit depths, channel
counts, rates, FLAC block sizes and subframe kinds; the port's
``encode_flac`` writes JAX's bytes, and each package decodes the other's
streams; the C++ helper (``csrc/audio_dsp.cpp``) and the Python loops
agree; corrupt and truncated streams raise JAX's class and message.
The containers are written by ``chip_smoke.py``'s writers, which its
phase 16 uploads on the card."""
import importlib.util
import logging
import os

import numpy as np
import pytest

import jax  # noqa: F401  (the port's tests import both frameworks)
import torch  # noqa: F401

from qwen3_asr_tpu.audio import flac as jax_flac
from qwen3_asr_tpu.audio.codec import AudioDecodeError as JaxAudioDecodeError
from qwen3_asr_tpu.audio.codec import decode_audio as jax_decode_audio
from qwen3_asr_tpu_torch.audio import flac, native
from qwen3_asr_tpu_torch.audio.codec import (AudioDecodeError,
                                             UnsupportedFormatError,
                                             decode_audio)
from qwen3_asr_tpu_torch.ops import _build

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REAL = os.path.join(ROOT, "e2e", "data", "real")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def _floats(seed: int, n: int, ch: int) -> np.ndarray:
    """A smooth signal with noise in [-1, 1], [n, ch]."""
    rng = np.random.default_rng(seed)
    t = np.arange(n)[:, None] / 16000
    x = 0.6 * np.sin(2 * np.pi * (220 + 110 * np.arange(ch)) * t)
    return np.clip(x + 0.05 * rng.standard_normal((n, ch)), -1, 1)


def _ints(x: np.ndarray, bits: int) -> np.ndarray:
    return np.round(x * ((1 << (bits - 1)) - 1)).astype(np.int64)


def _container(kind: str, seed: int) -> bytes:
    """One container of the table below, from seeded samples."""
    name, sr, ch, bits, opts = CONTAINERS[kind]
    x = _floats(seed, 3001, ch)
    if name == "w64":
        fmt = opts.get("fmt", "pcm")
        return CS.w64_bytes(x if fmt == "float" else _ints(x, bits), sr,
                            bits, fmt)
    if name == "aiff":
        fmt = opts.get("fmt", "pcm")
        return CS.aiff_bytes(x if fmt == "float" else _ints(x, bits), sr,
                             bits, opts.get("comp"), fmt)
    if name == "au":
        b, fmt = CS.AU_ENCODINGS[opts["encoding"]]
        return CS.au_bytes(x if fmt == "float" else _ints(x, b), sr,
                           opts["encoding"])
    fmt = opts.get("fmt", "pcm")
    return CS.caf_bytes(x if fmt == "float" else _ints(x, bits), sr, bits,
                        fmt, opts.get("little", False),
                        opts.get("open_ended", False))


# name -> (container, rate, channels, bits, options)
CONTAINERS = {
    "w64_pcm16_mono_16k": ("w64", 16000, 1, 16, {}),
    "w64_pcm24_stereo_44k": ("w64", 44100, 2, 24, {}),
    "w64_pcm8_mono_8k": ("w64", 8000, 1, 8, {}),
    "w64_pcm32_stereo_48k": ("w64", 48000, 2, 32, {}),
    "w64_float32_stereo_48k": ("w64", 48000, 2, 32, {"fmt": "float"}),
    "aiff_pcm16_mono_16k": ("aiff", 16000, 1, 16, {}),
    "aiff_pcm24_stereo_44k": ("aiff", 44100, 2, 24, {}),
    "aiff_pcm8_mono_22k": ("aiff", 22050, 1, 8, {}),
    "aiff_pcm32_mono_96k": ("aiff", 96000, 1, 32, {}),
    "aifc_none_stereo_16k": ("aiff", 16000, 2, 16, {"comp": b"NONE"}),
    "aifc_twos_mono_16k": ("aiff", 16000, 1, 16, {"comp": b"twos"}),
    "aifc_sowt_stereo_44k": ("aiff", 44100, 2, 16, {"comp": b"sowt"}),
    "aifc_fl32_mono_16k": ("aiff", 16000, 1, 32,
                           {"comp": b"fl32", "fmt": "float"}),
    "aifc_fl64_stereo_48k": ("aiff", 48000, 2, 64,
                             {"comp": b"fl64", "fmt": "float"}),
    "au_pcm8_mono_8k": ("au", 8000, 1, 8, {"encoding": 2}),
    "au_pcm16_mono_16k": ("au", 16000, 1, 16, {"encoding": 3}),
    "au_pcm24_stereo_44k": ("au", 44100, 2, 24, {"encoding": 4}),
    "au_pcm32_mono_16k": ("au", 16000, 1, 32, {"encoding": 5}),
    "au_float32_stereo_48k": ("au", 48000, 2, 32, {"encoding": 6}),
    "au_float64_mono_16k": ("au", 16000, 1, 64, {"encoding": 7}),
    "caf_pcm16_be_mono_16k": ("caf", 16000, 1, 16, {}),
    "caf_pcm16_le_stereo_44k": ("caf", 44100, 2, 16, {"little": True}),
    "caf_pcm24_be_stereo_48k": ("caf", 48000, 2, 24, {}),
    "caf_pcm32_le_mono_16k": ("caf", 16000, 1, 32, {"little": True}),
    "caf_float32_le_stereo_open": ("caf", 44100, 2, 32,
                                   {"fmt": "float", "little": True,
                                    "open_ended": True}),
    "caf_float64_be_mono_16k": ("caf", 16000, 1, 64, {"fmt": "float"}),
}


def _same(data: bytes) -> None:
    """The port decodes ``data`` as JAX does: the same samples and rate,
    or the same error class and message."""
    try:
        ref = jax_decode_audio(data)
    except Exception as e:  # the JAX package's class decides
        with pytest.raises(Exception) as ours:
            decode_audio(data)
        assert type(ours.value).__name__ == type(e).__name__
        assert str(ours.value) == str(e)
        return
    audio, sr = decode_audio(data)
    assert sr == ref[1] and audio.dtype == ref[0].dtype
    np.testing.assert_array_equal(audio, ref[0])


@pytest.mark.parametrize("kind", list(CONTAINERS))
def test_container_decodes_as_jax(kind):
    data = _container(kind, seed=len(kind))
    _same(data)
    audio, sr = decode_audio(data)
    assert sr == CONTAINERS[kind][1] and len(audio) == 3001


def _real_ints(name: str = "english_01.wav", seconds: float = 1.5):
    with open(os.path.join(REAL, name), "rb") as f:
        audio, _ = decode_audio(f.read())
    return np.round(audio[:int(seconds * 16000)] * 32768).astype(
        np.int64).clip(-32767, 32767)


def test_phase16_variants_decode_to_the_wavs_samples():
    """chip_smoke.py phase 16 (a)'s containers hold the WAV's samples
    exactly, in both packages."""
    ints = _real_ints()
    variants = CS.codec_variants(ints)
    want = decode_audio(variants["wav"])[0]
    for name, data in variants.items():
        for dec in (decode_audio, jax_decode_audio):
            audio, sr = dec(data)
            assert sr == 16000, name
            np.testing.assert_array_equal(audio, want, err_msg=name)


def _signal(seed: int, n: int, ch: int, sr: int) -> np.ndarray:
    x = _floats(seed, n, ch)
    return x[:, 0] if ch == 1 else x


# name -> (encode_flac keyword arguments, rate, channels, samples)
FLAC_CASES = {
    "mono16_fixed": ({}, 16000, 1, 9000),
    "mono16_block1152": ({"blocksize": 1152}, 16000, 1, 5000),
    "mono16_block4608_short_tail": ({"blocksize": 4608}, 22050, 1, 9300),
    "mono8": ({"bps": 8}, 8000, 1, 4000),
    "mono12": ({"bps": 12}, 16000, 1, 4000),
    "mono20_44k": ({"bps": 20}, 44100, 1, 6000),
    "mono24_48k": ({"bps": 24}, 48000, 1, 6000),
    "stereo16_independent": ({}, 44100, 2, 6000),
    "stereo16_left_side": ({"stereo_mode": "left_side"}, 44100, 2, 6000),
    "stereo16_right_side": ({"stereo_mode": "right_side"}, 44100, 2, 6000),
    "stereo24_mid_side": ({"bps": 24, "stereo_mode": "mid_side"}, 48000, 2,
                          6000),
    "three_channels": ({}, 16000, 3, 3000),
    "lpc2": ({"subframe_opts": {"mode": "lpc"}}, 16000, 1, 5000),
    "lpc3_rice2_partitions": ({"subframe_opts": {
        "mode": "lpc", "lpc_coeffs": (9, -5, 2), "lpc_shift": 3,
        "lpc_precision": 6, "partition_order": 2, "rice2": True}},
        16000, 1, 4096),
    "lpc8_24bit": ({"bps": 24, "subframe_opts": {
        "mode": "lpc", "lpc_coeffs": (12, -9, 4, 2, -1, 1, -1, 1),
        "lpc_shift": 3, "lpc_precision": 7, "partition_order": 1}},
        44100, 2, 4096),
    "verbatim": ({"subframe_opts": {"mode": "verbatim"}}, 16000, 1, 3000),
    "fixed2_escape": ({"subframe_opts": {
        "mode": "fixed", "fixed_order": 2, "escape": True,
        "partition_order": 3}}, 16000, 1, 4096),
    "fixed0_wasted_bits": ({"subframe_opts": {
        "mode": "fixed", "fixed_order": 0, "wasted": 2}}, 16000, 1, 3000),
    "fixed1_rice2_wasted": ({"subframe_opts": {
        "mode": "fixed", "fixed_order": 1, "rice2": True, "wasted": 1,
        "partition_order": 2}}, 16000, 2, 4096),
}


def _flac_args(case: str):
    kwargs, sr, ch, n = FLAC_CASES[case]
    x = _signal(sum(map(ord, case)), n, ch, sr)
    if ch == 1:
        return (x, sr), kwargs
    return (None, sr), {**kwargs, "channels": x}


@pytest.mark.parametrize("case", list(FLAC_CASES))
def test_flac_streams_of_both_encoders_decode_alike(case):
    """JAX's and the port's encoders write the same stream, and the port
    (with its helper and with its plain loops) and JAX decode it to the
    same samples and rate."""
    args, kwargs = _flac_args(case)
    ours = flac.encode_flac(*args, **kwargs)
    ref = jax_flac.encode_flac(*args, **kwargs)
    assert ours == ref
    want = jax_decode_audio(ref)
    for native_loops in (True, False):
        audio, sr = flac.decode_flac(ours, native=native_loops)
        assert sr == want[1] == args[1]
        np.testing.assert_array_equal(audio, want[0])
    np.testing.assert_array_equal(decode_audio(ours)[0], want[0])


@pytest.mark.parametrize("bps,stereo", [(16, False), (24, True)])
def test_real_clip_flac_round_trip(bps, stereo):
    """A real clip through the port's encoder decodes in JAX to its
    samples, and JAX's stream decodes in the port to the same."""
    ints = _real_ints("japanese_01.wav", 3.0) << (bps - 16)
    scale = (1 << (bps - 1)) - 1
    x = ints / scale
    args = (None, 16000) if stereo else (x, 16000)
    kwargs = {"bps": bps}
    if stereo:
        kwargs.update(channels=np.stack([x, x], 1), stereo_mode="mid_side")
    ours = flac.encode_flac(*args, **kwargs)
    ref = jax_flac.encode_flac(*args, **kwargs)
    want = (ints / float(1 << (bps - 1))).astype(np.float32)
    for data in (ours, ref):
        for dec in (decode_audio, jax_decode_audio):
            audio, sr = dec(data)
            assert sr == 16000
            np.testing.assert_array_equal(audio, want)


def _truncations(data: bytes, rng) -> list:
    cuts = sorted(set(int(c) for c in rng.integers(1, len(data), 6)))
    return [data[:c] for c in cuts] + [data[:len(data) // 2]]


def _corruptions(data: bytes, rng, start: int) -> list:
    out = []
    for _ in range(6):
        b = bytearray(data)
        for pos in rng.integers(start, len(b), 3):
            b[int(pos)] ^= int(rng.integers(1, 256))
        out.append(bytes(b))
    return out


CORRUPT_SOURCES = ["flac16", "flac24_lpc", "flac16_stereo", "aiff",
                   "aifc_float32", "au", "caf", "w64"]


@pytest.mark.parametrize("source", CORRUPT_SOURCES)
def test_truncated_and_corrupt_streams_fail_as_jax(source):
    """Cut and bit-flipped copies of each container: the port answers
    what JAX answers, the same samples or the same error and message."""
    rng = np.random.default_rng(sum(map(ord, source)))
    data = CS.codec_variants(_real_ints(seconds=0.6))[source]
    for bad in _truncations(data, rng) + _corruptions(data, rng, 4):
        _same(bad)


@pytest.mark.parametrize("data,message", [
    (b"fLaC" + bytes(60), "short STREAMINFO"),
    (b"fLaCxyzw" + bytes(60), "truncated metadata"),
    (b"fLaC\x81\x00\x00\x00" + bytes(60), "no STREAMINFO block"),
    (b"riff" + bytes(60), "not a Wave64 file"),
    (b"FORMxxxxWAVE" + bytes(60), "not an AIFF file"),
    (b"caff" + bytes(8) + b"desc" + bytes(60), "missing desc or data chunk"),
])
def test_header_errors_match_jax(data, message):
    _same(data)
    with pytest.raises(AudioDecodeError, match=message):
        decode_audio(data)


def _ogg_page(payload: bytes, flags: int, seq: int, granule: int = 0) -> bytes:
    from qwen3_asr_tpu_torch.audio import ogg
    lacing = bytes([255] * (len(payload) // 255) + [len(payload) % 255])
    page = bytearray(b"OggS\x00" + bytes([flags])
                     + granule.to_bytes(8, "little") + (7).to_bytes(4, "little")
                     + seq.to_bytes(4, "little") + bytes(4)
                     + bytes([len(lacing)]) + lacing + payload)
    page[22:26] = ogg.crc32(bytes(page)).to_bytes(4, "little")
    return bytes(page)


def _lsb_bits(fields) -> bytes:
    """Pack (value, bits) fields LSB first, as Vorbis packs them."""
    acc, n = 0, 0
    for value, bits in fields:
        acc |= (value & ((1 << bits) - 1)) << n
        n += bits
    return acc.to_bytes((n + 7) // 8, "little")


def _vorbis_with_floor0() -> bytes:
    """A Vorbis stream whose setup header declares a floor of type 0."""
    ident = b"\x01vorbis" + (0).to_bytes(4, "little") + bytes([1]) \
        + (16000).to_bytes(4, "little") + bytes(12) + bytes([0x86, 1])
    comment = b"\x03vorbis" + (0).to_bytes(4, "little") \
        + (0).to_bytes(4, "little") + b"\x01"
    setup = b"\x05vorbis" + _lsb_bits([
        (0, 8),                                  # one codebook
        (0x564342, 24), (1, 16), (2, 24),        # sync, 1 dim, 2 entries
        (0, 1), (0, 1), (0, 5), (0, 5),          # unordered, lengths 1, 1
        (0, 4),                                  # no lookup
        (0, 6), (0, 16),                         # one time-domain value
        (0, 6), (0, 16)])                        # one floor, of type 0
    return (_ogg_page(ident, 2, 0) + _ogg_page(comment, 0, 1)
            + _ogg_page(setup, 0, 2))


def _intensity_stereo() -> bytes:
    """The committed joint-stereo MP3 with every frame's intensity-stereo
    bit set."""
    from qwen3_asr_tpu_torch.audio import mp3
    with open(os.path.join(ROOT, "e2e", "data", "compressed",
                           "long_44k_stereo.mp3"), "rb") as f:
        data = bytearray(f.read())
    pos = 0
    while True:
        h = mp3.parse_header(bytes(data), pos)
        if h is None:
            break
        data[pos + 3] |= 0x10
        pos += h.size
    return bytes(data)


def _opus_head() -> bytes:
    head = b"OpusHead" + bytes([1, 1]) + bytes(2) \
        + (16000).to_bytes(4, "little") + bytes(3)
    return _ogg_page(head, 2, 0) + bytes(64)


@pytest.mark.parametrize("make,feature", [
    (_opus_head, None),
    (lambda: b"\xff\xff\x90\x00" + bytes(600), None),
    (lambda: b"\xff\xfd\x90\x00" + bytes(600), None),
    (_intensity_stereo, "intensity stereo"),
    (_vorbis_with_floor0, "floor type 0"),
], ids=["opus", "layer1", "layer2", "intensity_stereo", "vorbis_floor0"])
def test_mp3_and_ogg_are_refused_naming_the_decoded_formats(make, feature):
    """What the port still refuses answers UnsupportedFormatError naming
    the feature (the server's 422). Ogg Opus and MPEG Layer I/II decode
    now: their truncated streams here (a lone OpusHead page, a Layer I or
    II header and no frame after it) raise AudioDecodeError in both
    packages, as JAX's SDL_mixer does."""
    if feature is None:
        with pytest.raises(AudioDecodeError):
            decode_audio(make())
        with pytest.raises(JaxAudioDecodeError):
            jax_decode_audio(make())
        return
    with pytest.raises(UnsupportedFormatError, match=feature):
        decode_audio(make())


def test_helper_builds_here_and_matches_the_plain_loops_on_a_real_clip():
    """The helper builds into ``_build/`` from ``csrc/audio_dsp.cpp`` (a
    host compiler is on this machine) and decodes as the plain version."""
    assert native.get_lib() is not None
    assert _build.host_library_path("audio_dsp").exists()
    data = flac.encode_flac(_real_ints("hindi_02.wav", 2.0) / 32767, 16000,
                            subframe_opts={"mode": "lpc",
                                           "partition_order": 2})
    a, _ = flac.decode_flac(data)
    b, _ = flac.decode_flac(data, native=False)
    np.testing.assert_array_equal(a, b)


def test_plain_version_when_the_helper_cannot_build(monkeypatch, caplog):
    """A failed build logs JAX's warning once and the decoder takes the
    plain loops, with the same samples."""
    def fail(name):
        raise RuntimeError("no compiler")
    monkeypatch.setattr(_build, "build_host", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    data = flac.encode_flac(_real_ints(seconds=0.5) / 32767, 16000)
    with caplog.at_level(logging.WARNING):
        audio, sr = decode_audio(data)
        assert native.get_lib() is None
    warnings = [r.getMessage() for r in caplog.records
                if "native audio DSP" in r.getMessage()]
    assert warnings == ["native audio DSP build failed (no compiler); "
                        "using numpy paths"]
    np.testing.assert_array_equal(audio, jax_decode_audio(data)[0])
