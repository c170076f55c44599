"""The port's MP3 (Layer III) and Ogg Vorbis decoders against the JAX
package's SDL_mixer decode (mpg123, libvorbisfile) on the same bytes.

Fixtures: pygame's ``house_lo.mp3`` / ``house_lo.ogg``, and a matrix
written here through ctypes by ``libmp3lame`` and by the ``libsndfile`` of
``pygame.libs`` (``tests/compressed_fixtures.py``), once per module. Every
decode has JAX's rate and JAX's exact number of samples, and its samples
are within ``TOL_LSB`` steps of 1/32768 of JAX's with an SNR of at least
``MIN_SNR_DB`` (the port rounds to 16 bits as SDL's 16-bit output does, so
most samples are equal). The C++ helper decodes as the plain Python loops,
bit for bit; cut and bit-flipped streams decode or raise
``AudioDecodeError`` in a subprocess that must neither crash nor hang, and
so do headers that ask for more channels or samples than the decoders
take; a long upload's decode adds little more memory than its output;
chained Ogg streams, intensity stereo and Vorbis floor 0 are refused
(``tests/test_torch_codec.py``). Ogg Opus and MPEG Layer I/II have their
own file, ``tests/test_torch_opus.py``.
"""
import json
import logging
import os
import struct
import subprocess
import sys
import time

import numpy as np
import pytest
from hypothesis import HealthCheck, assume, given, settings
from hypothesis import strategies as st

import jax  # noqa: F401  (the port's tests import both frameworks)
import torch  # noqa: F401

from qwen3_asr_tpu.audio.codec import decode_audio as jax_decode_audio
from qwen3_asr_tpu.audio.compressed import sniff_mp3 as jax_sniff_mp3
from qwen3_asr_tpu.audio.compressed import sniff_ogg as jax_sniff_ogg
from qwen3_asr_tpu_torch.audio import mp3, native, ogg, vorbis
from qwen3_asr_tpu_torch.audio.codec import (MAX_DECODED_SAMPLES,
                                             AudioDecodeError,
                                             UnsupportedFormatError,
                                             decode_audio)
from qwen3_asr_tpu_torch.audio.compressed import (decode_compressed,
                                                  sniff_mp3, sniff_ogg)
from qwen3_asr_tpu_torch.ops import _build

from tests import compressed_fixtures as F

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TOL_LSB = 2.0      # largest difference from JAX's samples, in 1/32768
MIN_SNR_DB = 90.0
# 3-8 channels: SDL's fold to stereo, matched to within one step on a third
# of the samples (a divergence, ROADMAP §3)
MULTICHANNEL_TOL_LSB = 1.0
MULTICHANNEL_MIN_SNR_DB = 70.0

try:
    import pygame
    _PG_DATA = os.path.join(os.path.dirname(pygame.__file__), "examples",
                            "data")
except ImportError:  # pragma: no cover - environment-dependent
    _PG_DATA = None
HOUSE_MP3 = os.path.join(_PG_DATA or "", "house_lo.mp3")
HOUSE_OGG = os.path.join(_PG_DATA or "", "house_lo.ogg")

needs_pygame = pytest.mark.skipif(
    _PG_DATA is None or not os.path.exists(HOUSE_MP3),
    reason="pygame (JAX's decoder) or its example audio is not present")
needs_lame = pytest.mark.skipif(F.lame() is None,
                                reason="libmp3lame is not present")
needs_sndfile = pytest.mark.skipif(F.sndfile() is None,
                                   reason="libsndfile is not present")


def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _frames(data: bytes, n: int) -> int:
    """The offset of the n-th frame of a tag-free MP3."""
    pos = 0
    for _ in range(n):
        pos += mp3.parse_header(data, pos).size
    return pos


def _cut_mp3(data: bytes, n: int) -> bytes:
    return data[_frames(data, n):]


def _ape_tag() -> bytes:
    body = struct.pack("<I", 5) + struct.pack("<I", 0) + b"Title\x00" \
        + b"fixt\x00"
    footer = b"APETAGEX" + struct.pack("<IIII", 2000, len(body) + 32, 1, 0) \
        + bytes(8)
    return body + footer


# name -> a writer of the file's bytes
MP3_FIXTURES = {
    "mpeg1_44k_joint_lame_tag": lambda: F.encode_mp3(
        F.make_signal(44100, 2.0, 2), 44100, bitrate=128),
    "mpeg1_48k_stereo": lambda: F.encode_mp3(
        F.make_signal(48000, 1.0, 2, seed=1), 48000, bitrate=160,
        mode="stereo"),
    "mpeg1_32k_mono": lambda: F.encode_mp3(
        F.make_signal(32000, 1.0, 1, seed=2), 32000, bitrate=64),
    "mpeg2_22k_mono": lambda: F.encode_mp3(
        F.make_signal(22050, 1.0, 1, seed=3), 22050, bitrate=32),
    "mpeg2_24k_joint": lambda: F.encode_mp3(
        F.make_signal(24000, 1.0, 2, seed=4), 24000, bitrate=64),
    "mpeg2_16k_mono": lambda: F.encode_mp3(
        F.make_signal(16000, 1.5, 1, seed=5), 16000, bitrate=32),
    "mpeg25_8k_no_tag": lambda: F.encode_mp3(
        F.make_signal(8000, 2.0, 1, seed=6), 8000, bitrate=16),
    "mpeg25_11k_clicks": lambda: F.encode_mp3(
        F.make_signal(11025, 2.0, 1, seed=7, clicks=True), 11025,
        bitrate=32),
    "vbr_xing_clicks": lambda: F.encode_mp3(
        F.make_signal(44100, 2.0, 2, seed=8, clicks=True), 44100, vbr=True),
    "crc_protected": lambda: F.encode_mp3(
        F.make_signal(44100, 1.0, 2, seed=9), 44100, bitrate=128, crc=True),
    "id3v2_front_id3v1_end": lambda: F.id3v2(300, footer=True) + F.encode_mp3(
        F.make_signal(24000, 1.0, 2, seed=10), 24000, bitrate=64) + F.id3v1(),
    "short_blocks_clicks": lambda: F.encode_mp3(
        F.make_signal(44100, 2.0, 2, seed=11, clicks=True), 44100,
        bitrate=128),
    "first_frames_cut": lambda: _cut_mp3(F.encode_mp3(
        F.make_signal(44100, 2.0, 2, seed=12), 44100, bitrate=128,
        tag=False), 5),
}

OGG_FIXTURES = {
    "vorbis_48k_stereo": lambda: F.encode_ogg(
        F.make_signal(48000, 1.0, 2, seed=20), 48000),
    "vorbis_44k_mono": lambda: F.encode_ogg(
        F.make_signal(44100, 1.0, 1, seed=21), 44100),
    "vorbis_16k_mono": lambda: F.encode_ogg(
        F.make_signal(16000, 1.0, 1, seed=22), 16000),
    "vorbis_44k_stereo_q0": lambda: F.encode_ogg(
        F.make_signal(44100, 1.0, 2, seed=23, clicks=True), 44100,
        quality=0.0),
    "vorbis_44k_stereo_q9": lambda: F.encode_ogg(
        F.make_signal(44100, 1.0, 2, seed=24), 44100, quality=0.9),
    "vorbis_48k_6ch": lambda: F.encode_ogg(
        F.make_signal(48000, 0.5, 6, seed=25), 48000),
}

_cache = {}


def fixture(name: str) -> bytes:
    if name not in _cache:
        _cache[name] = (MP3_FIXTURES.get(name) or OGG_FIXTURES[name])()
    return _cache[name]


def _agree(data: bytes, tol: float = TOL_LSB, min_snr: float = MIN_SNR_DB):
    """Decode with both packages; assert JAX's rate, exact length and the
    tolerance. Returns (port samples, JAX samples, sr)."""
    want, sr_want = jax_decode_audio(data)
    kind = "OGG" if data[:4] == b"OggS" else "MP3"
    got, sr = decode_compressed(data, kind)
    assert (sr, len(got), got.dtype) == (sr_want, len(want), np.float32)
    diff = np.abs(got.astype(np.float64) - want)
    err = float(np.sum(diff ** 2))
    snr = 10 * np.log10(float(np.sum(want.astype(np.float64) ** 2))
                        / max(err, 1e-30))
    assert diff.max() * 32768 <= tol, (diff.max() * 32768, snr)
    assert snr >= min_snr, snr
    return got, want, sr


# -- the sniffers: JAX's table tests on the port's copies ----------------------


def _mp3_header(version_bits, layer_bits, bitrate_idx, sr_idx, mode):
    b1 = 0xE0 | (version_bits << 3) | (layer_bits << 1)
    b2 = (bitrate_idx << 4) | (sr_idx << 2)
    b3 = mode << 6
    return bytes([0xFF, b1, b2, b3]) + b"\x00" * 64


def test_sniff_mp3_tables():
    assert sniff_mp3(_mp3_header(3, 1, 9, 0, 0)) == (44100, 2)
    assert sniff_mp3(_mp3_header(2, 1, 9, 1, 1)) == (24000, 2)
    assert sniff_mp3(_mp3_header(0, 1, 9, 2, 3)) == (8000, 1)


def test_sniff_mp3_skips_id3_and_junk():
    tag_body = b"\x00" * 100
    id3 = b"ID3\x04\x00\x00" + bytes([0, 0, 0, len(tag_body)]) + tag_body
    assert sniff_mp3(id3 + _mp3_header(3, 1, 9, 0, 3)) == (44100, 1)
    bad = _mp3_header(3, 1, 0, 0, 0)[:4] + _mp3_header(3, 1, 15, 3, 0)[:4]
    assert sniff_mp3(bad + b"\x00" * 32) is None


def test_sniff_ogg_vorbis_and_opus():
    def page(payload):
        return (b"OggS" + b"\x00" * 22 + bytes([1, len(payload)]) + payload)

    vorbis_id = b"\x01vorbis" + b"\x00\x00\x00\x00" + bytes([2]) \
        + struct.pack("<I", 22050) + b"\x00" * 16
    assert sniff_ogg(page(vorbis_id)) == (22050, 2)
    opus = b"OpusHead" + bytes([1, 1]) + b"\x00\x00" \
        + struct.pack("<I", 16000) + b"\x00" * 8
    assert sniff_ogg(page(opus)) == (48000, 1)
    assert sniff_ogg(b"OggS" + b"\x00" * 10) is None
    assert sniff_ogg(b"nope") is None


@needs_pygame
@pytest.mark.parametrize("path", [HOUSE_MP3, HOUSE_OGG],
                         ids=["house_lo.mp3", "house_lo.ogg"])
def test_sniff_real_files_as_jax(path):
    data = _read(path)
    sniff, jax_sniff = ((sniff_mp3, jax_sniff_mp3) if path.endswith("mp3")
                        else (sniff_ogg, jax_sniff_ogg))
    assert sniff(data) == jax_sniff(data) == (11025, 1)


# -- pygame's two files ------------------------------------------------------------


@needs_pygame
def test_house_lo_mp3_as_jax():
    """MPEG-2.5 at 11025 Hz, CRC-protected, long, start, short and stop
    blocks, no Xing frame: 139 whole frames of 576."""
    got, _, sr = _agree(_read(HOUSE_MP3))
    assert (sr, len(got)) == (11025, 80064)


@needs_pygame
def test_house_lo_ogg_as_jax():
    got, _, sr = _agree(_read(HOUSE_OGG))
    assert (sr, len(got)) == (11025, 78331)


@needs_pygame
def test_mp3_ogg_cross_correlation():
    """JAX's test on the port's decodes: the same recording through two
    unrelated codecs aligns (r > 0.95)."""
    a, sr_a = decode_audio(_read(HOUSE_MP3))
    b, sr_b = decode_audio(_read(HOUSE_OGG))
    assert sr_a == sr_b
    n = min(len(a), len(b))
    seg = 3 * sr_a
    c = np.correlate(a[:seg].astype(np.float64),
                     b[:seg].astype(np.float64), mode="full")
    lag = int(c.argmax()) - (seg - 1)
    assert 0 <= lag < 4000
    x, y = a[lag:n], b[:n - lag]
    m = min(len(x), len(y))
    r = np.corrcoef(x[:m], y[:m])[0, 1]
    assert r > 0.95, f"cross-codec correlation {r}"


# -- the matrix ----------------------------------------------------------------------


@needs_pygame
@needs_lame
@pytest.mark.parametrize("name", sorted(MP3_FIXTURES))
def test_mp3_matrix_as_jax(name):
    got, _, sr = _agree(fixture(name))
    if name == "mpeg1_44k_joint_lame_tag":
        assert (sr, len(got)) == (44100, 88200)  # trimmed by LAME's tag
    if name == "mpeg25_8k_no_tag":
        assert (sr, len(got)) == (8000, 17280)  # 30 whole frames of 576


@needs_pygame
@needs_sndfile
@pytest.mark.parametrize("name", sorted(OGG_FIXTURES))
def test_vorbis_matrix_as_jax(name):
    if name.endswith("6ch"):
        _agree(fixture(name), tol=MULTICHANNEL_TOL_LSB,
               min_snr=MULTICHANNEL_MIN_SNR_DB)
    else:
        _agree(fixture(name))


@needs_pygame
@needs_sndfile
@pytest.mark.parametrize("channels", [3, 4, 5, 6, 7, 8])
def test_more_than_two_channels_fold_as_sdl(channels):
    """SDL folds 3-8 channels to stereo before JAX's mean; the port's fold
    (``compressed.SDL_STEREO_LEFT``) lands within one step of it (three
    channels: on nearly every sample)."""
    data = F.encode_ogg(F.make_signal(48000, 0.5, channels, seed=50),
                        48000)
    got, want, _ = _agree(data, tol=MULTICHANNEL_TOL_LSB,
                          min_snr=MULTICHANNEL_MIN_SNR_DB)
    if channels == 3:
        assert np.mean(got == want) > 0.99


@needs_lame
def test_first_frames_cut_start_with_a_silent_frame():
    """The cut stream's first frame reaches into a reservoir that is not
    there: it is not decoded and gives 1152 zeros, as mpg123 gives."""
    pcm, _ = mp3.decode_mp3(fixture("first_frames_cut"))
    assert not pcm[:1152].any() and pcm[1152:2304].any()


@needs_lame
def test_ape_tag_at_the_end_is_skipped():
    data = fixture("mpeg2_24k_joint")
    a, _ = mp3.decode_mp3(data)
    b, _ = mp3.decode_mp3(data + _ape_tag())
    np.testing.assert_array_equal(a, b)


def _regranule(data: bytes, delta: int) -> bytes:
    """The Ogg file with ``delta`` added to every audio page's granule
    position (the CRC recomputed with the plain loop)."""
    out = bytearray()
    pos = 0
    while pos < len(data):
        n_seg = data[pos + 26]
        end = pos + 27 + n_seg + sum(data[pos + 27:pos + 27 + n_seg])
        page = bytearray(data[pos:end])
        (gran,) = struct.unpack_from("<q", page, 6)
        if gran > 0:
            struct.pack_into("<q", page, 6, gran + delta)
        page[22:26] = bytes(4)
        struct.pack_into("<I", page, 22, ogg.crc32(bytes(page)))
        out += page
        pos = end
    return bytes(out)


@needs_pygame
@needs_sndfile
@pytest.mark.parametrize("delta", [-300, 0, 5000])
def test_vorbis_granule_trims_as_libvorbisfile(delta):
    """A stream whose first granule position is past what its first page
    makes (a stream that starts later) keeps every sample; one before it
    cuts the difference from the start; the last page cuts the end."""
    data = _regranule(fixture("vorbis_44k_mono"), delta)
    got, _, _ = _agree(data)
    full, _ = vorbis.decode_vorbis(fixture("vorbis_44k_mono"))
    assert len(got) == len(full) - max(0, -delta)


def test_ogg_crc_plain_loop_equals_the_page_crc():
    rng = np.random.default_rng(0)
    for n in (27, 28, 300, 4000):
        page = bytes(rng.integers(0, 256, n, dtype=np.uint8))
        zeroed = page[:22] + bytes(4) + page[26:]
        assert ogg.crc32(zeroed) == ogg.page_crc(page, 0, n)


# -- what the fixtures reach --------------------------------------------------------


def _mp3_reached(monkeypatch, names):
    seen = set()
    orig = mp3.parse_side_info

    def spy(data, pos, h):
        out = orig(data, pos, h)
        stereo = {3: "mono", 0: "stereo", 2: "dual"}.get(h.mode)
        if h.mode == 1:
            stereo = "joint_ms" if h.mode_ext & 2 else "joint_lr"
        seen.add(stereo)
        for row in out[2]:
            for g in row:
                seen.add(f"block_{g.block_type}" + ("_mixed" if g.mixed
                                                    else ""))
                seen.add("count1_" + "AB"[g.count1_table - 32])
                if g.sf_scale:
                    seen.add("scalefac_scale")
                if g.preflag:
                    seen.add("preflag")
                if max(g.subblock_gain):
                    seen.add("subblock_gain")
        seen.add("mpeg1" if not h.lsf else ("mpeg25" if h.mpeg25
                                            else "mpeg2"))
        return out

    monkeypatch.setattr(mp3, "parse_side_info", spy)
    for name in names:  # the plain loops parse in Python, where the spy is
        mp3.decode_mp3(fixture(name) if name in MP3_FIXTURES
                       else _read(name), native=False)
    return seen


def _vorbis_reached(monkeypatch, names):
    seen = set()
    orig_setup, orig_header = vorbis.read_setup, vorbis.packet_header

    def setup(*args):
        s = orig_setup(*args)
        for r in s.residues:
            seen.add(f"residue_{r.kind}")
        if any(m.coupling for m in s.mappings):
            seen.add("coupling")
        if any(len(m.residues) > 1 for m in s.mappings):
            seen.add("submaps")
        for b in s.books:
            if b.values is not None:
                seen.add("vq_lookup")
        return s

    def header(data, s):
        out = orig_header(data, s)
        if out is not None:
            flag, prev, nxt, _, _ = out
            seen.add("long_block" if flag else "short_block")
            if flag and not (prev and nxt):
                seen.add("long_short_slope")
        return out

    monkeypatch.setattr(vorbis, "read_setup", setup)
    monkeypatch.setattr(vorbis, "packet_header", header)
    for name in names:
        vorbis.decode_vorbis(fixture(name) if name in OGG_FIXTURES
                             else _read(name))
    return seen


# What no fixture of the encoders these tests drive reaches (ROADMAP §3):
# LAME writes no mixed blocks and no dual-channel frames; libvorbis writes
# no residue 0.
MP3_UNREACHED = {"block_2_mixed", "dual"}
VORBIS_UNREACHED = {"residue_0"}


@needs_lame
@needs_pygame
def test_mp3_fixtures_reach_every_block_type_and_stereo_mode(monkeypatch):
    seen = _mp3_reached(monkeypatch, sorted(MP3_FIXTURES) + [HOUSE_MP3])
    want = {"block_0", "block_1", "block_2", "block_3", "mono", "stereo",
            "joint_ms", "joint_lr", "mpeg1", "mpeg2", "mpeg25", "count1_A",
            "count1_B", "scalefac_scale", "preflag"}
    assert want <= seen, want - seen
    assert not (MP3_UNREACHED & seen), MP3_UNREACHED & seen


@needs_sndfile
@needs_pygame
def test_vorbis_fixtures_reach_both_blocks_residues_1_2_submaps(monkeypatch):
    seen = _vorbis_reached(monkeypatch, sorted(OGG_FIXTURES) + [HOUSE_OGG])
    want = {"residue_1", "residue_2", "coupling", "submaps", "vq_lookup",
            "long_block", "short_block", "long_short_slope"}
    assert want <= seen, want - seen
    assert not (VORBIS_UNREACHED & seen), VORBIS_UNREACHED & seen


# -- the C++ helper against the plain loops -----------------------------------------


@needs_lame
@needs_sndfile
@pytest.mark.parametrize("name", ["mpeg1_48k_stereo", "mpeg2_16k_mono",
                                  "vorbis_48k_stereo", "vorbis_48k_6ch"])
def test_helper_decodes_as_the_plain_loops(name):
    assert native.get_lib() is not None
    data = fixture(name)
    decode = mp3.decode_mp3 if name in MP3_FIXTURES else vorbis.decode_vorbis
    a, sr_a = decode(data)
    b, sr_b = decode(data, native=False)
    assert sr_a == sr_b
    np.testing.assert_array_equal(a, b)


@needs_lame
def test_plain_version_when_the_helper_cannot_build(monkeypatch, caplog):
    def fail(name):
        raise RuntimeError("no compiler")
    monkeypatch.setattr(_build, "build_host", fail)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    data = fixture("mpeg1_32k_mono")
    with caplog.at_level(logging.WARNING):
        audio, sr = decode_audio(data)
        assert native.get_lib() is None
    warnings = [r.getMessage() for r in caplog.records
                if "native audio DSP" in r.getMessage()]
    assert warnings == ["native audio DSP build failed (no compiler); "
                        "using numpy paths"]
    monkeypatch.undo()
    np.testing.assert_array_equal(audio, decode_audio(data)[0])


def test_committed_files_decode_with_the_helper_as_plain():
    """The smoke's committed files (``e2e/data/compressed``): the helper
    and the plain loops agree on the shortest of each codec."""
    folder = os.path.join(ROOT, "e2e", "data", "compressed")
    for ext, decode in (("mp3", mp3.decode_mp3),
                        ("ogg", vorbis.decode_vorbis)):
        path = min((os.path.join(folder, f) for f in os.listdir(folder)
                    if f.endswith(ext)), key=os.path.getsize)
        a, _ = decode(_read(path))
        b, _ = decode(_read(path), native=False)
        np.testing.assert_array_equal(a, b)


# -- corrupt and cut streams in a subprocess --------------------------------------


WORKER = r"""
import struct, sys
from qwen3_asr_tpu_torch.audio.codec import AudioDecodeError, decode_audio
out = sys.stdout
while True:
    head = sys.stdin.buffer.read(4)
    if len(head) < 4:
        break
    data = sys.stdin.buffer.read(struct.unpack("<I", head)[0])
    try:
        audio, sr = decode_audio(data)
        ok = bool((abs(audio) <= 1.0).all())
        out.write(f"ok {len(audio)} {sr} {ok}\n")
    except AudioDecodeError as e:
        out.write("err " + type(e).__name__ + "\n")
    except BaseException as e:
        out.write("bad " + repr(e).replace("\n", " ")[:300] + "\n")
    out.flush()
"""
CASE_SECONDS = 20.0


class _Worker:
    def __init__(self):
        env = dict(os.environ, PYTHONPATH=ROOT)
        self.proc = subprocess.Popen(
            [sys.executable, "-c", WORKER], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, cwd=ROOT,
            env=env)

    def decode(self, data: bytes) -> str:
        import select
        self.proc.stdin.write(struct.pack("<I", len(data)) + data)
        self.proc.stdin.flush()
        ready, _, _ = select.select([self.proc.stdout], [], [], CASE_SECONDS)
        if not ready:
            self.proc.kill()
            raise AssertionError(f"decode hung past {CASE_SECONDS} s")
        line = self.proc.stdout.readline().decode()
        if not line:
            raise AssertionError(
                f"decoder process died (exit {self.proc.wait()})")
        return line.strip()

    def close(self):
        self.proc.stdin.close()
        self.proc.wait(timeout=30)


@pytest.fixture(scope="module")
def worker():
    w = _Worker()
    yield w
    w.close()


@pytest.fixture(scope="module")
def fuzz_sources():
    """A short MP3 and a 2 s Ogg Vorbis (several pages) to cut and flip,
    those whose encoder is present."""
    out = {}
    if F.lame() is not None:
        out["mp3"] = F.encode_mp3(F.make_signal(44100, 0.4, 2, seed=30),
                                  44100, bitrate=96)
    if F.sndfile() is not None:
        out["ogg"] = F.encode_ogg(F.make_signal(22050, 2.0, 2, seed=31),
                                  22050)
    return out


@pytest.mark.skipif(F.lame() is None and F.sndfile() is None,
                    reason="neither libmp3lame nor libsndfile is present")
@settings(max_examples=40, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(codec=st.sampled_from(["mp3", "ogg"]),
       cut=st.floats(0.0, 1.0),
       flips=st.lists(st.tuples(st.floats(0.0, 1.0), st.integers(0, 7)),
                      max_size=6))
def test_cut_and_flipped_streams_decode_or_raise(worker, fuzz_sources, codec,
                                                 cut, flips):
    assume(codec in fuzz_sources)
    data = bytearray(fuzz_sources[codec])
    for at, bit in flips:
        i = min(int(at * len(data)), len(data) - 1)
        data[i] ^= 1 << bit
    data = bytes(data[:max(16, int(cut * len(data)))])
    line = worker.decode(data)
    assert line.startswith(("ok", "err")), line
    if line.startswith("ok"):
        assert line.endswith("True"), line


def test_a_corrupt_ogg_page_raises():
    page = bytearray(fixture("vorbis_16k_mono") if F.sndfile() else b"")
    if not page:
        pytest.skip("libsndfile is not present")
    page[200] ^= 0x40
    with pytest.raises(AudioDecodeError, match="CRC"):
        decode_audio(bytes(page))


# -- sizes from headers, and memory ---------------------------------------------


def test_hand_written_vorbis_silence_decodes():
    """The hand-written stream of the tests below is valid Vorbis: two
    channels of 20 one-byte packets decode to 19 * 1024 zeros, by the
    helper and by the plain loops."""
    data = F.vorbis_silence(2, 20)
    a, sr = vorbis.decode_vorbis(data)
    b, _ = vorbis.decode_vorbis(data, native=False)
    assert (a.shape, sr) == ((19 * 1024, 2), 44100) and not a.any()
    np.testing.assert_array_equal(a, b)


def test_255_channels_of_one_byte_packets_are_refused_at_the_header(
        worker, monkeypatch):
    """Each one-byte packet of a 255-channel stream with 8192-sample
    blocks asks for 255 * 4096 values: ~21 KB would decode to 10^10. The
    identification header is refused (at most 8 channels) before anything
    is decoded, quickly, in the subprocess too; with the limit lifted the
    same header and packets decode."""
    monkeypatch.setattr(vorbis, "MAX_CHANNELS", 255)
    few = vorbis.decode_vorbis(F.vorbis_silence(255, 3, blocksizes=(256,
                                                                    8192)))[0]
    assert few.shape == (2 * 4096, 255)
    monkeypatch.undo()
    data = F.vorbis_silence(255, 10000, blocksizes=(256, 8192))
    assert len(data) < 25000
    with pytest.raises(UnsupportedFormatError,
                       match="255 channels are not supported"):
        decode_audio(data)
    t = time.monotonic()
    assert worker.decode(data) == "err UnsupportedFormatError"
    assert time.monotonic() - t < 5.0


def test_a_stream_past_the_decoded_limit_is_refused_before_decoding(worker):
    """Eight channels of 8192-sample blocks, one byte a packet: 16400
    packets would decode to more than ``MAX_DECODED_SAMPLES`` samples; the
    stream is refused before its spectra are allocated."""
    data = F.vorbis_silence(8, 16400, blocksizes=(256, 8192))
    assert 16400 * 4096 * 8 > MAX_DECODED_SAMPLES
    with pytest.raises(AudioDecodeError, match="decodes to more than"):
        vorbis.decode_vorbis(data)
    t = time.monotonic()
    assert worker.decode(data) == "err VorbisError"
    assert time.monotonic() - t < 5.0


def test_mp3_decoded_limit_counts_frames_samples_and_channels(monkeypatch):
    data = _read(os.path.join(ROOT, "e2e", "data", "compressed",
                              "long_44k_stereo.mp3"))
    full, _ = mp3.decode_mp3(data)
    frames = 0
    pos = mp3.parse_header(data, 0).size  # the Info frame is not audio
    while pos < len(data) and mp3.parse_header(data, pos):
        pos += mp3.parse_header(data, pos).size
        frames += 1
    monkeypatch.setattr(mp3, "MAX_DECODED_SAMPLES", frames * 1152 * 2)
    np.testing.assert_array_equal(mp3.decode_mp3(data)[0], full)
    monkeypatch.setattr(mp3, "MAX_DECODED_SAMPLES", frames * 1152 * 2 - 1)
    with pytest.raises(AudioDecodeError, match="decodes to more than"):
        mp3.decode_mp3(data)


def _long_upload(codec: str) -> bytes:
    """~5 minutes of 44.1 kHz stereo: the committed 29.5 s MP3's audio
    frames ten times over (its Info frame dropped), or 3250 one-byte
    Vorbis packets of 8192-sample blocks."""
    if codec == "mp3":
        data = _read(os.path.join(ROOT, "e2e", "data", "compressed",
                                  "long_44k_stereo.mp3"))
        return data[mp3.parse_header(data, 0).size:] * 10
    return F.vorbis_silence(2, 3250, blocksizes=(256, 8192))


@pytest.mark.parametrize("codec", ["mp3", "ogg"])
def test_long_upload_peak_memory_stays_near_its_output(codec):
    """The peak memory that a ~5 min 44.1 kHz stereo upload's decode
    allocates (numpy's and Python's, by ``tracemalloc``, in a process of
    its own: ``tests/decode_peak.py``) stays within twice its mono float32
    output plus 64 MiB: the decoders work in blocks and fold to mono as
    they go. Decoding the whole upload at once took ~12-25x its output."""
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tests", "decode_peak.py")],
        input=_long_upload(codec),
        capture_output=True, cwd=ROOT, env=dict(os.environ, PYTHONPATH=ROOT),
        timeout=120)
    assert proc.returncode == 0, proc.stderr.decode()[-2000:]
    got = json.loads(proc.stdout.decode().strip().splitlines()[-1])
    assert got["sr"] == 44100 and got["samples"] > 290 * 44100
    assert got["peak"] <= 2 * got["out"] + (64 << 20), got


# -- Ogg Opus (tests/test_torch_opus.py has its matrix); chained streams -----------


@needs_pygame
@needs_sndfile
def test_opus_is_refused_where_jax_decodes_it():
    """Ogg Opus was refused here until the port had its own decoder; now
    libsndfile's Opus (CELT) decodes to JAX's rate and length, within the
    bound of opusfile's dither (``tests/test_torch_opus.py``
    ``DITHER_TOL_LSB``, ``DITHER_MIN_SNR_DB``)."""
    from tests.test_torch_opus import DITHER_MIN_SNR_DB, DITHER_TOL_LSB
    data = F.encode_ogg(F.make_signal(48000, 1.0, 1, seed=40), 48000,
                        codec="opus")
    want, sr = jax_decode_audio(data)
    assert (sr, len(want)) == (48000, 48000)
    _agree(data, DITHER_TOL_LSB, DITHER_MIN_SNR_DB)


@needs_sndfile
def test_chained_ogg_is_refused():
    a = fixture("vorbis_16k_mono")
    b = F.encode_ogg(F.make_signal(16000, 0.5, 1, seed=41), 16000)
    assert ogg.read_packets(a)[1] != ogg.read_packets(b)[1]
    with pytest.raises(UnsupportedFormatError, match="chained"):
        decode_audio(a + b)


def test_vorbis_codewords_take_the_lowest_free_word_in_entry_order():
    """Not canonical Huffman: lengths 2, 4, 4, 4, 4, 2, 3, 3 give the
    specification's example's words."""
    words = vorbis.codewords([2, 4, 4, 4, 4, 2, 3, 3])
    assert [format(w, f"0{n}b") for w, n in zip(
        words, [2, 4, 4, 4, 4, 2, 3, 3])] == \
        ["00", "0100", "0101", "0110", "0111", "10", "110", "111"]
    with pytest.raises(AudioDecodeError):
        vorbis.codewords([1, 1, 1])


@pytest.mark.parametrize("entries,dims,want", [
    (81, 4, 3), (80, 4, 2), (1, 1, 1), (1 << 16, 2, 256), (255, 8, 1),
    (256, 8, 2), (19683, 9, 3), (19682, 9, 2)])
def test_lookup1_values_is_exact(entries, dims, want):
    assert vorbis.lookup1_values(entries, dims) == want

