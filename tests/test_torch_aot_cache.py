"""The port's boot cache (``runtime/aot_cache.py``, ``ASR_AOT_CACHE_DIR``)
held to the contract of ``tests/test_aot_cache.py``: results through
cached entries are token-identical to the uncached engine, entries are
reused (not rebuilt) by later boots, a corrupt entry is rebuilt, an env
change that shapes an entry gives a new fingerprint, and the source hash
follows the content. The entries are the libraries ``ops/_build.py``
compiles; on this CPU that is the host library (``csrc/audio_dsp.cpp``,
``g++``: the FLAC, MP3 and Vorbis helpers), the one a CPU boot builds."""
import os
import subprocess

import numpy as np
import pytest

from qwen3_asr_tpu_torch.audio import native
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.audio.flac import encode_flac
from qwen3_asr_tpu_torch.ops import _build
from qwen3_asr_tpu_torch.runtime import aot_cache
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine

from tests.fixtures import write_tiny_checkpoint


@pytest.fixture(autouse=True)
def _quick_host_builds(monkeypatch):
    """Unoptimized host builds (0.9 s of g++ here against 2.6 s at -O3):
    the flags are part of every library's name and fingerprint, so the
    cache's behaviour is the same."""
    monkeypatch.setattr(_build, "HOST_FLAGS",
                        ("-O0", "-shared", "-fPIC", "-std=c++17"))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("aot_ckpt"))
    write_tiny_checkpoint(path)
    return path


def _boot(monkeypatch, build_dir):
    """A new process's state: an empty build directory, no helper loaded."""
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)


def _no_compiler(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a compiler ran: the cache was not used")
    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)


def _entries(cache):
    return {os.path.join(d, f): os.path.getmtime(os.path.join(d, f))
            for d, _, fs in os.walk(cache) for f in fs}


def _flac():
    rng = np.random.default_rng(7)
    return encode_flac((rng.standard_normal(16000) * 0.05).astype(
        np.float32), 16000)


def test_cached_boot_is_token_identical(ckpt, tmp_path, monkeypatch):
    """An upload decoded through the helper built into an empty cache, and
    through the helper a later boot takes from it with no compiler,
    transcribes to the uncached boot's token ids."""
    engine = load_engine(ckpt, device="cpu")
    _boot(monkeypatch, tmp_path / "plain")
    audio = decode_audio(_flac())[0]
    assert native.get_lib() is not None
    plain = [r.token_ids for r in engine.transcribe(audio, 16000,
                                                    language="en")]

    monkeypatch.setenv("ASR_AOT_CACHE_DIR", str(tmp_path / "cache"))
    for build in ("cold", "warm"):
        _boot(monkeypatch, tmp_path / build)
        if build == "warm":
            _no_compiler(monkeypatch)
        got = decode_audio(_flac())[0]
        assert native.get_lib() is not None
        assert np.array_equal(got, audio)
        assert [r.token_ids for r in engine.transcribe(
            got, 16000, language="en")] == plain
    assert any(e.startswith("lib-") for e in os.listdir(tmp_path / "cache"))


def test_entries_are_reused_not_rebuilt(tmp_path, monkeypatch):
    cache = tmp_path / "cache"
    monkeypatch.setenv("ASR_AOT_CACHE_DIR", str(cache))
    _boot(monkeypatch, tmp_path / "b1")
    built = _build.build_host("audio_dsp")
    files = _entries(cache)
    assert sorted(os.path.basename(f) for f in files) == [
        built.name, built.name + ".sha256"]
    for build in ("b2", "b3"):
        _boot(monkeypatch, tmp_path / build)
        _no_compiler(monkeypatch)
        lib = _build.build_host("audio_dsp")
        assert lib.read_bytes() == built.read_bytes()
    assert _entries(cache) == files, "an entry was rebuilt, not reused"


@pytest.mark.parametrize("damage", ["bytes", "digest", "truncated"])
def test_corrupt_entries_are_rebuilt(tmp_path, monkeypatch, damage):
    cache = tmp_path / "cache"
    monkeypatch.setenv("ASR_AOT_CACHE_DIR", str(cache))
    _boot(monkeypatch, tmp_path / "b1")
    good = _build.build_host("audio_dsp").read_bytes()
    entry = next(f for f in _entries(cache)
                 if f.endswith(".so") and "lib-" in f)
    if damage == "bytes":
        with open(entry, "wb") as fh:
            fh.write(b"not a library")
    elif damage == "digest":
        with open(entry + ".sha256", "w") as fh:
            fh.write("0" * 64)
    else:
        with open(entry, "wb") as fh:
            fh.write(good[:len(good) // 2])
    _boot(monkeypatch, tmp_path / "b2")
    rebuilt = _build.build_host("audio_dsp")     # g++ again, republished
    assert rebuilt.read_bytes() == good
    assert native.get_lib() is not None
    with open(entry, "rb") as fh:
        assert fh.read() == good
    _boot(monkeypatch, tmp_path / "b3")
    _no_compiler(monkeypatch)
    assert _build.build_host("audio_dsp").read_bytes() == good


def test_build_env_changes_fingerprint(tmp_path, monkeypatch):
    """``CUDA_HOME`` (which toolkit builds) gives a new library directory;
    JAX's program-shaping variables change no library and no fingerprint."""
    cache = aot_cache.AotCache(str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    before = cache.library_dir(_build.NVCC_FLAGS)
    for name, value in (("QUANTIZE", "int8"), ("ASR_KV_CACHE_DTYPE", "int4"),
                        ("ASR_DECODER_UNROLL", "scan")):
        monkeypatch.setenv(name, value)
        assert cache.library_dir(_build.NVCC_FLAGS) == before, name
    monkeypatch.setenv("CUDA_HOME", "/usr/local/cuda-other")
    assert cache.library_dir(_build.NVCC_FLAGS) != before
    assert cache.library_dir(_build.HOST_FLAGS) != cache.library_dir(
        _build.NVCC_FLAGS)


def test_build_env_change_rebuilds(tmp_path, monkeypatch):
    monkeypatch.setenv("ASR_AOT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    _boot(monkeypatch, tmp_path / "b1")
    _build.build_host("audio_dsp")
    before = set(os.listdir(tmp_path / "cache"))
    monkeypatch.setenv("CUDA_HOME", "/usr/local/cuda-other")
    _boot(monkeypatch, tmp_path / "b2")
    _build.build_host("audio_dsp")
    assert set(os.listdir(tmp_path / "cache")) - before, \
        "an env change reused a stale fingerprint"


def test_source_hash_tracks_content(tmp_path):
    """The package-source hash is byte-content-sensitive and order-stable,
    over Python, CUDA and C++ sources."""
    pkg = tmp_path / "pkg"
    (pkg / "csrc").mkdir(parents=True)
    (pkg / "runtime").mkdir()
    (pkg / "runtime" / "engine.py").write_text("x = 1\n")
    (pkg / "csrc" / "k.cu").write_text("__global__ void k() {}\n")
    h1 = aot_cache.package_source_hash(str(pkg))
    assert h1 == aot_cache.package_source_hash(str(pkg))
    os.utime(pkg / "runtime" / "engine.py")
    assert aot_cache.package_source_hash(str(pkg)) == h1, \
        "a modification time changed the hash"
    (pkg / "csrc" / "k.cu").write_text("__global__ void k() { }\n")
    h2 = aot_cache.package_source_hash(str(pkg))
    assert h2 != h1, "a kernel source edit did not change the hash"
    (pkg / "runtime" / "engine.py").write_text("x = 2\n")
    h3 = aot_cache.package_source_hash(str(pkg))
    assert h3 != h2, "a Python edit did not change the hash"
    (pkg / "README.md").write_text("hello")
    (pkg / "_build").mkdir()
    (pkg / "_build" / "k.cu").write_text("built output")
    assert aot_cache.package_source_hash(str(pkg)) == h3


def test_source_change_invalidates_entries(tmp_path, monkeypatch):
    """An edited source (a new package hash) gives new entries."""
    monkeypatch.setenv("ASR_AOT_CACHE_DIR", str(tmp_path / "cache"))
    monkeypatch.setattr(aot_cache, "package_source_hash",
                        lambda root=None: "aaaa")
    _boot(monkeypatch, tmp_path / "b1")
    _build.build_host("audio_dsp")
    before = set(os.listdir(tmp_path / "cache"))
    monkeypatch.setattr(aot_cache, "package_source_hash",
                        lambda root=None: "bbbb")
    _boot(monkeypatch, tmp_path / "b2")
    _build.build_host("audio_dsp")
    assert set(os.listdir(tmp_path / "cache")) - before, \
        "a source change reused a stale entry"


def test_no_cache_without_the_env(tmp_path, monkeypatch):
    monkeypatch.delenv("ASR_AOT_CACHE_DIR", raising=False)
    assert aot_cache.AotCache.from_env() is None
    _boot(monkeypatch, tmp_path / "b1")
    assert _build.build_host("audio_dsp").is_file()
    assert not list(tmp_path.glob("**/lib-*"))


def test_a_built_library_fills_an_empty_cache(tmp_path, monkeypatch):
    """A library found built in ``_build/`` (no compiler run) is published
    to a new cache, once: a later boot with an empty build directory takes
    it from there."""
    _boot(monkeypatch, tmp_path / "b1")
    built = _build.build_host("audio_dsp")          # no cache yet
    monkeypatch.setenv("ASR_AOT_CACHE_DIR", str(tmp_path / "cache"))
    _no_compiler(monkeypatch)
    assert _build.build_host("audio_dsp") == built
    files = _entries(tmp_path / "cache")
    assert len(files) == 2
    _build.build_host("audio_dsp")
    assert _entries(tmp_path / "cache") == files, "published twice"
    _boot(monkeypatch, tmp_path / "b2")
    assert _build.build_host("audio_dsp").read_bytes() == built.read_bytes()
