"""The port's VAD (``audio/vad.py`` spectral, ``audio/vad_model.py``
learned) and the WS tick's host DSP (``pcm16_to_f32``, ``fir_same``, the
bandpass kernel, ``StreamingResampler``) against the JAX package's on the
CPU, the same numpy inputs through both.

Inputs: the 12 in-repo real clips (whole, and their first 450 ms and last
1.2 s: a tick's tail and a window), synthetic noise, a tone, silence, and
the speech-like signal of ``tests/util_audio.py``. Probabilities agree
within 1e-4 absolute (both compute in f32; their FFTs sum in different
orders), and ``is_speech``, ``active_backend`` and
``default_flush_ticks`` are identical. The DSP: the bandpass kernel and
``pcm16_to_f32`` bit for bit, ``fir_same`` within 1e-6, and the streaming
resampler's s16 output byte for byte against JAX's over the same split
frames (JAX's numpy path, its reference: its C++ path may round a sample
apart)."""
import glob
import os

import numpy as np
import pytest
import torch

from qwen3_asr_tpu.audio import vad as jvad
from qwen3_asr_tpu.audio import vad_model as jvad_model
from qwen3_asr_tpu_torch.audio import vad, vad_model
from qwen3_asr_tpu_torch.audio.codec import decode_audio
from tests.util_audio import silence, speech_like, tone, white_noise

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data", "real")
CLIPS = sorted(glob.glob(os.path.join(ROOT, "*.wav")))
PROB_ATOL = 1e-4


def _clip(path):
    with open(path, "rb") as f:
        audio, sr = decode_audio(f.read())
    assert sr == 16000
    return audio.astype(np.float32) / 32768.0 if audio.dtype == np.int16 \
        else audio


def _inputs():
    out = {}
    for path in CLIPS:
        name = os.path.basename(path)[:-4]
        a = _clip(path)
        out[name] = a
        out[name + "_tick"] = a[:7200]
        out[name + "_window"] = a[-19200:]
    out["noise"] = white_noise(1.0, seed=3).astype(np.float32)
    out["loud_noise"] = white_noise(2.0, amplitude=0.5, seed=4).astype(
        np.float32)
    out["tone"] = tone(1.0).astype(np.float32)
    out["silence"] = silence(0.6).astype(np.float32)
    out["speech_like"] = speech_like(1.5, seed=5).astype(np.float32)
    out["short"] = white_noise(0.01, seed=6).astype(np.float32)
    return out


INPUTS = _inputs()


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", list(INPUTS))
def test_spectral_probability_matches_jax(name):
    x = INPUTS[name]
    ours = vad.spectral_probability(x, "cpu")
    ref = jvad._spectral_probability(x)
    assert abs(ours - ref) <= PROB_ATOL, (ours, ref)
    assert (ours >= 0.5) == (ref >= 0.5)


@pytest.mark.parametrize("name", list(INPUTS))
def test_learned_probability_matches_jax(name):
    x = INPUTS[name]
    ours = vad_model.speech_probability(x, "cpu")
    ref = jvad_model.speech_probability(x)
    assert abs(ours - ref) <= PROB_ATOL, (ours, ref)
    assert vad.is_speech(x, device="cpu") == jvad.is_speech(x)


def test_learned_vad_on_real_speech_and_noise():
    """The learned VAD hears every real clip and no synthetic noise or
    silence, as the JAX package's does."""
    for path in CLIPS:
        assert vad.is_speech(_clip(path), device="cpu"), path
    for name in ("noise", "silence", "tone"):
        assert (vad.is_speech(INPUTS[name], device="cpu")
                == jvad.is_speech(INPUTS[name]))
    assert not vad.is_speech(INPUTS["silence"], device="cpu")


def test_params_from_jax_is_the_packaged_copy():
    """The port's copy of the weights is the JAX package's file, and
    ``params_from_jax`` of JAX's dict gives the same frame logits."""
    ours, ref = vad_model.load_params(), jvad_model.load_params()
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    assert os.path.dirname(vad_model.WEIGHTS_PATH).endswith(
        os.path.join("qwen3_asr_tpu_torch", "audio"))
    import jax.numpy as jnp
    feats = np.random.default_rng(0).standard_normal((60, 32)).astype(
        np.float32)
    net = vad_model.params_from_jax(ref, "cpu")
    with torch.inference_mode():
        got = net.frame_logits(torch.from_numpy(feats)).numpy()
    want = np.asarray(jvad_model.frame_logits(
        {k: jnp.asarray(v) for k, v in ref.items()}, jnp.asarray(feats)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("env", ["", "spectral", "learned"])
def test_backend_and_flush_ticks_match_jax(monkeypatch, env):
    monkeypatch.setenv("ASR_VAD", env)
    assert vad.active_backend() == jvad.active_backend()
    assert vad.default_flush_ticks() == jvad.default_flush_ticks()
    x = INPUTS["english_01_tick"]
    assert vad.is_speech(x, device="cpu") == jvad.is_speech(x)


def test_backend_without_weights_matches_jax(monkeypatch, tmp_path):
    monkeypatch.setenv("ASR_VAD_WEIGHTS", str(tmp_path / "none.npz"))
    monkeypatch.setattr(jvad_model, "_params", None)
    monkeypatch.setenv("ASR_VAD", "")
    assert vad.active_backend() == jvad.active_backend() == "spectral"
    assert vad.default_flush_ticks() == jvad.default_flush_ticks() == 2
    monkeypatch.setenv("ASR_VAD", "learned")
    with pytest.raises(FileNotFoundError):
        vad.active_backend()
    assert vad.default_flush_ticks() == 2


def test_vad_entry_points_run_on_the_card_unless_asked(monkeypatch):
    """With no device given, every VAD entry point asks for the card: on a
    machine without one it raises ``resolve_device``'s error, and
    ``is_speech`` answers "speech" as JAX does but counts the failure."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = INPUTS["english_01_tick"]
    for fn in (vad.spectral_probability, vad.speech_probability,
               vad_model.speech_probability):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(x)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        vad_model.params_from_jax(vad_model.load_params())
    before = vad.failures
    assert vad.is_speech(INPUTS["silence"]) is True
    assert vad.failures == before + 1
    assert vad.is_speech(INPUTS["silence"], device="cpu") is False
    assert vad.failures == before + 1


def test_is_speech_failure_is_logged_and_counted(monkeypatch, caplog):
    """A detector that raises: "speech" (JAX's answer), one failure
    counted and the exception logged, for each call."""
    def broken(*a, **k):
        raise ValueError("detector broke")

    monkeypatch.setattr(vad, "speech_probability", broken)
    before = vad.failures
    with caplog.at_level("ERROR", logger=vad.__name__):
        assert vad.is_speech(INPUTS["silence"], device="cpu") is True
        assert vad.is_speech(INPUTS["tone"], device="cpu") is True
    assert vad.failures == before + 2
    assert "detector broke" in caplog.text


# -- the tick's host DSP ---------------------------------------------------------

def test_bandpass_and_pcm_match_jax():
    from qwen3_asr_tpu.audio import frontend as jfront
    from qwen3_asr_tpu.audio import native as jnative
    from qwen3_asr_tpu_torch.audio.frontend import (fir_bandpass_kernel,
                                                    fir_same, pcm16_to_f32)
    h = fir_bandpass_kernel()
    np.testing.assert_array_equal(h, jfront.fir_bandpass_kernel())
    pcm = (np.random.default_rng(1).standard_normal(9000) * 8000).clip(
        -32768, 32767).astype("<i2").tobytes()
    x = pcm16_to_f32(pcm)
    np.testing.assert_array_equal(x, jnative.pcm16_to_f32(pcm))
    np.testing.assert_allclose(fir_same(x, h), jnative.fir_same(x, h),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("frames", [[160, 161, 1000, 7, 3200, 1],
                                     [7200] * 4, [1, 2, 3, 4, 5, 999]],
                         ids=["ragged", "ticks", "tiny"])
def test_streaming_resampler_matches_jax(monkeypatch, frames):
    from qwen3_asr_tpu.audio import native as jnative
    from qwen3_asr_tpu.audio.resample import StreamingResampler as JaxSR
    from qwen3_asr_tpu_torch.audio.resample import StreamingResampler
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    pcm = (speech_like(1.5, sr=8000, seed=2) * 20000).clip(
        -32768, 32767).astype("<i2").tobytes()
    ours, ref = StreamingResampler(8000, 16000), JaxSR(8000, 16000)
    off, got, want = 0, [], []
    for n in frames:
        piece = pcm[off:off + n]
        off += n
        got.append(ours.process_pcm(piece))
        want.append(ref.process_pcm(piece))
    assert got == want
    assert sum(map(len, got)) > 0
