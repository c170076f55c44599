"""The port's operator tools against the JAX package's: the counterpart
of ``tests/test_tools.py``. ``debug_audio.describe`` on WAV and resampled
input; the offline transcribe CLI's JSON lines, error records and SRT
files against JAX's CLI on the CPU (``--device cpu``); and the encoder's
``torch.export`` with flash attention as a registered operator, whose
program equals the port's eager encoder exactly and JAX's
``encoder_forward`` within 1e-5."""
import json
import os
import shutil

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models.encoder import encoder_forward as jax_encoder
from qwen3_asr_tpu.sidecars import subtitle as jax_subtitle
from qwen3_asr_tpu.tools import debug_audio as jax_debug
from qwen3_asr_tpu.tools import transcribe as jax_cli
from qwen3_asr_tpu_torch.audio.codec import encode_wav
from qwen3_asr_tpu_torch.models.encoder import encoder_forward
from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
from qwen3_asr_tpu_torch.sidecars import subtitle
from qwen3_asr_tpu_torch.tools import debug_audio, transcribe
from qwen3_asr_tpu_torch.tools.export_encoder import (bucket_mel_frames,
                                                      export_encoder,
                                                      export_program,
                                                      flash_nodes,
                                                      load_encoder)
from qwen3_asr_tpu_torch.tools.train_vad import speech_like

from tests.fixtures import write_tiny_checkpoint

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
TRAINED = os.path.join(ROOT, "trained_ckpt")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("tools_ckpt"))
    write_tiny_checkpoint(path)
    return path


# -- debug_audio ------------------------------------------------------------

@pytest.mark.parametrize("sr,target", [(16000, None), (8000, 16000),
                                       (44100, 16000), (16000, 8000)])
def test_describe_equals_jax(tmp_path, sr, target):
    wav = tmp_path / "t.wav"
    wav.write_bytes(encode_wav(speech_like(1.3, sr=sr, seed=sr), sr))
    got = debug_audio.describe(str(wav), target_sr=target, device="cpu")
    want = jax_debug.describe(str(wav), target_sr=target)
    p, q = got.pop("speech_probability"), want.pop("speech_probability")
    assert abs(p - q) <= 1e-3
    assert got == want
    if target and target != sr:
        assert got["resampled_to"] == target


def test_describe_short_clip_has_no_probability(tmp_path):
    wav = tmp_path / "s.wav"
    wav.write_bytes(encode_wav(speech_like(0.02, seed=1), 16000))
    got = debug_audio.describe(str(wav), device="cpu")
    assert "speech_probability" not in got
    assert got == jax_debug.describe(str(wav))


def test_debug_audio_main_prints_every_key(tmp_path, capsys):
    wav = tmp_path / "t.wav"
    wav.write_bytes(encode_wav(speech_like(1.0, seed=0), 16000))
    debug_audio.main([str(wav), "--device", "cpu"])
    out = capsys.readouterr().out
    for key in ("sample_rate", "duration_s", "peak", "speech_probability"):
        assert f"{key:>20}: " in out


# -- transcribe CLI ---------------------------------------------------------

def _clips(tmp_path, n=3):
    paths = []
    for i in range(n):
        p = tmp_path / f"clip{i}.wav"
        p.write_bytes(encode_wav(speech_like(0.5 + 0.4 * i, seed=i), 16000))
        paths.append(str(p))
    return paths


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("extra", [[], ["--batch-size", "2"],
                                   ["--timestamps"]],
                         ids=["batched", "batch2", "timestamps"])
def test_transcribe_json_equals_jax(ckpt, tmp_path, capsys, extra):
    wavs = _clips(tmp_path)
    args = wavs + ["--model", ckpt, "--language", "en", "--json"] + extra
    rc, out, _ = _run(transcribe.main,
                      args + ["--output-dir", str(tmp_path / "port"),
                              "--device", "cpu"], capsys)
    jrc, jout, _ = _run(jax_cli.main,
                        args + ["--output-dir", str(tmp_path / "jax")],
                        capsys)
    assert rc == jrc == 0
    got = [json.loads(line) for line in out.strip().splitlines()]
    want = [json.loads(line) for line in jout.strip().splitlines()]
    assert [r["file"] for r in got] == wavs
    for g, w in zip(got, want):
        assert g.pop("txt").endswith(os.path.join("port", os.path.basename(
            w.pop("txt"))))
    assert got == want
    for name in os.listdir(tmp_path / "jax"):
        assert ((tmp_path / "port" / name).read_text()
                == (tmp_path / "jax" / name).read_text())


def test_transcribe_text_lines_equal_jax(ckpt, tmp_path, capsys):
    wavs = _clips(tmp_path, 2)
    rc, out, _ = _run(transcribe.main,
                      wavs + ["--model", ckpt, "--device", "cpu"], capsys)
    jrc, jout, _ = _run(jax_cli.main, wavs + ["--model", ckpt], capsys)
    assert rc == jrc == 0 and out == jout
    assert out.splitlines()[0].startswith(wavs[0] + "\t")


def test_transcribe_bad_file_reports_and_continues(ckpt, tmp_path, capsys):
    good = _clips(tmp_path, 1)[0]
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not audio at all")
    missing = str(tmp_path / "missing.wav")
    for as_json in ([], ["--json"]):
        args = [str(bad), good, missing, "--model", ckpt, "--language",
                "en"] + as_json
        rc, out, err = _run(transcribe.main, args + ["--device", "cpu"],
                            capsys)
        jrc, jout, jerr = _run(jax_cli.main, args, capsys)
        assert rc == jrc == 1
        assert out == jout and good in out
        errors = [line for line in err.splitlines()
                  if not line.startswith("[")]
        jerrors = [line for line in jerr.splitlines()
                   if not line.startswith("[")]
        assert errors == jerrors and len(errors) == 2


def test_transcribe_without_model_exits_2(capsys, monkeypatch):
    monkeypatch.delenv("MODEL_ID", raising=False)
    assert transcribe.main(["x.wav"]) == 2
    assert "no model" in capsys.readouterr().err


def test_srt_files_equal_jax(tmp_path, capsys, monkeypatch):
    """``--srt`` in both modes on the trained checkpoint, the aligner of
    ``accurate`` being the same checkpoint."""
    wavs = []
    for name in ("english_01", "chinese_02"):
        dst = tmp_path / f"{name}.wav"
        shutil.copy(os.path.join(ROOT, "real", name + ".wav"), dst)
        wavs.append(str(dst))
    monkeypatch.setattr(subtitle, "FORCED_ALIGNER_ID", TRAINED)
    monkeypatch.setattr(jax_subtitle, "FORCED_ALIGNER_ID", TRAINED)
    try:
        for mode in ("fast", "accurate"):
            args = wavs + ["--model", TRAINED, "--json", "--srt",
                           "--srt-mode", mode]
            rc, out, _ = _run(transcribe.main, args + [
                "--output-dir", str(tmp_path / f"p_{mode}"),
                "--device", "cpu"], capsys)
            jrc, jout, _ = _run(jax_cli.main, args + [
                "--output-dir", str(tmp_path / f"j_{mode}")], capsys)
            assert rc == jrc == 0
            got = [json.loads(line) for line in out.splitlines()]
            want = [json.loads(line) for line in jout.splitlines()]
            assert [g["text"] for g in got] == [w["text"] for w in want]
            for g, w in zip(got, want):
                with open(g["srt"]) as f, open(w["srt"]) as h:
                    srt = f.read()
                    assert srt == h.read() and "-->" in srt
    finally:
        subtitle.unload_aligner()
        jax_subtitle.unload_aligner()


def test_accurate_srt_without_aligner_exits_2(ckpt, tmp_path, capsys,
                                              monkeypatch):
    monkeypatch.setattr(subtitle, "FORCED_ALIGNER_ID",
                        str(tmp_path / "nowhere"))
    rc = transcribe.main(_clips(tmp_path, 1) + [
        "--model", ckpt, "--srt", "--srt-mode", "accurate", "--device",
        "cpu"])
    assert rc == 2
    assert "needs a loadable aligner" in capsys.readouterr().err


# -- the encoder's export ---------------------------------------------------

@pytest.fixture(scope="module")
def exported(ckpt, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("export") / "encoder.pt2")
    export_encoder(ckpt, bucket_s=1.0, output=path, device="cpu")
    return path


def test_export_holds_the_flash_op_and_equals_eager(ckpt, exported):
    engine = load_engine(ckpt, device="cpu")
    cfg = engine.model.cfg.encoder
    program = load_encoder(exported)
    assert flash_nodes(program) == cfg.encoder_layers
    names = {str(n.target) for n in program.graph.nodes}
    assert not any("scaled_dot_product" in n for n in names)
    frames = bucket_mel_frames(cfg, 1.0)
    rng = np.random.default_rng(0)
    mel = rng.standard_normal((1, cfg.num_mel_bins, frames)).astype(
        np.float32)
    lens = np.array([frames - 23], np.int32)
    got, got_lens = program.module()(torch.from_numpy(mel),
                                     torch.from_numpy(lens))
    want, want_lens = encoder_forward(engine.model.params["encoder"], cfg,
                                      torch.from_numpy(mel),
                                      torch.from_numpy(lens))
    assert torch.equal(got, want) and torch.equal(got_lens, want_lens)
    # against JAX's encoder_forward on the checkpoint's weights
    from tests.fixtures import load_tiny_model
    jmodel = load_tiny_model(ckpt)
    jout, jlens = jax_encoder(jmodel.params["encoder"], jmodel.cfg.encoder,
                              jnp.asarray(mel), jnp.asarray(lens))
    n = int(got_lens[0])
    np.testing.assert_allclose(got[0, :n].numpy(), np.asarray(jout)[0, :n],
                               rtol=1e-5, atol=1e-5)
    assert int(jlens[0]) == n


def test_export_at_batch_two_in_memory(ckpt):
    engine = load_engine(ckpt, device="cpu")
    cfg = engine.model.cfg.encoder
    frames = bucket_mel_frames(cfg, 2.0)
    program = export_program(engine.model.params["encoder"], cfg, 2, frames,
                             torch.float32, "cpu")
    mel = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, cfg.num_mel_bins, frames)).astype(np.float32))
    lens = torch.tensor([frames, frames // 2], dtype=torch.int32)
    got = program.module()(mel, lens)[0]
    want = encoder_forward(engine.model.params["encoder"], cfg, mel, lens)[0]
    assert torch.equal(got, want)
    # the weights are the program's inputs, not constants
    assert len(program.graph_signature.buffers) > 0


def test_export_refuses_quantized_weights(ckpt, monkeypatch):
    monkeypatch.setenv("QUANTIZE", "int8")
    engine = load_engine(ckpt, device="cpu")
    with pytest.raises(ValueError, match="unquantized"):
        export_program(engine.model.params["encoder"],
                       engine.model.cfg.encoder, 1, 100, torch.float32, "cpu")


def test_flash_op_runs_the_plain_version_on_the_cpu():
    from qwen3_asr_tpu_torch.ops.flash_attention import (
        flash_attention_plain, registered_op)
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((2, 4, 9, 16), (2, 2, 11, 16), (2, 2, 11, 16)))
    vf = torch.tensor([0, 3], dtype=torch.int32)
    vt = torch.tensor([11, 9], dtype=torch.int32)
    qo = torch.tensor([2, 0], dtype=torch.int32)
    got = registered_op()(q, k, v, vf, vt, qo, True, 0, 0.25)
    want = flash_attention_plain(q, k, v, vf, vt, qo, causal=True,
                                 window_block=0, sm_scale=0.25)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
