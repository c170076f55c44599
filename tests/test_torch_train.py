"""The port's training path against the JAX package, in f32 on the CPU:
``runtime/train.py`` (``asr_loss``, every gradient leaf, three optimizer
steps, the microbatch accumulation), ``runtime/optim.py`` against optax,
``tools/finetune.py``'s ``make_batch`` and CLI, ``tools/overfit.py``'s
``build_config``, ``save_asr_checkpoint`` both ways, ``utils/metrics.py``,
and the wrappers without a backward refusing autograd.

The model is ``tests/fixtures.py``'s tiny checkpoint (the setup of
``tests/test_train.py``, with a left-padded row). Tolerances: the loss to
1e-5 relative; a gradient leaf to 2e-5 of its largest magnitude (floored
at 1e-4: the encoder's key bias has a gradient of 0 in exact arithmetic,
since softmax ignores a per-row constant, and both sides give noise
there); params after three Adam steps to 1e-6 absolute (the step is
O(lr) = 1e-3 and g / sqrt(v) amplifies the gradients' 1e-6 relative
difference only where g is near its noise); the optimizer alone, on the
same gradients, to 1e-7."""
import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from tests.fixtures import load_tiny_model, write_tiny_checkpoint
from tests.util_audio import speech_like
from qwen3_asr_tpu.runtime import train as jtrain
from qwen3_asr_tpu_torch.runtime import optim
from qwen3_asr_tpu_torch.runtime import train as ptrain
from qwen3_asr_tpu_torch.runtime.checkpoint import (load_asr_checkpoint,
                                                    params_from_jax)

LOSS_RTOL = 1e-5
GRAD_TOL = 2e-5


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny")
    write_tiny_checkpoint(path)
    model = load_tiny_model(path)
    rng = np.random.default_rng(0)
    b, mel_frames = 2, 100
    batch = {
        "mel": rng.standard_normal((b, 32, mel_frames)).astype(np.float32),
        "feature_lens": np.full((b,), mel_frames, np.int32),
        "prompt_ids": np.ones((b, 4), np.int32),
        "target_ids": rng.integers(1, 400, (b, 6)).astype(np.int32),
        "target_mask": np.ones((b, 6), np.int32),
        "valid_from": np.array([0, 2], np.int32),
    }
    cfg, _ = load_asr_checkpoint(path, "cpu")
    return path, model, cfg, batch


def _port_params(model):
    return params_from_jax(jax.device_get(model.params), "cpu")


def _leaf_pairs(jax_tree, port_tree):
    flat = jax.tree_util.tree_flatten_with_path(jax_tree)[0]
    for path, leaf in flat:
        keys = [p.key for p in path]
        x = port_tree
        for k in keys:
            x = x[k]
        yield "/".join(keys), np.asarray(leaf), x.detach().numpy()


def _grad_close(name, got, want):
    scale = max(float(np.abs(want).max()), 1e-4)
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * scale,
                               err_msg=name)


def _jax_batch(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def test_loss_and_every_gradient_match_jax(setup):
    _, model, cfg, batch = setup
    jb = _jax_batch(batch)
    keys = ("mel", "feature_lens", "prompt_ids", "target_ids",
            "target_mask", "valid_from")
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, *a: jtrain.asr_loss(p, model.cfg, *a)))(
            model.params, *(jb[k] for k in keys))
    tb = ptrain.batch_to(batch, "cpu")
    params = _port_params(model)
    loss_p, grads_p = ptrain._value_and_grad(
        ptrain.asr_loss, params, cfg, *(tb[k] for k in keys))
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=LOSS_RTOL)
    assert float(loss_p) > 0
    zero = []
    for name, want, got in _leaf_pairs(grads_j, grads_p):
        _grad_close(name, got, want)
        if not np.any(got):
            zero.append(name)
    # the gradients reach both towers: every leaf but the encoder's key
    # bias (0 in exact arithmetic) is non-zero
    assert zero in ([], ["encoder/layers/bk"]), zero


def _optax_chain(lr_schedule):
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.adamw(lr_schedule))


def _port_chain(lr_schedule):
    return optim.chain(optim.clip_by_global_norm(1.0),
                       optim.adamw(lr_schedule))


def test_three_adamw_steps_match_optax(setup):
    """make_train_step under clip + adamw on a warmup-cosine schedule (the
    overfit tool's optimizer), three steps, against the JAX step with
    optax."""
    _, model, cfg, batch = setup
    sched = dict(init_value=1e-4, peak_value=1e-3, warmup_steps=2,
                 decay_steps=10, end_value=1e-5)
    jopt = _optax_chain(optax.warmup_cosine_decay_schedule(**sched))
    jstate = jtrain.init_train_state(model.params, jopt)
    jstep = jax.jit(jtrain.make_train_step(model.cfg, jopt))
    popt = _port_chain(optim.warmup_cosine_decay_schedule(**sched))
    pstate = ptrain.init_train_state(_port_params(model), popt)
    pstep = ptrain.make_train_step(cfg, popt)
    jb = _jax_batch(batch)
    for _ in range(3):
        jstate, jl = jstep(jstate, jb)
        pstate, pl = pstep(pstate, batch)
        np.testing.assert_allclose(float(pl), float(jl), rtol=LOSS_RTOL)
    assert pstate.step == 3
    for name, want, got in _leaf_pairs(jstate.params, pstate.params):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("clip", [1.0, 1e3], ids=["clipped", "unclipped"])
def test_optimizer_matches_optax_on_same_gradients(clip):
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": {"c": (11,), "d": (2, 3, 4)}}

    def tree(fn):
        def walk(s):
            return {k: walk(v) for k, v in s.items()} if isinstance(s, dict) \
                else fn(s)
        return walk(shapes)

    params = tree(lambda s: rng.standard_normal(s).astype(np.float32))
    grads = [tree(lambda s: rng.standard_normal(s).astype(np.float32))
             for _ in range(3)]
    sched = dict(init_value=0.0, peak_value=2e-3, warmup_steps=2,
                 decay_steps=6, end_value=1e-5)
    jopt = optax.chain(optax.clip_by_global_norm(clip), optax.adamw(
        optax.warmup_cosine_decay_schedule(**sched)))
    popt = optim.chain(optim.clip_by_global_norm(clip), optim.adamw(
        optim.warmup_cosine_decay_schedule(**sched)))
    jp = jax.tree.map(jnp.asarray, params)
    pp = optim.tree_map(torch.from_numpy, params)
    js, ps = jopt.init(jp), popt.init(pp)

    @jax.jit
    def jax_step(g, state, p):
        u, state = jopt.update(g, state, p)
        return optax.apply_updates(p, u), state

    for g in grads:
        jp, js = jax_step(jax.tree.map(jnp.asarray, g), js, jp)
        pu, ps = popt.update(optim.tree_map(torch.from_numpy, g), ps, pp)
        pp = optim.apply_updates(pp, pu)
    for name, want, got in _leaf_pairs(jp, pp):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                   err_msg=name)


def test_schedule_matches_optax():
    kw = dict(init_value=0.0, peak_value=2e-3, warmup_steps=30,
              decay_steps=400, end_value=1e-5)
    want = optax.warmup_cosine_decay_schedule(**kw)
    got = optim.warmup_cosine_decay_schedule(**kw)
    for count in (0, 1, 15, 29, 30, 31, 200, 399, 400, 500):
        np.testing.assert_allclose(got(count), float(want(count)),
                                   rtol=1e-6, atol=1e-12, err_msg=count)


def _sgd(lr):
    """Plain SGD, optax.sgd's update: linear in the gradient."""
    return optim.GradientTransformation(
        lambda params: {},
        lambda g, state, params: (optim.tree_map(lambda x: -lr * x, g),
                                  state))


def _sgd_step(cfg, params, batch, micro):
    opt = _sgd(1e-2)
    step = ptrain.make_train_step(cfg, opt, microbatch=micro)
    return step(ptrain.init_train_state(params, opt), batch)


@pytest.mark.parametrize("micro", [1, 2, 3],
                         ids=["two_chunks", "one_chunk", "pad_row"])
def test_microbatch_step_matches_full_batch(setup, micro):
    """Chunked accumulation gives the full-batch update (SGD: the update is
    linear in the gradient); micro=3 pads one zero-mask row, which must be
    inert."""
    _, model, cfg, batch = setup
    params = _port_params(model)
    sf, lf = _sgd_step(cfg, params, batch, 0)
    sa, la = _sgd_step(cfg, params, batch, micro)
    np.testing.assert_allclose(float(la), float(lf), rtol=LOSS_RTOL)
    for pf, pa in zip(optim.tree_leaves(sf.params),
                      optim.tree_leaves(sa.params)):
        np.testing.assert_allclose(pa.numpy(), pf.numpy(), rtol=2e-4,
                                   atol=2e-6)


# ---------------------------------------------------------------------------
# tools: make_batch, the finetune CLI, build_config


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    from qwen3_asr_tpu_torch.audio.codec import encode_wav
    d = tmp_path_factory.mktemp("wavs")
    out = []
    for i, secs in enumerate((1.0, 0.6)):
        p = d / f"clip{i}.wav"
        p.write_bytes(encode_wav(speech_like(secs, seed=i), 16000))
        out.append(str(p))
    return out


def test_make_batch_matches_jax(setup, wavs):
    from qwen3_asr_tpu.runtime.engine import \
        TranscriptionEngine as JaxEngine
    from qwen3_asr_tpu.tools.finetune import make_batch as jax_make_batch
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    from qwen3_asr_tpu_torch.tools.finetune import make_batch
    path, model, _, _ = setup
    items = [{"wav": wavs[0], "text": "hello world"},
             {"wav": wavs[1], "text": "a longer transcript here",
              "language": "en"}]
    want = jax_make_batch(JaxEngine(model), items, bucket_s=1.0)
    got = make_batch(load_engine(path, device="cpu"), items, bucket_s=1.0)
    assert sorted(got) == sorted(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        if k == "mel":
            np.testing.assert_allclose(got[k], w, rtol=0, atol=1e-5)
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_finetune_cli_steps_and_serves(setup, wavs, tmp_path):
    """Two steps of the CLI on the CPU; the output loads through
    load_engine and transcribes."""
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    from qwen3_asr_tpu_torch.tools.finetune import main
    path = setup[0]
    manifest = tmp_path / "m.jsonl"
    manifest.write_text("\n".join(json.dumps({"wav": w, "text": t})
                                  for w, t in zip(wavs, ("hi", "there"))))
    out = str(tmp_path / "out")
    main(["--model-id", path, "--manifest", str(manifest), "--steps", "2",
          "--batch-size", "2", "--bucket-s", "1", "--output", out,
          "--device", "cpu", "--lr", "1e-3"])
    assert os.path.exists(os.path.join(out, "tokenizer.json"))
    engine = load_engine(out, device="cpu")
    _, before = load_asr_checkpoint(path, "cpu")
    assert not torch.equal(engine.model.params["decoder"]["embed"],
                           before["decoder"]["embed"])
    audio = speech_like(1.0, seed=0)
    assert isinstance(engine.transcribe(audio, 16000)[0].text, str)


@pytest.mark.parametrize("argv,match", [
    (["--dp", "2"], "torchrun"),
], ids=["dp"])
def test_finetune_refuses(argv, match, capsys):
    """``--dp`` above 1 with no process group (not under torchrun) is
    refused, naming torchrun."""
    from qwen3_asr_tpu_torch.tools.finetune import main
    with pytest.raises(SystemExit):
        main(["--model-id", "x", "--manifest", "m.jsonl"] + argv)
    assert match in capsys.readouterr().err


def test_overfit_requires_tokenizer(tmp_path):
    """``--tokenizer`` is no longer required: without it the tool trains
    the JAX tool's tokenizer with the port's BPE trainer (one clip, 16
    steps of the draft size here)."""
    import shutil
    from qwen3_asr_tpu.tools.overfit import build_tokenizer as jax_build
    from qwen3_asr_tpu_torch.tools.overfit import main
    data = tmp_path / "data"
    data.mkdir()
    real = os.path.join(os.path.dirname(__file__), "..", "e2e", "data",
                        "real")
    for ext in (".wav", ".txt"):
        shutil.copy(os.path.join(real, "english_01" + ext), data)
    out = tmp_path / "o"
    main(["--data-dir", str(data), "--output", str(out), "--size", "draft",
          "--max-steps", "16", "--eval-every", "1000", "--device", "cpu"])
    jax_build([(data / "english_01.txt").read_text().strip()],
              str(tmp_path / "jax.json"))
    assert ((out / "tokenizer.json").read_text(encoding="utf-8")
            == (tmp_path / "jax.json").read_text(encoding="utf-8"))
    with open(out / "config.json") as f:
        assert json.load(f)["text_config"]["vocab_size"] == 2048
    assert (out / "overfit_manifest.json").exists()


@pytest.mark.parametrize("size", ["draft", "base", "medium", "large"])
def test_build_config_matches_jax(size):
    from qwen3_asr_tpu.tools.overfit import build_config as jax_build
    from qwen3_asr_tpu_torch.tools.overfit import build_config
    specials = {"<|AUDIO|>": 2043, "<|endoftext|>": 2040,
                "<|im_end|>": 2042}
    got = dataclasses.asdict(build_config(2048, specials, size))
    want = dataclasses.asdict(jax_build(2048, specials, size))
    assert got == want


def test_collect_clips_matches_jax():
    from qwen3_asr_tpu.tools.overfit import collect_clips as jax_collect
    from qwen3_asr_tpu_torch.tools.overfit import collect_clips
    data = os.path.join(os.path.dirname(__file__), "..", "e2e", "data",
                        "real")
    assert collect_clips(data) == jax_collect(data) and collect_clips(data)


# ---------------------------------------------------------------------------
# save_asr_checkpoint, both ways


def test_saved_checkpoint_reads_back_in_both_packages(setup, tmp_path):
    from qwen3_asr_tpu.runtime.checkpoint import \
        load_safetensors_dir as jax_read
    from qwen3_asr_tpu.runtime.checkpoint import \
        save_asr_checkpoint as jax_save
    from qwen3_asr_tpu_torch.runtime.checkpoint import (config_to_dict,
                                                        load_safetensors_dir,
                                                        save_asr_checkpoint)
    path, model, cfg, _ = setup
    params = _port_params(model)
    mine, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    save_asr_checkpoint(mine, cfg, params)
    jax_save(theirs, model.cfg, model.params)
    a, b = jax_read(mine), load_safetensors_dir(theirs)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == np.float32, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    with open(os.path.join(mine, "config.json")) as f1, \
            open(os.path.join(theirs, "config.json")) as f2:
        assert json.load(f1) == json.load(f2) == json.loads(
            json.dumps(config_to_dict(cfg)))
    cfg2, back = load_asr_checkpoint(mine, "cpu")
    assert cfg2 == cfg
    same = optim.tree_map(torch.equal, back, params)
    assert all(optim.tree_leaves(same)), same


def test_save_refuses_quantized(setup, tmp_path):
    from qwen3_asr_tpu_torch.ops.quant import quantize_params
    from qwen3_asr_tpu_torch.runtime.checkpoint import save_asr_checkpoint
    _, model, cfg, _ = setup
    q = quantize_params(_port_params(model), "int8")
    with pytest.raises(ValueError, match="quantized"):
        save_asr_checkpoint(str(tmp_path / "q"), cfg, q)


# ---------------------------------------------------------------------------
# metrics


@pytest.mark.parametrize("ref,hyp", [
    ("Hello, World!", "hello world"),
    ("the quick brown fox", "the quick brown box jumps"),
    ("", ""), ("", "extra"), ("ＡＢＣ 東京タワー", "abc 東京 タワ"),
    ("one two three", ""),
])
def test_metrics_match_jax(ref, hyp):
    from qwen3_asr_tpu.utils import metrics as jm
    from qwen3_asr_tpu_torch.utils import metrics as pm
    assert pm.wer(ref, hyp) == jm.wer(ref, hyp)
    assert pm.cer(ref, hyp) == jm.cer(ref, hyp)


# ---------------------------------------------------------------------------
# wrappers without a backward


def _no_backward_calls():
    from qwen3_asr_tpu_torch.models.decoder import init_kv_cache
    from qwen3_asr_tpu_torch.models.config import DecoderConfig
    from qwen3_asr_tpu_torch.ops.decode_attention import decode_attention
    from qwen3_asr_tpu_torch.ops.decode_attention_batch import \
        decode_attention_batched
    from qwen3_asr_tpu_torch.ops.qgemm import qgemm, qgemm_group
    from qwen3_asr_tpu_torch.ops.qgemv import qgemv, qgemv_group
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import qk_rope_kv_write
    from qwen3_asr_tpu_torch.ops.slab_reader import slab_read

    def x(*shape):
        return torch.randn(*shape, requires_grad=True)

    q8 = torch.randint(-127, 127, (6, 16), dtype=torch.int8)
    s = torch.rand(6)
    cfg = DecoderConfig(num_hidden_layers=1, num_attention_heads=4,
                        num_key_value_heads=2, head_dim=8)
    cache = init_kv_cache(cfg, 1, 4, torch.float32, "cpu")
    cos, sin = torch.ones(1, 2, 8), torch.zeros(1, 2, 8)
    big = torch.randn(1, 1, 2, 128, 128)
    return {
        "qgemv": lambda: qgemv(x(2, 16), q8, s, out_dtype=torch.float32),
        "qgemv_group": lambda: qgemv_group(x(2, 16), [(q8, s)],
                                           out_dtype=torch.float32),
        "qgemm": lambda: qgemm(x(20, 16), q8, s, out_dtype=torch.float32),
        "qgemm_group": lambda: qgemm_group(x(20, 16), [(q8, s)],
                                           out_dtype=torch.float32),
        "decode_attention": lambda: decode_attention(
            x(1, 4, 1, 8), torch.randn(1, 2, 4, 8), torch.randn(1, 2, 4, 8)),
        "decode_attention_batched": lambda: decode_attention_batched(
            x(1, 2, 1, 128), big[0], big[0]),
        "slab_read": lambda: slab_read(big.clone().requires_grad_(), big),
        "qk_rope_kv_write": lambda: qk_rope_kv_write(
            x(1, 2, 32), x(1, 2, 16), x(1, 2, 16), torch.ones(8),
            torch.ones(8), cos, sin, 1e-6, cache, 0, 0),
    }


@pytest.mark.parametrize("name", ["qgemv", "qgemv_group", "qgemm",
                                  "qgemm_group", "decode_attention",
                                  "decode_attention_batched", "slab_read",
                                  "qk_rope_kv_write"])
def test_no_backward_wrappers_raise_under_grad(name):
    call = _no_backward_calls()[name]
    with pytest.raises(RuntimeError, match="has no backward"):
        call()
    with torch.no_grad():
        call()      # the same call outside autograd runs
