"""Parallelism on torch.distributed, on the CPU: 4 gloo ranks (one spawn,
``tests/torch_dist.py`` ``all_ranks``) against the JAX package on its
virtual CPU devices.

- Context parallelism: the port's ``context_parallel_attention`` over the
  4 ranks, and ``combine_stacked`` with the 4 shards folded onto one
  device, against JAX's on a 4-device ``sp`` mesh (flash in interpret
  mode), in JAX's four cases at its tolerance; a backward raises, as
  JAX's does.
- The dp2×tp2 mesh: ``make_mesh``'s shapes, the specs equal to JAX's, the
  whole-heads refusal; a dp2×tp2 engine's tokens identical to the
  unsharded port's and to JAX's engine in f32, on ``write_tiny_checkpoint``
  and on trained_ckpt; a dp2×tp2 train step equal to the unsharded one.
- The pipeline: JAX's ``tests/test_pipeline_parallel.py`` cases.
- ``finetune --dp 2`` over 2 ranks equal to ``--dp 1``.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.sharding import Mesh

from qwen3_asr_tpu.ops.context_parallel import (
    context_parallel_attention as jax_cp)
from qwen3_asr_tpu.ops.flash_attention import flash_attention as jax_flash
from qwen3_asr_tpu_torch.ops.context_parallel import (
    combine_stacked, context_parallel_folded, shard_attend)
from qwen3_asr_tpu_torch.ops.flash_attention import flash_attention
from tests.torch_dist import (CKPT, ROOT, all_ranks, finetune_ranks,
                              run_ranks, start_ranks)

TOL = dict(atol=2e-5, rtol=2e-5)


def _case(seed, b, nq, nkv, t, s, d, **kw):
    rng = np.random.default_rng(seed)
    return {"q": rng.standard_normal((b, nq, t, d)).astype(np.float32),
            "k": rng.standard_normal((b, nkv, s, d)).astype(np.float32),
            "v": rng.standard_normal((b, nkv, s, d)).astype(np.float32),
            "kw": kw}


# JAX's tests/test_context_parallel.py cases, at their shapes
CASES = {
    "full": _case(0, 2, 8, 4, 16, 256, 64),
    "causal_offset": _case(3, 2, 4, 2, 8, 256, 64, causal=True, q_offset=100),
    "padded_rows": _case(6, 4, 4, 4, 8, 256, 64,
                         kv_valid_from=np.asarray([0, 63, 130, 200], np.int32),
                         kv_valid_to=np.asarray([256, 140, 131, 256],
                                                np.int32)),
    "vs_flash": _case(9, 2, 8, 4, 16, 512, 64, causal=True, q_offset=200),
}


def _jax_kw(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _torch_kw(kw):
    return {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@pytest.fixture(scope="module")
def jax_refs():
    devs = jax.devices()
    if len(devs) < 4:
        pytest.skip("needs 4 virtual CPU devices")
    mesh = Mesh(np.asarray(devs[:4]), axis_names=("sp",))
    return {name: np.asarray(jax_cp(
        jnp.asarray(c["q"]), jnp.asarray(c["k"]), jnp.asarray(c["v"]), mesh,
        interpret=True, **_jax_kw(c["kw"]))) for name, c in CASES.items()}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory, payload):
    return start_ranks(all_ranks, 4, tmp_path_factory.mktemp("ranks"),
                       payload, timeout=300)


@pytest.fixture(scope="module")
def ranks(spawned, jax_refs, pipeline_refs, jax_ids):
    """The 4 ranks' results, joined once the JAX references (computed
    while the ranks run) are ready."""
    return spawned.join()


@pytest.mark.parametrize("name", list(CASES))
def test_cp_over_four_ranks_matches_jax(ranks, jax_refs, name):
    i = list(CASES).index(name)
    for r in ranks:
        np.testing.assert_allclose(r["cp"][0][i], jax_refs[name], **TOL)


@pytest.mark.parametrize("name", list(CASES))
def test_combine_stacked_matches_jax(jax_refs, name):
    c = CASES[name]
    got = context_parallel_folded(torch.from_numpy(c["q"]),
                                  torch.from_numpy(c["k"]),
                                  torch.from_numpy(c["v"]), 4,
                                  **_torch_kw(c["kw"]))
    np.testing.assert_allclose(got.numpy(), jax_refs[name], **TOL)


def test_cp_matches_one_flash_call_and_jax_flash():
    """JAX's ``test_cp_matches_flash_single_device``: the folded shards
    equal one flash call over the whole K/V, the port's and JAX's."""
    c = CASES["vs_flash"]
    q, k, v = (torch.from_numpy(c[n]) for n in "qkv")
    got = context_parallel_folded(q, k, v, 4, **c["kw"]).numpy()
    np.testing.assert_allclose(got, flash_attention(q, k, v, **c["kw"]
                                                    ).numpy(), **TOL)
    want = jax_flash(*(jnp.asarray(c[n]) for n in "qkv"), interpret=True,
                     **c["kw"])
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_backward_raises_as_jax_does(ranks):
    """JAX's CP is not differentiable (pmax has no derivative): a
    backward through the port's raises NotImplementedError naming it, over
    the group and folded."""
    for r in ranks:
        assert "pmax" in r["cp"][1]
    c = CASES["full"]
    q, k, v = (torch.from_numpy(c[n]).requires_grad_() for n in "qkv")
    out = context_parallel_folded(q, k, v, 4)
    with pytest.raises(NotImplementedError, match="pmax"):
        out.sum().backward()


def test_two_half_calls_reconstruct_the_softmax():
    """JAX's ``test_flash_residuals_reconstruct_softmax`` through
    ``shard_attend`` and ``combine_stacked``: two half-sequence shards
    merge to the full call."""
    c = CASES["causal_offset"]
    q, k, v = (torch.from_numpy(c[n]) for n in "qkv")
    half = k.shape[2] // 2
    parts = [shard_attend(q, k[:, :, i * half:(i + 1) * half].contiguous(),
                          v[:, :, i * half:(i + 1) * half].contiguous(),
                          i * half, 2 * half, **c["kw"]) for i in range(2)]
    got = combine_stacked(*(torch.stack(x) for x in zip(*parts)))
    np.testing.assert_allclose(got.numpy(), flash_attention(
        q, k, v, **c["kw"]).numpy(), **TOL)


def test_window_and_uneven_shards_are_refused():
    c = CASES["full"]
    q, k, v = (torch.from_numpy(c[n]) for n in "qkv")
    with pytest.raises(ValueError, match="window_block"):
        context_parallel_folded(q, k, v, 4, window_block=50)
    with pytest.raises(ValueError, match="not divisible"):
        context_parallel_folded(q, k, v, 3)


# ---------------------------------------------------------------------------
# the payload of the 4-rank spawn, and its JAX references


def _real_clip(name):
    from qwen3_asr_tpu_torch.audio.codec import decode_audio
    with open(os.path.join(ROOT, "real", name), "rb") as f:
        audio, sr = decode_audio(f.read())
    assert sr == 16000
    return audio


CLIPS = ("english_02.wav", "cantonese_01.wav")   # one bucket: a dp batch


def _jax_engine(path):
    from qwen3_asr_tpu.models.asr import AsrModel, PromptTemplate
    from qwen3_asr_tpu.runtime.checkpoint import load_asr_checkpoint
    from qwen3_asr_tpu.runtime.engine import TranscriptionEngine
    from qwen3_asr_tpu.text.tokenizer import BpeTokenizer
    cfg, params = load_asr_checkpoint(path, dtype=jnp.float32, cache=False)
    model = AsrModel(cfg, params,
                     BpeTokenizer.from_file(os.path.join(path,
                                                         "tokenizer.json")),
                     PromptTemplate.from_checkpoint(path))
    return TranscriptionEngine(model, dtype=jnp.float32)


def _pp_cfg():
    from qwen3_asr_tpu.models.config import preset
    cfg = preset("tiny")
    cfg.decoder.num_hidden_layers = 4   # divisible by pp=4 and pp=2
    return cfg


def _pp_batch(cfg, b, seed, targets):
    chunk = cfg.encoder.n_window * 2
    return {
        "mel": np.random.default_rng(seed).standard_normal(
            (b, cfg.encoder.num_mel_bins, chunk)).astype(np.float32),
        "feature_lens": np.full((b,), chunk, np.int32),
        "prompt_ids": np.ones((b, 4), np.int32),
        "target_ids": np.asarray([targets] * b, np.int32),
        "target_mask": np.ones((b, 6), np.int32),
    }


@pytest.fixture(scope="module")
def pipeline_inputs():
    """JAX's ``test_pipeline_parallel.py`` inputs: its tiny config with 4
    decoder layers, its weights (JAX's init), embeddings and batches."""
    from qwen3_asr_tpu.models.decoder import init_decoder_params
    from qwen3_asr_tpu.models.encoder import init_encoder_params
    cfg = _pp_cfg()

    def both(key):
        return {"encoder": init_encoder_params(cfg.encoder, key),
                "decoder": init_decoder_params(cfg.decoder, key)}

    b, t = 8, 12
    return {"config": {"audio_config": dataclasses.asdict(cfg.encoder),
                       "text_config": dataclasses.asdict(cfg.decoder)},
            "decoder": jax.device_get(init_decoder_params(
                cfg.decoder, jax.random.PRNGKey(0))),
            "embeds": (np.random.default_rng(1).standard_normal(
                (b, t, cfg.decoder.hidden_size)) * 0.3).astype(np.float32),
            "vf": np.asarray([0, 2, 5, 0, 1, 0, 3, 0], np.int32),
            "params": jax.device_get(both(jax.random.PRNGKey(2))),
            "batch": _pp_batch(cfg, 8, 0, [1] * 6),
            "params2": jax.device_get(both(jax.random.PRNGKey(5))),
            "batch2": _pp_batch(cfg, 4, 1, [5, 6, 7, 2, 0, 0])}


@pytest.fixture(scope="module")
def pipeline_refs(pipeline_inputs):
    """JAX's single-device references: the decoder stack's hidden states,
    one adamw step's loss and wq."""
    import optax
    from qwen3_asr_tpu.models.decoder import decoder_forward, init_kv_cache
    from qwen3_asr_tpu.ops.attention import AttnSpec
    from qwen3_asr_tpu.runtime.train import init_train_state, make_train_step
    cfg, p = _pp_cfg(), pipeline_inputs
    embeds, vf = p["embeds"], p["vf"]
    b, t = embeds.shape[:2]
    dec = jax.tree.map(jnp.asarray, p["decoder"])
    ref_hidden, _ = decoder_forward(
        dec, cfg.decoder, jnp.asarray(embeds),
        jnp.broadcast_to(jnp.arange(t), (b, t)),
        init_kv_cache(cfg.decoder, b, 128, dtype=jnp.float32), jnp.int32(0),
        AttnSpec(causal=True, q_offset=0, valid_from=jnp.asarray(vf)))
    optimizer = optax.adamw(1e-3)
    state = init_train_state(jax.tree.map(jnp.asarray, p["params"]),
                             optimizer)
    state, loss = jax.jit(make_train_step(cfg, optimizer))(
        state, {k: jnp.asarray(v) for k, v in p["batch"].items()})
    return {"hidden": np.asarray(ref_hidden), "vf": vf, "loss": float(loss),
            "wq": np.asarray(state.params["decoder"]["layers"]["wq"])}


@pytest.fixture(scope="module")
def tiny_ckpt(tmp_path_factory):
    from tests.fixtures import write_tiny_checkpoint
    return write_tiny_checkpoint(str(tmp_path_factory.mktemp("tiny") / "c"))


@pytest.fixture(scope="module")
def payload(tiny_ckpt, pipeline_inputs):
    clips = [_real_clip(c) for c in CLIPS]
    train_batch = {
        "mel": np.random.default_rng(4).standard_normal(
            (4, 32, 100)).astype(np.float32),
        "feature_lens": np.full((4,), 100, np.int32),
        "prompt_ids": np.ones((4, 4), np.int32),
        "target_ids": np.asarray([[5, 6, 7, 2, 0, 0]] * 4, np.int32),
        "target_mask": np.asarray([[1] * 6, [1] * 4 + [0] * 2] * 2,
                                  np.int32),
    }
    return {"cp": list(CASES.values()), "ckpts": [CKPT, tiny_ckpt],
            "clips": clips, "train_batch": train_batch,
            "pipeline": pipeline_inputs}


# ---------------------------------------------------------------------------
# the dp x tp mesh


def test_make_mesh_shapes():
    """JAX's ``test_make_mesh_shapes`` rule over 8 ranks, and the port's
    refusal of a shape that does not cover them."""
    from qwen3_asr_tpu_torch.parallel.mesh import mesh_shape
    assert mesh_shape(8) == (1, 8)
    assert mesh_shape(8, dp=2) == (2, 4)
    assert mesh_shape(8, tp=8) == (1, 8)
    assert mesh_shape(12) == (3, 4)         # tp 8 halved until it divides
    assert mesh_shape(1) == (1, 1)
    with pytest.raises(ValueError):
        mesh_shape(8, dp=3, tp=2)


def _spec_tuple(tree):
    from jax.sharding import PartitionSpec
    if isinstance(tree, dict):
        return {k: _spec_tuple(v) for k, v in tree.items()}
    assert isinstance(tree, PartitionSpec)
    return tuple(tree)


def test_param_specs_equal_jax():
    from qwen3_asr_tpu.parallel import mesh as jax_mesh
    from qwen3_asr_tpu.parallel import pipeline as jax_pipe
    from qwen3_asr_tpu_torch.parallel import mesh, pipeline
    assert mesh.decoder_param_specs() == _spec_tuple(
        jax_mesh.decoder_param_specs())
    assert mesh.encoder_param_specs() == _spec_tuple(
        jax_mesh.encoder_param_specs())
    assert pipeline.decoder_param_specs_pp() == _spec_tuple(
        jax_pipe.decoder_param_specs_pp())


def test_whole_heads_refusal():
    """JAX drops a spec that does not divide; the port refuses a tp that
    would split a head or a slice."""
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.parallel.mesh import check_layout
    cfg = preset("1.7b")
    check_layout(cfg, 4)
    with pytest.raises(ValueError, match="encoder heads 20"):
        check_layout(cfg, 8)           # 16/8 query and KV heads, 20 encoder
    with pytest.raises(ValueError, match="decoder KV heads 8"):
        check_layout(cfg, 16)


class _Rank:
    def __init__(self, r, n):
        self.tp_rank, self.tp = r, n


@pytest.mark.parametrize("mode", ["int8", "fp8", "int4"])
def test_shard_params_quantized_leaves(mode, monkeypatch):
    """Each tp rank's quantized slices (the port's payload layout) widen
    to that rank's slice of the widened weight: by output features, by
    input features (int4 unpacked and packed again), by vocab rows."""
    from qwen3_asr_tpu_torch.ops.quant import dequantize, quantize_params
    from qwen3_asr_tpu_torch.parallel.mesh import shard_params
    from qwen3_asr_tpu_torch.models.config import preset
    from qwen3_asr_tpu_torch.models.decoder import init_decoder_params
    monkeypatch.setenv("ASR_INT4_GROUP", "16")
    cfg = preset("tiny").decoder
    gen = torch.Generator().manual_seed(0)
    q = quantize_params({"decoder": init_decoder_params(cfg, gen, "cpu")},
                        mode)["decoder"]
    full = {k: dequantize(q["layers"][k], torch.float32)
            for k in ("wq", "wo")}
    emb = dequantize(q["embed"], torch.float32)
    for r in range(2):
        s = shard_params({"decoder": q}, _Rank(r, 2))["decoder"]
        wq, wo = (dequantize(s["layers"][k], torch.float32)
                  for k in ("wq", "wo"))
        n, k = full["wq"].shape[-2] // 2, full["wo"].shape[-1] // 2
        assert torch.equal(wq, full["wq"][:, r * n:(r + 1) * n])
        assert torch.equal(wo, full["wo"][..., r * k:(r + 1) * k])
        v = emb.shape[0] // 2
        assert torch.equal(dequantize(s["embed"], torch.float32),
                           emb[r * v:(r + 1) * v])


@pytest.fixture(scope="module")
def jax_ids(payload):
    """JAX's engine's token ids on each checkpoint, a clip at a time (its
    batch results carry no ids)."""
    out = {}
    for path in payload["ckpts"]:
        eng = _jax_engine(path)
        out[path] = [eng.transcribe(c, 16000, language="en")[0].token_ids
                     for c in payload["clips"]]
    return out


@pytest.mark.parametrize("which", ["trained_ckpt", "tiny"])
def test_dp2_tp2_engine_tokens_identical(ranks, payload, jax_ids, which):
    """A dp2×tp2 engine on every rank gives the unsharded port's token ids
    (a batch split over dp, one clip whole on every rank, a resume tick
    batch) and JAX's engine's, in f32; its layers called the
    collectives, on their local heads."""
    ckpt = payload["ckpts"][0 if which == "trained_ckpt" else 1]
    want = jax_ids[ckpt]
    for r in ranks:
        plain, sharded, calls, heads = r["engine"][ckpt]
        assert sharded == plain
        batch, solo, ticks = plain
        assert batch == want and solo == want[:1]
        assert ticks == [want[0]] * 2
        assert calls > 0 and heads == 2


def test_mesh_env_shards_int8_engine(ranks):
    """``ASR_MESH_DP``/``ASR_MESH_TP`` with ``QUANTIZE=int8`` through
    ``load_engine``: the int8 dp2×tp2 engine gives the int8 unsharded
    engine's tokens (JAX's ``test_mesh_sharded_serving_path``)."""
    for r in ranks:
        plain, sharded, shape = r["engine"]["int8"]
        assert shape == {"dp": 2, "tp": 2}
        assert sharded == plain


def test_server_refuses_a_group_of_ranks(ranks):
    """Serving across ranks is ROADMAP item 14b: a server under a group
    of 4 refuses to start."""
    for r in ranks:
        assert "14b" in r["server"] and "4" in r["server"]


def test_mesh_env_without_group_serves_unsharded(monkeypatch):
    from qwen3_asr_tpu_torch.runtime.lifecycle import mesh_from_env
    monkeypatch.setenv("ASR_MESH_DP", "2")
    assert mesh_from_env(torch.device("cpu")) is None


def test_dp2_tp2_train_step_matches_unsharded(ranks):
    """Two clipped adamw steps under dp2×tp2 (loss normalized over the
    whole batch, gradients summed over dp, the clip's norm over tp) equal
    the unsharded steps: losses to 1e-5, weights to 1e-4 absolute, JAX's
    pp test's bound (adam turns a near-zero gradient into an lr-sized step
    whatever its rounding; a wrong gradient moves a weight by ~lr = 1e-3)."""
    for r in ranks:
        plain, mesh, gap = r["train"]
        np.testing.assert_allclose(mesh, plain, rtol=1e-5)
        assert gap < 1e-4


# ---------------------------------------------------------------------------
# the pipeline (JAX's tests/test_pipeline_parallel.py)


@pytest.mark.parametrize("pp", [4, 2])
def test_pipeline_matches_sequential_decoder(ranks, pipeline_refs, pp):
    refs = pipeline_refs
    valid = (np.arange(12)[None, :] >= refs["vf"][:, None])[..., None]
    for r in ranks:
        got = r["pipeline"][f"hidden_pp{pp}"]
        np.testing.assert_allclose(got * valid, refs["hidden"] * valid,
                                   atol=2e-5, rtol=2e-5)


def test_pp_train_step_matches_single_device(ranks, pipeline_refs):
    refs = pipeline_refs
    for r in ranks:
        np.testing.assert_allclose(r["pipeline"]["step_loss"], refs["loss"],
                                   atol=1e-5, rtol=1e-5)
    wq = np.concatenate([r["pipeline"]["step_wq"] for r in ranks])
    np.testing.assert_allclose(wq, refs["wq"], atol=1e-4, rtol=1e-4)


def test_pp_second_step_decreases_loss(ranks):
    for r in ranks:
        losses = r["pipeline"]["losses"]
        assert losses[-1] < losses[0]
        assert losses == ranks[0]["pipeline"]["losses"]


def test_shard_params_pp_quantized_leaves(ranks):
    for r in ranks:
        (qs, ss) = r["pipeline"]["int8_shapes"]
        assert qs[0] == 1 and ss[0] == 1        # 4 layers over pp=4
        assert np.isfinite(r["pipeline"]["int8_hidden"]).all()


# ---------------------------------------------------------------------------
# finetune --dp


def test_finetune_dp2_matches_dp1(tmp_path):
    """``finetune --dp 2`` over 2 gloo ranks (each training one of the two
    rows) gives ``--dp 1``'s losses and saved weights."""
    from qwen3_asr_tpu_torch.runtime.checkpoint import load_asr_checkpoint
    from qwen3_asr_tpu_torch.runtime.optim import tree_leaves
    from qwen3_asr_tpu_torch.tools.finetune import main
    manifest = tmp_path / "m.jsonl"
    with open(manifest, "w") as f:
        for name in CLIPS:
            with open(os.path.join(ROOT, "real", name[:-4] + ".txt"),
                      encoding="utf-8") as t:
                f.write(json.dumps({"wav": os.path.join(ROOT, "real", name),
                                    "text": t.read().strip()}) + "\n")
    args = ["--model-id", CKPT, "--manifest", str(manifest), "--steps", "2",
            "--batch-size", "2", "--lr", "1e-3", "--device", "cpu"]
    one = main(args + ["--output", str(tmp_path / "dp1")])
    two = run_ranks(finetune_ranks, 2, tmp_path, args + [
        "--output", str(tmp_path / "dp2"), "--dp", "2"])
    assert two[0] == two[1]
    np.testing.assert_allclose(two[0], one, rtol=1e-5)
    _, p1 = load_asr_checkpoint(str(tmp_path / "dp1"), "cpu")
    _, p2 = load_asr_checkpoint(str(tmp_path / "dp2"), "cpu")
    # JAX's pp test's bound: f32 reduction-order noise through adamw's
    # rsqrt (a near-zero gradient becomes an lr-sized step whatever its
    # rounding); a wrong gradient moves a weight by ~lr = 1e-3
    for a, b in zip(tree_leaves(p2), tree_leaves(p1)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4,
                                   rtol=1e-4)
