"""The port's VAD trainer (``tools/train_vad.py``) against the JAX
package's: ``build_dataset``'s windows and labels bit for bit, the
featurization, 20 Adam steps from JAX's ``init_params(PRNGKey(0))`` on the
same batches against JAX/optax's in f32, the calibration offset and the
train-set error, and ``evaluate()``'s flap table for the same weights."""
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

import qwen3_asr_tpu.audio.native as jax_native
from qwen3_asr_tpu.audio import vad_model as jax_vad
from qwen3_asr_tpu.tools import train_vad as jax_tool
from qwen3_asr_tpu_torch.audio import vad_model
from qwen3_asr_tpu_torch.tools import train_vad

DATA = os.path.join(os.path.dirname(__file__), "..", "e2e", "data", "real")
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def datasets():
    """(the port's, JAX's) datasets. JAX's band-pass goes through its C++
    helper when that builds; the port's is ``audio/frontend.py``'s numpy
    convolution, JAX's own plain path, so JAX's dataset is built once each
    way."""
    ours = train_vad.build_dataset(DATA)
    theirs = jax_tool.build_dataset(DATA)
    real = jax_native.get_lib
    jax_native.get_lib = lambda: None
    try:
        plain = jax_tool.build_dataset(DATA)
    finally:
        jax_native.get_lib = real
    return ours, theirs, plain


def test_dataset_equals_jax(datasets):
    (w, y, names, clips), theirs, (pw, py, pnames, pclips) = datasets
    assert np.array_equal(w, pw) and w.dtype == pw.dtype == np.float32
    assert np.array_equal(y, py)
    assert names == pnames and len(names) == 10
    assert sorted(clips) == sorted(pclips) == sorted(train_vad.HELD_OUT)
    for k in clips:
        assert np.array_equal(clips[k], pclips[k])
    # against the C++ band-pass: only the band-passed windows may differ,
    # by float summation order
    tw, ty = theirs[0], theirs[1]
    assert np.array_equal(y, ty)
    diff = np.abs(w - tw).max(axis=1)
    assert diff.max() < 1e-5
    assert (diff > 0).sum() <= int(y.sum()) // 4


def jax_feats(windows):
    n_frames = 1 + (windows.shape[1] - jax_vad.FRAME) // jax_vad.HOP
    idx = (np.arange(n_frames)[:, None] * jax_vad.HOP
           + np.arange(jax_vad.FRAME)[None, :])
    fn = jax.jit(jax.vmap(lambda fr: jax_vad.frames_to_feats(
        fr, jnp.asarray(jax_vad._mel_fb()))))
    win = jnp.asarray(jax_vad._window())
    return np.concatenate([
        np.asarray(fn(jnp.asarray(windows[i:i + 512][:, idx])
                      * win[None, None, :]))
        for i in range(0, len(windows), 512)])


def test_featurization_matches_jax(datasets):
    w = datasets[0][0][::7]
    ours = train_vad.featurize_windows(w, CPU).numpy()
    want = jax_feats(w)
    assert ours.shape == want.shape == (len(w), 98, vad_model.N_MELS)
    # f32 FFTs of two libraries agree to ~1e-6 of a frame's energy, so the
    # log features of its quiet bins differ more: compare mel power
    # against each frame's loudest bin
    po = 10.0 ** (3.0 * ours.astype(np.float64) - 5.0)
    pj = 10.0 ** (3.0 * want.astype(np.float64) - 5.0)
    assert np.all(np.abs(po - pj)
                  <= 1e-5 * pj.max(axis=-1, keepdims=True) + 1e-9)
    assert np.mean(np.abs(ours - want) < 2e-5) > 0.95


def jax_train(params, feats, labels, steps, lr, seed):
    """The JAX tool's training loop (``train_vad.py:166-190``)."""
    mask = jnp.ones((feats.shape[1],), bool)
    optimizer = optax.adam(lr)
    opt_state = optimizer.init(params)

    def loss_fn(p, f, y):
        logits = jax.vmap(lambda ff: jax_vad.window_logit(p, ff, mask))(f)
        return optax.sigmoid_binary_cross_entropy(logits, y).mean()

    @jax.jit
    def step_fn(p, o, f, y):
        loss, grads = jax.value_and_grad(loss_fn)(p, f, y)
        updates, o = optimizer.update(grads, o)
        return optax.apply_updates(p, updates), o, loss

    rng = np.random.default_rng(seed)
    losses = []
    for _ in range(steps):
        sel = rng.integers(0, len(feats), 256)
        params, opt_state, loss = step_fn(params, opt_state,
                                          jnp.asarray(feats[sel]),
                                          jnp.asarray(labels[sel]))
        losses.append(float(loss))
    return params, losses


def test_twenty_steps_match_optax(datasets):
    (w, y, _, _) = datasets[0]
    feats = jax_feats(w)
    init = {k: np.asarray(v) for k, v in
            jax_vad.init_params(jax.random.PRNGKey(0)).items()}
    want, want_losses = jax_train(init, feats, y, 20, 3e-3, 0)
    params = {k: torch.from_numpy(v.copy()) for k, v in init.items()}
    got, losses = train_vad.train(params, torch.from_numpy(feats), y, 20,
                                  3e-3, 0, log_every=0)
    np.testing.assert_allclose([float(x) for x in losses], want_losses,
                               rtol=1e-5)
    # within 1e-5 of each leaf's largest magnitude (an element near zero
    # has no meaningful relative error)
    for k, v in want.items():
        v = np.asarray(v)
        assert (np.abs(got[k].numpy() - v).max()
                <= 1e-5 * max(np.abs(v).max(), 1e-6)), k
    assert not np.allclose(got["w0"].numpy(), init["w0"])


def test_port_init_has_jax_layout_and_scales():
    params = train_vad.init_params(0, CPU)
    jp = jax_vad.init_params(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in params.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    for i, (k, cin, _, _) in enumerate(vad_model._LAYERS):
        assert float(params[f"w{i}"].std()) == pytest.approx(
            (2.0 / (k * cin)) ** 0.5, rel=0.15)
    assert torch.equal(train_vad.init_params(0, CPU)["w0"], params["w0"])


def test_calibration_and_error_match_jax(datasets):
    (w, y, _, _) = datasets[0]
    feats = jax_feats(w)
    weights = vad_model.load_params(vad_model.WEIGHTS_PATH)
    params = {k: torch.from_numpy(np.asarray(v, np.float32))
              for k, v in weights.items()}
    got, offset, logits, fp, fn = train_vad.calibrate(
        params, torch.from_numpy(feats), y)
    # the JAX tool's calibration (train_vad.py:194-227)
    mask = jnp.ones((feats.shape[1],), bool)
    eval_fn = jax.jit(jax.vmap(
        lambda pp, ff: jax_vad.window_logit(pp, ff, mask),
        in_axes=(None, 0)))
    jw = {k: jnp.asarray(v) for k, v in weights.items()}
    jl = np.concatenate([np.asarray(eval_fn(jw, jnp.asarray(feats[i:i + 512])))
                         for i in range(0, len(feats), 512)])
    jax_offset = -(float(jl[y == 0].max()) + 2.0)
    assert offset == pytest.approx(jax_offset, abs=1e-5)
    jl = jl + jax_offset
    pred = jl > 0
    assert fp == float(((pred == 1) & (y == 0)).sum() / (1 - y).sum())
    assert fn == float(((pred == 0) & (y == 1)).sum() / y.sum())
    np.testing.assert_allclose(logits, jl, rtol=0, atol=1e-4)
    assert float(got["b_head"]) == pytest.approx(
        float(weights["b_head"]) + offset, abs=1e-6)


def test_evaluate_table_equals_jax(monkeypatch, tmp_path):
    """``evaluate()`` through each package's serving VAD on the same
    weights (the committed file, saved again by the port's writer)."""
    path = str(tmp_path / "vad.npz")
    weights = vad_model.load_params(vad_model.WEIGHTS_PATH)
    train_vad.save_params({k: torch.from_numpy(np.asarray(v))
                           for k, v in weights.items()}, path)
    clips = train_vad.read_clips(DATA)
    clips = {k: clips[k] for k in ("english_01", "thai_02", "chinese_02")}
    monkeypatch.setenv("ASR_VAD", "learned")
    monkeypatch.setenv("ASR_VAD_WEIGHTS", path)
    monkeypatch.setattr(jax_vad, "_params", None)
    want = jax_tool.evaluate(clips)
    train_vad.use_weights(path)
    got = train_vad.evaluate(clips, device=CPU)
    vad_model._read.cache_clear()
    vad_model._model.cache_clear()
    assert got == want
    assert all(r["windows"] > 0 for r in got.values())


def test_main_writes_jax_readable_weights(tmp_path, monkeypatch, capsys):
    """A short CLI run on the CPU: the npz has JAX's keys and layout and
    JAX's loader reads it; the package's own weights are untouched."""
    import hashlib
    before = hashlib.sha256(open(vad_model.WEIGHTS_PATH, "rb").read()
                            ).hexdigest()
    out = str(tmp_path / "w.npz")
    # main() points the serving VAD at its output; the env comes back after
    monkeypatch.setenv("ASR_VAD", "learned")
    monkeypatch.setenv("ASR_VAD_WEIGHTS", vad_model.WEIGHTS_PATH)
    report = train_vad.main(["--data-dir", DATA, "--output", out,
                             "--steps", "3", "--device", "cpu"])
    vad_model._read.cache_clear()
    vad_model._model.cache_clear()
    assert set(report) >= {"train_fp", "train_fn", "flap_table",
                           "worst_flap_rate", "held_out"}
    loaded = jax_vad.load_params(out)
    assert {k: tuple(np.shape(v)) for k, v in loaded.items()} == {
        k: tuple(np.shape(v)) for k, v in
        jax_vad.init_params(jax.random.PRNGKey(0)).items()}
    assert hashlib.sha256(open(vad_model.WEIGHTS_PATH, "rb").read()
                          ).hexdigest() == before
