"""The port's backward kernels' plain versions against the JAX package, on
the CPU: flash attention's gradients (``FlashFunction``, whose backward is
``flash_attention_bwd_plain`` here) against ``jax.grad`` through JAX's
``flash_attention(..., interpret=True)`` (a custom VJP over the dense
``_xla_forward``), and ``qk_rope``'s against ``jax.grad`` of JAX's
``rms_norm`` then ``apply_rope``. Inputs come from numpy with a seed.

Tolerances: f32 gradients agree to 2e-5 of each gradient's largest
magnitude (the summation order differs; nothing is rounded); bf16 QK-norm
+ RoPE to 2e-2 of it (bf16's ulp at the rounding points both sides
share, where a sum taken in another order can round across one)."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from qwen3_asr_tpu.models.decoder import apply_rope as jax_apply_rope
from qwen3_asr_tpu.models.decoder import rms_norm as jax_rms_norm
from qwen3_asr_tpu.models.decoder import rope_cos_sin as jax_rope_cos_sin
from qwen3_asr_tpu.ops.flash_attention import flash_attention as jax_flash
from qwen3_asr_tpu_torch.ops.flash_attention import (_scores, flash_attention,
                                                     flash_attention_bwd_plain,
                                                     flash_attention_plain)
from qwen3_asr_tpu_torch.ops.qk_rope_kv import qk_rope, qk_rope_bwd_plain

F32_TOL = 2e-5


def _close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


# (name, b, nq, nkv, t, s, causal, window, valid_from, valid_to, q_offset)
CASES = [
    ("causal_gqa", 2, 4, 2, 40, 40, True, 0, None, None, 0),
    ("left_pad_fully_masked_rows", 2, 4, 2, 40, 40, True, 0,
     [0, 10], [40, 30], 0),
    ("valid_range_and_empty_row", 2, 2, 1, 24, 24, False, 0,
     [3, 0], [20, 0], 0),
    ("window_blocks", 2, 4, 4, 40, 40, False, 13, None, [40, 27], 0),
    ("per_row_q_offset", 2, 4, 2, 8, 40, True, 0, [0, 5], None,
     [32, 20]),
]


def _inputs(case, seed=0):
    _, b, nq, nkv, t, s, *_ = case
    rng = np.random.default_rng(seed)
    d = 16
    q = rng.standard_normal((b, nq, t, d)).astype(np.float32)
    k = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, nkv, s, d)).astype(np.float32)
    g = rng.standard_normal((b, nq, t, d)).astype(np.float32)
    return q, k, v, g


def _mask_args(case, lib):
    _, b, _, _, _, s, causal, window, vf, vt, q_off = case
    ints = (lambda x: None if x is None else jnp.asarray(x, jnp.int32)) \
        if lib == "jax" else \
        (lambda x: None if x is None else torch.tensor(x, dtype=torch.int32))
    off = ints(q_off) if isinstance(q_off, list) else q_off
    return dict(causal=causal, window_block=window, kv_valid_from=ints(vf),
                kv_valid_to=ints(vt), q_offset=off)


def _jax_grads(case, q, k, v, g):
    kw = _mask_args(case, "jax")

    def loss(q_, k_, v_):
        out = jax_flash(q_, k_, v_, interpret=True, **kw)
        return jnp.sum(out * g)

    return jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))


def _torch_grads(case, q, k, v, g):
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = flash_attention(*ts, **_mask_args(case, "torch"))
    assert out.grad_fn is not None
    return torch.autograd.grad(out, ts, torch.from_numpy(g))


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_flash_grads_match_jax(case):
    q, k, v, g = _inputs(case)
    want = _jax_grads(case, q, k, v, g)
    got = _torch_grads(case, q, k, v, g)
    for name, w, x in zip("qkv", want, got):
        assert np.isfinite(x.numpy()).all(), name
        _close(x.numpy(), w, F32_TOL)


def test_fully_masked_rows_have_zero_gradients():
    case = CASES[1]      # batch row 1: keys from 10, so rows 0..9 see none
    q, k, v, g = _inputs(case)
    dq, dk, dv = _torch_grads(case, q, k, v, g)
    assert torch.all(dq[1, :, :10] == 0)
    # keys outside [valid_from, valid_to) get nothing either
    assert torch.all(dk[1, :, :10] == 0) and torch.all(dv[1, :, 30:] == 0)


def _plain_args(case, q):
    kw = _mask_args(case, "torch")
    b, s = q.shape[0], case[5]
    vf = kw["kv_valid_from"]
    vt = kw["kv_valid_to"]
    off = kw["q_offset"]
    return dict(
        valid_from=torch.zeros(b, dtype=torch.int32) if vf is None else vf,
        valid_to=torch.full((b,), s, dtype=torch.int32) if vt is None else vt,
        q_offset=(off if torch.is_tensor(off)
                  else torch.full((b,), off, dtype=torch.int32)),
        causal=kw["causal"], window_block=kw["window_block"],
        sm_scale=q.shape[-1] ** -0.5)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_bwd_plain_matches_autograd_of_plain_forward(case):
    """In f32 the plain forward rounds nothing, so torch autograd of it is
    the gradient the backward restates."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(case, seed=1))
    a = _plain_args(case, q)
    ts = [x.clone().requires_grad_() for x in (q, k, v)]
    out, m, l = flash_attention_plain(*ts, **a)
    want = torch.autograd.grad(out, ts, g)
    got = flash_attention_bwd_plain(q, k, v, g, m.detach(), l.detach(), **a)
    for w, x in zip(want, got):
        _close(x.numpy(), w.numpy(), F32_TOL)


# the cases above, and rows whose maxima tie: keys 4, 9, 15 and 20 equal
# and dominant, every value a multiple of 1/4 so that every score is exact
# and the duplicated keys' scores tie on both sides
ML_CASES = CASES + [
    ("tied_maxima", 2, 4, 2, 24, 24, True, 0, [0, 3], None, [0, 2]),
]


def _ml_inputs(case):
    q, k, v, _ = _inputs(case, seed=3)
    if case[0] == "tied_maxima":
        q, k = np.round(q * 4) / 4, np.round(k * 4) / 4
        k[:, :, 4] = np.abs(k[:, :, 4]) * 4 * np.sign(q.sum(axis=2))[:, ::2]
        for c in (9, 15, 20):
            k[:, :, c] = k[:, :, 4]
    return q, k, v


def _residual_loss(out, m, l, lib):
    """JAX's ``test_grad_flows_through_residuals`` loss, with log l taken
    at no less than 1e-30 so that a row with no live key adds nothing."""
    if lib == "jax":
        return (jnp.sum(out ** 2) + jnp.sum(m) * 1e-3
                + jnp.sum(jnp.log(jnp.maximum(l, 1e-30))))
    return ((out ** 2).sum() + m.sum() * 1e-3
            + torch.log(torch.clamp(l, min=1e-30)).sum())


@pytest.mark.parametrize("case", ML_CASES, ids=[c[0] for c in ML_CASES])
def test_residual_cotangents_match_jax(case):
    """Cotangents on out, m and l: the port's backward (on the CPU,
    ``flash_attention_bwd_plain`` with dm and dl) against ``jax.vjp`` of
    JAX's flash with residuals in interpret mode, in f32: causal with
    offsets, left and right padding, a window, fully masked rows, tied
    maxima."""
    q, k, v = _ml_inputs(case)
    kw = _mask_args(case, "jax")

    def loss(q_, k_, v_):
        return _residual_loss(*jax_flash(q_, k_, v_, interpret=True,
                                         return_residuals=True, **kw), "jax")

    want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(_residual_loss(*flash_attention(
        *ts, return_residuals=True, **_mask_args(case, "torch")), "torch"), ts)
    for name, w, x in zip("qkv", want, got):
        assert np.isfinite(x.numpy()).all(), name
        _close(x.numpy(), w, F32_TOL)
    if case[0] == "tied_maxima":
        # the case holds ties: some row's maximum is a duplicated key
        a = _plain_args(case, ts[0])
        s, mask = _scores(ts[0].detach(), ts[1].detach(), a["valid_from"],
                          a["valid_to"], a["q_offset"], a["causal"], 0,
                          a["sm_scale"])
        top = torch.where(mask, s, torch.full_like(s, -torch.inf))
        ties = (top == top.amax(-1, keepdim=True)).sum(-1)
        assert int(ties.max()) >= 3


def test_no_graph_without_grad():
    """Serving (no tensor requiring grad) keeps its direct route."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(CASES[0]))
    assert flash_attention(q, k, v, causal=True).grad_fn is None


# ---------------------------------------------------------------------------
# QK-norm + RoPE


def _rope_inputs(b, t, nq, nkv, d, seed):
    rng = np.random.default_rng(seed)
    x = {n: rng.standard_normal((b, t, h * d)).astype(np.float32)
         for n, h in (("q", nq), ("k", nkv), ("v", nkv))}
    w = {n: (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
         for n in ("q_norm", "k_norm")}
    g = {n: rng.standard_normal((b, h, t, d)).astype(np.float32)
         for n, h in (("q", nq), ("k", nkv), ("v", nkv))}
    pos = np.stack([np.arange(t) + 3 * i for i in range(b)]).astype(np.int32)
    return x, w, g, pos


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [48, 128])
def test_qk_rope_grads_match_jax(d, dtype):
    b, t, nq, nkv, eps = 2, 5, 4, 2, 1e-6
    x, w, g, pos = _rope_inputs(b, t, nq, nkv, d, seed=d)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    cos, sin = jax_rope_cos_sin(jnp.asarray(pos), d, 1e6)

    def heads(a):
        return a.reshape(b, t, -1, d).transpose(0, 2, 1, 3)

    def jax_loss(q, k, v, qn, kn):
        qo = jax_apply_rope(jax_rms_norm(heads(q), qn, eps), cos, sin)
        ko = jax_apply_rope(jax_rms_norm(heads(k), kn, eps), cos, sin)
        return sum(jnp.sum(o.astype(jnp.float32) * g[n])
                   for o, n in ((qo, "q"), (ko, "k"), (heads(v), "v")))

    jargs = [jnp.asarray(x[n], jdt) for n in "qkv"] + \
            [jnp.asarray(w[n], jdt) for n in ("q_norm", "k_norm")]
    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1, 2, 3, 4)))(*jargs)

    targs = [torch.from_numpy(x[n]).to(tdt).requires_grad_() for n in "qkv"]
    tw = [torch.from_numpy(w[n]).to(tdt).requires_grad_()
          for n in ("q_norm", "k_norm")]
    tcos = torch.from_numpy(np.array(cos))
    tsin = torch.from_numpy(np.array(sin))
    outs = qk_rope(*targs, *tw, tcos, tsin, eps)
    got = torch.autograd.grad(
        outs, targs + tw,
        [torch.from_numpy(g[n]).to(tdt) for n in "qkv"])
    tol = F32_TOL if dtype == "float32" else 2e-2
    for name, wnt, gt in zip(("q", "k", "v", "q_norm", "k_norm"), want, got):
        assert gt.dtype == tdt, name
        _close(gt.float().numpy(), np.asarray(wnt, np.float32), tol)


def test_qk_rope_bwd_plain_matches_autograd():
    """The plain backward against torch autograd of the plain forward
    chain, f32, head_dim 128."""
    from qwen3_asr_tpu_torch.models.decoder import rope_cos_sin
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import apply_rope, rms_norm
    b, t, n, d, eps = 2, 6, 3, 128, 1e-6
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((b, n, t, d)).astype(np.float32))
    w = torch.from_numpy((1 + 0.1 * rng.standard_normal(d)).astype(
        np.float32))
    g = torch.from_numpy(rng.standard_normal((b, n, t, d)).astype(np.float32))
    cos, sin = rope_cos_sin(torch.arange(t)[None].expand(b, t), d, 1e6)
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    out = apply_rope(rms_norm(xr, wr, eps), cos, sin)
    want = torch.autograd.grad(out, (xr, wr), g)
    got = qk_rope_bwd_plain(x, w, cos, sin, eps, g)
    for a, c in zip(got, want):
        _close(a.numpy(), c.numpy(), F32_TOL)
