"""The training step: LM cross-entropy fine-tuning of the ASR stack.

Counterpart of ``qwen3_asr_tpu/runtime/train.py``: ``asr_loss`` (next-token
CE on the transcript, conditioned on [prefix, audio, suffix]), the
update-exact ``microbatch`` accumulation, ``make_train_step`` and
``init_train_state``, with the optimizer of ``runtime/optim.py`` in
optax's place. The forward is the serving model's without a KV cache
(``decoder_forward(..., cache=None)``): every attention goes through flash
attention's autograd function and QK-norm + RoPE through ``qk_rope``, so on
the card the backward runs the hand-written kernels
``csrc/flash_attention_bwd.cu`` and ``csrc/qk_rope_bwd.cu``; the rest is
torch autograd over plain ops (the products, norms, convolutions), as XLA
differentiates them in the JAX package. Quantized weights have no
backward: train before quantizing.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.config import AsrConfig
from ..models.decoder import decoder_forward, embed_tokens, lm_logits
from ..models.encoder import encoder_forward
from ..ops.attention import AttnSpec
from .optim import GradientTransformation, apply_updates, tree_leaves, tree_map


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: int


def _per_layer(params: dict) -> dict:
    """Each tower's stacked ``[L, ...]`` layer leaves as tuples of per-layer
    views (``torch.unbind``), which ``layer_slice`` indexes as it indexes
    the stacked tensor. Autograd then builds a leaf's gradient once, as a
    stack of the layers' gradients; indexing the stacked tensor would add
    a zero-padded gradient of the whole leaf for every layer, L² the
    bytes."""
    return {name: {**tower, "layers": {k: v.unbind(0)
                                       for k, v in tower["layers"].items()}}
            for name, tower in params.items()}


def asr_loss(params: dict, cfg: AsrConfig, mel: torch.Tensor,
             feature_lens: torch.Tensor, prompt_ids: torch.Tensor,
             target_ids: torch.Tensor, target_mask: torch.Tensor,
             valid_from: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CE loss of target transcript tokens given audio.

    mel: [B, M, T_mel]; prompt_ids: [B, T_pre] text prefix (the audio span
    follows it); target_ids/mask: [B, T_tgt], the prompt SUFFIX tokens
    (mask 0) ahead of the transcript, so training conditions on the layout
    inference decodes from; valid_from: [B] first real prompt index of
    left-padded prefixes (None = attend everything). The mask may carry
    weights (``tools/overfit.py`` upweights the first tokens)."""
    dec = cfg.decoder
    params = _per_layer(params)
    dtype = params["decoder"]["embed"].dtype
    audio_embeds, _ = encoder_forward(params["encoder"], cfg.encoder,
                                      mel.to(dtype), feature_lens)
    pre = embed_tokens(params["decoder"], prompt_ids.long())
    tgt = embed_tokens(params["decoder"], target_ids.long())
    inputs = torch.cat([pre, audio_embeds.to(pre.dtype), tgt], dim=1)
    b, t, _ = inputs.shape
    positions = torch.arange(t, device=inputs.device).expand(b, t)
    vf = None if valid_from is None else valid_from.to(torch.int32)
    hidden, _ = decoder_forward(params["decoder"], dec, inputs, positions,
                                None, 0, AttnSpec(causal=True, valid_from=vf))
    # target token i is predicted from position (prefix + audio + i - 1)
    tgt_start = t - target_ids.shape[1]
    logits = lm_logits(params["decoder"], dec, hidden[:, tgt_start - 1:-1])
    logp = F.log_softmax(logits, dim=-1)
    token_logp = logp.gather(-1, target_ids.long()[..., None])[..., 0]
    mask_f = target_mask.float()
    return -(token_logp * mask_f).sum() / torch.clamp(mask_f.sum(), min=1.0)


def _unnormalized_loss(params, cfg, mel, feature_lens, prompt_ids,
                       target_ids, target_mask, valid_from):
    """(negative weighted logp sum, weight sum): asr_loss's pieces before
    the normalization, so chunks accumulate exactly (the denominator does
    not depend on the params)."""
    den = torch.clamp(target_mask.float().sum(), min=0.0)
    num = asr_loss(params, cfg, mel, feature_lens, prompt_ids, target_ids,
                   target_mask, valid_from) * torch.clamp(den, min=1.0)
    return num, den


_BATCH_DTYPES = {"mel": torch.float32, "feature_lens": torch.int32,
                 "prompt_ids": torch.int64, "target_ids": torch.int64,
                 "target_mask": torch.float32, "valid_from": torch.int32}


def batch_to(batch: dict, device) -> dict:
    """A ``make_batch`` dict of numpy arrays (or tensors) → tensors on
    ``device`` in the step's dtypes."""
    return {k: torch.as_tensor(np.asarray(v) if not torch.is_tensor(v)
                               else v).to(device, _BATCH_DTYPES[k])
            for k, v in batch.items() if k in _BATCH_DTYPES}


def _value_and_grad(fn, params: dict, *args):
    """(fn(params, *args), d fn / d params) with the params' structure; a
    leaf the loss does not reach gets zeros, as jax.grad gives."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        out = fn(tracked, *args)
        value = out[0] if isinstance(out, tuple) else out
        grads = torch.autograd.grad(value, leaves, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    grads = tree_map(lambda _: next(it), params)
    if isinstance(out, tuple):
        return tuple(x.detach() for x in out), grads
    return out.detach(), grads


def make_train_step(cfg: AsrConfig, optimizer: GradientTransformation,
                    microbatch: int = 0) -> Callable:
    """A (state, batch) → (state, loss) step. ``batch`` holds the arrays of
    ``tools/finetune.make_batch`` (numpy or tensors), moved to the params'
    device.

    ``microbatch`` > 0 splits the rows into chunks of that size and
    accumulates their gradients in f32, so peak activation memory drops by
    B / microbatch while the update stays exactly the full-batch update:
    chunk numerators and mask weights are summed before the one
    normalization, and pad rows (zero mask) add nothing to either."""

    def step(state: TrainState, batch: dict) -> Tuple[TrainState,
                                                      torch.Tensor]:
        dev = tree_leaves(state.params)[0].device
        batch = batch_to(batch, dev)
        vfrom = batch.get("valid_from")
        if not microbatch:
            loss, grads = _value_and_grad(
                asr_loss, state.params, cfg, batch["mel"],
                batch["feature_lens"], batch["prompt_ids"],
                batch["target_ids"], batch["target_mask"], vfrom)
        else:
            b = batch["mel"].shape[0]
            n_chunks = -(-b // microbatch)
            pad = n_chunks * microbatch - b

            def pad_rows(x):
                if x is None or pad == 0:
                    return x
                return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

            rows = {k: pad_rows(batch.get(k)) for k in _BATCH_DTYPES}
            acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                 device=dev), state.params)
            num = torch.zeros((), dtype=torch.float32, device=dev)
            den = torch.zeros((), dtype=torch.float32, device=dev)
            for i in range(n_chunks):
                take = {k: (None if x is None else
                            x[i * microbatch:(i + 1) * microbatch])
                        for k, x in rows.items()}
                (n, d), g = _value_and_grad(
                    _unnormalized_loss, state.params, cfg, take["mel"],
                    take["feature_lens"], take["prompt_ids"],
                    take["target_ids"], take["target_mask"],
                    take["valid_from"])
                acc = tree_map(lambda a, gi: a + gi.float(), acc, g)
                num, den = num + n, den + d
            scale = 1.0 / torch.clamp(den, min=1.0)
            grads = tree_map(lambda a, p: (a * scale).to(p.dtype), acc,
                             state.params)
            loss = num * scale
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


def init_train_state(params: dict, optimizer: GradientTransformation
                     ) -> TrainState:
    return TrainState(params, optimizer.init(params), 0)
