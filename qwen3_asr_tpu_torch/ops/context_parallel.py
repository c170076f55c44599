"""Context (sequence) parallelism: attention over a key/value axis sharded
across ranks, merged by the online-softmax combine.

Counterpart of ``qwen3_asr_tpu/ops/context_parallel.py``. Each rank holds
a contiguous slice of the key/value sequence (rank i the i-th of n equal
slices, as JAX's ``in_specs`` assign them), runs the flash kernel
(``ops/flash_attention.py``) over its slice with its residuals m and l,
and the shards' outputs merge exactly:

    m   = max_i m_i                   (global row max)
    w_i = l_i · exp(m_i − m)          (shard weight)
    out = Σ_i w_i·o_i / Σ_i w_i       (a safe divide: 0 where Σ w = 0)

Masks decompose by a coordinate shift (``shard_attend``): the shard at key
offset ``off`` runs flash with ``q_offset − off`` and ``valid_from`` /
``valid_to`` clipped into its range; a shard no query reaches gets l = 0
and drops out of the combine. Block-diagonal windows do not shift this
way and are refused, as JAX's docstring says (encoder windows never need
it).

The combine comes in two forms with the same arithmetic in the same
order: ``combine`` over a ``torch.distributed`` group (one
``all_reduce(MAX)``, two ``all_reduce(SUM)``), and ``combine_stacked``
over a leading shard axis on one device, which folds the shards of a
sequence onto one card. The combine is torch ops around two collectives:
in the JAX package too it is XLA arithmetic, not a Pallas kernel.

Forward only, as JAX's is: ``jax.grad`` through JAX's
``context_parallel_attention`` raises (``pmax`` has no differentiation
rule), so a backward through the port's raises NotImplementedError too.
The flash kernel itself differentiates all three of its outputs.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from .flash_attention import flash_attention


def shard_attend(q: torch.Tensor, k_local: torch.Tensor,
                 v_local: torch.Tensor, off: int, s_global: int, *,
                 causal: bool = False, q_offset=0,
                 kv_valid_from: Optional[torch.Tensor] = None,
                 kv_valid_to: Optional[torch.Tensor] = None,
                 sm_scale: Optional[float] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(o, m, l) of the shard whose keys start at global position ``off``:
    JAX's ``_local_attend`` shift (``context_parallel.py:45-75``)."""
    b, s_local, dev = q.shape[0], k_local.shape[-2], q.device
    vf = (torch.zeros((b,), dtype=torch.int32, device=dev)
          if kv_valid_from is None else kv_valid_from.to(dev, torch.int32))
    vt = (torch.full((b,), s_global, dtype=torch.int32, device=dev)
          if kv_valid_to is None else kv_valid_to.to(dev, torch.int32))
    q_off = (q_offset.to(dev, torch.int32).expand(b)
             if torch.is_tensor(q_offset)
             else torch.full((b,), int(q_offset), dtype=torch.int32,
                             device=dev))
    return flash_attention(
        q, k_local, v_local, causal=causal, q_offset=q_off - off,
        kv_valid_from=torch.clamp(vf - off, 0, s_local),
        kv_valid_to=torch.clamp(vt - off, 0, s_local), sm_scale=sm_scale,
        return_residuals=True)


def _merge(num: torch.Tensor, den: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    return (num / torch.where(den == 0.0, torch.ones_like(den), den)[..., None]
            ).to(dtype)


def combine(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
            group=None) -> torch.Tensor:
    """This rank's (o, m, l) merged with every other rank's of ``group``:
    ``all_reduce`` MAX of m, then SUM of w·o and of w. Every rank gets the
    whole output."""
    m_g = m.clone()
    dist.all_reduce(m_g, op=dist.ReduceOp.MAX, group=group)
    w = l * torch.exp(m - m_g)
    num = o.float() * w[..., None]
    dist.all_reduce(num, op=dist.ReduceOp.SUM, group=group)
    den = w.clone()
    dist.all_reduce(den, op=dist.ReduceOp.SUM, group=group)
    return _merge(num, den, o.dtype)


def combine_stacked(o: torch.Tensor, m: torch.Tensor,
                    l: torch.Tensor) -> torch.Tensor:
    """``combine`` over a leading shard axis on one device: o [n, B, Nq,
    T, D], m and l [n, B, Nq, T]; the sums run over the shards in order."""
    m_g = m[0]
    for mi in m[1:]:
        m_g = torch.maximum(m_g, mi)
    w = l * torch.exp(m - m_g)
    num, den = o[0].float() * w[0][..., None], w[0]
    for i in range(1, o.shape[0]):
        num = num + o[i].float() * w[i][..., None]
        den = den + w[i]
    return _merge(num, den, o.dtype)


class _NoBackward(torch.autograd.Function):
    """The combined output, with a backward that raises as JAX's does."""

    @staticmethod
    def forward(ctx, out, *inputs):
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "context-parallel attention is forward only, as the JAX "
            "package's is: jax.grad through its context_parallel_attention "
            "raises 'Differentiation rule for pmax not implemented'")


def _refuse_backward(out: torch.Tensor,
                     inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    if torch.is_grad_enabled() and any(x.requires_grad for x in inputs):
        return _NoBackward.apply(out, *inputs)
    return out


def _check(k: torch.Tensor, n: int, window_block: int) -> None:
    if window_block:
        raise ValueError("context-parallel attention takes no window_block: "
                         "block-diagonal windows do not shift by a key "
                         "offset (encoder windows are chunk-local)")
    if k.shape[-2] % n:
        raise ValueError(f"S={k.shape[-2]} not divisible by the {n} shards")


def context_parallel_attention(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, group=None, *,
                               causal: bool = False, q_offset=0,
                               kv_valid_from: Optional[torch.Tensor] = None,
                               kv_valid_to: Optional[torch.Tensor] = None,
                               sm_scale: Optional[float] = None,
                               window_block: int = 0) -> torch.Tensor:
    """Flash attention with K/V sequence-sharded over ``group``: q [B, Nq,
    T, D] the same on every rank; k/v [B, Nkv, S, D], the whole sequence,
    of which this rank attends to its contiguous slice. Returns [B, Nq, T,
    D] on every rank, equal to one flash call over the whole K/V."""
    n = dist.get_world_size(group)
    _check(k, n, window_block)
    s = k.shape[-2]
    per = s // n
    off = dist.get_rank(group) * per
    with torch.no_grad():
        o, m, l = shard_attend(
            q, k[:, :, off:off + per].contiguous(),
            v[:, :, off:off + per].contiguous(), off, s, causal=causal,
            q_offset=q_offset, kv_valid_from=kv_valid_from,
            kv_valid_to=kv_valid_to, sm_scale=sm_scale)
        out = combine(o, m, l, group)
    return _refuse_backward(out, (q, k, v))


def context_parallel_folded(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, n: int, *,
                            causal: bool = False, q_offset=0,
                            kv_valid_from: Optional[torch.Tensor] = None,
                            kv_valid_to: Optional[torch.Tensor] = None,
                            sm_scale: Optional[float] = None,
                            window_block: int = 0) -> torch.Tensor:
    """The same attention with the ``n`` shards folded onto one device:
    one flash call a shard, then ``combine_stacked``."""
    _check(k, n, window_block)
    s = k.shape[-2]
    per = s // n
    with torch.no_grad():
        parts = [shard_attend(
            q, k[:, :, i * per:(i + 1) * per].contiguous(),
            v[:, :, i * per:(i + 1) * per].contiguous(), i * per, s,
            causal=causal, q_offset=q_offset, kv_valid_from=kv_valid_from,
            kv_valid_to=kv_valid_to, sm_scale=sm_scale) for i in range(n)]
        out = combine_stacked(*(torch.stack(x) for x in zip(*parts)))
    return _refuse_backward(out, (q, k, v))
