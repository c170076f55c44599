"""The tensor-parallel collectives the model's layers call themselves.

The JAX package shards its weights with ``NamedSharding`` and lets XLA
insert the collectives; the port's tensor parallelism is explicit, so a
sharded layer calls these at the points XLA would (``parallel/mesh.py``
says where). Each is differentiable, Megatron's pair:

- ``copy_to_tp``: identity forward; the backward sums the gradient over
  the tp group (the input of a product sharded by output features is
  replicated, and each rank holds only its heads' share of its gradient);
- ``reduce_from_tp``: ``all_reduce(SUM)`` forward (the partial sums of a
  product sharded by input features, or of a vocab-sharded lookup);
  identity backward;
- ``gather_from_tp``: ``all_gather`` along the last dim forward (this
  rank's slice of the logits or features to the whole); the backward
  keeps this rank's slice of the gradient.

Outside autograd (serving, and inside a CUDA graph capture) they are the
plain collectives on the tp group. They run whatever the group's size: a
group of one still calls the collective (on the card a real NCCL call,
which a graph captures). ``calls()`` counts the calls, eager or recorded
into a capture (``runtime/graphs.py`` ``Graph.collectives``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.distributed as dist


class TPShard(NamedTuple):
    """A model's tensor-parallel coordinates: the tp group, this rank's
    index in it and its size."""
    group: object
    rank: int
    size: int


_calls = [0]


def calls() -> int:
    """Collectives called so far in this process (eager, or recorded into
    a CUDA graph capture)."""
    return _calls[0]


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    _calls[0] += 1
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _all_gather_last(x: torch.Tensor, tp: TPShard) -> torch.Tensor:
    _calls[0] += 1
    x = x.contiguous()
    out = torch.empty((tp.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x, group=tp.group)
    return (out.reshape((tp.size,) + tuple(x.shape)).movedim(0, -2)
            .reshape(*x.shape[:-1], tp.size * x.shape[-1]))


def _tracked(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.contiguous().clone(), ctx.tp.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return _all_reduce(x.contiguous().clone(), tp.group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return _all_gather_last(x, tp)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.tp.rank * ctx.n
        return g[..., lo:lo + ctx.n].contiguous(), None


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    if tp is None or not _tracked(x):
        return x
    return _CopyToTP.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum of ``x`` over the tp group (in place outside autograd:
    ``x`` is a fresh product)."""
    if tp is None:
        return x
    if _tracked(x):
        return _ReduceFromTP.apply(x, tp)
    return _all_reduce(x.contiguous(), tp.group)


def gather_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    if tp is None:
        return x
    if _tracked(x):
        return _GatherFromTP.apply(x, tp)
    return _all_gather_last(x, tp)


def tp_of(cfg):
    """The ``TPShard`` a sharded model's config carries, else None."""
    return getattr(cfg, "tp", None)
