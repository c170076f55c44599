"""The optimizer of the training step: the parts of optax that the JAX
package's trainers use, restated on nested dicts of tensors (the params'
layout), since the card's machine has no optax.

Each transformation has optax's interface, ``init(params) -> state`` and
``update(updates, state, params) -> (updates, state)``, and optax's
defaults and arithmetic:

- ``adamw``: ``scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8 outside the
  square root, bias correction by ``1 - b**count``), then
  ``add_decayed_weights`` (weight decay 1e-4, where torch's ``AdamW``
  defaults to 1e-2), then the learning rate, a float or a schedule of the
  update count. Moments keep the params' dtype, as optax's do.
- ``clip_by_global_norm``: ``g / ||g|| * max_norm`` above the norm, with no
  +1e-6 in the divisor (``torch.nn.utils.clip_grad_norm_`` adds one).
  Over a tensor-parallel shard (``mesh``) the norm counts the squares of
  every tp-sharded leaf over the tp group and each replicated leaf once.
- ``chain``, ``apply_updates``.
- ``warmup_cosine_decay_schedule``: a linear warmup joined to a cosine
  decay, as optax joins them (``qwen3_asr_tpu/tools/overfit.py:293-297``).
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..parallel.mesh import tp_sharded

Schedule = Callable[[int], float]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def _lr(learning_rate: Union[float, Schedule], count: int) -> float:
    return learning_rate(count) if callable(learning_rate) else learning_rate


def adamw(learning_rate: Union[float, Schedule], b1: float = 0.9,
          b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 1e-4) -> GradientTransformation:
    """optax.adamw: Adam's moments and bias correction, decoupled weight
    decay, then ``-learning_rate`` (a schedule is read at the update count
    before this update, from 0)."""

    def init(params):
        return {"count": 0, "mu": tree_map(torch.zeros_like, params),
                "nu": tree_map(torch.zeros_like, params)}

    def update(updates, state, params):
        count = state["count"] + 1
        mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, updates,
                      state["mu"])
        nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, updates,
                      state["nu"])
        # optax takes 1 - b ** count in f32
        c1, c2 = (float(np.float32(1) - np.float32(b) ** np.float32(count))
                  for b in (b1, b2))
        step = -_lr(learning_rate, state["count"])
        out = tree_map(
            lambda m, v, p: ((m / c1) / (torch.sqrt(v / c2) + eps)
                             + weight_decay * p) * step, mu, nu, params)
        return out, {"count": count, "mu": mu, "nu": nu}

    return GradientTransformation(init, update)


def global_norm(tree, mesh=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32. With ``mesh``,
    ``tree`` is a tensor-parallel shard: its sharded leaves' squares are
    summed over the tp group (``parallel/mesh.py`` ``tp_sharded``)."""
    if mesh is None:
        return torch.sqrt(sum(torch.sum(x.float() * x.float())
                              for x in tree_leaves(tree)))
    flags = tree_leaves(tp_sharded(tree))
    sq = [torch.sum(x.float() * x.float()) for x in tree_leaves(tree)]
    dev = sq[0].device
    shard = sum((q for q, f in zip(sq, flags) if f),
                torch.zeros((), device=dev))
    dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=mesh.tp_group)
    return torch.sqrt(shard + sum((q for q, f in zip(sq, flags) if not f),
                                  torch.zeros((), device=dev)))


def clip_by_global_norm(max_norm: float,
                        mesh=None) -> GradientTransformation:
    """optax.clip_by_global_norm: leaves kept where the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm``. The choice is made on the
    device (no host read). ``mesh``: the updates are a tensor-parallel
    shard (``global_norm``)."""

    def update(updates, state, params):
        norm = global_norm(updates, mesh)
        keep = norm < max_norm

        def clip(g):
            return torch.where(keep, g, (g / norm.to(g.dtype)) * max_norm)

        return tree_map(clip, updates), state

    return GradientTransformation(lambda params: {}, update)


def chain(*transforms: GradientTransformation) -> GradientTransformation:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(updates, state, params):
        new_state = []
        for t, s in zip(transforms, state):
            updates, s = t.update(updates, s, params)
            new_state.append(s)
        return updates, tuple(new_state)

    return GradientTransformation(init, update)


def apply_updates(params, updates):
    """params + updates, in each param's dtype."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    """optax's schedule: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at
    ``decay_steps`` (counted from 0, warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if cos_steps <= 0:
        raise ValueError(f"the cosine decay needs positive steps, got "
                         f"{cos_steps}")

    f32 = np.float32

    def schedule(count: int) -> float:
        # in f32, as optax evaluates it
        if count < warmup_steps:
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(
                warmup_steps)
            return float(f32(init_value - peak_value) * frac
                         + f32(peak_value))
        c = f32(min(count - warmup_steps, cos_steps))
        decay = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(cos_steps)))
        return float(f32(peak_value) * (f32(1 - alpha) * decay ** f32(exponent)
                                        + f32(alpha)))

    return schedule
