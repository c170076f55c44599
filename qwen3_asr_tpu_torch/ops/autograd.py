"""The guard of the wrappers whose kernels have no backward.

A kernel launched through ``ctypes`` returns tensors with no ``grad_fn``:
a loss built through one would give silent zero gradients upstream. The
wrappers that have no backward (``qgemv``, ``qgemm``, the decode
attentions, the slab reader and the in-place ``qk_rope_kv_write``) call
``refuse_grad`` at their entry, on both devices, and so raise where
autograd would need their gradient. Training takes float weights and runs
no decode step, so it never reaches them; it differentiates flash
attention and ``qk_rope``, which have backwards.
"""
from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors) -> None:
    """Raises RuntimeError when grad mode is on and a tensor among
    ``tensors`` (None and non-tensors skipped) requires grad."""
    if torch.is_grad_enabled() and any(
            torch.is_tensor(t) and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad(), or on "
            f"tensors that do not require grad (training differentiates "
            f"flash attention and qk_rope, and needs float weights)")
