"""Batch padding policy (the micro-batcher itself is not ported yet).

Counterpart of ``qwen3_asr_tpu/runtime/batcher.py`` ``_pad_pow2``.
"""
from __future__ import annotations

import numpy as np


def _pad_pow2(clips: list, dtype=np.float32) -> None:
    """Pad in place to a power-of-two batch with 0.1 s silent clips, so the
    long-form path only ever runs batches of {1, 2, 4, 8, ...}."""
    n = 1
    while n < len(clips):
        n *= 2
    while len(clips) < n:
        clips.append(np.zeros(1600, dtype=dtype))
