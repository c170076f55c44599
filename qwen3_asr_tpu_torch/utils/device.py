"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``cuda`` unless the caller asks for the CPU.

    Raises when a CUDA device is asked for and there is none: an entry point
    never carries on on the CPU unless it was asked to.
    """
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


def working_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, f32 on the CPU (f32 is the parity dtype)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32
