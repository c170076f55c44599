"""Export the audio encoder with ``torch.export``, flash attention as a
registered operator.

Counterpart of ``qwen3_asr_tpu/tools/export_stablehlo.py``: JAX lowers
``encoder_forward`` at one bucket and batch, the weights as arguments of
the module rather than constants, and writes the StableHLO text. The port
wraps ``models/encoder.py`` ``encoder_forward`` in a module that holds the
weights as buffers (an exported program lifts them to inputs), exports it
at the bucket's mel shape and writes it with ``torch.export.save``. Flash
attention is traced as ``torch.ops.qwen3_asr_torch.flash_attention``
(``ops/flash_attention.py`` ``registered_op``), so the program runs the
hand-written kernel on the card and its plain version on the CPU; load a
program with ``load_encoder``, which registers the operator first.

    python -m qwen3_asr_tpu_torch.tools.export_encoder \\
        --model-id /path/to/ckpt --bucket-s 6 --output encoder.pt2 \\
        [--device cpu]

Quantized weights (``QUANTIZE``) are refused: kernels A and C are launched
through ``ctypes`` and are not registered operators.
"""
from __future__ import annotations

import argparse
import os
from typing import Tuple

import torch

from ..models.config import AudioEncoderConfig


class EncoderModule(torch.nn.Module):
    """``encoder_forward`` with its weights as buffers (``/`` in a tree
    path becomes ``__``)."""

    def __init__(self, params: dict, cfg: AudioEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self._paths = []
        for path, leaf in _flatten(params):
            name = "__".join(path)
            self.register_buffer(name, leaf, persistent=True)
            self._paths.append((path, name))

    def params(self) -> dict:
        tree: dict = {}
        for path, name in self._paths:
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = getattr(self, name)
        return tree

    def forward(self, mel: torch.Tensor, feature_lens: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        from ..models.encoder import encoder_forward
        return encoder_forward(self.params(), self.cfg, mel, feature_lens)


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def bucket_mel_frames(cfg: AudioEncoderConfig, bucket_s: float) -> int:
    """The bucket's mel frames, rounded up to the encoder's chunk."""
    chunk = cfg.n_window * 2
    frames = int(bucket_s * 100)
    return -(-frames // chunk) * chunk


def export_program(params: dict, cfg: AudioEncoderConfig, batch: int,
                   frames: int, dtype: torch.dtype, device):
    """The ``ExportedProgram`` of the encoder at ``[batch, n_mels,
    frames]``."""
    from ..ops.flash_attention import through_registered_op
    from ..ops.quant import any_quantized
    if any_quantized(params):
        raise ValueError("the encoder export takes unquantized weights "
                         "(unset QUANTIZE): kernels A and C are not "
                         "registered operators")
    module = EncoderModule(params, cfg)
    mel = torch.zeros((batch, cfg.num_mel_bins, frames), dtype=dtype,
                      device=device)
    lens = torch.full((batch,), frames, dtype=torch.int32, device=device)
    with torch.no_grad():
        # an eager run first: it fills the position embedding's cache with
        # real tensors, which the trace then holds as constants (a cache
        # filled inside the trace would keep its fake tensor)
        module(mel, lens)
        with through_registered_op():
            return torch.export.export(module, (mel, lens))


def export_encoder(model_id: str, bucket_s: float = 6.0,
                   output: str = "encoder.pt2", batch: int = 1,
                   device="cuda") -> str:
    """Load ``model_id`` as the server would on ``device`` and write its
    encoder's exported program to ``output``."""
    from ..runtime.lifecycle import load_engine
    engine = load_engine(model_id, device=device)
    cfg = engine.model.cfg.encoder
    program = export_program(engine.model.params["encoder"], cfg, batch,
                             bucket_mel_frames(cfg, bucket_s), engine.dtype,
                             engine.device)
    torch.export.save(program, output)
    return output


def load_encoder(path: str):
    """An exported encoder program, read back (the flash operator
    registered first)."""
    from ..ops.flash_attention import registered_op
    registered_op()
    return torch.export.load(path)


def flash_nodes(program) -> int:
    """The flash operator's nodes in an exported program's graph."""
    from ..ops.flash_attention import registered_op
    op = registered_op()
    return sum(1 for node in program.graph.nodes
               if node.op == "call_function" and node.target == op)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--model-id",
                        default=os.getenv("MODEL_ID", "preset:1.7b"))
    parser.add_argument("--bucket-s", type=float, default=6.0)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--output", default="encoder.pt2")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    path = export_encoder(args.model_id, args.bucket_s, args.output,
                          args.batch, args.device)
    print(f"exported encoder program written to {path}")


if __name__ == "__main__":
    main()
