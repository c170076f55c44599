"""KV read-rate probe on the card: how fast can one layer of the stacked
cache be read in batch-major slabs?

Counterpart of ``tools_perf/attn_phase.py``'s slab reader (its variant 2).
The slab-read kernel (``ops/slab_reader.py``) reads a layer as the batched
decode kernel (``ops/decode_attention_batch.py``) reads a fully live one:
the same plan, the same bulk copies into shared memory. So the answer is
the read ceiling of that kernel's design, the yardstick for its read rate.
Each probe call reads one layer; the timing steps the layer through all of
them, so each call finds its layer cold in device memory, as the decode
loop does.

Run on a machine with the card: ``python -m
qwen3_asr_tpu_torch.tools_perf.attn_phase``. It prints one line for each
shape: the engine's at preset:1.7b (B=8, S=768, bf16 and fp8, the 28
layers) and the JAX probe's default (B=96, S=512, fp8).
"""
from __future__ import annotations

import sys
from typing import Callable, List

import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
LAYERS, NKV, HEAD_DIM = 28, 8, 128  # preset:1.7b's decoder
SHAPES = (("engine_b8_s768_bf16", 8, 768, torch.bfloat16),
          ("engine_b8_s768_fp8", 8, 768, torch.float8_e4m3fn),
          ("jax_default_b96_s512_fp8", 96, 512, torch.float8_e4m3fn))


def device_ms(fn: Callable[[], object], iters: int = 20,
              reps: int = 10) -> float:
    """Device time of one call: ``reps`` calls captured in one CUDA graph,
    replayed ``iters`` times between CUDA events, so host overhead does not
    hide the kernel's own time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def stacked_cache(batch: int, seq: int, dtype: torch.dtype, dev,
                  seed: int = 0):
    """Seeded random K and V caches [LAYERS, batch, NKV, seq, HEAD_DIM]."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (LAYERS, batch, NKV, seq, HEAD_DIM)
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for _ in range(2))


def probe(dev="cuda") -> List[dict]:
    """Time one slab-read call per shape (stepping through the layers) and
    return its read rate."""
    from ..ops.slab_reader import slab_read
    rows = []
    for name, batch, seq, dtype in SHAPES:
        k, v = stacked_cache(batch, seq, dtype, dev)
        layer_bytes = 2 * batch * NKV * seq * HEAD_DIM * k.element_size()
        ms = device_ms(lambda: [slab_read(k, v, layer_idx=i, seed=1)
                                for i in range(LAYERS)]) / LAYERS
        rate = layer_bytes / (ms * 1e-3)
        rows.append({"shape": name, "batch": batch, "seq": seq,
                     "dtype": str(dtype).replace("torch.", ""),
                     "bytes": layer_bytes, "ms": ms,
                     "bound_ms": layer_bytes / HBM_BYTES_PER_S * 1e3,
                     "gb_s": rate / 1e9, "share": rate / HBM_BYTES_PER_S})
        del k, v
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("attn_phase: no CUDA device is available", file=sys.stderr)
        return 1
    print(f"device: {torch.cuda.get_device_name(0)}")
    for r in probe():
        print(f"{r['shape']}: {r['ms']:.4f} ms per layer "
              f"({r['bytes'] / 1e6:.1f} MB), {r['gb_s']:.0f} GB/s = "
              f"{r['share']:.1%} of 3.35 TB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
