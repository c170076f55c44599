"""Analytic roofline model of one fused transcription dispatch.

Counterpart of ``qwen3_asr_tpu/runtime/roofline.py``, term by term: the
same FLOP and HBM-traffic arithmetic over the model config, so a benchmark
of the port and one of the JAX package divide by the same yardstick.

FLOP accounting (per dispatch at batch B):
  encoder   conv frontend (3 stride-2 conv2d) + conv_out/proj matmuls +
            per-layer QKVO/FFN matmuls at S_tok tokens + block attention
            (n_window_infer-frame blocks)
  prefill   decoder matmuls at P prompt tokens + full P^2 attention
            (dense: masked positions count) + one lm_head matmul row
  decode    (max_new - 1) steps: decoder matmuls + lm_head at 1 token +
            attention against the full padded cache (P + max_new rounded
            up to 128) at every step

The model counts the same work whatever implements it. The port's decode
kernels (#2, #3) skip the cache positions outside ``[valid_from,
valid_to)`` and its flash kernel skips masked blocks, so the card executes
less than the model counts; the count stays JAX's so that the two
packages' shares compare. Norms, rotary, elementwise work, the mel FFT and
embedding gathers are left out, as JAX leaves them out.

HBM bytes are a traffic model, not a measurement: the weights are read
once for the encoder, once for the prefill and once per decode step, the
KV cache is written once a token and read at every step over the padded
cache, and the int16 audio crosses once.

``utilization`` turns a cost and a measured wall time into the shares of
the card's peaks that ``bench.py`` calls ``mfu`` and ``hbm_util``.
"""
from __future__ import annotations

import dataclasses

import torch

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit: dense bf16
# tensor-core FLOP/s (no sparsity) and HBM3 bytes/s, from the data sheet.
H100_BF16_DENSE_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12


def _dtype_bytes(dtype) -> float:
    """Bytes an element; ``torch.int4`` (the packed KV cache) half a byte."""
    if dtype == torch.int4:
        return 0.5
    return float(dtype.itemsize)


def _tree_bytes(tree) -> int:
    """Bytes of a parameter tree's tensors. A quantized leaf's payload
    (int8/fp8 ``[out, in]``, int4 ``[out, in/2]`` uint8) and its scales are
    tensors of the tree, so the count equals JAX's for the same model."""
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return int(tree.numel() * _dtype_bytes(tree.dtype))


@dataclasses.dataclass
class RooflineCost:
    flops: float            # executed flops per fused dispatch
    hbm_bytes: float        # modeled HBM traffic per dispatch (floor)
    detail: dict

    def as_dict(self) -> dict:
        return {"tflops": round(self.flops / 1e12, 2),
                "hbm_gb": round(self.hbm_bytes / 1e9, 2),
                **{k: round(v / 1e12, 2) if k.endswith("_flops")
                   else round(v / 1e9, 2) for k, v in self.detail.items()}}


def analytic_cost(engine, batch: int, bucket_frames: int,
                  bucket_s: float) -> RooflineCost:
    """FLOPs and HBM traffic of one dispatch (frontend -> encoder ->
    prefill -> full decode loop) at this shape."""
    from ..audio.frontend import HOP_LENGTH
    from ..models.encoder import conv_tokens_per_chunk, encoder_output_length
    from .engine import max_new_tokens_for

    cfg = engine.model.cfg
    enc, dec = cfg.encoder, cfg.decoder
    B = batch
    max_new = max_new_tokens_for(bucket_s)
    steps = max_new - 1                      # decode-loop trips

    # --- shapes -----------------------------------------------------------
    chunk = enc.n_window * 2
    s_tok = int(encoder_output_length(bucket_frames, chunk))
    block_tok = conv_tokens_per_chunk(min(enc.n_window_infer, bucket_frames))
    n_samples = bucket_frames * HOP_LENGTH
    # the prompt as the engine assembles it: prefix budget, audio tokens,
    # suffix
    P = int(engine.prompt_length(bucket_frames))

    # --- encoder flops ----------------------------------------------------
    d, ffn, L_e = enc.d_model, enc.encoder_ffn_dim, enc.encoder_layers
    ch, mel = enc.downsample_hidden_size, enc.num_mel_bins
    conv = 0.0
    t, f, cin = bucket_frames, mel, 1
    for _ in range(3):
        t, f = (t + 1) // 2, (f + 1) // 2
        conv += 2.0 * 9 * cin * ch * t * f * B
        cin = ch
    enc_mm = (enc.conv_out_dim * d + L_e * (4 * d * d + 2 * d * ffn)
              + d * d + d * enc.output_dim)
    enc_attn = 4.0 * L_e * s_tok * block_tok * d * B
    enc_flops = conv + 2.0 * enc_mm * s_tok * B + enc_attn

    # --- decoder flops ----------------------------------------------------
    h, i, L_d = dec.hidden_size, dec.intermediate_size, dec.num_hidden_layers
    nh, nkv, hd = (dec.num_attention_heads, dec.num_key_value_heads,
                   dec.head_dim)
    layer_mm = 2 * h * nh * hd + 2 * h * nkv * hd + 3 * h * i
    lm_mm = h * dec.vocab_size
    prefill_flops = (2.0 * L_d * layer_mm * P * B
                     + 4.0 * L_d * P * P * nh * hd * B
                     + 2.0 * lm_mm * B)
    total_kv = -(-(P + max_new) // 128) * 128
    attn_positions = float(steps * total_kv)
    decode_flops = (steps * 2.0 * (L_d * layer_mm + lm_mm) * B
                    + 4.0 * L_d * attn_positions * nh * hd * B)

    # --- HBM traffic model -------------------------------------------------
    enc_bytes = _tree_bytes(engine.model.params["encoder"])
    dec_bytes = _tree_bytes(engine.model.params["decoder"])
    kv_row = 2 * L_d * nkv * hd * _dtype_bytes(engine.cache_dtype)
    kv_write = (P + steps) * B * kv_row
    kv_read = attn_positions * B * kv_row
    hbm = (enc_bytes + dec_bytes * (1 + steps)
           + kv_write + kv_read + B * n_samples * 2)

    return RooflineCost(
        flops=enc_flops + prefill_flops + decode_flops,
        hbm_bytes=hbm,
        detail={
            "encoder_flops": enc_flops, "prefill_flops": prefill_flops,
            "decode_flops": decode_flops,
            "weights_gb_per_dispatch": enc_bytes + dec_bytes * (1 + steps),
            "kv_gb_per_dispatch": kv_write + kv_read,
        })


def utilization(cost: RooflineCost, wall_s: float,
                peak_flops: float = H100_BF16_DENSE_FLOPS,
                peak_bytes_per_s: float = H100_HBM_BYTES_PER_S) -> dict:
    """The shares of the card's peaks a dispatch of ``cost`` reached in
    ``wall_s`` seconds: ``mfu`` (FLOP/s over the bf16 dense peak) and
    ``hbm_util`` (bytes/s over the HBM rate), as ``bench.py`` names them."""
    return {"mfu": cost.flops / wall_s / peak_flops,
            "hbm_util": cost.hbm_bytes / wall_s / peak_bytes_per_s}
