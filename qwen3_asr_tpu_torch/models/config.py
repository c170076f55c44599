"""Model architecture configs (plain dataclasses, loadable from HF config.json).

Covers the Qwen3-ASR family: an AuT-style audio encoder (the Qwen3-Omni
audio tower design: conv2d×3 stride-2 downsampling + windowed-attention
transformer; see transformers qwen3_omni_moe configuration) feeding a Qwen3
text decoder (GQA + QK-norm + RoPE + SwiGLU).
"""
from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class AudioEncoderConfig:
    num_mel_bins: int = 128
    d_model: int = 1280
    encoder_layers: int = 32
    encoder_attention_heads: int = 20
    encoder_ffn_dim: int = 5120
    output_dim: int = 2048            # decoder hidden size
    downsample_hidden_size: int = 480
    n_window: int = 100               # mel frames per positional chunk
    n_window_infer: int = 400         # mel frames per attention block
    conv_chunksize: int = 500
    max_source_positions: int = 1500
    activation_function: str = "gelu"
    scale_embedding: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads

    @property
    def conv_out_dim(self) -> int:
        # freq axis after three stride-2 convs with padding 1
        f = self.num_mel_bins
        for _ in range(3):
            f = (f + 1) // 2
        return f * self.downsample_hidden_size


@dataclasses.dataclass
class DecoderConfig:
    vocab_size: int = 151936
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    attention_bias: bool = False
    max_position_embeddings: int = 32768


@dataclasses.dataclass
class AsrConfig:
    """Full ASR model: encoder + decoder + prompt wiring."""
    encoder: AudioEncoderConfig
    decoder: DecoderConfig
    audio_token_id: int = 151646        # placeholder replaced by audio embeds
    bos_token_id: int = 151643
    eos_token_id: int = 151645
    pad_token_id: int = 151643
    model_id: str = ""

    @staticmethod
    def from_dict(d: dict) -> "AsrConfig":
        # Qwen3-Omni-style checkpoints nest the audio/text configs under
        # "thinker_config" (transformers Qwen3OmniMoeConfig.sub_configs).
        if "thinker_config" in d and isinstance(d["thinker_config"], dict):
            inner = dict(d["thinker_config"])
            for k in ("audio_token_id", "bos_token_id", "eos_token_id",
                      "pad_token_id"):
                inner.setdefault(k, d[k]) if k in d else None
            d = inner
        enc_d = d.get("audio_config", d.get("audio_encoder_config", {}))
        dec_d = d.get("text_config", d.get("decoder_config", d))
        enc_fields = {f.name for f in dataclasses.fields(AudioEncoderConfig)}
        dec_fields = {f.name for f in dataclasses.fields(DecoderConfig)}
        enc = AudioEncoderConfig(**{k: v for k, v in enc_d.items() if k in enc_fields})
        dec = DecoderConfig(**{k: v for k, v in dec_d.items() if k in dec_fields})
        if "output_dim" not in enc_d:
            enc.output_dim = dec.hidden_size
        kwargs = {}
        for k in ("audio_token_id", "bos_token_id", "eos_token_id", "pad_token_id"):
            if k in d:
                kwargs[k] = d[k]
            elif k in dec_d:
                kwargs[k] = dec_d[k]
        return AsrConfig(encoder=enc, decoder=dec, **kwargs)

    @staticmethod
    def from_json(path: str) -> "AsrConfig":
        with open(path) as f:
            return AsrConfig.from_dict(json.load(f))


def preset(name: str) -> AsrConfig:
    """Built-in architecture presets for the Qwen3-ASR family.

    Sizes follow the Qwen3 dense family (0.6B / 1.7B) for the decoder and
    scaled AuT towers for the encoder. Real checkpoints override these via
    their config.json at load time.
    """
    name = name.lower()
    if "0.6b" in name:
        return AsrConfig(
            encoder=AudioEncoderConfig(
                d_model=1024, encoder_layers=24, encoder_attention_heads=16,
                encoder_ffn_dim=4096, output_dim=1024),
            decoder=DecoderConfig(
                hidden_size=1024, intermediate_size=3072,
                num_hidden_layers=28, num_attention_heads=16,
                num_key_value_heads=8, head_dim=128),
        )
    if "1.7b" in name:
        return AsrConfig(
            encoder=AudioEncoderConfig(
                d_model=1280, encoder_layers=32, encoder_attention_heads=20,
                encoder_ffn_dim=5120, output_dim=2048),
            decoder=DecoderConfig(
                hidden_size=2048, intermediate_size=6144,
                num_hidden_layers=28, num_attention_heads=16,
                num_key_value_heads=8, head_dim=128),
        )
    if "tiny" in name or "test" in name:
        return AsrConfig(
            encoder=AudioEncoderConfig(
                num_mel_bins=128, d_model=64, encoder_layers=2,
                encoder_attention_heads=4, encoder_ffn_dim=128,
                output_dim=64, downsample_hidden_size=32),
            decoder=DecoderConfig(
                vocab_size=512, hidden_size=64, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, head_dim=16),
            audio_token_id=500, bos_token_id=501, eos_token_id=502,
            pad_token_id=501,
        )
    raise ValueError(f"unknown preset: {name}")
