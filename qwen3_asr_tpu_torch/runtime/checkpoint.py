"""Checkpoints: HF safetensors → the stacked-layer parameter dicts.

Counterpart of ``qwen3_asr_tpu/runtime/checkpoint.py`` (the naming and
transpose rules of ``convert_*_state_dict`` and ``load_safetensors_dir``)
with its own safetensors reader, so the port needs no ``safetensors``
package. Parameters are plain dicts of tensors with the JAX package's keys
and layouts (per-layer weights stacked on a leading ``[L, ...]`` axis,
matrices as ``[in, out]``), so ``params_from_jax`` is a straight copy
(quantized payloads are transposed to ``[..., out, in]``, ``ops/quant.py``).
``save_asr_checkpoint`` is the inverse (``qwen3_asr_tpu/runtime/checkpoint.py``
``save_asr_checkpoint``), through the port's own safetensors writer.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import struct
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import AsrConfig, AudioEncoderConfig, DecoderConfig

log = logging.getLogger(__name__)

_NP_DTYPES = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16,
              "F64": np.float64, "I64": np.int64, "I32": np.int32}


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """One .safetensors file → {name: array}. Layout: an 8-byte
    little-endian header length, a JSON header of {name: {dtype, shape,
    data_offsets}}, then the raw little-endian buffer. BF16 widens to f32."""
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack("<Q", buf[:8])
    header = json.loads(buf[8:8 + n])
    data = memoryview(buf)[8 + n:]
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        kind = info["dtype"]
        if kind not in _NP_DTYPES:
            raise ValueError(f"{name}: unsupported safetensors dtype {kind}")
        lo, hi = info["data_offsets"]
        arr = np.frombuffer(data[lo:hi], dtype=np.dtype(_NP_DTYPES[kind])
                            .newbyteorder("<")).reshape(info["shape"])
        if kind == "BF16":
            arr = (arr.astype(np.uint32) << 16).view(np.float32)
        out[name] = arr
    return out


def write_safetensors(path: str, tensors: Dict[str, np.ndarray]) -> None:
    """{name: f32 array} → one .safetensors file, the inverse of
    ``read_safetensors``: the JSON header (names in sorted order, padded
    with spaces to 8 bytes, as the safetensors package pads it), then each
    array's little-endian bytes, C-contiguous, back to back."""
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name], dtype="<f4")
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [offset, offset + arr.nbytes]}
        offset += arr.nbytes
        blobs.append(arr)
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for arr in blobs:
            f.write(arr.tobytes())


def load_safetensors_dir(path: str) -> Dict[str, np.ndarray]:
    """Read all *.safetensors shards in a checkpoint directory."""
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    sd: Dict[str, np.ndarray] = {}
    for f in files:
        sd.update(read_safetensors(os.path.join(path, f)))
    return sd


def _find_prefix(sd: Dict[str, np.ndarray], marker: str) -> str:
    """Key prefix of a submodule; prefers the thinker tower when a combined
    checkpoint holds several matches, and refuses to guess otherwise."""
    prefixes = {key[:idx] for key in sd if (idx := key.find(marker)) >= 0}
    if not prefixes:
        raise KeyError(f"no parameter key contains {marker!r}; keys like: "
                       f"{list(sd)[:5]}")
    if len(prefixes) == 1:
        return next(iter(prefixes))
    thinker = [p for p in prefixes if "thinker" in p]
    if len(thinker) == 1:
        return thinker[0]
    raise KeyError(f"marker {marker!r} matches multiple submodules "
                   f"{sorted(prefixes)}; pass prefix= explicitly")


def _stack(sd, pattern: str, n: int, transpose: bool) -> np.ndarray:
    return np.stack([sd[pattern.format(i=i)].T if transpose
                     else sd[pattern.format(i=i)] for i in range(n)])


def convert_decoder_state_dict(sd: Dict[str, np.ndarray], cfg: DecoderConfig,
                               prefix: Optional[str] = None
                               ) -> Dict[str, object]:
    """HF Qwen3ForCausalLM state dict → stacked decoder arrays (numpy)."""
    p = prefix if prefix is not None else _find_prefix(
        sd, "layers.0.mlp.gate_proj")
    lyr = p + "layers.{i}.{name}.weight"
    n = cfg.num_hidden_layers

    def stk(name, transpose=True):
        return _stack(sd, lyr.replace("{name}", name), n, transpose)

    params = {
        "embed": sd[p + "embed_tokens.weight"],
        "layers": {
            "ln1": stk("input_layernorm", False),
            "ln2": stk("post_attention_layernorm", False),
            "wq": stk("self_attn.q_proj"),
            "wk": stk("self_attn.k_proj"),
            "wv": stk("self_attn.v_proj"),
            "wo": stk("self_attn.o_proj"),
            "q_norm": stk("self_attn.q_norm", False),
            "k_norm": stk("self_attn.k_norm", False),
            "w_gate": stk("mlp.gate_proj"),
            "w_up": stk("mlp.up_proj"),
            "w_down": stk("mlp.down_proj"),
        },
        "final_norm": sd[p + "norm.weight"],
    }
    if not cfg.tie_word_embeddings:
        for cand in ("lm_head.weight", p.split("model.")[0] + "lm_head.weight"):
            if cand in sd:
                params["lm_head"] = sd[cand].T
                break
        else:
            raise KeyError("untied config but no lm_head.weight in checkpoint")
    return params


def convert_encoder_state_dict(sd: Dict[str, np.ndarray],
                               cfg: AudioEncoderConfig,
                               prefix: Optional[str] = None
                               ) -> Dict[str, object]:
    """HF Qwen3-Omni-style AuT audio tower state dict → stacked arrays.
    Conv weights stay OIHW, as ``torch.nn.functional.conv2d`` takes them."""
    p = prefix if prefix is not None else _find_prefix(sd, "conv2d1.weight")
    lyr = p + "layers.{i}.{name}.{kind}"
    n = cfg.encoder_layers

    def stk(name, kind="weight"):
        pat = lyr.replace("{name}", name).replace("{kind}", kind)
        return _stack(sd, pat, n, transpose=kind == "weight")

    return {
        "conv1_w": sd[p + "conv2d1.weight"], "conv1_b": sd[p + "conv2d1.bias"],
        "conv2_w": sd[p + "conv2d2.weight"], "conv2_b": sd[p + "conv2d2.bias"],
        "conv3_w": sd[p + "conv2d3.weight"], "conv3_b": sd[p + "conv2d3.bias"],
        "conv_out_w": sd[p + "conv_out.weight"].T,
        "layers": {
            "ln1_w": stk("self_attn_layer_norm"),
            "ln1_b": stk("self_attn_layer_norm", "bias"),
            "wq": stk("self_attn.q_proj"), "bq": stk("self_attn.q_proj", "bias"),
            "wk": stk("self_attn.k_proj"), "bk": stk("self_attn.k_proj", "bias"),
            "wv": stk("self_attn.v_proj"), "bv": stk("self_attn.v_proj", "bias"),
            "wo": stk("self_attn.out_proj"),
            "bo": stk("self_attn.out_proj", "bias"),
            "ln2_w": stk("final_layer_norm"),
            "ln2_b": stk("final_layer_norm", "bias"),
            "fc1_w": stk("fc1"), "fc1_b": stk("fc1", "bias"),
            "fc2_w": stk("fc2"), "fc2_b": stk("fc2", "bias"),
        },
        "ln_post_w": sd[p + "ln_post.weight"],
        "ln_post_b": sd[p + "ln_post.bias"],
        "proj1_w": sd[p + "proj1.weight"].T, "proj1_b": sd[p + "proj1.bias"],
        "proj2_w": sd[p + "proj2.weight"].T, "proj2_b": sd[p + "proj2.bias"],
    }


def to_torch(tree, device: torch.device, dtype: torch.dtype):
    """Nested dict of arrays → the same dict of contiguous tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device, dtype) for k, v in tree.items()}
    arr = np.array(tree, dtype=np.float32, order="C")  # writable copy
    return torch.from_numpy(arr).to(device=device, dtype=dtype)


def _exact_tensor(arr) -> torch.Tensor:
    """A numpy array → a tensor of the same dtype and bits: int8 as it is,
    ml_dtypes' float8_e4m3fn and bfloat16 through same-width integers."""
    arr = np.ascontiguousarray(arr)
    name = arr.dtype.name
    if name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr, order="C"))


def _quantized_to_torch(leaf: dict, device: torch.device,
                        transpose: bool) -> dict:
    """A JAX ``{"q", "s"}`` leaf → the port's: the payload's bits kept
    (never widened) and laid out ``[..., out, in]`` (the layer matrices
    and an untied lm_head are transposed, the ``[V, H]`` embedding is
    already so); the scales in their source dtype, an int4 leaf's
    ``[..., G, out]`` group scales transposed with its payload."""
    q = _exact_tensor(leaf["q"])
    s = _exact_tensor(leaf["s"])
    if transpose:
        if q.dtype == torch.uint8:
            # a clone: with one group the transposed scales count as
            # contiguous but keep their strides
            s = s.transpose(-1, -2).clone(
                memory_format=torch.contiguous_format)
        q = q.transpose(-1, -2).contiguous()
    return {"q": q.to(device), "s": s.to(device)}


def params_from_jax(tree_of_numpy: dict, device,
                    dtype: torch.dtype = torch.float32) -> dict:
    """The JAX package's params (``jax.device_get`` of the pytree, i.e.
    nested dicts of numpy arrays) → the port's params. Same keys and
    layouts; float leaves in ``dtype``, quantized leaves (``ops.quant``)
    bit for bit."""
    from ..ops.quant import is_quantized
    device = torch.device(device)

    def walk(tree, key=""):
        if is_quantized(tree):
            return _quantized_to_torch(tree, device, key != "embed")
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return to_torch(tree, device, dtype)

    return walk(tree_of_numpy)


def load_asr_checkpoint(path: str, device,
                        dtype: torch.dtype = torch.float32
                        ) -> Tuple[AsrConfig, dict]:
    """Local HF-format Qwen3-ASR checkpoint directory →
    (AsrConfig, {"encoder": ..., "decoder": ...}) on ``device``."""
    with open(os.path.join(path, "config.json")) as f:
        cfg = AsrConfig.from_dict(json.load(f))
    sd = load_safetensors_dir(path)
    tree = {"encoder": convert_encoder_state_dict(sd, cfg.encoder),
            "decoder": convert_decoder_state_dict(sd, cfg.decoder)}
    return cfg, to_torch(tree, torch.device(device), dtype)


def config_to_dict(cfg: AsrConfig) -> dict:
    """AsrConfig → HF-style config.json dict (AsrConfig.from_dict inverse)."""
    return {
        "model_type": "qwen3_asr",
        "audio_config": dataclasses.asdict(cfg.encoder),
        "text_config": dataclasses.asdict(cfg.decoder),
        "audio_token_id": cfg.audio_token_id,
        "bos_token_id": cfg.bos_token_id,
        "eos_token_id": cfg.eos_token_id,
        "pad_token_id": cfg.pad_token_id,
    }


_DECODER_LEAVES = [  # (stacked leaf, HF name, transposed back to [out, in])
    ("ln1", "input_layernorm.weight", False),
    ("ln2", "post_attention_layernorm.weight", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("wk", "self_attn.k_proj.weight", True),
    ("wv", "self_attn.v_proj.weight", True),
    ("wo", "self_attn.o_proj.weight", True),
    ("q_norm", "self_attn.q_norm.weight", False),
    ("k_norm", "self_attn.k_norm.weight", False),
    ("w_gate", "mlp.gate_proj.weight", True),
    ("w_up", "mlp.up_proj.weight", True),
    ("w_down", "mlp.down_proj.weight", True),
]
_ENCODER_LEAVES = [
    ("ln1_w", "self_attn_layer_norm.weight", False),
    ("ln1_b", "self_attn_layer_norm.bias", False),
    ("wq", "self_attn.q_proj.weight", True),
    ("bq", "self_attn.q_proj.bias", False),
    ("wk", "self_attn.k_proj.weight", True),
    ("bk", "self_attn.k_proj.bias", False),
    ("wv", "self_attn.v_proj.weight", True),
    ("bv", "self_attn.v_proj.bias", False),
    ("wo", "self_attn.out_proj.weight", True),
    ("bo", "self_attn.out_proj.bias", False),
    ("ln2_w", "final_layer_norm.weight", False),
    ("ln2_b", "final_layer_norm.bias", False),
    ("fc1_w", "fc1.weight", True),
    ("fc1_b", "fc1.bias", False),
    ("fc2_w", "fc2.weight", True),
    ("fc2_b", "fc2.bias", False),
]


def save_asr_checkpoint(path: str, cfg: AsrConfig, params: dict) -> str:
    """Inverse of :func:`load_asr_checkpoint`: the stacked-layer params
    written back as an HF-layout checkpoint directory (config.json +
    model.safetensors, per-layer tensors in torch's ``[out, in]``
    convention, f32 as the JAX package writes them), so ``MODEL_ID`` can
    point at what ``runtime/train.py`` produced. Quantized params are
    refused (save before quantizing)."""
    from ..ops.quant import any_quantized
    if any_quantized(params):
        raise ValueError("params contain quantized {'q','s'} leaves "
                         "(ops/quant.py) — save before quantizing")
    os.makedirs(path, exist_ok=True)

    def host(x) -> np.ndarray:
        return x.detach().to("cpu", torch.float32).numpy()

    dec, enc = params["decoder"], params["encoder"]
    sd: Dict[str, np.ndarray] = {}
    p = "model."
    sd[p + "embed_tokens.weight"] = host(dec["embed"])
    sd[p + "norm.weight"] = host(dec["final_norm"])
    if "lm_head" in dec:
        sd["lm_head.weight"] = host(dec["lm_head"]).T
    for i in range(cfg.decoder.num_hidden_layers):
        for leaf, name, t in _DECODER_LEAVES:
            a = host(dec["layers"][leaf][i])
            sd[f"{p}layers.{i}.{name}"] = a.T if t else a

    p = "audio_tower."
    for n in (1, 2, 3):
        sd[p + f"conv2d{n}.weight"] = host(enc[f"conv{n}_w"])
        sd[p + f"conv2d{n}.bias"] = host(enc[f"conv{n}_b"])
    sd[p + "conv_out.weight"] = host(enc["conv_out_w"]).T
    sd[p + "ln_post.weight"] = host(enc["ln_post_w"])
    sd[p + "ln_post.bias"] = host(enc["ln_post_b"])
    for n in (1, 2):
        sd[p + f"proj{n}.weight"] = host(enc[f"proj{n}_w"]).T
        sd[p + f"proj{n}.bias"] = host(enc[f"proj{n}_b"])
    for i in range(cfg.encoder.encoder_layers):
        for leaf, name, t in _ENCODER_LEAVES:
            a = host(enc["layers"][leaf][i])
            sd[p + f"layers.{i}.{name}"] = a.T if t else a

    write_safetensors(os.path.join(path, "model.safetensors"), sd)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)
    log.info("Checkpoint saved to %s (%d tensors)", path, len(sd))
    return path
