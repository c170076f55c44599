"""Weight quantization: int8 / fp8 weight-only, and W8A8 for large products.

Counterpart of ``qwen3_asr_tpu/ops/quant.py``, selected by the same
``QUANTIZE`` variable ("", "int8", "fp8"). A quantized weight is a
``{"q": payload, "s": scales}`` leaf, as in the JAX package: int8 payloads
are ``torch.int8`` and fp8 payloads ``torch.float8_e4m3fn``, with symmetric
per-output-channel scales (absmax/127, absmax/448) in the source dtype.

One layout difference, on purpose: the port stores every payload as
``[..., out, in]`` (the contraction dim contiguous), transposed once at
quantization, because that is the layout the decode GEMV
(``ops/qgemv.py``) reads with wide coalesced loads; the tied embedding
``[V, H]`` already is. The scales keep the JAX package's shapes
(``[..., 1, out]`` for layers, ``[V, 1]`` per vocab row for the embedding).

``qdot`` has three routes, chosen by ``qdot_route``:

- decode rows (at most ``GEMV_MAX_ROWS``) of a CUDA tensor go to the
  hand-written GEMV (kernel A), which reads the low-precision payload; it
  takes bf16 activations, and other dtypes raise (the engine refuses
  quantized weights on the card at any other working dtype). ``qdot_group``
  sends the products of one x by up to three weights (q, k and v; gate
  and up) to one grouped launch;
- with ``ASR_INT8_ACT=true``, products of at least
  ``ASR_INT8_ACT_MIN_TOKENS`` rows (default 1024) against a 2-D int8
  weight quantize the activations per row (absmax/127, round half to
  even) and take an int8 x int8 -> int32 product (``torch._int_mm``: JAX
  takes this product in XLA, outside any Pallas kernel), then
  ``acc * xs * s``;
- everything else widens the payload to the working dtype (exact for int8
  and e4m3 into bf16 or f32), takes the product with an f32 result, and
  scales and rounds once, JAX's rounding points (``quant.py:180-182``):
  ``widened_product``.

``QUANTIZE=int4`` (grouped nibble weights) is not ported: ROADMAP §1
item 6.2.
"""
from __future__ import annotations

import os
from typing import Any, List, Sequence, Union

import torch

from .qgemv import GEMV_MAX_ROWS, qgemv, qgemv_group

# Weights worth quantizing (large matmul operands). Norms/biases stay put.
_DECODER_QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
_ENCODER_QUANT_KEYS = {"wq", "wk", "wv", "wo", "fc1_w", "fc2_w"}
MODES = ("int8", "fp8")


def check_mode(mode: str) -> None:
    """Raise for a mode the port does not take (int4: NotImplementedError;
    anything else: ValueError), both naming ROADMAP item 6."""
    if mode == "int4":
        raise NotImplementedError(
            "QUANTIZE=int4 (grouped nibble weights) is not ported: ROADMAP "
            "§1 item 6.2")
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}: the port "
                         f"takes {MODES} (ROADMAP §1 item 6)")


def check_quantized_dtype(device: torch.device, dtype: torch.dtype) -> None:
    """Quantized weights on the card need the bf16 working dtype: the GEMV
    that takes their decode rows reads bf16 activations, and there is no
    other route for those rows there."""
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(f"quantized weights on the card need the bf16 "
                         f"working dtype, got {dtype}")


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by IEEE division on every device, as JAX divides: PyTorch's
    CUDA kernel multiplies by ``1/c`` when ``c`` is a Python number, which
    can differ by an ulp. (A fill, not a host copy: graph-capture safe.)"""
    return x / torch.full_like(x, c)


def _quantize(wf: torch.Tensor, absmax: torch.Tensor, mode: str):
    if mode == "int8":
        scale = torch.clamp_min(div(absmax, 127.0), 1e-10)
        q = torch.clamp(torch.round(wf / scale), -128, 127).to(torch.int8)
    else:
        # e4m3 max normal = 448; a quotient a hair above it rounds to 448
        scale = torch.clamp_min(div(absmax, 448.0), 1e-10)
        q = (wf / scale).to(torch.float8_e4m3fn)
    return q.contiguous(), scale


def quantize_array(w: torch.Tensor, mode: str) -> dict:
    """Symmetric per-output-channel quantization of a ``[..., in, out]``
    weight. Returns ``{"q": [..., out, in], "s": [..., 1, out]}``, the
    scales in ``w``'s dtype."""
    check_mode(mode)
    wf = w.float()
    q, scale = _quantize(wf, wf.abs().amax(dim=-2, keepdim=True), mode)
    return {"q": q.transpose(-1, -2).contiguous(), "s": scale.to(w.dtype)}


def quantize_embed(w: torch.Tensor, mode: str) -> dict:
    """Per-vocab-row quantization of the ``[V, H]`` embedding: the row is
    the output channel of the tied lm_head. ``{"q": [V, H], "s": [V, 1]}``."""
    check_mode(mode)
    wf = w.float()
    q, scale = _quantize(wf, wf.abs().amax(dim=-1, keepdim=True), mode)
    return {"q": q, "s": scale.to(w.dtype)}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and set(w.keys()) == {"q", "s"}


def any_quantized(tree) -> bool:
    """Whether a parameter tree holds a quantized leaf."""
    if is_quantized(tree):
        return True
    return isinstance(tree, dict) and any(any_quantized(v)
                                          for v in tree.values())


def row_scales(w: dict) -> torch.Tensor:
    """The scales of a leaf as ``[..., out]``, one per payload row."""
    return w["s"].reshape(w["q"].shape[:-1])


def dequantize(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The leaf's weight in ``dtype``, in the PAYLOAD's layout
    (``[..., out, in]``)."""
    return (w["q"].float() * row_scales(w).float()[..., None]).to(dtype)


def layer_slice(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``params["layers"]`` (quantized leaves
    slice both payload and scales)."""
    return {k: ({"q": w["q"][i], "s": w["s"][i]} if is_quantized(w)
                else w[i]) for k, w in tree.items()}


def int8_act_min_rows() -> int:
    """``ASR_INT8_ACT_MIN_TOKENS`` (default 1024) when ``ASR_INT8_ACT=true``,
    else 0 (W8A8 off), read at every call as the JAX package reads it."""
    if os.getenv("ASR_INT8_ACT", "").lower() != "true":
        return 0
    return int(os.getenv("ASR_INT8_ACT_MIN_TOKENS", "1024"))


def qdot_route(rows: int, *, on_cuda: bool, x_dtype: torch.dtype,
               w_dtype: torch.dtype, w_ndim: int, min_rows: int) -> str:
    """Which route takes ``x @ w`` for a quantized ``w`` (see the module
    docstring): ``"gemv"``, ``"w8a8"`` or ``"dequant"``. ``rows`` is
    ``numel(x) / K``. On the card rows up to ``GEMV_MAX_ROWS`` never take
    W8A8 (cuBLAS's int8 product wants more than 16 rows): bf16 ones take
    the GEMV, so a threshold of 16 rows or fewer still leaves decode rows
    weight-only there. Decode rows of a CUDA tensor that is not bf16 have
    no kernel and raise ValueError."""
    if on_cuda and rows <= GEMV_MAX_ROWS:
        if x_dtype != torch.bfloat16:
            raise ValueError(f"the quantized GEMV takes bf16 activations, "
                             f"got {x_dtype}: quantized weights on the card "
                             f"need the bf16 working dtype")
        return "gemv"
    if (min_rows and w_dtype == torch.int8 and w_ndim == 2
            and x_dtype.is_floating_point and rows >= min_rows):
        return "w8a8"
    return "dequant"


def w8a8(x2: torch.Tensor, w: dict) -> torch.Tensor:
    """x2 [M, K] float → [M, N] in x2's dtype through int8 activations."""
    xf = x2.float()
    xs = torch.clamp_min(div(xf.abs().amax(dim=-1, keepdim=True), 127.0),
                         1e-10)
    xi = torch.clamp(torch.round(xf / xs), -128, 127).to(torch.int8)
    acc = torch._int_mm(xi, w["q"].t())          # exact int32
    out = acc.float() * xs * w["s"].reshape(1, -1).float()
    return out.to(x2.dtype)


def widened_product(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """The dequant route: x2 [M, K] float, q [N, K], s [N] → [M, N] in
    ``out_dtype``. The payload widened to x2's dtype (exact), the product
    with an f32 result, then the scale, rounded once. A bf16 CUDA product
    takes cuBLAS with an f32 output; elsewhere both operands widen to f32,
    which is exact for bf16 values."""
    w = q.to(x2.dtype)
    if x2.is_cuda and x2.dtype == torch.bfloat16:
        acc = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        acc = x2.float() @ w.float().t()
    return (acc * s.reshape(1, -1).float()).to(out_dtype)


def _route(x: torch.Tensor, w: dict, allow_w8a8: bool) -> str:
    q = w["q"]
    return qdot_route(x.numel() // q.shape[-1], on_cuda=x.is_cuda,
                      x_dtype=x.dtype, w_dtype=q.dtype, w_ndim=q.dim(),
                      min_rows=int8_act_min_rows() if allow_w8a8 else 0)


def _product(x: torch.Tensor, w: dict, out_dtype: torch.dtype,
             allow_w8a8: bool) -> torch.Tensor:
    q = w["q"]
    x2 = x.reshape(-1, q.shape[-1])
    route = _route(x, w, allow_w8a8)
    s = row_scales(w)
    if route == "gemv":
        out = qgemv(x2.contiguous(), q, s, out_dtype=out_dtype)
    elif route == "w8a8":
        out = w8a8(x2, w)
    else:
        out = widened_product(x2, q, s, out_dtype)
    return out.reshape(*x.shape[:-1], q.shape[-2])


def qdot(x: torch.Tensor, w: Union[torch.Tensor, dict]) -> torch.Tensor:
    """``x @ w`` for a plain ``[in, out]`` weight or a quantized leaf, in
    x's dtype."""
    if not is_quantized(w):
        return x @ w
    return _product(x, w, x.dtype, allow_w8a8=True)


def qdot_group(x: torch.Tensor,
               ws: Sequence[Union[torch.Tensor, dict]]) -> List[torch.Tensor]:
    """``[qdot(x, w) for w in ws]`` for up to three weights of one K
    (``qgemv.MAX_GROUP``). Where they are quantized leaves whose products
    take the GEMV route, the products are ONE launch of kernel A
    (``qgemv_group``: one payload and one scale dtype); otherwise (the CPU,
    prefill rows, plain weights) one product per weight, bit for bit what
    separate ``qdot`` calls give."""
    if all(map(is_quantized, ws)) and _route(x, ws[0], True) == "gemv":
        k = ws[0]["q"].shape[-1]
        outs = qgemv_group(x.reshape(-1, k).contiguous(),
                           [(w["q"], row_scales(w)) for w in ws],
                           out_dtype=x.dtype)
        return [o.reshape(*x.shape[:-1], w["q"].shape[-2])
                for o, w in zip(outs, ws)]
    return [qdot(x, w) for w in ws]


def qlogits(hidden: torch.Tensor, w: dict) -> torch.Tensor:
    """Logits in f32 against a quantized ``[V, H]`` leaf (the tied
    embedding, or the untied lm_head): ``(h @ q.T) * s``, never W8A8, no
    rounding (``qwen3_asr_tpu/models/decoder.py:388-414``)."""
    return _product(hidden, w, torch.float32, allow_w8a8=False)


def quantize_decoder_params(params: dict, mode: str,
                            include_embed: bool = True) -> dict:
    """Quantize the large decoder matmul weights; everything else unchanged."""
    out = dict(params)
    out["layers"] = {
        k: (quantize_array(v, mode) if k in _DECODER_QUANT_KEYS else v)
        for k, v in params["layers"].items()}
    if include_embed and not is_quantized(params["embed"]):
        out["embed"] = quantize_embed(params["embed"], mode)
        if "lm_head" in params and not is_quantized(params["lm_head"]):
            out["lm_head"] = quantize_array(params["lm_head"], mode)
    return out


def quantize_encoder_params(params: dict, mode: str) -> dict:
    out = dict(params)
    out["layers"] = {
        k: (quantize_array(v, mode) if k in _ENCODER_QUANT_KEYS else v)
        for k, v in params["layers"].items()}
    return out


def quantize_params(params: dict, mode: str) -> dict:
    """Quantize an {"encoder", "decoder"} bundle (QUANTIZE=int8|fp8).
    ``ASR_QUANTIZE_EMBED=false`` keeps the embedding and lm_head in full
    precision."""
    check_mode(mode)
    include_embed = os.getenv("ASR_QUANTIZE_EMBED",
                              "true").lower() != "false"
    out = dict(params)
    if "decoder" in params:
        out["decoder"] = quantize_decoder_params(params["decoder"], mode,
                                                 include_embed=include_embed)
    if "encoder" in params:
        out["encoder"] = quantize_encoder_params(params["encoder"], mode)
    return out


def param_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(param_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()
