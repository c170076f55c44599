"""Weight quantization: int8 / fp8 / int4 weight-only, and W8A8 for large
products.

Counterpart of ``qwen3_asr_tpu/ops/quant.py``, selected by the same
``QUANTIZE`` variable ("", "int8", "fp8", "int4"). A quantized weight is a
``{"q": payload, "s": scales}`` leaf, as in the JAX package: int8 payloads
are ``torch.int8`` and fp8 payloads ``torch.float8_e4m3fn``, with symmetric
per-output-channel scales (absmax/127, absmax/448) in the source dtype;
int4 payloads are ``torch.uint8`` (which marks them, as in JAX), two
values a byte biased by 8, with symmetric scales (absmax/7) per output
channel and group of ``ASR_INT4_GROUP`` (default 128, lowered until it
divides K) along the contraction, in the source dtype.

One layout difference, on purpose: the port stores every payload as
``[..., out, in]`` (the contraction dim contiguous), transposed once at
quantization, because that is the layout the quantized kernels read with
wide coalesced loads; the tied embedding ``[V, H]`` already is. int4
payloads are ``[..., out, in/2]``: byte j of a row holds k = j (low
nibble) and k = j + K/2 (high nibble), JAX's pairing; their scales are
``[..., out, G]`` (JAX's ``[..., G, out]`` transposed), and the int4
embedding ``[V, H/2]`` with ``[V, 1]`` row scales is that layout with
G = 1, so embedding, lm_head and layers share it. int8/fp8 scales keep
the JAX package's shapes (``[..., 1, out]`` for layers, ``[V, 1]`` for the
embedding).

``qdot`` has four routes, chosen by ``qdot_route``:

- decode rows (at most ``GEMV_MAX_ROWS``) of a CUDA tensor go to the
  hand-written GEMV (kernel A, ``ops/qgemv.py``), which reads the
  low-precision payload; it takes bf16 activations, and other dtypes raise
  (the engine refuses quantized weights on the card at any other working
  dtype). ``qdot_group`` sends the products of one x by up to three
  weights (q, k and v; gate and up) to one grouped launch (of kernel A, or
  of kernel C below);
- with ``ASR_INT8_ACT=true``, products of at least
  ``ASR_INT8_ACT_MIN_TOKENS`` rows (default 1024) against a 2-D int8
  weight quantize the activations per row (absmax/127, round half to
  even) and take an int8 x int8 -> int32 product (``torch._int_mm``: JAX
  takes this product in XLA, outside any Pallas kernel), then
  ``acc * xs * s``; never int4 (JAX's condition is an int8 payload);
- every other product of more than ``GEMV_MAX_ROWS`` rows of a CUDA tensor
  takes the hand-written quantized GEMM (kernel C, ``ops/qgemm.py``),
  which reads the payload too (bf16 activations, or it raises);
- on the CPU, the plain versions: the payload widened to the working
  dtype (exact for int8 and e4m3 into bf16 or f32), the product with an
  f32 result, the scale, one rounding (``widened_product``); for int4,
  JAX's grouped product (``ops/qgemv.py`` ``int4_product``): each group's
  f32 sum times its scale, added over the groups, one rounding
  (``quant.py:163-182``).
"""
from __future__ import annotations

import os
from typing import Any, List, Sequence, Union

import torch

from .qgemm import qgemm, qgemm_group, qgemm_plain
from .qgemv import (GEMV_MAX_ROWS, contraction, int4_layout_error, qgemv,
                    qgemv_group, unpack_int4)

# Weights worth quantizing (large matmul operands). Norms/biases stay put.
_DECODER_QUANT_KEYS = {"wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"}
_ENCODER_QUANT_KEYS = {"wq", "wk", "wv", "wo", "fc1_w", "fc2_w"}
MODES = ("int8", "fp8", "int4")


def check_mode(mode: str) -> None:
    """Raise ValueError for a mode the port does not take."""
    if mode not in MODES:
        raise ValueError(f"unknown quantization mode {mode!r}: the port "
                         f"takes {MODES}")


def check_quantized_dtype(device: torch.device, dtype: torch.dtype) -> None:
    """Quantized weights on the card need the bf16 working dtype: the
    kernels that take their products (A and C) read bf16 activations, and
    there is no other route for those products there."""
    if device.type == "cuda" and dtype != torch.bfloat16:
        raise ValueError(f"quantized weights on the card need the bf16 "
                         f"working dtype, got {dtype}")


def check_int4_layouts(tree, device: torch.device) -> None:
    """On the card, raise ValueError naming every int4 leaf whose group
    layout kernels A and C do not take (``ops/qgemv.py``
    ``int4_layout_error``: K/2 and the group size multiples of 64, or one
    group), so a load is refused before the first request, not at its
    first product. The CPU's plain versions take any layout."""
    if device.type != "cuda":
        return
    bad = []

    def walk(t, path):
        if is_packed_int4(t):
            err = int4_layout_error(contraction(t["q"]), t["s"].shape[-1])
            if err:
                bad.append(f"{path}: {err}")
        elif isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}" if path else k)

    walk(tree, "")
    if bad:
        raise ValueError("QUANTIZE=int4 on the card: " + "; ".join(bad))


def int4_group() -> int:
    """``ASR_INT4_GROUP`` (default 128), read at every quantization as the
    JAX package reads it."""
    return int(os.getenv("ASR_INT4_GROUP", "128"))


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` by IEEE division on every device, as JAX divides: PyTorch's
    CUDA kernel multiplies by ``1/c`` when ``c`` is a Python number, which
    can differ by an ulp. (A fill, not a host copy: graph-capture safe.)"""
    return x / torch.full_like(x, c)


def _quantize(wf: torch.Tensor, absmax: torch.Tensor, mode: str):
    if mode == "int8":
        scale = torch.clamp_min(div(absmax, 127.0), 1e-10)
        q = torch.clamp(torch.round(wf / scale), -128, 127).to(torch.int8)
    elif mode == "int4":
        scale = torch.clamp_min(div(absmax, 7.0), 1e-10)
        q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int32) + 8
    else:
        # e4m3 max normal = 448; a quotient a hair above it rounds to 448
        scale = torch.clamp_min(div(absmax, 448.0), 1e-10)
        q = (wf / scale).to(torch.float8_e4m3fn)
    return q.contiguous(), scale


def _pack(q: torch.Tensor) -> torch.Tensor:
    """Biased int4 values [..., K] (int32, 0..15) → uint8 [..., K/2]: byte
    j holds k = j in its low nibble and k = j + K/2 in its high one."""
    half = q.shape[-1] // 2
    return (q[..., :half] | (q[..., half:] << 4)).to(torch.uint8)


def quantize_array(w: torch.Tensor, mode: str) -> dict:
    """Symmetric quantization of a ``[..., in, out]`` weight. int8/fp8:
    per output channel, ``{"q": [..., out, in], "s": [..., 1, out]}``.
    int4: per output channel and group of ``ASR_INT4_GROUP`` rows of
    ``in`` (lowered until it divides ``in``), ``{"q": uint8 [..., out,
    in/2], "s": [..., out, G]}``. The scales in ``w``'s dtype (computed,
    and applied, in f32)."""
    check_mode(mode)
    wf = w.float()
    if mode == "int4":
        k, n = w.shape[-2], w.shape[-1]
        if k % 2:
            raise ValueError(f"int4 packing needs an even contraction dim, "
                             f"got {k}")
        g = max(1, min(int4_group(), k))
        while k % g:
            g -= 1                       # the group must divide K
        grouped = wf.reshape(*w.shape[:-2], k // g, g, n)
        q, scale = _quantize(grouped, grouped.abs().amax(dim=-2,
                                                         keepdim=True), mode)
        # scale [..., G, 1, out]; q [..., G, g, out] → [..., out, K], paired
        q = q.reshape(*w.shape[:-2], k, n).transpose(-1, -2)
        # (a clone, not .contiguous(): with one group the transposed
        # scales count as contiguous but keep their strides)
        return {"q": _pack(q).contiguous(),
                "s": scale.squeeze(-2).to(w.dtype).transpose(-1, -2)
                .clone(memory_format=torch.contiguous_format)}
    q, scale = _quantize(wf, wf.abs().amax(dim=-2, keepdim=True), mode)
    return {"q": q.transpose(-1, -2).contiguous(), "s": scale.to(w.dtype)}


def quantize_embed(w: torch.Tensor, mode: str) -> dict:
    """Per-vocab-row quantization of the ``[V, H]`` embedding: the row is
    the output channel of the tied lm_head. ``{"q": [V, H], "s": [V, 1]}``;
    int4 packs along H (``[V, H/2]``), the layers' layout with G = 1."""
    check_mode(mode)
    wf = w.float()
    q, scale = _quantize(wf, wf.abs().amax(dim=-1, keepdim=True), mode)
    if mode == "int4":
        q = _pack(q)
    return {"q": q, "s": scale.to(w.dtype)}


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and set(w.keys()) == {"q", "s"}


def is_packed_int4(w: Any) -> bool:
    """Packed-nibble storage is marked by the uint8 payload dtype."""
    return is_quantized(w) and w["q"].dtype == torch.uint8


def any_quantized(tree) -> bool:
    """Whether a parameter tree holds a quantized leaf."""
    if is_quantized(tree):
        return True
    return isinstance(tree, dict) and any(any_quantized(v)
                                          for v in tree.values())


def row_scales(w: dict) -> torch.Tensor:
    """The scales of a leaf a payload row at a time: ``[..., out]`` for
    int8/fp8, ``[..., out, G]`` for int4 (its groups along the
    contraction)."""
    if is_packed_int4(w):
        return w["s"]
    return w["s"].reshape(w["q"].shape[:-1])


def dequantize(w: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """The leaf's weight in ``dtype``, in the PAYLOAD's layout
    (``[..., out, in]``): values times scales in f32, one rounding."""
    if is_packed_int4(w):
        q = unpack_int4(w["q"]).float()
        s = w["s"].float()
        groups = s.shape[-1]
        q = q.reshape(*q.shape[:-1], groups, q.shape[-1] // groups)
        return (q * s[..., None]).reshape(*q.shape[:-2], -1).to(dtype)
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
    docstring): ``"gemv"``, ``"w8a8"``, ``"gemm"`` or ``"dequant"`` (the
    CPU's plain versions). ``rows`` is ``numel(x) / K``. On the card rows
    up to ``GEMV_MAX_ROWS`` never take W8A8 (cuBLAS's int8 product wants
    more than 16 rows): bf16 ones take the GEMV, so a threshold of 16 rows
    or fewer still leaves decode rows weight-only there. W8A8 takes int8
    payloads only (never int4's uint8). A CUDA tensor that is not bf16 has
    no kernel on the GEMV or GEMM route and raises ValueError."""
    w8a8_ok = (min_rows and w_dtype == torch.int8 and w_ndim == 2
               and x_dtype.is_floating_point and rows >= min_rows)
    if on_cuda and (rows <= GEMV_MAX_ROWS or not w8a8_ok):
        if x_dtype != torch.bfloat16:
            raise ValueError(f"the quantized GEMV and GEMM take bf16 "
                             f"activations, got {x_dtype}: quantized weights "
                             f"on the card need the bf16 working dtype")
        return "gemv" if rows <= GEMV_MAX_ROWS else "gemm"
    return "w8a8" if w8a8_ok else "dequant"


def w8a8(x2: torch.Tensor, w: dict) -> torch.Tensor:
    """x2 [M, K] float → [M, N] in x2's dtype through int8 activations.
    ``calls`` counts its calls."""
    w8a8.calls += 1
    xf = x2.float()
    xs = torch.clamp_min(div(xf.abs().amax(dim=-1, keepdim=True), 127.0),
                         1e-10)
    xi = torch.clamp(torch.round(xf / xs), -128, 127).to(torch.int8)
    acc = torch._int_mm(xi, w["q"].t())          # exact int32
    out = acc.float() * xs * w["s"].reshape(1, -1).float()
    return out.to(x2.dtype)


w8a8.calls = 0


def _route(x: torch.Tensor, w: dict, allow_w8a8: bool) -> str:
    q = w["q"]
    return qdot_route(x.numel() // contraction(q), on_cuda=x.is_cuda,
                      x_dtype=x.dtype, w_dtype=q.dtype, w_ndim=q.dim(),
                      min_rows=int8_act_min_rows() if allow_w8a8 else 0)


def _product(x: torch.Tensor, w: dict, out_dtype: torch.dtype,
             allow_w8a8: bool) -> torch.Tensor:
    q = w["q"]
    x2 = x.reshape(-1, contraction(q))
    route = _route(x, w, allow_w8a8)
    s = row_scales(w)
    if route == "gemv":
        out = qgemv(x2.contiguous(), q, s, out_dtype=out_dtype)
    elif route == "w8a8":
        out = w8a8(x2, w)
    elif route == "gemm":
        out = qgemm(x2.contiguous(), q, s, out_dtype=out_dtype)
    else:
        out = qgemm_plain(x2, q, s, out_dtype=out_dtype)
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
    take the GEMV or the GEMM route, the products are ONE launch of kernel
    A or C (``qgemv_group``, ``qgemm_group``: one payload and one scale
    dtype); otherwise (the CPU, W8A8 rows, plain weights) one product per
    weight, bit for bit what separate ``qdot`` calls give."""
    route = _route(x, ws[0], True) if all(map(is_quantized, ws)) else None
    if route in ("gemv", "gemm"):
        k = contraction(ws[0]["q"])
        launch = qgemv_group if route == "gemv" else qgemm_group
        outs = launch(x.reshape(-1, k).contiguous(),
                      [(w["q"], row_scales(w)) for w in ws],
                      out_dtype=x.dtype)
        return [o.reshape(*x.shape[:-1], w["q"].shape[-2])
                for o, w in zip(outs, ws)]
    return [qdot(x, w) for w in ws]


def qlogits(hidden: torch.Tensor, w: dict) -> torch.Tensor:
    """Logits in f32 against a quantized ``[V, H]`` leaf (the tied
    embedding, or the untied lm_head; int4: ``[V, H/2]`` pairs with row or
    group scales): ``(h @ q.T) * s``, never W8A8, no rounding
    (``qwen3_asr_tpu/models/decoder.py:388-414``)."""
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
    """Quantize an {"encoder", "decoder"} bundle (QUANTIZE=int8|fp8|int4).
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


def param_leaves(tree) -> list:
    """The tensors of a parameter tree."""
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in param_leaves(v)]
    return [tree]


def param_count(tree) -> int:
    """Parameters as JAX's ``/health`` counts them (``model_params_m``:
    every leaf's elements, a packed int4 payload two a byte)."""
    if is_packed_int4(tree):
        return tree["q"].numel() * 2 + tree["s"].numel()
    if isinstance(tree, dict):
        return sum(param_count(v) for v in tree.values())
    return tree.numel()
