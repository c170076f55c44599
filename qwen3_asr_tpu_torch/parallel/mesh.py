"""Data × tensor parallelism on ``torch.distributed``: the mesh, the
parameter specs, and a rank's shard of the weights.

Counterpart of ``qwen3_asr_tpu/parallel/mesh.py``. The mesh has dims
``("dp", "tp")`` over the process group's ranks (a ``DeviceMesh``: NCCL on
the card, gloo on the CPU). The specs are JAX's tables, entry for entry:

* decoder: q/k/v and gate/up sharded by output features (whole heads a
  rank, each KV head beside its query group, so attention needs no
  communication); wo and w_down by input features; the embedding by
  vocab rows, lm_head by vocab columns;
* encoder: the same pattern on its attention and FFN products, conv_out
  and proj1 by output features, proj2 by input features.

JAX places the shards and XLA inserts the collectives. The port's tensor
parallelism is explicit: ``shard_params`` gives a rank its slices (in the
port's payload layout for quantized leaves, ``[..., out, in]``), and
``shard_model`` gives it a model whose configs hold its local head and
feature counts and a ``TPShard`` (``parallel/collectives.py``), which the
layers read to call their collectives where XLA would: after wo, w_down,
fc2 and proj2 (``all_reduce``, with the biases of wo, fc2 and proj2 added
once after it), after the vocab-sharded lookup (a masked gather, then
``all_reduce``), and on the logits and conv_out's features
(``all_gather``, so greedy argmax keeps JAX's first-index tie rule).

One divergence, on purpose: JAX drops a spec whose axis does not divide
the dim (XLA then shards mid-head or replicates); the port's
head-parallel layers need whole heads, so ``check_layout`` refuses a tp
that does not divide the query and KV heads, the FFN width or the vocab
(ROADMAP §3).

The batch rides dp (``runtime/engine.py`` splits a request's rows over the
dp ranks, as JAX's ``batch_sharding`` places them).
"""
from __future__ import annotations

import copy
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..ops.qgemv import unpack_int4
from ..ops.quant import _pack, is_packed_int4, is_quantized
from .collectives import TPShard


class Mesh(NamedTuple):
    """A ``("dp", "tp")`` mesh over the process group, and this rank's
    coordinates on it."""
    device_mesh: object
    dp: int
    tp: int
    dp_rank: int
    tp_rank: int

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "tp": self.tp}

    @property
    def dp_group(self):
        return self.device_mesh.get_group("dp")

    @property
    def tp_group(self):
        return self.device_mesh.get_group("tp")

    def tp_shard(self) -> TPShard:
        return TPShard(self.tp_group, self.tp_rank, self.tp)


def init_from_env(device: torch.device) -> bool:
    """Join the process group that torchrun describes in the environment
    (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``): NCCL on the
    card (this rank's card is ``LOCAL_RANK``), gloo on the CPU. True when
    the process is in a group (it already was, or now is)."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    if device.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method="env://")
    return True


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None,
               cap: int = 8) -> tuple:
    """(dp, tp) over ``n`` ranks by JAX's rule: by default tp = min(cap, n),
    halved until it divides n, and dp the rest (the pipeline's pp takes
    cap 4)."""
    if tp is None and dp is None:
        tp = min(cap, n)
        while n % tp:
            tp //= 2
        dp = n // tp
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"a {dp}×{tp} mesh does not cover {n} ranks")
    return dp, tp


def make_mesh(dp: Optional[int] = None, tp: Optional[int] = None,
              device_type: str = "cuda") -> Mesh:
    """The mesh over the initialized process group's ranks (rank r at dp
    index r // tp, tp index r % tp). ``device_type`` "cuda" (NCCL) or
    "cpu" (gloo). Each group's communicator is made here, by one
    collective on it, so that a later CUDA graph capture finds it."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(torchrun, or init_process_group)")
    dp, tp = mesh_shape(dist.get_world_size(), dp, tp)
    dm = init_device_mesh(device_type, (dp, tp), mesh_dim_names=("dp", "tp"))
    mesh = Mesh(dm, dp, tp, dm.get_local_rank("dp"), dm.get_local_rank("tp"))
    dev = (torch.device("cuda", torch.cuda.current_device())
           if device_type == "cuda" else torch.device("cpu"))
    for group in (mesh.dp_group, mesh.tp_group):
        dist.all_reduce(torch.zeros(1, device=dev), group=group)
    return mesh


def decoder_param_specs() -> dict:
    """JAX's ``decoder_param_specs``: per leaf, the mesh axis of each dim
    of the JAX layout (``[L, in, out]`` products, ``[V, H]`` embedding,
    ``[H, V]`` lm_head)."""
    return {
        "embed": ("tp", None),
        "layers": {
            "ln1": (None, None), "ln2": (None, None),
            "wq": (None, None, "tp"), "wk": (None, None, "tp"),
            "wv": (None, None, "tp"), "wo": (None, "tp", None),
            "q_norm": (None, None), "k_norm": (None, None),
            "w_gate": (None, None, "tp"), "w_up": (None, None, "tp"),
            "w_down": (None, "tp", None),
        },
        "final_norm": (None,),
        "lm_head": (None, "tp"),
    }


def encoder_param_specs() -> dict:
    """JAX's ``encoder_param_specs``."""
    return {
        "conv1_w": (), "conv1_b": (), "conv2_w": (), "conv2_b": (),
        "conv3_w": (), "conv3_b": (),
        "conv_out_w": (None, "tp"),
        "layers": {
            "ln1_w": (None, None), "ln1_b": (None, None),
            "wq": (None, None, "tp"), "bq": (None, "tp"),
            "wk": (None, None, "tp"), "bk": (None, "tp"),
            "wv": (None, None, "tp"), "bv": (None, "tp"),
            "wo": (None, "tp", None), "bo": (None, None),
            "ln2_w": (None, None), "ln2_b": (None, None),
            "fc1_w": (None, None, "tp"), "fc1_b": (None, "tp"),
            "fc2_w": (None, "tp", None), "fc2_b": (None, None),
        },
        "ln_post_w": (None,), "ln_post_b": (None,),
        "proj1_w": (None, "tp"), "proj1_b": ("tp",),
        "proj2_w": ("tp", None), "proj2_b": (None,),
    }


def check_layout(cfg, tp: int) -> None:
    """Raise ValueError unless every dim the specs shard divides by ``tp``
    into whole heads: the query and KV heads and the FFN width of both
    towers, the vocab, the encoder's width."""
    dec, enc = cfg.decoder, cfg.encoder
    dims = {"decoder query heads": dec.num_attention_heads,
            "decoder KV heads": dec.num_key_value_heads,
            "decoder intermediate_size": dec.intermediate_size,
            "vocab_size": dec.vocab_size,
            "encoder heads": enc.encoder_attention_heads,
            "encoder_ffn_dim": enc.encoder_ffn_dim,
            "encoder d_model": enc.d_model}
    bad = [f"{k} {v}" for k, v in dims.items() if v % tp]
    if bad:
        raise ValueError(f"tensor parallelism over {tp} ranks needs whole "
                         f"heads and slices on every rank; not a multiple "
                         f"of {tp}: {', '.join(bad)}")


def _narrow(x: torch.Tensor, dim: int, rank: int, size: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not divide by "
                         f"{size}")
    return x.narrow(dim, rank * (n // size), n // size).contiguous()


def _shard_leaf(x, spec: tuple, rank: int, size: int, name: str):
    if "tp" not in spec:
        return x
    axis = spec.index("tp") - len(spec)          # from the end: -1, -2
    if not is_quantized(x):
        return _narrow(x, axis, rank, size)
    q, s = x["q"], x["s"]
    if name == "embed":                          # [V, H] rows, [V, 1]
        return {"q": _narrow(q, 0, rank, size), "s": _narrow(s, 0, rank, size)}
    if axis == -1:                               # output features
        return {"q": _narrow(q, -2, rank, size),
                "s": _narrow(s, -2 if is_packed_int4(x) else -1, rank, size)}
    # input features: the payload's contraction dim (int4 unpacked, sliced
    # and packed again, since a byte pairs k with k + K/2), and int4's
    # groups along it; int8/fp8 scales are per output channel
    if is_packed_int4(x):
        vals = _narrow(unpack_int4(q), -1, rank, size)
        return {"q": _pack(vals.to(torch.int32) + 8).contiguous(),
                "s": _narrow(s, -1, rank, size)}
    return {"q": _narrow(q, -1, rank, size), "s": s}


def _shard_tree(tree: dict, specs: dict, rank: int, size: int) -> dict:
    out = {}
    for k, v in tree.items():
        spec = specs.get(k, ())
        if isinstance(spec, dict):
            out[k] = _shard_tree(v, spec, rank, size)
        else:
            out[k] = _shard_leaf(v, spec, rank, size, k)
    return out


def shard_params(params: dict, mesh: Mesh) -> dict:
    """This rank's slices of an {"encoder", "decoder"} param tree (float
    or quantized leaves), by the specs."""
    out = dict(params)
    if "decoder" in params:
        out["decoder"] = _shard_tree(params["decoder"],
                                     decoder_param_specs(), mesh.tp_rank,
                                     mesh.tp)
    if "encoder" in params:
        out["encoder"] = _shard_tree(params["encoder"],
                                     encoder_param_specs(), mesh.tp_rank,
                                     mesh.tp)
    return out


def tp_sharded(params: dict) -> dict:
    """A tree of the params' structure (float leaves): True where the
    specs shard the leaf over tp."""
    specs = {"decoder": decoder_param_specs(),
             "encoder": encoder_param_specs()}

    def walk(tree, spec):
        return {k: (walk(v, spec.get(k, {})) if isinstance(v, dict)
                    else "tp" in spec.get(k, ()))
                for k, v in tree.items()}

    return walk(params, specs)


def gather_params(params: dict, mesh: Mesh) -> dict:
    """The whole float param tree from every tp rank's shard (the inverse
    of ``shard_params``), on every rank: what a sharded trainer saves."""
    specs = {"decoder": decoder_param_specs(),
             "encoder": encoder_param_specs()}

    def leaf(x, spec):
        if "tp" not in spec:
            return x
        axis = x.dim() + spec.index("tp") - len(spec)
        moved = x.movedim(axis, 0).contiguous()
        out = torch.empty((mesh.tp * moved.shape[0],) + tuple(moved.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, moved, group=mesh.tp_group)
        return out.movedim(0, axis).contiguous()

    def walk(tree, spec):
        return {k: (walk(v, spec.get(k, {})) if isinstance(v, dict)
                    else leaf(v, spec.get(k, ())))
                for k, v in tree.items()}

    return walk(params, specs)


def local_config(cfg, tp: TPShard):
    """The config a rank's shard runs with: the decoder's local query and
    KV heads and FFN width (the KV cache and every reshape follow them),
    and on both towers the ``TPShard``; the encoder keeps its global
    widths and splits its heads itself."""
    local = copy.copy(cfg)
    dec = copy.copy(cfg.decoder)
    dec.num_attention_heads //= tp.size
    dec.num_key_value_heads //= tp.size
    dec.intermediate_size //= tp.size
    dec.tp = tp
    enc = copy.copy(cfg.encoder)
    enc.tp = tp
    local.decoder, local.encoder = dec, enc
    return local


def shard_model(model, mesh: Mesh):
    """An ``AsrModel`` holding this rank's shard: ``shard_params``'
    weights and ``local_config``'s config (the same tokenizer and
    template)."""
    from ..models.asr import AsrModel
    check_layout(model.cfg, mesh.tp)
    sharded = AsrModel(local_config(model.cfg, mesh.tp_shard()),
                       shard_params(model.params, mesh), model.tokenizer,
                       model.template)
    sharded.eos_id, sharded.pad_id = model.eos_id, model.pad_id
    return sharded


def dp_rows(batch: int, mesh: Optional[Mesh]) -> Optional[slice]:
    """The rows of a batch this rank decodes: its dp slice where the batch
    divides by dp (JAX's ``batch_sharding``), else None (every rank runs
    every row, as JAX replicates a batch that does not divide)."""
    if mesh is None or batch % mesh.dp:
        return None
    per = batch // mesh.dp
    return slice(mesh.dp_rank * per, (mesh.dp_rank + 1) * per)


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every dp rank's rows of ``x`` [b, ...], in rank order."""
    out = torch.empty((mesh.dp * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, x.contiguous(), group=mesh.dp_group)
    return out
