"""Pipeline parallelism over the decoder's layer stack (dp × pp), a GPipe
schedule on ``torch.distributed``.

Counterpart of ``qwen3_asr_tpu/parallel/pipeline.py``. The decoder's
stacked ``[L, ...]`` leaves shard their layer axis over pp: stage s holds
layers ``[s·L/pp, (s+1)·L/pp)`` and everything else is replicated
(``shard_params_pp``). ``pipelined_decoder_hidden`` runs a microbatch
schedule of ``n_micro + pp − 1`` ticks: at tick t stage s runs microbatch
t − s through its layers (the training forward, cache-free:
``models/decoder.py`` ``_layer``), receives it and its ``valid_from`` from
stage s − 1 and sends both to stage s + 1 (``dist.send``/``recv``, JAX's
``ppermute``); the last stage's outputs are broadcast to every stage, as
JAX's psum does. The batch's rows ride dp: each dp rank takes its slice of
every microbatch, and the rows are gathered at the end.

Autograd does not cross ``send``/``recv``, so training (``asr_loss_pp``'s
gradient in ``make_pp_train_step``) runs a backward schedule of its own:
each stage keeps every microbatch's input (a leaf) and output, the loss
(replicated on every rank) gives the gradient of the gathered hidden
states, and in reverse microbatch order each stage calls
``torch.autograd.backward`` on its output, sends its input's gradient to
stage s − 1 and receives its output's from stage s + 1. Each stage's layer
gradients land on that stage (summed over dp); stage 0's input gradients,
gathered over dp and broadcast over pp, then flow back into the replicated
encoder and embedding on every rank, so their gradients agree everywhere.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.decoder import _layer, embed_tokens, lm_logits, rope_cos_sin
from ..models.encoder import encoder_forward
from ..ops.attention import AttnSpec
from ..ops.qk_rope_kv import rms_norm
from ..ops.quant import is_quantized
from ..runtime.optim import apply_updates, tree_leaves, tree_map
from ..runtime.train import TrainState, batch_to
from .mesh import dp_rows, gather_rows, mesh_shape


class PipeMesh(NamedTuple):
    """A ``("dp", "pp")`` mesh over the process group, and this rank's
    coordinates on it."""
    device_mesh: object
    dp: int
    pp: int
    dp_rank: int
    pp_rank: int

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "pp": self.pp}

    @property
    def dp_group(self):
        return self.device_mesh.get_group("dp")

    @property
    def pp_group(self):
        return self.device_mesh.get_group("pp")

    def pp_peer(self, stage: int) -> int:
        """The global rank of ``stage`` in this rank's pipeline."""
        return dist.get_global_rank(self.pp_group, stage)


def make_mesh_pp(dp: Optional[int] = None, pp: Optional[int] = None,
                 device_type: str = "cuda") -> PipeMesh:
    """The ``("dp", "pp")`` mesh over the process group's ranks by JAX's
    rule: by default pp = min(4, n), halved until it divides n, dp the
    rest."""
    from torch.distributed.device_mesh import init_device_mesh
    dp, pp = mesh_shape(dist.get_world_size(), dp, pp, cap=4)
    dm = init_device_mesh(device_type, (dp, pp), mesh_dim_names=("dp", "pp"))
    return PipeMesh(dm, dp, pp, dm.get_local_rank("dp"),
                    dm.get_local_rank("pp"))


LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "q_norm", "k_norm",
              "w_gate", "w_up", "w_down")


def decoder_param_specs_pp() -> dict:
    """JAX's ``decoder_param_specs_pp``: the layer stacks' axis 0 on pp,
    everything else replicated."""
    return {"embed": (), "layers": {k: ("pp",) for k in LAYER_KEYS},
            "final_norm": (), "lm_head": ()}


def shard_params_pp(params: dict, mesh: PipeMesh) -> dict:
    """This stage's layers of an {"encoder", "decoder"} tree: each decoder
    layer leaf's contiguous ``L/pp`` slice (a quantized leaf's payload and
    scales both); everything else as it is."""
    pp, s = mesh.pp, mesh.pp_rank

    def lead(x) -> int:
        return (x["q"] if is_quantized(x) else x).shape[0]

    def take(x):
        if is_quantized(x):
            return {"q": take(x["q"]), "s": take(x["s"])}
        n = x.shape[0] // pp
        return x[s * n:(s + 1) * n].contiguous()

    layers = params["decoder"]["layers"]
    counts = sorted({lead(x) for x in layers.values()})
    if any(n % pp for n in counts):
        raise ValueError(f"decoder layer count {counts} not divisible by "
                         f"pp={pp}: pipeline stages must hold equal layer "
                         f"slices")
    out = dict(params)
    out["decoder"] = dict(params["decoder"])
    out["decoder"]["layers"] = {k: take(v) for k, v in layers.items()}
    return out


def _stage(cfg, layers: dict, x: torch.Tensor, vf: torch.Tensor,
           cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """This stage's layers on one microbatch, the training forward."""
    n = layers["ln1"].shape[0]        # a norm: never quantized
    spec = AttnSpec(causal=True, valid_from=vf)
    b = x.shape[0]
    c, s = (x.expand(b, -1, -1).contiguous() for x in (cos, sin))
    for i in range(n):
        x = _layer(cfg, x, {"layers": layers}, i, c, s, None, 0, spec)
    return x


def _send(x: torch.Tensor, mesh: PipeMesh, stage: int) -> None:
    dist.send(x.contiguous(), dst=mesh.pp_peer(stage), group=mesh.pp_group)


def _recv(like: torch.Tensor, mesh: PipeMesh, stage: int) -> torch.Tensor:
    x = torch.empty_like(like)
    dist.recv(x, src=mesh.pp_peer(stage), group=mesh.pp_group)
    return x


def _dp_slice(x: torch.Tensor, mesh: PipeMesh) -> torch.Tensor:
    return x[dp_rows(x.shape[0], mesh)]


class _Schedule:
    """One forward of the GPipe schedule on this rank: every microbatch's
    stage input (a leaf that keeps its gradient) and output."""

    def __init__(self, cfg, layers, inputs, valid_from, mesh, n_micro):
        b, t, _ = inputs.shape
        if b % n_micro or (b // n_micro) % mesh.dp:
            raise ValueError(f"batch {b} must divide by n_micro {n_micro} "
                             f"and each microbatch by dp {mesh.dp}")
        self.mesh, self.n_micro = mesh, n_micro
        mb = b // n_micro
        cos, sin = rope_cos_sin(torch.arange(t, device=inputs.device)[None],
                                cfg.head_dim, cfg.rope_theta)
        last = mesh.pp - 1
        s = mesh.pp_rank
        self.xs: List[torch.Tensor] = []
        self.ys: List[torch.Tensor] = []
        for tick in range(n_micro + mesh.pp - 1):
            m = tick - s
            if not 0 <= m < n_micro:
                continue
            rows = slice(m * mb, (m + 1) * mb)
            if s == 0:
                x = _dp_slice(inputs[rows], mesh)
                vf = _dp_slice(valid_from[rows], mesh)
            else:
                like = _dp_slice(inputs[rows], mesh)
                x = _recv(like, mesh, s - 1)
                vf = _recv(_dp_slice(valid_from[rows], mesh), mesh, s - 1)
            x = x.detach().requires_grad_(torch.is_grad_enabled())
            y = _stage(cfg, layers, x, vf, cos, sin)
            if s < last:
                _send(y.detach(), mesh, s + 1)
                _send(vf, mesh, s + 1)
            self.xs.append(x)
            self.ys.append(y)
        # the last stage's outputs, to every stage (JAX's psum), then the
        # dp ranks' rows of each microbatch together
        hid = (torch.stack([y.detach() for y in self.ys]) if s == last else
               torch.empty((n_micro,) + tuple(_dp_slice(
                   inputs[:mb], mesh).shape), dtype=inputs.dtype,
                   device=inputs.device))
        dist.broadcast(hid, src=mesh.pp_peer(last), group=mesh.pp_group)
        self.hidden = torch.stack([gather_rows(h, mesh) for h in hid]
                                  ).reshape(b, t, -1)

    def backward(self, d_hidden: torch.Tensor) -> torch.Tensor:
        """Run the backward schedule from the gradient of ``hidden`` (the
        whole batch's, as every rank has it); returns the gradient of the
        inputs, the whole batch's, on every rank."""
        mesh, n_micro = self.mesh, self.n_micro
        s, last = mesh.pp_rank, mesh.pp - 1
        b = d_hidden.shape[0]
        mb = b // n_micro
        dx = [None] * n_micro
        for m in reversed(range(n_micro)):
            y = self.ys[m]
            if s == last:
                g = _dp_slice(d_hidden[m * mb:(m + 1) * mb], mesh)
            else:
                g = _recv(y.detach(), mesh, s + 1)
            torch.autograd.backward(y, g)
            dx[m] = self.xs[m].grad
            if s > 0:
                _send(dx[m], mesh, s - 1)
        d_in = (torch.stack(dx) if s == 0 else
                torch.empty((n_micro,) + tuple(self.xs[0].shape),
                            dtype=self.xs[0].dtype,
                            device=self.xs[0].device))
        dist.broadcast(d_in, src=mesh.pp_peer(0), group=mesh.pp_group)
        return torch.stack([gather_rows(d, mesh) for d in d_in]
                           ).reshape(d_hidden.shape)


def pipelined_decoder_hidden(cfg, layers: dict, inputs_embeds: torch.Tensor,
                             valid_from: torch.Tensor, mesh: PipeMesh,
                             n_micro: int) -> torch.Tensor:
    """The decoder's layer stack as a GPipe pipeline over pp. inputs_embeds
    [B, T, H] (positions 0..T−1 on every row, the training layout) and
    valid_from [B], the same on every rank; ``layers`` this stage's
    (``shard_params_pp``). Returns the pre-final-norm hidden states
    [B, T, H] on every rank. B must divide by n_micro, and B / n_micro by
    dp."""
    with torch.no_grad():
        return _Schedule(cfg, layers, inputs_embeds,
                         valid_from.to(torch.int32), mesh, n_micro).hidden


def _inputs(params: dict, cfg, mel, feature_lens, prompt_ids, target_ids):
    dec = cfg.decoder
    audio, _ = encoder_forward(params["encoder"], cfg.encoder,
                               mel.to(params["encoder"]["conv1_w"].dtype),
                               feature_lens)
    pre = embed_tokens(params["decoder"], prompt_ids.long(), dec)
    tgt = embed_tokens(params["decoder"], target_ids.long(), dec)
    return torch.cat([pre, audio.to(pre.dtype), tgt], dim=1)


def _head_loss(params: dict, cfg, hidden, target_ids, target_mask):
    dec = cfg.decoder
    hidden = rms_norm(hidden, params["decoder"]["final_norm"],
                      dec.rms_norm_eps)
    tgt_start = hidden.shape[1] - target_ids.shape[1]
    logits = lm_logits(params["decoder"], dec, hidden[:, tgt_start - 1:-1])
    logp = F.log_softmax(logits, dim=-1)
    token_logp = logp.gather(-1, target_ids.long()[..., None])[..., 0]
    mask_f = target_mask.float()
    return -(token_logp * mask_f).sum() / torch.clamp(mask_f.sum(), min=1.0)


def asr_loss_pp(params: dict, cfg, mel, feature_lens, prompt_ids,
                target_ids, target_mask, mesh: PipeMesh,
                n_micro: int) -> torch.Tensor:
    """``runtime/train.py`` ``asr_loss`` with the decoder's layer stack
    pipelined (prompts right-aligned: valid_from 0), forward only; the
    same on every rank."""
    with torch.no_grad():
        inputs = _inputs(params, cfg, mel, feature_lens, prompt_ids,
                         target_ids)
        b = inputs.shape[0]
        hidden = pipelined_decoder_hidden(
            cfg.decoder, params["decoder"]["layers"], inputs,
            torch.zeros((b,), dtype=torch.int32, device=inputs.device),
            mesh, n_micro)
        return _head_loss(params, cfg, hidden, target_ids, target_mask)


def pp_value_and_grad(params: dict, cfg, batch: dict, mesh: PipeMesh,
                      n_micro: int):
    """(loss, gradients) of ``asr_loss_pp`` through the forward and
    backward schedules: the gradients have the params' structure (this
    stage's layers), the same loss on every rank."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    tracked = tree_map(lambda _: next(it), params)
    dev = leaves[0].device
    with torch.enable_grad():
        inputs = _inputs(tracked, cfg, batch["mel"], batch["feature_lens"],
                         batch["prompt_ids"], batch["target_ids"])
        b = inputs.shape[0]
        sched = _Schedule(cfg.decoder, tracked["decoder"]["layers"],
                          inputs.detach(),
                          torch.zeros((b,), dtype=torch.int32, device=dev),
                          mesh, n_micro)
        hidden = sched.hidden.detach().requires_grad_(True)
        loss = _head_loss(tracked, cfg, hidden, batch["target_ids"],
                          batch["target_mask"])
        loss.backward()
        d_inputs = sched.backward(hidden.grad)
        torch.autograd.backward(inputs, d_inputs)
    layer_leaves = {id(x) for x in tree_leaves(tracked["decoder"]["layers"])}
    grads = []
    for p in leaves:
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        if id(p) in layer_leaves:
            # this stage's layers saw only its dp rows
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=mesh.dp_group)
        grads.append(g)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_pp_train_step(cfg, optimizer, mesh: PipeMesh,
                       n_micro: int) -> Callable:
    """(state, batch) → (state, loss) with the decoder's layers pipelined:
    each stage updates its own layers and its copy of the replicated
    weights (the same update on every stage)."""

    def step(state: TrainState, batch: dict):
        dev = tree_leaves(state.params)[0].device
        loss, grads = pp_value_and_grad(state.params, cfg,
                                        batch_to(batch, dev), mesh, n_micro)
        updates, opt_state = optimizer.update(grads, state.opt_state,
                                              state.params)
        params = apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step
