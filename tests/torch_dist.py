"""Spawned ``torch.distributed`` groups for the port's CPU tests.

``run_ranks(fn, world, tmp_path, *args)`` starts ``world`` processes
(spawn), joins them into a gloo group through a ``file://`` rendezvous
under ``tmp_path`` (so parallel test workers never share a port), runs
``fn(rank, world, *args)`` on each and returns the ranks' results in rank
order; ``start_ranks`` returns at once, and its ``join`` returns them, so
a test computes its JAX references while the ranks run. A rank's
exception fails the test with its traceback; ranks that have not finished
within ``timeout`` seconds (a deadlocked collective) are killed and the
test fails, so no test can hang the suite.

The rank functions below import the port only (no JAX): the tests compute
the JAX references in their own process and pass numpy arrays.
"""
from __future__ import annotations

import os
import pickle
import time
import traceback

import numpy as np
import torch
import torch.multiprocessing as mp

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")


def _entry(rank, fn, world, init_file, out_dir, args):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank)
    try:
        result, err = fn(rank, world, *args), None
    except Exception:  # reported by the parent
        result, err = None, traceback.format_exc()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((result, err), f)
    dist.destroy_process_group()


class Ranks:
    """``world`` spawned ranks running ``fn``; ``join`` waits for them (at
    most ``timeout`` seconds from the start) and returns their results."""

    def __init__(self, fn, world: int, tmp_path, args, timeout: float):
        self.name, self.world = fn.__name__, world
        self.out_dir = str(tmp_path / f"ranks_{fn.__name__}")
        os.makedirs(self.out_dir, exist_ok=True)
        init_file = os.path.join(self.out_dir, "rendezvous")
        self.deadline = time.monotonic() + timeout
        self.timeout = timeout
        self.ctx = mp.start_processes(
            _entry, args=(fn, world, init_file, self.out_dir, args),
            nprocs=world, join=False, start_method="spawn")

    def join(self) -> list:
        try:
            while not self.ctx.join(timeout=1.0):
                if time.monotonic() > self.deadline:
                    raise AssertionError(
                        f"{self.name}: {self.world} ranks did not finish "
                        f"within {self.timeout} s")
        finally:
            for p in self.ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join(5)
        results = []
        for rank in range(self.world):
            with open(os.path.join(self.out_dir, f"rank{rank}.pkl"),
                      "rb") as f:
                result, err = pickle.load(f)
            assert err is None, f"rank {rank}:\n{err}"
            results.append(result)
        return results


def start_ranks(fn, world: int, tmp_path, *args,
                timeout: float = 150.0) -> Ranks:
    return Ranks(fn, world, tmp_path, args, timeout)


def run_ranks(fn, world: int, tmp_path, *args, timeout: float = 150.0):
    return start_ranks(fn, world, tmp_path, *args, timeout=timeout).join()


# ---------------------------------------------------------------------------
# context parallelism


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


def cp_ranks(rank, world, cases):
    """Each case's ``context_parallel_attention`` over the group; then a
    backward through it, which must raise naming JAX's pmax."""
    from qwen3_asr_tpu_torch.ops.context_parallel import (
        context_parallel_attention)
    outs = []
    for c in cases:
        kw = dict(c["kw"])
        for name in ("kv_valid_from", "kv_valid_to"):
            kw[name] = _t(kw.get(name))
        outs.append(context_parallel_attention(
            _t(c["q"]), _t(c["k"]), _t(c["v"]), None, **kw).numpy())
    q, k, v = (_t(cases[0][n]).clone().requires_grad_() for n in "qkv")
    try:
        context_parallel_attention(q, k, v, None).sum().backward()
        refused = ""
    except NotImplementedError as e:
        refused = str(e)
    return outs, refused


# ---------------------------------------------------------------------------
# the dp x tp engine


def _ids(results):
    return [r.token_ids for r in results]


def engine_ranks(rank, world, ckpts, clips, dp, tp):
    """For each checkpoint: the unsharded port engine's tokens (a batch,
    one clip alone, a resume tick batch), then a dp×tp engine's on the
    same inputs; then the int8 engine that ``ASR_MESH_DP``/``ASR_MESH_TP``
    shard through ``load_engine``, against the unsharded int8 engine. The
    collectives the sharded engines called are counted."""
    from qwen3_asr_tpu_torch.parallel import collectives
    from qwen3_asr_tpu_torch.parallel.mesh import make_mesh
    from qwen3_asr_tpu_torch.runtime.engine import TranscriptionEngine
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    mesh = make_mesh(dp, tp, device_type="cpu")
    pairs = [(c, 16000) for c in clips]
    out = {}

    def run(eng):
        batch = _ids(eng.transcribe_batch(pairs, language="en"))
        solo = _ids(eng.transcribe(clips[0], 16000, language="en"))
        frames, bucket_s = eng.bucket_frames(len(clips[0]))
        _, ticks = eng._run_bucket([clips[0]] * 2, frames, bucket_s, "en",
                                   resume_rows=[solo[0], [3, 1, 4]])
        return batch, solo, ticks

    for ckpt in ckpts:
        plain = load_engine(ckpt, device="cpu")
        sharded = TranscriptionEngine(plain.model, device="cpu", mesh=mesh)
        before = collectives.calls()
        out[ckpt] = (run(plain), run(sharded),
                     collectives.calls() - before,
                     sharded.model.cfg.decoder.num_attention_heads)
    os.environ.update(QUANTIZE="int8", ASR_MESH_DP=str(dp),
                      ASR_MESH_TP=str(tp))
    sharded = load_engine(ckpts[0], device="cpu")
    for k in ("ASR_MESH_DP", "ASR_MESH_TP"):
        del os.environ[k]
    plain = load_engine(ckpts[0], device="cpu")
    del os.environ["QUANTIZE"]
    out["int8"] = (run(plain), run(sharded), sharded.mesh.shape)
    return out


# ---------------------------------------------------------------------------
# training under dp x tp, and the pipeline


def train_tp_ranks(rank, world, batch, dp, tp, steps=2):
    """``steps`` of ``make_train_step`` on trained_ckpt's weights under a
    dp×tp mesh, and the same steps unsharded on this rank; returns both
    losses and the largest gap between the gathered and the unsharded
    weights."""
    from qwen3_asr_tpu_torch.parallel.mesh import (gather_params, make_mesh,
                                                   shard_model)
    from qwen3_asr_tpu_torch.runtime.lifecycle import load_engine
    from qwen3_asr_tpu_torch.runtime.optim import (adamw, chain,
                                                   clip_by_global_norm,
                                                   tree_leaves)
    from qwen3_asr_tpu_torch.runtime.train import (init_train_state,
                                                   make_train_step)
    model = load_engine(CKPT, device="cpu").model
    mesh = make_mesh(dp, tp, device_type="cpu")
    shard = shard_model(model, mesh)
    runs = {}
    for name, cfg, params, m in (("plain", model.cfg, model.params, None),
                                 ("mesh", shard.cfg, shard.params, mesh)):
        opt = chain(clip_by_global_norm(0.5, mesh=m), adamw(1e-3))
        state = init_train_state(params, opt)
        step = make_train_step(cfg, opt, mesh=m)
        losses = []
        for _ in range(steps):
            state, loss = step(state, batch)
            losses.append(float(loss))
        runs[name] = (losses, state.params)
    full = gather_params(runs["mesh"][1], mesh)
    gap = max(float((a - b).abs().max())
              for a, b in zip(tree_leaves(full),
                              tree_leaves(runs["plain"][1])))
    return runs["plain"][0], runs["mesh"][0], gap


def pipeline_ranks(rank, world, p):
    """JAX's pipeline tests on the port, 4 ranks: hidden states at (pp,
    n_micro) (4, 2) and (2, 2); one pp=4 step's loss and wq; five dp2×pp2
    steps' losses; an int8 tree's pipelined forward."""
    from qwen3_asr_tpu_torch.models.config import AsrConfig
    from qwen3_asr_tpu_torch.ops.quant import quantize_params
    from qwen3_asr_tpu_torch.parallel.pipeline import (
        make_mesh_pp, make_pp_train_step, pipelined_decoder_hidden,
        shard_params_pp)
    from qwen3_asr_tpu_torch.runtime.checkpoint import params_from_jax
    from qwen3_asr_tpu_torch.runtime.optim import adamw
    from qwen3_asr_tpu_torch.runtime.train import init_train_state
    from qwen3_asr_tpu_torch.ops.qk_rope_kv import rms_norm
    cfg = AsrConfig.from_dict(p["config"])
    out = {}
    dec = params_from_jax(p["decoder"], "cpu")
    embeds, vf = torch.from_numpy(p["embeds"]), torch.from_numpy(p["vf"])
    meshes = {4: make_mesh_pp(pp=4, device_type="cpu"),
              2: make_mesh_pp(pp=2, device_type="cpu")}
    for pp in (4, 2):
        sharded = shard_params_pp({"decoder": dec}, meshes[pp])["decoder"]
        h = pipelined_decoder_hidden(cfg.decoder, sharded["layers"], embeds,
                                     vf, meshes[pp], 2)
        out[f"hidden_pp{pp}"] = rms_norm(h, sharded["final_norm"],
                                         cfg.decoder.rms_norm_eps).numpy()
    params = params_from_jax(p["params"], "cpu")
    state = init_train_state(shard_params_pp(params, meshes[4]), adamw(1e-3))
    step = make_pp_train_step(cfg, adamw(1e-3), meshes[4], n_micro=2)
    state, loss = step(state, p["batch"])
    out["step_loss"] = float(loss)
    out["step_wq"] = state.params["decoder"]["layers"]["wq"].numpy()
    params = params_from_jax(p["params2"], "cpu")
    state = init_train_state(shard_params_pp(params, meshes[2]), adamw(3e-3))
    step = make_pp_train_step(cfg, adamw(3e-3), meshes[2], n_micro=2)
    losses = []
    for _ in range(5):
        state, loss = step(state, p["batch2"])
        losses.append(float(loss))
    out["losses"] = losses
    q = shard_params_pp(quantize_params({"decoder": dec}, "int8"),
                        meshes[4])["decoder"]
    wq = q["layers"]["wq"]
    out["int8_shapes"] = (tuple(wq["q"].shape), tuple(wq["s"].shape))
    out["int8_hidden"] = pipelined_decoder_hidden(
        cfg.decoder, q["layers"], embeds, torch.zeros_like(vf), meshes[4],
        2).numpy()
    return out


def server_refusal(rank, world):
    """A server's manager under a group of more than one rank refuses,
    naming ROADMAP item 14b."""
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager
    try:
        ModelManager(device="cpu").start()
    except RuntimeError as e:
        return str(e)
    return ""


def all_ranks(rank, world, p):
    """The 4-rank checks of ``tests/test_torch_parallel.py`` in one group
    (one spawn): context parallelism, the dp2×tp2 engine, a dp2×tp2 train
    step, the pipeline, the server's refusal."""
    return {"server": server_refusal(rank, world),
            "cp": cp_ranks(rank, world, p["cp"]),
            "engine": engine_ranks(rank, world, p["ckpts"], p["clips"], 2, 2),
            "train": train_tp_ranks(rank, world, p["train_batch"], 2, 2),
            "pipeline": pipeline_ranks(rank, world, p["pipeline"])}


def finetune_ranks(rank, world, argv):
    """``tools/finetune.py`` under the group, as torchrun would run it."""
    from qwen3_asr_tpu_torch.tools.finetune import main
    return main(argv)
