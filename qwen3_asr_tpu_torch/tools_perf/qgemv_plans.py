"""Kernel A's grid choices on the card: the plan ``ops/qgemv.py`` picks
against the alternatives it turned down, at the decoder's shapes.

For each preset:1.7b decoder projection (and its grouped launches, and the
tied lm_head) at 1 and 8 rows, int8, it times one call of the quantized
GEMV under:

- ``plan``: ``ops.qgemv.plan`` as it is;
- ``split_to_fill``: K split, from the fewest splits that leave a warp 4
  stretches, one more at a time while the grid has fewer blocks than the
  card has SMs and every warp keeps a stretch (the design that fills all
  132 SMs at every shape);
- ``split_4``: w_down's K cut into 4 stretches a warp (three splits, two
  fragment sets) instead of 12 (no split, one set);
- ``groups_half`` / ``groups_double``: half or twice the plan's column
  groups (more or fewer tiles a block).

Each call steps through the 28 layers of a stacked payload (one layer for
the lm_head), so each finds its layer cold, as the decode loop does.
Every variant's output is first held against the plan's within kernel
A's tolerance (a split changes the order of the sum).

Run on a machine with the card: ``python -m
qwen3_asr_tpu_torch.tools_perf.qgemv_plans``. It prints the card's line
and one line a shape and row count: device ms of each variant.
"""
from __future__ import annotations

import dataclasses
import subprocess
import sys
from typing import Callable, Dict, Optional

import torch

from ..ops import qgemv as mod
from ..ops.quant import quantize_array, quantize_embed, row_scales
from .attn_phase import device_ms

LAYERS = 28
SHAPES = (("wq_wo", 2048, (2048,)), ("wk_wv", 2048, (1024,)),
          ("down", 6144, (2048,)), ("qkv_group", 2048, (2048, 1024, 1024)),
          ("gate_up_group", 2048, (6144, 6144)),
          ("lm_head", 2048, (151936,)))


# the int8 payload's limits: the stretches a warp holds with two fragment
# sets, and with one
MAX_KS, LONG_KS = mod._MAX_KS[False], mod._LONG_KS[False]


def _split_to_fill(p: mod.Plan) -> Optional[mod.Plan]:
    least = -(-p.stretches // (mod._WARPS * MAX_KS))
    splits = least
    while (p.tiles * splits < mod._SMS
           and -(-p.stretches // (splits + 1)) >= mod._WARPS):
        splits += 1
    if splits == least:       # the plan's own, or split_4's
        return None
    per_split = -(-p.stretches // splits)
    kw = -(-per_split // mod._WARPS)
    return dataclasses.replace(p, splits=splits, per_split=per_split, kw=kw,
                               ks=1 if kw == 1 else 2 if kw == 2 else 4)


def _split_4(p: mod.Plan) -> Optional[mod.Plan]:
    if p.ks != LONG_KS:
        return None
    splits = -(-p.stretches // (mod._WARPS * MAX_KS))
    per_split = -(-p.stretches // splits)
    return dataclasses.replace(p, splits=splits, per_split=per_split,
                               kw=-(-per_split // mod._WARPS), ks=4)


VARIANTS: Dict[str, Callable[[mod.Plan], Optional[mod.Plan]]] = {
    "plan": lambda p: p,
    "split_to_fill": _split_to_fill,
    "split_4": _split_4,
    "groups_half": lambda p: (dataclasses.replace(p, groups=p.groups // 2)
                              if p.groups > 1 else None),
    "groups_double": lambda p: (dataclasses.replace(p, groups=2 * p.groups)
                                if 2 * p.groups <= p.tiles else None),
}


def _payloads(name, k, ns, dev):
    gen = torch.Generator(device=dev).manual_seed(k + sum(ns))
    pays = []
    for n in ns:
        if name == "lm_head":
            leaf = quantize_embed((torch.randn((n, k), generator=gen,
                                               device=dev) * 0.02
                                   ).bfloat16(), "int8")
            pays.append((leaf["q"][None], row_scales(leaf)[None]))
        else:
            leaf = quantize_array((torch.randn((LAYERS, k, n), generator=gen,
                                               device=dev) * 0.02
                                   ).bfloat16(), "int8")
            pays.append((leaf["q"], row_scales(leaf)))
    return pays, gen


def run():
    """Yield (shape label, {variant: device ms})."""
    dev = torch.device("cuda")
    planner = mod.plan
    try:
        for name, k, ns in SHAPES:
            pays, gen = _payloads(name, k, ns, dev)
            layers = 1 if name == "lm_head" else LAYERS
            out_dtype = torch.float32 if name == "lm_head" else torch.bfloat16
            for m in (1, 8):
                x = torch.randn((m, k), generator=gen, device=dev).bfloat16()

                def call(layer, x=x):
                    return mod.qgemv_group(
                        x, [(q[layer], s[layer]) for q, s in pays],
                        out_dtype=out_dtype)

                times, ref = {}, None
                for var, change in VARIANTS.items():
                    p = change(planner(m, list(ns), k))
                    if p is None:
                        continue
                    mod.plan = lambda *_, p=p: p
                    outs = call(layers - 1)
                    if ref is None:
                        ref = outs
                    for a, b in zip(outs, ref):
                        torch.testing.assert_close(
                            a.float(), b.float(), rtol=8e-3,
                            atol=1e-4 * float(b.float().abs().max()))
                    times[var] = device_ms(
                        lambda: [call(i) for i in range(layers)]) / layers
                    mod.plan = planner
                yield f"{name}_m{m}", times
            del pays
    finally:
        mod.plan = planner


def main() -> int:
    if not torch.cuda.is_available():
        print("qgemv_plans: no CUDA device is available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(f"device: {card}")
    for label, times in run():
        print(f"{label}: " + ", ".join(f"{v} {ms:.4f} ms"
                                       for v, ms in times.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
