"""The weight-only quantized product of more than 16 rows (kernel C): a CUDA
kernel written by hand for Hopper (``csrc/qgemm.cu``), its plain PyTorch
versions, its launch plan and the wrapper.

No TPU kernel: JAX's ``qdot`` (``qwen3_asr_tpu/ops/quant.py:134-182``) runs
in XLA, which fuses the payload's widening and the scales into the dot. On
the card the prefill's and the encoder's products (hundreds of rows, and
decode steps of more than 16 rows) take this kernel where W8A8 does not
take them; it stands in for ``widened_product``, which wrote a bf16 copy
of the whole layer payload every call and ran cuBLAS on it, and which
cannot state int4's group scales without rounding ``q * s`` to bf16 or
materialising a partial product per group.

What it computes: ``out[m, n] = (sum_k x[m, k] * q[n, k]) * s[n]`` for an
int8 or ``float8_e4m3fn`` payload ``[N, K]`` (widened exactly) with N
scales, and ``out[m, n] = sum_g (sum_{k in g} x[m, k] * q[n, k]) * s[n, g]``
for int4 pairs ``[N, K/2]`` with ``[N, G]`` scales (``ops/qgemv.py``'s
layouts and rule for G); f32 sums, one rounding to ``out_dtype``: JAX's
rounding points. x is ``[M, K]`` bf16. ``qgemm_group`` takes up to three
payloads of one K that share x (q, k and v; gate and up) in one launch,
which also gives the card's SMs more blocks at the prompt's few hundred
rows.

What bounds it on the H100: at hundreds of rows, the tensor cores (w_down
at the 30 s prefill's 453 rows: 11.4 GFLOP against 12.6 MB of int8
payload). The design (``csrc/qgemm.cu``): one thread keeps TMA loads of
x (as it lies, 128-byte swizzle) and of the payload tile in flight
through a ring of stages; two consumer warpgroups each widen their 64
payload rows of a stage into a bf16 tile in shared memory and run
``wgmma`` with both operands from shared memory, two commit groups in
flight. ``qgemm_plan`` picks the block's x width (64, 128 or 256 rows) and
a split of K; the splits' f32 partials are added in split order by the
last block of each output tile (a ticket), inside the same launch: one
launch a call, the same bits every run.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch

from ._build import load
from .autograd import refuse_grad
from .decode_attention import _TICKETS, ticket_buffer
from .qgemv import (_OUT_CODE, _S_CODE, _SMS, _W_CODE, MAX_GROUP,
                    check_operands, int4_product)

TILE_N = 128                 # kBN in csrc/qgemm.cu: output columns a block
STEP_K = 64                  # kStep: payload bytes of a row a step
# kStages: the ring's depth at each x width (shared memory: a stage holds
# x's rows x 128 bytes and the 8 KB payload tile, beside four 8 KB
# widened tiles)
STAGES = {64: 8, 128: 6, 256: 4}
# The plan's estimate of a block's time on an H100 SXM (700 W), in ns by
# x width, fitted to the times of every grid at every QGEMM_SHAPES product
# but the lm_head, whose payload bytes bound it (``tools_perf/step_ms.py
# --mode qgemm --plans``; 4-8% median error): a step; a block's fixed
# cost (its first loads and its epilogue); with K split, writing a block's
# f32 partial (a wave's worth) and reading one split's in the combine.
STEP_NS = {64: 571, 128: 667, 256: 756}
BLOCK_NS = {64: 3003, 128: 3408, 256: 5201}
PART_NS = {64: 572, 128: 1589, 256: 4102}
COMBINE_NS = {64: 2199, 128: 2434, 256: 3062}


@dataclass(frozen=True)
class QgemmPlan:
    """Kernel C's grid for an [m, K] x [sum n, K] product. K runs in
    ``steps`` steps of 64 payload bytes (64 k; int4: each half of the row
    in turn, so a step is 64 k of the row's first or second half), cut
    into ``splits`` splits of ``per_split`` steps (the last may hold
    fewer). Output tiles are ``TILE_N`` columns (each payload's own, in
    order: ``tiles`` of them) by ``bm`` rows of x (``row_tiles``); block b
    takes row tile ``b % row_tiles`` of split ``(b // row_tiles) %
    splits`` of column tile ``b // (row_tiles * splits)``."""
    m: int
    bm: int
    tiles: int
    row_tiles: int
    steps: int
    splits: int
    per_split: int
    group_steps: int     # steps of one int4 scale group, or 1

    @property
    def stages(self) -> int:
        return STAGES[self.bm]

    @property
    def blocks(self) -> int:
        return self.tiles * self.row_tiles * self.splits

    @property
    def launches(self) -> int:
        """Launches a call: the splits' combine runs in the same one."""
        return 1

    @property
    def scratch(self) -> int:
        """f32 partials the kernel writes: one tile a block when split."""
        return self.blocks * TILE_N * self.bm if self.splits > 1 else 0

    @property
    def tickets(self) -> int:
        """Ticket slots it takes: one per output tile when K is split."""
        return self.tiles * self.row_tiles if self.splits > 1 else 0

    def split_range(self, split: int) -> Tuple[int, int]:
        """Steps [lo, hi) of one split."""
        lo = min(split * self.per_split, self.steps)
        return lo, min(lo + self.per_split, self.steps)

    def estimate_ns(self) -> int:
        """The plan's estimate: waves of one block an SM, each walking
        ``per_split`` steps after its fixed cost and, split, writing its
        partial; then the last block of a tile reads every split's."""
        block = self.per_split * STEP_NS[self.bm] + BLOCK_NS[self.bm]
        if self.splits == 1:
            return -(-self.blocks // _SMS) * block
        return (-(-self.blocks // _SMS) * (block + PART_NS[self.bm])
                + self.splits * COMBINE_NS[self.bm])


def qgemm_candidates(m: int, ns: Sequence[int], k: int,
                     w_dtype: torch.dtype, ngroups: int) -> List[QgemmPlan]:
    """Every grid the kernel takes for the product: each x width (64, 128
    or 256 rows; 64 or 128 for int4 with group scales, whose thread holds
    its group's sum beside the total) and each split of K in which
    every split has at least the ring's depth of steps and starts on an
    int4 group boundary (a split needs a ticket per output tile: at most
    the ticket buffer's)."""
    ns = list(ns)
    packed = w_dtype == torch.uint8
    if m <= 0 or k <= 0 or k % (32 if packed else 16) or ngroups <= 0 \
            or not 1 <= len(ns) <= MAX_GROUP or min(ns) <= 0:
        raise ValueError(f"qgemm_plan: m={m}, ns={ns}, k={k}, "
                         f"ngroups={ngroups} is not a product kernel C "
                         f"takes")
    half = -(-(k // 2 if packed else k) // STEP_K)
    steps = 2 * half if packed else half
    grouped = packed and ngroups > 1
    group_steps = k // ngroups // STEP_K if grouped else 1
    tiles = sum(-(-n // TILE_N) for n in ns)
    widths = (64, 128) if grouped else (64, 128, 256)
    plans = []
    for bm in widths:
        row_tiles = -(-m // bm)
        seen = set()
        for s in range(1, steps + 1):
            per = -(-steps // s)
            per = -(-per // group_steps) * group_steps
            splits = -(-steps // per)
            if splits in seen:
                continue
            if splits > 1 and (steps - (splits - 1) * per < STAGES[bm]
                               or tiles * row_tiles > _TICKETS):
                continue
            seen.add(splits)
            plans.append(QgemmPlan(m=m, bm=bm, tiles=tiles,
                                   row_tiles=row_tiles, steps=steps,
                                   splits=splits, per_split=per,
                                   group_steps=group_steps))
    return plans


def qgemm_plan(m: int, ns: Sequence[int], k: int, w_dtype: torch.dtype,
               ngroups: int = 1) -> QgemmPlan:
    """The grid for ``m`` rows of x, output widths ``ns`` (one payload, or
    each of a group) and contraction ``k``, for a payload of ``w_dtype``
    (``torch.uint8``: int4 pairs) with ``ngroups`` scale groups along K:
    of ``qgemm_candidates``, the one with the least estimated time
    (``QgemmPlan.estimate_ns``: waves of blocks times the steps a block
    walks, and the cost of the splits' partials), and of equals the fewest
    splits, then the widest x. So K is split where the output tiles alone
    leave SMs idle (enc wo and fc2 at 375 rows, w_down at 453), as far as
    the partials' traffic does not eat what the idle SMs gain."""
    return min(qgemm_candidates(m, ns, k, w_dtype, ngroups),
               key=lambda p: (p.estimate_ns(), p.splits, -p.bm))


def widened_product(x2: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                    out_dtype: torch.dtype) -> torch.Tensor:
    """Kernel C's plain version for int8/fp8, and the CPU's route for
    them: x2 [M, K] float, q [N, K], s [N] → [M, N] in ``out_dtype``. The
    payload widened to x2's dtype (exact), the product with an f32 result,
    then the scale, rounded once (JAX's ``quant.py:180-182``). A bf16 CUDA
    product takes cuBLAS with an f32 output; elsewhere both operands widen
    to f32, which is exact for bf16 values. ``cuda_calls`` counts its
    calls on a CUDA tensor, which the serving path never makes."""
    if x2.is_cuda:
        widened_product.cuda_calls += 1
    w = q.to(x2.dtype)
    if x2.is_cuda and x2.dtype == torch.bfloat16:
        acc = torch.mm(x2, w.t(), out_dtype=torch.float32)
    else:
        acc = x2.float() @ w.float().t()
    return (acc * s.reshape(1, -1).float()).to(out_dtype)


widened_product.cuda_calls = 0


def qgemm_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                out_dtype: torch.dtype) -> torch.Tensor:
    """The kernel's function in plain PyTorch: ``widened_product`` for
    int8/fp8, ``ops/qgemv.py`` ``int4_product`` (JAX's grouped product
    restated in f32) for int4 pairs."""
    if q.dtype == torch.uint8:
        return int4_product(x, q, s, out_dtype=out_dtype)
    return widened_product(x, q, s, out_dtype)


def _library() -> ctypes.CDLL:
    lib = load("qgemm")
    fn = lib.qgemm_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i, p, p, p, p, p, i, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _launch(x, pairs, out_dtype) -> List[torch.Tensor]:
    if not 1 <= len(pairs) <= MAX_GROUP:
        raise ValueError(f"qgemm takes 1..{MAX_GROUP} payloads, got "
                         f"{len(pairs)}")
    ngroups = check_operands("qgemm", x, pairs, out_dtype)
    m, k = x.shape
    dev = x.device
    p = qgemm_plan(m, [q.shape[0] for q, _ in pairs], k, pairs[0][0].dtype,
                   ngroups)
    outs = [torch.empty((m, q.shape[0]), dtype=out_dtype, device=dev)
            for q, _ in pairs]
    part = (torch.empty(p.scratch, dtype=torch.float32, device=dev)
            if p.scratch else None)
    tickets = ticket_buffer(dev, p.tickets) if p.tickets else None
    count = len(pairs)
    ptrs = ctypes.c_void_p * count
    qs = ptrs(*(q.data_ptr() for q, _ in pairs))
    ss = ptrs(*(s.data_ptr() for _, s in pairs))
    os_ = ptrs(*(o.data_ptr() for o in outs))
    ns = (ctypes.c_int * count)(*(q.shape[0] for q, _ in pairs))
    err = _library().qgemm_fwd(
        _W_CODE[pairs[0][0].dtype], _S_CODE[pairs[0][1].dtype],
        _OUT_CODE[out_dtype], count, x.data_ptr(), ctypes.addressof(qs),
        ctypes.addressof(ss), ctypes.addressof(os_), ctypes.addressof(ns),
        m, k, ngroups, p.bm, p.splits, p.per_split,
        0 if part is None else part.data_ptr(),
        0 if tickets is None else tickets.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qgemm kernel launch failed: CUDA error {err}")
    qgemm.launches += 1
    qgemm.last_plan = p
    return outs


def qgemm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
          out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ q[N, K].T * s[N] → [M, N] in ``out_dtype`` (int4: q
    [N, K/2] pairs, s [N, G]). A CUDA tensor launches the kernel or raises
    (``ops/qgemv.py`` ``check_operands``: bf16 x, the payload dtypes and
    int4 layouts the kernels take, contiguous operands); only a CPU
    tensor takes the plain version."""
    refuse_grad("qgemm", x, q, s)
    if x.device.type == "cpu":
        return qgemm_plain(x, q, s, out_dtype=out_dtype)
    return _launch(x, [(q, s)], out_dtype)[0]


def qgemm_group(x: torch.Tensor,
                pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                out_dtype: torch.dtype) -> List[torch.Tensor]:
    """``[qgemm(x, q, s) for q, s in pairs]`` in ONE launch on the card
    (1..3 payloads of one K, one payload dtype, scale dtype and group
    layout: q, k and v; gate and up); one plain version per payload on
    the CPU."""
    refuse_grad("qgemm_group", x, *(t for pair in pairs for t in pair))
    if x.device.type == "cpu":
        return [qgemm_plain(x, q, s, out_dtype=out_dtype) for q, s in pairs]
    return _launch(x, list(pairs), out_dtype)


qgemm.launches = 0
qgemm.last_plan = None       # the plan of the last launch, for the tools
