"""The weight-only quantized product of decode rows: a CUDA kernel written by
hand for Hopper (``csrc/qgemv.cu``), its plain PyTorch version, its plan,
and the wrappers.

No TPU kernel: JAX's ``qdot`` (``qwen3_asr_tpu/ops/quant.py:134-182``) runs
in XLA, which fuses the payload's widening and the scale into the dot. On
the card the decode step's products must read the int8/fp8 payload itself:
a bf16 copy widened every step would read more bytes than bf16 weights do.

What it computes: ``out[m, n] = (sum_k x[m, k] * q[n, k]) * s[n]``, the
payload widened exactly, the sum in f32, rounded once to ``out_dtype``
(x's dtype for a layer, f32 for the logits): JAX's rounding points. ``x``
is ``[M, K]`` bf16 with M <= ``GEMV_MAX_ROWS``; ``q`` is ``[N, K]`` int8 or
``float8_e4m3fn`` (the contraction dim contiguous, ``ops/quant.py``'s
layout); ``s`` holds N scales, f32 or bf16. ``qgemv_group`` takes up to
three payloads of one K that share x (q, k and v; gate and up) in one
launch and returns one output each.

What bounds it on the H100: the payload's bytes, N*K once. The design
(``csrc/qgemv.cu``): tensor cores (``mma.sync``, the widened payload as
the A operand, x as B), k permuted inside each 64-k stretch so a lane's
16-byte payload load and 32-byte x load feed its fragments directly;
blocks of 8 warps, each warp holding x for its part of the block's K slice
in registers while it walks the block's column tiles; K split across
blocks only where a warp cannot hold its share of x, the splits added in
a fixed order by the last block of a column group (a ticket), so the
output is the same bits on every run. ``plan`` picks the grid.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple, Union

import torch

from ._build import load
from .decode_attention import ticket_buffer

GEMV_MAX_ROWS = 16           # kMaxRows in csrc/qgemv.cu
MAX_GROUP = 3                # kMaxGroup: payloads of one launch
_WARPS = 8                   # kWarps
_TILE = 16                   # kTile: output columns of a tile
_STRETCH = 64                # kStretch: k of one stretch
_MAX_KS = 4                  # stretches a warp holds, two fragment sets
_LONG_KS = 12                # stretches a warp holds, one set (m <= 8)
_SMS = 132                   # streaming multiprocessors of an H100 SXM
_RESIDENT = 2 * _SMS         # blocks the plan counts on being resident
_W_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1}
_S_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class Plan:
    """The kernel's grid for an [m, K] x [sum n, K] product. Stretches of
    64 k (the last one may be short) are cut into ``splits`` K splits of
    ``per_split`` stretches (the last may hold fewer), and a split's
    stretches into the 8 warps, ``kw`` each (the last warps may hold fewer
    or none); a warp keeps ``ks`` >= ``kw`` stretches of x in registers
    (1, 2 or 4 with two payload fragment sets, the next tile's loads in
    flight; or 12, one set, for one tile a block).
    Column tiles of 16 (each payload's own, in order) fall into ``groups``
    column groups: group c holds tiles c, c + groups, c + 2 groups, ...
    Block ``b`` takes split ``b // groups`` of group ``b % groups``."""
    m: int
    n_tiles: int         # 8-row tiles of x: 1 (m <= 8) or 2
    tiles: int           # column tiles of all payloads
    stretches: int
    splits: int
    per_split: int
    kw: int
    ks: int
    groups: int

    @property
    def grid(self) -> int:
        return self.groups * self.splits

    @property
    def scratch(self) -> int:
        """f32 partials the kernel writes: [splits][m][tiles * 16]."""
        return self.splits * self.m * self.tiles * _TILE \
            if self.splits > 1 else 0

    @property
    def tickets(self) -> int:
        """Ticket slots it takes: one per column group when K is split."""
        return self.groups if self.splits > 1 else 0

    def split_range(self, split: int) -> Tuple[int, int]:
        """Stretches [lo, hi) of one split."""
        lo = min(split * self.per_split, self.stretches)
        return lo, min(lo + self.per_split, self.stretches)

    def warp_range(self, split: int, warp: int) -> Tuple[int, int]:
        """Stretches [lo, hi) a warp of a split's blocks multiplies."""
        s0, s1 = self.split_range(split)
        lo = min(s0 + warp * self.kw, s1)
        return lo, min(lo + self.kw, s1)

    def group_tiles(self, group: int) -> range:
        return range(group, self.tiles, self.groups)


def plan(m: int, n: Union[int, Sequence[int]], k: int) -> Plan:
    """The grid for ``m`` rows, output widths ``n`` (one payload, or each
    of a group) and contraction ``k`` (a multiple of 16).

    Column groups: one tile each while the grid stays within two waves of
    resident blocks (``_RESIDENT``, two a SM); else as many tiles a group
    as spread the tiles evenly over one wave. K splits: none where a warp
    can hold its share of K, i.e. at most 4 stretches (K <= 2048), or 12
    for up to 8 rows with one tile a block (K <= 6144: w_down); else the
    fewest that leave a warp 4. Splitting K further to fill the card's SMs
    was measured slower on the H100 at every decoder shape (PERF.md;
    ``tools_perf/qgemv_plans.py``): the combine costs more than the idle
    SMs gain. The combine adds splits in split order."""
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(f"qgemv takes 1..{GEMV_MAX_ROWS} rows, got {m}")
    if k <= 0 or k % 16:
        raise ValueError(f"qgemv needs K a positive multiple of 16, got {k}")
    ns = [n] if isinstance(n, int) else list(n)
    if not 1 <= len(ns) <= MAX_GROUP or min(ns) <= 0:
        raise ValueError(f"qgemv takes 1..{MAX_GROUP} payloads of positive "
                         f"width, got {ns}")
    tiles = sum(-(-x // _TILE) for x in ns)
    stretches = -(-k // _STRETCH)
    n_tiles = 1 if m <= 8 else 2
    long_k = (stretches > _WARPS * _MAX_KS and n_tiles == 1
              and stretches <= _WARPS * _LONG_KS and tiles <= 2 * _RESIDENT)
    splits = 1 if long_k else -(-stretches // (_WARPS * _MAX_KS))
    per_split = -(-stretches // splits)
    kw = -(-per_split // _WARPS)
    ks = _LONG_KS if long_k else 1 if kw == 1 else 2 if kw == 2 else 4
    if tiles * splits <= 2 * _RESIDENT:
        groups = tiles
    else:
        per_group = -(-tiles * splits // _RESIDENT)
        groups = -(-tiles // per_group)
    return Plan(m=m, n_tiles=n_tiles, tiles=tiles,
                stretches=stretches, splits=splits, per_split=per_split,
                kw=kw, ks=ks, groups=groups)


def qgemv_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] float, q [N, K], s [N] → [M, N] in ``out_dtype``: the
    kernel's function restated in f32 (the widened payload and bf16 x are
    exact there), the scale, one rounding."""
    acc = x.float() @ q.float().t()
    return (acc * s.reshape(1, -1).float()).to(out_dtype)


def _library() -> ctypes.CDLL:
    lib = load("qgemv")
    fn = lib.qgemv_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       p, p, p]
        fn.restype = ctypes.c_int
    return lib


def _check(x, pairs, out_dtype):
    m, k = x.shape
    dev = x.device
    if x.dtype != torch.bfloat16:
        raise ValueError(f"qgemv takes bf16 activations, got {x.dtype}")
    if not 1 <= len(pairs) <= MAX_GROUP:
        raise ValueError(f"qgemv takes 1..{MAX_GROUP} payloads, got "
                         f"{len(pairs)}")
    w_dtype, s_dtype = pairs[0][0].dtype, pairs[0][1].dtype
    for q, s in pairs:
        if q.dtype not in _W_CODE or s.dtype not in _S_CODE \
                or out_dtype not in _OUT_CODE:
            raise ValueError(f"qgemv takes int8/fp8 payloads, f32/bf16 "
                             f"scales and an f32/bf16 output, got {q.dtype}, "
                             f"{s.dtype}, {out_dtype}")
        if q.dtype != w_dtype or s.dtype != s_dtype:
            raise ValueError("a grouped qgemv takes payloads of one dtype "
                             "and scales of one dtype")
        if q.device != dev or s.device != dev:
            raise ValueError("x, q and s must be on one device")
        if q.dim() != 2 or q.shape[1] != k or s.numel() != q.shape[0]:
            raise ValueError(f"shapes x {tuple(x.shape)}, q "
                             f"{tuple(q.shape)}, s {tuple(s.shape)} do not "
                             f"match")
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError("qgemv needs contiguous q and s")
        if q.data_ptr() % 16:
            raise ValueError("qgemv needs 16-byte aligned payloads")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("qgemv needs a contiguous, 16-byte aligned x")
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(f"qgemv takes 1..{GEMV_MAX_ROWS} rows, got {m}")
    if k % 16:
        raise ValueError(f"qgemv needs K a multiple of 16, got K={k}")


def _launch(x, pairs, out_dtype) -> List[torch.Tensor]:
    pairs = [(q, s.reshape(-1)) for q, s in pairs]
    _check(x, pairs, out_dtype)
    m, k = x.shape
    dev = x.device
    p = plan(m, [q.shape[0] for q, _ in pairs], k)
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
    err = _library().qgemv_fwd(
        _W_CODE[pairs[0][0].dtype], _S_CODE[pairs[0][1].dtype],
        _OUT_CODE[out_dtype], count, x.data_ptr(),
        ctypes.addressof(qs), ctypes.addressof(ss), ctypes.addressof(os_),
        ctypes.addressof(ns), m, k, p.n_tiles, p.ks, p.kw, p.per_split,
        p.splits, p.groups, 0 if part is None else part.data_ptr(),
        0 if tickets is None else tickets.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qgemv kernel launch failed: CUDA error {err}")
    qgemv.launches += 1
    return outs


def qgemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
          out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ q[N, K].T * s[N] → [M, N] in ``out_dtype``. A CUDA tensor
    launches the kernel or raises; only a CPU tensor takes the plain
    version."""
    if x.device.type == "cpu":
        return qgemv_plain(x, q, s, out_dtype=out_dtype)
    return _launch(x, [(q, s)], out_dtype)[0]


def qgemv_group(x: torch.Tensor,
                pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                out_dtype: torch.dtype) -> List[torch.Tensor]:
    """``[qgemv(x, q, s) for q, s in pairs]`` in ONE launch on the card
    (1..3 payloads of one K, one payload dtype and one scale dtype); one
    plain version per payload on the CPU."""
    if x.device.type == "cpu":
        return [qgemv_plain(x, q, s, out_dtype=out_dtype) for q, s in pairs]
    return _launch(x, list(pairs), out_dtype)


qgemv.launches = 0
