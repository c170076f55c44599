"""The weight-only quantized product of decode rows: a CUDA kernel written by
hand for Hopper (``csrc/qgemv.cu``), its plain PyTorch version, its plan,
and the wrappers.

No TPU kernel: JAX's ``qdot`` (``qwen3_asr_tpu/ops/quant.py:134-182``) runs
in XLA, which fuses the payload's widening and the scale into the dot. On
the card the decode step's products must read the low-precision payload
itself: a bf16 copy widened every step would read more bytes than bf16
weights do.

What it computes: ``out[m, n] = (sum_k x[m, k] * q[n, k]) * s[n]``, the
payload widened exactly, the sum in f32, rounded once to ``out_dtype``
(x's dtype for a layer, f32 for the logits): JAX's rounding points. ``x``
is ``[M, K]`` bf16 with M <= ``GEMV_MAX_ROWS``; ``q`` is ``[N, K]`` int8 or
``float8_e4m3fn`` (the contraction dim contiguous, ``ops/quant.py``'s
layout) with N scales, or ``[N, K/2]`` uint8 int4 pairs (byte j holds k = j
and k = j + K/2, biased by 8) with ``[N, G]`` scales, G groups along K:
``out[m, n] = sum_g (sum_{k in g} x[m, k] * q[n, k]) * s[n, g]``, each
group's f32 sum scaled, the groups added in f32, one rounding (JAX's
``quant.py:169-182``). Scales are f32 or bf16. ``qgemv_group`` takes up to
three payloads of one K that share x (q, k and v; gate and up) in one
launch and returns one output each.

What bounds it on the H100: the payload's bytes, N*K (int4: N*K/2) once.
The design (``csrc/qgemv.cu``): tensor cores (``mma.sync``, the widened
payload as the A operand, x as B), k permuted inside each stretch of 64
payload bytes so a lane's 16-byte payload load and 32-byte x load feed its
fragments directly (an int4 stretch is two stretches of k, one from each
half of the row, each with its group's scale applied as the K loop goes);
blocks of 8 warps, each warp holding x for its part of the block's K slice
in registers while it walks the block's column tiles; K split across
blocks only where a warp cannot hold its share of x, the splits added in
a fixed order by the last block of a column group (a ticket), so the
output is the same bits on every run. ``plan`` picks the grid.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch

from ._build import load
from .autograd import refuse_grad
from .decode_attention import ticket_buffer

GEMV_MAX_ROWS = 16           # kMaxRows in csrc/qgemv.cu
MAX_GROUP = 3                # kMaxGroup: payloads of one launch
_WARPS = 8                   # kWarps
_TILE = 16                   # kTile: output columns of a tile
_STRETCH = 64                # kStretch: payload bytes of one stretch
# stretches a warp holds with two fragment sets, and with one (m <= 8), by
# payload: an int4 stretch is 128 k, so it holds half as many
_MAX_KS = {False: 4, True: 2}
_LONG_KS = {False: 12, True: 6}
_SMS = 132                   # streaming multiprocessors of an H100 SXM
_RESIDENT = 2 * _SMS         # blocks the plan counts on being resident
_W_CODE = {torch.int8: 0, torch.float8_e4m3fn: 1, torch.uint8: 2}
_S_CODE = {torch.float32: 0, torch.bfloat16: 1}
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}


@dataclass(frozen=True)
class Plan:
    """The kernel's grid for an [m, K] x [sum n, K] product. Stretches of
    64 payload bytes (64 k, or 128 for int4; the last one may be short) are
    cut into ``splits`` K splits of
    ``per_split`` stretches (the last may hold fewer), and a split's
    stretches into the 8 warps, ``kw`` each (the last warps may hold fewer
    or none); a warp keeps ``ks`` >= ``kw`` stretches of x in registers
    (1, 2 or 4 with two payload fragment sets, the next tile's loads in
    flight; or 12, one set, for one tile a block; int4: 1, 2 or 6).
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


def plan(m: int, n: Union[int, Sequence[int]], k: int,
         packed: bool = False) -> Plan:
    """The grid for ``m`` rows, output widths ``n`` (one payload, or each
    of a group) and contraction ``k`` (a multiple of 16; 32 for an int4
    payload, ``packed``, whose rows hold k / 2 bytes).

    Column groups: one tile each while the grid stays within two waves of
    resident blocks (``_RESIDENT``, two a SM); else as many tiles a group
    as spread the tiles evenly over one wave. K splits: none where a warp
    can hold its share of K, i.e. at most 4 stretches (K <= 2048), or 12
    for up to 8 rows with one tile a block (K <= 6144: w_down); else the
    fewest that leave a warp 4 (int4: 2, 6 and 2 stretches of 128 k, the
    same K). Splitting K further to fill the card's SMs was measured
    slower on the H100 at every decoder shape (PERF.md;
    ``tools_perf/qgemv_plans.py``): the combine costs more than the idle
    SMs gain. The combine adds splits in split order."""
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(f"qgemv takes 1..{GEMV_MAX_ROWS} rows, got {m}")
    step = 32 if packed else 16
    if k <= 0 or k % step:
        raise ValueError(f"qgemv needs K a positive multiple of {step}, "
                         f"got {k}")
    ns = [n] if isinstance(n, int) else list(n)
    if not 1 <= len(ns) <= MAX_GROUP or min(ns) <= 0:
        raise ValueError(f"qgemv takes 1..{MAX_GROUP} payloads of positive "
                         f"width, got {ns}")
    max_ks, long_ks = _MAX_KS[packed], _LONG_KS[packed]
    tiles = sum(-(-x // _TILE) for x in ns)
    stretches = -(-(k // 2 if packed else k) // _STRETCH)
    n_tiles = 1 if m <= 8 else 2
    long_k = (stretches > _WARPS * max_ks and n_tiles == 1
              and stretches <= _WARPS * long_ks and tiles <= 2 * _RESIDENT)
    splits = 1 if long_k else -(-stretches // (_WARPS * max_ks))
    per_split = -(-stretches // splits)
    kw = -(-per_split // _WARPS)
    ks = long_ks if long_k else 1 if kw == 1 else 2 if kw == 2 else 4
    if tiles * splits <= 2 * _RESIDENT:
        groups = tiles
    else:
        per_group = -(-tiles * splits // _RESIDENT)
        groups = -(-tiles // per_group)
    return Plan(m=m, n_tiles=n_tiles, tiles=tiles,
                stretches=stretches, splits=splits, per_split=per_split,
                kw=kw, ks=ks, groups=groups)


def int4_layout_error(k: int, groups: int) -> Optional[str]:
    """Why kernels A and C do not take an int4 payload of contraction ``k``
    with ``groups`` scale groups along it, or None where they do. Both read
    a row in stretches of 64 bytes, i.e. k [s, s + 64) from the low
    nibbles and [K/2 + s, K/2 + s + 64) from the high ones, and apply a
    group's scale to a half-stretch's sum: each half-stretch must lie in
    one group, so K/2 and the group size are multiples of 64 (or there is
    one group); 16-byte loads need K/2 a multiple of 16."""
    if k % 32 or groups <= 0 or k % groups:
        return (f"int4 K={k} with {groups} groups: the kernels need K a "
                f"multiple of 32 and whole groups")
    if groups > 1 and ((k // 2) % _STRETCH or (k // groups) % _STRETCH):
        return (f"int4 K={k} in {groups} groups of {k // groups}: the "
                f"kernels need K/2 and the group size multiples of "
                f"{_STRETCH} (ASR_INT4_GROUP)")
    return None


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """uint8 pairs [..., K/2] → int8 values [..., K] in their order: the
    low nibbles (k < K/2), then the high ones, each less 8 (a concat, as
    ``qwen3_asr_tpu/ops/quant.py`` ``unpack_int4``)."""
    lo = (q & 15).to(torch.int8) - 8
    hi = (q >> 4).to(torch.int8) - 8
    return torch.cat([lo, hi], dim=-1)


def int4_product(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] float, q [N, K/2] uint8 pairs, s [N, G] → [M, N] in
    ``out_dtype``: JAX's int4 ``qdot`` restated in f32 (``quant.py:163-182``;
    the unpacked values and bf16 x are exact there). G = 1: one sum times
    s; G > 1: each group's sum times its scale, added over the groups.
    One rounding."""
    n = q.shape[0]
    w = unpack_int4(q).float()
    s2 = s.reshape(n, -1).float()
    groups, xf = s2.shape[1], x.float()
    if groups == 1:
        return ((xf @ w.t()) * s2.reshape(1, n)).to(out_dtype)
    size = w.shape[1] // groups
    parts = torch.einsum("mgk,ngk->mgn", xf.reshape(-1, groups, size),
                         w.reshape(n, groups, size))
    return (parts * s2.t()[None]).sum(dim=1).to(out_dtype)


def qgemv_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
                out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] float, q [N, K], s [N] → [M, N] in ``out_dtype``: the
    kernel's function restated in f32 (the widened payload and bf16 x are
    exact there), the scale, one rounding; an int4 payload through
    ``int4_product``."""
    if q.dtype == torch.uint8:
        return int4_product(x, q, s, out_dtype=out_dtype)
    acc = x.float() @ q.float().t()
    return (acc * s.reshape(1, -1).float()).to(out_dtype)


def _library() -> ctypes.CDLL:
    lib = load("qgemv")
    fn = lib.qgemv_fwd
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [i, i, i, i, p, p, p, p, p, i, i, i, i, i, i, i, i,
                       i, p, p, p]
        fn.restype = ctypes.c_int
    return lib


def contraction(q: torch.Tensor) -> int:
    """K of a payload: its row's bytes, twice that for int4 pairs."""
    return q.shape[-1] * (2 if q.dtype == torch.uint8 else 1)


def check_operands(name: str, x: torch.Tensor, pairs, out_dtype) -> int:
    """Raise ValueError for what kernels A and C do not take: x not bf16,
    contiguous and 16-byte aligned; payloads not int8, fp8 or int4 pairs
    of one dtype, not 2-D, contiguous and 16-byte aligned, or not of x's
    K; scales not f32/bf16 of one dtype, contiguous, N of them (int4: N x
    G, G groups along K, in a layout ``int4_layout_error`` passes); an
    output neither f32 nor bf16; tensors on different devices. Returns G
    (1 but for int4)."""
    m, k = x.shape
    if x.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 activations, got {x.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"{name} needs a contiguous, 16-byte aligned x")
    w_dtype, s_dtype = pairs[0][0].dtype, pairs[0][1].dtype
    groups = set()
    for q, s in pairs:
        if q.dtype not in _W_CODE or s.dtype not in _S_CODE \
                or out_dtype not in _OUT_CODE:
            raise ValueError(f"{name} takes int8/fp8/int4 payloads, f32/bf16 "
                             f"scales and an f32/bf16 output, got {q.dtype}, "
                             f"{s.dtype}, {out_dtype}")
        if q.dtype != w_dtype or s.dtype != s_dtype:
            raise ValueError(f"a grouped {name} takes payloads of one dtype "
                             "and scales of one dtype")
        if q.device != x.device or s.device != x.device:
            raise ValueError("x, q and s must be on one device")
        if q.dim() != 2 or contraction(q) != k or s.numel() % q.shape[0] \
                or (q.dtype != torch.uint8 and s.numel() != q.shape[0]):
            raise ValueError(f"shapes x {tuple(x.shape)}, q "
                             f"{tuple(q.shape)} ({q.dtype}), s "
                             f"{tuple(s.shape)} do not match")
        if not (q.is_contiguous() and s.is_contiguous()):
            raise ValueError(f"{name} needs contiguous q and s")
        if q.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte aligned payloads")
        groups.add(s.numel() // q.shape[0])
    if len(groups) > 1:
        raise ValueError(f"a grouped {name} takes one scale layout")
    g = groups.pop()
    if w_dtype == torch.uint8:
        err = int4_layout_error(k, g)
        if err:
            raise ValueError(f"{name}: {err}")
    elif k % 16:
        raise ValueError(f"{name} needs K a multiple of 16, got K={k}")
    return g


def _launch(x, pairs, out_dtype) -> List[torch.Tensor]:
    if not 1 <= len(pairs) <= MAX_GROUP:
        raise ValueError(f"qgemv takes 1..{MAX_GROUP} payloads, got "
                         f"{len(pairs)}")
    ngroups = check_operands("qgemv", x, pairs, out_dtype)
    m, k = x.shape
    if not 1 <= m <= GEMV_MAX_ROWS:
        raise ValueError(f"qgemv takes 1..{GEMV_MAX_ROWS} rows, got {m}")
    dev = x.device
    packed = pairs[0][0].dtype == torch.uint8
    p = plan(m, [q.shape[0] for q, _ in pairs], k, packed)
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
        ctypes.addressof(ns), m, k, ngroups, p.n_tiles, p.ks, p.kw,
        p.per_split, p.splits, p.groups,
        0 if part is None else part.data_ptr(),
        0 if tickets is None else tickets.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"qgemv kernel launch failed: CUDA error {err}")
    qgemv.launches += 1
    return outs


def qgemv(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor, *,
          out_dtype: torch.dtype) -> torch.Tensor:
    """x [M, K] @ q[N, K].T * s[N] → [M, N] in ``out_dtype`` (int4: q
    [N, K/2] pairs, s [N, G]). A CUDA tensor launches the kernel or raises;
    only a CPU tensor takes the plain version."""
    refuse_grad("qgemv", x, q, s)
    if x.device.type == "cpu":
        return qgemv_plain(x, q, s, out_dtype=out_dtype)
    return _launch(x, [(q, s)], out_dtype)[0]


def qgemv_group(x: torch.Tensor,
                pairs: Sequence[Tuple[torch.Tensor, torch.Tensor]], *,
                out_dtype: torch.dtype) -> List[torch.Tensor]:
    """``[qgemv(x, q, s) for q, s in pairs]`` in ONE launch on the card
    (1..3 payloads of one K, one payload dtype and one scale dtype); one
    plain version per payload on the CPU."""
    refuse_grad("qgemv_group", x, *(t for pair in pairs for t in pair))
    if x.device.type == "cpu":
        return [qgemv_plain(x, q, s, out_dtype=out_dtype) for q, s in pairs]
    return _launch(x, list(pairs), out_dtype)


qgemv.launches = 0
