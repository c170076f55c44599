"""The launch plans of the training backward kernels, on the CPU.

Kernel (i)'s tensor-core route (``csrc/flash_attention_bwd.cu``) walks two
grids whose order and tiles ``ops/flash_attention.py`` ``bwd_plan``
restates: every block of each grid launches once, every (query row, key)
pair the mask keeps lies in exactly one (block, tile) of each pass, and
under the causal mask the longest walks launch first. Also the routes
each wrapper picks, and kernel B′'s vector grid."""
import numpy as np
import pytest
import torch

from qwen3_asr_tpu_torch.ops.flash_attention import (BWD_BLOCK_K,
                                                     BWD_BLOCK_Q, BWD_KEYS,
                                                     bwd_plan)
from qwen3_asr_tpu_torch.ops.flash_attention import bwd_route as flash_route
from qwen3_asr_tpu_torch.ops.qk_rope_kv import bwd_route as qk_route
from qwen3_asr_tpu_torch.ops.qk_rope_kv import _BWD_VEC_BLOCKS, bwd_vec_grid

# (b, nq, nkv, t, s, causal, window, valid_from, valid_to, q_offset): the
# card tests' FLASH_BWD_CASES and the CPU parity cases' masks
PLAN_CASES = {
    "encoder_6s": (2, 20, 20, 75, 75, False, 50, [0, 0], [75, 60], [0, 0]),
    "encoder_30s": (1, 20, 20, 375, 375, False, 50, [0], [375], [0]),
    "train_causal_1p7b": (8, 16, 8, 217, 217, True, 0, [12] * 8,
                          [217] * 8, [0] * 8),
    "trained_ckpt_heads": (2, 4, 2, 150, 150, True, 0, [20, 45],
                           [150, 150], [0, 0]),
    "fully_masked_rows": (2, 2, 2, 40, 40, False, 0, [45, 3], [40, 30],
                          [0, 0]),
    "group8_q_offset": (1, 16, 2, 29, 200, True, 0, [3], [200], [171]),
    "window_crossing_tiles": (2, 2, 2, 230, 230, False, 50, [0, 0],
                              [230, 171], [0, 0]),
    "group3_per_row_offset": (2, 6, 2, 8, 40, True, 0, [0, 5], [40, 40],
                              [32, 20]),
    "valid_range_and_empty_row": (2, 2, 1, 24, 24, False, 0, [3, 0],
                                  [20, 0], [0, 0]),
}


def _mask(t, s, causal, window, vf, vt, qoff):
    """The forward's mask of one batch row, [T, S]."""
    rows = np.arange(t)[:, None] + qoff
    cols = np.arange(s)[None, :]
    live = (cols >= vf) & (cols < vt) & (rows >= rows.min())
    if causal:
        live &= cols <= rows
    if window > 0:
        live &= (rows // window) == (cols // window)
    return live


@pytest.mark.parametrize("name", list(PLAN_CASES))
def test_bwd_plan_covers_every_live_pair_once(name):
    b, nq, nkv, t, s, causal, window, vf, vt, qo = PLAN_CASES[name]
    group = nq // nkv
    pass1, pass2 = bwd_plan(b, nq, nkv, t, s, causal=causal, window=window,
                            valid_from=vf, valid_to=vt, q_offset=qo)
    block_q = 64 // group
    # every block of each grid once
    assert sorted((bi, h, t0) for bi, h, t0, _, _ in pass1) == sorted(
        (bi, h, t0) for bi in range(b) for h in range(nkv)
        for t0 in range(0, t, block_q))
    assert sorted((bi, h, c0) for bi, h, c0, _ in pass2) == sorted(
        (bi, h, c0) for bi in range(b) for h in range(nkv)
        for c0 in range(0, s, BWD_KEYS))
    for bi in range(b):
        live = _mask(t, s, causal, window, vf[bi], vt[bi], qo[bi])
        for h in range(nkv):
            cover1 = np.zeros((t, s), np.int64)
            for bj, hj, t0, bq, tiles in pass1:
                if (bj, hj) != (bi, h):
                    continue
                assert bq == block_q
                for c0 in tiles:
                    cover1[t0:t0 + bq, c0:c0 + BWD_BLOCK_K] += 1
            assert np.all(cover1[live] == 1), name
            for g in range(group):
                cover2 = np.zeros((t, s), np.int64)
                for bj, hj, c0, walk in pass2:
                    if (bj, hj) != (bi, h):
                        continue
                    for gq, tq in walk:
                        if gq == g:
                            cover2[tq:tq + BWD_BLOCK_Q,
                                   c0:c0 + BWD_KEYS] += 1
                assert np.all(cover2[live] == 1), (name, g)
                assert cover2.max() <= 1


@pytest.mark.parametrize("name", ["train_causal_1p7b", "trained_ckpt_heads",
                                  "group8_q_offset"])
def test_bwd_plan_launches_the_longest_walks_first(name):
    b, nq, nkv, t, s, causal, window, vf, vt, qo = PLAN_CASES[name]
    pass1, pass2 = bwd_plan(b, nq, nkv, t, s, causal=causal, window=window,
                            valid_from=vf, valid_to=vt, q_offset=qo)
    for walks in ([len(p[4]) for p in pass1], [len(p[3]) for p in pass2]):
        ranks = [max(walks[i:i + b * nkv])
                 for i in range(0, len(walks), b * nkv)]
        assert ranks == sorted(ranks, reverse=True), ranks
        if not any(qo):   # a prefill at an offset walks every tile alike
            assert ranks[0] > ranks[-1], ranks


def test_backward_routes():
    assert [flash_route(torch.bfloat16, d) for d in (48, 64, 96, 128)] == \
        ["tensor_cores"] * 4
    assert flash_route(torch.bfloat16, 24) == "cuda_cores"
    assert [flash_route(torch.float32, d) for d in (24, 64, 128)] == \
        ["cuda_cores"] * 3
    assert [qk_route(torch.bfloat16, d) for d in (16, 32, 64, 128)] == \
        ["vector"] * 4
    assert [qk_route(torch.float32, d) for d in (8, 64, 128)] == \
        ["vector"] * 3
    assert [qk_route(dt, d) for dt in (torch.bfloat16, torch.float32)
            for d in (24, 48)] == ["rows"] * 4


@pytest.mark.parametrize("tokens", [1, 7, 395, 396, 397, 1736, 2520,
                                    100000])
def test_qk_rope_bwd_vec_grid_takes_every_token(tokens):
    per_block, blocks = bwd_vec_grid(tokens)
    assert blocks <= _BWD_VEC_BLOCKS and per_block * blocks >= tokens
    assert per_block * (blocks - 1) < tokens
