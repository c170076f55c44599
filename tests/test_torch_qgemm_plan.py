"""Kernel C's launch plan (``ops/qgemm.py`` ``qgemm_plan``) at every
product of a preset:1.7b front graph, on the CPU: the steps and splits
cover K exactly, every split of a split K holds at least the ring's depth
of steps, int4 with group scales takes at most 128 rows of x a block and
splits on group boundaries, the grid fills the card's 132 SMs wherever
the tiles and splits allow it without lengthening the slowest SM's walk
(the plan's own estimate), and a call is one launch."""
import pytest
import torch

from qwen3_asr_tpu_torch.models.config import preset
from qwen3_asr_tpu_torch.ops.qgemm import (STAGES, STEP_K, TILE_N,
                                           qgemm_candidates, qgemm_plan)

SMS = 132
INT4_GROUP = 128            # ASR_INT4_GROUP's default


def _front_products():
    """(name, K, output widths) of every kernel C launch of the front
    graph: one a product, q/k/v and gate/up as one grouped launch each."""
    cfg = preset("1.7b")
    dec, enc = cfg.decoder, cfg.encoder
    h, d = dec.hidden_size, dec.head_dim
    e = enc.d_model
    return {
        "dec_qkv": (h, (dec.num_attention_heads * d,
                        dec.num_key_value_heads * d,
                        dec.num_key_value_heads * d)),
        "dec_wo": (dec.num_attention_heads * d, (h,)),
        "dec_gate_up": (h, (dec.intermediate_size,) * 2),
        "dec_down": (dec.intermediate_size, (h,)),
        "enc_qkv": (e, (e,) * 3),
        "enc_wo": (e, (e,)),
        "enc_fc1": (e, (enc.encoder_ffn_dim,)),
        "enc_fc2": (enc.encoder_ffn_dim, (e,)),
    }


PRODUCTS = _front_products()
ROWS = (17, 64, 375, 453, 1000, 1624)
DTYPES = {"int8": torch.int8, "fp8": torch.float8_e4m3fn,
          "int4": torch.uint8}
CASES = ([(name, m, mode) for name in PRODUCTS for m in ROWS
          for mode in DTYPES]
         + [("lm_head", m, mode) for m in (17, 32) for mode in DTYPES])


@pytest.mark.parametrize("name,m,mode", CASES)
def test_qgemm_plan(name, m, mode):
    cfg = preset("1.7b")
    if name == "lm_head":
        k, ns, ngroups = cfg.decoder.hidden_size, (cfg.decoder.vocab_size,), 1
    else:
        k, ns = PRODUCTS[name]
        ngroups = k // INT4_GROUP if mode == "int4" else 1
    w_dtype = DTYPES[mode]
    p = qgemm_plan(m, ns, k, w_dtype, ngroups)

    # one launch; the grid is the tiles times the splits
    assert p.launches == 1
    assert p.tiles == sum(-(-n // TILE_N) for n in ns)
    assert p.row_tiles == -(-m // p.bm) and p.bm in STAGES
    assert p.blocks == p.tiles * p.row_tiles * p.splits
    kb = k // 2 if mode == "int4" else k
    assert p.steps == (2 if mode == "int4" else 1) * -(-kb // STEP_K)

    # the splits cover K exactly, in order, none empty; split, each holds
    # at least the ring's depth
    ranges = [p.split_range(s) for s in range(p.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == p.steps
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(hi > lo for lo, hi in ranges)
    if p.splits > 1:
        assert all(hi - lo >= p.stages for lo, hi in ranges)
        assert p.tickets == p.tiles * p.row_tiles
        assert p.scratch == p.blocks * TILE_N * p.bm

    # int4 with group scales: at most 128 rows of x, splits on group
    # boundaries (a step is 64 k of one group)
    if mode == "int4" and ngroups > 1:
        assert p.bm <= 128
        assert p.group_steps == k // ngroups // STEP_K
        assert all(lo % p.group_steps == 0 for lo, _ in ranges)

    # the card is filled wherever a plan that fills it is not estimated
    # slower; and the plan is the estimate's best
    candidates = qgemm_candidates(m, ns, k, w_dtype, ngroups)
    assert p in candidates
    assert all(p.estimate_ns() <= c.estimate_ns() for c in candidates)
    if p.blocks < SMS:
        assert all(c.estimate_ns() > p.estimate_ns() for c in candidates
                   if c.blocks >= SMS), (p, p.estimate_ns())


def test_qgemm_plan_splits_where_the_tiles_leave_sms_idle():
    """The shapes whose output tiles alone leave most of the card idle
    split K: enc wo and fc2 at the 30 s encoder's 375 rows, w_down at the
    prompt's 453."""
    for name, m in (("enc_wo", 375), ("enc_fc2", 375), ("dec_down", 453)):
        k, ns = PRODUCTS[name]
        for mode, w_dtype in DTYPES.items():
            ngroups = k // INT4_GROUP if mode == "int4" else 1
            p = qgemm_plan(m, ns, k, w_dtype, ngroups)
            assert p.splits > 1 and p.blocks >= 96, (name, mode, p)


def test_qgemm_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError):
        qgemm_plan(0, [128], 256, torch.int8)
    with pytest.raises(ValueError):
        qgemm_plan(32, [128], 200, torch.int8)         # K not of 16
    with pytest.raises(ValueError):
        qgemm_plan(32, [128] * 4, 256, torch.int8)     # four payloads
    with pytest.raises(ValueError):
        qgemm_plan(32, [128], 48, torch.uint8)         # int4 K not of 32
