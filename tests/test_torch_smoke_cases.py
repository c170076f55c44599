"""chip_smoke.py's cases for kernels A and C (``quant_cases``), run on the
CPU at small shapes: each case's kernel call (the wrapper, which takes its
plain version for a CPU tensor) gives its plain call's bits, one output a
payload; the library call is one product over all the payloads; the
earlier route is given only where the smoke times one (kernel C's int8 and
fp8 cases); bytes, FLOPs and layers are those of the shape."""
import importlib.util
import os

import pytest
import torch

from qwen3_asr_tpu_torch.ops.qgemm import (qgemm_group, qgemm_plain,
                                           widened_product)
from qwen3_asr_tpu_torch.ops.qgemv import qgemv_group, qgemv_plain

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHAPES = (("one", 256, (128,), "dec"), ("pair", 256, (128, 64), "dec"),
          ("head", 256, (512,), "head"))
ROWS = (3, 20)
LAYERS = 2
KERNELS = {"qgemv": (qgemv_group, qgemv_plain, None),
           "qgemm": (qgemm_group, qgemm_plain, widened_product)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_quant_cases_on_cpu(kernel):
    group, plain, earlier = KERNELS[kernel]
    cases = _chip_smoke().quant_cases(torch.device("cpu"), SHAPES,
                                      lambda where: ROWS, LAYERS, 1, group,
                                      plain, earlier)
    shapes = {name: (k, ns, where) for name, k, ns, where in SHAPES}
    labels = []
    for label, run, ref, lib, early, nbytes, flops, layers in cases:
        name, rest = label.split("_m")
        m, mode = rest.split("_")
        m, (k, ns, where) = int(m), shapes[name]
        head = where == "head"
        assert layers == (1 if head else LAYERS)
        outs, refs = run(layers - 1), ref(layers - 1)
        assert [o.shape for o in outs] == [(m, n) for n in ns]
        assert all(o.dtype == (torch.float32 if head else torch.bfloat16)
                   for o in outs)
        assert all(torch.equal(o, r) for o, r in zip(outs, refs)), label
        assert lib(layers - 1).shape == (m, sum(ns))
        assert (early is None) == (earlier is None or mode == "int4")
        if early is not None:
            assert all(torch.equal(o, r)
                       for o, r in zip(early(layers - 1), refs)), label
        assert flops == 2 * m * sum(ns) * k
        assert nbytes > 2 * m * k
        labels.append(label)
    assert len(labels) == len(set(labels)) == 3 * len(SHAPES) * len(ROWS)


DECODE = "decode_split_kernel(int, int)"


@pytest.mark.parametrize("captured,decoded,ok", [
    (7168, [(DECODE, 7168)], True),          # every record kept
    (7168, [(DECODE, 6246)], True),          # 12.9% of the records lost
    (7168, [(DECODE, 6794)], True),          # 5.2% lost
    (7168, [], True),                        # the profile names none
    (7168, [(DECODE, 7169)], False),         # launches outside the capture
    (7168, [(DECODE, 3584), ("decode_split_kernel<2>", 3584)], False),
    (7167, [(DECODE, 7167)], False),         # the capture's count is off
])
def test_profile_verdict_rests_on_the_capture(captured, decoded, ok):
    verdict = _chip_smoke().profile_verdict
    if ok:
        line = verdict(captured, 7168, decoded)
        if decoded:
            kept = decoded[0][1]
            assert f"kept {kept} of" in line
            assert f"({7168 - kept} lost)" in line
    else:
        with pytest.raises(AssertionError):
            verdict(captured, 7168, decoded)
