"""How far the port's Ogg Opus and Layer I/II decodes are from the
references, over ``tests/test_torch_opus.py``'s cases:

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/opus_bounds.py

prints one JSON line a case: against JAX's decode, the largest difference
in steps of 1/32768, the SNR in dB and the share of equal samples; against
libopus's ``opus_decode_float``, the SNR of the port's float output; then
the worst of each over the cases the dither bound holds. The test file
asserts the bounds; this prints the measurements behind them.
"""
import json
import sys

import numpy as np


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    from qwen3_asr_tpu.audio.codec import decode_audio as jax_decode_audio
    from qwen3_asr_tpu_torch.audio import native, opus
    from qwen3_asr_tpu_torch.audio.compressed import decode_compressed
    from tests import test_torch_opus as T

    dither = []
    for name in sorted(T.OPUS_CASES):
        make, exact = T.OPUS_CASES[name]
        data = make()
        want, _ = jax_decode_audio(data)
        got, _ = decode_compressed(data, "OGG")
        diff = np.abs(got.astype(np.float64) - want) * 32768
        row = {"case": name, "vs_jax_lsb": float(diff.max()),
               "vs_jax_snr_db": T._snr(want, got),
               "equal": float(np.mean(diff == 0)), "exact": exact}
        if not exact:
            dither.append(row)
        print(json.dumps(row), flush=True)
    for name in sorted(T.LAYER12_CASES):
        data = T.F.id3v2() + T.LAYER12_CASES[name]()
        want, _ = jax_decode_audio(data)
        got, _ = decode_compressed(data, "MP3")
        diff = np.abs(got.astype(np.float64) - want) * 32768
        print(json.dumps({"case": name, "vs_jax_lsb": float(diff.max()),
                          "vs_jax_snr_db": T._snr(want, got)}), flush=True)
    floats = []
    for name in sorted(T.FLOAT_CASES):
        kw = dict(T.FLOAT_CASES[name])
        sr, ch = kw.pop("sr"), kw.pop("ch")
        x = (T._dtx_signal(ch) if sr == 16000 else T._resampled_dtx(ch)) \
            if kw.get("dtx") else T._sig(sr, 0.5, ch, 70)
        packets = T.F.opus_packets(x, sr, **kw)[0]
        want = T._libopus_float(packets, ch)
        dec = opus.OpusDecoder(ch, native.get_lib())
        got = np.concatenate([dec.decode(p)[0] for p in packets])
        floats.append(T._snr(want, got))
        print(json.dumps({"case": name, "vs_libopus_float_snr_db":
                          floats[-1]}), flush=True)
    print(json.dumps({
        "dither_cases": len(dither),
        "worst_vs_jax_lsb": max(r["vs_jax_lsb"] for r in dither),
        "least_vs_jax_snr_db": min(r["vs_jax_snr_db"] for r in dither),
        "least_vs_libopus_float_snr_db": min(floats)}))


if __name__ == "__main__":
    sys.exit(main())
