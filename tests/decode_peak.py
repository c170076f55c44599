"""The wall and the peak memory of an upload's decode, as the server
decodes it (``decode_audio``: MP3 and Ogg Vorbis folded to mono).

    PYTHONPATH=. python tests/decode_peak.py [--repeats N] FILE [FILE ...]

prints one JSON line a file: ``ms``, the best of N (3) untraced decodes
after a warm-up; ``peak``, the most bytes numpy and Python held at once
during one more decode, traced by ``tracemalloc``; and the mono float32
output's bytes (``out``), samples and rate. With no FILE it reads one
upload from standard input. The package comes from ``PYTHONPATH``, which
picks the tree to measure.
"""
import json
import sys
import time
import tracemalloc


def measure(data: bytes, repeats: int = 3) -> dict:
    from qwen3_asr_tpu_torch.audio import native
    from qwen3_asr_tpu_torch.audio.codec import AudioDecodeError, decode_audio
    native.get_lib()
    try:  # the modules and their tables in memory before the reading
        decode_audio(data[:65536])
    except AudioDecodeError:
        pass
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        decode_audio(data)
        best = min(best, time.perf_counter() - t0)
    tracemalloc.start()
    audio, sr = decode_audio(data)
    peak = tracemalloc.get_traced_memory()[1]
    tracemalloc.stop()
    return {"ms": best * 1e3, "peak": peak, "out": audio.nbytes,
            "samples": len(audio), "sr": sr}


def main(args) -> None:
    repeats = 3
    if args[:1] == ["--repeats"]:
        repeats, args = int(args[1]), args[2:]
    for path in args or [None]:
        if path is None:
            data = sys.stdin.buffer.read()
        else:
            with open(path, "rb") as f:
                data = f.read()
        print(json.dumps({"file": path, **measure(data, repeats)}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
