"""The port's micro-batcher on the trained checkpoint (f32, CPU): the cases
of ``tests/test_batcher.py`` that apply to it. Concurrent same-bucket
requests make one dispatch at a power-of-two batch, and batched equals solo
token for token; other buckets, and requests that cannot batch, go
separately; a mixed-priority group dispatches express; a failure settles
every member."""
import glob
import os

import numpy as np
import pytest

import torch

from qwen3_asr_tpu_torch.audio.codec import decode_audio
from qwen3_asr_tpu_torch.runtime.batcher import MicroBatcher
from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager, load_engine
from qwen3_asr_tpu_torch.runtime.queue import EXPRESS, STANDARD

ROOT = os.path.join(os.path.dirname(__file__), "..", "e2e", "data")
CKPT = os.path.join(ROOT, "trained_ckpt")
CLIPS = sorted(glob.glob(os.path.join(ROOT, "real", "*.wav")))
WAIT = 120


@pytest.fixture(scope="module", autouse=True)
def _skip_warmup():
    """Managers here start without warming the engine's executables (the
    warmup has tests of its own in test_torch_generate.py)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SKIP_WARMUP", "true")
        yield


@pytest.fixture(autouse=True)
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engine():
    return load_engine(CKPT, device="cpu")


@pytest.fixture
def manager(engine):
    """A manager whose window is wide enough that every request of a test
    joins its group."""
    mgr = ModelManager(engine)
    mgr.batcher = MicroBatcher(mgr, window_ms=1000, max_batch=8)
    mgr.start()
    yield mgr
    mgr.stop()


@pytest.fixture
def batches(engine, monkeypatch):
    """The batch size of every engine run, in order."""
    seen = []
    orig = engine._run_bucket

    def counting(clips, *a, **k):
        seen.append(len(clips))
        return orig(clips, *a, **k)

    monkeypatch.setattr(engine, "_run_bucket", counting)
    return seen


def _clip(i, seconds=None):
    with open(CLIPS[i], "rb") as f:
        audio, sr = decode_audio(f.read())
    return audio if seconds is None else audio[:int(seconds * sr)]


def test_concurrent_same_bucket_batched(manager, batches):
    futs = [manager.batcher.transcribe(_clip(i, 0.6), 16000, "en")
            for i in range(3)]
    results = [f.result(WAIT) for f in futs]
    assert batches == [4]                      # one dispatch, padded to 4
    assert manager.batcher.dispatches == 1
    assert all(r[0].language == "en" for r in results)


def test_batched_equals_solo_token_for_token(manager, engine, batches):
    idx = [0, 3, 5, 11]                        # all four in the 10 s bucket
    futs = [manager.batcher.transcribe(_clip(i), 16000, None) for i in idx]
    batched = [f.result(WAIT)[0] for f in futs]
    assert batches == [4]
    for i, res in zip(idx, batched):
        solo = engine.transcribe(_clip(i), 16000)[0]
        assert res.token_ids == solo.token_ids
        assert (res.text, res.language, res.end_time) == (
            solo.text, solo.language, solo.end_time)


def test_different_buckets_not_batched(manager, batches):
    futs = [manager.batcher.transcribe(_clip(1, 0.5), 16000, "en"),
            manager.batcher.transcribe(_clip(2, 3.0), 16000, "en")]
    for f in futs:
        f.result(WAIT)
    assert sorted(batches) == [1, 1]


@pytest.mark.parametrize("case", ["resample", "stereo", "long", "cap1",
                                  "timestamps"])
def test_requests_that_cannot_batch_go_solo(engine, monkeypatch, case):
    """Each goes to the engine alone, through ``transcribe_sync``, with
    its ``return_timestamps``."""
    calls = []
    monkeypatch.setattr(engine, "transcribe",
                        lambda audio, sr, language, timestamps, *a, **k:
                        calls.append((audio.shape, sr, timestamps)) or [])
    mgr = ModelManager(engine)
    mgr.batcher = MicroBatcher(mgr, window_ms=1000,
                               max_batch=1 if case == "cap1" else 8)
    mgr.start()
    try:
        audio, sr = {
            "resample": (np.zeros(4000, np.float32), 8000),
            "stereo": (np.zeros((8000, 2), np.float32), 16000),
            "long": (np.zeros(31 * 16000, np.float32), 16000),
            "cap1": (np.zeros(8000, np.float32), 16000),
            "timestamps": (np.zeros(8000, np.float32), 16000),
        }[case]
        stamps = case == "timestamps"
        assert mgr.batcher.transcribe(audio, sr, None, stamps).result(
            WAIT) == []
    finally:
        mgr.stop()
    assert calls == [(audio.shape, sr, stamps)]
    assert mgr.batcher.dispatches == 1


def test_cap_rounds_down_to_a_power_of_two(engine):
    assert MicroBatcher(ModelManager(engine), window_ms=5,
                        max_batch=6).max_batch == 4


def test_mixed_priority_group_dispatches_express(manager, monkeypatch):
    seen = []
    orig = manager.queue.submit

    def spying(fn, priority=STANDARD):
        seen.append(priority)
        return orig(fn, priority=priority)

    monkeypatch.setattr(manager.queue, "submit", spying)
    futs = [manager.batcher.transcribe(_clip(1, 0.6), 16000, "en"),
            manager.batcher.transcribe(_clip(2, 0.6), 16000, "en",
                                       priority=EXPRESS)]
    for f in futs:
        f.result(WAIT)
    assert seen == [EXPRESS]


def test_failing_job_settles_every_member(manager, engine, monkeypatch):
    def broken(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(engine, "_run_bucket", broken)
    futs = [manager.batcher.transcribe(_clip(i, 0.6), 16000, "en")
            for i in range(3)]
    for f in futs:
        with pytest.raises(RuntimeError, match="device fault"):
            f.result(WAIT)


def test_stopped_queue_settles_every_member(manager):
    manager.stop()
    futs = [manager.batcher.transcribe(_clip(i, 0.6), 16000, "en")
            for i in range(2)]
    for f in futs:
        with pytest.raises(RuntimeError, match="stopped"):
            f.result(WAIT)
