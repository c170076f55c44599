"""The port's WS mode policy (``qwen3_asr_tpu_torch/config.py``) against the
JAX package's (``qwen3_asr_tpu/config.py``) over a grid of environment
settings: ``resolve_ws_mode`` and ``ws_warmup_profile`` give the same
modes; the port starts and warms every mode (``grouped`` and the ``auto``
policy at long caps included) and refuses, at start, a mode name it does
not know."""
import itertools

import pytest

from qwen3_asr_tpu import config as jcfg
from qwen3_asr_tpu_torch import config as tcfg

VARS = ("ASR_WS_PREFIX_CACHE", "ASR_WS_TICK_BATCH", "ASR_WS_STREAM_MODE",
        "ASR_WS_GROUP_MIN_CAP_S", "ASR_WS_TICK_MIN_SESSIONS",
        "WS_WINDOW_MAX_S")

# (name, environment)
ENVS = {
    "default": {},
    "explicit_solo": {"ASR_WS_STREAM_MODE": "solo"},
    "explicit_tick": {"ASR_WS_STREAM_MODE": "tick"},
    "explicit_auto": {"ASR_WS_STREAM_MODE": "auto"},
    "explicit_prefix": {"ASR_WS_STREAM_MODE": "prefix"},
    "explicit_grouped": {"ASR_WS_STREAM_MODE": "GROUPED"},
    "explicit_unknown": {"ASR_WS_STREAM_MODE": "turbo"},
    "legacy_tick": {"ASR_WS_TICK_BATCH": "true"},
    "legacy_off": {"ASR_WS_TICK_BATCH": "false"},
    "legacy_empty": {"ASR_WS_PREFIX_CACHE": ""},
    "legacy_prefix": {"ASR_WS_PREFIX_CACHE": "true"},
    "legacy_both": {"ASR_WS_PREFIX_CACHE": "true",
                    "ASR_WS_TICK_BATCH": "true"},
    "auto_overrides_legacy": {"ASR_WS_STREAM_MODE": "auto",
                              "ASR_WS_TICK_BATCH": "true"},
    "min_sessions_2": {"ASR_WS_TICK_MIN_SESSIONS": "2"},
    "min_sessions_bad": {"ASR_WS_TICK_MIN_SESSIONS": "three"},
    "min_cap_5": {"ASR_WS_GROUP_MIN_CAP_S": "5"},
    "min_cap_bad": {"ASR_WS_GROUP_MIN_CAP_S": "ten"},
    "cap_2": {"WS_WINDOW_MAX_S": "2.0"},
    "cap_10": {"WS_WINDOW_MAX_S": "10"},
    "cap_30": {"WS_WINDOW_MAX_S": "30"},
    "cap_bad": {"WS_WINDOW_MAX_S": "six"},
}
CAPS = (2.0, 6.0, 9.9, 10.0, 16.0)
SESSIONS = (1, 2, 3, 16)


@pytest.fixture
def env(monkeypatch):
    for var in VARS:
        monkeypatch.delenv(var, raising=False)
    return monkeypatch


def _set(env, name):
    for k, v in ENVS[name].items():
        env.setenv(k, v)


@pytest.mark.parametrize("name", list(ENVS))
def test_resolve_ws_mode_matches_jax(env, name):
    _set(env, name)
    for cap, sessions in itertools.product(CAPS, SESSIONS):
        ours = tcfg.resolve_ws_mode(cap, sessions)
        ref = jcfg.resolve_ws_mode(cap, sessions)
        assert tuple(ours) == tuple(ref), (cap, sessions)


@pytest.mark.parametrize("name", list(ENVS))
def test_ws_warmup_profile_matches_jax(env, name):
    _set(env, name)
    ours = [tuple(m) for m in tcfg.ws_warmup_profile()]
    ref = [tuple(m) for m in jcfg.ws_warmup_profile()]
    assert ours == ref
    names = {m[2] for m in ours}
    if names <= set(tcfg.PORTED_WS_MODES):
        assert [tuple(m) for m in tcfg.check_ws_modes()] == ours
    else:
        with pytest.raises(ValueError, match="not ported"):
            tcfg.check_ws_modes()


def test_default_modes_are_solo_and_tick(env):
    assert [m.name for m in tcfg.check_ws_modes()] == ["solo", "tick"]


@pytest.mark.parametrize("name", ["explicit_prefix", "explicit_grouped",
                                  "legacy_prefix", "legacy_both", "cap_10",
                                  "min_cap_5", "explicit_unknown"])
def test_manager_starts_ported_modes_and_refuses_unknown(env, name):
    """The manager starts and warms every configuration whose modes the
    port serves: ``prefix``, ``grouped`` (explicit or by the legacy
    flags) and the ``auto`` policy at a long cap, which names both. It
    refuses an unknown mode name before it warms anything or starts its
    device thread."""
    from qwen3_asr_tpu_torch.runtime.lifecycle import ModelManager

    class NoEngine:
        warmed = 0

        def warmup(self, *a, **k):
            self.warmed += 1

    _set(env, name)
    names = {m.name for m in tcfg.ws_warmup_profile()}
    mgr = ModelManager(NoEngine())
    if names <= set(tcfg.PORTED_WS_MODES):
        assert names in ({"prefix"}, {"grouped"}, {"prefix", "grouped"})
        try:
            mgr.start()
            assert mgr.engine.warmed == 1
        finally:
            mgr.stop()
        return
    with pytest.raises(ValueError, match="not ported"):
        mgr.start()
    assert mgr.engine.warmed == 0
    assert mgr.queue._thread is None
