"""Worker process: the internal API that the gateway supervises.

Counterpart of ``qwen3_asr_tpu/serving/worker.py``: the same internal
routes (``GET /health`` with ``"mode": "worker"``, ``POST /transcribe``,
``/subtitles``, ``/translate``, ``/transcribe/stream``, ``WS
/ws/transcribe``), the server's handler machinery (``serving/server.py``)
under a second route table, and an eager load at start (the public
server loads on the first request). JAX's deltas from the public server
are kept: ``EMPTY_AUDIO`` and ``INVALID_MODE`` answer 400, not 422;
``/translate`` with ``response_format=srt`` builds ``accurate`` subtitles
(the public server's are ``fast``); an aligner that fails to load answers
503 ``WORKER_ERROR``.

Run: ``MODEL_ID=e2e/data/trained_ckpt python -m
qwen3_asr_tpu_torch.serving.worker [--host WORKER_HOST] [--port
WORKER_PORT] [--device cuda] [--dtype float32]``. It never falls back to
the CPU: with no
card and no ``--device cpu`` the load fails and the process exits 1, as it
does on any failed load or invalid environment.
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import Optional

from .. import config
from ..runtime.lifecycle import ModelManager
from ..utils.logging import setup_logging
from .server import AsrServer, _Handler

log = logging.getLogger(__name__)


class WorkerHandler(_Handler):
    """The server's handler under the worker's route table."""

    def routes(self, method: str) -> dict:
        if method == "GET":
            return {"/health": self._worker_health,
                    "/ws/transcribe": self._websocket}
        return {"/transcribe": self._upload(self._transcriptions),
                "/transcribe/stream": self._upload(self._stream),
                "/subtitles": self._upload(self._worker_subtitles,
                                           load=False),
                "/translate": self._upload(self._worker_translate)}

    def _worker_health(self):
        self._json(200, {**self.server.manager_health(), "mode": "worker"})

    def _worker_subtitles(self, fields: dict, file_bytes: Optional[bytes]):
        """INVALID_MODE and EMPTY_AUDIO are 400, checked before the load;
        an aligner failure is always WORKER_ERROR."""
        route = "POST /subtitles"
        mode = fields.get("mode", "accurate")
        if mode not in ("accurate", "fast"):
            self._error("INVALID_MODE",
                        f"Invalid mode: {mode!r}. Must be 'accurate' or "
                        "'fast'.", 400, mode=mode)
            return
        if not file_bytes:
            self._error("EMPTY_AUDIO", "Empty audio file", 400)
            return
        self._ensure_loaded()
        t0 = time.time()
        audio, sr = self._decode(file_bytes)
        self._subtitle_core(fields, audio, sr, mode, route, t0,
                            lambda e: "WORKER_ERROR")

    def _worker_translate(self, fields: dict, file_bytes: Optional[bytes]):
        """EMPTY_AUDIO is 400; the SRT format uses accurate subtitles."""
        if not file_bytes:
            self._error("EMPTY_AUDIO", "Empty audio file", 400)
            return
        t0 = time.time()
        audio, sr = self._decode(file_bytes)
        self._translate_core(fields, audio, sr, "accurate", None,
                             "POST /translate", t0)


def build_worker(manager: ModelManager, host: str = "127.0.0.1",
                 port: int = 0) -> AsrServer:
    """A worker's server for a started manager (see ``build_server``)."""
    return AsrServer(manager, host, port, handler=WorkerHandler)


def main():
    parser = argparse.ArgumentParser(
        description="Qwen3-ASR worker (PyTorch)")
    parser.add_argument("--host",
                        default=os.getenv("WORKER_HOST", "127.0.0.1"))
    parser.add_argument("--port", type=int,
                        default=int(os.getenv("WORKER_PORT", "8001")))
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--dtype", choices=("float32", "bfloat16"),
                        help="the weights' dtype (default: bfloat16 on the "
                             "card, float32 on the CPU)")
    args = parser.parse_args()
    setup_logging()
    config.validate_env()
    log.info("Worker starting up...")
    import torch
    manager = ModelManager(device=args.device,
                           dtype=getattr(torch, args.dtype) if args.dtype
                           else None)
    manager.start()
    try:
        manager.ensure_loaded()          # eager, before the port is bound
    except Exception:
        log.exception("Worker failed to load %s on %s",
                      os.environ["MODEL_ID"], args.device)
        manager.stop()
        sys.exit(1)
    server = build_worker(manager, args.host, args.port)
    log.info("Worker ready on %s:%d", args.host, server.server_address[1])
    try:
        server.serve_forever()
    finally:
        server.server_close()
        manager.stop()


if __name__ == "__main__":
    main()
