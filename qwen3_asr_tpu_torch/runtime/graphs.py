"""CUDA graphs: how the port runs a request as a few replays on the card.

Counterpart of the JAX engine's one executable per bucket
(``qwen3_asr_tpu/runtime/engine.py`` ``_fused_fn``, kept in
``_generate_fns``): XLA compiles the frontend, encoder, prefill and the
``while_loop`` decode into one dispatch. PyTorch runs eagerly, so the port
captures the same work as CUDA graphs instead: ``Graph`` wraps one function
that reads and writes only persistent tensors (allocated outside it) and
replays it, and the engine keeps two per key (``runtime/engine.py``
``BucketExecutable``: everything up to the first token, and a chunk of
decode steps from ``runtime/generate.py``); the decode pool keeps one per
bucket's prefill and one per slot window's segment (``runtime/pool.py``).

On the card, building a ``Graph`` runs its function once eagerly on a side
stream (the serving path's only eager run: it builds the kernels, sets
their shared-memory opt-ins, allocates the ticket buffer, cuBLAS
workspaces and cuFFT plans, none of which a capture may do), then captures
it in thread-local mode. A failure in either raises; nothing falls back to
running eagerly. On the CPU a ``Graph`` is its function, run eagerly: the
CPU tests run the very code the card captures, on the same persistent
buffers.

Two threads drive the card: the queue's device thread (the engine's keys)
and the decode pool's. Both launch on the device's default stream, so
their replays and eager ops run one after another there. The one other
stream is the capture stream, where a build's eager run executes; a build
waits for the default stream before it starts and makes the default stream
wait for it when it ends, and it holds ``device_lock`` from start to end,
which every replay takes while it is enqueued. So no kernel of a build runs
beside a replay (the decode kernels share one ticket buffer,
``ops/decode_attention.py``), and no two captures overlap. A build also
holds ``capture_lock`` (taken before ``device_lock``), which nothing else
on the device path takes: the profiler starts and stops under both
(``serving/server.py``), so neither falls inside a capture and no replay
is enqueued while the profiler processes its records.

The wrappers' launch counters move when a kernel is launched eagerly or
recorded into a capture, never on a replay; ``Graph.recorded`` keeps what
its capture recorded and ``Graph.replays`` counts replays, so a run's
launches are the eager ones plus recorded × replays (``launches``).
``Graph.nodes`` is the number of nodes its capture holds (read through
the CUDA driver before the capture ends), and every replay adds it to a
process-wide count (``replayed_nodes``): the device records a profiler
takes of the serving path, one a node replayed, counted without a
profiler. ``wait_for_nodes`` blocks until that count has grown by a
budget, woken by the replay that crosses it: ``/debug/trace`` stops
recording there. ``Graph.collectives`` is the number of
tensor-parallel collectives (``parallel/collectives.py``) its capture
recorded: a sharded model's keys hold them.
"""
from __future__ import annotations

import ctypes
import gc
import threading
import time
from typing import Callable, Dict, Iterable, Optional

import torch

from ..parallel import collectives

# One capture stream per device: warm-up and capture run on the same stream
# (so the capture finds the cuBLAS workspace its warm-up allocated).
_capture_streams: Dict[torch.device, torch.cuda.Stream] = {}
# Held by a build from start to end and by a replay while it is enqueued.
device_lock = threading.RLock()
# Held by a build from start to end (taken before device_lock), and by the
# profiler's start and stop.
capture_lock = threading.RLock()


# Nodes of every replay so far, all graphs, and the (count, event) pairs
# of waiters to wake once it reaches count (both under device_lock).
_replayed_nodes = [0]
_node_alarms: list = []


def replayed_nodes() -> int:
    """Graph nodes replayed so far in this process, every graph."""
    return _replayed_nodes[0]


def wait_for_nodes(count: int, timeout: float) -> bool:
    """Block until ``count`` more graph nodes have been replayed (True) or
    ``timeout`` seconds have passed (False). One blocking wait, woken by
    the replay that crosses the count: nothing polls."""
    event = threading.Event()
    with device_lock:
        alarm = (_replayed_nodes[0] + count, event)
        _node_alarms.append(alarm)
    try:
        return event.wait(timeout)
    finally:
        with device_lock:
            _node_alarms.remove(alarm)


def capture_nodes(stream: torch.cuda.Stream) -> int:
    """The nodes of the graph ``stream`` is capturing, through the CUDA
    driver (a capture in progress may be read). Raises if the stream is
    not capturing or the driver refuses."""
    cu = ctypes.CDLL("libcuda.so.1")
    status, cid = ctypes.c_int(0), ctypes.c_uint64(0)
    graph, deps = ctypes.c_void_p(), ctypes.c_void_p()
    ndeps = ctypes.c_size_t()
    err = cu.cuStreamGetCaptureInfo_v2(
        ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status),
        ctypes.byref(cid), ctypes.byref(graph), ctypes.byref(deps),
        ctypes.byref(ndeps))
    if err or status.value != 1 or not graph.value:  # 1: capture active
        raise RuntimeError(f"cuStreamGetCaptureInfo_v2: error {err}, "
                           f"status {status.value}")
    n = ctypes.c_size_t(0)
    err = cu.cuGraphGetNodes(graph, None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: error {err}")
    return n.value


def kernel_launches() -> Dict[str, int]:
    """The launch counters of the kernels a request runs (#1-#3, #3's
    int4 route, the quantized GEMV and GEMM and the QK-norm + RoPE + cache
    write, and of its launches those with one write position a row), the
    W8A8 products (``torch._int_mm``), and the calls of
    ``widened_product`` on the card, which the path never makes (its
    cuBLAS route widened a whole layer)."""
    from ..ops.decode_attention import decode_attention
    from ..ops.decode_attention_batch import decode_attention_batched
    from ..ops.flash_attention import flash_attention
    from ..ops.qgemm import qgemm, widened_product
    from ..ops.qgemv import qgemv
    from ..ops.qk_rope_kv import qk_rope_kv_write
    from ..ops.quant import w8a8
    return {"flash_attention": flash_attention.launches,
            "decode_attention": decode_attention.launches,
            "decode_attention_batch": decode_attention_batched.launches,
            "decode_attention_batch_int4":
                decode_attention_batched.launches_int4,
            "qgemv": qgemv.launches,
            "qgemm": qgemm.launches,
            "widened_product": widened_product.cuda_calls,
            "w8a8": w8a8.calls,
            "qk_rope_kv": qk_rope_kv_write.launches,
            "qk_rope_kv_per_row": qk_rope_kv_write.launches_per_row}


class Graph:
    """``fn`` as a CUDA graph on a CUDA device, or as itself on the CPU.

    ``fn`` takes no arguments and touches only tensors that outlive it, so
    a replay redoes its work on whatever those tensors hold. Graphs built
    with one ``pool`` share their memory for temporaries; that is safe
    because nothing a graph leaves for later lives in the pool and replays
    never overlap: every replay runs on the default stream, and no build's
    eager run beside one (``device_lock``). The engine's keys share one
    pool and the decode pool's graphs another."""

    def __init__(self, fn: Callable[[], None], device: torch.device,
                 pool=None):
        self.fn = fn
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.recorded: Dict[str, int] = {}
        self.replays = 0
        self.nodes = 0           # the capture's graph nodes
        self.collectives = 0     # tp collectives the capture recorded
        self.capture_s = 0.0     # warm-up run and capture, seconds
        if device.type != "cuda":
            return
        with capture_lock, device_lock:
            self._build(fn, device, pool)

    def _build(self, fn, device, pool) -> None:
        t0 = time.perf_counter()
        stream = _capture_streams.get(device)
        if stream is None:
            stream = _capture_streams[device] = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.inference_mode(), torch.cuda.stream(stream):
            fn()
        torch.cuda.current_stream(device).wait_stream(stream)
        before = kernel_launches()
        calls = collectives.calls()
        graph = torch.cuda.CUDAGraph()
        # No garbage collection inside the capture: it could free another
        # graph (one left in a reference cycle, e.g. by a failed build),
        # and destroying a graph invalidates a capture in progress.
        # torch.cuda.graph collects once before it begins.
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.inference_mode(), torch.cuda.graph(
                    graph, pool=pool, stream=stream,
                    capture_error_mode="thread_local"):
                fn()
                self.nodes = capture_nodes(stream)
        finally:
            if collecting:
                gc.enable()
        after = kernel_launches()
        self.recorded = {k: after[k] - before[k] for k in after}
        self.collectives = collectives.calls() - calls
        self.graph = graph
        self.capture_s = time.perf_counter() - t0

    def __call__(self) -> None:
        if self.graph is None:
            self.fn()
            return
        with device_lock:
            self.graph.replay()
            self.replays += 1
            _replayed_nodes[0] += self.nodes
            for count, event in _node_alarms:
                if _replayed_nodes[0] >= count:
                    event.set()


def launches(graphs: Iterable[Graph], eager: Dict[str, int]
             ) -> Dict[str, int]:
    """Each kernel's launches: ``eager`` (the counters' reading) plus, for
    every graph, what its capture recorded times its replays."""
    total = dict(eager)
    for g in graphs:
        for name, n in g.recorded.items():
            total[name] = total.get(name, 0) + n * g.replays
    return total
