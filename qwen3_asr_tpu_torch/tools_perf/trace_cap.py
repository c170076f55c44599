"""What a ``/debug/trace`` capture costs the serving process, on the card.

Starts the port's server (``python -m qwen3_asr_tpu_torch.serving.server``)
with ``MODEL_ID=preset:1.7b`` (bf16, the preset's zero weights, so every
upload decodes to its token limit), keeps ``CLIENTS`` uploads of 29.5 s
of the in-repo speech running back to back, and takes one capture of each
length in ``--seconds`` through ``POST /debug/trace``. For each it reports
the server's resident memory before the capture, its peak during it
and after the answer (``VmRSS`` of ``/proc/<pid>/status``, sampled every
0.2 s), the request's wall, what the answer says (the seconds recorded,
the device records, whether the budget ended the recording), the seconds
from the request until a ``*.json`` file appears in the trace directory
(``file_s``: the recording, the stop and the writing; the server's log
times the stop and the writing apart), the trace file's size and its
kernel events, and the uploads finished during the request and by the
time the file appeared, against those finished in as many seconds just
before, without a capture (``upload_rate_share``: the rate over the
request's wall against the rate without). Each trace file is deleted once
counted.

Run on a machine with the card:

    python -m qwen3_asr_tpu_torch.tools_perf.trace_cap --seconds 3,60 \
        --server-log trace_cap_server.log

It prints the card's line, then one JSON object a capture.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
import uuid

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(os.path.dirname(HERE))
REAL = os.path.join(CHECKOUT, "e2e", "data", "real")
KERNEL_EVENT = re.compile(rb'"cat":\s*"kernel"')
CLIENTS = 4        # uploads in flight at once: the server batches them


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def upload_wav(seconds: float = 29.5) -> bytes:
    """The first ``seconds`` of the in-repo clips, one after another, as
    a 16 kHz WAV."""
    sys.path.insert(0, CHECKOUT)
    from qwen3_asr_tpu_torch.audio.codec import decode_audio, encode_wav
    parts = []
    for path in sorted(glob.glob(os.path.join(REAL, "*.wav"))):
        with open(path, "rb") as f:
            parts.append(decode_audio(f.read())[0])
    audio = np.concatenate(parts)
    reps = int(np.ceil(seconds * 16000 / len(audio)))
    return encode_wav(np.tile(audio, reps)[:int(seconds * 16000)], 16000)


def post(url: str, data: bytes = b"", content_type: str = None,
         timeout: float = 900):
    """(status, body) of one POST, whatever the status."""
    headers = {"Content-Type": content_type} if content_type else {}
    req = urllib.request.Request(url, data=data, method="POST",
                                 headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def multipart(wav: bytes):
    bnd = uuid.uuid4().hex
    body = (f"--{bnd}\r\nContent-Disposition: form-data; name=\"file\"; "
            f"filename=\"a.wav\"\r\n\r\n").encode() + wav + \
        f"\r\n--{bnd}--\r\n".encode()
    return body, f"multipart/form-data; boundary={bnd}"


def rss_mib(pid: int) -> float:
    with open(f"/proc/{pid}/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    return float("nan")


def kernel_events(path: str) -> int:
    """``"cat": "kernel"`` events in a Chrome trace, read in 64 MiB
    pieces (the file may not fit a parse in memory)."""
    count, tail = 0, b""
    with open(path, "rb") as f:
        while True:
            chunk = f.read(64 << 20)
            if not chunk:
                return count
            data = tail + chunk
            hits = list(KERNEL_EVENT.finditer(data))
            # a match inside the kept tail was counted with the last piece
            count += sum(1 for m in hits if m.end() > len(tail))
            tail = data[-32:]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def wait_ready(base: str, proc, timeout: float = 600) -> None:
    t_end = time.time() + timeout
    while time.time() < t_end:
        if proc.poll() is not None:
            raise RuntimeError(f"the server exited {proc.returncode}")
        try:
            with urllib.request.urlopen(base + "/health", timeout=5):
                return
        except (urllib.error.URLError, OSError):
            time.sleep(0.5)
    raise RuntimeError("the server did not answer /health")


def capture(base: str, pid: int, seconds: float, trace_dir: str,
            done: list, card: str) -> dict:
    """One capture of ``seconds`` while the clients upload, after as many
    seconds without one."""
    uploads0 = len(done)
    time.sleep(seconds)
    without = len(done) - uploads0
    before = rss_mib(pid)
    peak, stop, seen = [before], threading.Event(), {}

    def sample():
        while not stop.wait(0.2):
            peak.append(rss_mib(pid))
            if "file" not in seen and glob.glob(
                    os.path.join(trace_dir, "*.json")):
                # the profiler has stopped: its trace is being written
                seen["file"] = (time.perf_counter(), len(done))
    sampler = threading.Thread(target=sample, daemon=True)
    sampler.start()
    uploads0 = len(done)
    t0 = time.perf_counter()
    status, body = post(f"{base}/debug/trace?seconds={seconds:g}",
                        timeout=seconds + 900)
    t1 = time.perf_counter()
    stop.set()
    sampler.join()
    after = rss_mib(pid)
    files = sorted(glob.glob(os.path.join(trace_dir, "*.json")),
                   key=os.path.getmtime)
    if status != 200 or not files:
        raise RuntimeError(f"capture of {seconds} s: {status} "
                           f"{body[:200]!r}, files {files}")
    size = os.path.getsize(files[-1])
    kernels = kernel_events(files[-1])
    for path in files:
        os.remove(path)
    # a trace written between two samples: its writing took under 0.2 s
    t_file, uploads_file = seen.get("file", (t1, len(done)))
    answer = json.loads(body)
    during, wall = len(done) - uploads0, t1 - t0
    return {"seconds": seconds, "status": status,
            "request_wall_s": wall,
            "captured_s": answer.get("captured_seconds"),
            "budget_reached": answer.get("budget_reached"),
            "kernel_records": answer.get("kernel_records"),
            "file_s": t_file - t0,
            "rss_before_mib": before, "rss_peak_mib": max(peak),
            "rss_after_mib": after, "trace_mb": size / 1e6,
            "kernel_events": kernels, "uploads_without": without,
            "uploads_during": during,
            "uploads_by_file": uploads_file - uploads0,
            # uploads a second over the request's wall against those a
            # second in as many seconds just before, without a capture
            "upload_rate_share": (during / wall) / (without / seconds)
            if without else None, "card": card}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seconds", default="3,60",
                        help="capture lengths, comma-separated")
    parser.add_argument("--server-log", default=None,
                        help="a file for the server's output (default: "
                             "this script's)")
    args = parser.parse_args()
    card = card_line()
    t_start = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[trace_cap {time.perf_counter() - t_start:7.1f} s] {msg}",
              flush=True)
    say(card)
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    url = base + "/v1/audio/transcriptions"
    body, ctype = multipart(upload_wav())
    out = open(args.server_log, "w") if args.server_log else None
    with tempfile.TemporaryDirectory() as trace_dir:
        env = dict(os.environ, MODEL_ID="preset:1.7b",
                   ASR_TRACE_DIR=trace_dir, IDLE_TIMEOUT="0")
        # faulthandler: a SIGABRT on failure prints every server thread
        proc = subprocess.Popen(
            [sys.executable, "-X", "faulthandler", "-m",
             "qwen3_asr_tpu_torch.serving.server", "--host", "127.0.0.1",
             "--port", str(port)],
            cwd=CHECKOUT, env=env, stdout=out, stderr=out)
        stop, done, failed = threading.Event(), [], []

        def client():
            while not stop.is_set():
                try:
                    status, answer = post(url, body, ctype, timeout=300)
                except OSError as e:
                    status, answer = None, repr(e).encode()
                (done if status == 200 else failed).append(
                    (status, answer[:200]))
        ok = False
        try:
            wait_ready(base, proc)
            say("server up; the first upload loads the model")
            status, answer = post(url, body, ctype, timeout=600)
            if status != 200:
                raise RuntimeError(f"warm upload {status} {answer[:200]!r}")
            say(f"loaded; {CLIENTS} clients start")
            clients = [threading.Thread(target=client, daemon=True)
                       for _ in range(CLIENTS)]
            for t in clients:
                t.start()
            time.sleep(10)   # each batch key met once before a capture
            say(f"{len(done)} uploads done, {len(failed)} failed")
            for seconds in (float(s) for s in args.seconds.split(",")):
                row = capture(base, proc.pid, seconds, trace_dir, done, card)
                row["clients"] = CLIENTS
                print(json.dumps(row), flush=True)
                say(f"{len(done)} uploads done, {len(failed)} failed")
            stop.set()
            for t in clients:
                t.join(timeout=330)
            if failed:
                raise RuntimeError(f"{len(failed)} uploads failed: "
                                   f"{failed[:3]}")
            ok = True
        finally:
            stop.set()
            if not ok and proc.poll() is None:
                proc.send_signal(signal.SIGABRT)
            else:
                proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            if out:
                out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
