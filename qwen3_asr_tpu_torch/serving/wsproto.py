"""RFC 6455 on the standard library: the opening handshake, the frame codec
and a client.

The card's machine has neither ``aiohttp`` nor ``websockets``. This module
holds the protocol alone, with no ``torch`` and no ``numpy``, so that the
gateway (``serving/gateway.py``) relays WebSocket traffic without loading
either: ``accept_key`` (``Sec-WebSocket-Accept``), ``WebSocket`` (text,
binary, continuation, ping/pong and close frames; client frames masked,
server frames not; no extension, so no per-message deflate), ``upgrade``
for a request that reached a ``BaseHTTPRequestHandler`` and ``connect``, a
client for the gateway, tests and smoke runs. ``serving/ws.py`` serves the
transcription session on it.
"""
from __future__ import annotations

import base64
import hashlib
import json
import os
import socket
import struct
import threading
from typing import NamedTuple, Optional, Tuple
from urllib.parse import urlsplit

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
OP_CONT, OP_TEXT, OP_BINARY = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA
CLOSE_NORMAL, CLOSE_PROTOCOL, CLOSE_TOO_BIG = 1000, 1002, 1009
CLOSE_TRY_AGAIN_LATER = 1013
MAX_MESSAGE = 16 * 1024 ** 2


def accept_key(key: str) -> str:
    """``Sec-WebSocket-Accept`` for a client's ``Sec-WebSocket-Key``."""
    digest = hashlib.sha1((key + _GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


class Message(NamedTuple):
    kind: str           # "text" | "binary" | "close"
    data: object        # str, bytes, or the close code (int or None)

    def json(self):
        return json.loads(self.data)


class ProtocolError(Exception):
    def __init__(self, msg: str, code: int = CLOSE_PROTOCOL):
        super().__init__(msg)
        self.code = code


class WebSocket:
    """One end of a WebSocket connection over a socket's buffered reader
    and its writer. ``client`` ends mask their frames and expect none
    masked; a server end the reverse. One thread reads it; frames are
    written whole under a lock, so another thread may send (the gateway's
    relay sends on a connection that its other thread reads)."""

    def __init__(self, rfile, wfile, client: bool,
                 sock: Optional[socket.socket] = None):
        self.rfile, self.wfile, self.client, self.sock = (rfile, wfile,
                                                          client, sock)
        self.closed = False        # a close frame was sent
        self._write_lock = threading.Lock()

    # frames
    def _read_exact(self, n: int) -> bytes:
        data = self.rfile.read(n)
        if data is None or len(data) < n:
            raise ConnectionError("connection closed mid-frame")
        return data

    def _read_frame(self) -> Tuple[bool, int, bytes]:
        b1, b2 = self._read_exact(2)
        fin, op = bool(b1 & 0x80), b1 & 0x0F
        if b1 & 0x70:
            raise ProtocolError("reserved bits set (no extension agreed)")
        masked, n = bool(b2 & 0x80), b2 & 0x7F
        if masked == self.client:
            raise ProtocolError("client frames must be masked and server "
                                "frames not")
        if n == 126:
            n = struct.unpack(">H", self._read_exact(2))[0]
        elif n == 127:
            n = struct.unpack(">Q", self._read_exact(8))[0]
        if op >= 0x8 and (n > 125 or not fin):
            raise ProtocolError("a control frame is short and whole")
        if n > MAX_MESSAGE:
            raise ProtocolError("message too big", CLOSE_TOO_BIG)
        mask = self._read_exact(4) if masked else None
        data = self._read_exact(n)
        if mask is not None:
            data = _apply_mask(data, mask)
        return fin, op, data

    def _write_frame(self, op: int, data: bytes) -> None:
        head = bytearray([0x80 | op])
        n = len(data)
        bit = 0x80 if self.client else 0
        if n < 126:
            head.append(bit | n)
        elif n < 1 << 16:
            head.append(bit | 126)
            head += struct.pack(">H", n)
        else:
            head.append(bit | 127)
            head += struct.pack(">Q", n)
        if self.client:
            mask = os.urandom(4)
            head += mask
            data = _apply_mask(data, mask)
        with self._write_lock:
            self.wfile.write(bytes(head) + data)
            self.wfile.flush()

    # messages
    def send_text(self, text: str) -> None:
        self._write_frame(OP_TEXT, text.encode("utf-8"))

    def send_json(self, obj) -> None:
        self.send_text(json.dumps(obj))

    def send_bytes(self, data: bytes) -> None:
        self._write_frame(OP_BINARY, bytes(data))

    def close(self, code: int = CLOSE_NORMAL, reason: str = "") -> None:
        """Send a close frame (once)."""
        if self.closed:
            return
        self.closed = True
        try:
            self._write_frame(OP_CLOSE, struct.pack(">H", code)
                              + reason.encode("utf-8")[:120])
        except OSError:
            pass

    def receive(self, timeout: Optional[float] = None) -> Message:
        """The next data message, assembled from its fragments; pings are
        answered on the way. A close frame is answered and returned as
        ``Message("close", code)``; a connection that ends returns one
        with code None."""
        if self.sock is not None:
            self.sock.settimeout(timeout)
        kind, parts = None, []
        try:
            while True:
                fin, op, data = self._read_frame()
                if op == OP_PING:
                    self._write_frame(OP_PONG, data)
                    continue
                if op == OP_PONG:
                    continue
                if op == OP_CLOSE:
                    code = (struct.unpack(">H", data[:2])[0]
                            if len(data) >= 2 else None)
                    self.close(code or CLOSE_NORMAL)
                    return Message("close", code)
                if op == OP_CONT:
                    if kind is None:
                        raise ProtocolError("continuation of nothing")
                elif op in (OP_TEXT, OP_BINARY):
                    if kind is not None:
                        raise ProtocolError("a new message inside another")
                    kind = "text" if op == OP_TEXT else "binary"
                else:
                    raise ProtocolError(f"unknown opcode {op}")
                parts.append(data)
                if sum(map(len, parts)) > MAX_MESSAGE:
                    raise ProtocolError("message too big", CLOSE_TOO_BIG)
                if fin:
                    body = b"".join(parts)
                    if kind == "text":
                        return Message("text", body.decode("utf-8"))
                    return Message("binary", body)
        except ProtocolError as e:
            self.close(e.code, str(e))
            return Message("close", e.code)
        except (ConnectionError, OSError, UnicodeDecodeError):
            self.closed = True
            return Message("close", None)

    def receive_json(self, timeout: Optional[float] = None):
        msg = self.receive(timeout)
        if msg.kind != "text":
            raise ConnectionError(f"expected a text message, got "
                                  f"{msg.kind} {msg.data!r}")
        return msg.json()


def _apply_mask(data: bytes, mask: bytes) -> bytes:
    """XOR ``data`` with the 4-byte ``mask`` repeated, as one integer."""
    n = len(data)
    if not n:
        return data
    key = (mask * (n // 4 + 1))[:n]
    return (int.from_bytes(data, "little")
            ^ int.from_bytes(key, "little")).to_bytes(n, "little")


def upgrade(handler) -> Optional[WebSocket]:
    """Answer a ``BaseHTTPRequestHandler``'s WebSocket opening handshake
    with 101 and return the server end, or answer 400 and return None."""
    h = handler.headers
    key = h.get("Sec-WebSocket-Key", "")
    if ("websocket" not in h.get("Upgrade", "").lower()
            or "upgrade" not in h.get("Connection", "").lower()
            or h.get("Sec-WebSocket-Version") != "13" or not key):
        body = json.dumps({"code": "BAD_REQUEST", "statusCode": 400,
                           "message": "expected a WebSocket upgrade "
                                      "(version 13)"}).encode("utf-8")
        handler.send_response(400)
        handler.send_header("Content-Type", "application/json")
        handler.send_header("Content-Length", str(len(body)))
        handler.send_header("Sec-WebSocket-Version", "13")
        handler.end_headers()
        handler.wfile.write(body)
        return None
    handler.send_response(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    handler.close_connection = True
    return WebSocket(handler.rfile, handler.wfile, client=False,
                     sock=handler.connection)


def connect(url: str, timeout: float = 30.0) -> WebSocket:
    """A client end for ``ws://host:port/path?query``."""
    parts = urlsplit(url)
    if parts.scheme != "ws":
        raise ValueError(f"only ws:// URLs, got {url}")
    sock = socket.create_connection((parts.hostname, parts.port or 80),
                                    timeout=timeout)
    key = base64.b64encode(os.urandom(16)).decode("ascii")
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query
    sock.sendall((f"GET {path} HTTP/1.1\r\nHost: {parts.netloc}\r\n"
                  f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
                  f"Sec-WebSocket-Key: {key}\r\n"
                  f"Sec-WebSocket-Version: 13\r\n\r\n").encode("ascii"))
    rfile = sock.makefile("rb")
    status = rfile.readline().decode("latin-1")
    headers = {}
    while True:
        line = rfile.readline().decode("latin-1").strip()
        if not line:
            break
        name, _, value = line.partition(":")
        headers[name.strip().lower()] = value.strip()
    if " 101 " not in status + " " or \
            headers.get("sec-websocket-accept") != accept_key(key):
        sock.close()
        raise ConnectionError(f"handshake refused: {status.strip()}")
    return WebSocket(rfile, sock.makefile("wb"), client=True, sock=sock)
