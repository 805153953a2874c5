"""Minimal RFC 6455 WebSocket support, server side.

Port of ``kubernetes_tpu/util/websocket.py``.

ref: pkg/apiserver/watch.go:62-126 serves watch streams over WebSocket
(golang.org/x/net/websocket) alongside chunked JSON; this is the
dependency-free equivalent: handshake + text-frame writer + a client
frame reader good enough to notice CLOSE (and answer PING), which is all
a one-way event stream needs. Masked client frames are unmasked per the
spec; server frames go out unmasked as required.
"""

from __future__ import annotations

import base64
import hashlib
import struct
from typing import Optional, Tuple

__all__ = ["accept_key", "wants_websocket", "send_text", "send_close",
           "read_frame", "build_frame", "text_frame",
           "OP_TEXT", "OP_CLOSE", "OP_PING", "OP_PONG"]

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

OP_CONT, OP_TEXT, OP_BIN = 0x0, 0x1, 0x2
OP_CLOSE, OP_PING, OP_PONG = 0x8, 0x9, 0xA


def accept_key(client_key: str) -> str:
    """Sec-WebSocket-Accept for a Sec-WebSocket-Key."""
    digest = hashlib.sha1((client_key + _GUID).encode("ascii")).digest()
    return base64.b64encode(digest).decode("ascii")


def wants_websocket(headers) -> bool:
    upgrade = (headers.get("Upgrade") or "").lower()
    connection = (headers.get("Connection") or "").lower()
    return "websocket" in upgrade and "upgrade" in connection \
        and bool(headers.get("Sec-WebSocket-Key"))


def build_frame(opcode: int, payload: bytes) -> bytes:
    """One unmasked FIN frame as bytes — cacheable: a server text frame
    for a given payload is byte-identical for every connection, so the
    watch fan-out builds it once per (revision, version) and every
    watcher writes the same bytes."""
    header = bytearray([0x80 | opcode])
    n = len(payload)
    if n < 126:
        header.append(n)
    elif n < (1 << 16):
        header.append(126)
        header += struct.pack(">H", n)
    else:
        header.append(127)
        header += struct.pack(">Q", n)
    return bytes(header) + payload


def text_frame(payload: bytes) -> bytes:
    """One unmasked FIN text frame as bytes (see build_frame)."""
    return build_frame(OP_TEXT, payload)


def _send_frame(wfile, opcode: int, payload: bytes) -> None:
    wfile.write(build_frame(opcode, payload))
    wfile.flush()


def send_text(wfile, payload: bytes) -> None:
    """One unmasked FIN text frame."""
    _send_frame(wfile, OP_TEXT, payload)


def send_binary(wfile, payload: bytes) -> None:
    """One unmasked FIN binary frame."""
    _send_frame(wfile, OP_BIN, payload)


def send_close(wfile, code: int = 1000) -> None:
    payload = struct.pack(">H", code)
    wfile.write(bytes([0x80 | OP_CLOSE, len(payload)]) + payload)
    wfile.flush()


def send_pong(wfile, payload: bytes = b"") -> None:
    wfile.write(bytes([0x80 | OP_PONG, len(payload)]) + payload)
    wfile.flush()


MAX_FRAME = 1 << 20  # incoming cap: a watch client only sends control frames


def read_frame(rfile) -> Optional[Tuple[int, bytes]]:
    """(opcode, payload) or None on EOF or an oversized/hostile length.
    Client frames must be masked."""
    head = rfile.read(2)
    if len(head) < 2:
        return None
    opcode = head[0] & 0x0F
    masked = bool(head[1] & 0x80)
    n = head[1] & 0x7F
    if n == 126:
        ext = rfile.read(2)
        if len(ext) < 2:
            return None
        (n,) = struct.unpack(">H", ext)
    elif n == 127:
        ext = rfile.read(8)
        if len(ext) < 8:
            return None
        (n,) = struct.unpack(">Q", ext)
    if n > MAX_FRAME:
        # a client-declared multi-GB length must not drive an allocation
        # (RFC 6455 caps control frames at 125 bytes anyway)
        return None
    mask = rfile.read(4) if masked else b""
    payload = rfile.read(n) if n else b""
    if len(payload) < n:
        return None
    if masked and mask:
        payload = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    return opcode, payload
