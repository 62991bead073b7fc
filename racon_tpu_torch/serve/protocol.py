"""Length-prefixed JSON frames for the warm polishing service.

The port's copy of the JAX package's racon_tpu/serve/protocol.py, the
same wire format. One frame is an 8-byte header (the 4-byte magic
``RTPU`` and a 4-byte big-endian payload length) followed by a UTF-8
JSON object payload. JSON keeps the wire debuggable and free of
dependencies; the length prefix makes framing O(1) and lets a server
bound memory before it reads a payload. Polished FASTA rides inside the
JSON as a latin-1 string, lossless for arbitrary bytes.

Malformed input, and what the stream can still do after it:

  - a payload longer than ``max_frame`` (default 256 MiB, a parameter
    of `recv_frame`): the declared bytes are read and discarded in
    bounded chunks, so the stream stays framed, then `FrameTooLarge`;
  - a payload that is not a JSON object: `FrameGarbage`, the stream
    still framed;
  - a bad magic: `FrameGarbage` with ``resync=False``: the stream can no
    longer be trusted, so the connection is to be closed;
  - EOF mid-frame: `FrameTruncated` (``resync=False``): the peer is
    gone.

Each ProtocolError carries its wire error ``code``; `error_response`
builds the typed ``error`` frame. The request and response types come
with the server.
"""

from __future__ import annotations

import json
import socket
import struct

MAGIC = b"RTPU"
_HEADER = struct.Struct(">4sI")

#: discard granularity while draining an oversized payload
_DRAIN_CHUNK = 1 << 16

#: the default receive ceiling: what an untrusted peer can make the
#: receiver buffer (a client reading results from a trusted server
#: passes WIRE_LIMIT instead)
DEFAULT_MAX_FRAME = 256 << 20


class ProtocolError(Exception):
    """Base for frame-level failures; `code` is the wire error code."""

    code = "bad-frame"
    #: whether the stream is still framed after this error (the server
    #: may answer and keep the connection)
    resync = True

    def __init__(self, message: str, resync: bool | None = None):
        super().__init__(message)
        if resync is not None:
            self.resync = resync


class FrameTooLarge(ProtocolError):
    code = "frame-too-large"


class FrameGarbage(ProtocolError):
    code = "bad-frame"


class FrameTruncated(ProtocolError):
    code = "bad-frame"
    resync = False


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly `n` bytes; b"" on clean EOF at offset 0,
    FrameTruncated on EOF mid-read."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(n - got, _DRAIN_CHUNK))
        if not chunk:
            if got == 0:
                return b""
            raise FrameTruncated(
                f"connection closed mid-frame ({got}/{n} bytes)")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


#: hard wire limit: the length prefix is a u32
WIRE_LIMIT = 0xFFFFFFFF


def send_frame(sock: socket.socket, obj: dict) -> None:
    payload = json.dumps(obj, separators=(",", ":")).encode()
    if len(payload) > WIRE_LIMIT:
        # the u32 length prefix cannot carry it: raise typed instead of
        # letting struct.error escape mid-send
        raise FrameTooLarge(
            f"frame of {len(payload)} bytes exceeds the 4 GiB wire "
            "limit")
    sock.sendall(_HEADER.pack(MAGIC, len(payload)) + payload)


def recv_frame(sock: socket.socket,
               max_frame: int = DEFAULT_MAX_FRAME) -> dict | None:
    """Read one frame; None on clean EOF (peer closed between frames).
    Raises the ProtocolError taxonomy above on malformed input."""
    limit = max_frame
    header = _recv_exact(sock, _HEADER.size)
    if not header:
        return None
    magic, length = _HEADER.unpack(header)
    if magic != MAGIC:
        raise FrameGarbage(
            f"bad frame magic {magic!r} (stream desynced)", resync=False)
    if length > limit:
        # the peer did send these bytes: drain them so the stream stays
        # framed, then report; the connection survives
        left = length
        while left > 0:
            chunk = sock.recv(min(left, _DRAIN_CHUNK))
            if not chunk:
                raise FrameTruncated(
                    "connection closed draining oversized frame")
            left -= len(chunk)
        raise FrameTooLarge(
            f"frame of {length} bytes exceeds limit {limit}")
    payload = _recv_exact(sock, length)
    if length and not payload:
        raise FrameTruncated("connection closed before frame payload")
    try:
        obj = json.loads(payload.decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise FrameGarbage(f"frame payload is not JSON ({exc})") from None
    if not isinstance(obj, dict):
        raise FrameGarbage(
            f"frame payload is {type(obj).__name__}, expected object")
    return obj


def error_response(code: str, message: str, **extra) -> dict:
    out = {"type": "error", "code": code, "message": message}
    out.update(extra)
    return out
