"""Socket helpers of the wire clients (the port's copy of `recv_exact`
from ``transferia_tpu/utils/net.py``)."""

from __future__ import annotations

import socket


def recv_exact(sock: socket.socket, n: int) -> bytes:
    """Read exactly n bytes (raises ConnectionError on EOF).  Parts go to
    a list: bytes concatenation would be O(n^2) on large frames."""
    parts: list[bytes] = []
    got = 0
    while got < n:
        chunk = sock.recv(n - got)
        if not chunk:
            raise ConnectionError("connection closed by peer")
        parts.append(chunk)
        got += len(chunk)
    return b"".join(parts) if len(parts) != 1 else parts[0]
