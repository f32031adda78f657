"""Socket helpers of the wire clients (the port's copy of `recv_exact`
and `BufferedSock` from ``transferia_tpu/utils/net.py``)."""

from __future__ import annotations

import socket


class BufferedSock:
    """Read-buffering wrapper over a socket (drop-in for recv_exact).

    Wire clients parse many small frames (a PG COPY row, a MySQL packet,
    a RowBinary value): raw per-frame recv() means 2+ syscalls per frame
    and dominates wall time on fast links.  This wrapper refills a local
    buffer in large chunks and serves recv() from it; writes and every
    other attribute pass through to the underlying socket.  recv_into is
    intentionally not exposed: parsers here are frame-splitters, not
    zero-copy consumers.
    """

    REFILL = 1 << 18

    def __init__(self, sock: socket.socket):
        self._sock = sock
        self._buf = bytearray()
        self._pos = 0

    def recv(self, n: int) -> bytes:
        avail = len(self._buf) - self._pos
        if avail == 0:
            if n >= self.REFILL:
                # large reads bypass the buffer entirely
                return self._sock.recv(n)
            chunk = self._sock.recv(self.REFILL)
            if not chunk:
                return b""
            self._buf = bytearray(chunk)
            self._pos = 0
            avail = len(chunk)
        take = min(n, avail)
        out = bytes(self._buf[self._pos:self._pos + take])
        self._pos += take
        if self._pos == len(self._buf):
            self._buf = bytearray()
            self._pos = 0
        return out

    def pending(self) -> int:
        """Bytes already buffered (e.g. to drain before a mode switch)."""
        return len(self._buf) - self._pos

    def __getattr__(self, name):
        return getattr(self._sock, name)


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
