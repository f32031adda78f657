"""MySQL client/server protocol (the port's copy of
``transferia_tpu/providers/mysql/wire.py``; pure stdlib).

Packets: 3-byte little-endian length + 1-byte sequence id.  Implements the
handshake (v10), mysql_native_password and the caching_sha2_password fast
path, COM_QUERY with text-protocol resultsets (EOF framing — the
DEPRECATE_EOF capability is deliberately not negotiated), and COM_PING.
"""

from __future__ import annotations

import hashlib
import socket
import struct
from typing import Optional

from transferia_tpu_torch.abstract.errors import CategorizedError
from transferia_tpu_torch.utils.net import BufferedSock, recv_exact

CLIENT_LONG_PASSWORD = 0x1
CLIENT_PROTOCOL_41 = 0x200
CLIENT_SECURE_CONNECTION = 0x8000
CLIENT_PLUGIN_AUTH = 0x80000
CLIENT_CONNECT_WITH_DB = 0x8

COM_QUIT = 0x01
COM_QUERY = 0x03
COM_PING = 0x0E


class MySQLError(CategorizedError):
    def __init__(self, message: str, errno: int = 0):
        super().__init__(CategorizedError.SOURCE, message)
        self.errno = errno


def _native_password_token(password: str, nonce: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha1(password.encode()).digest()
    h2 = hashlib.sha1(h1).digest()
    h3 = hashlib.sha1(nonce + h2).digest()
    return bytes(a ^ b for a, b in zip(h1, h3))


def _caching_sha2_token(password: str, nonce: bytes) -> bytes:
    if not password:
        return b""
    h1 = hashlib.sha256(password.encode()).digest()
    h2 = hashlib.sha256(hashlib.sha256(h1).digest() + nonce).digest()
    return bytes(a ^ b for a, b in zip(h1, h2))


class MySQLConnection:
    def __init__(self, host: str = "localhost", port: int = 3306,
                 database: str = "", user: str = "root",
                 password: str = "", timeout: float = 60.0):
        self.host = host
        self.port = port
        self.database = database
        self.user = user
        self.password = password
        self.timeout = timeout
        self.sock: Optional[socket.socket] = None
        self._seq = 0

    # -- framing ------------------------------------------------------------
    def _recv_exact(self, n: int) -> bytes:
        try:
            return recv_exact(self.sock, n)
        except ConnectionError as e:
            raise MySQLError(str(e)) from e

    _MAX_PACKET = 0xFFFFFF

    def _read_packet(self) -> bytes:
        """Read one logical packet, rejoining 16MB-split frames."""
        out = b""
        while True:
            header = self._recv_exact(4)
            length = header[0] | (header[1] << 8) | (header[2] << 16)
            self._seq = (header[3] + 1) & 0xFF
            out += self._recv_exact(length)
            if length < self._MAX_PACKET:
                return out

    def _send_packet(self, payload: bytes) -> None:
        """Send one logical packet, splitting at the 16MB frame limit."""
        pos = 0
        while True:
            chunk = payload[pos:pos + self._MAX_PACKET]
            header = struct.pack("<I", len(chunk))[:3] + bytes([self._seq])
            self._seq = (self._seq + 1) & 0xFF
            self.sock.sendall(header + chunk)
            pos += len(chunk)
            if len(chunk) < self._MAX_PACKET:
                return

    @staticmethod
    def _err(payload: bytes) -> MySQLError:
        errno = struct.unpack_from("<H", payload, 1)[0]
        msg = payload[3:]
        if msg[:1] == b"#":
            msg = msg[6:]
        return MySQLError(msg.decode("utf-8", "replace"), errno)

    # -- handshake ----------------------------------------------------------
    def connect(self) -> "MySQLConnection":
        raw = socket.create_connection((self.host, self.port),
                                       timeout=self.timeout)
        raw.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # MySQL frames rows as individual packets: raw per-packet recv is
        # 2+ syscalls per row during snapshots.  Buffered reads refill in
        # 256KiB chunks
        self.sock = BufferedSock(raw)
        self._seq = 0
        greeting = self._read_packet()
        if greeting[:1] == b"\xff":
            raise self._err(greeting)
        pos = 1
        end = greeting.index(b"\x00", pos)
        pos = end + 1
        pos += 4  # thread id
        nonce = greeting[pos:pos + 8]
        pos += 9  # auth part1 + filler
        pos += 2  # cap low
        plugin = "mysql_native_password"
        if len(greeting) > pos:
            pos += 1 + 2 + 2  # charset, status, cap high
            auth_len = greeting[pos]
            pos += 1 + 10     # auth len + reserved
            extra = max(13, auth_len - 8)
            part2 = greeting[pos:pos + extra]
            if part2.endswith(b"\x00"):
                # exactly ONE protocol NUL terminator: a scramble byte
                # that happens to be 0x00 must survive (real servers send
                # ASCII scrambles, but rstrip would eat it)
                part2 = part2[:-1]
            nonce += part2
            pos += extra
            nul = greeting.find(b"\x00", pos)
            if nul > pos:
                plugin = greeting[pos:nul].decode()
        token = (_caching_sha2_token(self.password, nonce)
                 if plugin == "caching_sha2_password"
                 else _native_password_token(self.password, nonce[:20]))
        caps = (CLIENT_LONG_PASSWORD | CLIENT_PROTOCOL_41
                | CLIENT_SECURE_CONNECTION | CLIENT_PLUGIN_AUTH)
        if self.database:
            caps |= CLIENT_CONNECT_WITH_DB
        resp = struct.pack("<IIB23x", caps, 1 << 24, 33)
        resp += self.user.encode() + b"\x00"
        resp += bytes([len(token)]) + token
        if self.database:
            resp += self.database.encode() + b"\x00"
        resp += plugin.encode() + b"\x00"
        self._send_packet(resp)
        self._auth_finish(nonce)
        return self

    def _auth_finish(self, nonce: bytes) -> None:
        while True:
            pkt = self._read_packet()
            head = pkt[:1]
            if head == b"\x00":
                return  # OK
            if head == b"\xff":
                raise self._err(pkt)
            if head == b"\xfe":  # AuthSwitchRequest
                nul = pkt.index(b"\x00", 1)
                plugin = pkt[1:nul].decode()
                new_nonce = pkt[nul + 1:]
                if new_nonce.endswith(b"\x00"):
                    # exactly ONE protocol terminator (same rule as the
                    # greeting scramble: a 0x00 scramble byte survives)
                    new_nonce = new_nonce[:-1]
                if plugin == "mysql_native_password":
                    self._send_packet(
                        _native_password_token(self.password, new_nonce)
                    )
                elif plugin == "caching_sha2_password":
                    self._send_packet(
                        _caching_sha2_token(self.password, new_nonce)
                    )
                else:
                    raise MySQLError(
                        f"unsupported auth plugin {plugin!r}"
                    )
            elif head == b"\x01":  # caching_sha2 extra data
                if pkt[1:2] == b"\x03":
                    continue  # fast-auth success; OK follows
                raise MySQLError(
                    "caching_sha2_password full auth requires TLS; "
                    "use mysql_native_password for this user"
                )
            else:
                raise MySQLError(f"unexpected auth packet {pkt[:2]!r}")

    def close(self) -> None:
        if self.sock is not None:
            try:
                self._seq = 0
                self._send_packet(bytes([COM_QUIT]))
            except OSError:
                pass
            self.sock.close()
            self.sock = None

    # -- lenenc helpers -----------------------------------------------------
    @staticmethod
    def _lenenc(payload: bytes, pos: int) -> tuple[Optional[int], int]:
        first = payload[pos]
        if first < 0xFB:
            return first, pos + 1
        if first == 0xFB:
            return None, pos + 1  # NULL
        if first == 0xFC:
            return struct.unpack_from("<H", payload, pos + 1)[0], pos + 3
        if first == 0xFD:
            v = payload[pos + 1] | (payload[pos + 2] << 8) \
                | (payload[pos + 3] << 16)
            return v, pos + 4
        return struct.unpack_from("<Q", payload, pos + 1)[0], pos + 9

    # -- queries ------------------------------------------------------------
    def query(self, sql: str) -> list[dict]:
        """COM_QUERY; text-protocol rows as dicts (None = NULL)."""
        self._seq = 0
        self._send_packet(bytes([COM_QUERY]) + sql.encode())
        first = self._read_packet()
        if first[:1] == b"\xff":
            raise self._err(first)
        if first[:1] == b"\x00":
            return []  # OK (DML/DDL)
        n_cols, _ = self._lenenc(first, 0)
        columns = []
        for _ in range(n_cols):
            defn = self._read_packet()
            columns.append(self._parse_column_name(defn))
        eof = self._read_packet()  # EOF after column defs
        rows = []
        while True:
            pkt = self._read_packet()
            if pkt[:1] == b"\xfe" and len(pkt) < 9:
                return rows  # EOF
            if pkt[:1] == b"\xff":
                raise self._err(pkt)
            pos = 0
            vals = []
            for _ in range(n_cols):
                ln, pos = self._lenenc(pkt, pos)
                if ln is None:
                    vals.append(None)
                else:
                    vals.append(
                        pkt[pos:pos + ln].decode("utf-8", "replace")
                    )
                    pos += ln
            rows.append(dict(zip(columns, vals)))

    @staticmethod
    def _parse_column_name(defn: bytes) -> str:
        """Column definition packet: catalog/schema/table/org_table/name."""
        pos = 0
        name = ""
        for i in range(5):
            first = defn[pos]
            ln = first
            pos += 1
            if first == 0xFC:
                ln = struct.unpack_from("<H", defn, pos)[0]
                pos += 2
            field_val = defn[pos:pos + ln]
            pos += ln
            if i == 4:
                name = field_val.decode("utf-8", "replace")
        return name

    def scalar(self, sql: str):
        rows = self.query(sql)
        if not rows:
            return None
        return next(iter(rows[0].values()))

    def ping(self) -> None:
        self._seq = 0
        self._send_packet(bytes([COM_PING]))
        pkt = self._read_packet()
        if pkt[:1] != b"\x00":
            raise MySQLError(f"ping failed: {pkt[:2]!r}")
