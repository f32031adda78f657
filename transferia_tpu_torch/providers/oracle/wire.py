"""Oracle client: TNS transport + a reduced TTC session vocabulary (the
port's copy of ``transferia_tpu/providers/oracle/wire.py``).

Connect/auth/execute/fetch against an Oracle listener, dependency-free, the
way this framework's other wire clients work (PG v3, MySQL, Mongo OP_MSG).
Message flow:

    CONNECT -> ACCEPT (or REFUSE)
    DATA: protocol negotiation (0x01)
    DATA: FUNCTION auth phase one (0x76)  -> PARAMETER with AUTH_VFR_DATA
    DATA: FUNCTION auth phase two (0x73)  -> STATUS ok / ERROR ORA-01017
    DATA: FUNCTION execute (0x5E, sql)    -> DESCRIBE + ROWs + ERROR 1403
    DATA: FUNCTION fetch (0x05, cursor)   -> ROWs + ERROR 1403 at EOF
    DATA: FUNCTION logoff (0x09)

The frames, value codecs (NUMBER/DATE/TIMESTAMP), column type codes, and
the ORA-1403 end-of-fetch convention are Oracle's; the auth verifier is a
salted-SHA256 subset (a production client would speak O5LOGON's AES
session keys — out of scope for snapshot parity, and stated in
docs/PARITY.md).  Reference: pkg/providers/oracle/ (godror/OCI based).
"""

from __future__ import annotations

import hashlib
import logging
import socket
import struct
from typing import Any, Optional

from transferia_tpu_torch.providers.oracle import tns
from transferia_tpu_torch.providers.oracle.tns import (
    PKT_ACCEPT,
    PKT_CONNECT,
    PKT_DATA,
    PKT_REFUSE,
    TNSError,
    read_str,
    read_uint,
    write_str,
    write_uint,
)

logger = logging.getLogger(__name__)

# TTC message types
MSG_PROTOCOL = 0x01
MSG_FUNCTION = 0x03
MSG_ERROR = 0x04
MSG_ROW_HEADER = 0x06
MSG_ROW_DATA = 0x07
MSG_PARAMETER = 0x08
MSG_STATUS = 0x09
MSG_DESCRIBE = 0x10

# function codes
FN_FETCH = 0x05
FN_LOGOFF = 0x09
FN_EXECUTE = 0x5E
FN_AUTH_PHASE_TWO = 0x73
FN_AUTH_PHASE_ONE = 0x76

ORA_NO_DATA_FOUND = 1403
ORA_INVALID_LOGIN = 1017

DEFAULT_PREFETCH = 2000


class OracleError(Exception):
    def __init__(self, message: str, code: int = 0):
        super().__init__(message)
        self.code = code


class ColumnInfo:
    def __init__(self, name: str, type_code: int, precision: int = 0,
                 scale: int = 0, nullable: bool = True,
                 type_name: str = ""):
        self.name = name
        self.type_code = type_code
        self.precision = precision
        self.scale = scale
        self.nullable = nullable
        self.type_name = type_name


def auth_verifier(salt: bytes, password: str) -> str:
    """Salted-SHA256 verifier hex (subset; see module docstring)."""
    return hashlib.sha256(salt + password.encode()).hexdigest()


class OracleConnection:
    def __init__(self, host: str, port: int = 1521, user: str = "",
                 password: str = "", service_name: str = "", sid: str = "",
                 prefetch: int = DEFAULT_PREFETCH,
                 connect_timeout: float = 10.0):
        self.host, self.port = host, port
        self.user, self.password = user, password
        self.service_name, self.sid = service_name, sid
        self.prefetch = prefetch
        self.connect_timeout = connect_timeout
        self._sock: Optional[socket.socket] = None

    # -- transport ----------------------------------------------------------
    def _send(self, ptype: int, payload: bytes) -> None:
        self._sock.sendall(tns.pack_packet(ptype, payload))

    def _send_data(self, payload: bytes) -> None:
        # 2-byte data flags precede the TTC payload in DATA packets
        self._send(PKT_DATA, struct.pack(">H", 0) + payload)

    def _recv_data(self) -> bytes:
        ptype, payload = tns.read_packet(self._sock)
        if ptype == PKT_REFUSE:
            raise OracleError(f"refused: {tns.parse_refuse(payload)}")
        if ptype != PKT_DATA:
            raise OracleError(f"unexpected TNS packet type {ptype}")
        return payload[2:]

    # -- session ------------------------------------------------------------
    def connect(self) -> "OracleConnection":
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self.connect_timeout)
        try:
            self._sock.settimeout(60.0)
            desc = tns.connect_descriptor(self.host, self.port,
                                          self.service_name, self.sid)
            self._send(PKT_CONNECT, tns.build_connect(desc))
            ptype, payload = tns.read_packet(self._sock)
            if ptype == PKT_REFUSE:
                raise OracleError(
                    f"listener refused: {tns.parse_refuse(payload)}")
            if ptype != PKT_ACCEPT:
                raise OracleError(
                    f"expected ACCEPT, got packet type {ptype}")
            tns.parse_accept(payload)
            self._negotiate()
            self._authenticate()
        except BaseException:
            # failed mid-handshake: do not leak the half-open socket
            self._sock.close()
            self._sock = None
            raise
        return self

    def _negotiate(self) -> None:
        self._send_data(
            bytes([MSG_PROTOCOL]) + b"\x06\x05\x04\x03\x02\x01\x00"
            + b"transferia_tpu\x00")
        resp = self._recv_data()
        if resp[0:1] != bytes([MSG_PROTOCOL]):
            raise OracleError("protocol negotiation failed")

    def _authenticate(self) -> None:
        # phase one: present the user, receive the verifier salt
        self._send_data(bytes([MSG_FUNCTION, FN_AUTH_PHASE_ONE])
                        + write_str(self.user))
        params = self._read_parameters()
        salt_hex = params.get("AUTH_VFR_DATA", "")
        salt = bytes.fromhex(salt_hex) if salt_hex else b""
        # phase two: salted verifier
        self._send_data(
            bytes([MSG_FUNCTION, FN_AUTH_PHASE_TWO])
            + write_str(self.user)
            + write_str(auth_verifier(salt, self.password)))
        self._read_status()

    def _read_parameters(self) -> dict[str, str]:
        buf = self._recv_data()
        if buf[0] == MSG_ERROR:
            self._raise_error(buf)
        if buf[0] != MSG_PARAMETER:
            raise OracleError(f"expected PARAMETER, got 0x{buf[0]:02x}")
        pos = 1
        n, pos = read_uint(buf, pos)
        out = {}
        for _ in range(n):
            k, pos = read_str(buf, pos)
            v, pos = read_str(buf, pos)
            out[k] = v
        return out

    def _read_status(self) -> None:
        buf = self._recv_data()
        if buf[0] == MSG_ERROR:
            self._raise_error(buf)
        if buf[0] != MSG_STATUS:
            raise OracleError(f"expected STATUS, got 0x{buf[0]:02x}")

    @staticmethod
    def _parse_error(buf: bytes) -> tuple[int, str]:
        pos = 1
        code, pos = read_uint(buf, pos)
        msg, pos = read_str(buf, pos)
        return code, msg or ""

    def _raise_error(self, buf: bytes) -> None:
        code, msg = self._parse_error(buf)
        raise OracleError(msg or f"ORA-{code:05d}", code)

    # -- queries ------------------------------------------------------------
    def execute(self, sql: str):
        """Run a statement; yields (columns, row-iterator) semantics rolled
        into a full fetch: returns (columns, rows)."""
        self._send_data(
            bytes([MSG_FUNCTION, FN_EXECUTE])
            + write_str(sql) + write_uint(self.prefetch))
        columns: list[ColumnInfo] = []
        rows: list[list[Any]] = []
        cursor_id = 0
        while True:
            buf = self._recv_data()
            msg = buf[0]
            if msg == MSG_ERROR:
                code, emsg = self._parse_error(buf)
                if code == ORA_NO_DATA_FOUND:
                    return columns, rows
                raise OracleError(emsg or f"ORA-{code:05d}", code)
            if msg == MSG_DESCRIBE:
                columns, cursor_id = self._parse_describe(buf)
                continue
            if msg == MSG_ROW_DATA:
                rows.append(self._parse_row(buf, columns))
                continue
            if msg == MSG_STATUS:
                # batch boundary: ask for more
                self._send_data(
                    bytes([MSG_FUNCTION, FN_FETCH])
                    + write_uint(cursor_id) + write_uint(self.prefetch))
                continue
            raise OracleError(f"unexpected TTC message 0x{msg:02x}")

    @staticmethod
    def _parse_describe(buf: bytes) -> tuple[list[ColumnInfo], int]:
        pos = 1
        cursor_id, pos = read_uint(buf, pos)
        n, pos = read_uint(buf, pos)
        cols = []
        for _ in range(n):
            name, pos = read_str(buf, pos)
            tcode, pos = read_uint(buf, pos)
            prec, pos = read_uint(buf, pos)
            scale, pos = read_uint(buf, pos)
            nullable, pos = read_uint(buf, pos)
            tname, pos = read_str(buf, pos)
            cols.append(ColumnInfo(name, tcode, prec, scale,
                                   bool(nullable), tname or ""))
        return cols, cursor_id

    @staticmethod
    def _parse_row(buf: bytes, columns: list[ColumnInfo]) -> list[Any]:
        pos = 1
        out = []
        for col in columns:
            v, pos = tns.decode_value(col.type_code, buf, pos)
            out.append(v)
        return out

    def query(self, sql: str) -> list[dict[str, Any]]:
        columns, rows = self.execute(sql)
        names = [c.name for c in columns]
        return [dict(zip(names, r)) for r in rows]

    def scalar(self, sql: str):
        _, rows = self.execute(sql)
        return rows[0][0] if rows else None

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._send_data(bytes([MSG_FUNCTION, FN_LOGOFF]))
            except OSError:
                pass
            try:
                self._sock.close()
            finally:
                self._sock = None
