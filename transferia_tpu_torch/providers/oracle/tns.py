"""Oracle TNS (Transparent Network Substrate) framing and data codecs
(the port's copy of ``transferia_tpu/providers/oracle/tns.py``).

Reference parity: pkg/providers/oracle/ connects through godror/OCI; this
framework speaks the wire directly, like its PG/MySQL/Mongo/YDB clients.

Faithful parts (public, documented formats):
- TNS packet framing: 8-byte header (length, checksum, type, flags), packet
  types CONNECT/ACCEPT/REFUSE/DATA/MARKER, connect descriptors
  ``(DESCRIPTION=(CONNECT_DATA=(SERVICE_NAME=...)))``;
- Oracle NUMBER binary format: base-100 exponent/mantissa with the sign
  fold and the 102 terminator on negatives;
- Oracle DATE (7-byte excess-100 century/year) and TIMESTAMP (11-byte with
  big-endian nanoseconds);
- native column type codes (VARCHAR2=1, NUMBER=2, DATE=12, ...).

Simplified parts (documented here so nobody mistakes this for OCI parity):
the TTC session layer uses these frames and value codecs but a reduced
message vocabulary (see wire.py), and long values use a 0xFE marker
followed by one uint32 length — not Oracle's real repeated-chunk
continuation encoding.
"""

from __future__ import annotations

import datetime as dt
import socket
import struct
from decimal import Decimal
from typing import Optional, Union

# -- packet types ------------------------------------------------------------

PKT_CONNECT = 1
PKT_ACCEPT = 2
PKT_ACK = 3
PKT_REFUSE = 4
PKT_REDIRECT = 5
PKT_DATA = 6
PKT_NULL = 7
PKT_ABORT = 9
PKT_RESEND = 11
PKT_MARKER = 12

# protocol version: 314 = 1.3.14, the classic TNS version pre-big-SDU
TNS_VERSION = 314
TNS_VERSION_MIN = 300

SDU = 8192
TDU = 32767


class TNSError(Exception):
    pass


# -- framing -----------------------------------------------------------------


def pack_packet(ptype: int, payload: bytes, flags: int = 0) -> bytes:
    """8-byte TNS header + payload (length includes the header)."""
    total = len(payload) + 8
    if total > 0xFFFF:
        raise TNSError(f"packet too large for 2-byte length: {total}")
    return struct.pack(">HHBBH", total, 0, ptype, flags, 0) + payload


def read_packet(sock: socket.socket) -> tuple[int, bytes]:
    hdr = _read_exact(sock, 8)
    length, _cksum, ptype, _flags, _hck = struct.unpack(">HHBBH", hdr)
    if length < 8:
        raise TNSError(f"bad TNS length {length}")
    return ptype, _read_exact(sock, length - 8)


def _read_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise TNSError("connection closed mid-packet")
        buf += chunk
    return buf


# -- connect / accept / refuse ----------------------------------------------


def build_connect(descriptor: str) -> bytes:
    """CONNECT packet body: version block + offset/length of the connect
    descriptor, which trails the fixed header."""
    data = descriptor.encode()
    fixed = struct.pack(
        ">HHHHHHHHIHH2x",
        TNS_VERSION, TNS_VERSION_MIN,
        0,              # service options
        SDU, TDU,
        0x7F08,         # protocol characteristics (NT flags)
        0, 1,           # line turnaround, "our one" byte-order probe
        len(data),      # connect data length
        34,             # descriptor offset: 8 header + 26 fixed bytes
        0,              # max receivable connect data
    )
    return fixed + data


def parse_connect(payload: bytes) -> str:
    (_ver, _low, _opts, _sdu, _tdu, _prot, _turn, _probe, dlen, doff,
     _maxr) = struct.unpack(">HHHHHHHHIHH", payload[:24])
    start = doff - 8
    return payload[start:start + dlen].decode()


def build_accept() -> bytes:
    return struct.pack(">HHHHIBB8x", TNS_VERSION, 0, SDU, TDU, 0, 0, 0)


def parse_accept(payload: bytes) -> int:
    (version,) = struct.unpack(">H", payload[:2])
    return version


def build_refuse(message: str) -> bytes:
    data = message.encode()
    return struct.pack(">BBH", 1, 2, len(data)) + data


def parse_refuse(payload: bytes) -> str:
    (_ureason, _sreason, dlen) = struct.unpack(">BBH", payload[:4])
    return payload[4:4 + dlen].decode(errors="replace")


def connect_descriptor(host: str, port: int, service_name: str = "",
                       sid: str = "") -> str:
    if service_name:
        cd = f"(SERVICE_NAME={service_name})"
    elif sid:
        cd = f"(SID={sid})"
    else:
        raise TNSError("need service_name or sid")
    return (
        f"(DESCRIPTION=(ADDRESS=(PROTOCOL=TCP)(HOST={host})(PORT={port}))"
        f"(CONNECT_DATA={cd}(CID=(PROGRAM=transferia_tpu))))"
    )


def parse_connect_data(descriptor: str) -> dict:
    """Pull SERVICE_NAME / SID out of a connect descriptor."""
    out = {}
    for key in ("SERVICE_NAME", "SID"):
        marker = f"({key}="
        i = descriptor.upper().find(marker)
        if i >= 0:
            j = descriptor.index(")", i)
            out[key.lower()] = descriptor[i + len(marker):j]
    return out


# -- scalar marshaling (length-prefixed big-endian, UB* style) ---------------


def write_uint(n: int) -> bytes:
    if n < 0:
        raise TNSError("uint only")
    if n == 0:
        return b"\x00"
    raw = n.to_bytes((n.bit_length() + 7) // 8, "big")
    return bytes([len(raw)]) + raw


def read_uint(buf: bytes, pos: int) -> tuple[int, int]:
    ln = buf[pos]
    pos += 1
    if ln == 0:
        return 0, pos
    return int.from_bytes(buf[pos:pos + ln], "big"), pos + ln


def write_bytes(b: Optional[bytes]) -> bytes:
    """Length-prefixed byte string; 0xFF = NULL (single-chunk subset)."""
    if b is None:
        return b"\xff"
    if len(b) >= 0xFE:
        return b"\xfe" + struct.pack(">I", len(b)) + b
    return bytes([len(b)]) + b


def read_bytes(buf: bytes, pos: int) -> tuple[Optional[bytes], int]:
    ln = buf[pos]
    pos += 1
    if ln == 0xFF:
        return None, pos
    if ln == 0xFE:
        (real,) = struct.unpack(">I", buf[pos:pos + 4])
        pos += 4
        return buf[pos:pos + real], pos + real
    return buf[pos:pos + ln], pos + ln


def write_str(s: Optional[str]) -> bytes:
    return write_bytes(None if s is None else s.encode())


def read_str(buf: bytes, pos: int) -> tuple[Optional[str], int]:
    b, pos = read_bytes(buf, pos)
    return (None if b is None else b.decode()), pos


# -- Oracle NUMBER (base-100, excess-65 exponent) ----------------------------


def encode_number(value: Union[int, float, Decimal]) -> bytes:
    """Encode into Oracle's NUMBER wire format.

    Positive: [0xC1 + exp] [d1+1] [d2+1] ...      (digits base 100)
    Negative: [0x3E - exp] [101-d1] ... [102]     (sign-folded, terminated)
    Zero: [0x80].
    """
    if isinstance(value, float):
        value = Decimal(repr(value))
    else:
        value = Decimal(value)
    if value == 0:
        return b"\x80"
    neg = value < 0
    if neg:
        value = -value
    # normalize to d1.d2d3... * 100^exp with 1 <= d1 <= 99
    digits: list[int] = []
    exp = 0
    intpart = int(value)
    frac = value - intpart
    if intpart:
        while intpart:
            digits.insert(0, intpart % 100)
            intpart //= 100
        exp = len(digits) - 1
    else:
        exp = -1
        while frac and int(frac * 100) == 0:
            frac *= 100
            exp -= 1
    f = frac
    while f and len(digits) < 20:
        f *= 100
        d = int(f)
        digits.append(d)
        f -= d
    while digits and digits[-1] == 0:
        digits.pop()
    if not digits:
        return b"\x80"
    if neg:
        out = bytes([0x3E - exp]) + bytes(101 - d for d in digits)
        if len(digits) < 20:
            out += b"\x66"  # 102 terminator
        return out
    return bytes([0xC1 + exp]) + bytes(d + 1 for d in digits)


def decode_number(b: bytes) -> Union[int, float, Decimal]:
    if b == b"\x80":
        return 0
    head = b[0]
    if head & 0x80:  # positive
        exp = head - 0xC1
        digits = [x - 1 for x in b[1:]]
        neg = False
    else:
        exp = 0x3E - head
        digits = [101 - x for x in b[1:]]
        if digits and digits[-1] == -1:  # 102 terminator
            digits.pop()
        neg = True
    value = Decimal(0)
    for i, d in enumerate(digits):
        value += Decimal(d) * (Decimal(100) ** (exp - i))
    if neg:
        value = -value
    if value == value.to_integral_value():
        iv = int(value)
        if -(2 ** 63) <= iv < 2 ** 63:
            return iv
    # keep the exact Decimal whenever float would lose precision (wide
    # NUMBER(>18) keys, high-scale decimals); float only when lossless
    f = float(value)
    if Decimal(f) == value:
        return f
    return value


# -- Oracle DATE / TIMESTAMP -------------------------------------------------


def encode_date(value: Union[dt.date, dt.datetime]) -> bytes:
    if not isinstance(value, dt.datetime):
        value = dt.datetime(value.year, value.month, value.day)
    return bytes([
        value.year // 100 + 100, value.year % 100 + 100,
        value.month, value.day,
        value.hour + 1, value.minute + 1, value.second + 1,
    ])


def decode_date(b: bytes) -> dt.datetime:
    return dt.datetime(
        (b[0] - 100) * 100 + (b[1] - 100), b[2], b[3],
        b[4] - 1, b[5] - 1, b[6] - 1,
    )


def encode_timestamp(value: dt.datetime) -> bytes:
    ns = value.microsecond * 1000
    return encode_date(value) + struct.pack(">I", ns)


def decode_timestamp(b: bytes) -> dt.datetime:
    base = decode_date(b[:7])
    (ns,) = struct.unpack(">I", b[7:11])
    return base.replace(microsecond=ns // 1000)


# -- native column type codes ------------------------------------------------

ORA_VARCHAR2 = 1
ORA_NUMBER = 2
ORA_LONG = 8
ORA_DATE = 12
ORA_RAW = 23
ORA_LONG_RAW = 24
ORA_CHAR = 96
ORA_BINARY_FLOAT = 100
ORA_BINARY_DOUBLE = 101
ORA_CLOB = 112
ORA_BLOB = 113
ORA_TIMESTAMP = 180
ORA_TIMESTAMP_TZ = 181
ORA_INTERVAL_DS = 183


def encode_value(type_code: int, value) -> bytes:
    """One column value in wire form (NULL-aware, type-directed)."""
    if value is None:
        return write_bytes(None)
    if type_code == ORA_NUMBER:
        return write_bytes(encode_number(value))
    if type_code in (ORA_BINARY_FLOAT, ORA_BINARY_DOUBLE):
        fmt = ">f" if type_code == ORA_BINARY_FLOAT else ">d"
        return write_bytes(struct.pack(fmt, float(value)))
    if type_code == ORA_DATE:
        if isinstance(value, str):
            value = dt.datetime.fromisoformat(value)
        return write_bytes(encode_date(value))
    if type_code in (ORA_TIMESTAMP, ORA_TIMESTAMP_TZ):
        if isinstance(value, str):
            value = dt.datetime.fromisoformat(value)
        return write_bytes(encode_timestamp(value))
    if type_code in (ORA_RAW, ORA_LONG_RAW, ORA_BLOB):
        if isinstance(value, str):
            value = value.encode()
        return write_bytes(bytes(value))
    return write_bytes(str(value).encode())


def decode_value(type_code: int, buf: bytes, pos: int):
    raw, pos = read_bytes(buf, pos)
    if raw is None:
        return None, pos
    if type_code == ORA_NUMBER:
        return decode_number(raw), pos
    if type_code == ORA_BINARY_FLOAT:
        return struct.unpack(">f", raw)[0], pos
    if type_code == ORA_BINARY_DOUBLE:
        return struct.unpack(">d", raw)[0], pos
    if type_code == ORA_DATE:
        return decode_date(raw), pos
    if type_code in (ORA_TIMESTAMP, ORA_TIMESTAMP_TZ):
        return decode_timestamp(raw), pos
    if type_code in (ORA_RAW, ORA_LONG_RAW, ORA_BLOB):
        return raw, pos
    return raw.decode(errors="replace"), pos
