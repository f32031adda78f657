"""Canonical <-> Debezium/Kafka-Connect type mapping (the port's copy of
``transferia_tpu/debezium/types.py``).

The mapping is over the canonical lattice, with per-original-type depth
layered on top via `to_connect` for the types whose Debezium form is not
derivable from the canonical type alone:

pg: uuid/xml/hstore (semantic names), money (currency-normalized string),
range families (text), inet/cidr/macaddr, bit/varbit (Bits), arrays
(Connect array of the element mapping, element-wise encode);
mysql: bigint unsigned (precise Connect Decimal — int64 overflows),
enum/set (Enum/EnumSet), year (Year), time (MicroTime), bit(n) (Bits).
"""

from __future__ import annotations

import functools
import re
from typing import Any, Optional

from transferia_tpu_torch.abstract.schema import CanonicalType

# canonical -> (connect type, semantic name or None)
TO_CONNECT: dict[CanonicalType, tuple[str, Optional[str]]] = {
    CanonicalType.INT8: ("int16", None),
    CanonicalType.INT16: ("int16", None),
    CanonicalType.INT32: ("int32", None),
    CanonicalType.INT64: ("int64", None),
    CanonicalType.UINT8: ("int16", None),
    CanonicalType.UINT16: ("int32", None),
    CanonicalType.UINT32: ("int64", None),
    CanonicalType.UINT64: ("int64", None),
    CanonicalType.FLOAT: ("float", None),
    CanonicalType.DOUBLE: ("double", None),
    CanonicalType.BOOLEAN: ("boolean", None),
    CanonicalType.STRING: ("bytes", None),
    CanonicalType.UTF8: ("string", None),
    CanonicalType.DATE: ("int32", "io.debezium.time.Date"),
    CanonicalType.DATETIME: ("int64", "io.debezium.time.Timestamp"),
    CanonicalType.TIMESTAMP: ("int64", "io.debezium.time.MicroTimestamp"),
    CanonicalType.INTERVAL: ("int64", "io.debezium.time.MicroDuration"),
    CanonicalType.DECIMAL: ("string", None),
    CanonicalType.ANY: ("string", "io.debezium.data.Json"),
}

# semantic name -> canonical (receiver side)
FROM_SEMANTIC: dict[str, CanonicalType] = {
    "io.debezium.time.Date": CanonicalType.DATE,
    "io.debezium.time.Timestamp": CanonicalType.DATETIME,
    "io.debezium.time.MicroTimestamp": CanonicalType.TIMESTAMP,
    "io.debezium.time.NanoTimestamp": CanonicalType.TIMESTAMP,
    "io.debezium.time.MicroDuration": CanonicalType.INTERVAL,
    "io.debezium.time.MicroTime": CanonicalType.UTF8,
    "io.debezium.time.Year": CanonicalType.INT32,
    "io.debezium.data.Json": CanonicalType.ANY,
    "io.debezium.data.Uuid": CanonicalType.UTF8,
    "io.debezium.data.Xml": CanonicalType.UTF8,
    "io.debezium.data.Enum": CanonicalType.UTF8,
    "io.debezium.data.EnumSet": CanonicalType.UTF8,
    "io.debezium.data.Bits": CanonicalType.STRING,
    "org.apache.kafka.connect.data.Decimal": CanonicalType.DECIMAL,
}


_PG_RANGES = ("int4range", "int8range", "numrange", "tsrange",
              "tstzrange", "daterange")


@functools.lru_cache(maxsize=4096)
def _split_original(original_type: str) -> tuple[str, str, str]:
    """'mysql:enum('A','B')' -> ('mysql', 'enum', "'A','B'");
    'mysql:bigint(20) unsigned' -> ('mysql', 'bigint unsigned', '20').

    The paren group is stripped wherever it appears (display widths sit
    mid-string), args keep their original case (enum/set literals are
    case-significant), and the memo makes this safe on per-cell paths."""
    provider, _, rest = original_type.partition(":")
    rest = rest.strip()
    args = ""
    m = re.search(r"\(([^)]*)\)", rest)
    if m:
        args = m.group(1)
        rest = rest[:m.start()] + rest[m.end():]
    base = " ".join(rest.lower().split())
    return provider, base, args


def to_connect(cs) -> tuple[Any, Optional[str], dict]:
    """Full per-column Debezium mapping honoring the original DB type
    (the pg and mysql case trees).

    Returns (connect_type, semantic_name, schema_parameters);
    connect_type is a dict for Connect arrays ({"type": "array",
    "items": {...}}).
    """
    original = getattr(cs, "original_type", "") or ""
    provider, base, args = _split_original(original)

    # pg arrays -> Connect array of the element mapping (the element's
    # canonical type comes from the pg rules; the array column itself is
    # usually ANY via the wildcard rule)
    if provider == "pg" and base.endswith("[]"):
        elem_base = base[:-2]
        elem = _Elem(original_type=f"pg:{elem_base}",
                     data_type=_pg_element_ctype(elem_base))
        etype, esem, eparams = to_connect(elem)
        items: dict = {"type": etype, "optional": True}
        if esem:
            items["name"] = esem
            items["version"] = 1
        if eparams:
            items["parameters"] = eparams
        return {"type": "array", "items": items}, None, {}

    if provider == "pg":
        if base == "uuid":
            return "string", "io.debezium.data.Uuid", {}
        if base == "xml":
            return "string", "io.debezium.data.Xml", {}
        if base == "hstore":
            return "string", "io.debezium.data.Json", {}
        if base == "money":
            return "string", None, {}
        if base in _PG_RANGES:
            return "string", None, {}
        if base in ("inet", "cidr", "macaddr", "macaddr8"):
            return "string", None, {}
        if base in ("bit", "bit varying", "varbit"):
            if base == "bit" and args in ("", "1"):
                return "boolean", None, {}
            return "bytes", "io.debezium.data.Bits", \
                ({"length": args} if args else {})
    if provider == "mysql":
        if base == "bigint unsigned":
            # int64 overflows above 2^63-1: precise Connect Decimal
            return "bytes", "org.apache.kafka.connect.data.Decimal", \
                {"scale": "0"}
        if base == "enum":
            return "string", "io.debezium.data.Enum", \
                ({"allowed": args} if args else {})
        if base == "set":
            return "string", "io.debezium.data.EnumSet", \
                ({"allowed": args} if args else {})
        if base == "year":
            return "int32", "io.debezium.time.Year", {}
        if base == "time":
            return "int64", "io.debezium.time.MicroTime", {}
        if base == "bit":
            if args in ("", "1"):
                # the Debezium MySQL connector maps BIT(1) to boolean
                return "boolean", None, {}
            return "bytes", "io.debezium.data.Bits", \
                ({"length": args} if args else {})

    ctype, semantic = TO_CONNECT[cs.data_type]
    return ctype, semantic, {}


class _Elem:
    """Schema stub for array-element recursion."""

    def __init__(self, original_type: str, data_type: CanonicalType):
        self.original_type = original_type
        self.data_type = data_type


@functools.lru_cache(maxsize=1024)
def _pg_element_ctype(elem_base: str) -> CanonicalType:
    # the pg rule table registers on provider import; a standalone codec
    # user (receiver-only flows) may not have imported it yet
    import transferia_tpu_torch.providers.postgres.provider  # noqa: F401
    from transferia_tpu_torch.typesystem.rules import map_source_type

    return map_source_type("pg", elem_base)

FROM_CONNECT: dict[str, CanonicalType] = {
    "int8": CanonicalType.INT8,
    "int16": CanonicalType.INT16,
    "int32": CanonicalType.INT32,
    "int64": CanonicalType.INT64,
    "float": CanonicalType.FLOAT,
    "double": CanonicalType.DOUBLE,
    "boolean": CanonicalType.BOOLEAN,
    "string": CanonicalType.UTF8,
    "bytes": CanonicalType.STRING,
}


def _encode_micro_time(v: Any) -> int:
    """'[-]HH:MM:SS[.ffffff]' -> signed microseconds (MicroTime; mysql
    TIME spans -838:59:59..838:59:59)."""
    if isinstance(v, (int, float)):
        return int(v)
    s = str(v).strip()
    neg = s.startswith("-")
    if neg:
        s = s[1:]
    hms, _, frac = s.partition(".")
    parts = hms.split(":")
    h, m, sec = (int(parts[0]), int(parts[1]),
                 int(parts[2]) if len(parts) > 2 else 0)
    micros = (h * 3600 + m * 60 + sec) * 1_000_000
    if frac:
        micros += int(frac.ljust(6, "0")[:6])
    return -micros if neg else micros


def _decode_micro_time(v: int) -> str:
    v = int(v)
    sign = "-" if v < 0 else ""
    total, micros = divmod(abs(v), 1_000_000)
    h, rem = divmod(total, 3600)
    m, s = divmod(rem, 60)
    base = f"{sign}{h:02d}:{m:02d}:{s:02d}"
    return f"{base}.{micros:06d}" if micros else base


def _encode_unscaled_decimal(v: Any) -> str:
    """int -> base64 big-endian two's-complement unscaled bytes
    (org.apache.kafka.connect.data.Decimal)."""
    import base64

    n = int(v)
    length = max(1, (n.bit_length() + 8) // 8)
    return base64.b64encode(
        n.to_bytes(length, "big", signed=True)).decode()


def _encode_bits(v: Any, length_arg: str) -> str:
    """bit-string/int/bytes -> base64 little-endian bytes
    (io.debezium.data.Bits byte order)."""
    import base64

    if isinstance(v, (bytes, bytearray)):
        raw = bytes(v)
    else:
        if isinstance(v, str) and set(v) <= {"0", "1"} and v:
            n = int(v, 2)
            bits = len(v)
        else:
            n = int(v)
            bits = max(1, n.bit_length())
        try:
            bits = int(length_arg) if length_arg else bits
        except ValueError:
            pass
        raw = n.to_bytes(max(1, (bits + 7) // 8), "little")
    return base64.b64encode(raw).decode()


def _normalize_money(v: Any) -> str:
    """Currency text -> plain decimal string (pg money).

    Handles any symbol position ('$-99.00', '(1.00)') and comma-decimal
    lc_monetary locales ('1.234,56' -> '1234.56'): the RIGHTMOST of
    '.'/',' is the decimal separator when it is followed by exactly two
    digits; every other separator is grouping."""
    s = str(v).strip()
    neg = "-" in s or s.startswith("(")
    s = re.sub(r"[^0-9.,]", "", s)
    last_dot, last_comma = s.rfind("."), s.rfind(",")
    sep = max(last_dot, last_comma)
    if sep >= 0 and len(s) - sep - 1 == 2:
        intpart = re.sub(r"[.,]", "", s[:sep])
        s = f"{intpart}.{s[sep + 1:]}"
    else:
        s = re.sub(r"[.,]", "", s)
    return ("-" + s) if neg and s else s


def encode_value(ctype: CanonicalType, v: Any,
                 original_type: str = "") -> Any:
    """Canonical python value -> Debezium payload value."""
    if v is None:
        return None
    if original_type:
        provider, base, _args = _split_original(original_type)
        if provider == "pg" and base.endswith("[]") and \
                isinstance(v, (list, tuple)):
            elem_base = base[:-2]
            elem_orig = f"pg:{elem_base}"
            elem_ctype = _pg_element_ctype(elem_base)
            return [encode_value(elem_ctype, x, elem_orig) for x in v]
        if provider == "pg":
            if base == "money":
                return _normalize_money(v)
            if base == "hstore":
                import json

                return json.dumps(v, separators=(",", ":"),
                                  default=str) \
                    if not isinstance(v, str) else v
            if base in _PG_RANGES or base in (
                    "uuid", "xml", "inet", "cidr", "macaddr", "macaddr8"):
                return str(v)
            if base == "bit" and _args in ("", "1"):
                return v in (True, 1, "1", "t", "true")
            if base in ("bit", "bit varying", "varbit"):
                return _encode_bits(v, _args)
        if provider == "mysql":
            if base == "bigint unsigned":
                return _encode_unscaled_decimal(v)
            if base == "time":
                return _encode_micro_time(v)
            if base == "year":
                return int(v)
            if base in ("enum", "set"):
                return str(v)
            if base == "bit":
                if _args in ("", "1"):
                    return v in (True, 1, "1", b"\x01", "t", "true")
                return _encode_bits(v, _args)
    if ctype == CanonicalType.DATETIME:
        return int(v) * 1000  # seconds -> ms (io.debezium.time.Timestamp)
    if ctype == CanonicalType.STRING:
        import base64

        raw = v if isinstance(v, bytes) else str(v).encode()
        return base64.b64encode(raw).decode()
    if ctype == CanonicalType.ANY:
        import json

        # strings are json-encoded too ('123' -> '"123"'): decode_value
        # json.loads every ANY payload, so the pair must be symmetric
        return json.dumps(v, separators=(",", ":"), default=str)
    return v


def decode_value(ctype: CanonicalType, v: Any,
                 semantic: str = "") -> Any:
    """Debezium payload value -> canonical python value."""
    if v is None:
        return None
    if semantic == "io.debezium.time.MicroTime":
        return _decode_micro_time(v)
    if semantic == "io.debezium.time.Year":
        return int(v)
    if semantic == "io.debezium.data.Bits":
        import base64

        try:
            return base64.b64decode(v)
        except Exception:
            return v
    if semantic in ("io.debezium.data.Uuid", "io.debezium.data.Xml",
                    "io.debezium.data.Enum", "io.debezium.data.EnumSet"):
        return str(v)
    if ctype == CanonicalType.DATETIME:
        return int(v) // 1000
    if ctype == CanonicalType.STRING:
        import base64

        try:
            return base64.b64decode(v)
        except Exception:
            return str(v).encode()
    if ctype == CanonicalType.ANY and isinstance(v, str):
        import json

        try:
            return json.loads(v)
        except ValueError:
            # legacy/foreign producers may emit bare strings
            return v
    return v
