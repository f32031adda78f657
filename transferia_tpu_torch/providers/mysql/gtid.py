"""MySQL GTID set model, executed-GTID tracking and dump encoding (the
port's copy of ``transferia_tpu/providers/mysql/gtid.py``): replication
resumes from an executed-GTID set instead of a binlog file+position,
surviving source failovers where file names change.

Format: the standard "uuid:1-5:7,uuid2:1-3" executed-set string; the
binary encoding is COM_BINLOG_DUMP_GTID's SID block (n_sids u64le, then
per sid: 16 raw uuid bytes, n_intervals u64le, and start/end u64le pairs
with EXCLUSIVE end).
"""

from __future__ import annotations

import struct
import uuid as uuid_mod


class GtidSet:
    def __init__(self) -> None:
        # uuid(str, dashed lowercase) -> sorted list of [start, end]
        # intervals, end INCLUSIVE in this in-memory form
        self.sids: dict[str, list[list[int]]] = {}

    # -- construction -------------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "GtidSet":
        out = cls()
        for part in (text or "").replace("\n", "").split(","):
            part = part.strip()
            if not part:
                continue
            chunks = part.split(":")
            try:
                sid = str(uuid_mod.UUID(chunks[0].strip()))
            except ValueError:
                continue  # not a GTID sid (malformed server output)
            for rng in chunks[1:]:
                if "-" in rng:
                    a, b = rng.split("-", 1)
                    out._add_interval(sid, int(a), int(b))
                else:
                    out._add_interval(sid, int(rng), int(rng))
        return out

    def copy(self) -> "GtidSet":
        out = GtidSet()
        out.sids = {k: [iv[:] for iv in v] for k, v in self.sids.items()}
        return out

    # -- mutation -----------------------------------------------------------
    def add(self, sid: str, gno: int) -> None:
        self._add_interval(sid.lower(), gno, gno)

    def _add_interval(self, sid: str, start: int, end: int) -> None:
        ivs = self.sids.setdefault(sid, [])
        ivs.append([start, end])
        ivs.sort()
        merged: list[list[int]] = []
        for iv in ivs:
            if merged and iv[0] <= merged[-1][1] + 1:
                merged[-1][1] = max(merged[-1][1], iv[1])
            else:
                merged.append(iv)
        self.sids[sid] = merged

    def update(self, other: "GtidSet") -> None:
        for sid, ivs in other.sids.items():
            for a, b in ivs:
                self._add_interval(sid, a, b)

    # -- queries ------------------------------------------------------------
    def contains(self, sid: str, gno: int) -> bool:
        for a, b in self.sids.get(sid.lower(), []):
            if a <= gno <= b:
                return True
        return False

    def __bool__(self) -> bool:
        return bool(self.sids)

    def __eq__(self, other) -> bool:
        return isinstance(other, GtidSet) and self.sids == other.sids

    # -- formats ------------------------------------------------------------
    def __str__(self) -> str:
        parts = []
        for sid in sorted(self.sids):
            rngs = ":".join(
                f"{a}-{b}" if a != b else str(a)
                for a, b in self.sids[sid]
            )
            parts.append(f"{sid}:{rngs}")
        return ",".join(parts)

    def encode(self) -> bytes:
        """COM_BINLOG_DUMP_GTID SID-block encoding (end exclusive)."""
        out = struct.pack("<Q", len(self.sids))
        for sid in sorted(self.sids):
            out += uuid_mod.UUID(sid).bytes
            ivs = self.sids[sid]
            out += struct.pack("<Q", len(ivs))
            for a, b in ivs:
                out += struct.pack("<QQ", a, b + 1)
        return out

    @classmethod
    def decode(cls, data: bytes) -> "GtidSet":
        out = cls()
        (n_sids,) = struct.unpack_from("<Q", data, 0)
        pos = 8
        for _ in range(n_sids):
            sid = str(uuid_mod.UUID(bytes=data[pos:pos + 16]))
            pos += 16
            (n_ivs,) = struct.unpack_from("<Q", data, pos)
            pos += 8
            for _ in range(n_ivs):
                a, b = struct.unpack_from("<QQ", data, pos)
                pos += 16
                out._add_interval(sid, a, b - 1)
        return out
