"""Seeded CDC streams for the wire fakes: a users table's binlog as GTID
transactions of row changes, and wal2json v2 insert transactions.

`users_changes` draws the change stream of a users table (id bigint
key, email utf8mb4 varchar(255), region int): inserts of fresh ids,
updates of live ids (a before and an after image, a new email) and
deletes of distinct live ids, in a seeded order.  `feed_users_binlog`
logs it into a fake MySQL the way a server does (GTID, TABLE_MAP, ROWS
v2 events of at most `max_event` bytes, one for each run of one kind,
XID) and `users_final_state` applies it, giving the rows a MySQL target
holds afterwards.  `feed_hits_wal` feeds a fake Postgres the wal2json v2
insert messages of the hits table (id, url, region, score) in `B` ...
`C` transactions.  The feeds take the port's fakes or the JAX
package's, which share the feed methods.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

INSERT, UPDATE, DELETE = 0, 1, 2
USERS_SID = "3e11fa47-71ca-11e1-9e33-c80aa9429562"
USERS_TABLE_ID = 42
# (name, data_type, column_type, key, not null), as the catalog lists them
USERS_COLUMNS = [("id", "bigint", "bigint", True, True),
                 ("email", "varchar", "varchar(255)", False, False),
                 ("region", "int", "int", False, False)]
T_LONG, T_LONGLONG, T_VARCHAR = 3, 8, 15
# utf8mb4 varchar(255): 4 bytes a character, so a 2-byte length prefix
USERS_COL_SPECS = [(T_LONGLONG, b""), (T_VARCHAR, struct.pack("<H", 1020)),
                   (T_LONG, b"")]
ROWS_EVENT = {INSERT: 30, UPDATE: 31, DELETE: 32}   # ROWS v2 event types
EVENT_HEADER = 19
MAX_ROWS_EVENT = 8192     # MySQL's default binlog_row_event_max_size

# one change: (kind, id, region, email before, email after); an insert
# has no before image and a delete no after image (None there), while a
# NULL email is None in an image the kind has


def users_changes(inserts: int, updates: int, deletes: int,
                  seed: int = 17, null_share: float = 0.01) -> list:
    """The seeded change stream: insert i carries id i, email
    user{i}@example.test (NULL for a `null_share` of them) and region
    i % 500; an update of a live id gives it the email
    user{id}.v{j}@example.test (j the change's index), a delete removes
    a live id."""
    rng = np.random.default_rng(seed)
    total = inserts + updates + deletes
    kinds = np.repeat(np.array([INSERT, UPDATE, DELETE], dtype=np.int8),
                      [inserts, updates, deletes])[rng.permutation(total)]
    null = rng.random(inserts) < null_share
    picks = rng.random(total)
    live: list[int] = []
    where: dict[int, int] = {}
    email: dict[int, Optional[str]] = {}
    out = []
    next_id = 0
    for j in range(total):
        kind = int(kinds[j])
        if kind != INSERT and not live:
            # nothing to change yet: the next insert comes first
            m = j + 1 + int(np.argmax(kinds[j + 1:] == INSERT))
            kinds[j], kinds[m] = kinds[m], kinds[j]
            kind = INSERT
        if kind == INSERT:
            i = next_id
            next_id += 1
            e = None if null[i] else f"user{i}@example.test"
            where[i] = len(live)
            live.append(i)
            email[i] = e
            out.append((INSERT, i, i % 500, None, e))
            continue
        i = live[int(picks[j] * len(live))]
        if kind == UPDATE:
            e = f"user{i}.v{j}@example.test"
            out.append((UPDATE, i, i % 500, email[i], e))
            email[i] = e
        else:
            out.append((DELETE, i, i % 500, email[i], None))
            last = live.pop()
            if last != i:
                live[where[i]] = last
                where[last] = where[i]
            del where[i], email[i]
    return out


def users_final_state(changes: list) -> dict:
    """id -> (email, region) after every change."""
    state: dict[int, tuple] = {}
    for kind, i, region, _, after in changes:
        if kind == DELETE:
            del state[i]
        else:
            state[i] = (after, region)
    return state


def _image(i: int, email: Optional[str], region: int) -> bytes:
    """One row image: the null bitmap over the three columns, then the
    values of the non-null ones."""
    if email is None:
        return b"\x02" + struct.pack("<qi", i, region)
    raw = email.encode()
    return (b"\x00" + struct.pack("<qH", i, len(raw)) + raw
            + struct.pack("<i", region))


def _rows_body_bytes(kind: int) -> int:
    """A ROWS v2 event's bytes before its images (the header, table id,
    flags, extra-info length, column count and the present bitmaps)."""
    return EVENT_HEADER + 6 + 2 + 2 + 1 + (2 if kind == UPDATE else 1)


def feed_users_binlog(fake, changes: list, database: str = "db",
                      table: str = "users", txn_changes: int = 100,
                      sid: str = USERS_SID, first_gno: int = 1,
                      max_event: int = MAX_ROWS_EVENT) -> int:
    """Log `changes` into the fake's binlog: transactions of
    `txn_changes` changes, each a GTID event, the TABLE_MAP, one ROWS v2
    event for each run of one kind (split to stay within `max_event`
    bytes) and an XID.  Returns the last GTID number."""
    gno = first_gno - 1
    for lo in range(0, len(changes), txn_changes):
        gno += 1
        fake.feed_gtid(sid, gno)
        fake.feed_table_map(USERS_TABLE_ID, database, table,
                            USERS_COL_SPECS)
        kind, images, size = None, [], 0
        for k, i, region, before, after in changes[lo:lo + txn_changes]:
            if k == INSERT:
                img = _image(i, after, region)
            elif k == UPDATE:
                img = _image(i, before, region) + _image(i, after, region)
            else:
                img = _image(i, before, region)
            if images and (k != kind or size + len(img) > max_event):
                fake.feed_rows(ROWS_EVENT[kind], USERS_TABLE_ID, 3, images)
                images = []
            if not images:
                kind, size = k, _rows_body_bytes(k)
            images.append(img)
            size += len(img)
        fake.feed_rows(ROWS_EVENT[kind], USERS_TABLE_ID, 3, images)
        fake.feed_xid(gno)
    return gno


# the hits table of the pg2ch transfer: (name, type, key, not null)
HITS_COLUMNS = [("id", "bigint", True, True), ("url", "text", False, False),
                ("region", "integer", False, False),
                ("score", "double precision", False, False)]


def hits_row(i: int) -> tuple:
    """Row i of the hits table: id, url, region, score."""
    return i, f"https://e.test/{i % 997}", i % 500, (i % 91) * 1.5


def feed_hits_wal(fake, rows: int, txn_rows: int = 1000,
                  schema: str = "public", table: str = "hits",
                  start: int = 0) -> int:
    """Feed wal2json v2 inserts of hits rows start..start+rows-1,
    `txn_rows` to a transaction between its `B` and `C` messages.
    Returns the last message's LSN."""
    pk = [{"name": "id", "type": "bigint"}]
    for lo in range(start, start + rows, txn_rows):
        fake.feed_wal(json.dumps({"action": "B"}).encode())
        for i in range(lo, min(start + rows, lo + txn_rows)):
            values = hits_row(i)
            fake.feed_wal(json.dumps({
                "action": "I", "schema": schema, "table": table,
                "columns": [{"name": c[0], "type": c[1], "value": v}
                            for c, v in zip(HITS_COLUMNS, values)],
                "pk": pk}).encode())
        fake.feed_wal(json.dumps({"action": "C"}).encode())
    return fake.wal[-1][0]
