"""Schema-object transfer: indexes, views, sequences (the port's copy of
``transferia_tpu/providers/postgres/pg_dump.py``: pg_dump-style DDL moved
from source to target around the snapshot).

Post-data objects (indexes, views) apply AFTER rows land — building
indexes on loaded tables is much faster and views depend on the tables.
Sequences apply post-data too, with setval() so serial columns continue
from the source's last value.  Primary-key indexes are skipped: the sink
already creates them with the table DDL.
"""

from __future__ import annotations

import logging
import re
from typing import Sequence

logger = logging.getLogger(__name__)


def _q(ident: str) -> str:
    return '"' + ident.replace('"', '""') + '"'


def _lit(s: str) -> str:
    """SQL string literal with quote escaping."""
    return "'" + str(s).replace("'", "''") + "'"


def dump_ddl_objects(conn, schemas: Sequence[str]) -> list[str]:
    """Read post-data DDL statements from the source connection."""
    in_list = ", ".join(_lit(s) for s in schemas)
    out: list[str] = []
    for row in conn.query(
            f"SELECT schemaname, sequencename, start_value, increment_by, "
            f"last_value FROM pg_sequences "
            f"WHERE schemaname IN ({in_list})"):
        seq = f"{_q(row['schemaname'])}.{_q(row['sequencename'])}"
        out.append(
            f"CREATE SEQUENCE IF NOT EXISTS {seq} "
            f"START WITH {row['start_value'] or 1} "
            f"INCREMENT BY {row['increment_by'] or 1}")
        if row.get("last_value"):
            # regclass literal with QUOTED idents: unquoted names would
            # case-fold and miss mixed-case sequences
            out.append(f"SELECT setval({_lit(seq)}, "
                       f"{row['last_value']})")
    for row in conn.query(
            f"SELECT schemaname, tablename, indexname, indexdef "
            f"FROM pg_indexes WHERE schemaname IN ({in_list})"):
        if row["indexname"].endswith("_pkey"):
            continue  # the table DDL already created the pk index
        ddl = row["indexdef"]
        # idempotent re-activation: CREATE [UNIQUE] INDEX IF NOT EXISTS
        ddl = re.sub(r"^CREATE (UNIQUE )?INDEX (?!IF NOT EXISTS)",
                     lambda m: f"CREATE {m.group(1) or ''}INDEX "
                               f"IF NOT EXISTS ",
                     ddl, count=1)
        out.append(ddl)
    for row in conn.query(
            f"SELECT schemaname, viewname, definition FROM pg_views "
            f"WHERE schemaname IN ({in_list})"):
        view = f"{_q(row['schemaname'])}.{_q(row['viewname'])}"
        out.append(f"CREATE OR REPLACE VIEW {view} AS "
                   f"{row['definition'].rstrip(';')}")
    return out


def apply_ddl_objects(conn, statements: list[str]) -> int:
    """Apply on the target; per-statement failures log and continue (a
    view referencing an excluded table must not fail the transfer)."""
    applied = 0
    for stmt in statements:
        try:
            conn.query(stmt)
            applied += 1
        except Exception as e:
            logger.warning("ddl object skipped (%s): %.120s", e, stmt)
    return applied
