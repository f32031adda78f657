"""The port's Postgres target (`PGSinker`), its `transfer_ddl` step
(`providers/postgres/pg_dump.py`) and the snapshot's incremental branch,
each package over its own fakes (the JAX package's `tests/recipes/`,
the port's `transferia_tpu_torch/recipes/`), on the CPU.

- `PGSinker`: the same batches through both sinks leave equal tables
  (rows as a set, columns, keys): a plain COPY push; the staged commit's
  publish, abort and republish, with one fence row a (part, epoch) and
  no staging table left; a zombie publisher's stale epoch raising;
  CDC inserts, updates and deletes (a statement a row).
- The port's fake finds a statement's row through its key index where
  the JAX fake scans: the same statements leave the same rows.
- `transfer_ddl`: `dump_ddl_objects` gives the JAX package's statements
  and the provider applies the same ones.
- Incremental tables: two `SnapshotLoader` runs of a regular snapshot
  with rows inserted between them move the same rows and persist the
  same cursors in both packages, over Postgres, MySQL and the memory
  source.
"""

import dataclasses

import pytest

from tests.recipes import fake_mysql as ref_fake_mysql
from tests.recipes import fake_postgres as ref_fake_pg
from transferia_tpu.abstract import kinds as ref_kinds
from transferia_tpu.abstract import errors as ref_errors
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import (
    IncrementalTableCfg as RefIncCfg,
)
from transferia_tpu.models.transfer import RegularSnapshot as RefRegular
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.mysql import MySQLSourceParams as RefMySrc
from transferia_tpu.providers.postgres import pg_dump as ref_pg_dump
from transferia_tpu.providers.postgres import provider as ref_pg
from transferia_tpu.providers.postgres.wire import PGConnection as RefConn
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu_torch.abstract import kinds as port_kinds
from transferia_tpu_torch.abstract import errors as port_errors
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.schema import new_table_schema
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import (
    IncrementalTableCfg,
    RegularSnapshot,
    Transfer,
)
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.mysql import MySQLSourceParams
from transferia_tpu_torch.providers.postgres import pg_dump as port_pg_dump
from transferia_tpu_torch.providers.postgres import provider as port_pg
from transferia_tpu_torch.providers.postgres.wire import PGConnection
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.recipes import fake_mysql as port_fake_mysql
from transferia_tpu_torch.recipes import fake_postgres as port_fake_pg
from transferia_tpu_torch.tasks import SnapshotLoader

PKGS = {
    "port": dict(fake=port_fake_pg, pg=port_pg, batch=ColumnBatch,
                 tid=TableID, schema=new_table_schema, kinds=port_kinds,
                 errors=port_errors, conn=PGConnection,
                 pg_dump=port_pg_dump),
    "jax": dict(fake=ref_fake_pg, pg=ref_pg, batch=RefBatch,
                tid=RefTableID, schema=ref_schema, kinds=ref_kinds,
                errors=ref_errors, conn=RefConn, pg_dump=ref_pg_dump),
}
COLS = [("id", "int64", True), ("name", "utf8"), ("score", "double"),
        ("flag", "boolean"), ("n", "int32")]


def batch(pkg, ids, tag="v", kinds=None):
    m = PKGS[pkg]
    data = {"id": list(ids),
            "name": [None if i % 7 == 3 else f'{tag}{i}, "q"\n'
                     for i in ids],
            "score": [i * 0.5 for i in ids],
            "flag": [i % 2 == 0 for i in ids],
            "n": [i % 11 for i in ids]}
    b = m["batch"].from_pydict(m["tid"]("public", "t"), m["schema"](COLS),
                               data)
    if kinds is not None:
        items = b.to_rows()
        kind = m["kinds"].Kind
        out = []
        for it, k in zip(items, kinds):
            if k != "I":
                it = dataclasses.replace(
                    it, kind=kind.UPDATE if k == "U" else kind.DELETE)
            out.append(it)
        return m["batch"].from_rows(out)
    return b


def table_state(fake, name="t"):
    with fake.lock:
        t = fake.tables.get(("public", name))
        if t is None:
            return None
        rows = sorted(tuple(sorted(r.items())) for r in t.rows)
        return [tuple(c) for c in t.columns], rows


def tables(fake):
    return sorted(n for _, n in fake.tables)


def with_sinks(scenario):
    """Run scenario(pkg, sink, fake) in both packages; their results."""
    out = {}
    for pkg, m in PKGS.items():
        fake = m["fake"].FakePG().start()
        try:
            params = m["pg"].PGTargetParams(host="127.0.0.1", port=fake.port)
            sink = m["pg"].PGSinker(params, "cpu") if pkg == "port" \
                else m["pg"].PGSinker(params)
            try:
                out[pkg] = scenario(pkg, sink, fake)
            finally:
                sink.close()
        finally:
            fake.stop()
    return out


def test_plain_push_equals_jax():
    def scenario(pkg, sink, fake):
        sink.push(batch(pkg, range(40)))
        sink.push(batch(pkg, range(40, 45)))
        return table_state(fake), tables(fake)

    got = with_sinks(scenario)
    assert got["port"] == got["jax"]
    assert len(got["port"][0][1]) == 45


def test_staged_publish_abort_republish_equals_jax():
    def scenario(pkg, sink, fake):
        states = []
        sink.begin_part("part-a", 1)
        sink.push(batch(pkg, range(10)))
        states.append(("published", sink.publish_part("part-a", 1)))
        states.append(table_state(fake))
        sink.begin_part("part-b", 1)
        sink.push(batch(pkg, range(100, 104)))
        sink.abort_part("part-b")
        states.append((table_state(fake), tables(fake)))
        # a retried part republishes: its rows are replaced, not doubled
        sink.begin_part("part-a", 2)
        sink.push(batch(pkg, range(5), tag="w"))
        states.append(("republished", sink.publish_part("part-a", 2)))
        states.append((table_state(fake), tables(fake),
                       table_state(fake, "__trtpu_commits")))
        return states

    got = with_sinks(scenario)
    assert got["port"] == got["jax"]
    final_rows = got["port"][-1][0][1]
    assert len(final_rows) == 5
    assert not [n for n in got["port"][-1][1] if n.startswith("__trtpu_stg")]
    assert len(got["port"][-1][2][1]) == 2   # one fence row a (part, epoch)


def test_zombie_epoch_raises_as_jax():
    def scenario(pkg, sink, fake):
        sink.begin_part("part-z", 3)
        sink.push(batch(pkg, range(4)))
        sink.publish_part("part-z", 3)
        sink.begin_part("part-z", 2)
        sink.push(batch(pkg, range(4, 8)))
        with pytest.raises(PKGS[pkg]["errors"].StaleEpochPublishError):
            sink.publish_part("part-z", 2)
        return table_state(fake)

    got = with_sinks(scenario)
    assert got["port"] == got["jax"] and len(got["port"][1]) == 4


def test_cdc_rows_equal_jax():
    def scenario(pkg, sink, fake):
        sink.push(batch(pkg, range(30)))
        sink.push(batch(pkg, [30, 31, 5, 6, 7, 8, 9], tag="c",
                        kinds=["I", "I", "U", "U", "D", "D", "I"]))
        sink.push(batch(pkg, [30, 12], tag="d", kinds=["U", "D"]))
        return table_state(fake)

    got = with_sinks(scenario)
    assert got["port"] == got["jax"]
    ids = {dict(r)["id"] for r in got["port"][1]}
    assert "31" in ids and not {"7", "8", "12"} & ids


def test_fake_key_index_equals_the_jax_fake_scan():
    """Statements on one key through the port's fake index and through
    the JAX fake's scans leave the same rows; a statement on another
    column (the scan) and rows a COPY appends keep the index right."""
    stmts = [
        'CREATE TABLE IF NOT EXISTS "public"."k" ("id" bigint NOT NULL, '
        '"v" text, PRIMARY KEY ("id"))',
    ] + [f'INSERT INTO "public"."k" ("id", "v") VALUES ({i}, \'a{i}\') '
         f'ON CONFLICT ("id") DO UPDATE SET "v" = EXCLUDED."v"'
         for i in range(20)] + [
        'INSERT INTO "public"."k" ("id", "v") VALUES (3, \'b\') '
        'ON CONFLICT ("id") DO UPDATE SET "v" = EXCLUDED."v"',
        'INSERT INTO "public"."k" ("id", "v") VALUES (4, \'c\') '
        'ON CONFLICT ("id") DO NOTHING',
        'UPDATE "public"."k" SET "v" = \'u\' WHERE "id" = 5',
        'UPDATE "public"."k" SET "id" = 105, "v" = \'m\' WHERE "id" = 6',
        'DELETE FROM "public"."k" WHERE "id" = 2',
        'DELETE FROM "public"."k" WHERE "id" = 19',
        'DELETE FROM "public"."k" WHERE "id" = 77',
        'UPDATE "public"."k" SET "v" = \'s\' WHERE "v" = \'a9\'',
        'UPDATE "public"."k" SET "v" = \'t\' WHERE "id" = 105',
        'DELETE FROM "public"."k" WHERE "id" = 0',
        'INSERT INTO "public"."k" ("id", "v") VALUES (2, \'again\') '
        'ON CONFLICT ("id") DO UPDATE SET "v" = EXCLUDED."v"',
    ]
    after_copy = [
        'UPDATE "public"."k" SET "v" = \'cu\' WHERE "id" = 31',
        'DELETE FROM "public"."k" WHERE "id" = 32',
        'INSERT INTO "public"."k" ("id", "v") VALUES (33, \'cx\') '
        'ON CONFLICT ("id") DO UPDATE SET "v" = EXCLUDED."v"',
        'DELETE FROM "public"."k" WHERE "id" = 1',
        'UPDATE "public"."k" SET "v" = \'last\' WHERE "id" = 34',
    ]
    got = {}
    for pkg, m in PKGS.items():
        fake = m["fake"].FakePG().start()
        try:
            conn = m["conn"](host="127.0.0.1", port=fake.port).connect()
            for s in stmts:
                conn.query(s)
            mid = table_state(fake, "k")
            # rows a COPY appends behind the index, then found by key
            conn.copy_in('COPY "public"."k" ("id", "v") FROM STDIN WITH '
                         '(FORMAT csv)',
                         ["".join(f"{i},c{i}\n" for i in range(30, 35))
                          .encode()])
            for s in after_copy:
                conn.query(s)
            conn.close()
            got[pkg] = mid, table_state(fake, "k")
        finally:
            fake.stop()
    assert got["port"] == got["jax"]
    assert len(got["port"][0][1]) == 18 and len(got["port"][1][1]) == 21


def test_fake_transaction_rollback_equals_jax():
    """A transaction that fails after changing rows in place, through the
    key index and through scans, leaves both fakes as they were, and
    the port's fake finds rows by key afterwards."""
    ins = ('INSERT INTO "public"."k" ("id", "v") VALUES ({}, \'{}\') '
           'ON CONFLICT ("id") DO UPDATE SET "v" = EXCLUDED."v"')
    setup = [
        'CREATE TABLE IF NOT EXISTS "public"."k" ("id" bigint NOT NULL, '
        '"v" text, PRIMARY KEY ("id"))',
    ] + [ins.format(i, f"a{i}") for i in range(12)]
    txn = "; ".join([
        "BEGIN", ins.format(3, "b"), ins.format(40, "new"),
        'UPDATE "public"."k" SET "v" = \'u\' WHERE "id" = 5',
        'UPDATE "public"."k" SET "id" = 106, "v" = \'m\' WHERE "id" = 6',
        'UPDATE "public"."k" SET "v" = \'s\' WHERE "v" = \'a9\'',
        'DELETE FROM "public"."k" WHERE "id" = 2',
        'DELETE FROM "public"."k" WHERE "id" = 11',
        'UPDATE "public"."k" SET "v" = \'w\' WHERE "id" = 11',
        "SELECT 1", "COMMIT"])
    after = ['UPDATE "public"."k" SET "v" = \'z\' WHERE "id" = 6',
             'DELETE FROM "public"."k" WHERE "id" = 11',
             ins.format(2, "again")]
    got = {}
    for pkg, m in PKGS.items():
        fake = m["fake"].FakePG().start()
        try:
            conn = m["conn"](host="127.0.0.1", port=fake.port).connect()
            for s in setup:
                conn.query(s)
            before = table_state(fake, "k")
            with pytest.raises(Exception, match="unhandled txn stmt"):
                conn.query(txn)
            assert table_state(fake, "k") == before
            for s in after:
                conn.query(s)
            conn.close()
            got[pkg] = table_state(fake, "k")
        finally:
            fake.stop()
    assert got["port"] == got["jax"]
    assert len(got["port"][1]) == 11


DDL = dict(
    indexes=[("public", "t", "t_pkey",
              "CREATE UNIQUE INDEX t_pkey ON public.t USING btree (id)"),
             ("public", "t", "t_n", "CREATE INDEX t_n ON public.t (n)"),
             ("public", "t", "t_u",
              "CREATE UNIQUE INDEX IF NOT EXISTS t_u ON public.t (name)")],
    views=[("public", "v", " SELECT id FROM public.t;"),
           ("public", "Odd'View", "SELECT 1")],
    sequences=[("public", "t_id_seq", 1, 1, 40),
               ("public", "fresh", 5, 2, None)])


def test_transfer_ddl_equals_jax():
    got = {}
    for pkg, m in PKGS.items():
        src, dst = m["fake"].FakePG().start(), m["fake"].FakePG().start()
        try:
            for k, v in DDL.items():
                getattr(src, k).extend(v)
            conn = m["conn"](host="127.0.0.1", port=src.port).connect()
            stmts = m["pg_dump"].dump_ddl_objects(conn, ["public"])
            conn.close()
            transfer = (Transfer if pkg == "port" else RefTransfer)(
                id="ddl",
                src=m["pg"].PGSourceParams(host="127.0.0.1", port=src.port,
                                           transfer_ddl=True),
                dst=m["pg"].PGTargetParams(host="127.0.0.1", port=dst.port))
            prov = m["pg"].PostgresProvider(transfer)
            applied = prov.transfer_ddl_objects(transfer.dst)
            got[pkg] = (stmts, applied, list(dst.executed_ddl))
        finally:
            src.stop()
            dst.stop()
    assert got["port"] == got["jax"]
    # two sequences (one setval: "fresh" has no last value), two indexes
    # (the primary key's comes with the table), two views
    assert got["port"][1] == 7 and len(got["port"][0]) == 7


def test_pg_sinker_is_the_providers_sink():
    t = Transfer(id="s", src=port_pg.PGSourceParams(),
                 dst=port_pg.PGTargetParams())
    sink = get_provider("pg", t, device="cpu").sinker()
    assert isinstance(sink, port_pg.PGSinker)


# -- incremental tables ---------------------------------------------------------

EV_COLS = [("id", "bigint", True, True), ("v", "text", False, False)]


def pg_rows(lo, hi):
    return [{"id": str(i), "v": f"v{i}"} for i in range(lo, hi)]


def store_rows(store):
    return sorted(tuple(sorted(it.as_dict().items())) for it in store.rows())


def two_runs(pkg, source_of, add_rows, initial=""):
    """A regular snapshot's incremental table, loaded twice with rows
    added between: (rows of each run, the cursor state after each)."""
    port = pkg == "port"
    mem = port_memory if port else ref_memory
    sink = f"inc-{pkg}-{source_of.__name__}"
    store = mem.get_store(sink)
    store.clear()
    src, stop = source_of(pkg)
    try:
        transfer = (Transfer if port else RefTransfer)(
            id=sink, src=src,
            dst=mem.MemoryTargetParams(sink_id=sink),
            regular_snapshot=(RegularSnapshot if port else RefRegular)(
                enabled=True, cron="* * * * *",
                incremental=[(IncrementalTableCfg if port else RefIncCfg)(
                    namespace="public", name="ev", cursor_field="id",
                    initial_state=initial)]))
        cp = MemoryCoordinator() if port else RefCoordinator()
        out = []
        for run in range(2):
            kw = {"device": "cpu"} if port else {}
            (SnapshotLoader if port else RefLoader)(
                transfer, cp, operation_id=f"op-{run}", **kw).upload_tables()
            out.append((store_rows(store),
                        cp.get_transfer_state(sink).get("incremental_state")))
            store.clear()
            add_rows(pkg)
        return out
    finally:
        stop()


FAKES = {}


def pg_source(pkg):
    fake = PKGS[pkg]["fake"].FakePG().start()
    fake.add_table(PKGS[pkg]["fake"].FakeTable("public", "ev", EV_COLS,
                                               pg_rows(0, 25)))
    FAKES[pkg] = fake
    return (PKGS[pkg]["pg"].PGSourceParams(host="127.0.0.1", port=fake.port),
            fake.stop)


def pg_add(pkg):
    fake = FAKES[pkg]
    with fake.lock:
        fake.tables[("public", "ev")].rows.extend(pg_rows(25, 31))


@pytest.mark.parametrize("initial", ["", "9"])
def test_postgres_incremental_equals_jax(initial):
    got = {pkg: two_runs(pkg, pg_source, pg_add, initial) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert len(got["port"][0][0]) == (25 if not initial else 15)


MY_COLS = [("id", "bigint", "bigint", True, True),
           ("v", "varchar", "varchar(64)", False, False)]


def my_source(pkg):
    mod = port_fake_mysql if pkg == "port" else ref_fake_mysql
    fake = mod.FakeMySQL().start()
    fake.add_table(mod.FakeMyTable(
        "public", "ev", MY_COLS,
        [{"id": i, "v": f"v{i}"} for i in range(40)]))
    FAKES[pkg] = fake
    params = (MySQLSourceParams if pkg == "port" else RefMySrc)(
        host="127.0.0.1", port=fake.port, database="public")
    return params, fake.stop


def my_add(pkg):
    fake = FAKES[pkg]
    with fake.lock:
        t = fake.tables[("public", "ev")]
        t.rows.extend({"id": i, "v": f"v{i}"} for i in range(40, 47))


def test_mysql_incremental_equals_jax():
    got = {pkg: two_runs(pkg, my_source, my_add) for pkg in PKGS}
    assert got["port"] == got["jax"]
    (first, cursor), (second, cursor2) = got["port"]
    assert len(first) == 40 and len(second) == 7
    # the fake's MAX comes back as text, in both packages
    assert cursor == {"public.ev": "39"} and cursor2 == {"public.ev": "46"}


def memory_source(pkg):
    mem = port_memory if pkg == "port" else ref_memory
    m = PKGS[pkg]
    sid = f"inc-src-{pkg}"
    schema = m["schema"]([("id", "int64", True), ("v", "utf8")])
    mem.seed_source(sid, [m["batch"].from_pydict(
        m["tid"]("public", "ev"), schema,
        {"id": list(range(12)), "v": [f"v{i}" for i in range(12)]})])
    FAKES[pkg] = (sid, schema)
    return mem.MemorySourceParams(source_id=sid), lambda: None


def memory_add(pkg):
    mem = port_memory if pkg == "port" else ref_memory
    m = PKGS[pkg]
    sid, schema = FAKES[pkg]
    mem.seed_source(sid, [m["batch"].from_pydict(
        m["tid"]("public", "ev"), schema,
        {"id": list(range(20)), "v": [f"v{i}" for i in range(20)]})])


def test_memory_incremental_equals_jax():
    got = {pkg: two_runs(pkg, memory_source, memory_add) for pkg in PKGS}
    assert got["port"] == got["jax"]
    assert len(got["port"][1][0]) == 8
