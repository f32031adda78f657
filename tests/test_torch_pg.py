"""BASELINE config #2's source half and its activation: the port's
Postgres wire client, snapshot storage, COPY CSV decoder and
`activate_delivery` against the JAX package's, on the CPU, exactly.

Each package runs against its own fake Postgres and fake ClickHouse.
Held equal: the wire (trust, cleartext and SCRAM-SHA-256, a wrong
password, an error mid-stream); the batches a COPY of every canonical
type the `pg` rules map decodes into (values, NULLs, quoted and empty
strings, the batches' cut at pyarrow's 1 MiB blocks and at
`batch_rows`, `read_bytes`), and the values the JAX package's pyarrow
reader refuses (Postgres' `t`/`f` booleans, a `timestamptz` offset),
which the port refuses too; the catalog, counts, `position`,
`shard_table`, the checksum samples and the incremental cursors; and
`activate_delivery` of a 5,000-row pg2ch with bench.py's filter into
ClickHouse, staged commits on and off: the ClickHouse tables, the
transfer state (its `snapshot_position`) and the status.
"""

import io

import numpy as np
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from tests.recipes.fake_postgres import FakePG as RefFakePG
from tests.recipes.fake_postgres import FakeTable as RefFakeTable
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.table import (
    TableDescription as RefTableDescription,
)
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers.clickhouse import CHTargetParams as RefCHParams
from transferia_tpu.providers.postgres import PGSourceParams as RefPGParams
from transferia_tpu.providers.postgres.provider import PGStorage as RefStorage
from transferia_tpu.providers.postgres.wire import (
    PGConnection as RefConnection,
)
from transferia_tpu.providers.postgres.wire import PGError as RefPGError
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.postgres import (
    PGSourceParams,
    PGTargetParams,
)
from transferia_tpu_torch.providers.postgres.copycsv import (
    CopyCSVError,
    decode_copy_csv,
)
from transferia_tpu_torch.providers.postgres.provider import PGStorage
from transferia_tpu_torch.providers.postgres.wire import (
    PGConnection,
    PGError,
)
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_postgres import FakePG, FakeTable
from transferia_tpu_torch.tasks import activate_delivery
from transferia_tpu_torch.transform import fused as port_tfused

PKGS = {
    "port": dict(pg=FakePG, table=FakeTable, ch=FakeCH, conn=PGConnection,
                 err=PGError, storage=PGStorage, params=PGSourceParams,
                 tid=TableID, td=TableDescription, transfer=Transfer,
                 ch_params=CHTargetParams, coordinator=MemoryCoordinator,
                 activate=activate_delivery, kw={"device": "cpu"}),
    "jax": dict(pg=RefFakePG, table=RefFakeTable, ch=RefFakeCH,
                conn=RefConnection, err=RefPGError, storage=RefStorage,
                params=RefPGParams, tid=RefTableID, td=RefTableDescription,
                transfer=RefTransfer, ch_params=RefCHParams,
                coordinator=RefCoordinator, activate=ref_activate, kw={}),
}


# -- the wire ----------------------------------------------------------------

def wire(pkg: str, password: str, scram: bool, given: str):
    p = PKGS[pkg]
    pg = p["pg"](password=password, scram=scram).start()
    try:
        pg.add_table(p["table"]("public", "t", [("id", "bigint", True, True),
                                                ("v", "text", False, False)],
                                [{"id": str(i), "v": f"x,{i}" if i % 3
                                  else None} for i in range(50)]))
        try:
            c = p["conn"](host="127.0.0.1", port=pg.port, database="db",
                          user="u", password=given).connect()
        except p["err"] as e:
            return ("refused", e.sqlstate)
        try:
            out = (c.scalar("SELECT 1"),
                   c.query("SELECT count(*) FROM public.t"),
                   b"".join(c.copy_out(
                       'COPY (SELECT "id", "v" FROM public.t) TO STDOUT '
                       "WITH (FORMAT csv, HEADER false)")))
            try:
                c.query("SELECT * FROM public.missing")
            except p["err"] as e:
                out += (e.sqlstate, str(e))
            # the connection stays usable after an error
            return out + (c.scalar("SELECT count(*) FROM public.t"),)
        finally:
            c.close()
    finally:
        pg.stop()


@pytest.mark.parametrize("password,scram,given", [
    ("", False, ""), ("pw", False, "pw"), ("pw", True, "pw"),
    ("pw", False, "bad"), ("pw", True, "bad")],
    ids=["trust", "cleartext", "scram", "cleartext_refused",
         "scram_refused"])
def test_wire_equals_jax(password, scram, given):
    got = wire("port", password, scram, given)
    assert got == wire("jax", password, scram, given)
    if given == password:
        assert got[0] == "1" and got[-1] == "50"
    else:
        assert got[0] == "refused"


# -- the COPY CSV decoder ----------------------------------------------------

def column_state(col):
    return (col.ctype.value, np.asarray(col.data).dtype.str,
            np.asarray(col.data).tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def batch_state(b):
    schema = tuple((c.name, c.data_type.value, c.primary_key, c.required,
                    c.original_type) for c in b.schema)
    return (str(b.table_id), schema, b.n_rows, b.read_bytes,
            {n: column_state(c) for n, c in b.columns.items()})


def cell(rng, pg_type: str, i: int):
    """A value as Postgres' COPY CSV prints it (None: NULL)."""
    if i % 9 == 0:
        return None
    k = int(rng.integers(0, 1 << 30))
    return {
        "smallint": str(k % 65536 - 32768),
        "integer": str(k - (1 << 29)),
        "bigint": str(k * 7919 - (1 << 40)),
        "real": f"{np.float32(rng.normal() * 1e3)!r}".split("(")[-1]
        .rstrip(")") if i % 7 else ["Infinity", "-Infinity", "NaN"][i % 3],
        "double precision": repr(float(rng.normal() * 1e9)),
        "boolean": ["true", "false", "1", "0", "TRUE", "False"][k % 6],
        "text": ["", "plain", "with,comma", 'q"uote', "new\nline",
                 "ünï©ødé", " pad "][k % 7],
        "character varying(20)": f"v{k % 1000}",
        "bytea": "\\x" + rng.bytes(k % 6).hex(),
        "date": f"{1900 + k % 200:04d}-{1 + k % 12:02d}-{1 + k % 28:02d}",
        "timestamp without time zone":
            f"{1960 + k % 80:04d}-{1 + k % 12:02d}-{1 + k % 28:02d} "
            f"{k % 24:02d}:{k % 60:02d}:{k % 59:02d}"
            + ("" if k % 4 == 0 else f".{k % 1000000:06d}"[:2 + k % 6]),
        "numeric(12,2)": f"{k % 100000}.{k % 100:02d}",
        "jsonb": '{"a": %d}' % (k % 10),
        "uuid": f"{k:08x}-0000-4000-8000-{k:012x}",
        "interval": f"{k % 30} days",
    }[pg_type]


TYPES = ["smallint", "integer", "bigint", "real", "double precision",
         "boolean", "text", "character varying(20)", "bytea", "date",
         "timestamp without time zone", "numeric(12,2)", "jsonb", "uuid",
         "interval"]


def load(pkg: str, columns, rows, batch_rows: int = 131_072,
         method: str = "load_table", **kw):
    p = PKGS[pkg]
    pg = p["pg"]().start()
    try:
        pg.add_table(p["table"]("public", "t", columns, rows))
        st = p["storage"](p["params"](host="127.0.0.1", port=pg.port,
                                      database="db", user="u",
                                      batch_rows=batch_rows))
        out = []
        try:
            td = p["td"](id=p["tid"]("public", "t"))
            getattr(st, method)(td, *kw.values(), out.append)
        except (p["err"], ValueError, TypeError):
            return ("raised",)
        finally:
            st.close()
        return [batch_state(b) for b in out]
    finally:
        pg.stop()


def typed_rows(types, n: int, seed: int):
    rng = np.random.default_rng(seed)
    cols = [("id", "bigint", True, True)] + [
        (f"c{j}", t, False, False) for j, t in enumerate(types)]
    rows = [{"id": str(i), **{f"c{j}": cell(rng, t, i)
                              for j, t in enumerate(types)}}
            for i in range(n)]
    return cols, rows


@pytest.mark.parametrize("pg_type", TYPES)
def test_copy_decode_each_type_equals_jax(pg_type):
    cols, rows = typed_rows([pg_type], 700, seed=len(pg_type))
    got = load("port", cols, rows, batch_rows=256)
    want = load("jax", cols, rows, batch_rows=256)
    assert got == want
    # an interval reads as text (the bytes and offsets of a string under
    # the fixed-width INTERVAL type), in both packages
    assert [b[2] for b in got] == [256, 256, 188]


@pytest.mark.parametrize("values,pg_type", [
    (["t", "f"], "boolean"),
    (["2024-01-02 03:04:05+00"], "timestamp with time zone"),
    (["12.5"], "integer"),
    (["+5"], "bigint"),
    (["40000"], "smallint"),
    (["2024-02-30"], "date"),
    (["2024-01-02 03:04:05.1234567"], "timestamp without time zone"),
], ids=["pg_bool", "timestamptz", "int_fraction", "int_plus",
        "int_overflow", "bad_date", "ts_7_digits"])
def test_copy_decode_refuses_what_jax_refuses(values, pg_type):
    cols = [("id", "bigint", True, True), ("c", pg_type, False, False)]
    rows = [{"id": str(i), "c": v} for i, v in enumerate(values)]
    got = load("port", cols, rows)
    want = load("jax", cols, rows)
    assert got[0] == want[0] == "raised"


def test_copy_decode_blocks_and_slices_equal_jax():
    # ~2.6 MB of CSV: three pyarrow blocks, each cut into 10,000-row
    # slices; NULLs in some blocks only (validity bitmaps per block)
    n = 60_000
    rng = np.random.default_rng(5)
    cols = [("id", "bigint", True, True), ("url", "text", False, False),
            ("region", "integer", False, False),
            ("score", "double precision", False, False),
            ("ok", "boolean", False, False)]
    rows = [{"id": str(i),
             "url": None if i % 13 == 0 else
             f"https://e.test/{rng.integers(0, 10 ** (1 + i % 8))}",
             "region": None if i < 20_000 and i % 17 == 0 else str(i % 500),
             "score": f"{(i % 91) * 1.5}",
             "ok": "true" if i % 2 else "0"} for i in range(n)]
    got = load("port", cols, rows, batch_rows=10_000)
    assert got == load("jax", cols, rows, batch_rows=10_000)
    sizes = [b[2] for b in got]
    assert sum(sizes) == n and len(sizes) > 6 and max(sizes) == 10_000


def test_copy_decoder_alone():
    """Empty lines skip, quoted empties are NULL, CRLF ends rows, a
    quoted newline stays in its value; a row of the wrong width and a
    non-UTF-8 byte raise."""
    from transferia_tpu_torch.abstract.schema import (
        CanonicalType,
        ColSchema,
        TableSchema,
    )

    schema = TableSchema([ColSchema("a", CanonicalType.UTF8),
                          ColSchema("b", CanonicalType.INT32)])
    tid = TableID("public", "t")
    (b,) = decode_copy_csv(b'x,1\r\n\n"",2\n"p\nq",""\n', tid, schema, 10)
    assert b.n_rows == 3
    assert b.column("a").to_pylist() == ["x", None, "p\nq"]
    assert b.column("b").to_pylist() == [1, 2, None]
    for bad in (b"x,1,2\n", b"\xff,1\n", b""):
        with pytest.raises(CopyCSVError):
            list(decode_copy_csv(bad, tid, schema, 10))


# -- the storage --------------------------------------------------------------

HITS = [("id", "bigint", True, True), ("url", "text", False, False),
        ("region", "integer", False, False),
        ("score", "double precision", False, False)]


def hits_rows(n: int):
    return [{"id": str(i), "url": f"https://e.test/{i % 997}",
             "region": str(i % 500), "score": f"{(i % 91) * 1.5}"}
            for i in range(n)]


def storage_calls(pkg: str):
    p = PKGS[pkg]
    pg = p["pg"]().start()
    try:
        pg.add_table(p["table"]("public", "hits", HITS, hits_rows(3000)))
        pg.add_table(p["table"]("public", "__trtpu_commits",
                                [("part_key", "text", True, True)], []))
        st = p["storage"](p["params"](host="127.0.0.1", port=pg.port,
                                      database="db", user="u",
                                      desired_part_size_bytes=1000))
        tid = p["tid"]("public", "hits")
        td = p["td"](id=tid, eta_rows=3000)
        try:
            out = {
                "tables": sorted((str(k), v.eta_rows)
                                 for k, v in st.table_list().items()),
                "schema": [(c.name, c.data_type.value, c.primary_key,
                            c.required, c.original_type)
                           for c in st.table_schema(tid)],
                "exact": st.exact_table_rows_count(tid),
                "estimate": st.estimate_table_rows_count(tid),
                "position": st.position(),
                "shards": [(str(s.id), s.filter, s.eta_rows)
                           for s in st.shard_table(td)],
                "size": st.table_size_in_bytes(tid),
            }
            for method, args in (("load_random_sample", ()),
                                 ("load_top_bottom_sample", ()),
                                 ("load_sample_by_set",
                                  ([{"id": 5}, {"id": 2999}],))):
                got = []
                getattr(st, method)(td, *args, got.append)
                out[method] = [batch_state(b) for b in got]
            return out
        finally:
            st.close()
    finally:
        pg.stop()


def test_storage_equals_jax():
    got = storage_calls("port")
    assert got == storage_calls("jax")
    assert got["tables"] == [("public.hits", 3000)]
    assert got["position"] == {"wal_lsn": "0/ABCDEF0"}
    assert got["exact"] == 3000
    # the fake reports one page, so the table is one part
    assert got["shards"] == [("public.hits", "", 3000)]


# -- activate_delivery: pg2ch --------------------------------------------------

FILTER = {"transformers": [
    {"filter_rows": {"filter": "region < 400 AND score >= 10"}}]}


def pg2ch(pkg: str, rows: int):
    p = PKGS[pkg]
    pg, ch = p["pg"]().start(), p["ch"]().start()
    try:
        pg.add_table(p["table"]("public", "hits", HITS, hits_rows(rows)))
        t = p["transfer"](
            id="pg2ch", src=p["params"](host="127.0.0.1", port=pg.port,
                                        database="db", user="u"),
            dst=p["ch_params"](host="127.0.0.1", port=ch.port,
                               bufferer=None),
            transformation=FILTER)
        cp = p["coordinator"]()
        p["activate"](t, cp, **p["kw"])
        tables = {n: (tb["ddl"], sorted(tuple(sorted(r.items()))
                                        for r in tb["rows"]))
                  for n, tb in ch.tables.items()}
        return tables, cp.get_transfer_state("pg2ch"), \
            cp.get_status("pg2ch").value
    finally:
        pg.stop()
        ch.stop()


@pytest.mark.parametrize("staged", ["auto", "off"])
@pytest.mark.parametrize("mode", ["device", "host"])
def test_activate_pg2ch_equals_jax(monkeypatch, staged, mode):
    monkeypatch.setenv("TRANSFERIA_TPU_STAGED_COMMIT", staged)
    port_tfused.set_placement(mode)
    ref_tfused.set_placement("host")
    try:
        got = pg2ch("port", 5000)
        want = pg2ch("jax", 5000)
    finally:
        port_tfused.set_placement(None)
        ref_tfused.set_placement(None)
    assert got == want
    tables, state, status = got
    expected = sum(1 for i in range(5000)
                   if i % 500 < 400 and (i % 91) * 1.5 >= 10)
    assert len(tables["public__hits"][1]) == expected
    assert state == {"snapshot_position": {"wal_lsn": "0/ABCDEF0"},
                     "status": "activated"}
    assert status == "activated"
    assert ("__trtpu_commits" in tables) == (staged == "auto")


@pytest.mark.parametrize("case", ["snapshot_and_increment", "dbt"])
def test_activate_left_out_branches_raise(case):
    """A configured dbt step, the activation's one left-out part, raises
    naming its ROADMAP item and fails the transfer, in a snapshot and in
    a SNAPSHOT_AND_INCREMENT transfer (whose MVCC cutover is ported:
    tests/test_torch_mvcc.py)."""
    pg = FakePG().start()
    try:
        pg.add_table(FakeTable("public", "hits", HITS, hits_rows(10)))
        t = Transfer(
            id="left-out",
            src=PGSourceParams(host="127.0.0.1", port=pg.port),
            dst=CHTargetParams(bufferer=None),
            type=TransferType.SNAPSHOT_AND_INCREMENT
            if case == "snapshot_and_increment" else
            TransferType.SNAPSHOT_ONLY,
            transformation={"transformers": [{"dbt": {}}]})
        cp = MemoryCoordinator()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            activate_delivery(t, cp, device="cpu")
        assert cp.get_status("left-out").value == "failed"
    finally:
        pg.stop()


def test_pg_target_and_replication_wait():
    t = Transfer(id="w", src=PGSourceParams(), dst=PGTargetParams())
    prov = get_provider("pg", t, device="cpu")
    # the target waits (A6); logical replication is ported
    with pytest.raises(NotImplementedError, match="ROADMAP.md A6"):
        prov.sinker()
    assert type(prov.source()).__name__ == "PGReplicationSource"
    pg = FakePG().start()
    try:
        pg.slots["transferia_w"] = "wal2json"
        t = Transfer(id="w", src=PGSourceParams(host="127.0.0.1",
                                                port=pg.port),
                     dst=PGTargetParams())
        get_provider("pg", t, device="cpu").deactivate()
        assert pg.slots == {}
    finally:
        pg.stop()
    assert prov.storage() is not None
    assert prov.transfer_ddl_objects(CHTargetParams()) == 0


def test_snapshot_records_the_position_in_the_transfer_state():
    from transferia_tpu_torch.tasks import SnapshotLoader
    from transferia_tpu_torch.providers.memory import (
        MemoryTargetParams,
        get_store,
    )

    pg = FakePG().start()
    try:
        pg.add_table(FakeTable("public", "hits", HITS, hits_rows(100)))
        t = Transfer(id="pos", src=PGSourceParams(host="127.0.0.1",
                                                  port=pg.port),
                     dst=MemoryTargetParams(sink_id="pos"))
        get_store("pos").clear()
        cp = MemoryCoordinator()
        SnapshotLoader(t, cp, device="cpu").upload_tables()
        assert cp.get_transfer_state("pos") == {
            "snapshot_position": {"wal_lsn": "0/ABCDEF0"}}
        assert get_store("pos").row_count() == 100
    finally:
        pg.stop()


def test_read_bytes_is_arrow_nbytes():
    """read_bytes of a slice: the Arrow bytes it references (pyarrow's
    own number, read here straight from the JAX package's reader)."""
    import pyarrow as pa
    import pyarrow.csv as pacsv

    data = b"".join(b"%d,%s,%s\n" % (i, b"" if i % 5 == 0 else b"s%d" % i,
                                    b"" if i % 3 == 0 else b"true")
                    for i in range(3001))
    tbl = pacsv.read_csv(
        io.BytesIO(data),
        read_options=pacsv.ReadOptions(column_names=["a", "b", "c"]),
        convert_options=pacsv.ConvertOptions(
            column_types={"a": pa.int64(), "b": pa.string(),
                          "c": pa.bool_()},
            null_values=[""], strings_can_be_null=True))
    want = [rb.nbytes for rb in tbl.to_batches(max_chunksize=999)]
    from transferia_tpu_torch.abstract.schema import (
        CanonicalType,
        ColSchema,
        TableSchema,
    )

    schema = TableSchema([ColSchema("a", CanonicalType.INT64),
                          ColSchema("b", CanonicalType.UTF8),
                          ColSchema("c", CanonicalType.BOOLEAN)])
    got = [b.read_bytes for b in decode_copy_csv(
        data, TableID("", "t"), schema, 999)]
    assert got == want
