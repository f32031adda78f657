"""The checksum task and the fingerprint's host lanes (the port's
`tasks/checksum.py`, `ops/rowhash.py` host backend and chooser,
`providers/memory.py::MemoryStoreStorage` and
`providers/clickhouse/provider.py::CHStorage`) against the JAX package's,
on the CPU.

Held equal, exactly: every comparator case of the JAX package's
`tests/unit/test_checksum_compare.py` and the type families; the
`ChecksumReport` tables (counts, strategy, mismatches, notes,
fingerprints) of both compare methods over memory storages and over each
package's own fake Postgres -> fake ClickHouse transfer (the scenarios of
`tests/e2e/test_checksum_e2e.py`: ok, a tampered value, a missing row,
the sampled strategy with a tampered top row, strict types, float drift
past 12 digits, a real fingerprint mismatch); the digests and row keys of
the host library's lanes, K10's plain version and the JAX package's
host route over a numpy-seeded batch of every column kind; and
`TableFingerprinter._choose`'s decisions on a fixed ns/row sequence.
The CLI's `checksum` command waits on the port's CLI (ROADMAP.md A5).
"""

import datetime as dt
import importlib

import numpy as np
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from tests.recipes.fake_postgres import FakePG as RefFakePG
from tests.recipes.fake_postgres import FakeTable as RefFakeTable
from transferia_tpu.abstract.schema import CanonicalType as RefCT
from transferia_tpu.abstract.schema import ColSchema as RefColSchema
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import TableSchema as RefTableSchema
from transferia_tpu.columnar import batch as ref_batch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.ops import linkprobe as ref_linkprobe
from transferia_tpu.ops import rowhash as ref_rowhash
from transferia_tpu.providers.clickhouse import CHTargetParams as RefCHTarget
from transferia_tpu.providers.clickhouse.provider import (
    CHSourceParams as RefCHSource,
)
from transferia_tpu.providers.clickhouse.provider import (
    CHStorage as RefCHStorage,
)
from transferia_tpu.providers.memory import (
    MemorySourceParams as RefMemSource,
)
from transferia_tpu.providers.memory import (
    MemoryStorage as RefMemStorage,
)
from transferia_tpu.providers.memory import (
    MemoryStoreStorage as RefStoreStorage,
)
from transferia_tpu.providers.memory import (
    MemoryTargetParams as RefMemTarget,
)
from transferia_tpu.providers.memory import get_store as ref_get_store
from transferia_tpu.providers.memory import seed_source as ref_seed
from transferia_tpu.providers.postgres import PGSourceParams as RefPGSource
from transferia_tpu.providers.postgres.provider import (
    PGStorage as RefPGStorage,
)
from transferia_tpu.providers.sample import make_batch as ref_make_batch
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu.tasks.snapshot import SnapshotLoader as RefLoader
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar import batch as port_batch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.ops import linkprobe as port_linkprobe
from transferia_tpu_torch.ops import rowhash as port_rowhash
from transferia_tpu_torch.providers.clickhouse import (
    CHSourceParams,
    CHStorage,
    CHTargetParams,
)
from transferia_tpu_torch.providers.memory import (
    MemorySourceParams,
    MemoryStorage,
    MemoryStoreStorage,
    MemoryTargetParams,
    get_store,
    seed_source,
)
from transferia_tpu_torch.providers.postgres import PGSourceParams
from transferia_tpu_torch.providers.postgres.provider import PGStorage
from transferia_tpu_torch.providers.sample import make_batch
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_postgres import FakePG, FakeTable
from transferia_tpu_torch.tasks import activate_delivery
from transferia_tpu_torch.tasks.snapshot import SnapshotLoader

CPU = "cpu"
# the modules (each package's `tasks` exports a `checksum` function)
PORT = importlib.import_module("transferia_tpu_torch.tasks.checksum")
REF = importlib.import_module("transferia_tpu.tasks.checksum")


def port_col(orig="", ctype=CanonicalType.UTF8):
    return ColSchema(name="c", data_type=ctype, original_type=orig)


def ref_col(orig="", ctype=RefCT.UTF8):
    return RefColSchema(name="c", data_type=ctype, original_type=orig)


# -- the comparators (test_checksum_compare.py) ------------------------------

# (lval, schema (original type, canonical type name) or None, rval)
COMPARE_CASES = [
    (1, None, 1), ("x", None, "x"),
    (None, None, None), (None, None, 0), ("", None, None),
    (True, None, 1), (False, None, "false"), (True, None, 0),
    (1.4142135623730951, None, 1.4142135623730999),
    (1.41421, None, 1.41422), (1.0, None, 1),
    ("1.50", ("", "double"), 1.5),
    (float("nan"), None, float("nan")),
    (b"abc", None, "abc"), ("\\x616263", None, b"abc"),
    (b"abc", None, "abd"),
    ("2024-01-02 03:04:05+00", ("pg:timestamp with time zone", "utf8"),
     "2024-01-02 06:04:05+03"),
    (dt.datetime(2024, 1, 2, 3, 4, 5),
     ("pg:timestamp without time zone", "utf8"), "2024-01-02T03:04:05"),
    (dt.date(2024, 1, 2), ("mysql:date", "utf8"), "2024-01-02"),
    ("2024-01-02 03:04:05.000001", ("ch:DateTime64(6)", "utf8"),
     "2024-01-02 03:04:05.000002"),
    ("1 day", ("pg:interval", "utf8"), "1 days 00:00"),
    ("(2,2),(0,0)", ("pg:box", "utf8"), "(2.0,2.0),(0.0,0.0)"),
    ([1.0, 2.0], ("pg:double precision[]", "any"), [1, 2]),
    ([1, 2], ("pg:double precision[]", "any"), [1, 2, 3]),
    ([1, 2], ("pg:double precision[]", "any"), [1, 3]),
    ([[1, 2], [3]], None, [[1, 2], [3]]),
    ('{"a": 1}', ("pg:jsonb", "any"), '{"a":1}'),
    ("abc", ("pg:lseg", "utf8"), "abc"),
    ("[(0,0),(1,1)]", ("pg:lseg", "utf8"), "((0,0),(1,1))"),
    ("12", ("", "utf8"), "12.0"), ("x", None, "y"),
]


def _schema(pkg, spec):
    if spec is None:
        return None
    orig, ctype = spec
    if pkg == "port":
        return port_col(orig, CanonicalType(ctype))
    return ref_col(orig, RefCT(ctype))


@pytest.mark.parametrize("case", range(len(COMPARE_CASES)))
def test_try_compare_equals_jax(case):
    """try_compare (and values_equal) of the port equal the JAX
    package's on each case, exactly (raising alike)."""
    lv, spec, rv = COMPARE_CASES[case]
    out = {}
    for pkg, mod in (("port", PORT), ("jax", REF)):
        s = _schema(pkg, spec)
        try:
            out[pkg] = mod.try_compare(lv, s, rv, s)
        except mod.ComparisonError as e:
            out[pkg] = ("raises", str(e))
        out[pkg] = (out[pkg], mod.values_equal(lv, rv, s, s))
    assert out["port"] == out["jax"]


def test_comparator_reference_cases():
    """The JAX package's own expectations, on the port (exact)."""
    f = port_col(ctype=CanonicalType.DOUBLE)
    assert PORT.try_compare("1.50", f, 1.5, f)
    assert PORT.try_compare(1.4142135623730951, None,
                            1.4142135623730999, None)
    assert not PORT.try_compare(1.41421, None, 1.41422, None)
    assert PORT.compare_pg_interval("1 day", "1 days")
    assert PORT.compare_pg_interval("01:00", "01:00:00")
    assert not PORT.compare_pg_interval("01:00", "01:00:01")
    assert PORT.compare_pg_geometry(
        "(1.414213562373095,1.414213562373095)",
        "(1.4142135623730951,1.4142135623730951)")
    assert not PORT.compare_pg_geometry("(1,2)", "(1,3)")
    assert PORT.compare_pg_lseg("[(0,0),(1,1)]", "((0,0),(1,1))")
    assert not PORT.values_equal(object(), object())

    def always_equal(lv, ls, rv, rs, into_array):
        return True, True

    assert PORT.try_compare("a", None, "b", None, [always_equal])


@pytest.mark.parametrize("pair", [
    ("utf8", "string"), ("decimal", "string"), ("int32", "int64"),
    ("timestamp", "datetime"), ("double", "int64"), ("boolean", "int8"),
    ("interval", "int64"), ("any", "utf8"), ("float", "double")])
def test_type_families_equal_jax(pair):
    """heterogeneous_data_types of both packages (exact)."""
    assert PORT.heterogeneous_data_types(*pair) == \
        REF.heterogeneous_data_types(*pair)


def test_error_map_and_report_summary_equal_jax():
    """The error map's samples and the report's summary text (exact)."""
    def run(mod, tid):
        em = mod.ErrorMap()
        for i in range(5):
            em.add("s.t", mod.GENERIC_ERROR, f"e{i}")
        em.add("s.t", mod.SCHEMA_MISMATCH_ERROR, "x")
        tc = mod.TableChecksum(table=tid, source_rows=3, target_rows=2,
                               mismatches=["m"], notes=["n"])
        rep = mod.ChecksumReport(tables=[tc])
        return [em.table_errors("s.t"), em.total(), rep.ok, rep.summary()]
    assert run(PORT, TableID("s", "t")) == run(REF, RefTableID("s", "t"))


# -- memory storages (the streaming compare) ---------------------------------

MEM = {
    "port": dict(mod=PORT, seed=seed_source, batch=make_batch, tid=TableID,
                 storage=MemoryStorage, params=MemorySourceParams,
                 store_storage=MemoryStoreStorage,
                 target=MemoryTargetParams, transfer=Transfer,
                 cp=MemoryCoordinator, loader=SnapshotLoader,
                 get_store=get_store, kw={"device": CPU}),
    "jax": dict(mod=REF, seed=ref_seed, batch=ref_make_batch,
                tid=RefTableID, storage=RefMemStorage, params=RefMemSource,
                store_storage=RefStoreStorage, target=RefMemTarget,
                transfer=RefTransfer, cp=RefCoordinator, loader=RefLoader,
                get_store=ref_get_store, kw={}),
}


def report_of(rep):
    """A ChecksumReport as plain data."""
    return [(t.table.fqtn(), t.source_rows, t.target_rows, t.compared_rows,
             t.strategy, list(t.mismatches), list(t.notes),
             t.source_fingerprint, t.target_fingerprint, t.ok)
            for t in rep.tables]


def mem_storage(k, sid, rows=120, corrupt_at=None):
    b = k["batch"]("users", k["tid"]("sample", "users"), 0, rows, seed=3)
    if corrupt_at is not None:
        b.columns["score"].data[corrupt_at] += 0.5
    k["seed"](sid, [b])
    return k["storage"](k["params"](source_id=sid))


@pytest.mark.parametrize("method", ["compare", "fingerprint"])
@pytest.mark.parametrize("corrupt", [None, 77])
def test_memory_storages_equal_jax(method, corrupt):
    """compare_checksum over two seeded memory storages (chunked key-set
    flushes; the fingerprint's host lanes): equal reports, and the
    corruption found by both (exact)."""
    out = {}
    for pkg, k in MEM.items():
        src = mem_storage(k, f"cs_src_{pkg}")
        dst = mem_storage(k, f"cs_dst_{pkg}", corrupt_at=corrupt)
        params = k["mod"].ChecksumParameters(
            keyset_chunk=16, method=method, fingerprint_backend="host")
        out[pkg] = report_of(k["mod"].compare_checksum(src, dst,
                                                       params=params))
    assert out["port"] == out["jax"]
    ok = out["port"][0][-1]
    assert ok == (corrupt is None)
    if corrupt is not None:
        assert any("score" in m for m in out["port"][0][5])


@pytest.mark.parametrize("corrupt", [False, True])
def test_memory_sink_read_back_equals_jax(corrupt):
    """A memory -> memory snapshot, then the checksum of the seeded source
    (one score changed after the snapshot when `corrupt`) against the
    sink's captured rows through MemoryStoreStorage, both methods
    (exact)."""
    out = {}
    for pkg, k in MEM.items():
        src_id, sink_id = f"rb_src_{pkg}", f"rb_sink_{pkg}"
        mem_storage(k, src_id, rows=200)
        k["get_store"](sink_id).clear()
        t = k["transfer"](id=f"rb_{pkg}", src=k["params"](source_id=src_id),
                          dst=k["target"](sink_id=sink_id))
        k["loader"](t, k["cp"](), **k["kw"]).upload_tables()
        dst = k["store_storage"](sink_id)
        rows = []
        for method in ("compare", "fingerprint"):
            # the source re-seeded, one score changed when `corrupt`
            rep = k["mod"].compare_checksum(
                mem_storage(k, src_id, rows=200,
                            corrupt_at=5 if corrupt else None), dst,
                params=k["mod"].ChecksumParameters(
                    keyset_chunk=64, method=method,
                    fingerprint_backend="host"))
            rows.append(report_of(rep))
        out[pkg] = [rows, sorted(str(t) for t in dst.table_list()),
                    str(dst.table_schema(k["tid"]("sample", "users")))]
    assert out["port"] == out["jax"]
    assert out["port"][0][0][0][-1] is (not corrupt)


# -- Postgres -> ClickHouse (test_checksum_e2e.py) ---------------------------

ROWS = 260
E2E = {
    "port": dict(mod=PORT, pg=FakePG, table=FakeTable, ch=FakeCH,
                 pg_params=PGSourceParams, ch_target=CHTargetParams,
                 ch_source=CHSourceParams, pg_storage=PGStorage,
                 ch_storage=CHStorage, transfer=Transfer,
                 cp=MemoryCoordinator, activate=activate_delivery,
                 kw={"device": CPU}),
    "jax": dict(mod=REF, pg=RefFakePG, table=RefFakeTable, ch=RefFakeCH,
                pg_params=RefPGSource, ch_target=RefCHTarget,
                ch_source=RefCHSource, pg_storage=RefPGStorage,
                ch_storage=RefCHStorage, transfer=RefTransfer,
                cp=RefCoordinator, activate=ref_activate, kw={}),
}


@pytest.fixture(scope="module")
def farms():
    """Each package's fake Postgres with 260 users and its fake
    ClickHouse after `activate_delivery` of the table."""
    out = {}
    for pkg, k in E2E.items():
        pg = k["pg"]().start()
        pg.add_table(k["table"](
            "public", "users",
            [("id", "bigint", True, True), ("name", "text", False, False),
             ("score", "double precision", False, False)],
            [{"id": str(i), "name": f"user-{i:04d}", "score": f"{i * 1.5}"}
             for i in range(ROWS)]))
        ch = k["ch"]().start()
        t = k["transfer"](
            id=f"chk-e2e-{pkg}",
            src=k["pg_params"](host="127.0.0.1", port=pg.port,
                               database="db", user="u"),
            dst=k["ch_target"](host="127.0.0.1", port=ch.port,
                               bufferer=None))
        k["activate"](t, k["cp"](), **k["kw"])
        assert len(ch.rows("public__users")) == ROWS
        out[pkg] = (pg, ch)
    yield out
    for pg, ch in out.values():
        pg.stop()
        ch.stop()


def storages(k, pg, ch, shrink=False):
    src = k["pg_storage"](k["pg_params"](host="127.0.0.1", port=pg.port,
                                         database="db", user="u"))
    dst = k["ch_storage"](k["ch_source"](host="127.0.0.1", port=ch.port))
    if shrink:
        # 260 rows over the sample limits: top/bottom covers 2 x 50,
        # the random probe every 7th row
        for s in (src, dst):
            s.TOP_BOTTOM_LIMIT = 50
            s.RANDOM_SAMPLE_LIMIT = 40
    return src, dst


def _row_by_id(ch, rid):
    return next(r for r in ch.tables["public__users"]["rows"]
                if r["id"] == rid)


def _set(ch, rid, col, value):
    row = _row_by_id(ch, rid)
    old, row[col] = row[col], value
    return lambda: row.__setitem__(col, old)


def _pop(ch, rid):
    rows = ch.tables["public__users"]["rows"]
    i = next(i for i, r in enumerate(rows) if r["id"] == rid)
    row = rows.pop(i)
    return lambda: rows.insert(i, row)


# name: (mutation, params, strict types, shrink the sample limits)
E2E_CASES = {
    "full_ok": (None, dict(keyset_chunk=64), False, False),
    "full_tampered": (lambda ch: _set(ch, 123, "name", "tampered"),
                      dict(keyset_chunk=64), False, False),
    "full_missing_row": (lambda ch: _pop(ch, 200), dict(keyset_chunk=64),
                         False, False),
    "sampled_ok": (None, dict(table_size_threshold=1000), False, True),
    "sampled_tampered_top": (
        lambda ch: _set(ch, 3, "score", 4.5 + 999),
        dict(table_size_threshold=1000), False, True),
    "schema_mismatch": (None, {}, True, False),
    "fingerprint_ok": (None, dict(method="fingerprint", keyset_chunk=64,
                                  fingerprint_backend="host"), False, False),
    "fingerprint_drift": (
        lambda ch: _set(ch, 50, "score", "75.0000000000001"),
        dict(method="fingerprint", keyset_chunk=64,
             fingerprint_backend="host"), False, False),
    "fingerprint_mismatch": (
        lambda ch: _set(ch, 51, "name", "really-different"),
        dict(method="fingerprint", keyset_chunk=64,
             fingerprint_backend="host"), False, False),
    "fingerprint_missing_row": (
        lambda ch: _pop(ch, 17),
        dict(method="fingerprint", keyset_chunk=64,
             fingerprint_backend="host"), False, False),
}


@pytest.mark.parametrize("case", list(E2E_CASES))
def test_pg2ch_checksum_equals_jax(farms, case):
    """Each package's Postgres -> ClickHouse transfer checked by its own
    checksum over its own fakes: equal reports (counts, strategy, every
    mismatch line, notes, fingerprints), exactly."""
    mutate, params, strict, shrink = E2E_CASES[case]
    out = {}
    for pkg, k in E2E.items():
        pg, ch = farms[pkg]
        src, dst = storages(k, pg, ch, shrink)
        undo = mutate(ch) if mutate is not None else None
        try:
            kw = {} if strict else dict(
                equal_data_types=k["mod"].heterogeneous_data_types)
            rep = k["mod"].compare_checksum(
                src, dst, params=k["mod"].ChecksumParameters(**params), **kw)
        finally:
            if undo is not None:
                undo()
            src.close()
            dst.close()
        out[pkg] = report_of(rep)
    assert out["port"] == out["jax"]
    (row,) = out["port"]
    ok, mismatches, notes = row[-1], row[5], row[6]
    assert ok == (case in ("full_ok", "sampled_ok", "fingerprint_ok",
                           "fingerprint_drift"))
    if case == "full_ok":
        assert row[4] == "full" and row[3] == ROWS
        assert any("OR" in q and "WHERE" in q for q in farms["port"][1].queries)
    if case == "sampled_ok":
        assert row[4] == "sample" and 0 < row[3] < ROWS
    if case == "full_missing_row":
        assert any("missing in target" in m for m in mismatches)
    if case in ("full_tampered", "fingerprint_mismatch"):
        assert any("name" in m for m in mismatches)
    if case == "fingerprint_mismatch":
        assert any("fingerprints differ" in m for m in mismatches)
        assert any(m.startswith("row (51,)") for m in mismatches)
    if case == "fingerprint_drift":
        assert notes and "representation-only" in notes[0]
    if case == "schema_mismatch":
        assert any("types differ" in m for m in mismatches)


@pytest.mark.parametrize("backend", ["host", "device", "auto"])
def test_pg2ch_fingerprint_backends(farms, backend):
    """The port's fingerprint digests of both tables are the same under
    the host lanes, K10's plain version ("device" on the CPU) and auto,
    and equal the JAX package's host digests (exact)."""
    k = E2E["port"]
    src, dst = storages(k, *farms["port"])
    rep = PORT.compare_checksum(
        src, dst, params=PORT.ChecksumParameters(
            method="fingerprint", fingerprint_backend=backend),
        equal_data_types=PORT.heterogeneous_data_types, device=CPU)
    rk = E2E["jax"]
    rsrc, rdst = storages(rk, *farms["jax"])
    want = REF.compare_checksum(
        rsrc, rdst, params=REF.ChecksumParameters(
            method="fingerprint", fingerprint_backend="host"),
        equal_data_types=REF.heterogeneous_data_types)
    assert report_of(rep) == report_of(want)
    assert rep.ok and rep.tables[0].strategy == "fingerprint"
    for s in (src, dst, rsrc, rdst):
        s.close()


def test_ch_storage_equals_jax(farms):
    """CHStorage: the table list, schema, counts, size, the streamed rows
    and each sample, against the JAX package's over its fake (exact)."""
    from transferia_tpu.abstract.table import (
        TableDescription as RefTD,
    )
    from transferia_tpu_torch.abstract.table import TableDescription

    def run(k, ch, tid, td_cls):
        s = k["ch_storage"](k["ch_source"](host="127.0.0.1", port=ch.port))
        s.TOP_BOTTOM_LIMIT, s.RANDOM_SAMPLE_LIMIT = 5, 4
        td = td_cls(id=tid)
        got = {}
        for name, call in (
                ("all", lambda p: s.load_table(td, p)),
                ("random", lambda p: s.load_random_sample(td, p)),
                ("topbottom", lambda p: s.load_top_bottom_sample(td, p)),
                ("byset", lambda p: s.load_sample_by_set(
                    td, [{"id": 7}, {"id": 250}, {"id": 9999}], p))):
            batches = []
            call(batches.append)
            got[name] = [b.to_pydict() for b in batches]
        out = [sorted(str(t) for t in s.table_list()),
               [(c.name, c.data_type.value, c.primary_key, c.required,
                 c.original_type) for c in s.table_schema(tid)],
               s.exact_table_rows_count(tid), s.table_size_in_bytes(tid),
               got]
        s.close()
        return out
    got = run(E2E["port"], farms["port"][1], TableID("public", "users"),
              TableDescription)
    want = run(E2E["jax"], farms["jax"][1], RefTableID("public", "users"),
               RefTD)
    assert got == want
    assert len(got[4]["topbottom"][0]["id"]) == 5


# -- the host lanes and the chooser ------------------------------------------

def lanes_batch(pkg, n=333, seed=7):
    """Every column kind: fixed ints/floats (with -0.0 and NaN), bools,
    var utf8 with NULLs, and a dictionary column."""
    rng = np.random.default_rng(seed)
    tid_cls, ct, cs, schema_cls, b = {
        "port": (TableID, CanonicalType, ColSchema, TableSchema, port_batch),
        "jax": (RefTableID, RefCT, RefColSchema, RefTableSchema,
                ref_batch)}[pkg]
    f = rng.normal(size=n)
    f[:3] = [-0.0, np.nan, 0.0][:n]
    words = [bytes(rng.integers(97, 123, int(rng.integers(0, 90))).astype(
        np.uint8)) for _ in range(n)]
    vals = [b"alpha", b"beta", b"", b"x" * 70]
    pool = b.DictPool(np.frombuffer(b"".join(vals), np.uint8).copy(),
                      b._offsets_from_lengths([len(v) for v in vals]))
    schema = schema_cls((
        cs("id", ct.INT64, primary_key=True), cs("f", ct.DOUBLE),
        cs("ok", ct.BOOLEAN), cs("s", ct.UTF8), cs("d", ct.UTF8)))
    valid = rng.random(n) < 0.8
    return b.ColumnBatch(tid_cls("s", "lanes"), schema, {
        "id": b.Column("id", ct.INT64, rng.integers(-2**62, 2**62, n)),
        "f": b.Column("f", ct.DOUBLE, f),
        "ok": b.Column("ok", ct.BOOLEAN, rng.random(n) < 0.5),
        "s": b.Column("s", ct.UTF8,
                      np.frombuffer(b"".join(words), np.uint8).copy(),
                      b._offsets_from_lengths([len(w) for w in words]),
                      validity=valid),
        "d": b.Column("d", ct.UTF8, dict_enc=b.DictEnc(
            rng.integers(0, 4, n).astype(np.int32), pool=pool)),
    })


@pytest.mark.parametrize("n", [0, 1, 333])
def test_host_lanes_equal_plain_and_jax(n):
    """The host library's lanes, K10's plain version and the JAX
    package's host route give the same digest and row keys (exact)."""
    pb, rb = lanes_batch("port", n), lanes_batch("jax", n)
    want = ref_rowhash.fingerprint_host(*ref_rowhash.prep_batch(rb))
    native = port_rowhash.fingerprint_native(
        *port_rowhash.prep_batch(pb, CPU, native=True))
    plain = port_rowhash.fingerprint_host(*port_rowhash.prep_batch(pb, CPU))
    assert native.digest() == plain.digest() == want.digest()
    keys = port_rowhash.batch_row_keys(pb, backend="host")
    np.testing.assert_array_equal(keys, ref_rowhash.batch_row_keys(
        rb, backend="host"))
    np.testing.assert_array_equal(keys, port_rowhash.batch_row_keys(
        pb, backend="device", device=CPU))
    fp = port_rowhash.TableFingerprinter(backend="host")
    fp.push(pb)
    assert fp.result().digest() == want.digest()


def test_native_pool_accumulators_equal_plain():
    """A pool's accumulators through `polyhash_varcol` equal the plain
    version's (exact), and either fills the shared memo."""
    rng = np.random.default_rng(11)
    vals = [bytes(rng.integers(0, 256, int(rng.integers(0, 200))).astype(
        np.uint8)) for _ in range(300)]

    def mk():
        return port_batch.DictPool(
            np.frombuffer(b"".join(vals), np.uint8).copy(),
            port_batch._offsets_from_lengths([len(v) for v in vals]))

    a = port_rowhash.pool_accumulators_native(mk())
    b = port_rowhash.pool_accumulators(mk(), CPU)
    assert all(x.dtype == y.dtype and bool((x == y).all())
               for x, y in zip(a, b))


LINK = "0.02,20000,20000"   # rtt ms, h2d MB/s, d2h MB/s
# (host samples, host ns/row, batch number, rows, row bytes)
CHOOSE_STEPS = [
    (0, -1.0, 1, 10_000, 64), (1, -1.0, 2, 10_000, 64),
    (2, 120.0, 3, 10_000, 64), (2, 120.0, 4, 10_000, 64),
    (2, 20.0, 256, 10_000, 64), (2, 20.0, 257, 10_000, 64),
    (3, 300.0, 512, 1_000, 4096), (3, 5.0, 768, 1_000_000, 8),
]


def test_choose_decisions_equal_jax(monkeypatch):
    """TableFingerprinter._choose on a fixed ns/row sequence, a pinned link
    profile and an accelerator present: the same placement at every step
    in both packages (exact), host before two samples, re-decided every
    REPROBE_EVERY batches."""
    monkeypatch.setenv("TRANSFERIA_TPU_LINK", LINK)
    monkeypatch.setattr(ref_linkprobe, "_cached", None)
    monkeypatch.setattr(port_linkprobe, "_cached", {})
    port_fp = port_rowhash.TableFingerprinter(device=CPU)
    ref_fp = ref_rowhash.TableFingerprinter()
    assert port_fp.REPROBE_EVERY == ref_fp.REPROBE_EVERY == 256
    for fp in (port_fp, ref_fp):
        monkeypatch.setattr(fp, "_accel_available", lambda: True)
    got = {"port": [], "jax": []}
    for samples, ns, batch_no, n, row_bytes in CHOOSE_STEPS:
        for name, fp in (("port", port_fp), ("jax", ref_fp)):
            fp._host_samples, fp._host_ns_row = samples, ns
            fp._batch_no = batch_no
            got[name].append(fp._choose(n, row_bytes))
    assert got["port"] == got["jax"]
    assert got["port"][:2] == ["host", "host"]
    assert set(got["port"]) == {"host", "device"}


def test_auto_on_the_cpu_is_the_host():
    """Without a card ("cpu") auto never leaves the host lanes, as the
    reference's does with JAX on the CPU; the digest equals the JAX
    package's (exact)."""
    pb, rb = lanes_batch("port"), lanes_batch("jax")
    fp = port_rowhash.TableFingerprinter(device=CPU)
    for lo in range(0, pb.n_rows, 100):
        fp.push(pb.slice(lo, lo + 100))
    assert fp.choices == ["host"] * 4 and fp._device is None
    want = ref_rowhash.fingerprint_host(*ref_rowhash.prep_batch(rb))
    assert fp.result().digest() == want.digest()


def test_checksum_fingerprint_needs_a_card_or_the_cpu(monkeypatch):
    """A device fingerprint without a card raises (no quiet CPU route).
    The checksum records it in the error map, as the JAX package does,
    and (a deliberate difference, ROADMAP.md C) fails the table, where
    the JAX package lets the row-level pass decide; the row-level pass
    still runs and finds the rows equal.  With device="cpu" K10's plain
    version fingerprints and the table passes."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = MEM["port"]
    src = mem_storage(k, "nc_src", rows=50)
    dst = mem_storage(k, "nc_dst", rows=50)
    rep = PORT.checksum(src, dst, params=PORT.ChecksumParameters(
        method="fingerprint", fingerprint_backend="device"))
    (tc,) = rep.tables
    assert not rep.ok and not tc.ok
    assert tc.strategy == "fingerprint+full" and tc.compared_rows == 50
    (failed,) = tc.mismatches
    assert failed.startswith("fingerprint failed: ") and \
        "device='cpu'" in failed
    assert tc.notes == []
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_rowhash.TableFingerprinter(backend="device")
    rep = PORT.checksum(src, dst, device=CPU,
                        params=PORT.ChecksumParameters(
                            method="fingerprint",
                            fingerprint_backend="device"))
    assert rep.ok and rep.tables[0].strategy == "fingerprint"


def test_memory_sink_counts_no_rows_as_in_jax():
    """Both packages' MemoryStoreStorage count 0 rows (the Storage
    default), so a checksum of a counting source (the sample storage)
    against a memory sink reports differing row counts in both, with
    equal reports (exact).  ROADMAP.md C notes it: a fix is the
    reference's."""
    from transferia_tpu.factories import new_storage as ref_new_storage
    from transferia_tpu.providers.sample import (
        SampleSourceParams as RefSample,
    )
    from transferia_tpu_torch.factories import new_storage
    from transferia_tpu_torch.providers.sample import SampleSourceParams

    out = {}
    for pkg, k, sample, storage in (
            ("port", MEM["port"], SampleSourceParams, new_storage),
            ("jax", MEM["jax"], RefSample, ref_new_storage)):
        sink_id = f"cnt_{pkg}"
        k["get_store"](sink_id).clear()
        t = k["transfer"](id=sink_id, src=sample(preset="users",
                                                 table="users", rows=90),
                          dst=k["target"](sink_id=sink_id))
        k["loader"](t, k["cp"](), **k["kw"]).upload_tables()
        rep = k["mod"].compare_checksum(storage(t),
                                        k["store_storage"](sink_id))
        out[pkg] = report_of(rep)
    assert out["port"] == out["jax"]
    assert "row counts differ: src=90 dst=0" in out["port"][0][5]


@pytest.mark.parametrize("chunk", [1, 7, 64, 1 << 20])
def test_rowbinary_stream_rows_cut_at_chunk_boundaries(chunk):
    """A deliberate difference: the port's RowBinary stream decoder
    appends a row's values only once the whole row parsed, so a row cut
    at a chunk boundary decodes; the JAX package's appends column by
    column and raises a ragged batch there (its CHStorage fails on
    tables over one 8 MB chunk).  Exact against the whole-buffer decode.
    ROADMAP.md C pins it."""
    from transferia_tpu.providers.clickhouse import rowbinary as ref_rb
    from transferia_tpu_torch.providers.clickhouse import rowbinary as rb

    schema = TableSchema((
        ColSchema("id", CanonicalType.INT64, primary_key=True),
        ColSchema("url", CanonicalType.UTF8),
        ColSchema("score", CanonicalType.DOUBLE, required=False)))
    rng = np.random.default_rng(3)
    n = 500
    batch = port_batch.ColumnBatch.from_pydict(TableID("", "t"), schema, {
        "id": list(range(n)),
        "url": [f"u{'x' * int(k)}" for k in rng.integers(0, 40, n)],
        "score": [None if k % 5 == 0 else float(k) for k in range(n)]})
    payload = bytes(rb.encode_rowbinary(batch, {"score": True}))

    def reader(data):
        pos = [0]

        def read(k):
            out = data[pos[0]:pos[0] + min(k, chunk)]
            pos[0] += len(out)
            return out
        return read

    got = list(rb.decode_rowbinary_stream(
        reader(payload), schema, {"score": True}, batch_rows=128,
        chunk_bytes=chunk))
    assert sum(b.n_rows for b in got) == n
    assert port_batch.ColumnBatch.concat(got).to_pydict() == \
        batch.to_pydict()
    ref_schema = RefTableSchema((
        RefColSchema("id", RefCT.INT64, primary_key=True),
        RefColSchema("url", RefCT.UTF8),
        RefColSchema("score", RefCT.DOUBLE, required=False)))
    ref_stream = ref_rb.decode_rowbinary_stream(
        reader(payload), ref_schema, {"score": True}, batch_rows=128,
        chunk_bytes=chunk)
    if chunk >= len(payload):
        ref = list(ref_stream)
        assert [b.to_pydict() for b in ref] == [b.to_pydict() for b in got]
    else:
        with pytest.raises(ValueError, match="ragged"):
            list(ref_stream)
