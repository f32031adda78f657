"""The port's Oracle provider (`transferia_tpu_torch/providers/oracle/`:
the TNS framing and value codecs, the TTC client, the SCN-pinned
snapshot storage and LogMiner CDC) against the JAX package's, on the
CPU, exactly.

- Codecs: seeded NUMBER values (negative, zero, 38 digits, 1e-130,
  9.99e125), DATE, TIMESTAMP, BINARY_FLOAT and BINARY_DOUBLE (NaN, the
  infinities, -0.0) encode byte for byte as the JAX package's and decode
  to equal values; the TNS packets likewise.
- The two fakes speak one protocol: the port's client against the JAX
  package's fake (`tests/recipes/fake_oracle.py`) and the JAX client
  against the port's (`recipes/fake_oracle.py`).
- The cases of `tests/e2e/test_oracle_e2e.py`,
  `tests/e2e/test_oracle_logminer_e2e.py` and
  `tests/unit/test_oracle_codecs.py`, each package against its own fake:
  schema discovery, keyset paging, the SCN-pinned snapshot, ROWID
  shards, the wide NUMBER, sampling and the sampled checksum, the redo
  parser (every statement of the JAX tests and a seeded set), LogMiner
  replication, the resume at a boundary SCN and CSF continuations: equal
  batches, items, their order and transfer state.
- The S&I handoff: on the snapshot loader's route both packages record
  the pinned SCN and the LogMiner source starts there; on the MVCC route
  the port pins and records it too, where the reference does not
  (ROADMAP.md C8): a change committed during the load is lost by the
  reference's tail and delivered by the port's.
- The slice through the chain: Oracle -> mask on EMAIL + `SCORE > 0.25`
  (a BINARY_FLOAT column with NaN, infinities, -0.0 and nulls, filtered
  by the fused program's plain versions) -> memory, byte-identical to
  the JAX package's run on the CPU.
"""

import datetime as dt
import math
import struct
import socket
import threading
import time
from decimal import Decimal

import numpy as np
import pytest

from tests.recipes import fake_oracle as ref_fake
from tests.torch_quiescent import ledger_quiescent  # noqa: F401
from transferia_tpu.abstract.interfaces import (
    SyncAsAsyncSink as RefSyncAsAsync,
)
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.table import TableDescription as RefTD
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import TransferType as RefTransferType
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.oracle import logminer as ref_lm
from transferia_tpu.providers.oracle import provider as ref_provider
from transferia_tpu.providers.oracle import tns as ref_tns
from transferia_tpu.providers.oracle import wire as ref_wire
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu.tasks.checksum import ChecksumParameters as RefCkParams
from transferia_tpu.tasks.checksum import compare_checksum as ref_compare
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch.abstract.interfaces import SyncAsAsyncSink
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.oracle import logminer as port_lm
from transferia_tpu_torch.providers.oracle import provider as port_provider
from transferia_tpu_torch.providers.oracle import tns as port_tns
from transferia_tpu_torch.providers.oracle import wire as port_wire
from transferia_tpu_torch.recipes import fake_oracle as port_fake
from transferia_tpu_torch.tasks import SnapshotLoader, activate_delivery
from transferia_tpu_torch.tasks.checksum import (
    ChecksumParameters,
    compare_checksum,
)
from transferia_tpu_torch.transform import fused as port_tfused

CPU = {"device": "cpu"}
PKGS = {
    "port": dict(tns=port_tns, wire=port_wire, provider=port_provider,
                 lm=port_lm, fake=port_fake, memory=port_memory,
                 transfer=Transfer, ttype=TransferType,
                 coordinator=MemoryCoordinator, activate=activate_delivery,
                 loader=SnapshotLoader, compare=compare_checksum,
                 ck_params=ChecksumParameters, tid=TableID,
                 td=TableDescription, kind=Kind, sync=SyncAsAsyncSink,
                 fused=port_tfused, kw=CPU),
    "jax": dict(tns=ref_tns, wire=ref_wire, provider=ref_provider,
                lm=ref_lm, fake=ref_fake, memory=ref_memory,
                transfer=RefTransfer, ttype=RefTransferType,
                coordinator=RefCoordinator, activate=ref_activate,
                loader=RefLoader, compare=ref_compare,
                ck_params=RefCkParams, tid=RefTableID,
                td=RefTD, kind=RefKind, sync=RefSyncAsAsync,
                fused=ref_tfused, kw={}),
}
SETTLE_S = 20.0

EMP_ROWS = 250
EMP_COLUMNS = [("ID", "NUMBER(10)", True, True),
               ("NAME", "VARCHAR2(100)", False, False),
               ("SALARY", "NUMBER(10,2)", False, False),
               ("RATIO", "BINARY_DOUBLE", False, False),
               ("HIRED", "DATE", False, False)]
# the chip phase's table shape: a BINARY_FLOAT score with the IEEE
# specials and nulls, a NUMBER(12,2), a NUMBER(30) that stays DECIMAL,
# a DATE and a TIMESTAMP(6)
ACC_COLUMNS = [("ID", "NUMBER(10)", True, True),
               ("EMAIL", "VARCHAR2(64)", False, False),
               ("NAME", "VARCHAR2(40)", False, False),
               ("SCORE", "BINARY_FLOAT", False, False),
               ("AMOUNT", "NUMBER(12,2)", False, False),
               ("BIG", "NUMBER(30)", False, False),
               ("CREATED", "DATE", False, False),
               ("UPDATED", "TIMESTAMP(6)", False, False)]
SPECIALS = (math.nan, math.inf, -math.inf, -0.0, None, 0.25)


def emp_rows() -> list:
    return [{"ID": i, "NAME": f"emp-{i:04d}" if i % 9 else None,
             "SALARY": i * 1.25, "RATIO": i / 3.0,
             "HIRED": dt.datetime(2020, 1 + i % 12, 1 + i % 28)}
            for i in range(EMP_ROWS)]


def acc_rows(n: int, seed: int = 5) -> list:
    rng = np.random.default_rng(seed)
    score = rng.uniform(-1.0, 1.0, n).astype(np.float32)
    amount = rng.integers(0, 10**9, n)
    secs = rng.integers(0, 10**9, n)
    micros = rng.integers(0, 10**6, n)
    rows = []
    for i in range(n):
        s = SPECIALS[i % 7] if i % 7 < len(SPECIALS) and i % 5 == 0 \
            else float(score[i])
        rows.append({
            "ID": i, "EMAIL": f"user{i}@example.test",
            "NAME": f"User {i}" if i % 11 else None, "SCORE": s,
            "AMOUNT": int(amount[i]) / 100,
            "BIG": 10**25 + 2 * i + 1,
            "CREATED": dt.datetime(1990, 1, 1)
            + dt.timedelta(seconds=int(secs[i])),
            "UPDATED": dt.datetime(2001, 1, 1)
            + dt.timedelta(seconds=int(secs[i]),
                           microseconds=int(micros[i]))})
    return rows


def start_fake(pkg: str, tables: dict):
    fake = PKGS[pkg]["fake"]
    srv = fake.FakeOracle(service_name="XEPDB1", user="scott",
                          password="tiger")
    for name, (cols, rows) in tables.items():
        srv.add_table(fake.FakeOraTable("SCOTT", name, cols, rows))
    return srv.start()


@pytest.fixture()
def fakes():
    """Each package's own fake, each holding EMP and ACCOUNTS."""
    tables = {"EMP": (EMP_COLUMNS, emp_rows()),
              "ACCOUNTS": (ACC_COLUMNS, acc_rows(600))}
    srvs = {pkg: start_fake(pkg, tables) for pkg in PKGS}
    yield srvs
    for s in srvs.values():
        s.stop()


def params(pkg: str, srv, **kw):
    return PKGS[pkg]["provider"].OracleSourceParams(
        host="127.0.0.1", port=srv.port, service_name="XEPDB1",
        user="scott", password="tiger", owner="SCOTT", **kw)


def canon(v):
    """A value in a form that compares exactly across the packages:
    floats by their bits (NaN and -0.0 included), numpy scalars as
    Python ones, enums by value."""
    if isinstance(v, np.generic):
        v = v.item()
    if isinstance(v, float):
        return ("f", struct.pack(">d", v))
    if isinstance(v, dict):
        return {k: canon(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return tuple(canon(x) for x in v)
    if type(v).__name__ == "Kind":
        return v.value
    if isinstance(v, Decimal):
        return ("d", str(v))
    return v


def batch_key(b) -> tuple:
    return (str(b.table_id),
            tuple((c.name, c.data_type.value, c.primary_key)
                  for c in b.schema.columns),
            canon(b.to_pydict()))


def item_key(it) -> tuple:
    return (str(it.table_id), canon(it.kind), canon(it.as_dict()),
            tuple(it.old_keys.key_names), canon(it.old_keys.key_values),
            it.lsn, it.txn_id, it.commit_time_ns)


def load(pkg: str, storage, td) -> list:
    out = []
    storage.load_table(td, out.append)
    return [batch_key(b) for b in out]


# -- codecs -------------------------------------------------------------------

def _seeded_numbers() -> list:
    rng = np.random.default_rng(11)
    out = []
    for _ in range(12):
        out.append(int(rng.integers(-(10**12), 10**12)))
        out.append(float(rng.normal() * 10.0 ** rng.integers(-20, 20)))
        out.append(Decimal(int(rng.integers(1, 10**9)))
                   / Decimal(10) ** int(rng.integers(0, 12)))
    return out


NUMBERS = [0, 1, -1, 99, 100, 123, -123, 65535, 10**12, -(10**12), 0.5,
           -0.5, 0.005, 123.456, -99.99, 2**40 + 1, 2**63 + 1, -(2**63),
           12345678901234567890123456789012345678,
           -12345678901234567890123456789012345678, 1e-130, -1e-130,
           9.99e125, -9.99e125, Decimal("0.000001"),
           Decimal("-123456789.123456789"), 10**25 + 7,
           *_seeded_numbers()]


@pytest.mark.parametrize("v", NUMBERS, ids=repr)
def test_number_codec_equals_jax(v):
    data = port_tns.encode_number(v)
    assert data == ref_tns.encode_number(v)
    got, want = port_tns.decode_number(data), ref_tns.decode_number(data)
    assert type(got) is type(want) and canon(got) == canon(want)
    assert float(got) == pytest.approx(float(v), rel=1e-12)


def test_known_number_encodings():
    for mod in (port_tns, ref_tns):
        assert mod.encode_number(0) == b"\x80"
        assert mod.encode_number(1) == b"\xc1\x02"
        assert mod.encode_number(123) == b"\xc2\x02\x18"
        assert mod.encode_number(-123) == b"\x3d\x64\x4e\x66"
    assert isinstance(port_tns.decode_number(port_tns.encode_number(42)),
                      int)
    assert isinstance(port_tns.decode_number(port_tns.encode_number(1.5)),
                      float)


TEMPORALS = [dt.datetime(2026, 7, 29, 13, 45, 59),
             dt.datetime(2003, 1, 1, 0, 0, 0), dt.datetime(1, 1, 1),
             dt.datetime(9999, 12, 31, 23, 59, 59, 999999),
             dt.datetime(2026, 2, 3, 4, 5, 6, 789012),
             dt.datetime(1970, 1, 1, 0, 0, 0, 1)]


@pytest.mark.parametrize("v", TEMPORALS, ids=str)
def test_temporal_codecs_equal_jax(v):
    d = port_tns.encode_date(v)
    assert d == ref_tns.encode_date(v)
    assert port_tns.decode_date(d) == ref_tns.decode_date(d) == \
        v.replace(microsecond=0)
    t = port_tns.encode_timestamp(v)
    assert t == ref_tns.encode_timestamp(v)
    assert port_tns.decode_timestamp(t) == ref_tns.decode_timestamp(t) == v
    assert port_tns.encode_date(v.date()) == ref_tns.encode_date(v.date())


VALUES = [(port_tns.ORA_BINARY_FLOAT, x) for x in
          (math.nan, math.inf, -math.inf, -0.0, 0.0, 0.1, -3.4e38, 1e-45)] + \
    [(port_tns.ORA_BINARY_DOUBLE, x) for x in
     (math.nan, math.inf, -math.inf, -0.0, 3.25, 1e308, 5e-324)] + \
    [(port_tns.ORA_VARCHAR2, None), (port_tns.ORA_VARCHAR2, "o'brien"),
     (port_tns.ORA_VARCHAR2, "x" * 10_000), (port_tns.ORA_VARCHAR2, "é€"),
     (port_tns.ORA_CHAR, "N"), (port_tns.ORA_RAW, b"\x00\x01\xfe"),
     (port_tns.ORA_BLOB, "text"), (port_tns.ORA_NUMBER, 2**63 + 1),
     (port_tns.ORA_NUMBER, None), (port_tns.ORA_DATE, "2026-07-29T10:00:00"),
     (port_tns.ORA_DATE, dt.date(2024, 2, 29)),
     (port_tns.ORA_TIMESTAMP, "2026-07-29 10:00:00.123456"),
     (port_tns.ORA_TIMESTAMP_TZ, dt.datetime(2020, 5, 6, 7, 8, 9, 10)),
     (port_tns.ORA_CLOB, 12345)]


@pytest.mark.parametrize("code,v", VALUES, ids=repr)
def test_value_codecs_equal_jax(code, v):
    data = port_tns.encode_value(code, v)
    assert data == ref_tns.encode_value(code, v)
    got, end = port_tns.decode_value(code, data, 0)
    want, ref_end = ref_tns.decode_value(code, data, 0)
    assert end == ref_end == len(data)
    assert canon(got) == canon(want)


def test_framing_equals_jax():
    for kw in ({"service_name": "ORCL"}, {"sid": "XE"}):
        desc = port_tns.connect_descriptor("db.example", 1521, **kw)
        assert desc == ref_tns.connect_descriptor("db.example", 1521, **kw)
        assert port_tns.parse_connect_data(desc) == \
            ref_tns.parse_connect_data(desc)
        payload = port_tns.build_connect(desc)
        assert payload == ref_tns.build_connect(desc)
        assert port_tns.parse_connect(payload) == desc
    for mod in (port_tns, ref_tns):
        with pytest.raises(mod.TNSError):
            mod.connect_descriptor("h", 1)
        with pytest.raises(mod.TNSError):
            mod.pack_packet(mod.PKT_DATA, b"x" * 0xFFFF)
    assert port_tns.build_accept() == ref_tns.build_accept()
    assert port_tns.parse_accept(port_tns.build_accept()) == 314
    refuse = port_tns.build_refuse("ORA-12514: no service")
    assert refuse == ref_tns.build_refuse("ORA-12514: no service")
    assert "12514" in port_tns.parse_refuse(refuse)
    for n in (0, 1, 255, 256, 2**40):
        assert port_tns.write_uint(n) == ref_tns.write_uint(n)
        assert port_tns.read_uint(port_tns.write_uint(n), 0)[0] == n
    for b in (None, b"", b"a" * 253, b"a" * 254, b"a" * 70_000):
        assert port_tns.write_bytes(b) == ref_tns.write_bytes(b)
        assert port_tns.read_bytes(port_tns.write_bytes(b), 0)[0] == b
    msg = port_tns.pack_packet(port_tns.PKT_DATA, b"\x00\x00hello")
    assert msg == ref_tns.pack_packet(ref_tns.PKT_DATA, b"\x00\x00hello")
    a, b = socket.socketpair()
    try:
        threading.Thread(target=a.sendall, args=(msg,)).start()
        assert port_tns.read_packet(b) == (port_tns.PKT_DATA,
                                           b"\x00\x00hello")
    finally:
        a.close()
        b.close()
    assert port_wire.auth_verifier(b"salt", "pw") == \
        ref_wire.auth_verifier(b"salt", "pw")


# -- the wire, across the fakes -----------------------------------------------

@pytest.mark.parametrize("client,server", [("port", "jax"), ("jax", "port"),
                                           ("port", "port")])
def test_client_against_either_fake(client, server, fakes):
    srv = fakes[server]
    wire = PKGS[client]["wire"]
    kw = dict(host="127.0.0.1", port=srv.port, service_name="XEPDB1",
              user="scott")
    conn = wire.OracleConnection(password="tiger", prefetch=64,
                                 **kw).connect()
    try:
        assert conn.scalar("SELECT 1 FROM dual") == 1
        assert conn.scalar("SELECT current_scn FROM v$database") == \
            srv.current_scn
        cols, rows = conn.execute(
            'SELECT "ID", "SCORE", "BIG", "UPDATED" FROM "SCOTT"."ACCOUNTS"')
        assert [c.name for c in cols] == ["ID", "SCORE", "BIG", "UPDATED"]
        assert len(rows) == 600   # 10 fetch rounds of the fake's 100 rows
        ref_rows = acc_rows(600)
        assert rows[7][2] == 10**25 + 15
        assert rows[7][3] == ref_rows[7]["UPDATED"]
        with pytest.raises(wire.OracleError, match="00900"):
            conn.execute("SELECT nonsense")
    finally:
        conn.close()
    with pytest.raises(wire.OracleError, match="01017") as ei:
        wire.OracleConnection(password="wrong", **kw).connect()
    assert ei.value.code == 1017
    with pytest.raises(wire.OracleError, match="12514"):
        wire.OracleConnection(host="127.0.0.1", port=srv.port,
                              service_name="NOPE", user="scott",
                              password="tiger").connect()


# -- the snapshot -------------------------------------------------------------

def test_schema_discovery_equals_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        st = PKGS[pkg]["provider"].OracleStorage(params(pkg, srv))
        try:
            tables = st.table_list()
            got[pkg] = (
                sorted((str(t), i.eta_rows) for t, i in tables.items()),
                [st.table_schema(PKGS[pkg]["tid"]("SCOTT", n)).to_json()
                 for n in ("EMP", "ACCOUNTS")],
                st.exact_table_rows_count(PKGS[pkg]["tid"]("SCOTT", "EMP")),
                st.table_size_in_bytes(PKGS[pkg]["tid"]("SCOTT", "EMP")))
        finally:
            st.close()
    assert got["port"] == got["jax"]
    st = port_provider.OracleStorage(params("port", fakes["port"]))
    by_name = {c.name: c.data_type.value for c in
               st.table_schema(TableID("SCOTT", "ACCOUNTS"))}
    st.close()
    assert by_name == {"ID": "int64", "EMAIL": "utf8", "NAME": "utf8",
                       "SCORE": "float", "AMOUNT": "double",
                       "BIG": "decimal", "CREATED": "datetime",
                       "UPDATED": "timestamp"}
    st = port_provider.OracleStorage(params(
        "port", fakes["port"], convert_number_to_int64=False,
        include_tables=["emp"]))
    assert list(st.table_list()) == [TableID("SCOTT", "EMP")]
    assert st.table_schema(TableID("SCOTT", "EMP")).find("ID") \
        .data_type.value == "decimal"
    st.close()


@pytest.mark.parametrize("table,batch_rows", [("EMP", 64), ("ACCOUNTS", 97),
                                              ("ACCOUNTS", 65_536)])
def test_keyset_paging_equals_jax(fakes, table, batch_rows):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        st = p["provider"].OracleStorage(params(pkg, srv,
                                                batch_rows=batch_rows))
        before = len(srv.queries)
        got[pkg] = (load(pkg, st, p["td"](id=p["tid"]("SCOTT", table))),
                    srv.queries[before:])
        st.close()
    assert got["port"] == got["jax"]
    rows = sum(len(b[2]["ID"]) for b in got["port"][0])
    assert rows == (EMP_ROWS if table == "EMP" else 600)
    if table == "EMP":
        first = got["port"][0][0][2]
        assert first["NAME"][9] is None and first["NAME"][17] == "emp-0017"


def test_scn_pinned_snapshot_equals_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        td = p["td"](id=p["tid"]("SCOTT", "EMP"))
        st = p["provider"].OracleStorage(params(pkg, srv))
        pos = st.position()
        assert pos == {"scn": srv.current_scn}

        def delete_half(rows):
            del rows[0:100]

        scn = srv.mutate("SCOTT", "EMP", delete_half)
        pinned = load(pkg, st, td)
        st.close()
        loose = p["provider"].OracleStorage(params(
            pkg, srv, consistent_snapshot=False))
        unpinned = load(pkg, loose, td)
        loose.close()
        got[pkg] = (pos, scn, pinned, unpinned)
    assert got["port"] == got["jax"]
    _, _, pinned, unpinned = got["port"]
    assert sum(len(b[2]["ID"]) for b in pinned) == EMP_ROWS
    assert sum(len(b[2]["ID"]) for b in unpinned) == EMP_ROWS - 100


@pytest.mark.parametrize("shards,batch_rows", [(3, 16), (4, 65_536),
                                               (1, 50)])
def test_rowid_shards_equal_jax(fakes, shards, batch_rows):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        st = p["provider"].OracleStorage(params(
            pkg, srv, desired_shards=shards, batch_rows=batch_rows))
        parts = st.shard_table(p["td"](id=p["tid"]("SCOTT", "ACCOUNTS"),
                                       eta_rows=600))
        got[pkg] = [(part.filter, part.eta_rows, load(pkg, st, part))
                    for part in parts]
        st.close()
    assert got["port"] == got["jax"]
    ids = sorted(i for _, _, bs in got["port"] for b in bs
                 for i in b[2]["ID"])
    assert ids == list(range(600))
    assert len(got["port"]) == shards


def test_wide_number_keeps_precision(fakes):
    """NUMBER beyond int64 decodes exactly up to 28 digits; past them
    both packages' decoders round to Decimal's default 28-digit context
    (a 30-digit NUMBER(30) loses its low digits: ROADMAP.md C, notes)."""
    for v in (2**63 + 1, 10**25 + 7, -(10**27) - 7):
        assert port_tns.decode_number(port_tns.encode_number(v)) == v
    wide = port_tns.encode_number(10**29 + 7)
    assert wide == ref_tns.encode_number(10**29 + 7)
    assert port_tns.decode_number(wide) == ref_tns.decode_number(wide) \
        == Decimal(10**29)
    st = port_provider.OracleStorage(params("port", fakes["port"]))
    batches = []
    st.load_table(TableDescription(id=TableID("SCOTT", "ACCOUNTS")),
                  batches.append)
    st.close()
    big = [v for b in batches for v in b.to_pydict()["BIG"]]
    assert big == [str(10**25 + 2 * i + 1) for i in range(600)]


def test_sampling_and_checksum_equal_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        tid = p["tid"]("SCOTT", "ACCOUNTS")
        td = p["td"](id=tid)
        st = p["provider"].OracleStorage(params(pkg, srv))
        st.TOP_BOTTOM_LIMIT, st.RANDOM_SAMPLE_LIMIT = 40, 30
        samples = []
        for call in (lambda push: st.load_random_sample(td, push),
                     lambda push: st.load_top_bottom_sample(td, push),
                     lambda push: st.load_sample_by_set(
                         td, [{"ID": i} for i in range(0, 600, 3)], push)):
            out = []
            call(out.append)
            samples.append([batch_key(b) for b in out])
        dst = p["provider"].OracleStorage(params(pkg, srv))
        dst.TOP_BOTTOM_LIMIT, dst.RANDOM_SAMPLE_LIMIT = 40, 30
        report = p["compare"](st, dst, params=p["ck_params"](
            table_size_threshold=1000), **p["kw"])
        got[pkg] = (samples, report.ok, report.summary(),
                    [(t.strategy, t.source_rows, t.target_rows)
                     for t in report.tables])
        st.close()
        dst.close()
    assert got["port"] == got["jax"]
    samples, ok, _, tables = got["port"]
    assert ok and tables[0][0] == "sample"
    assert sum(len(b[2]["ID"]) for b in samples[2]) == 200


def test_snapshot_activation_equals_jax(fakes):
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        store = p["memory"].get_store(f"ora-act-{pkg}")
        store.clear()
        t = p["transfer"](id=f"ora-act-{pkg}", src=params(pkg, srv),
                          dst=p["memory"].MemoryTargetParams(
                              sink_id=f"ora-act-{pkg}"))
        cp = p["coordinator"]()
        p["activate"](t, cp, **p["kw"])
        got[pkg] = (sorted((canon(r.as_dict()) for r in store.rows()),
                           key=repr),
                    cp.get_transfer_state(t.id)["snapshot_position"])
        store.clear()
    assert got["port"] == got["jax"]
    assert len(got["port"][0]) == EMP_ROWS + 600


# -- the redo parser ----------------------------------------------------------

REDO = [
    'insert into "SCOTT"."EMP"("ID","NAME") values (7, \'o\'\'brien\')',
    'update "SCOTT"."EMP" set "NAME" = NULL, "SAL" = 10.5 '
    'where "ID" = 7 and "NAME" = \'old\'',
    'delete from "SCOTT"."EMP" where "ID" = 3 and "NAME" IS NULL',
    'insert into "S"."T"("D") values '
    "(TO_TIMESTAMP('2026-07-29 10:00:00'))",
    'alter table "S"."T" add "C" int',
    'insert into "S"."T"("A","B") values (1)',
    'insert into S.T(A, B) values (1, \'two\');',
    'update "S"."T" set "A" = TO_DATE(\'29-JUL-26\', \'DD-MON-RR\') '
    'where "ID" = 1',
    'delete from "S"."T"',
    'delete from "S"."T" where "A" = \'unterminated',
    'insert into "S"."T"("A") values (\'a,b) (c\')',
    'update "S"."T" set "A" = \'x\' where "ID" = 1 or "ID" = 2',
    "",
    'insert into "S"."T$#_1"("C$","D#") values (-1.5e3, \'\')',
]


def _redo_literal(rng, kind: int) -> str:
    if kind == 0:
        return str(int(rng.integers(-(10**9), 10**9)))
    if kind == 1:
        s = "".join(rng.choice(list("ab' ,()é"), int(rng.integers(0, 9))))
        return "'" + s.replace("'", "''") + "'"
    if kind == 2:
        return "NULL"
    if kind == 3:
        return (f"TO_DATE('{int(rng.integers(1, 28)):02d}-JAN-"
                f"{int(rng.integers(0, 99)):02d}', 'DD-MON-RR')")
    return (f"TO_TIMESTAMP('2026-07-{int(rng.integers(1, 29)):02d} "
            f"10:11:12.{int(rng.integers(0, 10**6)):06d}', "
            "'YYYY-MM-DD HH24:MI:SS.FF6')")


def seeded_redo(n: int, seed: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        cols = [f'"C{j}"' for j in range(int(rng.integers(1, 6)))]
        vals = [_redo_literal(rng, int(rng.integers(0, 5))) for _ in cols]
        verb = int(rng.integers(0, 3))
        if verb == 0:
            out.append(f'insert into "OWN"."TAB"({",".join(cols)}) '
                       f'values ({", ".join(vals)})')
        elif verb == 1:
            sets = ", ".join(f"{c} = {v}" for c, v in zip(cols, vals))
            out.append(f'update "OWN"."TAB" set {sets} where "ID" = '
                       f'{int(rng.integers(0, 99))} and "N" IS NULL')
        else:
            conds = " and ".join(f"{c} = {v}" if v != "NULL" else
                                 f"{c} IS NULL" for c, v in zip(cols, vals))
            out.append(f'delete from "OWN"."TAB" where {conds}')
    return out


def parse_result(mod, sql: str):
    try:
        s = mod.parse_redo_sql(sql)
    except Exception as e:   # the error's type and text are compared
        return ("error", type(e).__name__, str(e))
    return (s.op.value, s.owner, s.table, s.new_values, s.conditions,
            str(s.table_id()))


@pytest.mark.parametrize("sql", REDO + seeded_redo(40, 3), ids=repr)
def test_redo_parser_equals_jax(sql):
    assert parse_result(port_lm, sql) == parse_result(ref_lm, sql)


def test_redo_parser_cases_of_the_jax_tests():
    s = port_lm.parse_redo_sql(REDO[0])
    assert s.op == Kind.INSERT and (s.owner, s.table) == ("SCOTT", "EMP")
    assert s.new_values == {"ID": "7", "NAME": "o'brien"}
    s = port_lm.parse_redo_sql(REDO[1])
    assert s.new_values == {"NAME": None, "SAL": "10.5"}
    assert s.conditions == {"ID": "7", "NAME": "old"}
    s = port_lm.parse_redo_sql(REDO[2])
    assert s.op == Kind.DELETE and s.conditions == {"ID": "3", "NAME": None}
    assert port_lm.parse_redo_sql(REDO[3]).new_values["D"].startswith(
        "TO_TIMESTAMP(")
    with pytest.raises(port_lm.RedoParseError):
        port_lm.parse_redo_sql(REDO[4])


CASTS = [("int64", "7"), ("int64", "x7"), ("int32", "-12"),
         ("double", "10.5"), ("double", "Nan"), ("float", "-Inf"),
         ("float", "-0.0"), ("float", "abc"), ("boolean", "0"),
         ("boolean", "T"), ("utf8", "o'brien"), ("string", "raw"),
         ("decimal", "10000000000000000000000007"),
         ("datetime", "2026-07-29 10:00:00"), ("datetime", "garbage"),
         ("timestamp", "2026-07-29 10:00:00.123456"),
         ("datetime", "TO_DATE('29-JUL-26', 'DD-MON-RR')"),
         ("datetime", "TO_DATE('29-jul-1999 11:05:09 PM', "
                      "'DD-MON-YYYY HH:MI:SS AM')"),
         ("timestamp", "TO_TIMESTAMP('2026-07-29 10:11:12.000123', "
                       "'YYYY-MM-DD HH24:MI:SS.FF6')"),
         ("timestamp", "TO_TIMESTAMP('2026-07-29 10:00:00')"),
         ("datetime", "TO_DATE('bad', 'YYYY-MM-DD')"),
         ("utf8", "TO_DATE('2020-01-02', 'YYYY-MM-DD')"),
         ("int64", None)]


@pytest.mark.parametrize("ctype,raw", CASTS, ids=repr)
def test_cast_redo_value_equals_jax(ctype, raw):
    from transferia_tpu.abstract.schema import CanonicalType as RefCT
    from transferia_tpu.abstract.schema import ColSchema as RefCol
    from transferia_tpu_torch.abstract.schema import CanonicalType, ColSchema

    got = port_lm.cast_redo_value(ColSchema("c", CanonicalType(ctype)), raw)
    want = ref_lm.cast_redo_value(RefCol("c", RefCT(ctype)), raw)
    assert canon(got) == canon(want)


# -- LogMiner -----------------------------------------------------------------

def run_source(source, sink, until, timeout: float = SETTLE_S) -> None:
    """The source on a thread until `until()` holds (polled against a
    deadline), then stopped."""
    th = threading.Thread(target=source.run, args=(sink,), daemon=True)
    th.start()
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and not until():
        time.sleep(0.02)
    source.stop()
    th.join(timeout=10)
    assert not th.is_alive(), "the LogMiner source did not stop"
    assert until(), "replication did not deliver in time"


def cdc_fake(pkg: str):
    return start_fake(pkg, {"EMP": ([("ID", "NUMBER(10)", True, True),
                                     ("NAME", "VARCHAR2(100)", False, False),
                                     ("SAL", "NUMBER(8,2)", False, False)],
                                    [])})


def memory_sink(pkg: str, sink_id: str):
    p = PKGS[pkg]
    store = p["memory"].get_store(sink_id)
    store.clear()
    sinker = p["memory"].MemorySinker(p["memory"].MemoryTargetParams(
        sink_id=sink_id), **p["kw"])
    return store, p["sync"](sinker)


def source(pkg: str, srv, tid: str, cp, **kw):
    return PKGS[pkg]["lm"].OracleLogMinerSource(
        params(pkg, srv), tid, cp, poll_interval=0.02, **kw)


E2E_REDO = [
    (1, 'insert into "SCOTT"."EMP"("ID","NAME","SAL") '
        "values (1, 'ada', 100.5)"),
    (1, 'insert into "SCOTT"."EMP"("ID","NAME","SAL") '
        "values (2, 'bob', 200)"),
    (3, 'update "SCOTT"."EMP" set "SAL" = 300 where "ID" = 2'),
    (2, 'delete from "SCOTT"."EMP" where "ID" = 1'),
    (3, 'update "SCOTT"."EMP" set "ID" = 5, "NAME" = NULL where "ID" = 2 '
        "and \"NAME\" = 'bob' and \"SAL\" = 300"),
    (1, 'insert into "SCOTT"."NOPE"("ID") values (1)'),
    (1, 'garbage redo'),
    (1, 'insert into "SCOTT"."EMP"("ID","SAL","EXTRA") values (9, 1, 2)'),
]


def test_logminer_replication_equals_jax():
    got = {}
    for pkg in PKGS:
        srv = cdc_fake(pkg)
        try:
            for op, sql in E2E_REDO:
                srv.feed_redo("SCOTT", "EMP" if "NOPE" not in sql
                              else "NOPE", op, sql)
            cp = PKGS[pkg]["coordinator"]()
            cp.set_transfer_state("ora-cdc", {"oracle_scn": 1000})
            store, sink = memory_sink(pkg, f"ora-cdc-{pkg}")
            src = source(pkg, srv, "ora-cdc", cp, batch_rows=2)
            run_source(src, sink, lambda: cp.get_transfer_state(
                "ora-cdc").get("oracle_scn") == srv.current_scn)
            got[pkg] = ([item_key(r) for r in store.rows()],
                        cp.get_transfer_state("ora-cdc"))
            store.clear()
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    items, state = got["port"]
    assert [i[1] for i in items] == ["insert", "insert", "update", "delete",
                                     "update", "insert"]
    assert items[0][2] == canon({"ID": 1, "NAME": "ada", "SAL": 100.5})
    assert items[4][3:5] == (("ID",), (2,)) and items[4][2]["ID"] == 5
    assert state["oracle_scn"] == 1008 and state["oracle_scn_rows"] == \
        [[1008, "0x000007", 0]]


def test_logminer_resume_at_a_boundary_scn_equals_jax():
    """Rows sharing an SCN: the first incarnation delivers two and
    checkpoints them; a third row at that SCN, visible only later, is
    mined by the restarted source (SCN >=) and the two are not
    replayed."""
    got = {}
    for pkg in PKGS:
        srv = cdc_fake(pkg)
        try:
            cp = PKGS[pkg]["coordinator"]()
            cp.set_transfer_state("ora-b", {"oracle_scn": 1000})
            scn = srv.feed_redo(
                "SCOTT", "EMP", 1,
                'insert into "SCOTT"."EMP"("ID","NAME","SAL") '
                "values (10, 'old', 1)")
            row = dict(srv.redo[-1], rs_id="0x0000aa", ssn=1,
                       sql=srv.redo[-1]["sql"].replace("10, 'old'",
                                                       "11, 'twin'"))
            with srv.lock:
                srv.redo.append(row)
            store, sink = memory_sink(pkg, f"ora-b-{pkg}")
            run_source(source(pkg, srv, "ora-b", cp), sink,
                       lambda: len(store.rows()) >= 2)
            first = cp.get_transfer_state("ora-b")
            with srv.lock:
                srv.redo.append(dict(row, rs_id="0x0000ab", ssn=2,
                                     sql=row["sql"].replace("11, 'twin'",
                                                            "12, 'late'")))
            srv.feed_redo("SCOTT", "EMP", 1,
                          'insert into "SCOTT"."EMP"("ID","NAME","SAL") '
                          "values (13, 'new', 2)")
            # the restarted source's first cycle mines the two delivered
            # rows with the two new ones: a replay would land in the same
            # push as the new rows
            run_source(source(pkg, srv, "ora-b", cp), sink,
                       lambda: len(store.rows()) >= 4)
            got[pkg] = ([item_key(r) for r in store.rows()], first,
                        cp.get_transfer_state("ora-b"), scn)
            store.clear()
        finally:
            srv.stop()
    assert got["port"] == got["jax"]
    items, first, last, scn = got["port"]
    assert [i[2]["ID"] for i in items] == [10, 11, 12, 13]
    assert first == {"oracle_scn": scn, "oracle_scn_rows": [
        [scn, "0x000000", 0], [scn, "0x0000aa", 1]]}
    assert last["oracle_scn"] == scn + 1


def test_logminer_csf_continuation_equals_jax():
    got = {}
    long_name = "x" * 120
    for pkg in PKGS:
        srv = cdc_fake(pkg)
        try:
            cp = PKGS[pkg]["coordinator"]()
            cp.set_transfer_state("ora-csf", {"oracle_scn": 1000})
            for i, parts in enumerate((4, 1, 7, 2)):
                srv.feed_redo(
                    "SCOTT", "EMP", 1,
                    f'insert into "SCOTT"."EMP"("ID","NAME","SAL") '
                    f"values ({40 + i}, '{long_name}', 7)", csf_parts=parts)
            store, sink = memory_sink(pkg, f"ora-csf-{pkg}")
            run_source(source(pkg, srv, "ora-csf", cp), sink,
                       lambda: len(store.rows()) >= 4)
            got[pkg] = ([item_key(r) for r in store.rows()],
                        cp.get_transfer_state("ora-csf"))
            store.clear()
        finally:
            srv.stop()
    assert got["port"][0] == got["jax"][0]
    assert [i[2]["ID"] for i in got["port"][0]] == [40, 41, 42, 43]
    assert all(i[2]["NAME"] == long_name for i in got["port"][0])
    # the checkpoint SCN is the reference's; its boundary rows are every
    # continuation row of the last statement, where the reference keeps
    # one (ROADMAP.md C9)
    state = got["port"][1]
    assert state["oracle_scn"] == got["jax"][1]["oracle_scn"] == 1004
    assert state["oracle_scn_rows"] == [[1004, "0x00000e", k]
                                        for k in range(3)]


def mining_cycles(srv) -> int:
    return sum("v$logmnr_contents" in q.lower() for q in list(srv.queries))


def idle_run(pkg: str, srv, tid: str, cp, sink, until, idle: int = 6):
    """The source until `until()` holds, then `idle` more mining cycles
    (counted on the fake's log, not timed)."""
    state = {}

    def settled():
        if not until():
            return False
        state.setdefault("at", mining_cycles(srv))
        return mining_cycles(srv) >= state["at"] + idle

    run_source(source(pkg, srv, tid, cp), sink, settled)


def test_csf_boundary_rows_are_not_replayed_where_jax_replays_them():
    """ROADMAP.md C9.  An UPDATE continued over three CSF rows whose middle
    row lies inside a quoted value: once delivered and checkpointed, the
    reference's idle re-mines at its SCN drop only the first row, glue the
    others into statements, and deliver the one that parses (the update
    with the middle of its value cut out) again and again.  The port
    remembers every row and delivers the statement once."""
    value = "A" * 40 + "B" * 40 + "C" * 40
    sql = (f'update "SCOTT"."EMP" set "NAME" = \'{value}\' where "ID" = 2')
    got = {}
    for pkg in PKGS:
        srv = cdc_fake(pkg)
        try:
            srv.feed_redo("SCOTT", "EMP", 1, 'insert into "SCOTT"."EMP"'
                          '("ID","NAME","SAL") values (2, \'b\', 1)')
            srv.feed_redo("SCOTT", "EMP", 3, sql, csf_parts=3)
            cp = PKGS[pkg]["coordinator"]()
            cp.set_transfer_state("ora-c9", {"oracle_scn": 1000})
            store, sink = memory_sink(pkg, f"ora-c9-{pkg}")
            idle_run(pkg, srv, "ora-c9", cp, sink,
                     lambda: len(store.rows()) >= 2)
            got[pkg] = [r.as_dict()["NAME"] for r in store.rows()]
            store.clear()
        finally:
            srv.stop()
    assert got["port"] == ["b", value]
    assert got["jax"][:2] == ["b", value] and len(got["jax"]) > 2
    (cut,) = set(got["jax"][2:])   # the middle row's text cut out
    assert len(cut) < len(value) and cut.startswith("A") and \
        cut.endswith("C" * 40)


def test_late_boundary_rows_do_not_replay_earlier_ones_where_jax_does():
    """ROADMAP.md C9.  A row that becomes visible at the checkpoint SCN after
    it was checkpointed is delivered, and the boundary set then holds both
    rows; the reference keeps only the late one, so its next re-mine
    delivers the first row again."""
    got = {}
    for pkg in PKGS:
        srv = cdc_fake(pkg)
        try:
            scn = srv.feed_redo("SCOTT", "EMP", 1, 'insert into "SCOTT"."EMP"'
                                '("ID","NAME","SAL") values (1, \'a\', 1)')
            cp = PKGS[pkg]["coordinator"]()
            cp.set_transfer_state("ora-late", {"oracle_scn": 1000})
            store, sink = memory_sink(pkg, f"ora-late-{pkg}")
            src = source(pkg, srv, "ora-late", cp)
            th = threading.Thread(target=src.run, args=(sink,), daemon=True)
            th.start()
            deadline = time.monotonic() + SETTLE_S
            while len(store.rows()) < 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            with srv.lock:
                srv.redo.append(dict(srv.redo[-1], rs_id="0x0000ff",
                                     sql=srv.redo[-1]["sql"].replace(
                                         "(1, 'a'", "(2, 'late'")))
            at = mining_cycles(srv)
            while (len(store.rows()) < 2 or mining_cycles(srv) < at + 6) \
                    and time.monotonic() < deadline:
                time.sleep(0.02)
            src.stop()
            th.join(10)
            assert not th.is_alive()
            got[pkg] = ([r.as_dict()["ID"] for r in store.rows()],
                        cp.get_transfer_state("ora-late"), scn)
            store.clear()
        finally:
            srv.stop()
    ids, state, scn = got["port"]
    assert ids == [1, 2]
    assert state["oracle_scn_rows"] == [[scn, "0x000000", 0],
                                        [scn, "0x0000ff", 0]]
    assert got["jax"][0][:2] == [1, 2] and 1 in got["jax"][0][2:]


# -- the S&I handoff ----------------------------------------------------------

def test_start_scn_order_equals_jax(fakes):
    """Checkpoint first, then the snapshot's SCN, then current_scn; the
    snapshot loader's route records the snapshot's SCN in both
    packages."""
    got = {}
    for pkg, srv in fakes.items():
        p = PKGS[pkg]
        cp = p["coordinator"]()
        t = p["transfer"](id="ora-h", src=params(pkg, srv),
                          dst=p["memory"].MemoryTargetParams(
                              sink_id=f"ora-h-{pkg}"))
        p["loader"](t, cp, **p["kw"]).upload_tables()
        pinned = cp.get_transfer_state("ora-h")["snapshot_position"]
        srv.mutate("SCOTT", "EMP", lambda rows: rows.pop())
        conn = p["provider"]._conn(params(pkg, srv))
        try:
            order = [source(pkg, srv, "ora-h", cp)._start_scn(conn)]
            cp.set_transfer_state("ora-h", {"oracle_scn": 4242,
                                            "oracle_scn_rows": [[4242, "r",
                                                                 0]]})
            src = source(pkg, srv, "ora-h", cp)
            order.append(src._start_scn(conn))
            order.append(sorted(src._delivered_at_boundary))
            order.append(source(pkg, srv, "ora-none", cp)._start_scn(conn))
        finally:
            conn.close()
        p["memory"].get_store(f"ora-h-{pkg}").clear()
        got[pkg] = (pinned, order, srv.current_scn)
    assert got["port"] == got["jax"]
    pinned, order, current = got["port"]
    assert order == [pinned["scn"], 4242, [(4242, "r", 0)], current]


def sai_run(pkg: str) -> tuple:
    """SNAPSHOT_AND_INCREMENT through activate_delivery (the MVCC route
    on the memory coordinator) while a writer commits one change after
    the first page of the load and another transaction commits after it;
    then the LogMiner tail, until a sentinel insert fed after the
    activation arrives."""
    p = PKGS[pkg]
    srv = start_fake(pkg, {"EMP": (EMP_COLUMNS, emp_rows())})
    session = p["fake"]._Session
    orig = session.execute_data_select
    fired = []

    def during_load(self, *a):
        orig(self, *a)
        if not fired:
            fired.append(True)
            with srv.lock:
                srv.mutate("SCOTT", "EMP", lambda rows: rows.__setitem__(
                    3, dict(rows[3], NAME="changed")))
                srv.feed_redo("SCOTT", "EMP", 3,
                              'update "SCOTT"."EMP" set "NAME" = '
                              "'changed' where \"ID\" = 3")
                srv.mutate("SCOTT", "EMP", lambda rows: None)

    session.execute_data_select = during_load
    sink_id = f"ora-sai-{pkg}"
    store = p["memory"].get_store(sink_id)
    store.clear()
    try:
        t = p["transfer"](id="ora-sai",
                          type=p["ttype"].SNAPSHOT_AND_INCREMENT,
                          src=params(pkg, srv, batch_rows=64),
                          dst=p["memory"].MemoryTargetParams(
                              sink_id=sink_id))
        cp = p["coordinator"]()
        p["activate"](t, cp, **p["kw"])
        session.execute_data_select = orig
        tail, sink = memory_sink(pkg, sink_id + "-tail")
        srv.feed_redo("SCOTT", "EMP", 1,
                      'insert into "SCOTT"."EMP"("ID","NAME") '
                      "values (1000, 'sentinel')")
        run_source(source(pkg, srv, "ora-sai", cp), sink,
                   lambda: any(r.as_dict()["ID"] == 1000
                               for r in tail.rows()))
        names = {r.as_dict()["ID"]: r.as_dict()["NAME"]
                 for r in store.rows()}
        for r in tail.rows():
            names[r.as_dict()["ID"]] = r.as_dict()["NAME"]
        delivered = len(tail.rows())
        tail.clear()
        return (names[3], cp.get_transfer_state("ora-sai").get(
            "snapshot_position"), delivered, len(store.rows()))
    finally:
        session.execute_data_select = orig
        store.clear()
        srv.stop()


def test_sai_mvcc_route_pins_the_scn_where_jax_does_not():
    """ROADMAP.md C8: the reference's MVCC route reads Oracle unpinned and
    records no position, so its tail starts at the current SCN and the
    change committed after the first page (row 3 is on it) is lost; the
    port pins the read, records the SCN and its tail delivers it."""
    assert sai_run("jax") == ("emp-0003", None, 1, EMP_ROWS)
    assert sai_run("port") == ("changed", {"scn": 1000}, 2, EMP_ROWS)


# -- the slice through the chain ---------------------------------------------

CHAIN = {"transformers": [
    {"mask_field": {"columns": ["EMAIL"], "salt": "ora-salt"}},
    {"filter_rows": {"filter": "SCORE > 0.25"}}]}


@pytest.mark.parametrize("placement", ["device", "host"])
def test_chain_mask_and_score_filter_equal_jax(placement):
    got = {}
    rows = acc_rows(3000, seed=9)
    for pkg in PKGS:
        p = PKGS[pkg]
        srv = start_fake(pkg, {"ACCOUNTS": (ACC_COLUMNS, rows)})
        sink_id = f"ora-chain-{pkg}"
        store = p["memory"].get_store(sink_id)
        store.clear()
        p["fused"].set_placement(placement)
        try:
            t = p["transfer"](id="ora-chain", src=params(
                pkg, srv, batch_rows=1000, desired_shards=3),
                dst=p["memory"].MemoryTargetParams(sink_id=sink_id),
                transformation=CHAIN)
            p["activate"](t, p["coordinator"](), **p["kw"])
            got[pkg] = sorted((canon(r.as_dict()) for r in store.rows()),
                              key=lambda d: d["ID"])
        finally:
            p["fused"].set_placement(None)
            store.clear()
            srv.stop()
    assert got["port"] == got["jax"]
    want = [r["ID"] for r in rows if r["SCORE"] is not None
            and np.float32(r["SCORE"]) > np.float32(0.25)]
    assert [d["ID"] for d in got["port"]] == want
    assert all(len(d["EMAIL"]) == 64 for d in got["port"])


def test_checksum_against_clickhouse_equals_jax(tmp_path):
    """`checksum` of an Oracle table against its unmasked copy in
    ClickHouse, both packages' CLIs over the same tables (the port's fake
    Oracle and fake ClickHouse): sampled, full and fingerprinted, clean
    and with one value altered, equal verdicts.  The JAX tests' fake
    ClickHouse lowercases a name in `SELECT count()`, so against it the
    upper-case `SCOTT__ACCOUNTS` counts 0 rows in either package
    (ROADMAP.md C, notes)."""
    import io
    from contextlib import redirect_stdout

    from tests.recipes import fake_clickhouse as ref_fake_ch
    from transferia_tpu.cli import main as ref_main
    from transferia_tpu_torch.cli import main as port_main
    from transferia_tpu_torch.recipes import fake_clickhouse as port_fake_ch

    def verdicts(ch, srv) -> list:
        path = tmp_path / f"ck-{ch.port}.yaml"
        path.write_text(
            "id: ck\ntype: SNAPSHOT_ONLY\nsrc:\n  type: oracle\n  params: "
            f"{{host: 127.0.0.1, port: {srv.port}, user: scott, password: "
            "tiger, owner: SCOTT, service_name: XEPDB1}\ndst:\n  type: ch\n"
            f"  params: {{host: 127.0.0.1, port: {ch.port}, bufferer: "
            "null}\n")
        if not ch.tables:
            assert port_main.main(["--device", "cpu", "--log-level",
                                   "error", "activate", "--transfer",
                                   str(path)]) == 0
        out = []
        for argv in (["--size-threshold", "0"], [],
                     ["--method", "fingerprint",
                      "--fingerprint-backend", "host"]):
            got = []
            for main, pre in ((port_main, ["--device", "cpu"]),
                              (ref_main, [])):
                buf = io.StringIO()
                with redirect_stdout(buf):
                    rc = main.main(pre + ["--log-level", "error",
                                          "checksum", "--transfer",
                                          str(path)] + argv)
                got.append((rc, buf.getvalue()))
            out.append(got)
        return out

    srv = start_fake("port", {"ACCOUNTS": (ACC_COLUMNS, acc_rows(600))})
    ch = port_fake_ch.FakeCH().start()
    try:
        clean = verdicts(ch, srv)
        row = next(r for r in ch.rows("SCOTT__ACCOUNTS") if r["ID"] == 300)
        row["EMAIL"] = b"altered"
        altered = verdicts(ch, srv)
    finally:
        ch.stop()
    for port, jax in clean + altered:
        assert port == jax
    assert [v[0][0] for v in clean] == [0, 0, 0]
    assert "OK [sample]" in clean[0][0][1] and "OK [full]" in clean[1][0][1]
    assert [v[0][0] for v in altered] == [1, 1, 1]
    ref_ch = ref_fake_ch.FakeCH().start()
    try:
        (port, jax), = verdicts(ref_ch, srv)[:1]
        assert port == jax and port[0] == 1
        assert "row counts differ: src=600 dst=0" in port[1]
    finally:
        ref_ch.stop()
        srv.stop()
