"""The rename transformers and BASELINE config #1's chain (kafka2ch:
`rename_tables` then `mask_field`) against the JAX package's, on the CPU.

Both packages plan the same steps (the mask after the rename still fuses
into a device step), report the same output table and schema
(`Transformation.output_schema`) and give byte-identical batches.
"""

import numpy as np
import pytest

from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.columnar.batch import (
    Column,
    ColumnBatch,
    DictEnc,
    DictPool,
    flat_materializations,
    reset_flat_materializations,
)
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform import fused as port_tfused
from transferia_tpu_torch.transform.plugins.rename import (
    RenameColumns,
    RenameTables,
)

# examples/kafka2ch.yaml:9-15 and :25-27 (a fixed salt for MASK_SALT)
KAFKA2CH_COLS = [("id", "int64", True), ("user_email", "utf8"),
                 ("amount", "double"), ("ts", "timestamp")]
KAFKA2CH = {"transformers": [
    {"rename_tables": {"tables": [{"from": ".events",
                                   "to": ".events_clean"}]}},
    {"mask_field": {"columns": ["user_email"], "salt": "kafka2ch-salt"}},
]}


def kafka2ch_data(n, seed=7, nulls=False):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 2**62, n).tolist()
    emails = [f"user{i}@example.test" for i in ids]
    if nulls:
        for i in range(0, n, 4):
            emails[i] = None
    return {"id": ids, "user_email": emails,
            "amount": rng.random(n).round(6).tolist(),
            "ts": (1_700_000_000_000_000
                   + rng.integers(0, 86_400_000_000, n)).tolist()}


def batches(cols, data, table=("", "events")):
    port = ColumnBatch.from_pydict(TableID(*table), new_table_schema(cols),
                                   data)
    ref = RefBatch.from_pydict(RefTableID(*table), ref_schema(cols), data)
    return port, ref


def schema_rows(schema):
    return [(c.name, c.data_type.value, c.primary_key) for c in schema]


def column_bytes(col):
    return (col.ctype.value, np.asarray(col.data).tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def assert_same(out, ref_out):
    assert (out.table_id.namespace, out.table_id.name) == \
        (ref_out.table_id.namespace, ref_out.table_id.name)
    assert schema_rows(out.schema) == schema_rows(ref_out.schema)
    assert list(out.columns) == list(ref_out.columns)
    for name in ref_out.columns:
        assert column_bytes(out.column(name)) == \
            column_bytes(ref_out.column(name)), name


@pytest.fixture
def placement():
    def pin(mode):
        for mod in (ref_tfused, port_tfused):
            mod.set_placement(mode)
        ref_tfused.set_device_fusion(True)

    yield pin
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)
    ref_tfused.set_device_fusion(None)


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("n", [1, 1024, 1500])
@pytest.mark.parametrize("mode", ["device", "host"])
def test_kafka2ch_chain_byte_identical(mode, n, nulls, placement):
    placement(mode)
    port_batch, ref_batch = batches(KAFKA2CH_COLS,
                                    kafka2ch_data(n, nulls=nulls))
    chain, ref_chain = build_chain(KAFKA2CH, device="cpu"), \
        ref_build_chain(KAFKA2CH)
    steps = chain.plan_for(port_batch.table_id, port_batch.schema).steps
    ref_steps = ref_chain.plan_for(ref_batch.table_id,
                                   ref_batch.schema).steps
    # the rename stays a host step; the mask after it still fuses
    assert [s.describe() for s in steps] == \
        [s.describe() for s in ref_steps]
    assert isinstance(steps[0], RenameTables)
    assert isinstance(steps[1], port_tfused.DeviceFusedStep)
    assert steps[1].describe() == "device[mask_field]"
    table, schema = chain.output_schema(port_batch.table_id,
                                        port_batch.schema)
    ref_table, ref_schema_out = ref_chain.output_schema(ref_batch.table_id,
                                                        ref_batch.schema)
    assert table == TableID("", "events_clean")
    assert (ref_table.namespace, ref_table.name) == ("", "events_clean")
    assert schema_rows(schema) == schema_rows(ref_schema_out)
    out = chain.apply(port_batch)
    assert_same(out, ref_chain.apply(ref_batch))
    assert out.table_id == table and out.schema == schema
    assert all(len(v) == 64 for v in out.to_pydict()["user_email"]
               if v is not None and v != "")


def test_kafka2ch_other_table_passes_through(placement):
    placement("device")
    port_batch, ref_batch = batches(KAFKA2CH_COLS, kafka2ch_data(8),
                                    table=("", "other"))
    chain, ref_chain = build_chain(KAFKA2CH, device="cpu"), \
        ref_build_chain(KAFKA2CH)
    steps = chain.plan_for(port_batch.table_id, port_batch.schema).steps
    ref_steps = ref_chain.plan_for(ref_batch.table_id,
                                   ref_batch.schema).steps
    assert [s.describe() for s in steps] == \
        [s.describe() for s in ref_steps] == ["device[mask_field]"]
    assert chain.output_schema(port_batch.table_id, port_batch.schema)[0] \
        == TableID("", "other")
    assert_same(chain.apply(port_batch), ref_chain.apply(ref_batch))


def test_kafka2ch_dict_column_stays_encoded(placement):
    """A dictionary-encoded user_email keeps its encoding through the
    rename and the pool route, and equals the JAX chain on the flat
    column."""
    placement("device")
    n = 600
    data = kafka2ch_data(n)
    values = sorted(set(data["user_email"]))[:50]
    codes = np.arange(n, dtype=np.int32) % len(values)
    data["user_email"] = [values[c] for c in codes]
    port_flat, ref_batch = batches(KAFKA2CH_COLS, data)
    raw = [v.encode() for v in values]
    offsets = np.zeros(len(raw) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(v) for v in raw])
    pool = DictPool(np.frombuffer(b"".join(raw), dtype=np.uint8).copy(),
                    offsets)
    cols = dict(port_flat.columns)
    cols["user_email"] = Column("user_email",
                                port_flat.column("user_email").ctype,
                                dict_enc=DictEnc(codes, pool))
    port_batch = ColumnBatch(port_flat.table_id, port_flat.schema, cols)
    reset_flat_materializations()
    out = build_chain(KAFKA2CH, device="cpu").apply(port_batch)
    assert out.column("user_email").is_lazy_dict
    assert flat_materializations() == 0
    assert_same(out, ref_build_chain(KAFKA2CH).apply(ref_batch))


RENAME_COLS = [("id", "int64", True), ("email", "utf8"),
               ("amount", "double")]


def rename_data(n=5):
    return {"id": list(range(n)),
            "email": [f"u{i}@x" if i % 2 else None for i in range(n)],
            "amount": [i * 1.5 for i in range(n)]}


@pytest.mark.parametrize("config", [
    {"rename_tables": {"tables": [{"from": "db.users",
                                   "to": "db2.people"}]}},
    {"rename_tables": {"tables": [{"from": "db.other", "to": "x.y"}]}},
    {"rename_columns": {"columns": {"email": "mail", "amount": "sum"}}},
    {"rename_columns": {"columns": {"email": "mail"},
                        "tables": ["db.users"]}},
    {"rename_columns": {"columns": {"email": "mail"},
                        "tables": ["db.other"]}},
    {"rename_columns": {"columns": {"absent": "x"}}},
])
def test_renames_against_jax(config):
    cfg = {"transformers": [config]}
    port_batch, ref_batch = batches(RENAME_COLS, rename_data(),
                                    table=("db", "users"))
    chain, ref_chain = build_chain(cfg, device="cpu"), ref_build_chain(cfg)
    steps = chain.plan_for(port_batch.table_id, port_batch.schema).steps
    ref_steps = ref_chain.plan_for(ref_batch.table_id,
                                   ref_batch.schema).steps
    assert [s.describe() for s in steps] == \
        [s.describe() for s in ref_steps]
    table, schema = chain.output_schema(port_batch.table_id,
                                        port_batch.schema)
    ref_table, ref_out_schema = ref_chain.output_schema(ref_batch.table_id,
                                                        ref_batch.schema)
    assert (table.namespace, table.name) == \
        (ref_table.namespace, ref_table.name)
    assert schema_rows(schema) == schema_rows(ref_out_schema)
    out = chain.apply(port_batch)
    assert_same(out, ref_chain.apply(ref_batch))
    assert out.table_id == table and schema_rows(out.schema) == \
        schema_rows(schema)


def test_renamed_column_shares_buffers_and_encoding():
    pool = DictPool(np.frombuffer(b"ab", dtype=np.uint8).copy(),
                    np.array([0, 1, 2], dtype=np.int32))
    col = Column("c", new_table_schema([("c", "utf8")]).find("c").data_type,
                 dict_enc=DictEnc(np.array([1, 0], dtype=np.int32), pool),
                 validity=np.array([True, False]))
    r = col.renamed("d")
    assert r.name == "d" and r.is_lazy_dict and r.dict_enc is col.dict_enc
    assert r.validity is col.validity
    assert RenameColumns({"c": "d"}).result_schema(
        new_table_schema([("c", "utf8")])).names() == ["d"]


def test_rename_tables_result_table():
    t = RenameTables([{"from": "a.b", "to": "c.d"}])
    assert t.result_table(TableID("a", "b")) == TableID("c", "d")
    assert t.result_table(TableID("a", "x")) == TableID("a", "x")
    assert t.suitable(TableID("a", "b"), new_table_schema([]))
    assert not t.suitable(TableID("a", "x"), new_table_schema([]))
