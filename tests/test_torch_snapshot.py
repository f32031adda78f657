"""The snapshot transfer: the port's row contract, sink pipeline and
SnapshotLoader against the JAX package's, on the CPU, exactly.

The port runs with device="cpu" (each kernel's plain version); the JAX
package runs as its own tests run it on the CPU.  Held equal:
`ColumnBatch.from_rows`/`to_rows` on random ChangeItem lists (mixed
kinds, LSNs, NULLs, every canonical type); the chain on mixed-table row
batches and under emit/drop/fail with a failing transformer defined
here for each package; the Bufferer's merges; the Retrier over the
memory sink's injected failures; `pushable_predicate`; and whole
snapshots (the README's Quick-start chain over `sample` users, 20,000
rows, 4 parts, 4 upload threads, flat and dictionary-encoded, and over
a seeded `memory` source with NULLs; staged commits on and off): the
sink's rows, its control events, the coordinator's part records and
the published digests are equal, and each package's digest parses and
compares equal in the other.  Sample rows carry their generation time
as commit time, which is the one field not compared.
"""

import numpy as np
import pytest

from transferia_tpu.abstract.change_item import ChangeItem as RefItem
from transferia_tpu.abstract.change_item import OldKeys as RefOldKeys
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.middlewares import asynchronizer as ref_async
from transferia_tpu.middlewares import sync as ref_sync
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import Runtime as RefRuntime
from transferia_tpu.models.transfer import (
    ShardingUploadParams as RefSharding,
)
from transferia_tpu.ops.rowhash import FingerprintAggregate as RefAggregate
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import sample as ref_sample
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu.transform import base as ref_base
from transferia_tpu.transform import build_chain as ref_build_chain
from transferia_tpu.transform import fused as ref_tfused
from transferia_tpu.transform.chain import Transformation as RefChain
from transferia_tpu_torch.abstract.change_item import ChangeItem, OldKeys
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    new_table_schema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.middlewares import asynchronizer as port_async
from transferia_tpu_torch.middlewares import sync as port_sync
from transferia_tpu_torch.models import (
    Runtime,
    ShardingUploadParams,
    Transfer,
)
from transferia_tpu_torch.ops.rowhash import (
    FingerprintAggregate,
    TableFingerprinter,
)
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import sample as port_sample
from transferia_tpu_torch.tasks import SnapshotLoader, upload
from transferia_tpu_torch.transform import base as port_base
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform import fused as port_tfused
from transferia_tpu_torch.transform.chain import Transformation

QUICK_START = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": "s3cr3t"}},
    {"filter_rows": {"filter": "age >= 21 AND country IN ('de','us')"}},
]}
FUSED = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": "s3cr3t"}},
    {"filter_rows": {"filter": "age >= 21"}},
]}


@pytest.fixture(autouse=True)
def device_placement():
    """Both packages' fused steps take their device strategy (the port's
    on the CPU runs the kernels' plain versions)."""
    for mod in (ref_tfused, port_tfused):
        mod.set_placement("device")
    yield
    for mod in (ref_tfused, port_tfused):
        mod.set_placement(None)


# -- values and rows -------------------------------------------------------

ALL_TYPES = [t.value for t in CanonicalType]


def random_value(ctype: str, rng):
    if rng.random() < 0.2:
        return None
    if ctype in ("int8", "int16", "int32", "int64"):
        bits = int(ctype[3:])
        return int(rng.integers(-(2 ** (bits - 1)), 2 ** (bits - 1)))
    if ctype in ("uint8", "uint16", "uint32", "uint64"):
        return int(rng.integers(0, 2 ** int(ctype[4:]), dtype=np.uint64))
    if ctype == "float":  # representable in float32, so it round-trips
        return float(np.float32(np.round(rng.normal(0, 1e3), 3)))
    if ctype == "double":
        return float(np.round(rng.normal(0, 1e3), 3))
    if ctype == "boolean":
        return bool(rng.integers(0, 2))
    if ctype in ("date", "datetime", "timestamp", "interval"):
        return int(rng.integers(0, 2 ** 31))
    if ctype == "string":
        return bytes(rng.integers(0, 256, int(rng.integers(0, 12)),
                                  dtype=np.uint8))
    if ctype == "utf8":
        return "".join(chr(int(c)) for c in rng.integers(32, 0x4ff, int(
            rng.integers(0, 9))))
    if ctype == "decimal":
        return f"{int(rng.integers(-10**6, 10**6))}.{int(rng.integers(100))}"
    return {"k": int(rng.integers(100)), "v": [1, "x", None]}  # any


def schema_cols(with_pk: bool = True):
    cols = [("id", "int64", True)] if with_pk else []
    return cols + [(f"c_{t}", t) for t in ALL_TYPES]


def random_items(seed: int, n: int, tables=("t",)):
    """(port items, JAX items): the same random rows, kinds, LSNs, old
    keys and transaction ids in each package's types."""
    rng = np.random.default_rng(seed)
    cols = schema_cols()
    port_schemas = {t: new_table_schema(cols) for t in tables}
    ref_schemas = {t: ref_schema(cols) for t in tables}
    names = tuple(c[0] for c in cols)
    port, ref = [], []
    kinds = ("insert", "update", "delete")
    for i in range(n):
        table = tables[int(rng.integers(len(tables)))] \
            if len(tables) > 1 else tables[0]
        values = (i,) + tuple(random_value(t, rng) for t in ALL_TYPES)
        kind = kinds[int(rng.integers(3))] if seed % 2 else "insert"
        lsn = int(rng.integers(0, 2 ** 40)) if rng.random() < 0.7 else 0
        ct = int(rng.integers(0, 2 ** 60)) if rng.random() < 0.5 else 0
        old = ((("id",), (i + 1000,)) if kind != "insert"
               and rng.random() < 0.5 else ((), ()))
        txn = f"tx{i // 3}" if rng.random() < 0.3 else ""
        for out, item, keys, kcls, schemas in (
                (port, ChangeItem, OldKeys, Kind, port_schemas),
                (ref, RefItem, RefOldKeys, RefKind, ref_schemas)):
            out.append(item(kind=kcls(kind), schema="ns", table=table,
                            column_names=names, column_values=values,
                            table_schema=schemas[table], lsn=lsn,
                            commit_time_ns=ct, txn_id=txn,
                            old_keys=keys(*old), part_id="p1",
                            size_bytes=17))
    return port, ref


def norm_item(it, commit_time: bool = True):
    schema = None if it.table_schema is None else tuple(
        (c.name, c.data_type.value, c.primary_key)
        for c in it.table_schema)
    return (it.kind.value, it.schema, it.table, tuple(it.column_names),
            tuple(it.column_values), it.lsn,
            it.commit_time_ns if commit_time else None,
            tuple(it.old_keys.key_names), tuple(it.old_keys.key_values),
            it.txn_id, it.part_id, schema)


def column_bytes(col):
    return (col.ctype.value, np.asarray(col.data).tobytes(),
            None if col.offsets is None else col.offsets.tobytes(),
            None if col.validity is None else col.validity.tobytes())


def batch_state(b):
    """Everything a ColumnBatch carries, as comparable values."""
    def arr(a):
        return None if a is None else (a.dtype.str, a.tobytes())

    return (str(b.table_id), b.n_rows,
            {n: column_bytes(c) for n, c in b.columns.items()},
            arr(b.kinds), arr(b.lsns), arr(b.commit_times), b.part_id,
            b.read_bytes,
            None if b.old_keys is None else
            [(k.key_names, k.key_values) for k in b.old_keys],
            b.txn_ids)


def norm_out(out):
    """A chain's output (a block or a row list) as comparable values."""
    if hasattr(out, "columns"):
        return ("block", batch_state(out))
    return ("rows", [norm_item(it) for it in out])


@pytest.mark.parametrize("seed", range(6))
def test_rows_pivot_round_trip(seed):
    port, ref = random_items(seed, 60 + seed)
    pb, rb = ColumnBatch.from_rows(port), RefBatch.from_rows(ref)
    assert batch_state(pb) == batch_state(rb)
    back, ref_back = pb.to_rows(), rb.to_rows()
    assert [norm_item(a) for a in back] == [norm_item(b) for b in ref_back]
    # what went in comes back, kinds, LSNs and NULLs included
    assert [norm_item(a)[:11] for a in back] == \
        [norm_item(a)[:9] + (a.txn_id, a.part_id) for a in port]
    # slicing, filtering and concatenation carry the row metadata
    keep = np.arange(pb.n_rows) % 3 != 1
    parts = [pb.filter(keep), pb.slice(5, 40)]
    ref_parts = [rb.filter(keep), rb.slice(5, 40)]
    assert batch_state(ColumnBatch.concat(parts)) == \
        batch_state(RefBatch.concat(ref_parts))


def test_rows_pivot_refuses_what_jax_refuses():
    port, ref = random_items(1, 4, tables=("a", "b"))
    port = [port[0]] + [p for p in port[1:] if p.table != port[0].table]
    ref = [ref[0]] + [r for r in ref[1:] if r.table != ref[0].table]
    if len(port) > 1:
        for fn, items in ((ColumnBatch.from_rows, port),
                          (RefBatch.from_rows, ref)):
            with pytest.raises(ValueError, match="mixed tables"):
                fn(items)
    for fn in (ColumnBatch.from_rows, RefBatch.from_rows):
        with pytest.raises(ValueError, match="empty"):
            fn([])


# -- the chain ------------------------------------------------------------

CHAIN_COLS = [("id", "int64", True), ("email", "utf8"), ("age", "int32"),
              ("country", "utf8")]


def chain_items(seed: int, n: int, tables=("a", "b")):
    rng = np.random.default_rng(seed)
    port_schemas = {t: new_table_schema(CHAIN_COLS) for t in tables}
    ref_schemas = {t: ref_schema(CHAIN_COLS) for t in tables}
    names = tuple(c[0] for c in CHAIN_COLS)
    port, ref = [], []
    table = tables[0]
    for i in range(n):
        if rng.random() < 0.15:  # runs of a table, then a switch
            table = tables[int(rng.integers(len(tables)))]
        values = (i,
                  None if rng.random() < 0.1 else f"u{i}@example.com",
                  None if rng.random() < 0.1 else int(rng.integers(10, 60)),
                  ["de", "us", "fr", None][int(rng.integers(4))])
        kind = ("insert", "update", "delete")[int(rng.integers(3))]
        lsn = 1000 + i
        for out, item, kcls, schemas in (
                (port, ChangeItem, Kind, port_schemas),
                (ref, RefItem, RefKind, ref_schemas)):
            out.append(item(kind=kcls(kind), schema="ns", table=table,
                            column_names=names, column_values=values,
                            table_schema=schemas[table], lsn=lsn))
    return port, ref


@pytest.mark.parametrize("config", [QUICK_START, FUSED],
                         ids=["quick_start", "fused"])
@pytest.mark.parametrize("seed", [3, 4])
def test_chain_on_mixed_table_rows(config, seed):
    port, ref = chain_items(seed, 300)
    chain = build_chain(config, device="cpu")
    ref_chain = ref_build_chain(config)
    out, ref_out = chain.apply(port), ref_chain.apply(ref)
    assert isinstance(out, list) and len(out) < len(port)
    assert norm_out(out) == norm_out(ref_out)
    # one table alone pivots to a single block
    single = [it for it in port if it.table == "a"]
    ref_single = [it for it in ref if it.table == "a"]
    assert norm_out(chain.apply(single)) == \
        norm_out(ref_chain.apply(ref_single))
    for name in ("rows_in", "rows_out", "errors", "compiles"):
        assert getattr(chain.stats, name).get() == \
            getattr(ref_chain.stats, name)._value.get()


def failing_transformer(base):
    """A transformer that fails every row whose id is odd, in `base`'s
    package (transform/base.py of the port or of the JAX package)."""

    class FailOdd(base.Transformer):
        TYPE = "fail_odd"

        def suitable(self, table, schema):
            return True

        def apply(self, batch):
            ids = batch.column("id").data
            odd = (ids % 2) == 1
            return base.TransformResult(
                batch.filter(~odd),
                base.error_batch(batch, odd, "odd id"))

    return FailOdd()


@pytest.mark.parametrize("behavior", ["emit", "drop", "fail"])
def test_chain_error_behaviors(behavior):
    port, ref = chain_items(5, 120, tables=("a",))
    port_batch = ColumnBatch.from_rows(port)
    ref_batch = RefBatch.from_rows(ref)
    chain = Transformation([failing_transformer(port_base)],
                           error_behavior=behavior, device="cpu")
    ref_chain = RefChain([failing_transformer(ref_base)],
                         error_behavior=behavior)
    if behavior == "fail":
        for c, b in ((chain, port_batch), (ref_chain, ref_batch)):
            with pytest.raises(ValueError, match="failed 60 rows"):
                c.apply(b)
        return
    out, ref_out = chain.apply(port_batch), ref_chain.apply(ref_batch)
    assert norm_out(out) == norm_out(ref_out)
    if behavior == "emit":
        errors = [it for it in out if "__transform_error" in it.column_names]
        assert len(errors) == 60
        assert {it.value("__transform_error") for it in errors} == {"odd id"}
    else:
        assert out.n_rows == 60
    assert chain.stats.errors.get() == ref_chain.stats.errors._value.get()


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_collapse_and_split_by_table(seed):
    from transferia_tpu.abstract.change_item import collapse as ref_collapse
    from transferia_tpu.abstract.change_item import (
        split_by_table_id as ref_split,
    )
    from transferia_tpu_torch.abstract.change_item import (
        collapse,
        split_by_table_id,
    )

    port, ref = chain_items(seed, 200)
    # few keys, so inserts, updates and deletes of one row fold
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 12, len(port))
    port = [it.with_values(it.column_names, (int(k),) + it.column_values[1:])
            for it, k in zip(port, keys)]
    ref = [it.with_values(it.column_names, (int(k),) + it.column_values[1:])
           for it, k in zip(ref, keys)]
    out, ref_out = collapse(port), ref_collapse(ref)
    assert len(out) < len(port)
    assert [norm_item(a) for a in out] == [norm_item(b) for b in ref_out]
    split, ref_split_out = split_by_table_id(port), ref_split(ref)
    assert {str(t): [norm_item(a) for a in v] for t, v in split.items()} == \
        {str(t): [norm_item(a) for a in v] for t, v in ref_split_out.items()}


# -- the sink pipeline ------------------------------------------------------

class _Capture:
    """A sync sink recording what reaches it."""

    def __init__(self):
        self.pushes = []

    def push(self, batch):
        self.pushes.append(batch)

    def close(self):
        pass


def pipeline_inputs(pkg_sample, pkg_items, item, kind, tid_cls):
    """Sample blocks of two tables (one pool per dictionary column), two
    parts of one table, and control items between them."""
    blocks = []
    for k, (table, start, n) in enumerate([
            ("users", 0, 300), ("users", 300, 200), ("other", 0, 100),
            ("users", 500, 250), ("users", 750, 50)]):
        b = pkg_sample.make_batch("users", tid_cls("sample", table), start,
                                  n, seed=9, dict_encode=k != 3)
        b.part_id = "p2" if k == 4 else ""
        blocks.append(b)
    control = [item(kind=kind("init_load_table"), schema="sample",
                    table="users")]
    return [blocks[0], blocks[1], control, blocks[2], blocks[3],
            blocks[4], pkg_items[:7], pkg_items[7:20]]


@pytest.mark.parametrize("trigger_rows", [1, 400, 10_000])
def test_bufferer_merges(trigger_rows):
    items, ref_items = chain_items(6, 20, tables=("a",))
    inputs = pipeline_inputs(port_sample, items, ChangeItem, Kind, TableID)
    ref_inputs = pipeline_inputs(ref_sample, ref_items, RefItem, RefKind,
                                 RefTableID)
    outs = []
    for mod, batches in ((port_async, inputs), (ref_async, ref_inputs)):
        sink = _Capture()
        buf = mod.Bufferer(sink, mod.BuffererConfig(
            trigger_rows=trigger_rows, trigger_interval=0))
        futs = [buf.async_push(b) for b in batches]
        buf.close()
        for f in futs:
            f.result()
        # the encoding first: reading a column's bytes flattens it
        encoded = [hasattr(p, "columns") and p.columns["country"]
                   .is_lazy_dict for p in sink.pushes]
        outs.append(([norm_out(p) for p in sink.pushes], encoded,
                     buf.stats.flush_count))
    (port_pushes, port_dict, port_flushes), \
        (ref_pushes, ref_dict, ref_flushes) = outs
    assert port_pushes == ref_pushes
    # a merge of blocks over one pool keeps the column encoded, as in JAX
    assert port_dict == ref_dict
    if trigger_rows > 1:
        assert port_dict[0] and port_pushes[0][1][1] == 500
    assert port_flushes.get() == ref_flushes._value.get()


class _Failing(_Capture):
    """Fails its third push."""

    def push(self, batch):
        if len(self.pushes) == 2:
            self.pushes.append(None)
            raise ConnectionError("third push")
        super().push(batch)


@pytest.mark.parametrize("wrap", ["asynchronizer", "synchronizer",
                                  "memthrottler"])
def test_async_wrappers_order_and_latch(wrap):
    """Order through each async wrapper, and ErrorTracker's latch."""
    items, ref_items = chain_items(8, 60, tables=("a",))
    outs = []
    for mod, rows in ((port_async, items), (ref_async, ref_items)):
        # the asynchronizer resolves on its own thread, so when its error
        # latches is a race: it runs over a sink that never fails
        sink = _Capture() if wrap == "asynchronizer" else _Failing()
        if wrap == "asynchronizer":
            inner = mod.Asynchronizer(sink)
        elif wrap == "synchronizer":
            inner = mod.Synchronizer(sink)
        else:
            inner = mod.MemThrottler(mod.Synchronizer(sink), 1)
        tracker = mod.ErrorTracker(inner)
        futs = [tracker.async_push(rows[i:i + 10]) for i in range(0, 60, 10)]
        errors = []
        for f in futs:
            try:
                f.result(timeout=30)
                errors.append(None)
            except ConnectionError as e:
                errors.append(str(e))
        tracker.close()
        outs.append(([None if p is None else norm_out(p)
                      for p in sink.pushes], errors,
                     str(tracker.failure)))
    assert outs[0] == outs[1]
    if wrap == "asynchronizer":
        assert outs[0][1] == [None] * 6 and len(outs[0][0]) == 6
    else:  # the failure latches: later pushes fail without reaching it
        assert outs[0][1] == [None, None] + ["third push"] * 4


@pytest.mark.parametrize("fails", [0, 2, 3])
def test_retrier_over_memory_sink_failures(fails):
    items, ref_items = chain_items(7, 50, tables=("a",))
    batch, ref_batch = ColumnBatch.from_rows(items), \
        RefBatch.from_rows(ref_items)
    results = []
    for mem, sync, b, sid in (
            (port_memory, port_sync, batch, f"port-retry-{fails}"),
            (ref_memory, ref_sync, ref_batch, f"ref-retry-{fails}")):
        mem.get_store(sid).clear()
        sink = mem.MemorySinker(mem.MemoryTargetParams(
            sink_id=sid, fail_pushes=fails))
        retrier = sync.Retrier(sink, attempts=3, base_delay=0.0)
        try:
            retrier.push(b)
            err = None
        except ConnectionError as e:
            err = str(e)
        results.append((err, [norm_item(it) for it in
                              mem.get_store(sid).rows()]))
    assert results[0] == results[1]
    assert (results[0][0] is None) == (fails < 3)


@pytest.mark.parametrize("config", [
    QUICK_START,
    FUSED,
    {"transformers": [{"mask_field": {"columns": ["age"], "salt": "s"}},
                      {"filter_rows": {"filter": "age >= 21"}}]},
    {"transformers": [{"filter_rows": {"filter": "country = 'de'"}}]},
    {"transformers": [{"rename_columns": {"columns": {"email": "e"}}},
                      {"filter_rows": {"filter": "age >= 21"}}]},
    {"transformers": [{"mask_field": {"columns": ["email"], "salt": "s"}}]},
], ids=["quick_start", "fused", "masked_column", "filter_only", "rename",
        "mask_only"])
def test_pushable_predicate(config):
    cols = [("user_id", "int64", True), ("name", "utf8"), ("email", "utf8"),
            ("age", "int32"), ("score", "double"), ("country", "utf8")]
    tid = TableID("sample", "users")
    node = build_chain(config, device="cpu").pushable_predicate(
        tid, new_table_schema(cols))
    ref_node = ref_build_chain(config).pushable_predicate(
        RefTableID("sample", "users"), ref_schema(cols))
    assert repr(node) == repr(ref_node)


# -- whole snapshots --------------------------------------------------------

def memory_source_batches(batch_cls, schema_fn, tid_cls):
    """A seeded memory source with NULLs: 8 batches of 500 rows."""
    rng = np.random.default_rng(21)
    out = []
    for k in range(8):
        ids = range(k * 500, (k + 1) * 500)
        data = {
            "user_id": list(ids),
            "email": [None if rng.random() < 0.1 else f"m{i}@example.org"
                      for i in ids],
            "age": [None if rng.random() < 0.1 else int(a)
                    for a in rng.integers(10, 70, 500)],
            "country": [["de", "us", "jp", None][int(c)]
                        for c in rng.integers(0, 4, 500)],
        }
        out.append(batch_cls.from_pydict(
            tid_cls("src", "people"),
            schema_fn([("user_id", "int64", True), ("email", "utf8"),
                       ("age", "int32"), ("country", "utf8")]), data))
    return out


def run_snapshot(pkg: str, source: str, config, dict_encode: bool,
                 sid: str):
    """One transfer through the package's SnapshotLoader on a memory
    coordinator; returns (coordinator, store, operation id)."""
    if pkg == "port":
        mem, sample, transfer, runtime, sharding = (
            port_memory, port_sample, Transfer, Runtime,
            ShardingUploadParams)
    else:
        mem, sample, transfer, runtime, sharding = (
            ref_memory, ref_sample, RefTransfer, RefRuntime, RefSharding)
    if source == "sample":
        src = sample.SampleSourceParams(
            preset="users", table="users", rows=20_000, shard_parts=4,
            batch_rows=2048, dict_encode=dict_encode)
    else:
        if pkg == "port":
            batches = memory_source_batches(ColumnBatch, new_table_schema,
                                            TableID)
        else:
            batches = memory_source_batches(RefBatch, ref_schema,
                                            RefTableID)
        mem.seed_source(sid, batches)
        src = mem.MemorySourceParams(source_id=sid)
    mem.get_store(sid).clear()
    t = transfer(
        id=sid, src=src,
        dst=mem.MemoryTargetParams(sink_id=sid,
                                   bufferer={"trigger_rows": 4096}),
        transformation=config,
        runtime=runtime(sharding=sharding(process_count=4)),
        validation={"fingerprint": True})
    if pkg == "port":
        cp = MemoryCoordinator()
        SnapshotLoader(t, cp, device="cpu").upload_tables()
    else:
        cp = RefCoordinator()
        RefLoader(t, cp).upload_tables()
    return cp, mem.get_store(sid), f"op-{sid}"


def part_records(cp, op):
    out = []
    for p in sorted(cp.operation_parts(op), key=lambda p: p.key()):
        d = p.to_json()
        d.pop("lease_expires_at")  # a wall-clock deadline
        d["operation_id"] = d["operation_id"].split("-", 2)[-1]
        out.append(d)
    return out


def sink_rows(store):
    rows = sorted((norm_item(it, commit_time=False)
                   for it in store.rows()), key=lambda r: r[4][0])
    controls = sorted((it.kind.value, it.schema, it.table, it.part_id)
                      for it in store.control_events())
    return rows, controls


SNAPSHOTS = {
    "sample_dict_staged": ("sample", QUICK_START, True, "on"),
    "sample_flat_staged": ("sample", QUICK_START, False, "on"),
    "sample_dict_unstaged": ("sample", QUICK_START, True, "off"),
    "sample_fused_staged": ("sample", FUSED, True, "on"),
    "memory_staged": ("memory", QUICK_START, False, "on"),
    "memory_unstaged": ("memory", QUICK_START, False, "off"),
}


@pytest.mark.parametrize("case", sorted(SNAPSHOTS))
def test_snapshot_equals_jax(case, monkeypatch):
    source, config, dict_encode, staged = SNAPSHOTS[case]
    monkeypatch.setenv("TRANSFERIA_TPU_STAGED_COMMIT", staged)
    cp, store, op = run_snapshot("port", source, config, dict_encode,
                                 f"port-{case}")
    ref_cp, ref_store, ref_op = run_snapshot("jax", source, config,
                                             dict_encode, f"jax-{case}")
    rows, controls = sink_rows(store)
    ref_rows, ref_controls = sink_rows(ref_store)
    assert len(rows) > 0
    assert rows == ref_rows
    assert controls == ref_controls
    records = part_records(cp, op)
    assert records == part_records(ref_cp, ref_op)
    assert all(r["completed"] for r in records)
    assert all(r["commit_epoch"] == (r["assignment_epoch"]
                                     if staged == "on" else None)
               for r in records)
    digests = cp.get_operation_state(op)["table_fingerprints"]
    ref_digests = ref_cp.get_operation_state(ref_op)["table_fingerprints"]
    assert digests == ref_digests
    for table, digest in digests.items():
        assert FingerprintAggregate.parse(ref_digests[table]) == \
            FingerprintAggregate.parse(digest)
        assert RefAggregate.parse(digest).digest() == ref_digests[table]
    # the digest is the fingerprint of what the sink holds
    fp = TableFingerprinter(backend="host")
    for b in store.batches:
        if hasattr(b, "columns"):
            fp.push(b)
    assert list(digests.values()) == [fp.result().digest()]


def test_upload_entry_point_equals_loader():
    """tasks.upload over explicit tables gives the loader's digests."""
    cp = MemoryCoordinator()
    mem = port_memory
    sid = "port-upload"
    mem.seed_source(sid, memory_source_batches(ColumnBatch,
                                               new_table_schema, TableID))
    mem.get_store(sid).clear()
    t = Transfer(id=sid, src=mem.MemorySourceParams(source_id=sid),
                 dst=mem.MemoryTargetParams(sink_id=sid),
                 transformation=QUICK_START,
                 validation={"fingerprint": True})
    upload(t, cp, ["src.people"], device="cpu")
    loader_cp, _, op = run_snapshot("port", "memory", QUICK_START, False,
                                    "port-upload-ref")
    assert cp.get_operation_state(f"op-{sid}")["table_fingerprints"] == \
        loader_cp.get_operation_state(op)["table_fingerprints"]


@pytest.mark.parametrize("what", ["secondary", "resume", "incremental",
                                  "preempted"])
def test_left_out_branches_raise(what):
    from transferia_tpu_torch.models.transfer import IncrementalTableCfg

    t = Transfer(id=f"left-{what}",
                 src=port_memory.MemorySourceParams(source_id="none"),
                 dst=port_memory.MemoryTargetParams(sink_id="none"))
    kw = {}
    if what == "secondary":
        t.runtime.current_job = 1
    elif what == "resume":
        kw["resume"] = True
    elif what == "incremental":
        t.regular_snapshot.incremental.append(
            IncrementalTableCfg("src", "people", "user_id"))
    else:
        kw["preempted"] = lambda: False
    if what == "incremental":
        # the incremental branch is ported (tests/test_torch_pg_sink.py
        # holds it against the JAX package): the run persists the cursors
        cp = MemoryCoordinator()
        SnapshotLoader(t, cp, device="cpu", **kw).upload_tables()
        assert cp.get_transfer_state(t.id)["incremental_state"] == {}
        return
    # ported (tests/test_torch_sharded.py holds the secondary and the
    # resume against the JAX package, tests/test_torch_fleet_distributed.py
    # the preemption): a secondary whose main found no parts exits at
    # once, a resume with no queue to reuse runs afresh, and a probe that
    # never fires leaves the run as it was
    cp = MemoryCoordinator()
    cp.set_operation_state(f"op-{t.id}", {"parts_discovery_done": True})
    SnapshotLoader(t, cp, device="cpu", **kw).upload_tables()
    assert cp.operation_parts(f"op-{t.id}") == []
