"""The port's event model v2 (`transferia_tpu_torch/events/`) against the
JAX package's `transferia_tpu/events/`, on the CPU.  Every comparison is
exact.

- `batch_to_events` / `events_to_batches` on seeded batches of every
  event kind (a columnar block; row runs of inserts, updates and deletes;
  the four table-load markers and the barrier; DDL, truncate and drop
  items), and the reference's own case (`tests/unit/test_events_sr.py`).
- Both bridges: `EventTargetOverAsyncSink` (events lowered in order, one
  future for all, a single shared waiter thread whatever the pushes) and
  `AsyncSinkOverEventTarget`.
- `DataObjectPart` and its round trip through the v1 table part, and
  `StorageSnapshotSource` over a v1 storage with its progress.
"""

import concurrent.futures
import threading

import numpy as np
import pytest

from transferia_tpu import events as ref_events
from transferia_tpu.abstract import change_item as ref_ci
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import \
    new_table_schema as ref_new_schema
from transferia_tpu.abstract.table import \
    TableDescription as RefTableDescription
from transferia_tpu.columnar.batch import ColumnBatch as RefColumnBatch
from transferia_tpu_torch import events as port_events
from transferia_tpu_torch.abstract import change_item as port_ci
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.columnar.batch import ColumnBatch

PKG = {
    "port": dict(ev=port_events, ci=port_ci, Kind=Kind, TableID=TableID,
                 schema=new_table_schema, CB=ColumnBatch,
                 TD=TableDescription),
    "jax": dict(ev=ref_events, ci=ref_ci, Kind=RefKind, TableID=RefTableID,
                schema=ref_new_schema, CB=RefColumnBatch,
                TD=RefTableDescription),
}
COLS = [("id", "int64", True), ("name", "utf8"), ("score", "double")]
ROW_KINDS = ("insert", "update", "delete")
CONTROL_KINDS = ("init_load_table", "done_load_table",
                 "init_sharded_table_load", "done_sharded_table_load",
                 "synchronize")
RAW_KINDS = ("ddl", "truncate", "drop", "pg:DDL")


def seeded_items(pkg: str, seed: int, n: int = 40) -> list:
    """n items of every kind in a seeded order: row runs broken by
    control markers and raw items, over two tables."""
    m = PKG[pkg]
    rng = np.random.default_rng(seed)
    schema = m["schema"](COLS)
    out = []
    for i in range(n):
        r = rng.random()
        table = "t" if rng.random() < 0.8 else "u"
        if r < 0.6:
            kind = ROW_KINDS[int(rng.integers(0, 3))]
            out.append(m["ci"].ChangeItem(
                kind=m["Kind"](kind), schema="s", table=table,
                column_names=("id", "name", "score"),
                column_values=(int(rng.integers(0, 1000)),
                               f"n{int(rng.integers(0, 50))}",
                               float(rng.integers(0, 100)) / 4),
                table_schema=schema, lsn=i, txn_id=f"x{i // 5}"))
        elif r < 0.8:
            kind = CONTROL_KINDS[int(rng.integers(0, len(CONTROL_KINDS)))]
            out.append(m["ci"]._control(m["Kind"](kind),
                                        m["TableID"]("s", table), schema,
                                        part_id=f"p{i}"))
        else:
            kind = RAW_KINDS[int(rng.integers(0, len(RAW_KINDS)))]
            out.append(m["ci"].ChangeItem(
                kind=m["Kind"](kind), schema="s", table=table,
                column_names=("sql",), column_values=(f"stmt {i}",),
                lsn=i))
    return out


def seeded_columnar(pkg: str, seed: int, n: int = 64):
    m = PKG[pkg]
    rng = np.random.default_rng(seed)
    return m["CB"].from_pydict(m["TableID"]("s", "t"), m["schema"](COLS), {
        "id": [int(v) for v in rng.integers(0, 10_000, n)],
        "name": [f"v{int(v)}" for v in rng.integers(0, 99, n)],
        "score": [float(v) / 8 for v in rng.integers(0, 800, n)]})


def item_key(it) -> tuple:
    """Everything of an item but its commit time (a control item's is
    the clock at its making)."""
    schema = None if it.table_schema is None else \
        [(c.name, c.data_type.value, c.primary_key)
         for c in it.table_schema]
    return (it.kind.value, it.schema, it.table, it.column_names,
            it.column_values, schema, it.lsn, it.txn_id, it.part_id)


def event_key(ev) -> tuple:
    name = type(ev).__name__
    tid = ev.table()
    head = (name, tid.namespace, tid.name)
    if name == "InsertBatchEvent":
        return head + (ev.row_count(),
                       tuple(tuple(r.as_dict().items())
                             for r in ev.batch.to_rows()))
    if name in ("RowEvents", "RawItems"):
        return head + (tuple(item_key(it) for it in ev.items),)
    schema = None if ev.schema is None else \
        [(c.name, c.data_type.value) for c in ev.schema]
    return head + (ev.kind.value, ev.part_id, schema, ev.is_done)


def batch_key(batch) -> tuple:
    if isinstance(batch, list):
        return ("items", tuple(item_key(it) for it in batch))
    return ("columnar", batch.n_rows,
            tuple(tuple(r.as_dict().items()) for r in batch.to_rows()))


@pytest.mark.parametrize("seed", [1, 2, 3, 7, 11])
def test_row_batches_to_events_and_back_equal_jax(seed):
    got, want = [], []
    for pkg, out in (("port", got), ("jax", want)):
        ev = PKG[pkg]["ev"]
        events = ev.batch_to_events(seeded_items(pkg, seed))
        out.append([event_key(e) for e in events])
        out.append([batch_key(b) for b in ev.events_to_batches(events)])
    assert got == want
    kinds = {k[0] for k in got[0]}
    assert {"RowEvents", "TableLoadEvent", "RawItems"} <= kinds


@pytest.mark.parametrize("seed", [5, 6])
def test_columnar_batch_is_one_insert_event_as_jax(seed):
    got, want = [], []
    for pkg, out in (("port", got), ("jax", want)):
        ev = PKG[pkg]["ev"]
        events = ev.batch_to_events(seeded_columnar(pkg, seed))
        out.append([event_key(e) for e in events])
        out.append([batch_key(b) for b in ev.events_to_batches(events)])
    assert got == want and got[0][0][0] == "InsertBatchEvent"


def test_reference_case_roundtrip():
    """tests/unit/test_events_sr.py::test_event_roundtrip on the port."""
    schema = new_table_schema([("id", "int64", True)])
    tid = TableID("s", "t")
    evs = port_events.batch_to_events(
        ColumnBatch.from_pydict(tid, schema, {"id": [1, 2]}))
    assert len(evs) == 1 and isinstance(evs[0],
                                        port_events.InsertBatchEvent)
    assert evs[0].row_count() == 2
    items = [
        port_ci.init_table_load(tid, schema, part_id="p1"),
        port_ci.ChangeItem(kind=Kind.INSERT, schema="s", table="t",
                           column_names=("id",), column_values=(1,),
                           table_schema=schema),
        port_ci.done_table_load(tid, schema, part_id="p1"),
    ]
    evs = port_events.batch_to_events(items)
    assert [type(e).__name__ for e in evs] == [
        "TableLoadEvent", "RowEvents", "TableLoadEvent"]
    assert evs[0].part_id == "p1" and not evs[0].is_done
    assert evs[2].is_done
    back = list(port_events.events_to_batches(evs))
    assert len(back) == 3
    assert back[0][0].kind == Kind.INIT_TABLE_LOAD
    assert back[1][0].value("id") == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_unknown_event_is_refused(pkg):
    class Odd(PKG[pkg]["ev"].Event):
        def table(self):
            return None

    with pytest.raises(TypeError, match="unknown event Odd"):
        list(PKG[pkg]["ev"].events_to_batches([Odd()]))


# -- the bridges ----------------------------------------------------------------

class RecordingSink:
    """A v1 async sink: records each batch, resolves its future when
    `release` is set (at once by default)."""

    def __init__(self, hold: bool = False):
        self.batches, self.futures = [], []
        self.hold = hold
        self.closed = False

    def async_push(self, batch):
        self.batches.append(batch)
        fut = concurrent.futures.Future()
        if self.hold:
            self.futures.append(fut)
        else:
            fut.set_result(None)
        return fut

    def release(self, exc=None):
        for f in self.futures:
            if exc is None:
                f.set_result(None)
            else:
                f.set_exception(exc)

    def close(self):
        self.closed = True


def bridge_pushes(pkg: str, seed: int) -> tuple:
    ev = PKG[pkg]["ev"]
    sink = RecordingSink()
    target = ev.EventTargetOverAsyncSink(sink)
    events = ev.batch_to_events(seeded_items(pkg, seed))
    results = []
    for i in range(0, len(events), 3):
        results.append(target.async_push(events[i:i + 3]).result())
    results.append(target.async_push([]).result())
    target.close()
    return (tuple(batch_key(b) for b in sink.batches), tuple(results),
            sink.closed)


@pytest.mark.parametrize("seed", [1, 4])
def test_event_target_over_async_sink_equals_jax(seed):
    assert bridge_pushes("port", seed) == bridge_pushes("jax", seed)


def waiter_threads() -> int:
    return sum(1 for t in threading.enumerate()
               if t.name.startswith("a2-bridge-wait"))


def test_bridge_resolves_many_futures_on_one_waiter_thread():
    """Pushes whose futures resolve only later (a buffered sink's flush)
    share the one waiter thread, and an error reaches the caller."""
    before = waiter_threads()
    sink = RecordingSink(hold=True)
    target = port_events.EventTargetOverAsyncSink(sink)
    events = port_events.batch_to_events(seeded_items("port", 9))
    futs = [target.async_push(events[i:i + 4])
            for i in range(0, len(events), 4)]
    assert waiter_threads() - before == 1
    assert not any(f.done() for f in futs if f not in sink.futures)
    sink.release()
    for f in futs:
        assert f.result(timeout=10) is None
    # a failed batch fails the push that carried it
    fail = RecordingSink(hold=True)
    t2 = port_events.EventTargetOverAsyncSink(fail)
    fut = t2.async_push(events[:4])
    fail.release(RuntimeError("sink down"))
    with pytest.raises(RuntimeError, match="sink down"):
        fut.result(timeout=10)
    target.close()
    t2.close()
    assert waiter_threads() == before


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_async_sink_over_event_target(pkg):
    ev = PKG[pkg]["ev"]

    class Capture(ev.EventTarget):
        def __init__(self):
            self.events, self.closed = [], False

        def async_push(self, events):
            self.events.append(list(events))
            fut = concurrent.futures.Future()
            fut.set_result(None)
            return fut

        def close(self):
            self.closed = True

    cap = Capture()
    sink = ev.AsyncSinkOverEventTarget(cap)
    sink.async_push(seeded_items(pkg, 3)).result()
    sink.async_push(seeded_columnar(pkg, 3)).result()
    sink.close()
    assert cap.closed
    want = [[event_key(e) for e in ev.batch_to_events(seeded_items(pkg, 3))],
            [event_key(e) for e in ev.batch_to_events(
                seeded_columnar(pkg, 3))]]
    assert [[event_key(e) for e in evs] for evs in cap.events] == want


# -- data object parts and the storage source -----------------------------------

@pytest.mark.parametrize("key,eta", [("", 0), ("obj:a/b.parquet", 1234),
                                     ("s3://b/t/part-0.parquet", 7)])
def test_data_object_part_round_trip_equals_jax(key, eta):
    got = {}
    for pkg in ("port", "jax"):
        m = PKG[pkg]
        ev = m["ev"]
        part = ev.DataObjectPart(table=m["TableID"]("ns", "t"),
                                 part_key=key, eta_rows=eta)
        td = part.to_table_part()

        class SP(ev.SnapshotProvider):
            def data_objects(self, include=None):
                return {part.table: [part, part]}

            def table_schema(self, p):
                return None

            def create_snapshot_source(self, p):
                raise AssertionError

        sp = SP()
        tds = sp.data_objects_to_table_parts()
        back = sp.table_part_to_data_object_part(td)
        assert back == part
        got[pkg] = ((td.id.namespace, td.id.name, td.filter, td.eta_rows),
                    [(t.filter, t.eta_rows) for t in tds],
                    (back.part_key, back.eta_rows))
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_storage_snapshot_source_progress(pkg):
    m = PKG[pkg]
    ev = m["ev"]

    class Store:
        def load_table(self, td, pusher):
            pusher(seeded_columnar(pkg, 1, 30))
            pusher(seeded_items(pkg, 2, 20))

    part = ev.DataObjectPart(table=m["TableID"]("s", "t"), part_key="p",
                             eta_rows=50)
    src = ev.StorageSnapshotSource(Store(), part)
    sink = RecordingSink()
    target = ev.EventTargetOverAsyncSink(sink)
    assert not src.progress().done and not src.running()
    src.start(target)
    p = src.progress()
    rows = 30 + sum(1 for it in seeded_items(pkg, 2, 20)
                    if it.is_row_event())
    assert p.done and p.current == rows and p.total == 50
    src.stop()
    with pytest.raises(RuntimeError, match="stopped"):
        src.start(target)
    target.close()


def test_log_position_compare():
    for lp in (port_events.LogPosition, ref_events.LogPosition):
        a, b = lp(5, ""), lp(7, "lsn-7")
        assert (a.compare(b), b.compare(a), a.compare(a)) == (-1, 1, 0)
        assert (str(a), str(b)) == ("5", "lsn-7")
