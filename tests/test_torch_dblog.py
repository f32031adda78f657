"""The port's DBLog incremental snapshot (`transferia_tpu_torch/dblog/`
and `providers/postgres/dblog.py`) against the JAX package's, on the CPU,
exactly.

- `DBLogSnapshot` over the scenarios of
  `tests/unit/test_incremental_dblog.py::TestDBLog` with the same inputs
  from one numpy seed: chunks deduplicated against live events inside
  their windows (events before, inside and after a window, on keys of
  earlier, current and later chunks), a chunk never trailing a CDC event
  that follows its HIGH watermark, a watermark timeout marked BAD.  Equal
  emitted rows (kinds and values, in order) and equal watermark kind
  sequences; a deduplicated chunk with a one-column key stays columnar
  in the port.
- `tests/e2e/test_pg_dblog_e2e.py`'s transfer (2,500 rows, 1,000-row
  chunks) through `run_replication` on each package's own fake Postgres
  (`echo_dml_to_wal`): with no live write and the mask and a filter in
  the chain, equal target rows in order, equal completion state, no
  signal row, and a restart that snapshots nothing again; with the e2e
  test's live update and insert, equal latest-wins images, every other
  key exactly once.
"""

import concurrent.futures
import hashlib
import hmac
import json
import threading
import time

import numpy as np
import pytest

from tests.recipes.fake_postgres import FakePG as RefFakePG
from tests.recipes.fake_postgres import FakeTable as RefFakeTable
from transferia_tpu.abstract import schema as ref_schema
from transferia_tpu.abstract.change_item import ChangeItem as RefItem
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.dblog import core as ref_core
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import TransferType as RefTransferType
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.postgres import PGSourceParams as RefPGParams
from transferia_tpu.runtime.local import run_replication as ref_run
from transferia_tpu_torch.abstract import schema
from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.dblog import core
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.postgres import PGSourceParams
from transferia_tpu_torch.recipes.fake_postgres import FakePG, FakeTable
from transferia_tpu_torch.runtime.local import run_replication

PKGS = {
    "port": dict(core=core, item=ChangeItem, kind=Kind, batch=ColumnBatch,
                 schema=schema, pg=FakePG, table=FakeTable,
                 params=PGSourceParams, transfer=Transfer,
                 types=TransferType, coordinator=MemoryCoordinator,
                 memory=port_memory, run=run_replication,
                 kw={"device": "cpu"}),
    "jax": dict(core=ref_core, item=RefItem, kind=RefKind, batch=RefBatch,
                schema=ref_schema, pg=RefFakePG, table=RefFakeTable,
                params=RefPGParams, transfer=RefTransfer,
                types=RefTransferType, coordinator=RefCoordinator,
                memory=ref_memory, run=ref_run, kw={}),
}


def rows_of(batch) -> list:
    rows = batch.to_rows() if hasattr(batch, "to_rows") else batch
    return [(r.kind.value, str(r.table_id), r.as_dict()) for r in rows]


# -- DBLogSnapshot -----------------------------------------------------------

def dedup_scenario(pkg: str, seed: int, compound: bool = False) -> dict:
    """The unit test's chunked snapshot over a seeded table, with live
    updates fed at seeded watermarks: right after a LOW (inside the
    window), right after a HIGH (outside), on seeded keys.  `compound`
    keys the table on (id, g), g = id % 3."""
    p = PKGS[pkg]
    rng = np.random.default_rng(seed)
    sch = p["schema"].new_table_schema(
        [("id", "int64", True)] + ([("g", "int64", True)] if compound
                                   else []) + [("v", "utf8")])
    signal_schema = p["schema"].new_table_schema([("mark_id", "utf8", True),
                                                  ("kind", "utf8")])
    tid = p["schema"].TableID("m", "inc")
    ids = np.sort(rng.choice(10_000, 300, replace=False)).tolist()
    chunk_rows = int(rng.integers(20, 60))
    n_marks = 2 * (len(ids) // chunk_rows + 2)
    # watermark index -> keys a live update touches right after it
    live = {int(w): [int(k) for k in rng.choice(ids, rng.integers(1, 6))]
            for w in rng.choice(n_marks, n_marks // 2, replace=False)}

    def load_fn(cursor, limit):
        start = 0 if cursor is None else ids.index(cursor) + 1
        got = ids[start:start + limit]
        if not got:
            return None
        data = {"id": got, "v": [f"old{i}" for i in got]}
        if compound:
            data["g"] = [i % 3 for i in got]
        return p["batch"].from_pydict(tid, sch, data)

    emitted, marks, holder = [], [], {}

    def push(out):
        if out is None or (isinstance(out, list) and not out):
            return
        emitted.append((type(out).__name__ == "ColumnBatch",
                        rows_of(out)))

    def write_fn(mark_id, kind):
        marks.append(kind)
        snap = holder["snap"]
        push(snap.filter_cdc([p["item"](
            kind=p["kind"].INSERT, schema="", table="__transferia_signal",
            column_names=("mark_id", "kind"), column_values=(mark_id, kind),
            table_schema=signal_schema)]))
        for k in live.get(len(marks) - 1, []):
            names, vals = ("id", "v"), (k, f"live{k}-{len(marks)}")
            if compound:
                names, vals = ("id", "g", "v"), (k, k % 3, vals[1])
            push(snap.filter_cdc([p["item"](
                kind=p["kind"].UPDATE, schema="m", table="inc",
                column_names=names, column_values=vals,
                table_schema=sch)]))

    signal = p["core"].StorageSignalTable(write_fn)
    snap = p["core"].DBLogSnapshot(
        signal, p["core"].PagedChunkIterator(load_fn, "id", chunk_rows),
        ["id", "g"] if compound else ["id"])
    holder["snap"] = snap
    total = snap.run(chunk_timeout=5)
    return {"total": total, "marks": marks,
            "emitted": [rows for _, rows in emitted],
            "columnar": [columnar for columnar, rows in emitted
                         if rows and rows[0][0] == "insert"]}


@pytest.mark.parametrize("seed,compound", [(1, False), (2, False),
                                           (3, False), (4, True)])
def test_chunk_dedup_equals_jax(seed, compound):
    """Equal rows in equal order.  A deduplicated chunk with a one-column
    key stays columnar in the port; the JAX package emits its rows as
    ChangeItems, as the port does for a compound key."""
    got = dedup_scenario("port", seed, compound)
    want = dedup_scenario("jax", seed, compound)
    assert {k: v for k, v in got.items() if k != "columnar"} == \
        {k: v for k, v in want.items() if k != "columnar"}
    marks = got["marks"]
    assert marks.count("low") == marks.count("high") and \
        marks[-1] == "success"
    # some window saw a live event (a deduplicated chunk, which the JAX
    # package emits as rows) and some did not (the columnar fast path)
    deduped = want["columnar"].count(False)
    assert deduped and len(want["columnar"]) > deduped
    assert got["columnar"] == (want["columnar"] if compound else
                               [True] * len(want["columnar"]))
    # every key's last version is its last live update, or its chunk copy
    last = {}
    for rows in got["emitted"]:
        for kind, _, vals in rows:
            last[vals["id"]] = vals["v"]
    assert len(last) == 300


def test_chunk_never_trails_post_high_event_equals_jax():
    """A CDC update committed right after HIGH reaches the sink after the
    chunk's copy of its key, in both packages."""
    def run(pkg):
        p = PKGS[pkg]
        sch = p["schema"].new_table_schema([("id", "int64", True),
                                            ("v", "utf8")])
        signal_schema = p["schema"].new_table_schema([
            ("mark_id", "utf8", True), ("kind", "utf8")])
        tid = p["schema"].TableID("m", "inc")
        arrivals, holder = [], {}

        def load_fn(cursor, limit):
            if cursor is not None:
                return None
            return p["batch"].from_pydict(tid, sch, {
                "id": [1, 2, 3], "v": ["old1", "old2", "old3"]})

        def write_fn(mark_id, kind):
            stream = [p["item"](
                kind=p["kind"].INSERT, schema="",
                table="__transferia_signal",
                column_names=("mark_id", "kind"),
                column_values=(mark_id, kind), table_schema=signal_schema)]
            if kind == "high" and not holder.get("emitted"):
                holder["emitted"] = True
                stream.append(p["item"](
                    kind=p["kind"].UPDATE, schema="m", table="inc",
                    column_names=("id", "v"), column_values=(2, "new2"),
                    table_schema=sch))
            out = holder["snap"].filter_cdc(stream)
            if out:
                arrivals.extend(rows_of(out))

        snap = p["core"].DBLogSnapshot(
            p["core"].StorageSignalTable(write_fn),
            p["core"].PagedChunkIterator(load_fn, "id", chunk_rows=8),
            ["id"])
        holder["snap"] = snap
        return snap.run(chunk_timeout=5), arrivals

    got, want = run("port"), run("jax")
    assert got == want
    assert [v["v"] for _, _, v in got[1] if v["id"] == 2] == ["old2",
                                                              "new2"]


def test_watermark_timeout_marks_bad_equals_jax():
    def run(pkg):
        core_mod = PKGS[pkg]["core"]
        written = []
        snap = core_mod.DBLogSnapshot(
            core_mod.StorageSignalTable(lambda i, k: written.append(k)),
            core_mod.PagedChunkIterator(lambda c, n: None, "id"), ["id"])
        with pytest.raises(TimeoutError, match="not observed") as e:
            snap.run(chunk_timeout=0.1)
        return written, str(e.value).split(" watermark ")[0]

    assert run("port") == run("jax") == (["low", "bad"], "low")


def test_signal_table_recognizes_only_its_marks_equals_jax():
    def run(pkg):
        p = PKGS[pkg]
        sig = p["core"].StorageSignalTable(lambda i, k: None)
        sch = p["schema"].new_table_schema([("mark_id", "utf8", True),
                                            ("kind", "utf8")])
        out = []
        for table, vals in (("__transferia_signal", ("a", "high")),
                            ("__transferia_signal", ("b", "nope")),
                            ("other", ("c", "low"))):
            wm = sig.is_watermark(p["item"](
                kind=p["kind"].INSERT, schema="", table=table,
                column_names=("mark_id", "kind"), column_values=vals,
                table_schema=sch))
            out.append(None if wm is None else (wm.id, wm.kind.value))
        return out, str(p["core"].SIGNAL_TABLE)

    assert run("port") == run("jax")
    assert run("port")[0] == [("a", "high"), None, None]


# -- the Postgres transfer ----------------------------------------------------

ROWS, CHUNK = 2_500, 1_000
SALT = "dblog-salt"
CHAIN = {"transformers": [
    {"mask_field": {"columns": ["name"], "salt": SALT}},
    {"filter_rows": {"filter": "region < 40"}}]}
COLUMNS = [("id", "bigint", True, True), ("name", "text", False, False),
           ("region", "integer", False, False)]


def source_rows():
    return [{"id": i, "name": f"n{i}", "region": (i * 7) % 50}
            for i in range(ROWS)]


def dblog_transfer(pkg: str, port: int, sink: str, chain: bool):
    p = PKGS[pkg]
    return p["transfer"](
        id=sink, type=p["types"].INCREMENT_ONLY,
        src=p["params"](host="127.0.0.1", port=port, database="db",
                        user="u", dblog_snapshot=True,
                        dblog_chunk_rows=CHUNK,
                        dblog_tables=["public.big"]),
        dst=p["memory"].MemoryTargetParams(sink_id=sink),
        transformation=CHAIN if chain else None)


def replicate_until(pkg: str, srv, t, cp, done) -> None:
    """run_replication on a thread until `done()`, then stopped through
    its stop event.  The JAX package's source looks at its stop only
    after a WAL message (ROADMAP.md C4): a logical message, which decodes
    to nothing, is fed until its thread ends."""
    p = PKGS[pkg]
    stop = threading.Event()
    th = threading.Thread(target=p["run"], args=(t, cp), kwargs={
        "stop_event": stop, "backoff": 0.1, **p["kw"]}, daemon=True)
    th.start()
    deadline = time.monotonic() + 60
    while not done() and time.monotonic() < deadline:
        time.sleep(0.05)
    # the CDC side settles before the stop (a late push would land after)
    time.sleep(0.3)
    stop.set()
    deadline = time.monotonic() + 30
    while th.is_alive() and time.monotonic() < deadline:
        if pkg == "jax":
            srv.feed_wal(json.dumps({"action": "M"}).encode())
        th.join(0.5)
    assert done() and not th.is_alive()


def quiet_transfer(pkg: str) -> dict:
    """The e2e transfer through the mask and a filter with no live write,
    then the same transfer restarted: nothing snapshots again."""
    p = PKGS[pkg]
    srv = p["pg"](echo_dml_to_wal=True).start()
    try:
        srv.add_table(p["table"]("public", "big", COLUMNS, source_rows()))
        sink = f"dblog-quiet-{pkg}"
        store = p["memory"].get_store(sink)
        store.clear()
        cp = p["coordinator"]()
        t = dblog_transfer(pkg, srv.port, sink, chain=True)
        replicate_until(pkg, srv, t, cp, lambda: cp.get_transfer_state(
            sink).get("pg_dblog_done"))
        rows = rows_of(store.rows())
        batches = len(store.batches)
        marks = [r["kind"] for r in
                 srv.tables[("public", "__transferia_signal")].rows]
        replicate_until(pkg, srv, t, cp, lambda: True)
        state = cp.get_transfer_state(sink)
        return {"rows": rows, "batches": batches, "marks": marks,
                "done": state.get("pg_dblog_done"),
                "after_restart": rows_of(store.rows()),
                "marks_after_restart": len(srv.tables[
                    ("public", "__transferia_signal")].rows)}
    finally:
        srv.stop()


def test_pg_dblog_transfer_equals_jax():
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        port = ex.submit(quiet_transfer, "port")
        ref = ex.submit(quiet_transfer, "jax")
        got, want = port.result(), ref.result()
    assert got == want
    kept = [r for r in source_rows() if r["region"] < 40]
    masked = [{"id": r["id"], "name": hmac.new(
        SALT.encode(), r["name"].encode(), hashlib.sha256).hexdigest(),
        "region": r["region"]} for r in kept]
    assert [v for _, tid, v in got["rows"]] == masked
    assert {tid for _, tid, _ in got["rows"]} == {"public.big"}
    assert got["done"] is True
    # three chunks, then a window whose read finds nothing
    assert got["marks"] == ["low", "high"] * 4 + ["success"]
    assert got["after_restart"] == got["rows"]
    assert got["marks_after_restart"] == len(got["marks"])


def live_transfer(pkg: str) -> dict:
    """The e2e test's run: a live UPDATE of a key of the last chunk and
    a live INSERT while the chunks run."""
    p = PKGS[pkg]
    srv = p["pg"](echo_dml_to_wal=True).start()
    try:
        srv.add_table(p["table"]("public", "big", COLUMNS, source_rows()))
        sink = f"dblog-live-{pkg}"
        store = p["memory"].get_store(sink)
        store.clear()
        cp = p["coordinator"]()
        t = dblog_transfer(pkg, srv.port, sink, chain=False)
        hot = ROWS - 10

        def feed():
            time.sleep(0.3)
            with srv.lock:
                srv.tables[("public", "big")].rows[hot]["name"] = "live-upd"
            srv.feed_wal(json.dumps({
                "action": "U", "schema": "public", "table": "big",
                "columns": [
                    {"name": "id", "type": "bigint", "value": hot},
                    {"name": "name", "type": "text", "value": "live-upd"},
                    {"name": "region", "type": "integer",
                     "value": (hot * 7) % 50}],
                "identity": [{"name": "id", "type": "bigint",
                              "value": hot}],
                "pk": [{"name": "id", "type": "bigint"}]}).encode())
            srv.feed_wal(json.dumps({
                "action": "I", "schema": "public", "table": "big",
                "columns": [
                    {"name": "id", "type": "bigint", "value": ROWS + 7},
                    {"name": "name", "type": "text", "value": "live-ins"},
                    {"name": "region", "type": "integer", "value": 1}],
                "pk": [{"name": "id", "type": "bigint"}]}).encode())

        feeder = threading.Thread(target=feed, daemon=True)
        feeder.start()
        replicate_until(pkg, srv, t, cp, lambda: cp.get_transfer_state(
            sink).get("pg_dblog_done") and store.row_count() >= ROWS + 1)
        feeder.join()
        versions: dict = {}
        for kind, tid, vals in rows_of(store.rows()):
            assert tid == "public.big"
            versions.setdefault(vals["id"], []).append(vals)
        return {"image": {k: v[-1] for k, v in versions.items()},
                "counts": {k: len(v) for k, v in versions.items()},
                "done": cp.get_transfer_state(sink).get("pg_dblog_done"),
                "hot": hot}
    finally:
        srv.stop()


def test_pg_dblog_live_writes_equal_jax():
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        port = ex.submit(live_transfer, "port")
        ref = ex.submit(live_transfer, "jax")
        got, want = port.result(), ref.result()
    # the image is the source's final state in both; how often the hot
    # key landed depends on where its event met the windows
    assert got["image"] == want["image"]
    assert got["done"] is True and want["done"] is True
    hot = got["hot"]
    assert got["image"][hot]["name"] == "live-upd"
    assert got["image"][ROWS + 7]["name"] == "live-ins"
    assert len(got["image"]) == ROWS + 1
    for pkg_got in (got, want):
        assert all(n == 1 for k, n in pkg_got["counts"].items()
                   if k != hot)
        assert pkg_got["counts"][hot] <= 2


def test_chunk_loader_across_copy_blocks_equals_jax():
    """A keyset page larger than one COPY block (1 MiB) comes back as one
    chunk of the same rows as the JAX runner's, page after page."""
    from transferia_tpu.providers.postgres import dblog as ref_dblog
    from transferia_tpu_torch.providers.postgres import dblog

    def run(pkg):
        p = PKGS[pkg]
        mod = dblog if pkg == "port" else ref_dblog
        srv = p["pg"]().start()
        try:
            srv.add_table(p["table"]("public", "wide", COLUMNS, [
                {"id": i, "name": f"{i:06d}" + "x" * 150,
                 "region": i % 50} for i in range(12_000)]))
            runner = mod.PGDBLogRunner(
                p["params"](host="127.0.0.1", port=srv.port),
                "t", None, chunk_rows=7_000)
            tid = p["schema"].TableID("public", "wide")
            schema = runner.storage.table_schema(tid)
            load = runner._chunk_loader(tid, schema, "id")
            pages, cursor = [], None
            while True:
                chunk = load(cursor, 7_000)
                if chunk is None:
                    break
                pages.append(rows_of(chunk))
                cursor = chunk.column("id").value(chunk.n_rows - 1)
            runner.storage.close()
            return pages
        finally:
            srv.stop()

    got = run("port")
    assert got == run("jax")
    assert [len(p) for p in got] == [7_000, 5_000]
