"""The port's ClickHouse staged commit against the JAX package's, on the
CPU, each package against its own fake ClickHouse:

- the fault's pin: a `sample` snapshot into ClickHouse with staged
  commits on lands every row and one `__trtpu_commits` fence row per
  part, and leaves no staging table (the port used to refuse in
  `begin_part`, so the part failed after its retries);
- begin/publish/abort, a stale-epoch publish and a restaged part that
  replaces its earlier publish, driven on the sink directly.

Exact: the fakes' tables (DDL and rows, the hidden part column and the
fence table included) equal the JAX package's.
"""

import numpy as np
import pytest

from tests.recipes.fake_clickhouse import FakeCH as RefFakeCH
from transferia_tpu.abstract.errors import (
    StaleEpochPublishError as RefStale,
)
from transferia_tpu.abstract.schema import CanonicalType as RefCT
from transferia_tpu.abstract.schema import ColSchema as RefCol
from transferia_tpu.abstract.schema import TableID as RefTID
from transferia_tpu.abstract.schema import TableSchema as RefSchema
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.providers.clickhouse import CHTargetParams as RefCH
from transferia_tpu.providers.clickhouse.provider import (
    CHSinker as RefSinker,
)
from transferia_tpu.providers.sample import SampleSourceParams as RefSample
from transferia_tpu.tasks import SnapshotLoader as RefLoader
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.clickhouse.provider import CHSinker
from transferia_tpu_torch.providers.sample import SampleSourceParams
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.tasks import SnapshotLoader

PKGS = {
    "port": dict(fake=FakeCH, transfer=Transfer, sample=SampleSourceParams,
                 ch=CHTargetParams, coordinator=MemoryCoordinator,
                 loader=SnapshotLoader, kw={"device": "cpu"},
                 sinker=lambda p: CHSinker(p, device="cpu"),
                 stale=StaleEpochPublishError, batch=ColumnBatch,
                 tid=TableID, schema=TableSchema, col=ColSchema,
                 ct=CanonicalType),
    "jax": dict(fake=RefFakeCH, transfer=RefTransfer, sample=RefSample,
                ch=RefCH, coordinator=RefCoordinator, loader=RefLoader,
                kw={}, sinker=RefSinker, stale=RefStale, batch=RefBatch,
                tid=RefTID, schema=RefSchema, col=RefCol, ct=RefCT),
}


def ch_state(ch) -> dict:
    return {name: (tb["ddl"], sorted(tuple(sorted(r.items()))
                                     for r in tb["rows"]))
            for name, tb in ch.tables.items()}


def sample_snapshot(pkg: str, rows: int, parts: int) -> dict:
    p = PKGS[pkg]
    ch = p["fake"]().start()
    try:
        t = p["transfer"](
            id="staged", src=p["sample"](preset="users", table="users",
                                         rows=rows, shard_parts=parts),
            dst=p["ch"](host="127.0.0.1", port=ch.port, bufferer=None))
        p["loader"](t, p["coordinator"](), **p["kw"]).upload_tables()
        return ch_state(ch)
    finally:
        ch.stop()


@pytest.mark.parametrize("rows,parts", [(5000, 1), (20000, 4)])
def test_sample_snapshot_staged_lands_rows_and_fences(monkeypatch, rows,
                                                      parts):
    monkeypatch.setenv("TRANSFERIA_TPU_STAGED_COMMIT", "auto")
    got = sample_snapshot("port", rows, parts)
    assert got == sample_snapshot("jax", rows, parts)
    assert not [n for n in got if n.startswith("__trtpu_stg_")]
    _, fence = got["__trtpu_commits"]
    assert len(fence) == parts
    ddl, final = got["sample__users"]
    assert "PARTITION BY `__trtpu_part`" in ddl
    assert len(final) == rows


def _batch(p, seed: int, n: int):
    rng = np.random.default_rng(seed)
    ct = p["ct"]
    schema = p["schema"]([p["col"]("id", ct.INT64, primary_key=True),
                          p["col"]("name", ct.UTF8),
                          p["col"]("score", ct.DOUBLE)])
    data = {"id": [int(v) for v in rng.integers(0, 1 << 40, n)],
            "name": [None if v % 7 == 0 else f"n{v}"
                     for v in rng.integers(0, 1000, n)],
            "score": [float(v) for v in rng.random(n)]}
    return p["batch"].from_pydict(p["tid"]("public", "t"), schema, data)


def drive_sink(pkg: str, script) -> tuple[dict, list]:
    """Run `script` (a list of (op, key, epoch, seed)) on one sinker;
    returns the fake's state and each op's outcome."""
    p = PKGS[pkg]
    ch = p["fake"]().start()
    outcomes = []
    try:
        sink = p["sinker"](p["ch"](host="127.0.0.1", port=ch.port,
                                   bufferer=None))
        try:
            for op, key, epoch, seed in script:
                try:
                    if op == "begin":
                        out = sink.begin_part(key, epoch)
                    elif op == "push":
                        out = sink.push(_batch(p, seed, 50 + seed))
                    elif op == "publish":
                        out = sink.publish_part(key, epoch)
                    else:
                        out = sink.abort_part(key)
                    outcomes.append(out)
                except p["stale"] as e:
                    outcomes.append(("stale", e.key, e.epoch,
                                     e.published_epoch))
        finally:
            sink.close()
        return ch_state(ch), outcomes
    finally:
        ch.stop()


SCRIPTS = {
    "begin_publish": [("begin", "op/p0", 1, 0), ("push", "", 0, 1),
                      ("push", "", 0, 2), ("publish", "op/p0", 1, 0)],
    "abort": [("begin", "op/p0", 1, 0), ("push", "", 0, 1),
              ("abort", "op/p0", 1, 0)],
    "two_parts": [("begin", "op/p0", 1, 0), ("push", "", 0, 1),
                  ("publish", "op/p0", 1, 0), ("begin", "op/p1", 1, 0),
                  ("push", "", 0, 2), ("publish", "op/p1", 1, 0)],
    "restage_replaces": [("begin", "op/p0", 1, 0), ("push", "", 0, 1),
                         ("publish", "op/p0", 1, 0),
                         ("begin", "op/p0", 2, 0), ("push", "", 0, 3),
                         ("publish", "op/p0", 2, 0)],
    "stale_epoch": [("begin", "op/p0", 3, 0), ("push", "", 0, 1),
                    ("publish", "op/p0", 3, 0), ("begin", "op/p0", 2, 0),
                    ("push", "", 0, 2), ("publish", "op/p0", 2, 0),
                    ("abort", "op/p0", 2, 0)],
    "crashed_epoch_swept": [("begin", "op/p0", 1, 0), ("push", "", 0, 1),
                            ("begin", "op/p0", 2, 0), ("push", "", 0, 2),
                            ("publish", "op/p0", 2, 0)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_staged_sink_equals_jax(name):
    got, outcomes = drive_sink("port", SCRIPTS[name])
    want, want_outcomes = drive_sink("jax", SCRIPTS[name])
    assert got == want
    assert outcomes == want_outcomes
    assert not [n for n in got if n.startswith("__trtpu_stg_")]


def test_restaged_part_replaces_and_stale_publish_raises():
    state, out = drive_sink("port", SCRIPTS["restage_replaces"])
    # only the second stage's rows (seed 3: 53 rows) stand
    _, rows = state["public__t"]
    assert len(rows) == 53
    assert out[2] == 51 and out[5] == 53
    _, fence = state["__trtpu_commits"]
    assert sorted(dict(r)["epoch"] for r in fence) == [1, 2]
    state, out = drive_sink("port", SCRIPTS["stale_epoch"])
    assert out[5] == ("stale", "op/p0", 2, 3)
    _, rows = state["public__t"]
    assert len(rows) == 51


def test_sharded_target_keeps_at_least_once():
    sink = CHSinker(CHTargetParams(shards={"a": ["h:1"]}), device="cpu")
    assert sink.staged_commit_available()
    sink.close()
    with pytest.raises(NotImplementedError):
        CHSinker(CHTargetParams(shards={"a": ["h:1"], "b": ["h:2"]}),
                 device="cpu")
