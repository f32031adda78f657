"""The port's freshness watermarks (`transferia_tpu_torch/stats/
watermark.py`) against the JAX package's `stats/watermark.py`.

The same sequences of advances and publishes, on a pinned clock, leave
both packages' `WatermarkMap`s equal: monotone per (transfer, table),
poll watermarks standing in for batches without an event time, the
`replication_lag` histogram, the `~overflow` eviction, the absorbed
`watermark.advance` fault.  `batch_event_ns`, `merge_maps` (over torn
and replayed maps) and `summarize` give equal results.
"""

import numpy as np
import pytest

from transferia_tpu.abstract.change_item import ChangeItem as RefItem
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import new_table_schema as ref_schema
from transferia_tpu.chaos import failpoints as ref_fp
from transferia_tpu.columnar.batch import ColumnBatch as RefBatch
from transferia_tpu.stats import hdr as ref_hdr
from transferia_tpu.stats import watermark as ref_wm
from transferia_tpu_torch.abstract.change_item import ChangeItem
from transferia_tpu_torch.abstract.kinds import Kind
from transferia_tpu_torch.abstract.schema import TableID, new_table_schema
from transferia_tpu_torch.chaos import failpoints as port_fp
from transferia_tpu_torch.columnar.batch import ColumnBatch
from transferia_tpu_torch.stats import hdr as port_hdr
from transferia_tpu_torch.stats import watermark as port_wm

PKG = {
    "jax": (ref_wm, ref_hdr, ref_fp, RefBatch, ref_schema, RefTableID,
            RefItem, RefKind),
    "torch": (port_wm, port_hdr, port_fp, ColumnBatch, new_table_schema,
              TableID, ChangeItem, Kind),
}
NOW_NS = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def clean():
    for wm, hdr, fp, *_ in PKG.values():
        wm.WATERMARKS.reset()
        hdr.STAGES.reset()
        fp.reset()
    yield
    for wm, hdr, fp, *_ in PKG.values():
        wm.WATERMARKS.reset()
        hdr.STAGES.reset()
        fp.reset()


def columnar(pkg: str, seed: int, n: int = 50, commit=True, ts=False):
    _, _, _, batch_cls, schema_fn, tid_cls, _, _ = PKG[pkg]
    rng = np.random.default_rng(seed)
    cols = [("id", "int64", True), ("v", "int32")]
    data = {"id": list(range(n)), "v": rng.integers(0, 9, n).tolist()}
    if ts:
        cols.append(("_timestamp", "int64"))
        data["_timestamp"] = (NOW_NS // 1000
                              - rng.integers(0, 10**6, n)).tolist()
    b = batch_cls.from_pydict(tid_cls("db", "t"), schema_fn(cols), data)
    if commit:
        b.commit_times = (NOW_NS - rng.integers(10**6, 10**9, n)).astype(
            np.int64)
        b.lsns = rng.integers(1, 10**6, n).astype(np.int64)
    return b


def rows(pkg: str, seed: int, n: int = 5):
    *_, item_cls, kind = PKG[pkg]
    rng = np.random.default_rng(seed)
    return [item_cls(kind=kind.INSERT, schema="db", table="r",
                     column_names=("id",), column_values=(i,),
                     lsn=int(rng.integers(1, 1000)),
                     commit_time_ns=NOW_NS - int(rng.integers(1, 10**9)))
            for i in range(n)]


def drive(pkg: str):
    """One sequence of polls, publishes and advances on a pinned clock;
    returns everything the map and the lag histogram hold."""
    wm, hdr, fp, *_ = PKG[pkg]
    m = wm.WatermarkMap(max_tables=4)
    lags = []
    m.advance("tr", f"{wm.POLL_PREFIX}topic:0", event_ns=NOW_NS - 5000,
              origin="poll", now=1.0)
    m.advance("tr", f"{wm.POLL_PREFIX}topic:1", event_ns=NOW_NS - 9000,
              origin="poll", now=1.0)
    for seed in range(3):
        lags.append(m.observe_publish("tr", columnar(pkg, seed),
                                      now_ns=NOW_NS + seed))
    lags.append(m.observe_publish("tr", columnar(pkg, 7, ts=True,
                                                 commit=False),
                                  now_ns=NOW_NS + 9))
    # no event time: the transfer's poll watermark stands in
    lags.append(m.observe_publish("tr", columnar(pkg, 8, commit=False),
                                  now_ns=NOW_NS + 10))
    lags.append(m.observe_publish("tr", rows(pkg, 4), now_ns=NOW_NS + 11))
    # no event time and no poll watermark: liveness only, no lag
    lags.append(m.observe_publish("fresh", columnar(pkg, 9, commit=False),
                                  now_ns=NOW_NS + 12))
    moved = [m.advance("tr", "db.t", event_ns=1, now=0.5),   # regression
             m.advance("tr", "", event_ns=5),                # refused
             m.advance("", "db.t", event_ns=5)]
    for i in range(6):  # past max_tables: evictions into ~overflow
        moved.append(m.advance("big", f"t{i}", event_ns=NOW_NS + i,
                               lsn=i, now=2.0 + i))
    fp.configure("watermark.advance=times:1")
    moved.append(m.advance("tr", "db.t", event_ns=NOW_NS, now=99.0))
    fp.reset()
    return (m.snapshot(), lags, moved, m.advances, m.regressions_skipped,
            m.folded_entries, m.faults_absorbed,
            hdr.STAGES.get(wm.STAGE_LAG).to_json())


def test_map_and_lag_equal_jax():
    got, want = drive("torch"), drive("jax")
    assert got == want
    snap, lags, moved, advances, skipped, folded, absorbed, lag = got
    assert absorbed == 1 and folded > 0 and "~overflow" in snap["big"]
    assert lags[-1] is None and lag["count"] == 6
    assert snap["fresh"]["db.t"]["origin"] == "publish"


@pytest.mark.parametrize("seed", range(3))
def test_batch_event_ns_equal_jax(seed):
    for kw in ({}, {"commit": False}, {"commit": False, "ts": True}):
        assert port_wm.batch_event_ns(columnar("torch", seed, **kw)) == \
            ref_wm.batch_event_ns(columnar("jax", seed, **kw))
    assert port_wm.batch_event_ns(rows("torch", seed)) == \
        ref_wm.batch_event_ns(rows("jax", seed))


def test_merge_maps_and_summarize_equal_jax():
    a, b = drive("jax")[0], drive("torch")[0]
    torn = {"tr": {"db.t": {"event_ns": "junk"}, "x": 5}, 3: None,
            "late": {"db.t": {"event_ns": NOW_NS + 10**12, "lsn": 1}}}
    for maps in ([a], [a, b], [b, torn, a], [torn]):
        got = port_wm.merge_maps(maps)
        assert got == ref_wm.merge_maps(maps)
        assert port_wm.summarize(got, now=NOW_NS / 1e9 + 5) == \
            ref_wm.summarize(got, now=NOW_NS / 1e9 + 5)
    # replays and reordering never regress a watermark
    assert port_wm.merge_maps([a, b, a]) == port_wm.merge_maps([b, a])
