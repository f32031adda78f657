"""The MVCC staging store and SNAPSHOT_AND_INCREMENT (the port's `mvcc/`,
`abstract/mvccfence.py`, the coordinator's control plane and
`activate_delivery`'s S&I branch) against the JAX package's, on the CPU.

Every scenario of the JAX package's own `tests/unit/test_mvcc_{
coordinator,store,pump,runner}.py` that the port covers runs through
both packages on equal inputs (made from literals or a numpy seed), the
port with `device="cpu"` (its keys are K10's plain version there).  Held
equal, exactly: the coordinator's decisions and control docs (their
wall-clock stamps aside), merged images (per source batch: columns,
kinds, LSNs), compaction results, content keys, the pump's layers and
offsets, `resume_state` and the published sinks.  The fleet-ticket,
spill-rebuild and chaos cases become tests that the port raises and
names the item that owns the part.
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from transferia_tpu.abstract import mvccfence as ref_fence
from transferia_tpu.abstract.kinds import KIND_CODES as REF_KINDS
from transferia_tpu.abstract.kinds import Kind as RefKind
from transferia_tpu.abstract.schema import CanonicalType as RefCT
from transferia_tpu.abstract.schema import ColSchema as RefColSchema
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.abstract.schema import TableSchema as RefTableSchema
from transferia_tpu.abstract.schema import (
    new_table_schema as ref_new_schema,
)
from transferia_tpu.abstract.table import (
    OperationTablePart as RefPart,
)
from transferia_tpu.columnar import batch as ref_batch
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import TransferType as RefTransferType
from transferia_tpu.mvcc import compact as ref_compact
from transferia_tpu.mvcc import pump as ref_pump
from transferia_tpu.mvcc import runner as ref_runner
from transferia_tpu.mvcc import store as ref_store
from transferia_tpu.parsers.base import Message as RefMessage
from transferia_tpu.parsers.base import ParseResult as RefParseResult
from transferia_tpu.providers.memory import (
    MemoryTargetParams as RefMemTarget,
)
from transferia_tpu.providers.memory import get_store as ref_get_store
from transferia_tpu.providers.queue_common import (
    FetchedBatch as RefFetched,
)
from transferia_tpu.providers.sample import (
    SampleSourceParams as RefSampleParams,
)
from transferia_tpu.providers.staging import (
    StaleEpochPublishError as RefStale,
)
from transferia_tpu.stats.trace import TELEMETRY as REF_TELEMETRY
from transferia_tpu.tasks import activate_delivery as ref_activate
from transferia_tpu_torch.abstract import mvccfence
from transferia_tpu_torch.abstract import ticket as port_ticket
from transferia_tpu_torch.abstract.errors import StaleEpochPublishError
from transferia_tpu_torch.abstract.kinds import KIND_CODES, Kind
from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    ColSchema,
    TableID,
    TableSchema,
    new_table_schema,
)
from transferia_tpu_torch.abstract.table import OperationTablePart
from transferia_tpu_torch.columnar import batch as port_batch
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.mvcc import compact as port_compact
from transferia_tpu_torch.mvcc import pump as port_pump
from transferia_tpu_torch.mvcc import runner as port_runner
from transferia_tpu_torch.mvcc import store as port_store
from transferia_tpu_torch.parsers.base import Message, ParseResult
from transferia_tpu_torch.providers.memory import (
    MemoryTargetParams,
    get_store,
)
from transferia_tpu_torch.providers.queue_common import FetchedBatch
from transferia_tpu_torch.providers.sample import SampleSourceParams
from transferia_tpu_torch.stats.trace import TELEMETRY
from transferia_tpu_torch.tasks import activate_delivery

CPU = "cpu"


def _port_store(scope, coordinator=None, metrics=None):
    return port_store.MvccStore(scope, coordinator, metrics, device=CPU)


PKG = {
    "port": SimpleNamespace(
        fence=mvccfence, Store=_port_store, store_mod=port_store,
        compact=port_compact, pump=port_pump, runner=port_runner,
        cp=MemoryCoordinator, batch=port_batch, CT=CanonicalType,
        ColSchema=ColSchema, TableID=TableID, TableSchema=TableSchema,
        new_schema=new_table_schema, KINDS=KIND_CODES, Kind=Kind,
        Stale=StaleEpochPublishError, Part=OperationTablePart,
        Fetched=FetchedBatch, Message=Message, ParseResult=ParseResult,
        Transfer=Transfer, TransferType=TransferType,
        Sample=SampleSourceParams, MemTarget=MemoryTargetParams,
        get_store=get_store, activate=activate_delivery,
        kw={"device": CPU}, telemetry=TELEMETRY),
    "jax": SimpleNamespace(
        fence=ref_fence, Store=ref_store.MvccStore, store_mod=ref_store,
        compact=ref_compact, pump=ref_pump, runner=ref_runner,
        cp=RefCoordinator, batch=ref_batch, CT=RefCT,
        ColSchema=RefColSchema, TableID=RefTableID,
        TableSchema=RefTableSchema, new_schema=ref_new_schema,
        KINDS=REF_KINDS, Kind=RefKind, Stale=RefStale, Part=RefPart,
        Fetched=RefFetched, Message=RefMessage,
        ParseResult=RefParseResult, Transfer=RefTransfer,
        TransferType=RefTransferType, Sample=RefSampleParams,
        MemTarget=RefMemTarget, get_store=ref_get_store,
        activate=ref_activate, kw={}, telemetry=REF_TELEMETRY),
}


@pytest.fixture(autouse=True)
def _no_spill(monkeypatch):
    """The JAX package spills its landings through pyarrow when it can;
    the port takes the reference's route without pyarrow.  The
    reference's own kill switch puts it on that route here, so both
    packages keep layers in memory and their control docs compare."""
    monkeypatch.setenv("TRANSFERIA_TPU_MVCC_SPILL", "0")


def both(fn):
    """fn(pkg namespace) in both packages; the port's result."""
    port, ref = fn(PKG["port"]), fn(PKG["jax"])
    assert port == ref
    return port


_STAMPS = ("admitted_at", "sealed_at", "recorded_at")


def unstamped(x):
    """A control doc or decision without its wall-clock stamps."""
    if isinstance(x, dict):
        return {k: unstamped(v) for k, v in x.items() if k not in _STAMPS}
    if isinstance(x, list):
        return [unstamped(v) for v in x]
    return x


# -- the coordinator's control plane (test_mvcc_coordinator.py) -------------

SCOPE = "mvcc/t1"


def layer(worker="w0", seq=0, lsn_min=100, lsn_max=110, rows=8,
          table="s.t", content_key="abc"):
    return {"worker": worker, "seq": seq, "table": table,
            "lsn_min": lsn_min, "lsn_max": lsn_max, "rows": rows,
            "content_key": content_key}


def cp_supports(p, cp):
    return [cp.supports_mvcc(), cp.supports_mvcc_blobs(),
            cp.mvcc_state(SCOPE)]


def cp_admit_and_state(p, cp):
    out = [cp.mvcc_admit_layer(SCOPE, layer(seq=0)),
           cp.mvcc_admit_layer(SCOPE, layer(seq=1, lsn_min=111,
                                            lsn_max=120))]
    st = cp.mvcc_state(SCOPE)
    assert [(x["worker"], x["seq"]) for x in st["layers"]] == \
        [("w0", 0), ("w0", 1)] and st["watermark"] == 120
    return out + [st]


def cp_replace_keeps_order(p, cp):
    cp.mvcc_admit_layer(SCOPE, layer(seq=0))
    cp.mvcc_admit_layer(SCOPE, layer(seq=1, lsn_max=120))
    d = cp.mvcc_admit_layer(SCOPE, layer(seq=0, content_key="xyz"))
    assert d["status"] == p.fence.REPLACED
    st = cp.mvcc_state(SCOPE)
    assert [(x["seq"], x["content_key"]) for x in st["layers"]] == \
        [(0, "xyz"), (1, "abc")]
    return [d, st]


def cp_cutover_first_wins(p, cp):
    cp.mvcc_admit_layer(SCOPE, layer(seq=0, lsn_max=115))
    out = [cp.mvcc_cutover(SCOPE, 115, 2), cp.mvcc_cutover(SCOPE, 115, 2),
           cp.mvcc_cutover(SCOPE, 999, 3)]
    assert out[0] == {"granted": True, "first": True, "watermark": 115,
                      "epoch": 2, "offsets": {}}
    assert out[1]["granted"] and not out[1]["first"]
    assert not out[2]["granted"] and (out[2]["watermark"],
                                      out[2]["epoch"]) == (115, 2)
    return out


def cp_zombie_after_cutover(p, cp):
    """A worker that went quiet before the cutover publishes after it: a
    NEW (worker, seq) is fenced, a re-put of an admitted key acks."""
    cp.mvcc_admit_layer(SCOPE, layer(worker="w0", seq=0))
    cp.mvcc_cutover(SCOPE, 110, 2, offsets={"t:0": 7})
    z = cp.mvcc_admit_layer(SCOPE, layer(worker="w-zombie", seq=0,
                                         lsn_min=200, lsn_max=210))
    dup = cp.mvcc_admit_layer(SCOPE, layer(worker="w0", seq=0))
    assert z["status"] == p.fence.FENCED
    assert dup["status"] == p.fence.DUPLICATE
    st = cp.mvcc_state(SCOPE)
    assert len(st["layers"]) == 1 and st["watermark"] == 110
    return [z, dup, st]


def cp_prune_idempotent(p, cp):
    for seq in range(3):
        cp.mvcc_admit_layer(SCOPE, layer(seq=seq))
    out = [cp.mvcc_prune_layers(SCOPE, [("w0", 0), ("w0", 1)]),
           cp.mvcc_prune_layers(SCOPE, [("w0", 0), ("w0", 1)]),
           cp.mvcc_prune_layers("mvcc/other", [("w0", 0)]),
           cp.mvcc_state(SCOPE)]
    assert out[:3] == [2, 0, 0]
    return out


def cp_scopes_isolated(p, cp):
    cp.mvcc_admit_layer("mvcc/a", layer(seq=0))
    cp.mvcc_cutover("mvcc/a", 110, 2)
    st = cp.mvcc_state("mvcc/b")
    d = cp.mvcc_admit_layer("mvcc/b", layer(seq=0))
    assert st["layers"] == [] and st["cutover"] is None
    return [st, d]


def cp_decision_landed(p, cp):
    return [cp.mvcc_admit_layer(SCOPE, layer(seq=5)),
            cp.mvcc_admit_layer(SCOPE, layer(seq=5))]


def cp_bases(p, cp):
    """The manifest's base records under the epoch rule (an exclusive
    record evicts its table's others)."""
    rec = {"table": "s.t", "part": "p0", "epoch": 2, "rows": 3,
           "content_key": "k", "locator": "L0"}
    out = [cp.mvcc_record_base(SCOPE, rec),
           cp.mvcc_record_base(SCOPE, dict(rec, epoch=1)),
           cp.mvcc_record_base(SCOPE, dict(rec, epoch=3)),
           cp.mvcc_record_base(SCOPE, dict(rec, part="p1", locator="L1")),
           cp.mvcc_record_base(SCOPE, dict(rec, part="__c__", epoch=4,
                                           locator="L2", exclusive=True)),
           cp.mvcc_state(SCOPE)]
    return out


@pytest.mark.parametrize("scenario", [
    cp_supports, cp_admit_and_state, cp_replace_keeps_order,
    cp_cutover_first_wins, cp_zombie_after_cutover, cp_prune_idempotent,
    cp_scopes_isolated, cp_decision_landed, cp_bases],
    ids=lambda f: f.__name__)
def test_coordinator_control_plane_equals_jax(scenario):
    """Each decision and control doc of the port's MemoryCoordinator
    equals the JAX package's on the same calls, exactly (stamps aside)."""
    both(lambda p: unstamped(scenario(p, p.cp())))


def test_fence_helpers_equal_jax():
    """The dict-form helpers on one doc, call by call (exact)."""
    def run(p):
        doc, now, out = p.fence.new_mvcc_doc(), 5.0, []
        out.append(p.fence.admit_layer_in_place(doc, dict(
            layer(), offsets={"t:0": 3}), now))
        out.append(p.fence.admit_layer_in_place(doc, layer(seq=1), now))
        out.append(p.fence.doc_offsets(doc))
        out.append(p.fence.cutover_in_place(doc, 110, 1, now, {"t:0": 3}))
        out.append(p.fence.admit_layer_in_place(doc, layer(seq=9), now))
        out.append(p.fence.prune_layers_in_place(doc, [("w0", 1)]))
        out.append(p.fence.state_view(doc))
        out.append(p.fence.state_view(None))
        return out
    both(run)


# -- the store (test_mvcc_store.py) ------------------------------------------

TABLE = "s.t"


def mk_batch(p, ids, vals, kinds=None, lsns=None, tid=None):
    schema = p.new_schema([("id", "int64", True), ("val", "utf8")])
    kw = {}
    if kinds is not None:
        kw["kinds"] = np.asarray([p.KINDS[getattr(p.Kind, k)]
                                  for k in kinds], dtype=np.int8)
    if lsns is not None:
        kw["lsns"] = np.asarray(lsns, dtype=np.int64)
    return p.batch.ColumnBatch.from_pydict(
        tid or p.TableID("s", "t"), schema,
        {"id": list(ids), "val": list(vals)}, **kw)


def image(batches):
    """A merged read, source by source: columns, kinds and LSNs."""
    return [(b.to_pydict(),
             None if b.kinds is None else b.kinds.tolist(),
             None if b.lsns is None else b.lsns.tolist())
            for b in batches]


def rows_of(batches):
    """{id: val}, each id once."""
    out = {}
    for b in batches:
        d = b.to_pydict()
        for i, v in zip(d["id"], d["val"]):
            assert i not in out, f"duplicate id {i} across sources"
            out[i] = v
    return out


def seeded(p, **kw):
    st = p.Store("mvcc/test", **kw)
    st.put_base(TABLE, "p0", 1, [mk_batch(p, [1, 2, 3], ["a", "b", "c"])])
    return st


def st_base_only(p):
    return image(seeded(p).read_at(TABLE))


def st_kinds(p):
    st = seeded(p)
    st.append_delta(TABLE, "w0", 0, [mk_batch(
        p, [4, 2, 3], ["d", "B", "c"], kinds=["INSERT", "UPDATE", "DELETE"],
        lsns=[100, 101, 102])])
    assert rows_of(st.read_at(TABLE)) == {1: "a", 2: "B", 4: "d"}
    return image(st.read_at(TABLE))


def st_later_layer_wins(p):
    st = seeded(p)
    st.append_delta(TABLE, "w0", 0, [mk_batch(p, [2], ["x"], ["UPDATE"],
                                              [100])])
    st.append_delta(TABLE, "w1", 0, [mk_batch(p, [2], ["y"], ["UPDATE"],
                                              [105])])
    assert rows_of(st.read_at(TABLE))[2] == "y"
    return image(st.read_at(TABLE))


def st_out_of_order_lsns(p):
    st = seeded(p)
    st.append_delta(TABLE, "w0", 0, [mk_batch(
        p, [2, 2, 2], ["late", "early", "mid"], ["UPDATE"] * 3,
        [107, 103, 105])])
    got = [rows_of(st.read_at(TABLE, watermark=w))[2]
           for w in (None, 105, 103)]
    assert got == ["late", "mid", "early"]
    return [image(st.read_at(TABLE, watermark=w)) for w in (None, 105, 103)]


def st_same_lsn_tie(p):
    st = seeded(p)
    st.append_delta(TABLE, "w0", 0, [mk_batch(
        p, [2, 2], ["first", "second"], ["UPDATE"] * 2, [100, 100])])
    assert rows_of(st.read_at(TABLE))[2] == "second"
    return image(st.read_at(TABLE))


def st_delete_then_reinsert(p):
    st = seeded(p)
    st.append_delta(TABLE, "w0", 0, [mk_batch(
        p, [1, 1], ["", "A2"], ["DELETE", "INSERT"], [100, 110])])
    assert rows_of(st.read_at(TABLE))[1] == "A2"
    assert 1 not in rows_of(st.read_at(TABLE, watermark=105))
    return [image(st.read_at(TABLE)), image(st.read_at(TABLE, 105))]


def st_multi_part_base(p):
    st = p.Store("mvcc/test")
    st.put_base(TABLE, "p0", 1, [mk_batch(p, [1], ["a"])])
    st.put_base(TABLE, "p1", 1, [mk_batch(p, [2], ["b"])])
    st.append_delta(TABLE, "w0", 0, [mk_batch(p, [2], ["B"], ["UPDATE"],
                                              [100])])
    assert rows_of(st.read_at(TABLE)) == {1: "a", 2: "B"}
    return [image(st.read_at(TABLE)), seeded(p).read_at("s.other")]


def st_pre_mid_post(p):
    st = seeded(p)
    st.append_delta(TABLE, "w0", 0, [mk_batch(p, [2], ["B1"], ["UPDATE"],
                                              [100])])
    st.append_delta(TABLE, "w0", 1, [mk_batch(p, [2], ["B2"], ["UPDATE"],
                                              [200])])
    out = [rows_of(st.read_at(TABLE, watermark=w)) for w in (50, 150)]
    out.append(rows_of(st.read_at(TABLE)))
    d = st.cutover(epoch=2)
    z = st.append_delta(TABLE, "w9", 0, [mk_batch(p, [2], ["Z"], ["UPDATE"],
                                                  [300])])
    assert d["granted"] and d["watermark"] == 200
    assert z["status"] == "fenced"
    assert rows_of(st.read_at(TABLE))[2] == "B2"
    return out + [d, unstamped(z), image(st.read_at(TABLE)),
                  st.stats.m.value("mvcc_layers_fenced")]


def st_cutover_against_coordinator(p):
    cp = p.cp()
    st = p.Store("mvcc/cp", cp)
    st.put_base(TABLE, "p0", 1, [mk_batch(p, [1], ["a"])])
    st.append_delta(TABLE, "w0", 0, [mk_batch(p, [1], ["A"], ["UPDATE"],
                                              [100])])
    d = st.cutover(epoch=2)
    st2 = p.Store("mvcc/cp", cp)
    assert st2.sealed() == (100, 2)
    return [d, st2.sealed(), st2.cutover(epoch=3),
            unstamped(cp.mvcc_state("mvcc/cp"))]


def st_append_retry_replaces(p):
    st = seeded(p)
    b = [mk_batch(p, [2], ["B"], ["UPDATE"], [100])]
    out = [st.append_delta(TABLE, "w0", 0, b)["status"],
           st.append_delta(TABLE, "w0", 0, b)["status"],
           st.layer_count(TABLE), image(st.read_at(TABLE))]
    assert out[:3] == ["admitted", "replaced", 1]
    return out


def st_zombie_base_fenced(p):
    st = p.Store("mvcc/test")
    st.put_base(TABLE, "p0", 2, [mk_batch(p, [1], ["a"])])
    with pytest.raises(p.Stale):
        st.put_base(TABLE, "p0", 1, [mk_batch(p, [1], ["old"])])
    st.put_base(TABLE, "p0", 2, [mk_batch(p, [1], ["a2"])])
    return image(st.read_at(TABLE))


def layered(p, cp=None):
    st = seeded(p) if cp is None else p.Store("mvcc/cpx", cp)
    if cp is not None:
        st.put_base(TABLE, "p0", 1, [mk_batch(p, [1, 2, 3],
                                              ["a", "b", "c"])])
    st.append_delta(TABLE, "w0", 0, [mk_batch(
        p, [4, 2], ["d", "B"], ["INSERT", "UPDATE"], [100, 101])])
    st.append_delta(TABLE, "w0", 1, [mk_batch(p, [3], [""], ["DELETE"],
                                              [110])])
    st.append_delta(TABLE, "w1", 0, [mk_batch(p, [5], ["e"], ["INSERT"],
                                              [120])])
    return st


def st_compaction_equivalence(p):
    st = layered(p)
    before = image(st.read_at(TABLE))
    res = p.compact.compact_table(st, TABLE)
    assert rows_of(st.read_at(TABLE)) == {1: "a", 2: "B", 4: "d", 5: "e"}
    return [before, res, st.layer_count(TABLE), image(st.read_at(TABLE))]


def st_partial_fold(p):
    st = layered(p)
    at_110 = image(st.read_at(TABLE, watermark=110))
    res = p.compact.compact_table(st, TABLE, watermark=110)
    assert res["folded"] == [("w0", 0), ("w0", 1)]
    return [at_110, res, st.layer_count(TABLE),
            image(st.read_at(TABLE, watermark=110)),
            image(st.read_at(TABLE))]


def st_compaction_prunes_doc(p):
    cp = p.cp()
    st = layered(p, cp)
    res = p.compact.compact_table(st, TABLE)
    assert cp.mvcc_state("mvcc/cpx")["layers"] == []
    return [res, unstamped(cp.mvcc_state("mvcc/cpx"))]


def st_compaction_rerun(p):
    st = layered(p)
    want = image(st.read_at(TABLE))
    out = [p.compact.compact_table(st, TABLE),
           p.compact.compact_table(st, TABLE)]
    assert rows_of(st.read_at(TABLE)) == rows_of_image(want)
    return out + [image(st.read_at(TABLE))]


def rows_of_image(img):
    out = {}
    for cols, _, _ in img:
        out.update(zip(cols["id"], cols["val"]))
    return out


def st_should_compact(p):
    st = layered(p)
    env = p.store_mod.ENV_COMPACT_MIN_LAYERS
    return [p.compact.should_compact(st, TABLE, environ={env: "3"}),
            p.compact.should_compact(st, TABLE, environ={env: "4"}),
            p.compact.should_compact(st, TABLE, environ={})]


def st_knobs(p):
    m = p.store_mod
    return [m.compact_min_layers(environ={}),
            m.compact_min_layers(environ={m.ENV_COMPACT_MIN_LAYERS: "9"}),
            m.compact_min_layers(environ={m.ENV_COMPACT_MIN_LAYERS: "0"}),
            m.max_layer_rows(environ={m.ENV_MAX_LAYER_ROWS: "64"}),
            m.max_layer_rows(environ={}), m.DEFAULT_MAX_LAYER_ROWS]


def st_content_key(p):
    ck = p.store_mod.content_key
    a = mk_batch(p, [1, 2], ["a", "b"], ["INSERT"] * 2, [100, 101])
    b = mk_batch(p, [2, 1], ["b", "a"], ["INSERT"] * 2, [101, 100])
    c = mk_batch(p, [3], ["c"], ["INSERT"], [102])
    kw = {"device": CPU} if p is PKG["port"] else {}
    out = [ck([a], **kw), ck([b], **kw), ck([a, c], **kw), ck([], **kw)]
    assert out[0] == out[1] and out[0] != out[2]
    return out


def st_keyless(p):
    schema = p.TableSchema((p.ColSchema("x", p.CT.INT64),
                            p.ColSchema("y", p.CT.UTF8)))
    assert p.store_mod.pk_column_names(schema) == ["x", "y"]
    tid = p.TableID("s", "nokey")
    st = p.Store("mvcc/nokey")
    st.put_base(str(tid), "p0", 1, [p.batch.ColumnBatch.from_pydict(
        tid, schema, {"x": [1, 1], "y": ["a", "b"]})])
    st.append_delta(str(tid), "w0", 0, [p.batch.ColumnBatch.from_pydict(
        tid, schema, {"x": [1], "y": ["a"]},
        kinds=np.asarray([p.KINDS[p.Kind.INSERT]], dtype=np.int8),
        lsns=np.asarray([100], dtype=np.int64))])
    merged = st.read_at(str(tid))
    assert sum(b.n_rows for b in merged) == 2
    return image(merged)


def st_watermark_and_stats(p):
    st = seeded(p)
    out = [st.watermark()]
    st.append_delta(TABLE, "w0", 0, [mk_batch(p, [2], ["B"], ["UPDATE"],
                                              [100])])
    st.cutover(epoch=1)
    return out + [st.watermark(), st.tables(), st.sealed()] + [
        st.stats.m.value(n) for n in (
            "mvcc_base_versions", "mvcc_base_rows", "mvcc_delta_layers",
            "mvcc_delta_rows", "mvcc_cutovers", "mvcc_live_layers",
            "mvcc_watermark_lag")]


STORE_SCENARIOS = [
    st_base_only, st_kinds, st_later_layer_wins, st_out_of_order_lsns,
    st_same_lsn_tie, st_delete_then_reinsert, st_multi_part_base,
    st_pre_mid_post, st_cutover_against_coordinator,
    st_append_retry_replaces, st_zombie_base_fenced,
    st_compaction_equivalence, st_partial_fold, st_compaction_prunes_doc,
    st_compaction_rerun, st_should_compact, st_knobs, st_content_key,
    st_keyless, st_watermark_and_stats]


@pytest.mark.parametrize("scenario", STORE_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_store_equals_jax(scenario):
    """Merged images (per source: columns, kinds, LSNs), decisions,
    compaction results and counters equal the JAX package's, exactly."""
    both(scenario)


def test_oversize_layer_rejected(monkeypatch):
    """A layer above TRANSFERIA_TPU_MVCC_MAX_LAYER_ROWS raises in both
    packages and admits nothing (exact)."""
    monkeypatch.setenv(port_store.ENV_MAX_LAYER_ROWS, "4")
    for p in PKG.values():
        st = seeded(p)
        with pytest.raises(p.store_mod.OversizeLayerError):
            st.append_delta(TABLE, "w0", 0, [mk_batch(
                p, range(5), ["x"] * 5, ["INSERT"] * 5, range(100, 105))])
        assert st.layer_count(TABLE) == 0


def dict_store(p, n=512):
    """A dict-heavy table: `seg` is a shared-pool code column on both the
    base and the delta layer (numpy-seeded ids)."""
    vals = [b"alpha", b"beta", b"gamma"]
    pool = p.batch.DictPool(
        np.frombuffer(b"".join(vals), dtype=np.uint8).copy(),
        p.batch._offsets_from_lengths([len(v) for v in vals]))
    schema = p.TableSchema((p.ColSchema("id", p.CT.INT64, primary_key=True),
                            p.ColSchema("seg", p.CT.UTF8)))
    tid = p.TableID("s", "t")

    def mk(ids, codes, **kw):
        return p.batch.ColumnBatch(tid, schema, {
            "id": p.batch.Column("id", p.CT.INT64,
                                 np.asarray(ids, dtype=np.int64)),
            "seg": p.batch.Column("seg", p.CT.UTF8, dict_enc=p.batch.DictEnc(
                np.asarray(codes, dtype=np.int32), pool=pool)),
        }, **kw)

    ids = np.random.default_rng(5).permutation(n)
    st = p.Store("mvcc/dict")
    st.put_base(TABLE, "p0", 1, [mk(ids, ids % 3)])
    upd = np.arange(0, n, 7)
    st.append_delta(TABLE, "w0", 0, [mk(
        upd, (upd + 1) % 3,
        kinds=np.full(len(upd), p.KINDS[p.Kind.UPDATE], dtype=np.int8),
        lsns=np.arange(100, 100 + len(upd), dtype=np.int64))])
    return st, n


@pytest.mark.parametrize("compact", [False, True])
def test_dict_columns_stay_encoded(compact):
    """The merge (and a compaction) hands dictionary columns back still
    code-encoded, no flat materialization, and equal to the JAX
    package's; the merged int64 ids keep their dtype (exact)."""
    def run(p):
        st, n = dict_store(p)
        p.telemetry.reset()
        if compact:
            p.compact.compact_table(st, TABLE)
        merged = st.read_at(TABLE)
        assert sum(b.n_rows for b in merged) == n
        assert all(b.column("seg").is_lazy_dict for b in merged)
        assert p.telemetry.snapshot()["dict_flat_materializations"] == 0
        assert all(b.column("id").data.dtype == np.int64 for b in merged)
        return [([c.tolist() for c in (b.column("id").data,
                                       b.column("seg").dict_enc.indices)],
                 b.kinds.tolist() if b.kinds is not None else None)
                for b in merged]
    both(run)


def test_registry_and_left_out_parts():
    """The registry resolves registered scopes; a miss stays a miss, as
    the reference's is without pyarrow.  The spill rebuild raises and
    names its ROADMAP item; the compaction ticket equals the JAX
    package's (exact), and the runner on a scope the process does not
    hold raises, naming the spill it would rebuild from."""
    st = register = port_store.register_store(_port_store("mvcc/reg"))
    assert port_store.resolve_store("mvcc/reg") is st is register
    port_store.unregister_store("mvcc/reg")
    assert port_store.resolve_store("mvcc/reg", MemoryCoordinator()) is None
    assert not st.spilling()
    with pytest.raises(NotImplementedError, match="pyarrow.*A7"):
        port_store.rebuild_store("mvcc/reg", MemoryCoordinator())
    # too few layers to be worth a compaction: nothing enqueued
    assert port_compact.enqueue_compaction(MemoryCoordinator(), "fleet", st,
                                           TABLE) is None
    runner = port_compact.make_compact_runner(port_store.resolve_store)
    with pytest.raises(RuntimeError, match="no MVCC store.*pyarrow"):
        runner(port_compact.compaction_ticket("mvcc/reg", TABLE, 1), None)
    got = port_compact.compaction_ticket("mvcc/x", "s.t", 100, "t1")
    want = ref_compact.compaction_ticket("mvcc/x", "s.t", 100, "t1")
    assert got.to_json() == want.to_json()
    assert port_ticket.FleetTicket.from_json(want.to_json()).to_json() == \
        want.to_json()


def test_ticket_helpers_equal_jax():
    """The ticket's dict-form helpers, call by call (exact; the wall
    clock passed in)."""
    from transferia_tpu.abstract import ticket as ref_ticket

    def run(t):
        d = t.FleetTicket("a", qos="scavenger", seq=3).to_json()
        out = [t.ticket_claimable(d, 10.0)]
        t.claim_in_place(d, "w1", 5.0, now=10.0)
        out += [dict(d), t.ticket_lease_expired(d, 14.0),
                t.ticket_lease_expired(d, 16.0),
                t.ticket_claimable(d, 16.0)]
        tk = t.FleetTicket.from_json(d)
        out += [t.fence_matches(d, tk)]
        t.revoke_in_place(d)
        out += [dict(d), t.fence_matches(d, tk), t.sort_key(d),
                t.ticket_expired(d, 1.0, 100.0)]
        t.release_in_place(d, failed=True)
        out += [dict(d)]
        return out
    assert run(port_ticket) == run(ref_ticket)


# -- the pump (test_mvcc_pump.py) --------------------------------------------

TOPIC = "events"
PARSER = {"json": {
    "schema": [
        {"name": "id", "type": "int64", "key": True},
        {"name": "payload", "type": "utf8"},
        {"name": "amount", "type": "double"},
    ],
    "table": "pump_events",
    "namespace": "mqtest",
    "add_system_cols": False,
}}
PUMP_TABLE = "mqtest.pump_events"


def feed_messages(n=40):
    """Insert ids 0..n/2-1, then update every one of them: the final
    image is the second half, latest-wins by PK."""
    half = n // 2
    return ([{"id": i, "payload": f"v0-{i}", "amount": float(i)}
             for i in range(half)]
            + [{"id": i, "payload": f"v1-{i}", "amount": float(i) + 0.5}
               for i in range(half)])


class ListClient:
    """The QueueSource client contract over per-partition message lists
    (fetch, commit, seek), in either package's message types."""

    def __init__(self, p, msgs, n_partitions=2):
        self.p = p
        self.parts = {k: [] for k in range(n_partitions)}
        for i, m in enumerate(msgs):
            self.parts[i % n_partitions].append(json.dumps(m).encode())
        self.positions = {k: 0 for k in self.parts}
        self.committed = {}

    def produce(self, partition, msg):
        self.parts[partition].append(json.dumps(msg).encode())

    def fetch(self, max_messages=1024):
        out = []
        for part in sorted(self.parts):
            pos = self.positions[part]
            vals = self.parts[part][pos:pos + max_messages]
            if vals:
                out.append(self.p.Fetched(TOPIC, part, [
                    self.p.Message(value=v, key=b"", topic=TOPIC,
                                   partition=part, offset=pos + i)
                    for i, v in enumerate(vals)]))
                self.positions[part] = pos + len(vals)
        return out

    def commit(self, topic, partition, offset):
        self.committed[(topic, partition)] = offset

    def seek(self, topic, partition, offset):
        self.positions[partition] = offset


def new_pump(p, store, client, **kw):
    kw.setdefault("layer_rows", 10)
    return p.pump.MvccPump(store, client, parser_config=PARSER, **kw)


def drain(pump, max_messages=8):
    while pump.step(max_messages=max_messages):
        pass
    pump.flush()


def pump_rows(st):
    out = {}
    for b in st.read_at(PUMP_TABLE):
        d = b.to_pydict()
        for i, v in zip(d["id"], d["payload"]):
            assert i not in out, f"duplicate id {i} in merged image"
            out[i] = v
    return out


def layers_of(st):
    return [{k: d[k] for k in ("worker", "seq", "table", "lsn_min",
                               "lsn_max", "rows", "content_key")}
            | {"offsets": d.get("offsets")}
            for d in st.control_state()["layers"]]


def pm_drain_builds_layers(p):
    msgs = feed_messages(40)
    client = ListClient(p, msgs)
    st = p.Store("mvcc/pump-drain", p.cp())
    pump = new_pump(p, st, client)
    drain(pump)
    assert pump_rows(st) == {m["id"]: m["payload"] for m in msgs}
    assert st.watermark() == len(msgs) - 1
    assert pump.offsets() == {f"{TOPIC}:0": 19, f"{TOPIC}:1": 19}
    assert client.committed == {}
    return [layers_of(st), pump.offsets(), image_of(st, PUMP_TABLE)]


def image_of(st, table):
    return [(b.to_pydict(), b.lsns.tolist()) for b in st.read_at(table)]


def pm_offsets_ride_last_layer(p):
    """A flush sealing several tables' layers puts the covered offsets
    on the LAST one only."""
    schema = p.new_schema([("id", "int64", True)])
    t_a, t_b = p.TableID("s", "aa"), p.TableID("s", "bb")

    class TwoTableParser:
        def do_batch(self, messages):
            n = len(messages)
            kw = {"kinds": np.full(n, p.KINDS[p.Kind.INSERT], np.int8)}
            return p.ParseResult(batches=[
                p.batch.ColumnBatch.from_pydict(
                    t_a, schema, {"id": list(range(n))}, **kw),
                p.batch.ColumnBatch.from_pydict(
                    t_b, schema, {"id": list(range(n))}, **kw)])

    client = ListClient(p, [{"x": o} for o in range(3)], n_partitions=1)
    st = p.Store("mvcc/pump-flushgroup", p.cp())
    pump = p.pump.MvccPump(st, client, parser=TwoTableParser(),
                           layer_rows=1)
    pump.step()
    pump.flush()
    layers = st.control_state()["layers"]
    assert [d["table"] for d in layers] == [str(t_a), str(t_b)]
    assert not layers[0].get("offsets")
    assert layers[1].get("offsets") == {f"{TOPIC}:0": 2}
    return layers_of(st)


def pm_resume_seeks(p):
    msgs = feed_messages(40)
    client = ListClient(p, msgs)
    st = p.Store("mvcc/pump-resume", p.cp())
    pump1 = new_pump(p, st, client, layer_rows=6)
    pump1.step(max_messages=8)
    pump1.step(max_messages=8)
    pump1.flush()
    covered = pump1.offsets()
    seqs_before = [d["seq"] for d in st.control_state()["layers"]]
    # a fresh incarnation on a fresh client arms the cursor from the
    # manifest alone
    client2 = ListClient(p, msgs)
    pump2 = new_pump(p, st, client2, layer_rows=6)
    positions = dict(client2.positions)
    for key, off in covered.items():
        _, part = p.pump.split_partition_key(key)
        assert positions[part] == off + 1
    drain(pump2)
    assert pump_rows(st) == {m["id"]: m["payload"] for m in msgs}
    seqs = [d["seq"] for d in st.control_state()["layers"]]
    assert len(set(seqs)) == len(seqs)
    assert min(s for s in seqs if s not in seqs_before) == \
        max(seqs_before) + 1
    return [covered, positions, layers_of(st)]


def pm_zombie_fenced(p):
    msgs = feed_messages(20)
    client = ListClient(p, msgs)
    st = p.Store("mvcc/pump-zombie", p.cp())
    pump = new_pump(p, st, client)
    drain(pump)
    d = st.cutover(2, offsets=pump.offsets())
    doc_layers = len(st.control_state()["layers"])
    client.produce(0, {"id": 99, "payload": "late", "amount": 9.9})
    pump.step()
    pump.flush()
    assert d["granted"] and pump.fenced and pump.step() == 0
    assert len(st.control_state()["layers"]) == doc_layers
    assert 99 not in pump_rows(st)
    return [d, doc_layers, st.stats.m.value("mvcc_layers_fenced")]


def pm_commit_needs_seal(p):
    client = ListClient(p, feed_messages(20))
    st = p.Store("mvcc/pump-fence1", p.cp())
    pump = new_pump(p, st, client)
    drain(pump)
    with pytest.raises(RuntimeError, match="no sealed cutover"):
        pump.commit_sealed_offsets()
    assert client.committed == {}
    return pump.offsets()


def pm_only_sealed_offsets(p):
    client = ListClient(p, feed_messages(20))
    st = p.Store("mvcc/pump-fence2", p.cp())
    pump = new_pump(p, st, client)
    drain(pump)
    sealed_offs = pump.offsets()
    assert st.cutover(2, offsets=sealed_offs)["granted"]
    client.produce(0, {"id": 77, "payload": "late", "amount": 7.7})
    pump.step()
    pump.flush()
    committed = pump.commit_sealed_offsets()
    assert committed == sealed_offs == st.sealed_offsets()
    assert client.committed == {(TOPIC, 0): 9, (TOPIC, 1): 9}
    assert pump.commit_sealed_offsets() == sealed_offs
    return [committed, client.committed,
            st.stats.m.value("mvcc_offset_commits")]


@pytest.mark.parametrize("scenario", [
    pm_drain_builds_layers, pm_offsets_ride_last_layer, pm_resume_seeks,
    pm_zombie_fenced, pm_commit_needs_seal, pm_only_sealed_offsets],
    ids=lambda f: f.__name__)
def test_pump_equals_jax(scenario):
    """The pump's layers (LSNs, seqs, content keys, offsets), merged image,
    fences and commits equal the JAX package's on the same feed (exact)."""
    both(scenario)


def test_partition_key_roundtrip():
    """Both packages' partition keys (exact)."""
    for m in (port_pump, ref_pump):
        assert m.partition_key("a:b", 3) == "a:b:3"
        assert m.split_partition_key("a:b:3") == ("a:b", 3)


def test_crash_rebuild_names_the_spill():
    """The reference rebuilds a killed worker's scope from its spilled
    blobs; the port has no spill (pyarrow) and says so."""
    cp = MemoryCoordinator()
    st = port_store.register_store(_port_store("mvcc/pump-crash", cp))
    pump = new_pump(PKG["port"], st, ListClient(PKG["port"],
                                                feed_messages(40)))
    pump.step(max_messages=10)
    pump.flush()
    port_store.unregister_store("mvcc/pump-crash")
    with pytest.raises(NotImplementedError, match="pyarrow"):
        port_store.rebuild_store("mvcc/pump-crash", cp)


# -- the runner and activate_delivery (test_mvcc_runner.py) -----------------

def sai_transfer(p, tid, rows=64, **src_kw):
    return p.Transfer(
        id=tid, type=p.TransferType.SNAPSHOT_AND_INCREMENT,
        src=p.Sample(preset="users", table="users", rows=rows,
                     batch_rows=32, **src_kw),
        dst=p.MemTarget(sink_id=f"mvccrun_{tid}_{id(p)}"))


def sink_image(p, t, table):
    """The sink's published rows sorted by user_id."""
    rows = [it.as_dict() for it in p.get_store(t.dst.sink_id).rows(table)]
    return sorted(rows, key=lambda r: r["user_id"])


def rn_sai_e2e(p):
    t = sai_transfer(p, "sai1")
    p.get_store(t.dst.sink_id).clear()
    cp = p.cp()
    assert p.runner.resume_state(cp, t.id) is None
    p.activate(t, cp, **p.kw)
    tid = p.TableID("sample", "users")
    return [cp.get_status(t.id).value,
            p.get_store(t.dst.sink_id).row_count(tid),
            p.runner.resume_state(cp, t.id), sink_image(p, t, tid)]


def rn_dict_heavy(p):
    t = sai_transfer(p, "sai_dict", rows=256, dict_encode=True)
    p.get_store(t.dst.sink_id).clear()
    p.telemetry.reset()
    p.activate(t, p.cp(), **p.kw)
    snap = p.telemetry.snapshot()
    assert snap["dict_flat_materializations"] == 0, snap
    assert snap["lazy_dict_preserved"] > 0
    tid = p.TableID("sample", "users")
    return [p.get_store(t.dst.sink_id).row_count(tid),
            sink_image(p, t, tid)]


def rn_idempotent_activation(p):
    t = sai_transfer(p, "sai_retry", rows=32)
    p.get_store(t.dst.sink_id).clear()
    cp = p.cp()
    st1 = p.runner.activate_snapshot_and_increment(t, cp, epoch=1, **p.kw)
    st2 = p.runner.activate_snapshot_and_increment(t, cp, epoch=2, **p.kw)
    return [st1.sealed(), st2.sealed(), p.runner.resume_state(cp, t.id),
            st2.stats.m.value("mvcc_cutover_fenced")]


def rn_land_part(p):
    tid = p.TableID("s", "t")
    b = mk_batch(p, [1], ["a"], tid=tid)
    part = p.Part(operation_id="op-x", table_id=tid, part_index=0,
                  assignment_epoch=3)

    class Deny:
        def commit_part(self, operation_id, part):
            return False

    class Grant:
        def commit_part(self, operation_id, part):
            return True

    st = p.Store("mvcc/land")
    out = [p.runner.land_snapshot_part(st, Deny(), "op-x", part, [b]),
           st.read_at(str(tid)),
           p.runner.land_snapshot_part(st, Grant(), "op-x", part, [b]),
           image(st.read_at(str(tid)))]
    st2 = p.Store("mvcc/land2")
    out.append(p.runner.land_snapshot_part(st2, None, "op-x", part, [b]))
    return out + [p.runner.store_scope("t-1"),
                  (p.runner.STATE_WATERMARK, p.runner.STATE_EPOCH,
                   p.runner.STATE_OFFSETS)]


def rn_live_pump(p):
    """Snapshot + concurrent pump -> the cutover seals the covered offsets
    -> only then do they commit -> resume_state exposes them."""
    msgs = feed_messages(40)
    client = ListClient(p, msgs)
    t = sai_transfer(p, "pact1")
    p.get_store(t.dst.sink_id).clear()
    cp = p.cp()
    st = p.Store(p.runner.store_scope(t.id), cp)
    pump = new_pump(p, st, client, layer_rows=8)
    out = p.runner.activate_snapshot_and_increment(t, cp, store=st,
                                                   pump=pump)
    assert out is st
    rs = p.runner.resume_state(cp, t.id)
    assert rs["offsets"] == {f"{TOPIC}:0": 19, f"{TOPIC}:1": 19}
    assert client.committed == {(TOPIC, 0): 19, (TOPIC, 1): 19}
    sink = p.get_store(t.dst.sink_id)
    pump_tid = p.TableID("mqtest", "pump_events")
    users = p.TableID("sample", "users")
    return [sorted(st.tables()), rs, client.committed,
            sink.row_count(pump_tid), sink.row_count(users),
            sorted((r.as_dict()["id"], r.as_dict()["payload"])
                   for r in sink.rows(pump_tid)),
            sink_image(p, t, users)]


@pytest.mark.parametrize("scenario", [
    rn_sai_e2e, rn_dict_heavy, rn_idempotent_activation,
    rn_land_part, rn_live_pump], ids=lambda f: f.__name__)
def test_runner_equals_jax(scenario):
    """S&I activations and the runner's pieces: status, sealed decisions,
    resume_state, commits and the published sinks equal the JAX
    package's (exact)."""
    both(scenario)


def test_slot_created_before_snapshot(monkeypatch):
    """The source's activate hook (the slot) runs BEFORE the first
    snapshot row is read, in the port as in the reference."""
    from transferia_tpu_torch.tasks import activate as activate_mod

    events = []
    t = sai_transfer(PKG["port"], "sai_slot", rows=32)
    get_store(t.dst.sink_id).clear()
    real_get = activate_mod.get_provider

    class SlotProvider:
        def __init__(self, inner):
            self._inner = inner

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def supports_activate(self):
            return True

        def activate(self, callbacks):
            events.append("slot")

    def fake_get(provider_id, transfer, metrics, **kw):
        p = real_get(provider_id, transfer, metrics, **kw)
        if provider_id == transfer.src_provider():
            return SlotProvider(p)
        return p

    real_sai = port_runner.activate_snapshot_and_increment

    def recording_sai(*a, **kw):
        events.append("snapshot")
        return real_sai(*a, **kw)

    monkeypatch.setattr(activate_mod, "get_provider", fake_get)
    monkeypatch.setattr(port_runner, "activate_snapshot_and_increment",
                        recording_sai)
    activate_delivery(t, MemoryCoordinator(), device=CPU)
    assert events == ["slot", "snapshot"]


def test_from_transfer_none_for_non_queue_source():
    """A sample source has no replication: no pump, in both packages."""
    for p in PKG.values():
        t = sai_transfer(p, "pnq1")
        st = p.Store(p.runner.store_scope(t.id), p.cp())
        assert p.pump.MvccPump.from_transfer(t, st) is None


def test_sai_without_mvcc_support_uploads_plainly():
    """A coordinator without the MVCC control plane takes the plain
    upload, as the reference does: the sink gets every row, no cutover
    state."""
    class Plain(MemoryCoordinator):
        def supports_mvcc(self):
            return False

    t = sai_transfer(PKG["port"], "sai_plain", rows=48)
    get_store(t.dst.sink_id).clear()
    cp = Plain()
    activate_delivery(t, cp, device=CPU)
    assert get_store(t.dst.sink_id).row_count(TableID("sample", "users")) \
        == 48
    assert port_runner.resume_state(cp, t.id) is None


def test_sai_needs_a_card_or_the_cpu(monkeypatch):
    """Without a card the store (and so the S&I activation) raises unless
    the caller passes device="cpu"."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_store.MvccStore("mvcc/x")
    t = sai_transfer(PKG["port"], "sai_nocard", rows=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        activate_delivery(t, MemoryCoordinator())


def test_pg_sai_makes_no_slot_at_activation():
    """Neither package's Postgres provider has an activate hook, so a
    SNAPSHOT_AND_INCREMENT activation from Postgres makes no slot before
    the snapshot (the slot comes when replication starts); both publish
    the same image and resume state (exact).  ROADMAP.md C notes it."""
    from tests.recipes.fake_postgres import FakePG as RefFakePG
    from tests.recipes.fake_postgres import FakeTable as RefFakeTable
    from transferia_tpu.providers.postgres import PGSourceParams as RefPG
    from transferia_tpu_torch.providers.postgres import PGSourceParams
    from transferia_tpu_torch.recipes.fake_postgres import FakePG, FakeTable

    cols = [("id", "bigint", True, True), ("url", "text", False, False)]
    rows = [{"id": str(i), "url": f"u{i % 7}"} for i in range(40)]
    out = {}
    for name, p, fake, table, params in (
            ("port", PKG["port"], FakePG, FakeTable, PGSourceParams),
            ("jax", PKG["jax"], RefFakePG, RefFakeTable, RefPG)):
        pg = fake().start()
        try:
            pg.add_table(table("public", "hits", cols, rows))
            t = p.Transfer(id="sai-pg", type=p.TransferType
                           .SNAPSHOT_AND_INCREMENT,
                           src=params(host="127.0.0.1", port=pg.port,
                                      database="db", user="u"),
                           dst=p.MemTarget(sink_id=f"sai-pg-{name}"))
            p.get_store(t.dst.sink_id).clear()
            cp = p.cp()
            p.activate(t, cp, **p.kw)
            out[name] = [dict(pg.slots), p.runner.resume_state(cp, t.id),
                         sorted(it.as_dict()["id"] for it in
                                p.get_store(t.dst.sink_id).rows())]
        finally:
            pg.stop()
    assert out["port"] == out["jax"]
    assert out["port"][0] == {} and len(out["port"][2]) == 40


def test_from_transfer_kafka_client_has_no_coordinator():
    """MvccPump.from_transfer builds the Kafka source without a
    coordinator in both packages, so that client's commits (which land
    in the coordinator's transfer state) go nowhere; a caller that wants
    the sealed offsets kept builds the client with one, as the chip's
    sai phase does.  ROADMAP.md C notes it."""
    from tests.recipes.fake_kafka import FakeKafka as RefFakeKafka
    from transferia_tpu.providers.kafka import (
        KafkaSourceParams as RefKafkaParams,
    )
    from transferia_tpu_torch.providers.kafka import KafkaSourceParams
    from transferia_tpu_torch.recipes.fake_kafka import FakeKafka

    for p, fake, params in ((PKG["port"], FakeKafka, KafkaSourceParams),
                            (PKG["jax"], RefFakeKafka, RefKafkaParams)):
        kf = fake(n_partitions=2).start()
        try:
            kf.create_topic("hits")
            t = p.Transfer(id="pk", type=p.TransferType
                           .SNAPSHOT_AND_INCREMENT,
                           src=params(brokers=[f"127.0.0.1:{kf.port}"],
                                      topic="hits", parser=PARSER),
                           dst=p.MemTarget(sink_id="pk"))
            st = p.Store(p.runner.store_scope(t.id), p.cp())
            pump = p.pump.MvccPump.from_transfer(t, st)
            assert pump is not None and pump.client.cp is None
            pump.close()
        finally:
            kf.stop()
