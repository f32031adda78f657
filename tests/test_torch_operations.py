"""The port's maintenance operations (`tasks/operations.py`: reupload,
add_tables, remove_tables, the persisted include list), its cron matcher
(`utils/cron.py`) and the cron-driven regular snapshot
(`runtime/local.py::run_regular_snapshot`), each against the JAX
package's on the CPU: the cases of `tests/unit/test_operations.py` and
`tests/unit/test_incremental_dblog.py::TestCron` on both packages, the
target rows held equal; `parse_cron`'s next times over a year of starts;
`run_regular_snapshot` with `max_runs` on a patched clock.
"""

import time

import numpy as np
import pytest

from transferia_tpu import tasks as ref_tasks
from transferia_tpu.abstract.schema import TableID as RefTableID
from transferia_tpu.coordinator import MemoryCoordinator as RefCoordinator
from transferia_tpu.coordinator.interface import (
    TransferStatus as RefStatus,
)
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models.transfer import DataObjects as RefDataObjects
from transferia_tpu.models.transfer import IncrementalTableCfg as RefInc
from transferia_tpu.models.transfer import RegularSnapshot as RefRegular
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers.kafka.provider import (
    KafkaSourceParams as RefKafkaSrc,
)
from transferia_tpu.providers.sample import make_batch as ref_make_batch
from transferia_tpu.runtime import local as ref_local
from transferia_tpu.utils import cron as ref_cron
from transferia_tpu_torch import tasks as port_tasks
from transferia_tpu_torch.abstract.schema import TableID
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.coordinator.interface import TransferStatus
from transferia_tpu_torch.models import (
    DataObjects,
    IncrementalTableCfg,
    RegularSnapshot,
    Transfer,
)
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers.kafka import KafkaSourceParams
from transferia_tpu_torch.providers.sample import make_batch
from transferia_tpu_torch.runtime import local as port_local
from transferia_tpu_torch.utils import cron as port_cron

PKG = {
    "port": dict(tasks=port_tasks, tid=TableID, cp=MemoryCoordinator,
                 status=TransferStatus, transfer=Transfer, do=DataObjects,
                 mem=port_memory, make_batch=make_batch, kafka=KafkaSourceParams,
                 local=port_local, inc=IncrementalTableCfg,
                 regular=RegularSnapshot, kw={"device": "cpu"}),
    "jax": dict(tasks=ref_tasks, tid=RefTableID, cp=RefCoordinator,
                status=RefStatus, transfer=RefTransfer, do=RefDataObjects,
                mem=ref_memory, make_batch=ref_make_batch, kafka=RefKafkaSrc,
                local=ref_local, inc=RefInc, regular=RefRegular, kw={}),
}


def seed(pkg, source_id, tables, rows=30):
    m = PKG[pkg]
    m["mem"].seed_source(source_id, [
        m["make_batch"]("users", m["tid"]("sample", n), 0, rows, seed=5)
        for n in tables])


def transfer(pkg, tid, source_id, sink_id, include=None):
    m = PKG[pkg]
    return m["transfer"](
        id=tid, src=m["mem"].MemorySourceParams(source_id=source_id),
        dst=m["mem"].MemoryTargetParams(sink_id=sink_id),
        data_objects=m["do"](include_object_ids=list(include or [])))


def rows(store):
    return sorted(tuple(sorted(it.as_dict().items())) for it in store.rows())


def both(scenario):
    out = {pkg: scenario(pkg, PKG[pkg]) for pkg in PKG}
    assert out["port"] == out["jax"]
    return out["port"]


def test_reupload_cleans_and_reloads():
    def scenario(pkg, m):
        seed(pkg, f"op_src1_{pkg}", ["t1"])
        store = m["mem"].get_store(f"op_sink1_{pkg}")
        store.clear()
        cp = m["cp"]()
        t = transfer(pkg, "op-re", f"op_src1_{pkg}", f"op_sink1_{pkg}")
        m["tasks"].activate_delivery(t, cp, **m["kw"])
        first = store.row_count(m["tid"]("sample", "t1"))
        m["tasks"].reupload(t, cp, **m["kw"])
        return first, rows(store), cp.get_status(t.id).value

    first, got, status = both(scenario)
    assert first == len(got) == 30 and status == "activated"


def test_reupload_forbidden_for_append_only_source():
    for pkg, m in PKG.items():
        t = m["transfer"](id="op-ao", src=m["kafka"](),
                          dst=m["mem"].MemoryTargetParams(sink_id="y"))
        with pytest.raises(ValueError, match="append-only source is not "
                                             r"allowed \(reupload.go:13\)"):
            m["tasks"].reupload(t, m["cp"](), **m["kw"])


def test_add_tables_loads_only_new_and_persists():
    def scenario(pkg, m):
        seed(pkg, f"op_src2_{pkg}", ["t1", "t2", "t3"])
        store = m["mem"].get_store(f"op_sink2_{pkg}")
        store.clear()
        cp = m["cp"]()
        t = transfer(pkg, "op-add", f"op_src2_{pkg}", f"op_sink2_{pkg}",
                     include=["sample.t1"])
        m["tasks"].activate_delivery(t, cp, **m["kw"])
        before = rows(store)
        m["tasks"].add_tables(t, cp, ["sample.t2"], **m["kw"])
        t2 = transfer(pkg, "op-add", f"op_src2_{pkg}", f"op_sink2_{pkg}",
                      include=["sample.t1"])
        m["tasks"].apply_persisted_include_list(t2, cp)
        return (len(before), rows(store), t.data_objects.include_object_ids,
                t2.data_objects.include_object_ids)

    n_before, got, include, persisted = both(scenario)
    assert n_before == 30 and len(got) == 60
    assert include == persisted == ["sample.t1", "sample.t2"]


def test_add_tables_requires_include_list_and_skips_known():
    def scenario(pkg, m):
        t = transfer(pkg, "op-add2", "s", "k")
        with pytest.raises(ValueError, match="include"):
            m["tasks"].add_tables(t, m["cp"](), ["sample.t9"], **m["kw"])
        seed(pkg, f"op_src3_{pkg}", ["t1"])
        store = m["mem"].get_store(f"op_sink3_{pkg}")
        store.clear()
        t = transfer(pkg, "op-add3", f"op_src3_{pkg}", f"op_sink3_{pkg}",
                     include=["sample.t1"])
        m["tasks"].add_tables(t, m["cp"](), ["sample.t1"], **m["kw"])
        return store.row_count()

    assert both(scenario) == 0


def test_remove_tables_narrows_persists_and_refuses():
    def scenario(pkg, m):
        cp = m["cp"]()
        t = transfer(pkg, "op-rm", "s", "k",
                     include=["sample.t1", "sample.t2"])
        m["tasks"].remove_tables(t, cp, ["sample.t2"])
        t2 = transfer(pkg, "op-rm", "s", "k",
                      include=["sample.t1", "sample.t2"])
        m["tasks"].apply_persisted_include_list(t2, cp)
        errs = []
        for bad in (["sample.nope"], ["sample.t1"], []):
            with pytest.raises(ValueError) as e:
                m["tasks"].remove_tables(t, cp, bad)
            errs.append(str(e.value))
        return (t.data_objects.include_object_ids,
                t2.data_objects.include_object_ids, errs)

    include, persisted, errs = both(scenario)
    assert include == persisted == ["sample.t1"]
    assert "not in the include list" in errs[0] and "empty" in errs[1]


# -- cron ------------------------------------------------------------------------

CRONS = ["* * * * *", "*/15 3 * * *", "0 0 1,15 * 1-5", "5 4 * * 7",
         "0 */6 * 2-11 *", "59 23 31 12 *", "0 0 * * 0,6"]


@pytest.mark.parametrize("expr", CRONS)
def test_parse_cron_next_times_equal_jax(expr):
    got, want = port_cron.parse_cron(expr), ref_cron.parse_cron(expr)
    assert (got.minutes, got.hours, got.days, got.months, got.weekdays,
            got.dom_restricted, got.dow_restricted) == \
        (want.minutes, want.hours, want.days, want.months, want.weekdays,
         want.dom_restricted, want.dow_restricted)
    rng = np.random.default_rng(len(expr))
    starts = 1_700_000_000 + rng.integers(0, 365 * 86_400, 12)
    for t in starts.tolist():
        nxt = got.next_after(t)
        assert nxt == want.next_after(t) and nxt > t and nxt % 60 == 0
        assert got.matches(time.localtime(nxt))


@pytest.mark.parametrize("expr", ["* * *", "99 * * * *", "* 24 * * *",
                                  "* * 0 * *", "a * * * *"])
def test_parse_cron_refuses_as_jax(expr):
    for mod in (port_cron, ref_cron):
        with pytest.raises(ValueError):
            mod.parse_cron(expr)


# -- the regular snapshot ------------------------------------------------------------

def regular(pkg, m, sink, max_runs, clock):
    seed(pkg, f"reg_src_{pkg}", ["ev"], rows=20)
    store = m["mem"].get_store(sink)
    store.clear()
    t = transfer(pkg, f"reg-{pkg}", f"reg_src_{pkg}", sink)
    t.regular_snapshot = m["regular"](
        enabled=True, cron="*/5 * * * *",
        incremental=[m["inc"](namespace="sample", name="ev",
                              cursor_field="user_id")])
    cp = m["cp"]()
    waits = []

    class Stop:
        def is_set(self):
            return False

        def wait(self, seconds):
            waits.append(seconds)
            clock[0] += seconds
            if len(waits) == 2:   # new rows before the second run
                seed(pkg, f"reg_src_{pkg}", ["ev"], rows=26)
            return False

    m["local"].run_regular_snapshot(t, cp, stop_event=Stop(),
                                    max_runs=max_runs, **m["kw"])
    return (waits, rows(store),
            cp.get_transfer_state(t.id).get("incremental_state"))


@pytest.mark.parametrize("max_runs", [1, 2])
def test_run_regular_snapshot_equals_jax(max_runs, monkeypatch):
    clock = [1_700_000_123.0]
    monkeypatch.setattr(time, "time", lambda: clock[0])
    got = {}
    for pkg, m in PKG.items():
        clock[0] = 1_700_000_123.0
        got[pkg] = regular(pkg, m, f"reg_sink_{pkg}", max_runs, clock)
    assert got["port"] == got["jax"]
    waits, got_rows, state = got["port"]
    assert len(waits) == max_runs
    assert waits[0] == 1_700_000_400 - 1_700_000_123
    assert len(got_rows) == (20 if max_runs == 1 else 26)
    assert state == {"sample.ev": 19 if max_runs == 1 else 25}


def test_run_regular_snapshot_needs_a_cron():
    for pkg, m in PKG.items():
        t = transfer(pkg, "reg-none", "s", "k")
        with pytest.raises(ValueError, match="no regular_snapshot cron"):
            m["local"].run_regular_snapshot(t, m["cp"](), max_runs=1,
                                            **m["kw"])
