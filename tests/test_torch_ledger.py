"""The port's resource ledger (`transferia_tpu_torch/stats/ledger.py`)
against the JAX package's `transferia_tpu/stats/ledger.py`.

The JAX package's ledger unit cases run on both packages (`pkg`):
scoping and inheritance, thread adoption, the cardinality bound, the
device counters routed through the ledger, the conservation check (and
under four concurrent snapshot transfers), the metric folds and
`format_top`.  The parity case runs the 5,000-row `sample` -> memory
snapshot of `test_torch_trace.py` through both packages and compares
the per-transfer rows and bytes the ledger attributed.
"""

import threading

import pytest

from test_torch_trace import quiet  # noqa: F401  (autouse fixture)
from test_torch_trace import sample_snapshot
from transferia_tpu.coordinator.memory import (
    MemoryCoordinator as RefCoordinator,
)
from transferia_tpu.models import Transfer as RefTransfer
from transferia_tpu.models import TransferType as RefTransferType
from transferia_tpu.providers import memory as ref_memory
from transferia_tpu.providers import sample as ref_sample
from transferia_tpu.stats import ledger as ref_ledger
from transferia_tpu.stats import trace as ref_trace
from transferia_tpu.stats.registry import Metrics as RefMetrics
from transferia_tpu.tasks.snapshot import SnapshotLoader as RefLoader
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import Transfer, TransferType
from transferia_tpu_torch.providers import memory as port_memory
from transferia_tpu_torch.providers import sample as port_sample
from transferia_tpu_torch.stats import ledger as port_ledger
from transferia_tpu_torch.stats import trace as port_trace
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.tasks import SnapshotLoader

MODS = {"jax": (ref_ledger, ref_trace, RefMetrics),
        "torch": (port_ledger, port_trace, Metrics)}


@pytest.fixture(params=["jax", "torch"])
def pkg(request):
    return request.param


def test_scope_attributes_and_inherits(pkg):
    led_mod, _, _ = MODS[pkg]
    LEDGER = led_mod.LEDGER
    with LEDGER.context(transfer_id="t1", tenant="acme"):
        LEDGER.add(rows_in=10)
        with LEDGER.context(part="ns.t/0"):
            assert LEDGER.current_key() == led_mod.LedgerKey(
                "t1", "acme", "ns.t/0")
            LEDGER.add(rows_out=7)
        assert LEDGER.current_key() == led_mod.LedgerKey(
            "t1", "acme", led_mod.UNATTRIBUTED)
    assert LEDGER.current_key() is None
    snap = LEDGER.snapshot()
    tr = snap["transfers"]["t1"]
    assert tr["rows_in"] == 10 and tr["rows_out"] == 7
    assert tr["tenant"] == "acme" and tr["parts"] == 1
    assert snap["tenants"]["acme"]["transfers"] == 1


def test_unscoped_work_lands_in_unattributed_bucket(pkg):
    led_mod, _, _ = MODS[pkg]
    led_mod.LEDGER.add(rows_in=5)
    snap = led_mod.LEDGER.snapshot()
    assert snap["transfers"][led_mod.UNATTRIBUTED]["rows_in"] == 5


def test_add_for_explicit_key(pkg):
    LEDGER = MODS[pkg][0].LEDGER
    LEDGER.add_for("tX", tenant="tn", retries=2)
    assert LEDGER.snapshot()["transfers"]["tX"]["retries"] == 2


def test_adopted_carries_scope_across_threads(pkg):
    LEDGER = MODS[pkg][0].LEDGER
    got = {}
    with LEDGER.context(transfer_id="t1", tenant="acme"):
        key = LEDGER.current_key()

    def worker():
        assert LEDGER.current_key() is None
        with LEDGER.adopted(key):
            LEDGER.add(bytes_out=64)
            got["key"] = LEDGER.current_key()
        assert LEDGER.current_key() is None

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert got["key"] == key
    assert LEDGER.snapshot()["transfers"]["t1"]["bytes_out"] == 64


def test_overflow_folds_preserve_totals(pkg):
    led = MODS[pkg][0].ResourceLedger(max_entries=8)
    for i in range(20):
        led.add_for(f"t{i:02d}", tenant="acme", rows_out=1,
                    bytes_out=100)
    snap = led.snapshot()
    assert snap["entries"] <= 8 and snap["overflow_folded"] > 0
    assert snap["totals"]["rows_out"] == 20
    assert snap["totals"]["bytes_out"] == 2000
    assert snap["transfers"]["~overflow"]["rows_out"] > 0


def test_overflow_folds_equal_jax():
    snaps = []
    for pkg in ("jax", "torch"):
        led = MODS[pkg][0].ResourceLedger(max_entries=8)
        for i in range(20):
            led.add_for(f"t{i:02d}", tenant=f"tn{i % 3}", rows_out=i,
                        bytes_out=100 * i)
        snap = led.snapshot()
        snaps.append((snap["entries"], snap["overflow_folded"],
                      snap["totals"], sorted(snap["transfers"]),
                      {t: v["rows_out"] for t, v in
                       snap["tenants"].items()}))
    assert snaps[0] == snaps[1]


def test_device_telemetry_routes_through_ledger(pkg):
    led_mod, tr_mod, _ = MODS[pkg]
    LEDGER, TELEMETRY = led_mod.LEDGER, tr_mod.TELEMETRY
    with LEDGER.context(transfer_id="t1", tenant="acme"):
        TELEMETRY.record_h2d(1000)
        TELEMETRY.record_d2h(500)
        TELEMETRY.record_launch(3)
        TELEMETRY.record_dispatch(100, 800)
        TELEMETRY.record_compile(0.5)
        TELEMETRY.record_kernel(0.25)
    snap = LEDGER.snapshot()
    tr = snap["transfers"]["t1"]
    assert tr["h2d_bytes"] == 1000 and tr["d2h_bytes"] == 500
    assert tr["launches"] == 3 and tr["compiles"] == 1
    assert tr["h2d_encoded_bytes"] == 100
    assert tr["h2d_raw_equiv_bytes"] == 800
    assert tr["kernel_seconds"] == 0.25
    cons = snap["conservation"]
    assert cons["ok"], cons
    for field in ("h2d_bytes", "d2h_bytes", "launches", "compiles"):
        assert cons[field]["drift"] == 0


def test_conservation_detects_drift(pkg):
    led_mod, tr_mod, _ = MODS[pkg]
    tr_mod.TELEMETRY.record_h2d(1000)
    led_mod.LEDGER.reset()
    cons = led_mod.LEDGER.conservation()
    assert not cons["ok"]
    assert cons["h2d_bytes"]["drift"] == 1000


def test_conservation_under_four_concurrent_transfers(pkg):
    """Four sample->memory snapshots on four threads: attribution per
    transfer is exact and the totals reconcile with the counters."""
    led_mod, _, metrics_cls = MODS[pkg]
    LEDGER = led_mod.LEDGER
    rows = 200
    if pkg == "jax":
        cp, mem, sample = RefCoordinator(), ref_memory, ref_sample
        transfer, ttype = RefTransfer, RefTransferType
        run = lambda t: RefLoader(t, cp, metrics=metrics_cls())  # noqa
    else:
        cp, mem, sample = MemoryCoordinator(), port_memory, port_sample
        transfer, ttype = Transfer, TransferType
        run = lambda t: SnapshotLoader(  # noqa: E731
            t, cp, metrics=metrics_cls(), device="cpu")
    errors = []

    def one(i):
        sink_id = f"ledger-cons-{pkg}-{i}"
        mem.get_store(sink_id).clear()
        t = transfer(
            id=f"led-t{i}", type=ttype.SNAPSHOT_ONLY,
            src=sample.SampleSourceParams(preset="iot", table="events",
                                          rows=rows, batch_rows=64),
            dst=mem.MemoryTargetParams(sink_id=sink_id))
        t.runtime.sharding.process_count = 1
        try:
            with LEDGER.context(tenant=f"tn{i % 2}"):
                run(t).upload_tables()
        except BaseException as e:  # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    snap = LEDGER.snapshot()
    for i in range(4):
        tr = snap["transfers"][f"led-t{i}"]
        assert tr["rows_out"] == rows and tr["rows_in"] == rows, tr
        assert tr["tenant"] == f"tn{i % 2}"
    assert snap["tenants"]["tn0"]["transfers"] == 2
    assert snap["tenants"]["tn0"]["rows_out"] == 2 * rows
    assert snap["conservation"]["ok"], snap["conservation"]


def test_fold_into_metrics_bounded_and_idempotent(pkg):
    led_mod, _, metrics_cls = MODS[pkg]
    led = led_mod.ResourceLedger(max_entries=64)
    led.add_for("t1", tenant="acme", rows_out=10, bytes_out=1000)
    led.add_for("t2", tenant="bee-corp", rows_out=5, bytes_out=200)
    m = metrics_cls()
    led.fold_into(m)
    assert m.value("ledger_rows_out") == 15
    assert m.value("ledger_bytes_out") == 1200
    assert m.value("ledger_tenant_acme_rows_out") == 10
    assert m.value("ledger_tenant_bee_corp_rows_out") == 5
    assert m.value("ledger_entries") == 2
    led.fold_into(m)
    assert m.value("ledger_rows_out") == 15
    led.add_for("t1", tenant="acme", rows_out=1)
    led.fold_into(m)
    assert m.value("ledger_rows_out") == 16


def test_fold_caps_per_tenant_series(pkg):
    led_mod, _, metrics_cls = MODS[pkg]
    cap = led_mod.MAX_PROM_TENANTS
    led = led_mod.ResourceLedger(max_entries=4096)
    for i in range(cap + 10):
        led.add_for(f"t{i}", tenant=f"tenant{i:03d}", bytes_out=i + 1)
    m = metrics_cls()
    led.fold_into(m)
    top = cap + 9
    assert m.value(f"ledger_tenant_tenant{top:03d}_bytes_out") == top + 1
    assert m.value("ledger_tenant_tenant000_bytes_out") == 0.0
    assert m.value("ledger_bytes_out") == sum(range(1, cap + 11))


def test_format_top_equal_jax():
    frames = []
    for pkg in ("jax", "torch"):
        led_mod = MODS[pkg][0]
        led = led_mod.ResourceLedger(max_entries=64)
        led.add_for("transfer-big", tenant="acme", rows_in=100,
                    rows_out=90, bytes_in=5_000_000, bytes_out=4_000_000,
                    h2d_bytes=1_000_000, launches=4, retries=1)
        led.add_for("transfer-small", tenant="bee", rows_out=5)
        frames.append(led_mod.format_top(led.snapshot(), limit=10))
    assert frames[0] == frames[1]
    assert "transfer-big" in frames[1] and "h2d_mb" in frames[1]


# -- parity: the ledger of a sample snapshot ---------------------------------

FIELDS = ("rows_in", "rows_out", "bytes_in", "bytes_out", "retries",
          "commits", "commit_fences", "lease_steals", "chaos_fires",
          "launches", "d2h_bytes")


def test_sample_snapshot_ledger_equal_jax():
    ids, snap, _ = sample_snapshot("torch", "led-port")
    ref_ids, ref_snap, _ = sample_snapshot("jax", "led-jax")
    assert ids == ref_ids
    tr = snap["transfers"]["led-port"]
    ref_tr = ref_snap["transfers"]["led-jax"]
    for field in FIELDS:
        assert tr[field] == ref_tr[field], field
    assert tr["parts"] == ref_tr["parts"] == 2
    assert tr["rows_in"] == 5000 and tr["rows_out"] == len(ids)
    assert tr["commits"] == 2 and tr["retries"] == 0
    # the predicate column's delta base: 4 staged bytes a fused batch in
    # the JAX package, a kernel argument in the port
    assert ref_tr["h2d_bytes"] - tr["h2d_bytes"] == 4 * tr["launches"]
    assert snap["conservation"]["ok"] and ref_snap["conservation"]["ok"]


def test_concurrent_records_lose_no_update(pkg):
    """More threads than cores record device events under their own
    transfer scopes with a shortened switch interval: every count lands
    in its scope and the totals reconcile exactly."""
    import sys

    led_mod, tr_mod, _ = MODS[pkg]
    LEDGER, TELEMETRY = led_mod.LEDGER, tr_mod.TELEMETRY
    threads, per = 24, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            with LEDGER.context(transfer_id=f"s{i % 4}"):
                for _ in range(per):
                    TELEMETRY.record_h2d(3)
                    TELEMETRY.record_launch()
                    LEDGER.add(rows_out=1)

        ts = [threading.Thread(target=work, args=(i,))
              for i in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    snap = LEDGER.snapshot()
    for i in range(4):
        tr = snap["transfers"][f"s{i}"]
        assert tr["rows_out"] == tr["launches"] == threads // 4 * per
        assert tr["h2d_bytes"] == 3 * threads // 4 * per
    tel = TELEMETRY.snapshot()
    assert tel["device_launches"] == threads * per
    assert tel["h2d_transfers"] == threads * per
    cons = snap["conservation"]
    assert cons["ok"] and cons["launches"]["drift"] == 0
    assert cons["h2d_bytes"]["drift"] == 0
