"""Compaction: fold delta layers into a new base version (the port's copy
of ``transferia_tpu/mvcc/compact.py``).

Compaction is pure maintenance: a merged read at a chosen watermark
materialized as the table's next base epoch, with the folded layers
pruned from the coordinator control doc.  Correctness never depends on
it: `MvccStore.read_at` answers identically before and after, so it can
lag, crash or rerun freely.

It runs as SCAVENGER fleet tickets (abstract/ticket.py's QOS_RANK: it
never preempts transfer work) with a deterministic ticket id per
(scope, table, watermark): `enqueue_ticket` is idempotent by id, so
noticing the same opportunity twice never double-admits.  A fleet
worker (fleet/worker.py RUNNERS) runs the ticket on the store it finds
in its process's registry; the reference rebuilds a miss from the
spill manifest (mvcc/spill.py, which needs pyarrow and is not in the
port), so in the port a miss raises, naming that, and the ticket's
lease hands it to the worker that holds the layers.
"""

from __future__ import annotations

import os
from typing import Callable, Optional

from transferia_tpu_torch.abstract.ticket import FleetTicket
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.mvcc.store import (
    SPILL_LEFT_OUT,
    MvccStore,
    compact_min_layers,
)
from transferia_tpu_torch.stats import trace

PAYLOAD_KIND = "mvcc_compact"


def should_compact(store: MvccStore, table: str,
                   environ=os.environ) -> bool:
    """Enough delta layers to be worth a base rewrite
    (TRANSFERIA_TPU_MVCC_COMPACT_MIN_LAYERS)."""
    return store.layer_count(table) >= compact_min_layers(environ)


def compact_table(store: MvccStore, table: str,
                  watermark: Optional[int] = None) -> dict:
    """Fold the table's deltas at or below `watermark` into one compacted
    base version at the next epoch.  Defaults to the sealed cutover
    watermark, or the local delta high-watermark before a seal.
    Idempotent: a rerun merges the compacted image onto zero remaining
    folded layers and installs an equivalent base."""
    failpoint("mvcc.compact")
    if watermark is None:
        sealed = store.sealed()
        watermark = sealed[0] if sealed is not None else store.watermark()
    sp = trace.span("mvcc_compact", table=table, watermark=watermark)
    with sp:
        merged = store.read_at(table, watermark=int(watermark))
        folded = store.install_compacted(table, int(watermark), merged)
        pruned = 0
        if store.cp is not None and folded:
            pruned = store.cp.mvcc_prune_layers(store.scope, folded)
        rows = sum(b.n_rows for b in merged)
        if sp:
            sp.add(rows=rows, folded=len(folded), pruned=pruned)
        return {"table": table, "watermark": int(watermark),
                "rows": rows, "folded": folded, "pruned": pruned}


def compaction_ticket(scope: str, table: str, watermark: int,
                      transfer_id: str = "") -> FleetTicket:
    """SCAVENGER ticket for one compaction opportunity.  The id is
    deterministic over (scope, table, watermark): the key
    `enqueue_ticket` dedups on."""
    return FleetTicket(
        ticket_id=f"mvcc-compact/{scope}/{table}@{int(watermark)}",
        transfer_id=transfer_id,
        qos="scavenger",
        payload={"kind": PAYLOAD_KIND, "scope": scope, "table": table,
                 "watermark": int(watermark)},
    )


def enqueue_compaction(coordinator, queue: str, store: MvccStore,
                       table: str,
                       transfer_id: str = "") -> Optional[FleetTicket]:
    """Enqueue a compaction ticket once the table has enough layers.
    Safe after every append: the deterministic id makes repeats free."""
    if not should_compact(store, table):
        return None
    sealed = store.sealed()
    w = sealed[0] if sealed is not None else store.watermark()
    t = compaction_ticket(store.scope, table, w, transfer_id)
    return coordinator.enqueue_ticket(queue, t)


def make_compact_runner(
        resolve_store: Callable[[str], Optional[MvccStore]]):
    """Build the `RUNNERS[PAYLOAD_KIND]` entry for fleet workers.
    Columnar layer data lives in process, so the worker supplies
    `resolve_store(scope)`; a miss raises (the reference would rebuild
    the scope from its spill manifest) and the lease hands the ticket
    on."""
    def _run(ticket: FleetTicket, ctx) -> None:
        p = ticket.payload
        store = resolve_store(p["scope"])
        if store is None:
            raise RuntimeError(
                f"ticket {ticket.ticket_id}: no MVCC store for scope "
                f"{p['scope']!r} in this worker, and the rebuild from "
                f"spilled layers is out: {SPILL_LEFT_OUT}")
        compact_table(store, p["table"], watermark=int(p["watermark"]))
    return _run
