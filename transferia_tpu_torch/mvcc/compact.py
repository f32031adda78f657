"""Compaction: fold delta layers into a new base version (the port's copy
of ``transferia_tpu/mvcc/compact.py``).

Compaction is pure maintenance: a merged read at a chosen watermark
materialized as the table's next base epoch, with the folded layers
pruned from the coordinator control doc.  Correctness never depends on
it: `MvccStore.read_at` answers identically before and after, so it can
lag, crash or rerun freely.

The reference runs it as SCAVENGER fleet tickets (abstract/ticket.py's
`FleetTicket`) with a deterministic id per (scope, table, watermark).
The port has no fleet to queue or run them on (ROADMAP.md A7):
`compaction_ticket`, `enqueue_compaction` and `make_compact_runner`
raise and name that item.  `compact_table` runs in process.
"""

from __future__ import annotations

import os
from typing import Optional

from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.mvcc.store import MvccStore, compact_min_layers
from transferia_tpu_torch.stats import trace

FLEET_LEFT_OUT = ("the compaction ticket, its queue and its runner wait "
                  "on the fleet (fleet/worker.py RUNNERS, the "
                  "coordinator's ticket queue), not ported to "
                  "transferia_tpu_torch yet (ROADMAP.md A7)")


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
                      transfer_id: str = ""):
    """The reference's SCAVENGER fleet ticket for one compaction
    opportunity; the port has no fleet to run it."""
    raise NotImplementedError(f"compaction_ticket: {FLEET_LEFT_OUT}")


def enqueue_compaction(coordinator, queue: str, store: MvccStore,
                       table: str, transfer_id: str = ""):
    """The reference enqueues `compaction_ticket` on the coordinator's
    ticket queue; the port has no ticket queue."""
    raise NotImplementedError(f"enqueue_compaction: {FLEET_LEFT_OUT}")


def make_compact_runner(resolve_store):
    """The reference's `RUNNERS[PAYLOAD_KIND]` entry for fleet workers;
    the port has no fleet worker."""
    raise NotImplementedError(f"make_compact_runner: {FLEET_LEFT_OUT}")
