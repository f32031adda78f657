"""Failpoint site catalog (the port's copy of the JAX package's
``chaos/sites.py``: the same names, so one spec arms both packages).

Every injection site in the tree is declared HERE, once, with the layer
it lives in and what failing there simulates.  `failpoints.configure`
rejects spec strings naming unknown sites.  The catalog keeps every
site of the JAX package, also those whose layer the port has not
ported yet: such a site is armed and never hit.

Site naming: `<layer>.<component>[.<event>]`, dots only (they map to
`chaos_fires_<name with _>` counters in the stats registry).
"""

from __future__ import annotations

# name -> (layer, what a fault here simulates)
SITES: dict[str, tuple[str, str]] = {
    "storage.part.open": (
        "providers/sample.py",
        "source part handle failing to open (connection refused, "
        "missing object) before any row is read"),
    "storage.part.read": (
        "providers/sample.py",
        "mid-part read error: the source dies after some batches of a "
        "part already reached the sink"),
    "storage.file.open": (
        "providers/file.py",
        "parquet footer/open failure on a file part (truncated upload, "
        "transient FS error)"),
    "decode.native.rowgroup": (
        "providers/parquet_native.py",
        "native C++ row-group decode failing (corrupt page, codec "
        "error) — exercises the arrow/native fallback seams"),
    "decode.dict_adopt": (
        "providers/parquet_native.py",
        "dict-page pool adoption failing (corrupt dict page offsets, "
        "interning fault) before the pool is shared — the row group "
        "must fail cleanly into the arrow fallback/part retry, never "
        "publish a half-adopted pool"),
    "flight.pool_ship": (
        "interchange/flight.py",
        "encoded Flight wire failing exactly as a stream ships a dict "
        "POOL (first batch referencing it) — the put must fail whole "
        "and the retried stream must re-ship the pool; consumers never "
        "see codes without their pool"),
    "decode.readahead.worker": (
        "providers/readahead.py",
        "prefetch worker dying mid-decode: the error must re-raise on "
        "the consumer thread, never vanish with the worker"),
    "transform.chain": (
        "middlewares/sync.py",
        "transformer chain blowing up on a batch (bad cast, device "
        "error surfaced through the fused step)"),
    "device.dispatch": (
        "ops/fused.py",
        "fused mask/filter device launch failing (kernel error, device "
        "OOM, link reset)"),
    "rowhash.pool_accs": (
        "ops/rowhash.py",
        "dict-pool accumulator pass failing (corrupt pool offsets, "
        "native lib fault) before the memo lands — the fingerprint "
        "consumer must surface the error instead of publishing a "
        "partial digest, and a retry must recompute cleanly"),
    "dispatch.h2d": (
        "ops/dispatch.py",
        "encoded-dispatch H2D staging failing (device_put OOM, link "
        "reset mid-transfer) before any kernel launches — the batch "
        "must fail cleanly with no partial device state and retry "
        "through the part machinery"),
    "device.mesh_dispatch": (
        "parallel/fusedmesh.py",
        "multi-chip sharded launch failing on the mesh path"),
    "sink.push": (
        "middlewares/sync.py",
        "sink write failing cleanly: nothing of the batch landed"),
    "sink.push.torn": (
        "middlewares/sync.py",
        "torn write: a PREFIX of the batch lands in the target, then "
        "the push errors — the retry must tolerate the duplicates"),
    "sink.stage": (
        "providers/staging.py",
        "staged-commit stage write failing (staging area full, "
        "staging I/O error) — the push must fail with nothing newly "
        "staged visible and retry through the sink/part machinery; "
        "a part retry restages from scratch (begin replaces)"),
    "sink.publish": (
        "providers/staging.py",
        "staged-commit publish failing between the coordinator grant "
        "and visibility — the target must be left either fully "
        "unpublished or fully replaced (never torn), and the retried "
        "part must republish idempotently under the same epoch"),
    "sink.pg.publish": (
        "providers/postgres/provider.py",
        "postgres staged publish failing between the fence read and "
        "the single-transaction INSERT...SELECT flip (server gone at "
        "the worst moment) — the target must stay fully unpublished "
        "and the retried part must republish idempotently"),
    "sink.ch.publish": (
        "providers/clickhouse/provider.py",
        "clickhouse staged publish failing before the REPLACE "
        "PARTITION flip — the final table's partition must be either "
        "the old publish or the new one, never a mix"),
    "sink.ydb.publish": (
        "providers/ydb/provider.py",
        "ydb staged publish failing before the interactive "
        "transaction (delete + upsert + commit-marker row) commits — "
        "nothing of the part may be visible, marker unmoved"),
    "sink.kafka.publish": (
        "providers/kafka/provider.py",
        "kafka transactional publish failing before the epoch-keyed "
        "transactional produce commits — no message of the part may "
        "land, and the republish supersedes cleanly"),
    "sink.s3.publish": (
        "providers/s3.py",
        "s3 staged publish failing before the batched copy-to-final "
        "behind the conditional marker write — staged objects stay "
        "invisible under .staging/ and the retry re-copies"),
    "coordinator.commit_part": (
        "coordinator/memory.py",
        "the fenced commit_part decision RPC failing (coordinator "
        "unreachable at the worst moment) — nothing may become "
        "visible, and the part retry must re-ask for the decision"),
    "coordinator.set_state": (
        "coordinator/memory.py",
        "transfer-state checkpoint write failing (coordinator KV "
        "unavailable) — cursors/positions must not silently regress"),
    "coordinator.set_op_state": (
        "coordinator/memory.py",
        "operation-state write failing mid-snapshot (discovery flags, "
        "sharded handoff, fingerprint publication)"),
    "snapshot.lease_renew": (
        "tasks/snapshot.py",
        "heartbeat lease renewal failing (coordinator unreachable): "
        "transient failures must be absorbed by the lease TTL; with "
        "raise:WorkerKilledError the heartbeat dies and the worker "
        "becomes a zombie whose parts get reclaimed"),
    "snapshot.part.batch": (
        "tasks/snapshot.py",
        "worker thread dying between batches mid-part (OOM-kill, pod "
        "eviction) — armed with raise:WorkerKilledError this is the "
        "worker_crash generator: the part's lease must expire and a "
        "surviving worker must reclaim and complete it"),
    "replication.pump": (
        "providers/queue_common.py",
        "replication source pump dying between fetch and enqueue — the "
        "retry loop must resume from the last committed offset"),
    "parsequeue.parse": (
        "parsequeue/queue.py",
        "parse worker failing on a fetched batch: the failure must "
        "latch and surface on the source thread, offsets uncommitted"),
    "interchange.ipc.read": (
        "providers/arrow_ipc.py",
        "Arrow IPC stream read failing mid-table (truncated stream, "
        "pipe peer death) after some batches already reached the sink"),
    "interchange.flight.do_get": (
        "interchange/flight.py",
        "Flight DoGet stream failing server-side mid-shard — the "
        "client's part retry must re-fetch without losing rows"),
    "interchange.flight.do_put": (
        "interchange/flight.py",
        "Flight DoPut upload failing server-side after a prefix of the "
        "stream landed — the retried put must replace, not append"),
    "interchange.shm.attach": (
        "interchange/shm.py",
        "shared-memory segment attach failing (segment reaped, name "
        "raced) — the client must fall back to the Flight wire path"),
    "flight.substream": (
        "interchange/flight.py",
        "one substream of a multi-stream part put dying mid-stripe "
        "(gRPC stream reset) — the WHOLE part put must fail with "
        "nothing promoted server-side (no partial visibility), and "
        "the retried put must replace wholesale"),
    "region.seal": (
        "interchange/regions.py",
        "region seal failing after scatter/gather writes landed "
        "(mmap fault, shm truncation) — the region must dispose "
        "cleanly, never hand out views of an unsealed buffer, and "
        "the caller's put/segment write must fail whole"),
    "fleet.admit": (
        "fleet/scheduler.py",
        "fleet admission RPC failing before the transfer is enqueued "
        "(scheduler unreachable) — submitters must retry; nothing may "
        "be half-admitted"),
    "fleet.dispatch": (
        "fleet/scheduler.py",
        "worker slot dying at the dispatch decision (pod eviction as "
        "the transfer is handed over) — with raise:WorkerKilledError "
        "this is the scheduler_kill generator: the slot dies and the "
        "in-flight ticket must rebalance to a survivor; other errors "
        "are transient dispatch faults the scheduler absorbs"),
    "fleet.rebalance": (
        "fleet/scheduler.py",
        "requeue RPC failing while rebalancing a dead worker's "
        "transfer — the fault must be absorbed (logged + counted), "
        "never lose the transfer"),
    "fleet.enqueue": (
        "fleet/distributed.py",
        "durable admission enqueue RPC failing before the ticket is "
        "stored (coordinator unreachable) — submitters retry, and the "
        "idempotent enqueue guarantees the retry can never "
        "double-admit the ticket"),
    "fleet.claim": (
        "fleet/worker.py",
        "ticket claim RPC failing at the WDRR pick (coordinator "
        "unreachable as the worker asks for work) — the worker must "
        "absorb it and re-pick; the ticket stays claimable and exactly "
        "one claimer can ever win it"),
    "fleet.complete": (
        "fleet/worker.py",
        "ticket completion RPC failing after the transfer delivered "
        "(coordinator unreachable at the worst moment) — the worker "
        "retries the fenced completion; a duplicate completion under "
        "the same epoch is idempotent, a stale one is fenced"),
    "fleet.preempt": (
        "fleet/distributed.py",
        "lease-revocation RPC failing as an INTERACTIVE arrival "
        "preempts the lowest-priority in-flight ticket — the "
        "preemption is dropped for this tick (the arrival waits one "
        "lane-drain longer), never half-applied"),
    "worker.spawn": (
        "fleet/worker.py",
        "worker process/thread spawn failing (fork limit, image pull "
        "error) — the supervisor absorbs it and the autoscaler retries "
        "on its next step; the fleet keeps running on the survivors"),
    "worker.heartbeat": (
        "fleet/worker.py",
        "worker heartbeat failing (coordinator unreachable): transient "
        "failures must be absorbed by the ticket lease TTL; with "
        "raise:WorkerKilledError the heartbeat dies and the worker's "
        "claimed ticket is reclaimed by a survivor after expiry"),
    "obs.export": (
        "stats/fleetobs.py",
        "observability-segment export failing (coordinator "
        "unreachable at heartbeat cadence) — export is best-effort: a "
        "failed export must never fail the part/ticket it rode on, "
        "and at most one export interval of observability is lost "
        "(the next beat re-sends the window under the same seq)"),
    "obs.merge": (
        "stats/fleetobs.py",
        "a torn/truncated obs segment hitting the reader's merge "
        "(writer SIGKILLed mid-put) — the merge must skip and count "
        "the corrupt segment and still render the pane from the "
        "survivors"),
    "watermark.advance": (
        "stats/watermark.py",
        "freshness-watermark advance failing (bookkeeping fault) — "
        "absorbed and counted: a watermark fault must never fail the "
        "batch it rode on, and the per-(transfer, table) watermark "
        "stays monotone (the fleet_distributed chaos mode asserts a "
        "worker kill never regresses a published watermark)"),
    "slo.evaluate": (
        "stats/slo.py",
        "SLO burn-rate evaluation failing mid-verdict — the evaluator "
        "must surface an error payload to the caller (`/debug/slo` "
        "reports it, `trtpu slo` exits 2), never a half-computed "
        "verdict that could latch or clear the QoS plane wrongly"),
    "mvcc.append": (
        "mvcc/store.py",
        "delta-layer append failing between the coordinator admission "
        "and the in-process layer install (worker dies mid-append) — "
        "the retried append re-admits idempotently under the same "
        "(worker, seq) and the layer lands exactly once in merge "
        "order; a layer arriving after the cutover seal is fenced"),
    "mvcc.cutover": (
        "mvcc/store.py",
        "the single cutover fence RPC failing at the worst moment "
        "(coordinator unreachable as the watermark+epoch decision "
        "seals) — the retry must re-ask and get the idempotent grant "
        "or the sealed decision; two racing cutovers must agree on "
        "exactly one (watermark, epoch)"),
    "mvcc.compact": (
        "mvcc/compact.py",
        "compaction ticket dying between materializing the merged "
        "base version and pruning the folded delta layers (kill -9 "
        "mid-compaction) — the retried SCAVENGER ticket re-merges "
        "idempotently: reads stay byte-identical whether the deltas "
        "were pruned or not"),
    "mvcc.spill": (
        "mvcc/spill.py",
        "layer/base spill dying between the landing's local encode "
        "and the coordinator blob put (worker SIGKILL mid-spill) — "
        "the landing must fail WHOLE (no manifest record naming a "
        "missing blob) and the idempotent retry redoes both halves "
        "under the same deterministic blob name"),
    "mvcc.rebuild": (
        "mvcc/spill.py",
        "a restarted worker dying at the start of a manifest rebuild "
        "(second kill during recovery) — the retried rebuild must "
        "reconstruct the scope byte-identically from the doc + blobs, "
        "layers in admission order, dict pools re-adopted"),
    "mvcc.offset_commit": (
        "mvcc/pump.py",
        "the fenced source-offset commit dying between the cutover "
        "seal and the client commit (pump killed at the worst moment) "
        "— the sealed offsets are already in the decision, so the "
        "retried commit re-reads and re-commits them idempotently; "
        "a pump that lost the race commits the SEALED values, never "
        "its local view"),
    "client.s3.request": (
        "coordinator/s3client.py",
        "S3 wire request failing (timeout, 5xx, connection reset)"),
    "client.kafka.roundtrip": (
        "providers/kafka/client.py",
        "kafka broker roundtrip failing (broken socket, leader moved)"),
}


def site_names() -> frozenset:
    return frozenset(SITES)
