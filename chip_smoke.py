#!/usr/bin/env python3
"""Chip smoke test of the PyTorch port (transferia_tpu_torch) on one CUDA card.

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (one JSON line each, then the kernels line, the card line and the
final line):
  1. build: compile every CUDA kernel from the checkout's sources;
  1b. hostlib: the port's C++ host library (transferia_tpu_torch/native,
     built with g++) holds every bound entry point exactly against the
     port's pure Python/numpy routes (Python specs here for the entry
     points the port does not call yet) on the card's host CPU, whose
     SHA-NI and SSE4.2 dispatch it reports;
  2. kernels: each kernel against its plain PyTorch version on the card
     (and against hashlib / the host evaluator / the host SHA-block
     pack), exact equality; K10 and var_accumulators also at their edges
     (rows of 0-100,000 bytes at every start offset mod 16, UTF-8, nulls,
     mixed kinds, the by-value column limit and one past it), the shard
     histogram at every bin count from 1 to 4,096, none and all kept,
     1,000 launches back to back, two streams in flight and a launch
     whose error comes back after it ran, also against torch.bincount;
     K-C also at row counts that are not a multiple of a block's rows
     or of 32, with validity on every dtype and without, and over
     predicates of any size on 320 columns (a 70-literal OR, IN of 70
     and of 4,000 literals, NOT IN with NULL, an AND over 20 and over 320
     columns, a 70-deep nesting, 70 comparisons); the digest gather at
     row counts that are not a multiple of a warp's rows, and n = 1;
  3. main_path: 2,000,000 ClickBench-shaped rows (made as bench.py makes
     them, seed 42) through build_chain(...).apply in 131072-row batches
     with device placement and the default chunking; the output must be
     byte-identical to the host strategy on the same batches;
  3b. main_path_devpack: the same with TRANSFERIA_TPU_PALLAS_PACK=1 (the
     flat bytes ship and kernel K12 packs them on the card, one launch
     per batch); the output must be byte-identical to main_path's;
  3c. dispatch: bench.py measure_dispatch's shape (4 x 131,072 rows, URL
     dictionary-encoded over 4,096 values, RegionID, seed 11; one warm
     batch) with the dispatch encoding raw and auto and the host
     strategy, each over a fresh pool; all three byte-identical, auto
     keeps URL dict-encoded with no flat materialization and one K-A
     launch over the pool; a pool of 2 x rows + 1 values launches no K-A
     and equals the host strategy;
  4. fingerprint_flat: the same rows through
     TableFingerprinter(backend="device"); the digest must equal the
     plain version's on the card, the digest of the rows cut into
     100,003-row batches, and the digest with one batch permuted;
  5. fingerprint_dict: bench.py measure_checksum_dict's shape (8 x
     262,144 rows, seed 13, an int64 id and three dictionary columns over
     4,096-value pools); the dict digest must equal the flat digest and
     the plain version's, with no flat materialization, and
     batch_row_keys on the card must equal the plain keys;
  6. decode: bench.py measure_device_decode's shape (4,194,304 codes of
     17 bits, a 131,072-entry int32 pool, seed 13); the output must equal
     pool[codes], and a 64-iteration decode_dict_loop its plain version;
  7. main_path_mesh: main_path's rows and config through the chain's
     mesh route on a 4-shard virtual mesh of the card
     (`testing.force_virtual_mesh(4)`, parallel/fusedmesh.py): every
     batch runs sharded (K-A, K-B, K-C and the shard histogram on each
     shard), the output byte-identical to main_path's, each batch's
     kept count and shard histogram equal to a host bincount of its
     output;
  8. dispatch_mesh: the dispatch phase's dictionary batches through the
     mesh's dict route: one K-A launch for the pool, the digest gather
     on every shard, output byte-identical to the host strategy, URL
     still dictionary-encoded with no flat materialization;
  9. mesh_step: sharded_transform_step (K13) on the 4-shard mesh, 2
     columns x 524,288 rows of 2-block messages (64 MB of blocks a
     column), equal to a 1-shard mesh, to hashlib on sampled rows and
     to a host bincount;
 10. mesh1: bench.py measure_mesh_1dev's shape (131,072 rows, RegionID <
     400, seed 21) through ShardedFusedProgram on a 1-shard mesh against
     FusedMaskFilterProgram, interleaved, medians of 9;
 11. lambda_stream: BASELINE config #5's chain (the lambda transformer
     with the SR fan-in user function, ops.lambdas.bench_lambda) over
     bench.py measure_kafka_sr2ch's rows, 64 partitions x 1,200
     messages cut as the Kafka source fetches them (1,024 + 176 rows a
     partition; the 176-row batches bucket to 256); device placement
     launches K15 once a batch, host placement never; both equal the
     plain reference column by column, id re-typed INT32;
 12. lambda_backlog: the same over a catch-up backlog of 64 x 16,384
     messages (1,024 batches of 1,024 rows), and once more under auto
     placement, reporting where its EWMA settled;
 13. kafka2ch: BASELINE config #1's chain (rename_tables .events ->
     .events_clean, mask_field user_email) over 1,048,576 rows in
     1,024-row batches: the mask fuses after the rename (one K-A launch
     a batch), device and host placement byte-identical, sampled rows
     equal to hashlib's HMAC;
 14. snapshot: the README's Quick-start transfer through the port's
     SnapshotLoader on a memory coordinator: 2,000,000 `sample` users
     rows (dictionary-encoded country), 4 parts on 4 upload threads,
     16,384-row source batches merged by the memory sink's Bufferer into
     131,072-row flushes, staged commits, fingerprint validation; the
     README's chain (mask on the card, the utf8 IN filter on the host)
     with device placement, and the chain with the filter `age >= 21`
     (fused: K-A, K-B and K-C) with device, host and auto placement.
     Per chain the sink's rows sorted by user_id are byte-identical
     across placements and their ids equal numpy's over the generator's
     columns; each published digest equals TableFingerprinter on the
     card and the plain version over the sink's rows; every part is
     completed and committed; the runs' launches, counted across the
     threads, hold K-A, K-B, K-C and K10; the fingerprint tap's auto,
     the reference's measured choice, times the host lanes on each
     part's first two batches and sends every later one to K10, and
     its choices print with the host's measured and the card's
     predicted ns/row;
 15. replication: INCREMENT_ONLY transfers through the port's
     run_replication on a memory coordinator, from the port's fake Kafka
     broker into its fake ClickHouse, device and host placement: (a)
     bench.py measure_kafka2ch's shape (16 partitions x 1,500 JSON
     messages, parallelism 4, no Bufferer, mask_field url + filter_rows
     "region < 400": K-A, K-B and K-C on the card) and (b) BASELINE
     config #1 (examples/kafka2ch.yaml: rename + mask of user_email,
     the CH target's default Bufferer) over a backlog of 16 partitions
     x 1,024 messages of the kafka2ch phase's generator (K-A; cut from
     16,384 a partition for the call's time).  Exact
     row counts in the fake, rows sorted by id identical across
     placements, sampled masks equal to hashlib's HMAC, kept ids equal
     to numpy's, no unparsed rows, every partition's last offset
     committed; it reports rows/s, the transform p50/p99 (the
     Transformation's stage timer) and the batch sizes the chain saw;
 15b. sr2ch: BASELINE config #5, bench.py measure_kafka_sr2ch's shape
     through run_replication: 64 partitions x 1,200 confluent-wire Avro
     records from the port's fake broker, resolved through its fake
     schema registry by the confluent_schema_registry parser (the host
     library's avro_decode_flat), the lambda (K15), the fake ClickHouse
     with no Bufferer, parallelism 4; device and host placement.  All
     76,800 rows land, ids equal numpy's sign flip truncated to int32,
     rows identical across placements, K15 launched at least once a
     chain batch on the card and never on the host; it reports rows/s,
     the batches the chain saw and the columnar route's share;
 15c. pg2ch: BASELINE config #2, bench.py measure_pg2ch's shape through
     activate_delivery: 300,000 rows from the port's fake Postgres (COPY
     CSV decoded by the port), filter_rows "region < 400 AND score >=
     10" (host path: a filter alone is not fused, in either package),
     the fake ClickHouse with no Bufferer and staged commits, whose
     dedup window keys each staged push with K10 on the card; device
     and host placement.  The delivered count equals bench.py's
     expected count, rows identical across placements, one
     __trtpu_commits row a part, no staging table left, K10 alone
     launched and as often in both runs, and the keys K10 gave each
     staged push on the path equal to its plain version's over the same
     batch, one push a launch; it reports rows/s over the 300,000;
 15c'. checksum: the checksum task (tasks/checksum.py) over pg2ch's
     300,000 rows transferred by activate_delivery without the filter
     (a checksum compares whole tables): checksum(PGStorage, CHStorage)
     by fingerprint with fingerprint_backend "device" (K10 in reduce mode
     on the card), "host" (the host library's lanes) and "auto" (the
     measured choice, its placements printed), and by compare (the
     sampled strategy: the table is over 20 MiB); then with one
     ClickHouse value altered; then a dictionary-encoded copy of the
     table (url over a fresh 997-value pool) against its flat rows,
     which launches trt_var_accumulators once for the pool; on the card,
     and with device="cpu" the "device" backend (K10's plain version;
     the host lanes and the compare run alike in both).  Every clean run
     reports ok, every method
     reports the altered table failed and its row-level pass names the
     key, the device, host and auto digests are equal (and the card's
     equal the CPU's), the host lanes launch nothing, and each batch K10
     fingerprinted is keyed again on the card against the plain version;
 15c''. sai: config #2 as SNAPSHOT_AND_INCREMENT through the MVCC staging
     store (mvcc/): the pg2ch table snapshotted by
     activate_snapshot_and_increment into the store while an MvccPump
     over the port's Kafka client feeds 60,000 JSON messages (seed 23,
     16 partitions: two versions each of 20,000 of the snapshot's keys
     and of 10,000 new keys, the parser naming the snapshot's table);
     the cutover seals the watermark, epoch and offsets, only the sealed
     offsets are committed, and the merged image publishes through the
     filter with the ClickHouse staged commit; on the card and with
     device="cpu".  ClickHouse equals numpy's latest-wins image after
     the filter with no duplicate key, resume_state equals numpy's
     watermark and offsets, the committed offsets the sealed ones, and
     every K10 launch (the store's PK and content keys, the staged
     dedup keys) equals its plain version.  Then the wal2json tail:
     activate_delivery of the same table as SNAPSHOT_AND_INCREMENT with
     no pump, and run_replication of 20,000 new inserts; ClickHouse
     equals numpy's.  Each run is traced and prints its stage table;
 15d. my2kf: BASELINE config #4, bench.py measure_mysql2kafka's shape
     through activate_delivery: 100,000 rows from the port's fake MySQL
     (cut from bench.py's 200,000 for the chaos phase's room)
     (id bigint key, email varchar(255), region int), mask_field email
     with salt "bench" (K-A on the card, one launch a fused chunk and
     one for the salt's key states), Debezium envelopes, the port's fake
     Kafka with 16 partitions, topic cdc, staged commits on (one
     InitProducerId and one transactional produce a part; the dedup
     window keys each staged push with K10); device and host placement.
     Each run lands 100,000 records by offsets and by live_size, no
     superseded segment, every part committed; the records are
     identical across placements once ts_ms is set aside; every record
     decodes through the debezium parser to the generator's id and
     region and to the host mask route's HMAC of its email, and lies in
     crc32c(key) % 16 by the pure CRC32C; K-A launches on the card and
     never on the host, K10 as often in both, and each staged push's
     keys from K10 equal the plain version's; it reports rows/s over
     the 100,000 and the transactional request's bytes;
 15e. my2kf_cdc: BASELINE config #4's CDC half through run_replication
     (INCREMENT_ONLY): the port's fake MySQL holds a binlog of 100,000
     row changes of seed 17 (recipes/cdc.py: 70,000 inserts, 1 % NULL
     emails, 20,000 updates of live ids with a before and an after
     image, 10,000 deletes of distinct live ids; cut from 200,000 for
     the fleet phase's room) in 1,000 GTID
     transactions of 100 (GTID, TABLE_MAP of bigint, utf8mb4
     varchar(255), int, ROWS v2 events of at most 8,192 bytes, XID);
     the port's MySQLBinlogSource tails it, mask_field email (K-A on the
     card), Debezium envelopes, the 16-partition topic, no staged
     commit; device and host placement, timed until Kafka holds the
     100,000 records.  Both land every change once, checkpoint the fed
     executed set at the binlog's end, and are identical once ts_ms is
     set aside; every record, decoded by the port's DebeziumReceiver, is
     its change (op c/u/d, the after image with the HMAC of the plain
     email, NULL staying NULL, the before image's key) in crc32c(key) %
     16; each K-A launch (recorded on the card during the run) equals
     the plain version on its inputs; it reports rows/s, the transform
     p50/p99 (the stage timer, as replication (a) reads it), the
     checkpointed state and, each run traced, its stage tables (so do
     the next two phases);
 15f. pg2ch_cdc: BASELINE config #2's CDC half: 100,000 wal2json v2
     inserts of the pg2ch rows (the first third of the 300,000, a depth
     cut from PR 16 for the call's time) in transactions of 1,000, fed
     before the
     start and tailed by the port's PGReplicationSource through
     run_replication, the pg2ch filter (host path), the fake ClickHouse
     with no Bufferer; device and host placement.  The source creates
     its slot, ClickHouse holds numpy's kept rows in both placements,
     pg_wal_lsn is the last fed LSN, PostgresProvider.deactivate() drops
     the slot, and nothing launches on the card;
 15g. my2my_cdc: the MySQL target: the first 20,000 changes of
     my2kf_cdc's binlog through the same mask into MySQLSinker on a
     second fake MySQL; device and host placement.  Its db.users equals
     numpy's applied state (masked emails, updated rows, deleted ids
     gone), the checkpoint the fed set, and each K-A launch equals the
     plain version;
 15h. clickbench: BASELINE config #3, bench.py's run_pipeline.  The
     recipe writer (transferia_tpu_torch/recipes/) writes main_path's
     2,000,000 rows as bench.py's Parquet file (131,072-row groups,
     SNAPPY); the port's reader decodes row groups 0 and 15 equal to the
     generator's columns byte for byte; then bench.py's make_transfer
     shape (the fs source at 131,072-row batches, mask URL with
     "bench-salt", the filter pushed into the scan, the devnull sink,
     min(4, effective CPUs) upload threads) runs through SnapshotLoader
     on a memory coordinator: one warm-up, then device, host and auto
     placement.  Each run delivers exactly the rows numpy keeps
     (bench.py's completeness gate), kept + pruned = 2,000,000, every
     part committed; the device run launches K-A, K-B and K-C (their
     counts predicted and printed before the runs), the host run
     nothing; it reports rows/s over the source's 2,000,000 rows, the
     stage timer's source_decode and pivot seconds, scan_rows_pruned,
     the snappy route and the CPU's SHA-NI/SSE4.2 flags;
 15i. telemetry: the telemetry plane on the card, every earlier phase
     having run with tracing off.  With the trace, the stage timer and
     the ledger on: (1) clickbench's file again, device then host
     placement: the rows delivered equal the untraced phase's; on the
     card the spans nest part > batch > fused_run > {pack,
     device_dispatch, device_wait}, and source_decode,
     native_rowgroup_decode and decode_readahead run on the readahead
     threads with parent links that resolve; TELEMETRY's launches equal
     K-A's launch count, its h2d bytes the path's staged bytes; the host
     run records no device span and no launch; the ledger's rows in and
     out equal the source's and the delivered rows and conservation
     holds; the device run's Chrome trace is written under
     build/torch_kernels/telemetry/ and loads with json.load;
     (2) the device run again with the device.dispatch and
     snapshot.part.batch failpoints armed to fire once each: the sink
     Retrier absorbs the first, the second fails a part once, so two
     fires, one part retry in the ledger and the same rows delivered; (3) replication (a) on the card: the spans hold
     replication_attempt, kafka_roundtrip, source_decode, transform,
     sink_wait and sink, and the transform spans' p50/p99 agree with
     the stage timer's window within 5 %; (4) my2kf at 25,000 rows (cut
     from 200,000 for the chaos phase's room) in both placements with
     every my2kf check; each run prints its stage table;
 15j. cli: the port's CLI on transfer.yaml files, as a user
     runs it, in this process and thread (TRANSFERIA_TPU_PLACEMENT's
     device placement): validate on the examples (OK, the s3 one too)
     and describe; replicate of a PG -> PG
     SNAPSHOT_AND_INCREMENT transfer (pg2ch's 300,000 rows and a
     50,000-row events table, mask_field on url, filter_rows region <
     400, transfer_ddl with an index, a view and a sequence): the MVCC
     activation publishes through the fused chain into the target's
     staged parts, then a wal2json tail of 20,000 changes (inserts,
     updates, deletes, seed 29), fed once the slot exists, ends on
     SIGTERM once its last LSN is confirmed; the target equals numpy's
     image, one fence row a part, no staging table, the DDL applied;
     checksum by K10 against a fake holding numpy's image (exit 0), and
     with one value altered (exit 1); upload of the events table from a
     cursor moves exactly the new rows' kept ones; `python3 -m
     transferia_tpu_torch.cli.main activate` in a subprocess.  Every
     K-A, K-B, K-C and K10 launch of the in-process commands is held
     against its plain version;
 15k. sharded: BASELINE config #2 across processes on the filestore
     coordinator, through the CLI on one transfer.yaml (pg2ch's 300,000
     hits rows and cli's 50,000-row events table in the port's fake
     Postgres, on heap pages, split by ctid into 15 + 3 parts; the
     fused mask + region < 400 into the fake ClickHouse, staged commits
     on; validation: {fingerprint: true}): (a) job 0 here, jobs 1 and 2
     as `python3 -m transferia_tpu_torch.cli.main --device cuda`
     processes started together: every rc 0, every part completed, each
     job at least one part, the target equal to numpy's image once, a
     fence row a part, no staging table, the recorded fingerprints equal
     to K10's plain version over the image, checksum
     --against-operation 0 clean and 1 with a value altered; the same
     YAML with --job-count 1 beside it; (b) (a) again with 3-s leases,
     1-s heartbeats and job 2 slowed by a failpoint delay, SIGKILLed
     while it holds a lease: the survivors steal its parts and the
     target is still exact; (c) Kafka -> fs (jsonl), 16 partitions x
     4,096 messages through replication (a)'s mask + filter, one
     PartitionedWorker pipeline a partition: the files equal hashlib's
     image, each row once.  Every K-A, K-B, K-C and K10 launch of this
     process is held against its plain version;
 15l. s3: BASELINE config #3 from object storage.  bench.py's 2,000,000
     rows as 8 Parquet objects of 250,000 rows (131,072-row groups,
     SNAPPY) under hits/ on the port's fake S3, readable anonymously:
     (a) examples/clickbench_s3_parquet2ch.yaml with only endpoint_url
     added, validate then activate in a `python3 -m
     transferia_tpu_torch.cli.main` process (HITS_URL the objects'
     glob, CH_HOST a fake ClickHouse on port 8123): ClickHouse holds
     their 2,000,000 rows; the YAML activated again over the first 2
     objects, checksum by K10 exits 0, and 1 over a 25,000-row object
     with a value altered; (b) bench.py's mask +
     filter over the objects (ranged GETs, parts discovered while the
     upload runs, 8 upload threads, staged commits) into a fake
     ClickHouse, on the card and with device="cpu": the kept rows equal
     write_clickbench's count and the two tables landed byte-identical
     inserts part for part; rows/s,
     the parts and the traced stages (the GETs, source_decode, pack,
     device_wait, sink) printed; (c) (b) as 3 jobs on --coordinator s3
     over the same fake (job 0 here, jobs 1 and 2 as CLI processes): the
     8 parts split, each committed once, the inserts equal (b)'s; (d)
     16 jsonl objects of 4,096 rows landing while run_replication polls,
     then while it takes their SQS events, through replication's mask +
     filter into ClickHouse, each row once; and the poll objects
     snapshotted into s3://clickbench/out through the staged jsonl sink
     with one push torn and retried: one copy published.  Every launch
     of this process (K-A, K-B, K-C, K10 and trt_var_accumulators) is
     held against its plain version, as many held as counted;
 15m. fleet: the fleet control plane on the card.  (a) `trtpu fleet
     bench` at its defaults (120 sample -> memory transfers over 8
     workers x 2 lanes, seed 7, the 10:1 tenant skew): every transfer
     delivered once, nothing lost or double-admitted, Jain >= 0.9,
     dispatch p50/p99; (b) the s3 phase's 8 objects as 8 transfer_yaml
     tickets of 4 tenants (BATCH and SCAVENGER) through bench.py's
     chain into a fake ClickHouse each, on a filestore queue drained by
     worker 0 (a FleetWorker thread here) and workers 1-2 (`python3 -m
     transferia_tpu_torch.cli.main worker` processes): an INTERACTIVE
     ticket revokes worker 0's first BATCH ticket at the part boundary
     after its part committed (it resumes from that part), and worker 2
     is SIGKILLed holding a ticket (reclaimed after its 3-s lease);
     every ticket done once, each ClickHouse holding numpy's count of
     the object's kept rows in one fenced part (the preempted and the
     reclaimed ones row for row: numpy's WatchIDs, each URL the hmac of
     the source's); (c) the MVCC compaction ticket on a store of a base
     and 6 delta layers, enqueued twice (one admission) and run by a
     fleet worker: `read_at` equal before and after; (d) `top --fleet`,
     `trace --fleet`, `slo --fleet` and `explain` over (b)'s segments:
     every worker's segment present, each ticket's merged ledger rows
     equal to the rows ClickHouse holds.  Every K-A, K-B, K-C and K10
     launch of this process is held against its plain version;
 15n. delta: a Delta Lake table -> ClickHouse through the event model
     (events/, tasks/snapshot_v2.py).  The s3 phase's objects copied
     under delta/ as Delta tables on the same fake S3: (a)
     examples/delta2ch.yaml with only endpoint_url added, `activate`
     through cli.main here over a table whose log adds objects 0-2 and
     7, then adds 3 and removes 7 (1,000,000 live rows), bench.py's mask
     and filter behind the bridge, on the card (traced) and with
     --device cpu: ClickHouse holds numpy's kept count of the live
     objects, the two tables landed byte-identical inserts, the CPU run
     launched nothing; then the same YAML over a one-object table in a
     `python3 -m transferia_tpu_torch.cli.main --metrics-port P
     activate` process, its /metrics scraped once while it runs (the
     Prometheus text format, prometheus_client's default families),
     its ClickHouse numpy's kept count; (b) the one-object table with no
     transformation: ClickHouse's native a2 target, CREATE before the
     first INSERT, every row equal to numpy's, nothing launched; (c)
     `checksum --method fingerprint --fingerprint-backend device` of the
     25,000-row object's table: against its ClickHouse copy the
     reference's verdict (the Delta source counts no rows: "row counts
     differ: src=0", exit 1, no fingerprint), against a memory copy exit
     0 by K10; (d) the one-object table through replace_primary_key,
     bench.py's chain and number_to_float on the card and on the CPU:
     byte-identical inserts.  Every K-A, K-B, K-C and K10 launch of this
     process is held against its plain version;
 15o. chaos: the chaos runner (chaos/) on the card through cli.main
     here: (a) `--device cuda chaos --mode all --trials 1 --seed 7
     --json`: snapshot, replication, worker_crash, scheduler_kill,
     fleet_distributed, lock_order, exactly_once over the memory,
     postgres, clickhouse, kafka and s3 backends (the port's fakes) and
     snapshot_and_increment's layered scenario, each passing its
     delivery audit, with the fused mask forced to the card (the
     device.dispatch site fires; the trials' float64 filter stays on
     the host in both packages, so K-B and K-C do not launch) and the
     auditor's row keys on K10;
     the arrow_ipc mode, the arrow_ipc and ydb backends and the S&I
     pump scenario reported skipped (ROADMAP.md A7); per mode its
     trials, restarts, kills, fenced publishes, duplicates absorbed and
     seconds, and the sites fired; (b) `--mode snapshot --trials 2`
     twice: the two reports' specs and fire logs byte-identical (seed
     replay on the card); (c) a negative control: a clean snapshot's
     delivery passes its audit and fails it on at-least-once with one
     batch dropped.  Every K-A, K-B, K-C and K10 launch of this process
     is held against its plain version;
 15p. check: `check --strict` (analysis/, the port's lint) over
     transferia_tpu_torch on this host: exit 0, no finding, its seconds
     and rule count, nothing launched;
 16. timing: each kernel at its path's shapes, beside its plain version,
     a PyTorch library call where one exists, and its bound on an H100
     (3.35 TB/s HBM; 64 INT32 lanes a SM at the card's maximum SM clock,
     against the SASS instructions counted from this run's build: K-A's
     compression loop, K10's paths, K12's thread, the histogram's warp
     step, the gather's thread; K-C against the compares and folds its
     predicate needs, its interpreter's SASS count reported beside
     them); K-C also with validity, with the 70-literal OR and 70
     comparisons; K-A also at kafka2ch's 1,024-row batch and at the
     snapshot phase's chunk of emails; and the launch floor, probe.cu's
     empty kernel timed alike.
Each path names the kernels it must launch (PATH_KERNELS); the launch
counts are zeroed just before the path runs and read just after it, and
a kernel of the path that never launched fails the run.  Any failure
raises and exits non-zero.  Without CUDA it exits 2 and prints no result.
"""

from __future__ import annotations

import ctypes
import hashlib
import hmac
import importlib
import json
import os
import re
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    new_table_schema,
)
from transferia_tpu_torch.columnar.batch import (
    Column,
    ColumnBatch,
    DictEnc,
    DictPool,
    _offsets_from_lengths,
    bucket_rows,
    flat_materializations,
    reset_flat_materializations,
)
from transferia_tpu_torch.ops import _build
from transferia_tpu_torch.ops import rowhash
from transferia_tpu_torch.ops.decode import (
    DELTA_TILE,
    MODE_BITS,
    MODE_DELTA,
    MODE_FOR,
    MODE_UNPACK,
    _dict_decode_launch,
    _wrap_i32,
    decode_dict_loop,
    decode_dict_loop_plain,
    decode_dict_run,
    decode_dict_run_plain,
    dict_staged_entries,
    pack_mask_words,
    pred_decode,
    pred_decode_plain,
    unpack_plain,
)
from transferia_tpu_torch.ops.dispatch import (
    dispatch_bytes,
    encode_pred_column,
    pack_bits_host,
    reset_dispatch_bytes,
    set_dispatch_encoding,
)
from transferia_tpu_torch.ops.fused import (
    FusedMaskFilterProgram,
    _chunk_rows,
    pack_hmac_blocks,
    pow2_blocks,
)
from transferia_tpu_torch.ops.lambdas import (
    REGION_THRESHOLD,
    region_sign_flip,
    region_sign_flip_plain,
)
from transferia_tpu_torch.ops.raggedpack import (
    pack_blocks_device,
    pack_blocks_plain,
    ragged_pack,
)
from transferia_tpu_torch.ops.linkprobe import _empty_launch, probe_link
from transferia_tpu_torch.ops.sha256 import (
    _hmac_key_states,
    _words_to_bytes,
    prepare_padded_blocks,
    sha256_hmac,
    sha256_hmac_plain,
    sha256_padded,
)
from transferia_tpu_torch.parallel import make_mesh, sharded_transform_step
from transferia_tpu_torch.parallel.fusedmesh import (
    ShardedFusedProgram,
    digest_gather,
    digest_gather_plain,
)
from transferia_tpu_torch.parallel.mesh import (
    example_step_args,
    shard_hist_fused,
    shard_hist_fused_plain,
    shard_hist_step,
    shard_hist_step_plain,
)
from transferia_tpu_torch.predicate import compile_mask, parse
from transferia_tpu_torch.predicate.device import (
    HAS_NULL,
    OP_AND,
    OP_CMP,
    OP_CMP_NULL,
    OP_IN,
    OP_ISNULL,
    OP_NOT,
    OP_OR,
    compile_mask_program,
    device_compatible,
    eval3_torch,
    pred3vl_mask,
)
from transferia_tpu_torch.coordinator import MemoryCoordinator
from transferia_tpu_torch.models import (
    Runtime,
    ShardingUploadParams,
    Transfer,
)
from transferia_tpu_torch.providers.memory import (
    MemoryTargetParams,
    get_store,
)
from transferia_tpu_torch.providers.sample import (
    SampleSourceParams,
    make_batch,
)
from transferia_tpu_torch.middlewares import fingerprint_tap
from transferia_tpu_torch.middlewares import sync as sync_mw
from transferia_tpu_torch.models import TransferType
from transferia_tpu_torch.providers.clickhouse import CHTargetParams
from transferia_tpu_torch.providers.kafka import KafkaSourceParams
from transferia_tpu_torch.providers.kafka.client import KafkaClient
from transferia_tpu_torch.providers.kafka.protocol import Record
from transferia_tpu_torch.parsers import Message, make_parser
from transferia_tpu_torch.parsers.plugins import ConfluentSRParser
from transferia_tpu_torch.providers.kafka import KafkaTargetParams
from transferia_tpu_torch.providers.kafka import client as kafka_client
from transferia_tpu_torch.providers.mysql import MySQLSourceParams
from transferia_tpu_torch.providers.postgres import PGSourceParams
from transferia_tpu_torch.providers import staging
from transferia_tpu_torch.abstract.interfaces import is_columnar
from transferia_tpu_torch.recipes.fake_mysql import FakeMySQL, FakeMyTable
from transferia_tpu_torch.recipes.fake_postgres import FakePG, FakeTable
from transferia_tpu_torch.recipes import cdc
from transferia_tpu_torch.debezium.receiver import DebeziumReceiver
from transferia_tpu_torch.ops import sha256 as sha256_mod
from transferia_tpu_torch.providers.mysql import MySQLTargetParams
from transferia_tpu_torch.providers.postgres.replication import int_to_lsn
from transferia_tpu_torch.providers.registry import get_provider
from transferia_tpu_torch.recipes.fake_sr import FakeSchemaRegistry
from transferia_tpu_torch.tasks import activate_delivery
from transferia_tpu_torch import native
from transferia_tpu_torch.columnar.batch import (
    _gather_fixed,
    _gather_varwidth,
    _gather_varwidth_plain,
)
from transferia_tpu_torch.ops.fused import pack_hmac_blocks_plain
from transferia_tpu_torch.providers.clickhouse import rowbinary
from transferia_tpu_torch.providers.file import FileProvider, FileSourceParams
from transferia_tpu_torch.providers.kafka import protocol
from transferia_tpu_torch.providers.parquet_meta import parquet_metadata
from transferia_tpu_torch.providers.parquet_native import (
    NativeParquetReader,
    dict_encoded_columns,
)
from transferia_tpu_torch.providers.stdout import NullTargetParams
from transferia_tpu_torch.recipes.clickbench import (
    clickbench_rows,
    flat_strings,
    slice_rows,
    write_clickbench,
)
from transferia_tpu_torch.coordinator import S3Coordinator
from transferia_tpu_torch.providers.misc_providers import DeltaSourceParams
from transferia_tpu_torch.providers.s3 import S3SourceParams, S3TargetParams
from transferia_tpu_torch.recipes.fake_s3 import FakeS3
from transferia_tpu_torch.runtime.limits import effective_cpus
from transferia_tpu_torch.transform.plugins import mask as mask_plugin
from transferia_tpu_torch.recipes.fake_clickhouse import FakeCH
from transferia_tpu_torch.recipes.fake_kafka import FakeKafka
from transferia_tpu_torch.runtime.device import resolve_device
from transferia_tpu_torch.runtime.local import run_replication
from transferia_tpu_torch.chaos import failpoints
from transferia_tpu_torch.stats import stagetimer, trace
from transferia_tpu_torch.stats.ledger import LEDGER
from transferia_tpu_torch.stats.registry import Metrics
from transferia_tpu_torch.abstract.table import TableDescription
from transferia_tpu_torch.mvcc import runner as mvcc_runner
from transferia_tpu_torch.mvcc import store as mvcc_store
from transferia_tpu_torch.mvcc.pump import MvccPump
from transferia_tpu_torch.providers.clickhouse import (
    CHSourceParams,
    CHStorage,
)
from transferia_tpu_torch.providers.kafka.provider import (
    _KafkaQueueClient as KafkaQueueClient,
)
from transferia_tpu_torch.providers.memory import (
    MemorySourceParams,
    MemoryStorage,
    seed_source,
)
from transferia_tpu_torch.providers.postgres.provider import PGStorage
# the module (the tasks package exports a `checksum` function)
checksum_mod = importlib.import_module("transferia_tpu_torch.tasks.checksum")
from transferia_tpu_torch.tasks import SnapshotLoader
from transferia_tpu_torch.testing import force_virtual_mesh
from transferia_tpu_torch.transform import build_chain
from transferia_tpu_torch.transform.fused import (
    DeviceFusedStep,
    set_placement,
)
from transferia_tpu_torch.transform.plugins.lambda_tf import (
    LambdaTransformer,
)
from transferia_tpu_torch.transform.plugins.rename import RenameTables

ROWS = 2_000_000          # bench.py BENCH_ROWS default
BATCH_ROWS = 131_072      # bench.py BENCH_BATCH_ROWS default
CONFIG = {"transformers": [   # bench.py make_transfer
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400 AND ResolutionWidth >= 390"}},
]}
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# An H100 SM has 64 INT32 lanes against 128 FP32 ones (NVIDIA H100 Tensor
# Core GPU Architecture white paper, the SM diagram; NVIDIA's table of
# arithmetic instruction throughput: 64 results a clock a SM for 32-bit
# integer add, shift, compare and logic at compute capability 9.0).  The
# integer peak is 64 x SMs x the SM clock that
# `nvidia-smi --query-gpu=clocks.max.sm` reports; main() sets it.
INT32_LANES_PER_SM = 64
INT32_OPS_PER_S = 0.0

KERNEL_META = {
    "sha256_hmac": ("transferia_tpu_torch/csrc/sha256_hmac.cu",
                    "transferia_tpu/ops/sha256.py:257"),
    "pred_decode": ("transferia_tpu_torch/csrc/pred_decode.cu",
                    "transferia_tpu/ops/decode.py:142"),
    "pred3vl_mask": ("transferia_tpu_torch/csrc/pred3vl_mask.cu",
                     "transferia_tpu/predicate/device.py:131"),
    "rowhash_lanes": ("transferia_tpu_torch/csrc/rowhash.cu",
                      "transferia_tpu/ops/rowhash.py:520"),
    "var_accumulators": ("transferia_tpu_torch/csrc/rowhash.cu",
                         "transferia_tpu/ops/rowhash.py:562"),
    "dict_decode": ("transferia_tpu_torch/csrc/pred_decode.cu",
                    "transferia_tpu/ops/decode.py:44"),
    "ragged_pack": ("transferia_tpu_torch/csrc/raggedpack.cu",
                    "transferia_tpu/ops/raggedpack.py:41"),
    "shard_hist": ("transferia_tpu_torch/csrc/mesh.cu",
                   "transferia_tpu/parallel/mesh.py:72"),
    "digest_gather": ("transferia_tpu_torch/csrc/mesh.cu",
                      "transferia_tpu/parallel/fusedmesh.py:171"),
    "region_sign_flip": ("transferia_tpu_torch/csrc/lambda_select.cu",
                         "bench.py:1015"),
}
# the histogram replaces two JAX programs' scatter-adds; K15 the user
# program the lambda transformer runs on the accelerator
ALSO_REPLACES = {
    "shard_hist": "transferia_tpu/parallel/fusedmesh.py:191",
    "region_sign_flip": "transferia_tpu/transform/plugins/lambda_tf.py:172",
}
# the kernels each path must launch, and the path whose launches and
# shapes a kernel's line in the kernels JSON reports
PATH_KERNELS = {
    "main_path": ("sha256_hmac", "pred_decode", "pred3vl_mask"),
    "main_path_devpack": ("ragged_pack", "sha256_hmac", "pred_decode",
                          "pred3vl_mask"),
    "dispatch": ("sha256_hmac", "pred_decode", "pred3vl_mask"),
    "fingerprint_flat": ("rowhash_lanes",),
    "fingerprint_dict": ("rowhash_lanes", "var_accumulators"),
    "decode": ("dict_decode",),
    "main_path_mesh": ("sha256_hmac", "pred_decode", "pred3vl_mask",
                       "shard_hist"),
    "dispatch_mesh": ("sha256_hmac", "digest_gather", "pred_decode",
                      "pred3vl_mask", "shard_hist"),
    "mesh_step": ("sha256_hmac", "shard_hist"),
    "mesh1": ("sha256_hmac", "pred_decode", "pred3vl_mask", "shard_hist"),
    "lambda_stream": ("region_sign_flip",),
    "lambda_backlog": ("region_sign_flip",),
    "kafka2ch": ("sha256_hmac",),
    # K10 keys the staged flushes; the fingerprint tap's auto is the
    # reference's measured choice: two host samples a part and table
    # (so the country pool's accumulators come from the host library and
    # are moved to the card, not computed: no trt_var_accumulators
    # launch), then K10 for every later batch (checked, TapChoices)
    "snapshot": ("sha256_hmac", "pred_decode", "pred3vl_mask",
                 "rowhash_lanes"),
    "replication": ("sha256_hmac", "pred_decode", "pred3vl_mask"),
    "clickbench": ("sha256_hmac", "pred_decode", "pred3vl_mask"),
    # the lambda's K15, once a chain batch
    "sr2ch": ("region_sign_flip",),
    # K10 in keys mode: the staged commit's dedup window keys each
    # staged push on the loader's device, in either placement.  The
    # filter alone is not fused (a run with no device mask stays on the
    # host path, transform/fused.py), so K-B and K-C do not launch
    "pg2ch": ("rowhash_lanes",),
    # from PR 16: the MVCC store keys each source batch (PK keys in the
    # merge, content keys a layer) and the staged publish keys its pushes,
    # all K10 in keys mode
    "sai": ("rowhash_lanes",),
    # the checksum's device fingerprint (K10 in reduce mode, one launch a
    # batch) and, for the dictionary-encoded copy, the pool's accumulators
    "checksum": ("rowhash_lanes", "var_accumulators"),
    # the mask's K-A, one launch a fused chunk (no predicate), and K10
    # keying each staged push for the dedup window, in either placement
    "my2kf": ("sha256_hmac", "rowhash_lanes"),
    # the binlog tail through the mask: K-A, one launch a fused chunk
    # of each flush (at most 1,024 rows and a ROWS event) and one for
    # the salt's key states; no staged commit, so no K10
    "my2kf_cdc": ("sha256_hmac",),
    # the wal2json tail through the filter alone (not fused): nothing
    # on the card
    "pg2ch_cdc": (),
    "my2my_cdc": ("sha256_hmac",),
    # clickbench, replication (a) and my2kf again, traced
    "telemetry": ("sha256_hmac", "pred_decode", "pred3vl_mask",
                  "rowhash_lanes"),
    # the CLI on transfer.yaml, PG -> PG: the fused mask and
    # filter on the snapshot's publish, the tail and the incremental
    # upload; K10 keying the MVCC store and the staged parts, and the
    # checksum command's fingerprint
    "cli": ("sha256_hmac", "pred_decode", "pred3vl_mask", "rowhash_lanes"),
    # from PR 18, config #2 sharded over three processes on the filestore
    # coordinator (this process is job 0): the fused mask and filter, K10
    # keying the staged pushes, the fingerprint tap and the checksum
    # against the operation; Kafka -> fs through the mask and filter
    "sharded": ("sha256_hmac", "pred_decode", "pred3vl_mask",
                "rowhash_lanes"),
    # config #3 from object storage: the fused mask and filter
    # of the headline and of the replication runs, K10 keying the
    # staged pushes (ClickHouse's and the bucket's) and fingerprinting
    # the checksum's batches, and the accumulators of the dictionary
    # pools the checksum meets in the objects' Parquet pages
    "s3": ("sha256_hmac", "pred_decode", "pred3vl_mask", "rowhash_lanes",
           "var_accumulators"),
    # the fleet: worker 0's tickets (this process) through the fused mask
    # and filter, K10 keying their staged pushes into ClickHouse and the
    # MVCC compaction ticket's keys and merged read.  The accumulators of
    # the objects' Parquet dictionary pools launch only where no earlier
    # phase memoized them (12 with the phase alone, 0 after `s3`); each
    # launch is held all the same
    "fleet": ("sha256_hmac", "pred_decode", "pred3vl_mask",
              "rowhash_lanes"),
    # from PR 21, a Delta Lake table -> ClickHouse through the event
    # model: the fused mask and filter behind the bridge (the CLI's
    # activation and the new host transformers around them), and K10 in
    # the checksum's device fingerprint (against a memory target: against
    # ClickHouse the Delta source's uncounted rows decide before any
    # fingerprint, as in the reference)
    "delta": ("sha256_hmac", "pred_decode", "pred3vl_mask",
              "rowhash_lanes"),
    # the chaos runner's gauntlet on the card: every trial's
    # fused mask (the runner forces the device placement, so the
    # device.dispatch site is on the path) and K10 keying the auditor's
    # rows, the fingerprint tap and the staged pushes.  The trials'
    # filter (temperature > -1000) reads a float64 column, which neither
    # package evaluates on the device (predicate/device.py
    # _DEVICE_SAFE), so it stays on the host and K-B and K-C do not
    # launch; any launch of theirs would be held all the same
    "chaos": ("sha256_hmac", "rowhash_lanes"),
    # the port's lint: a static pass, nothing on the card
    "check": (),
}
# the first path that lists a kernel reports it
KERNEL_PATH = {k: p for p, ks in reversed(PATH_KERNELS.items()) for k in ks}
FP_CUT_ROWS = 100_003
DICT_ROWS, DICT_BATCHES, DICT_UNIQUES = 262_144, 8, 4096  # bench.py
DICT_COLUMNS = ("URL", "Referer", "SearchPhrase")
DECODE_ROWS, DECODE_BITS, DECODE_ITERS = 1 << 22, 17, 64  # bench.py
DISPATCH_ROWS, DISPATCH_BATCHES, DISPATCH_UNIQUES = 131_072, 4, 4096
DISPATCH_CONFIG = {"transformers": [   # bench.py measure_dispatch
    {"mask_field": {"columns": ["URL"], "salt": "bench-salt"}},
    {"filter_rows": {"filter": "RegionID < 400"}},
]}
MESH_SHARDS = 4           # virtual shards of the one card (data 2 x model 2)
TARGET_SHARDS = 16        # the shard histogram's bins (the programs' default)
STEP_ROWS_PER_DEVICE, STEP_COLUMNS, STEP_MAX_BLOCKS = 262_144, 2, 2
MESH1_ROWS, MESH1_ITERS = 1 << 17, 9   # bench.py measure_mesh_1dev
# bench.py measure_kafka_sr2ch: 64 partitions x 1,200 messages, fetched
# at most 1,024 a partition (providers/kafka/provider.py:149); then a
# catch-up backlog of the same stream, 16,384 messages a partition
SR_PARTITIONS, SR_MESSAGES, SR_BACKLOG, FETCH_MAX = 64, 1200, 16_384, 1024
LAMBDA_CONFIG = {"transformers": [{"lambda": {
    "function": "transferia_tpu_torch.ops.lambdas:bench_lambda"}}]}
# BASELINE config #1 (examples/kafka2ch.yaml:25-27), a fixed MASK_SALT
KAFKA2CH_ROWS, KAFKA2CH_BATCH, KAFKA2CH_SALT = 1 << 20, 1024, b"kafka2ch-salt"
KAFKA2CH_CONFIG = {"transformers": [
    {"rename_tables": {"tables": [{"from": ".events",
                                   "to": ".events_clean"}]}},
    {"mask_field": {"columns": ["user_email"],
                    "salt": KAFKA2CH_SALT.decode()}},
]}
# the README's Quick-start transfer: sample users -> memory, 4 parts on
# 4 upload threads, Bufferer flushes of 131,072 rows, fingerprint
# validation; its chain (the utf8 IN keeps the filter on the host) and
# one whose filter fuses onto the card
SNAP_ROWS, SNAP_PARTS, SNAP_THREADS = 2_000_000, 4, 4
SNAP_BATCH, SNAP_TRIGGER, SNAP_SEED = 16_384, 131_072, 7
SNAP_TABLE, SNAP_SALT = TableID("sample", "users"), "s3cr3t"
SNAP_README = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": SNAP_SALT}},
    {"filter_rows": {"filter": "age >= 21 AND country IN ('de','us')"}},
]}
SNAP_FUSED = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": SNAP_SALT}},
    {"filter_rows": {"filter": "age >= 21"}},
]}
# replication through run_replication, fake Kafka -> fake ClickHouse:
# bench.py measure_kafka2ch's shape (16 partitions x 1,500 messages,
# parallelism 4, no Bufferer, mask + filter) and BASELINE config #1
# (examples/kafka2ch.yaml: rename + mask, the CH target's default
# Bufferer) over a backlog of 16 partitions x 1,024 messages of the
# kafka2ch phase's generator (cut from 16,384 for the later phases'
# time: (b) moves one fetch batch a Bufferer tick, so its run is about
# a second a 1,024-message batch, whatever the depth)
REPL_PARTITIONS, REPL_MESSAGES, REPL_SALT = 16, 1500, b"bench"
REPL_SCHEMA = [{"name": "id", "type": "int64", "key": True},
               {"name": "url", "type": "utf8"},
               {"name": "region", "type": "int32"}]
REPL_CONFIG = {"transformers": [
    {"mask_field": {"columns": ["url"], "salt": REPL_SALT.decode()}},
    {"filter_rows": {"filter": "region < 400"}},
]}
BACKLOG_MESSAGES = 1024
K2CH_SCHEMA = [{"name": "id", "type": "int64", "key": True},
               {"name": "user_email", "type": "utf8"},
               {"name": "amount", "type": "double"},
               {"name": "ts", "type": "timestamp"}]
REPL_SETTLE_S = 400.0
# BASELINE config #5, bench.py measure_kafka_sr2ch: 64 partitions x
# 1,200 confluent-wire Avro records (id long, url string, region int)
# through the schema-registry parser, parallelism 4, no Bufferer, the
# lambda; each partition produced at once
SR_AVRO_SCHEMA = {"type": "record", "name": "Hit", "fields": [
    {"name": "id", "type": "long"}, {"name": "url", "type": "string"},
    {"name": "region", "type": "int"}]}
# BASELINE config #2, bench.py measure_pg2ch: a 300,000-row Postgres
# table snapshotted through activate_delivery into ClickHouse with no
# Bufferer, staged commits on (the default)
PG2CH_ROWS = 300_000
PG2CH_COLUMNS = [("id", "bigint", True, True), ("url", "text", False, False),
                 ("region", "integer", False, False),
                 ("score", "double precision", False, False)]
PG2CH_CONFIG = {"transformers": [
    {"filter_rows": {"filter": "region < 400 AND score >= 10"}}]}
# from PR 16, config #2 as SNAPSHOT_AND_INCREMENT through the MVCC staging
# store: the pg2ch table snapshotted into the store while an MvccPump
# over the port's Kafka client feeds 60,000 JSON messages (seed 23) on 16
# partitions: two versions each of 20,000 of the snapshot's keys and of
# 10,000 keys it lacks, both versions of a key on its partition (key mod
# 16) so the second is the later write; the parser names the snapshot's
# table, so deltas override its base rows; the cutover, the staged
# publish through the filter; then activate_delivery of the same table
# with no pump and a wal2json tail of 20,000 new inserts
SAI_PARTITIONS, SAI_SEED = 16, 23
SAI_UPDATED, SAI_NEW, SAI_TAIL = 20_000, 10_000, 20_000
SAI_PARSER = {"json": {
    "table": "hits", "namespace": "public", "add_system_cols": False,
    "schema": [{"name": "id", "type": "int64", "key": True},
               {"name": "url", "type": "utf8"},
               {"name": "region", "type": "int32"},
               {"name": "score", "type": "double"}]}}
# the checksum task over pg2ch's table transferred without the filter (a
# checksum compares whole tables): fingerprint (device, host, auto) and
# compare, then one ClickHouse value altered; and a dictionary-encoded
# copy of the table (url over a fresh pool) against its flat rows, which
# launches trt_var_accumulators for the pool
CHECKSUM_TAMPERED_ID = 5
# BASELINE config #4, bench.py measure_mysql2kafka: a 200,000-row MySQL
# table through mask_field email -> Debezium envelopes -> a 16-partition
# Kafka topic, through activate_delivery, staged commits on (the
# default): one transactional produce a part
MY2KF_ROWS, MY2KF_PARTITIONS, MY2KF_SALT = 200_000, 16, b"bench"
# depth cuts for the chaos and check phases' room (with them added, the
# whole script took 1,008.46 s on an NVIDIA H100 80GB HBM3 at 700 W on
# a slow host; PERF.md section 4): the my2kf phase at 100,000 of
# bench.py's 200,000 rows, and telemetry's traced rerun of it at 25,000
MY2KF_CUT_ROWS, TELEMETRY_MY2KF_ROWS = 100_000, 25_000
MY2KF_COLUMNS = [("id", "bigint", "bigint", True, True),
                 ("email", "varchar", "varchar(255)", False, False),
                 ("region", "int", "int", False, False)]
MY2KF_CONFIG = {"transformers": [
    {"mask_field": {"columns": ["email"], "salt": MY2KF_SALT.decode()}}]}
TS_MS = re.compile(rb'"ts_ms":\d+')
# the CDC tails through run_replication (INCREMENT_ONLY), after my2kf:
# config #4's CDC half, a binlog of 100,000 row changes (seed 17:
# 70,000 inserts, 20,000 updates of live ids, 10,000 deletes; cut from
# 200,000 for the fleet phase's room) in 1,000 GTID transactions of 100
# (recipes/cdc.py), through the mask into the
# 16-partition topic with Debezium envelopes; config #2's CDC half,
# wal2json v2 inserts of the pg2ch rows in transactions of 1,000,
# through the filter into ClickHouse; and the first 20,000
# changes through the mask into a MySQL target
CDC_INSERTS, CDC_UPDATES, CDC_DELETES, CDC_TXN, CDC_SEED = (
    70_000, 20_000, 10_000, 100, 17)
# (pg2ch_cdc at 100,000 of the 300,000 messages from PR 16: the depth cut
# that makes room for the checksum and sai phases in the call's time)
PG_CDC_ROWS, PG_CDC_TXN = 100_000, 1000
MY2MY_CHANGES = 20_000
CDC_SETTLE_S = 300.0
# the chaos runner as the CLI drives it (every mode, one
# trial, seed 7) and what the port reports skipped (ROADMAP.md A7)
CHAOS_ARGV = ["--mode", "all", "--trials", "1", "--seed", "7", "--json"]
CHAOS_REPLAY_ARGV = ["--mode", "snapshot", "--trials", "2", "--seed", "7",
                     "--json"]
CHAOS_SKIPPED = {"arrow_ipc mode", "exactly_once backend arrow_ipc",
                 "exactly_once backend ydb",
                 "snapshot_and_increment pump scenario"}
CHAOS_MODES = {"snapshot", "replication", "worker_crash", "scheduler_kill",
               "fleet_distributed", "lock_order", "exactly_once",
               "snapshot_and_increment"}
CHAOS_BACKENDS = {"memory", "postgres", "clickhouse", "kafka", "s3"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class PathLaunches:
    """Zero the launch counts, run a path, read them; fail when a kernel
    of the path never launched."""

    def __init__(self, path: str):
        self.path = path
        self.counts: dict[str, int] = {}

    def __enter__(self):
        _build.reset_launch_counts()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.counts = _build.launch_counts()
        if exc_type is None:
            require_launched(self.path, self.counts)
        return False


def require_launched(path: str, counts: dict) -> None:
    """Fail when a kernel of the path never launched."""
    missing = [k for k in PATH_KERNELS[path] if counts[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the {path} "
                             f"path: {missing}")


def max_abs_diff(a: torch.Tensor, b: torch.Tensor) -> int:
    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def require_equal(a: torch.Tensor, b: torch.Tensor, what: str) -> int:
    err = max_abs_diff(a, b)
    if err != 0:
        raise AssertionError(f"{what}: kernel differs from its plain "
                             f"version (max abs err {err})")
    return err


# -- phase 2: kernels against their plain versions ---------------------------

def check_sha256_hmac(dev: torch.device) -> int:
    rng = np.random.default_rng(3)
    lens = [0, 1, 8, 55, 56, 63, 64, 100, 119, 120, 150, 183, 200, 247]
    lens += list(rng.integers(0, 248, 200))
    msgs = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lens]
    data = np.frombuffer(b"".join(msgs), dtype=np.uint8)
    offsets = np.zeros(len(msgs) + 1, dtype=np.int32)
    offsets[1:] = np.cumsum([len(m) for m in msgs])
    err = 0
    # SHA mode against hashlib
    blocks, nb, mb = prepare_padded_blocks(data, offsets)
    got = sha256_padded(torch.from_numpy(blocks).to(dev),
                        torch.from_numpy(nb).to(dev), mb)
    want = [hashlib.sha256(m).digest() for m in msgs]
    if [bytes(r) for r in _words_to_bytes(
            got.cpu().numpy().view(np.uint32))] != want:
        raise AssertionError("sha256_hmac (SHA mode) differs from hashlib")
    # HMAC mode: short, 64-byte and >64-byte keys; pad rows (n_blocks 0)
    for key in (b"k", bytes(range(64)), b"long-key" * 13):
        inner, outer = _hmac_key_states(key, dev)
        blocks, nb, mb = prepare_padded_blocks(data, offsets, prefix_len=64,
                                               max_blocks=4)
        blocks = np.pad(blocks, ((0, 24), (0, 0)))
        nb = np.pad(nb, (0, 24))
        b_t = torch.from_numpy(blocks).to(dev)
        nb_t = torch.from_numpy(nb).to(dev)
        got = sha256_hmac(b_t, nb_t, inner, outer, 4)
        err = max(err, require_equal(
            got, sha256_hmac_plain(b_t, nb_t, inner, outer, 4),
            "sha256_hmac"))
        hexes = [bytes(r).hex() for r in _words_to_bytes(
            got.cpu().numpy().view(np.uint32))[:len(msgs)]]
        want = [hmac.new(key, m, hashlib.sha256).hexdigest() for m in msgs]
        if hexes != want:
            raise AssertionError("sha256_hmac differs from hashlib HMAC")
    return err


def check_pred_decode(dev: torch.device) -> int:
    rng = np.random.default_rng(4)
    err = 0

    def both(mode, words, n, bw, base=0, mins=None, frame=0, what=""):
        w = torch.from_numpy(words.view(np.int32).copy()).to(dev)
        m = torch.from_numpy(mins).to(dev) if mins is not None else None
        got = pred_decode(mode, w, n, bw, base, m, frame)
        return require_equal(
            got, pred_decode_plain(mode, w, n, bw, base, m, frame), what)

    for n in (32768, 1000):
        bits = rng.integers(0, 2, n).astype(np.uint64)
        err = max(err, both(MODE_BITS, pack_bits_host(bits, 1), n, 1,
                            what="bits"))
        for bw in range(1, 33):
            vals = rng.integers(0, 2**bw, n, dtype=np.uint64)
            words = pack_bits_host(vals, bw)
            base = int(rng.integers(-2**31, 2**31))
            err = max(err, both(MODE_DELTA, words, n, bw, base=base,
                                what=f"delta bw={bw}"))
            if n % 256 == 0:
                mins = rng.integers(-2**31, 2**31, n // 256).astype(np.int32)
                err = max(err, both(MODE_FOR, words, n, bw, mins=mins,
                                    frame=256, what=f"for bw={bw}"))
    # the encoder's own wire: 30-bit delta cap, a multi-tile scan over
    # the largest bucket, and a 32-bit FOR span that wraps int32
    n = 1 << 20
    # alternating steps of just under 2^29: zigzag codes need 30 bits
    walk = ((np.arange(n) % 2) * (2**29 - 2001)
            + rng.integers(0, 1000, n)).astype(np.int32)
    spec, arrs = encode_pred_column("x", walk, None, n, n, True)
    if spec.kind != "delta" or spec.bit_width != 30:
        raise AssertionError(f"expected a 30-bit delta wire, got {spec}")
    w = torch.from_numpy(arrs[0].view(np.int32).copy()).to(dev)
    got = pred_decode(MODE_DELTA, w, n, 30, int(arrs[1]))
    err = max(err, require_equal(got, torch.from_numpy(walk).to(dev),
                                 "delta 30-bit cap vs source values"))
    span = np.tile(np.array([-2**31, 2**31 - 1], dtype=np.int64), 128)
    rel = (span - span.min()).astype(np.uint64)
    w = torch.from_numpy(pack_bits_host(rel, 32).view(np.int32).copy()).to(dev)
    mins = torch.tensor([-2**31], dtype=torch.int32, device=dev)
    got = pred_decode(MODE_FOR, w, 256, 32, mins=mins, frame=256)
    err = max(err, require_equal(got, torch.from_numpy(
        span.astype(np.int32)).to(dev), "for 32-bit span"))
    return max(err, check_delta_edges(dev), check_delta_streams(dev))


def pack_on_card(vals: torch.Tensor, bw: int) -> torch.Tensor:
    """pack_bits_host on the card: int64 values < 2^bw -> the packed
    little-endian word stream as int32 (value bits never overlap, so
    adding them into their words is OR-ing them)."""
    n = vals.numel()
    start = torch.arange(n, dtype=torch.int64, device=vals.device) * bw
    wi, off = start >> 5, start & 31
    words = torch.zeros((n * bw + 31) // 32 + 1, dtype=torch.int64,
                        device=vals.device)
    words.index_add_(0, wi, (vals << off) & 0xFFFFFFFF)
    spill = off + bw > 32
    words.index_add_(0, wi[spill] + 1, vals[spill] >> (32 - off[spill]))
    return _wrap_i32(words[:(n * bw + 31) // 32])


DELTA_EDGE_NS = (1, 31, 32, 33, DELTA_TILE - 1, DELTA_TILE, DELTA_TILE + 1,
                 3 * DELTA_TILE + 5, 65_536, 131_072, 1 << 20)


def wrapping_deltas(n: int, bw: int, gen: torch.Generator, dev):
    """Zigzag codes of width bw, every other one a large positive delta
    (an even code >= 2^(bw-1)), so at the wide widths the int32 sum wraps
    within and across tiles."""
    vals = torch.randint(0, 2**bw, (n,), generator=gen, device=dev,
                         dtype=torch.int64)
    if bw > 1:
        vals[::2] = (vals[::2] | (1 << (bw - 1))) & ~1
    return vals


def check_delta_edges(dev) -> int:
    """The delta scan at its tile edges, at every width, from a base near
    the top of int32; the card's packer against the host's."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    vals = wrapping_deltas(1000, 13, gen, dev)
    if not np.array_equal(
            pack_on_card(vals, 13).cpu().numpy().view(np.uint32),
            pack_bits_host(vals.cpu().numpy().astype(np.uint64), 13)):
        raise AssertionError("pack_on_card differs from pack_bits_host")
    err = 0
    base = 2**31 - 7
    for n in DELTA_EDGE_NS:
        for bw in range(1, 33):
            w = pack_on_card(wrapping_deltas(n, bw, gen, dev), bw)
            err = max(err, require_equal(
                pred_decode(MODE_DELTA, w, n, bw, base),
                pred_decode_plain(MODE_DELTA, w, n, bw, base),
                f"delta n={n} bw={bw}"))
    return err


def check_delta_streams(dev) -> int:
    """Two delta scans in flight at once on two streams, released
    together (each stream has its own scratch), eight times; then 1,000
    back to back on one stream (1,000 epochs on one scratch), and a scan
    of 1,025 tiles (the scratch grows)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(43)
    n, bw = 1 << 20, 30
    inputs = [(pack_on_card(wrapping_deltas(n, bw, gen, dev), bw), base)
              for base in (-2**31, 2**31 - 1)]
    want = [pred_decode_plain(MODE_DELTA, w, n, bw, b) for w, b in inputs]
    current = torch.cuda.current_stream(dev)
    streams = [torch.cuda.Stream(dev) for _ in inputs]
    torch.cuda._sleep(10_000_000)
    for s in streams:
        s.wait_stream(current)
    outs = [[] for _ in inputs]
    for _ in range(8):
        for i, ((w, b), s) in enumerate(zip(inputs, streams)):
            with torch.cuda.stream(s):
                outs[i].append(pred_decode(MODE_DELTA, w, n, bw, b))
    for s in streams:
        current.wait_stream(s)
    torch.cuda.synchronize(dev)
    err = 0
    for i, got in enumerate(outs):
        for o in got:
            err = max(err, require_equal(o, want[i], f"delta stream {i}"))
    n = 65_536
    w = pack_on_card(wrapping_deltas(n, bw, gen, dev), bw)
    zero = pred_decode_plain(MODE_DELTA, w, n, bw, 0).to(torch.int64)
    bases = torch.randint(-2**31, 2**31, (1000,), generator=gen,
                          device=dev).tolist()
    got = [pred_decode(MODE_DELTA, w, n, bw, b) for b in bases]
    for b, o in zip(bases, got):
        err = max(err, require_equal(o, _wrap_i32(zero + b),
                                     f"delta back to back base={b}"))
    for n in ((1 << 21) + 3, 65_536):
        w = pack_on_card(wrapping_deltas(n, bw, gen, dev), bw)
        err = max(err, require_equal(
            pred_decode(MODE_DELTA, w, n, bw, 5),
            pred_decode_plain(MODE_DELTA, w, n, bw, 5),
            f"delta n={n} after the scratch grew"))
    return err


PRED_CASES = [
    "b = true", "b != false", "i8 < -3", "u8 >= 200", "i16 BETWEEN -50 AND 50",
    "u16 > 30000", "i32 <= 12345", "f = 1.5", "f != 1.5", "f < 0",
    "f > 0.5 OR f IS NULL", "f IN (1.5, 2.5, NULL)", "f NOT IN (1.5)",
    "i16 IN (1, 2, 3)", "i16 NOT IN (1, NULL)", "i32 IS NULL",
    "i32 IS NOT NULL", "NOT i32 IS NULL", "i8 = NULL", "NOT i8 > 0",
    "NOT (i8 > 0 AND u8 < 100)", "NOT (i8 > 0 OR f < 0.5)",
    "(b = true OR i16 > 0) AND NOT (u16 < 100 OR i32 >= 0)",
    "i16 > 2.5", "u8 <= 100.5", "i16 IN (3, 1, 2, 3, 1)",
    "i32 IN (-2147483648, 2147483647, 0)", "u16 NOT IN (65535, 0, 7)",
    "b IN (true)", "i8 IN (5)", "",
]
PRED_SCHEMA = new_table_schema([
    ("b", "boolean"), ("i8", "int8"), ("u8", "uint8"), ("i16", "int16"),
    ("u16", "uint16"), ("i32", "int32"), ("f", "float"),
])


def pred_columns(n: int, seed: int) -> dict[str, tuple[np.ndarray,
                                                      np.ndarray]]:
    rng = np.random.default_rng(seed)
    f = rng.choice(np.array([0.0, 0.5, 1.5, 2.5, -1.0, np.nan],
                            dtype=np.float32), n)
    data = {
        "b": rng.integers(0, 2, n).astype(np.bool_),
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "i16": rng.integers(-100, 100, n).astype(np.int16),
        "u16": rng.integers(0, 65536, n).astype(np.uint16),
        "i32": rng.integers(-2**31, 2**31, n).astype(np.int32),
        "f": f,
    }
    return {k: (v, rng.random(n) > 0.2) for k, v in data.items()}


# row counts: a whole bucket, and counts that are not a multiple of a
# block's rows or, packed, of 32
PRED_NS = (32768, 999, 544, 33, 1)
# predicates of any size over WIDE_COLS columns of every dtype (a fourth
# of them with validity): more than 64 literals and 128 instructions
# (the earlier by-value program's limits), more columns than K-C takes
# by value, a 70-deep nesting, a program too large for a block's shared
# memory (4,000 literals, 64 KB), and more columns than the value tile
# holds (305 at 32 threads)
WIDE_TYPES = ("boolean", "int8", "uint8", "int16", "uint16", "int32", "float")
WIDE_COLS = 320
WIDE_SCHEMA = new_table_schema([(f"w{k}", WIDE_TYPES[k % len(WIDE_TYPES)])
                                for k in range(WIDE_COLS)])
WIDE_COND = {"boolean": "{} IN (true, false)", "int8": "{} > -120",
             "uint8": "{} != 7", "int16": "{} BETWEEN -90 AND 90",
             "uint16": "{} >= 100", "int32": "{} < 2000000000",
             "float": "{} != 2.5"}


def nested(depth: int) -> str:
    """`col > i OP (...)` nested `depth` deep, AND and OR alternating."""
    ints = ("w1", "w3", "w5", "w2", "w4")
    text = "w3 = 1"
    for i in range(depth):
        text = (f"{ints[i % len(ints)]} > {i} "
                f"{'AND' if i % 2 else 'OR'} ({text})")
    return text


def rare_cmps(cols, lows, highs, steps, k: int = 70) -> str:
    """An OR of k comparisons, each true on a few rows: column i % 3
    below its low end or above its high end by a margin that grows with
    i; no IN list can stand for them (k instructions)."""
    parts = []
    for i in range(k):
        j = i % len(cols)
        m = steps[j] * (i // 6 + 1)
        parts.append(f"{cols[j]} < {lows[j] + m}" if i % 2
                     else f"{cols[j]} > {highs[j] - m}")
    return " OR ".join(parts)


def wide_and(k: int) -> str:
    return " AND ".join(WIDE_COND[WIDE_TYPES[c % len(WIDE_TYPES)]].format(
        f"w{c}") for c in range(k))


LARGE_PRED_CASES = {
    "or70": " OR ".join(f"w3 = {i - 35}" for i in range(70)),
    "in70": f"w3 IN ({', '.join(str(i - 35) for i in range(70))})",
    "not_in_null": "w3 NOT IN ("
                   f"{', '.join(str(i) for i in range(0, 140, 2))}, NULL)",
    "and20": wide_and(20),
    "deep70": nested(70),
    "cmp70": rare_cmps(("w1", "w3", "w5"), (-128, -100, -2**31),
                       (127, 99, 2**31 - 1), (1, 1, 2**24)),
    "in4000": f"w3 IN ({', '.join(str(i) for i in range(-2000, 2000))})",
    "and320": wide_and(WIDE_COLS),
}


def wide_columns(n: int, seed: int) -> dict:
    base = pred_columns(n, seed)
    by_type = dict(zip(("boolean", "int8", "uint8", "int16", "uint16",
                        "int32", "float"), base))
    rng = np.random.default_rng(seed + 1)
    out = {}
    for k in range(WIDE_COLS):
        data, _ = base[by_type[WIDE_TYPES[k % len(WIDE_TYPES)]]]
        data = rng.permutation(data)
        out[f"w{k}"] = (data, rng.random(n) > 0.01 if k % 4 == 0 else None)
    return out


def check_pred(text: str, schema, cols_np: dict, n: int, dev) -> int:
    """K-C against its plain version and the host evaluator, unpacked and
    (n a multiple of 32) packed."""
    node = parse(text)
    if not device_compatible(node, schema):
        raise AssertionError(f"{text[:80]!r} is not device-eligible")
    batch = ColumnBatch(TableID("", "t"), schema, {
        k: Column(k, schema.find(k).data_type, d, None, v)
        for k, (d, v) in cols_np.items()})
    program = compile_mask_program(node)
    cols = [(torch.from_numpy(cols_np[c][0]).to(dev),
             None if cols_np[c][1] is None
             else torch.from_numpy(cols_np[c][1]).to(dev))
            for c in program.columns]
    got = pred3vl_mask(program, cols, n, False, dev)
    want = eval3_torch(node, dict(zip(program.columns, cols)), n, dev)
    err = require_equal(got, want, f"pred3vl {text[:80]!r} n={n}")
    host = compile_mask(node)(batch)
    if not np.array_equal(got.cpu().numpy(), host):
        raise AssertionError(f"pred3vl {text[:80]!r} n={n} differs from "
                             "the host evaluator")
    if n % 32 == 0:
        packed = pred3vl_mask(program, cols, n, True, dev)
        err = max(err, require_equal(packed, pack_mask_words(want, n),
                                     f"packed {text[:80]!r} n={n}"))
    return err


def check_pred3vl_mask(dev: torch.device) -> int:
    err = 0
    for n in PRED_NS:
        cols_np = pred_columns(n, seed=n)
        for text in PRED_CASES:
            err = max(err, check_pred(text, PRED_SCHEMA, cols_np, n, dev))
        # every column valid (no validity tensor)
        all_valid = {k: (d, None) for k, (d, _) in cols_np.items()}
        for text in PRED_CASES[-4:]:
            err = max(err, check_pred(text, PRED_SCHEMA, all_valid, n, dev))
    for n in (999, 4096):
        cols_np = wide_columns(n, seed=n)
        for text in LARGE_PRED_CASES.values():
            err = max(err, check_pred(text, WIDE_SCHEMA, cols_np, n, dev))
    return err


def staged(batch: ColumnBatch, dev) -> tuple[list, int]:
    """A batch's canonical columns on the card (pool accumulators by
    kernel K10)."""
    cols, n = rowhash.prep_batch(batch, dev)
    on_card = rowhash._stage(cols, dev)
    _sync(dev)
    return on_card, n


def lane_check_batch(n: int) -> ColumnBatch:
    """Every canonical kind K10 must hash alike: integers of each width
    (full range), uint64, float32/64 with +-0.0 and NaNs, bool, date;
    strings with nulls, empties, the 64-byte block boundaries and one
    row over 1 KB; dict columns with a null sentinel."""
    rng = np.random.default_rng(10)
    kinds = [("i8", "int8", np.int8), ("i16", "int16", np.int16),
             ("i32", "int32", np.int32), ("i64", "int64", np.int64),
             ("u64", "uint64", np.uint64), ("date", "date", np.int32)]
    spec, cols = [], {}
    for name, ctype, dt in kinds:
        info = np.iinfo(dt)
        data = rng.integers(info.min, info.max, n, dtype=dt, endpoint=True)
        spec.append((name, ctype))
        cols[name] = (data, None, rng.random(n) > 0.2)
    edges = np.array([0.0, -0.0, np.nan, -np.nan, np.inf, 1.5,
                      np.uint64(0xFFF8000000000123).view(np.float64)])
    for name, ctype, dt in (("f32", "float", np.float32),
                            ("f64", "double", np.float64)):
        with np.errstate(invalid="ignore"):
            data = rng.choice(edges, n).astype(dt)
        spec.append((name, ctype))
        cols[name] = (data, None, rng.random(n) > 0.1)
    spec.append(("b", "boolean"))
    cols["b"] = (rng.integers(0, 2, n).astype(np.bool_), None, None)
    lens = rng.choice([0, 1, 55, 56, 63, 64, 119, 120], n)
    lens[7] = 1500
    strs = [rng.integers(0, 256, ln, dtype=np.uint8).tobytes() for ln in lens]
    spec.append(("s", "string"))
    cols["s"] = (*_flat_bytes(strs), rng.random(n) > 0.2)
    schema = new_table_schema(spec + [(c, "utf8") for c in ("d1", "d2")])
    out = {cs.name: Column(cs.name, cs.data_type, *cols[cs.name])
           for cs in schema if cs.name in cols}
    values = [b"", b"x" * 55, b"y" * 56, b"z" * 64, b"w" * 1100, b"v"]
    pool = DictPool(*_flat_bytes(values + [b""]), null_code=len(values))
    for name in ("d1", "d2"):
        valid = rng.random(n) > 0.3
        codes = np.where(valid, rng.integers(0, len(values), n),
                         pool.null_code).astype(np.int32)
        out[name] = Column(name, schema.find(name).data_type,
                           validity=valid, dict_enc=DictEnc(codes, pool=pool))
    return ColumnBatch(TableID("", "lanes"), schema, out)


def _flat_bytes(values: list) -> tuple[np.ndarray, np.ndarray]:
    data = np.frombuffer(b"".join(values), dtype=np.uint8).copy()
    return data, _offsets_from_lengths([len(v) for v in values])


def check_rowhash_lanes(dev: torch.device) -> int:
    err = 0
    for n in (3 * 1024 + 17, 100):
        batch = lane_check_batch(n)
        cols, n = staged(batch, dev)
        r1, r2 = rowhash.rowhash_lanes(cols, n)
        p1, p2 = rowhash.rowhash_lanes_plain(cols, n)
        err = max(err, require_equal(r1, rowhash._to_i32(p1), "lanes r1"),
                  require_equal(r2, rowhash._to_i32(p2), "lanes r2"))
        acc = torch.zeros(4, dtype=torch.int32, device=dev)
        rowhash.rowhash_lanes(cols, n, acc)
        want = rowhash.fingerprint_host(cols, n)
        got = rowhash.FingerprintAggregate.from_acc(acc, n)
        if got != want:
            raise AssertionError(f"rowhash_lanes reduce {got.digest()} != "
                                 f"plain {want.digest()}")
        host = rowhash.fingerprint_host(*rowhash.prep_batch(batch))
        if host != want:
            raise AssertionError("rowhash plain on the card differs from "
                                 "the plain version on the CPU")
    return err


def check_var_accumulators(dev: torch.device) -> int:
    rng = np.random.default_rng(11)
    lens = list(rng.choice([0, 1, 55, 56, 63, 64, 119, 120, 300], 5000))
    lens += [1500, 0]
    values = [rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
              for ln in lens]
    data, offsets = _flat_bytes(values)
    d = torch.from_numpy(data).to(dev)
    o = torch.from_numpy(offsets).to(dev)
    got = rowhash.var_accumulators(d, o)
    want = rowhash._var_accs_host(d, o)
    err = max(require_equal(got[0], want[0], "var_accumulators lane 1"),
              require_equal(got[1], want[1], "var_accumulators lane 2"))
    # offsets past the bytes: the kernel clamps each row to the buffer
    bad = torch.tensor([0, 2, 1 << 20], dtype=torch.int32, device=dev)
    got = rowhash.var_accumulators(d[:5].clone(), bad)
    want = rowhash._var_accs_host(d[:5].clone(), torch.tensor(
        [0, 2, 5], dtype=torch.int32, device=dev))
    return max(err, require_equal(got[0], want[0], "clamped row lane 1"),
               require_equal(got[1], want[1], "clamped row lane 2"))


# where len + 9 crosses a 64-byte block, and a row over one base-64 digit
VAR_EDGE_LENS = (0, 1, 54, 55, 56, 63, 64, 65, 119, 120, 100_000)
UTF8_VALUES = ("наушники", "☃ snow", "𝄞 clef", "ü", "日本語テキスト")


def edge_var_values(rng) -> list[bytes]:
    """Each VAR_EDGE_LENS row starting at every offset mod 16 of the flat
    buffer (a spacer row of 0-15 bytes before each), then multi-byte
    UTF-8 rows."""
    values, total = [], 0
    for ln in VAR_EDGE_LENS:
        for k in range(16):
            pad = (k - total) % 16
            values += [rng.integers(0, 256, pad, dtype=np.uint8).tobytes(),
                       rng.integers(0, 256, ln, dtype=np.uint8).tobytes()]
            total += pad + ln
    values += [v.encode() for v in UTF8_VALUES]
    starts = np.cumsum([0] + [len(v) for v in values])[:-1]
    for ln in VAR_EDGE_LENS:
        at = {int(st) % 16 for st, v in zip(starts, values) if len(v) == ln}
        if len(at) != 16:
            raise AssertionError(f"edge rows of {ln} bytes start at only "
                                 f"{len(at)} offsets mod 16")
    return values


def edge_lane_batch(n_cols: int, n: int, rng) -> ColumnBatch:
    """n_cols columns cycling fixed int64, var (edge rows, nulls), dict
    (a pool of edge values, nulls) and float64, n rows."""
    var_values = edge_var_values(rng)
    pool = DictPool(*_flat_bytes(var_values[:40] + [b""]), null_code=40)
    kinds = ("int64", "utf8", "dict", "double")
    spec = [(f"c{i}", "utf8" if kinds[i % 4] == "dict" else kinds[i % 4])
            for i in range(n_cols)]
    schema = new_table_schema(spec)
    cols = {}
    for i, cs in enumerate(schema):
        valid = rng.random(n) > 0.2
        kind = kinds[i % 4]
        if kind == "int64":
            data = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
            cols[cs.name] = Column(cs.name, cs.data_type, data, None,
                                   valid if i % 8 == 0 else None)
        elif kind == "double":
            data = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, 1.5]), n)
            cols[cs.name] = Column(cs.name, cs.data_type, data, None, valid)
        elif kind == "utf8":
            pick = rng.integers(0, len(var_values), n)
            pick[:min(n, len(var_values))] = np.arange(min(n,
                                                           len(var_values)))
            cols[cs.name] = Column(cs.name, cs.data_type, *_flat_bytes(
                [var_values[j] for j in pick]), valid)
        else:
            codes = np.where(valid, rng.integers(0, 40, n), 40).astype(
                np.int32)
            cols[cs.name] = Column(cs.name, cs.data_type, validity=valid,
                                   dict_enc=DictEnc(codes, pool=pool))
    return ColumnBatch(TableID("", "edges"), schema, cols)


def check_lanes_exact(batch: ColumnBatch, dev, what: str) -> int:
    """K10 in keys and reduce mode against its plain version on the card;
    the reduce launch adds into an accumulator that already holds a
    value, as the fingerprint's second batch does."""
    cols, n = staged(batch, dev)
    r1, r2 = rowhash.rowhash_lanes(cols, n)
    p1, p2 = rowhash.rowhash_lanes_plain(cols, n)
    err = max(require_equal(r1, rowhash._to_i32(p1), f"{what} r1"),
              require_equal(r2, rowhash._to_i32(p2), f"{what} r2"))
    start = torch.tensor([7, -3, 0x1234, -0x5678], dtype=torch.int32,
                         device=dev)
    acc, want = start.clone(), start.clone()
    rowhash.rowhash_lanes(cols, n, acc)
    rowhash._reduce_into(want, p1, p2)
    return max(err, require_equal(acc, want, f"{what} reduce"))


def check_rowhash_edges(dev: torch.device) -> int:
    """K10 and var_accumulators at the edges: rows of VAR_EDGE_LENS bytes
    at every start offset mod 16, multi-byte UTF-8, nulls, fixed, var and
    dict columns in one batch; the by-value column limit and one column
    past it (the descriptors in device memory); keys and reduce mode."""
    rng = np.random.default_rng(19)
    values = edge_var_values(rng)
    data, offsets = _flat_bytes(values)
    d = torch.from_numpy(data).to(dev)
    o = torch.from_numpy(offsets).to(dev)
    want = rowhash._var_accs_host(d, o)
    got = rowhash.var_accumulators(d, o)
    err = max(require_equal(got[0], want[0], "var_accumulators edges"),
              require_equal(got[1], want[1], "var_accumulators edges lane 2"))
    for n_cols in (10, rowhash.BY_VALUE_COLS, rowhash.BY_VALUE_COLS + 1):
        err = max(err, check_lanes_exact(
            edge_lane_batch(n_cols, 400, rng), dev,
            f"rowhash_lanes {n_cols} columns "
            f"({rowhash.descriptor_route(n_cols)})"))
    return err


def packed_codes(codes: np.ndarray, bw: int, dev) -> torch.Tensor:
    return torch.from_numpy(
        pack_bits_host(codes, bw).view(np.int32).copy()).to(dev)


DICT_EDGE_NS = (1, 31, 32, 33, 1 << 22)
# a pool of one entry; the dispatch pools; a pool just past the staged
# prefix; the decode path's; Parquet's default dictionary page limit (1 MB)
DICT_POOLS = (1, 4096, 56_000, 131_072, 262_144)


def dict_splits(k: int) -> list[int]:
    """The splits of a k-entry pool K11 runs: none staged (every gather
    from L2) and the wrapper's."""
    return [0, dict_staged_entries(k)]


def check_dict_edges(dev) -> int:
    """K11 at every width, at n = 1, 31, 32, 33 and 4,194,304, over pools
    of 1 to 262,144 entries, through the wrapper and in each split of
    dict_splits (the pool whole or its prefix staged, none staged: a
    branch each); codes past the pool and,
    at width 32, negative ones; the carry mode with an odd carry in each
    split."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)
    err = 0
    for k in DICT_POOLS:
        pool = torch.randint(-2**31, 2**31, (k,), generator=gen,
                             device=dev, dtype=torch.int64).to(torch.int32)
        for n in DICT_EDGE_NS:
            for bw in range(1, 33):
                hi = 1 << bw
                codes = torch.randint(0, min(hi, k + k // 8 + 1), (n,),
                                      generator=gen, device=dev,
                                      dtype=torch.int64)
                codes[::10] = torch.randint(0, hi, codes[::10].shape,
                                            generator=gen, device=dev,
                                            dtype=torch.int64)
                if bw == 32:
                    codes[::7] = torch.randint(2**31, 2**32,
                                               codes[::7].shape,
                                               generator=gen, device=dev,
                                               dtype=torch.int64)
                w = pack_on_card(codes, bw)
                what = f"dict_decode n={n} bw={bw} k={k}"
                want = decode_dict_run_plain(w, pool, bw, n)
                err = max(err, require_equal(
                    decode_dict_run(w, pool, bw, n), want, what))
                carry0 = 0x9E3779B9  # odd: the words flip their low bit
                flipped = decode_dict_run_plain(w ^ 1, pool, bw, n)
                carry_want = _wrap_i32(
                    (carry0 + flipped.to(torch.int64).sum()).reshape(1))
                for staged in dict_splits(k):
                    out = torch.empty(n, dtype=torch.int32, device=dev)
                    _dict_decode_launch(w, pool, bw, n, None, None, out,
                                        staged)
                    err = max(err, require_equal(
                        out, want, f"{what} staged={staged}"))
                    if n in (33, 1 << 22) and bw in (1, 17, 32):
                        carries = _wrap_i32(torch.tensor(
                            [carry0, 0], dtype=torch.int64, device=dev))
                        _dict_decode_launch(w, pool, bw, n, carries[0],
                                            carries[1], None, staged)
                        err = max(err, require_equal(
                            carries[1:], carry_want,
                            f"{what} staged={staged} carry"))
    return err


def check_dict_decode(dev: torch.device) -> int:
    rng = np.random.default_rng(12)
    err = 0
    k = 1000
    pool = torch.from_numpy(
        rng.integers(-2**31, 2**31, k).astype(np.int32)).to(dev)
    n = 100_003
    for bw in (1, 7, 17, 31, 32):
        hi = 1 << bw
        codes = rng.integers(0, min(hi, k + k // 8), n, dtype=np.uint64)
        if bw == 32:
            codes[::5] = rng.integers(2**31, 2**32, len(codes[::5]),
                                      dtype=np.uint64)
        w = packed_codes(codes, bw, dev)
        err = max(err, require_equal(
            decode_dict_run(w, pool, bw, n),
            decode_dict_run_plain(w, pool, bw, n), f"dict_decode bw={bw}"))
        err = max(err, require_equal(
            pred_decode(MODE_UNPACK, w, n, bw),
            pred_decode_plain(MODE_UNPACK, w, n, bw), f"unpack bw={bw}"))
        err = max(err, require_equal(
            decode_dict_loop(w, pool, bw, n, 3),
            decode_dict_loop_plain(w, pool, bw, n, 3),
            f"dict_decode loop bw={bw}"))
    return max(err, check_dict_edges(dev))


def check_ragged_pack(dev: torch.device) -> int:
    """K12 against its plain version and the host pack, byte for byte:
    rows of 0-500 bytes across the 55/56 and 119/120 block boundaries at
    1, 2, 4 and 8 blocks, bucket pad rows, a flat buffer that ends at
    the last row's end; a row too long for its blocks raises."""
    rng = np.random.default_rng(14)
    err = 0
    for mb in (1, 2, 4, 8):
        fit = mb * 64 - 9
        lens = [n for n in (0, 1, 54, 55, 56, 119, 120, 500) if n <= fit]
        lens += [fit] + list(rng.integers(0, fit + 1, 3000))
        values = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                  for n in lens]
        data, offsets = _flat_bytes(values)
        n = len(values)
        bucket = n + 37
        blocks, nb = pack_blocks_device(data, offsets, bucket, mb, dev)
        d = torch.from_numpy(data).to(dev)  # exactly off[n] bytes
        o = torch.from_numpy(offsets).to(dev)
        p_blocks, p_nb = pack_blocks_plain(d, o, bucket, mb)
        err = max(err,
                  require_equal(blocks, p_blocks, f"ragged_pack mb={mb}"),
                  require_equal(nb, p_nb, f"ragged_pack counts mb={mb}"))
        host, host_nb, _ = prepare_padded_blocks(data, offsets, prefix_len=64,
                                                 max_blocks=mb)
        got = blocks.cpu().numpy()
        if not (np.array_equal(got[:n], host)
                and np.array_equal(nb.cpu().numpy()[:n], host_nb)):
            raise AssertionError(f"ragged_pack mb={mb} differs from the "
                                 "host pack")
        if got[n:].any() or nb[n:].any():
            raise AssertionError("ragged_pack left bytes in pad rows")
    try:
        pack_blocks_device(data, offsets, bucket, 4, dev)
    except ValueError:
        pass
    else:
        raise AssertionError("ragged_pack took a row longer than its blocks")
    return err


def mask_layout(bits: np.ndarray, layout: str, dev) -> torch.Tensor:
    """A bool mask as the kernels read it: bool bytes, or packed
    little-endian words (bit j of word k = row 32k+j)."""
    if layout == "bool":
        return torch.from_numpy(bits.copy()).to(dev)
    packed = np.packbits(bits.astype(np.uint8), bitorder="little")
    packed = np.pad(packed, (0, (-len(packed)) % 4))
    return torch.from_numpy(packed.view(np.int32).copy()).to(dev)


def check_shard_hist(dev: torch.device) -> int:
    """K13/K14's histogram against its plain version: fused mode with
    the masks packed and as bools, with and without a predicate; step
    mode over 1 and 3 columns with float32 and float64 scores (a
    negative age, 1e300, inf, NaN); n_shards 1, 13, 16 and 4096; a
    count above the limit raises."""
    rng = np.random.default_rng(15)
    err = 0
    for n, n_shards in ((65_536, 16), (100_000, 13), (4_096, 4096),
                        (1_000, 1)):
        words = torch.from_numpy(rng.integers(
            -2**31, 2**31, (n, 8)).astype(np.int32)).to(dev)
        valid, pred = rng.random(n) > 0.1, rng.random(n) > 0.4
        for layout in ("packed", "bool"):
            v = mask_layout(valid, layout, dev)
            for keep in (mask_layout(pred, layout, dev), None):
                got = shard_hist_fused(words, n_shards, v, keep)
                err = max(err, require_equal(
                    got, shard_hist_fused_plain(words, n_shards, v, keep),
                    f"shard_hist fused n={n} shards={n_shards} {layout}"))
                if int(got[:n_shards].sum()) != int(got[n_shards]) or \
                        int(got[n_shards]) != int(
                            (valid & (pred if keep is not None
                                      else True)).sum()):
                    raise AssertionError("shard_hist fused: counts do not "
                                         "add up")
        ages = torch.from_numpy(rng.integers(-3, 99, n).astype(
            np.int32)).to(dev)
        scores = rng.uniform(0, 100, n)
        scores[[1, 2, 3]] = [1e300, np.inf, np.nan]
        for dtype in (np.float64, np.float32):
            with np.errstate(over="ignore"):  # 1e300 overflows to inf
                sc = torch.from_numpy(scores.astype(dtype)).to(dev)
            for c in (1, 3):
                dig = torch.from_numpy(rng.integers(
                    -2**31, 2**31, (c, n, 8)).astype(np.int32)).to(dev)
                part, keep, s32 = shard_hist_step(dig, ages, sc, n_shards)
                p_part, p_keep, p_s32 = shard_hist_step_plain(
                    dig, ages, sc, n_shards)
                what = f"shard_hist step n={n} c={c} {dtype.__name__}"
                nan = torch.isnan(s32)
                if not torch.equal(nan, torch.isnan(p_s32)) or \
                        bool(keep[1:4].any()):
                    raise AssertionError(f"{what}: NaN/inf rows differ")
                err = max(err, require_equal(part, p_part, what),
                          require_equal(keep, p_keep, what),
                          require_equal(s32.view(torch.int32)[~nan],
                                        p_s32.view(torch.int32)[~nan], what))
    try:
        shard_hist_fused(words, 4097, v)
    except ValueError:
        pass
    else:
        raise AssertionError("shard_hist took more than 4096 shards")
    return err


EDGE_SHARDS = (1, 2, 3, 4, 31, 32, 33, 4096)


def hist_exact(got, words, n_shards, keep_rows, plain, what) -> int:
    """A fused/step partial against its plain version and torch.bincount
    of the kept rows' bins."""
    err = require_equal(got, plain, what)
    bins = (words.to(torch.int64) & 0xFFFFFFFF) % n_shards
    counted = torch.bincount(bins[keep_rows.expand_as(bins)],
                             minlength=n_shards).to(torch.int32)
    return max(err, require_equal(got[:n_shards], counted,
                                  f"{what} against bincount"),
               require_equal(got[n_shards:], keep_rows.sum().reshape(1),
                             f"{what} kept count"))


def check_shard_hist_edges(dev: torch.device) -> int:
    """The histogram at every route edge (n_shards 1 to 4,096), at a row
    count no multiple of 32 in both layouts, none and all kept, step
    mode over inf, NaN and 1e300 at each shard count; 1,000 launches
    back to back on one stream alternating the two routes (each must
    leave its scratch zero for the next), launches on two streams in
    flight at once, and a launch on the current stream after one whose
    error came back once it had run, each checked."""
    rng = np.random.default_rng(23)
    err = 0
    n = 65_536 + 17
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 8)).astype(
        np.int32)).to(dev)
    masks = {"random": (rng.random(n) > 0.1, rng.random(n) > 0.4),
             "none": (np.zeros(n, bool), np.ones(n, bool)),
             "all": (np.ones(n, bool), np.ones(n, bool))}
    ages = torch.from_numpy(rng.integers(-3, 99, n).astype(np.int32)).to(dev)
    scores = rng.uniform(0, 100, n)
    scores[:6] = [1e300, np.inf, np.nan, -np.inf, -1e300, 3.0]
    sc = torch.from_numpy(scores).to(dev)
    dig3 = torch.from_numpy(rng.integers(-2**31, 2**31, (3, n, 8)).astype(
        np.int32)).to(dev)
    for ns in EDGE_SHARDS:
        for name, (valid, pred) in masks.items():
            for layout in ("packed", "bool"):
                v = mask_layout(valid, layout, dev)
                p = mask_layout(pred, layout, dev)
                kept = torch.from_numpy(valid & pred).to(dev)
                what = f"shard_hist fused {name} {layout} shards={ns}"
                err = max(err, hist_exact(
                    shard_hist_fused(words, ns, v, p), words[:, 0], ns,
                    kept, shard_hist_fused_plain(words, ns, v, p), what))
        part, keep, s32 = shard_hist_step(dig3, ages, sc, ns)
        p_part, p_keep, _ = shard_hist_step_plain(dig3, ages, sc, ns)
        if bool(keep[:5].any()) or not bool(keep[5]):
            raise AssertionError("shard_hist step kept inf/NaN/1e300")
        err = max(err, require_equal(keep, p_keep, f"step keep {ns}"),
                  hist_exact(part, dig3[:, :, 0], ns, keep[None, :],
                             p_part, f"shard_hist step shards={ns}"))
    v = mask_layout(masks["random"][0], "packed", dev)
    p = mask_layout(masks["random"][1], "packed", dev)
    want = {ns: shard_hist_fused_plain(words, ns, v, p) for ns in (16, 4096)}
    outs = [(ns, shard_hist_fused(words, ns, v, p))
            for ns in (16, 4096) * 500]
    for i, (ns, got) in enumerate(outs):
        err = max(err, require_equal(got, want[ns],
                                     f"shard_hist back to back #{i}"))
    streams = [torch.cuda.Stream(dev) for _ in range(2)]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(dev))
    in_flight = []
    for i in range(8):
        ns = 16 if i % 2 else 4096
        with torch.cuda.stream(streams[i % 2]):
            if i == 0:
                torch.cuda._sleep(10_000_000)  # hold stream 0 back
            in_flight.append((ns, shard_hist_fused(words, ns, v, p)))
    torch.cuda.synchronize(dev)
    for i, (ns, got) in enumerate(in_flight):
        err = max(err, require_equal(got, want[ns],
                                     f"shard_hist two streams #{i}"))
    # a launch whose error comes back after it ran: it has added into the
    # stream's pending output, which the next launch must not reuse
    check = _build.check

    def refuse(lib, rc, what):
        raise RuntimeError(f"{what}: an error reported after the launch")

    _build.check = refuse
    try:
        shard_hist_fused(words, 16, v, p)
    except RuntimeError:
        pass
    else:
        raise AssertionError("shard_hist did not raise")
    finally:
        _build.check = check
    return max(err, require_equal(shard_hist_fused(words, 16, v, p),
                                  want[16], "shard_hist after an error"))


def check_digest_gather(dev: torch.device) -> int:
    """K14's gather against its plain version, clipping negative and
    out-of-range codes to the first and last rows (jnp.take "clip"), at
    row counts that are not a multiple of a warp's rows, and n = 1."""
    rng = np.random.default_rng(16)
    err = 0
    for k in (1, 7, 4097):
        table = torch.from_numpy(rng.integers(
            -2**31, 2**31, (k, 8)).astype(np.int32)).to(dev)
        for n in (100_003, 65, 33, 1):
            codes = rng.integers(-10, k + 10, n).astype(np.int32)
            edge = np.array([-5, -1, k, k + 100, 2**31 - 1, -2**31],
                            dtype=np.int32)[:n]
            codes[:len(edge)] = edge
            c = torch.from_numpy(codes).to(dev)
            got = digest_gather(table, c)
            err = max(err, require_equal(got, digest_gather_plain(table, c),
                                         f"digest_gather k={k} n={n}"))
            want = [table[0], table[0], table[k - 1], table[k - 1],
                    table[k - 1], table[0]][:n]
            if not all(torch.equal(got[i], w) for i, w in enumerate(want)):
                raise AssertionError(f"digest_gather k={k} n={n} does not "
                                     "clip")
    return err


def sign_flip_numpy(ids: np.ndarray, region: np.ndarray,
                    threshold: int = REGION_THRESHOLD) -> np.ndarray:
    """bench.py:1015 under jax.jit without x64, in numpy's int32."""
    low = ids.astype(np.int32)
    return np.where(region < threshold, low, -low)


def check_region_sign_flip(dev: torch.device) -> int:
    """K15 against its plain version and numpy's int32 arithmetic: the
    edge ids (+-2^31, 2^31+5, 2^40, -2^63, 2^63-1) and regions (399, 400,
    -1, int32's ends) first, then random int64 ids and regions from a
    seed, at 1,023, 1,024 and 1,048,577 rows and three thresholds."""
    rng = np.random.default_rng(15)
    edge_ids = np.array([2**31, -2**31, 2**31 + 5, 2**40, -2**63, 2**63 - 1,
                         -2**31 - 1, 1, -7, 0], dtype=np.int64)
    edge_region = np.array([399, 400, -1, 500, 399, 400, -2**31, 2**31 - 1,
                            450, 3], dtype=np.int32)
    err = 0
    for n in (1023, 1024, 1_048_577):
        ids = rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)
        region = rng.integers(-600, 600, n).astype(np.int32)
        ids[:len(edge_ids)], region[:len(edge_region)] = edge_ids, edge_region
        i_t, r_t = torch.from_numpy(ids).to(dev), torch.from_numpy(region).to(
            dev)
        for threshold in (REGION_THRESHOLD, 0, -2**31):
            got = region_sign_flip(i_t, r_t, threshold)
            err = max(err, require_equal(
                got, region_sign_flip_plain(i_t, r_t, threshold),
                f"region_sign_flip n={n} threshold={threshold}"))
            if got.dtype != torch.int32 or not np.array_equal(
                    got.cpu().numpy(), sign_flip_numpy(ids, region,
                                                       threshold)):
                raise AssertionError(f"region_sign_flip n={n} differs "
                                     "from numpy's int32")
    empty = torch.empty(0, dtype=torch.int64, device=dev)
    if region_sign_flip(empty, empty.to(torch.int32)).numel() != 0:
        raise AssertionError("region_sign_flip of no rows")
    return err


# -- phase 3: the main path ---------------------------------------------------

def cut_batches(tid, schema, fixed, var, bounds) -> list[ColumnBatch]:
    """Batches over [lo, hi) row ranges of whole columns (views)."""
    out = []
    for lo, hi in bounds:
        cols = {}
        for cs in schema:
            if cs.name in fixed:
                cols[cs.name] = Column(cs.name, cs.data_type,
                                       fixed[cs.name][lo:hi])
            else:
                data, off = var[cs.name]
                cols[cs.name] = Column(cs.name, cs.data_type,
                                       data[off[lo]:off[hi]],
                                       off[lo:hi + 1] - off[lo])
        out.append(ColumnBatch(tid, schema, cols))
    return out


def clickbench_batches(schema, fixed, var, n: int,
                       batch_rows: int = BATCH_ROWS) -> list[ColumnBatch]:
    return cut_batches(TableID("", "hits"), schema, fixed, var,
                       [(lo, min(lo + batch_rows, n))
                        for lo in range(0, n, batch_rows)])


def run_chain(batches, placement: str, dev) -> tuple[list, float, object]:
    set_placement(placement)
    try:
        chain = build_chain(CONFIG, device=dev)
        step = chain.plan_for(batches[0].table_id, batches[0].schema).steps
        t0 = time.perf_counter()
        outs = [chain.apply(b) for b in batches]
        torch.cuda.synchronize(dev)
        return outs, time.perf_counter() - t0, step
    finally:
        set_placement(None)


def column_arrays(col: Column) -> tuple:
    """A column's (data, offsets, validity); a dictionary column is
    flattened through its encoding, which counts no materialization."""
    if col.is_lazy_dict:
        data, offsets = col.dict_enc.materialize()
    else:
        data, offsets = col.data, col.offsets
    return data, offsets, col.validity


def batches_identical(a: ColumnBatch, b: ColumnBatch) -> bool:
    if a.schema != b.schema or a.n_rows != b.n_rows:
        return False
    for name in a.schema.names():
        for x, y in zip(column_arrays(a.column(name)),
                        column_arrays(b.column(name))):
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                return False
    return True


def main_path_devpack(batches, dev_outs, main_bytes: dict, dev) -> dict:
    """The main path with the device pack on: K12 packs each batch's URL
    bytes on the card; the output must equal main_path's."""
    os.environ["TRANSFERIA_TPU_PALLAS_PACK"] = "1"
    try:
        reset_dispatch_bytes()
        with PathLaunches("main_path_devpack") as launches:
            outs, seconds, _ = run_chain(batches, "device", dev)
        staged = dispatch_bytes()
    finally:
        del os.environ["TRANSFERIA_TPU_PALLAS_PACK"]
    for i, (a, b) in enumerate(zip(outs, dev_outs)):
        if not batches_identical(a, b):
            raise AssertionError(f"batch {i}: the device pack's output "
                                 "differs from main_path's")
    return dict(rows=ROWS, batch_rows=BATCH_ROWS, device_seconds=seconds,
                device_rows_per_s=ROWS / seconds, h2d_bytes=staged,
                main_path_h2d_bytes=main_bytes,
                h2d_vs_main_path=staged["encoded"] / main_bytes["encoded"],
                launches=launches.counts, identical_to="main_path")


def dispatch_data():
    """bench.py measure_dispatch's pool values and per-batch (codes,
    RegionID), drawn in the same order from the same seed."""
    rng = np.random.default_rng(11)
    values = [f"https://bench{i}.example/path/{i % 97}/{i}".encode()
              for i in range(DISPATCH_UNIQUES)]
    batch_data = [
        (rng.integers(0, DISPATCH_UNIQUES, DISPATCH_ROWS).astype(np.int32),
         rng.integers(0, 500, DISPATCH_ROWS).astype(np.int32))
        for _ in range(DISPATCH_BATCHES)]
    return values, batch_data


def dispatch_batches(pool: DictPool, batch_data) -> list[ColumnBatch]:
    schema = new_table_schema([("URL", "utf8"), ("RegionID", "int32")])
    return [ColumnBatch(TableID("bench", "dispatch"), schema, {
        "URL": Column("URL", schema.find("URL").data_type,
                      dict_enc=DictEnc(codes, pool=pool)),
        "RegionID": Column("RegionID", schema.find("RegionID").data_type,
                           regions)})
        for codes, regions in batch_data]


def run_dispatch(values, batch_data, mode: str, placement: str, dev):
    """One mode over a fresh pool: a warm batch, then the batches timed.
    Returns (outputs, seconds, bytes staged by the timed batches)."""
    pool = DictPool(*_flat_bytes(values + [b""]), null_code=len(values))
    data = dispatch_batches(pool, batch_data)
    set_dispatch_encoding(mode)
    set_placement(placement)
    try:
        chain = build_chain(DISPATCH_CONFIG, device=dev)
        chain.apply(data[0])  # warm: the build, the link probe, the pool
        torch.cuda.synchronize(dev)
        reset_dispatch_bytes()
        t0 = time.perf_counter()
        outs = [chain.apply(b) for b in data]
        torch.cuda.synchronize(dev)
        return outs, time.perf_counter() - t0, dispatch_bytes()
    finally:
        set_dispatch_encoding(None)
        set_placement(None)


def dispatch_path(dev) -> dict:
    values, batch_data = dispatch_data()
    _hmac_key_states(b"bench-salt", dev)  # the key's states, made once
    raw, raw_s, raw_bytes = run_dispatch(values, batch_data, "raw",
                                         "device", dev)
    reset_flat_materializations()
    with PathLaunches("dispatch") as launches:
        auto, auto_s, auto_bytes = run_dispatch(values, batch_data, "auto",
                                                "device", dev)
    materialized = flat_materializations()
    lazy = all(b.column("URL").is_lazy_dict for b in auto)
    chunk = _chunk_rows(dev) or DISPATCH_ROWS
    chunks = (DISPATCH_BATCHES + 1) * -(-DISPATCH_ROWS // chunk)
    want = {"sha256_hmac": 1, "pred_decode": chunks, "pred3vl_mask": chunks}
    got = {k: launches.counts[k] for k in want}
    if materialized or not lazy or got != want:
        raise AssertionError(f"dispatch auto: {materialized} flat "
                             f"materializations, URL encoded {lazy}, "
                             f"launches {got} (want {want})")
    host, host_s, _ = run_dispatch(values, batch_data, "auto", "host", dev)
    for i, (a, r, h) in enumerate(zip(auto, raw, host)):
        if not (batches_identical(a, r) and batches_identical(a, h)):
            raise AssertionError(f"dispatch batch {i}: auto, raw and host "
                                 "differ")
    # a pool larger than twice the batch: hashed on the host (the
    # referenced subset), no K-A for URL, still equal to the host's
    big = [f"https://bench{i}.example/path/{i % 97}/{i}".encode()
           for i in range(2 * DISPATCH_ROWS + 1)]
    codes = np.random.default_rng(12).integers(
        0, len(big), DISPATCH_ROWS).astype(np.int32)
    big_data = [(codes, batch_data[0][1])]
    _build.reset_launch_counts()
    big_dev, _, _ = run_dispatch(big, big_data, "auto", "device", dev)
    big_hmac = _build.launch_counts()["sha256_hmac"]
    big_host, _, _ = run_dispatch(big, big_data, "auto", "host", dev)
    if big_hmac or not batches_identical(big_dev[0], big_host[0]):
        raise AssertionError(f"dispatch large pool: {big_hmac} K-A "
                             "launches, or output differs from the host")
    rows = DISPATCH_ROWS * DISPATCH_BATCHES
    return dict(rows=rows, batch_rows=DISPATCH_ROWS,
                pool_values=DISPATCH_UNIQUES,
                auto_rows_per_s=rows / auto_s, raw_rows_per_s=rows / raw_s,
                host_rows_per_s=rows / host_s,
                auto_h2d_bytes=auto_bytes, raw_h2d_bytes=raw_bytes,
                compression_ratio=(auto_bytes["raw_equiv"]
                                   / max(auto_bytes["encoded"], 1)),
                raw_over_auto_bytes=(raw_bytes["encoded"]
                                     / max(auto_bytes["encoded"], 1)),
                flat_materializations=materialized,
                launches=launches.counts,
                large_pool=dict(values=len(big),
                                sha256_hmac_launches=big_hmac),
                equal_to=["raw", "host"])


# -- phases 4-6: the fingerprint and decode paths -----------------------------

def device_digest(batches, dev) -> tuple[str, float]:
    """TableFingerprinter(backend="device") over the batches: digest and
    seconds (the result waits for the card)."""
    t0 = time.perf_counter()
    fp = rowhash.TableFingerprinter(backend="device", device=dev)
    for b in batches:
        fp.push(b)
    digest = fp.result().digest()
    return digest, time.perf_counter() - t0


def breakdown(batches, dev) -> dict:
    """Where the device path's host time goes, batch by batch as the
    path runs them: canonicalizing (prep_batch) and staging on the card
    (one pinned copy, waited for here), each batch's buffers released
    before the next as in the path."""
    prep_s = stage_s = 0.0
    for b in batches:
        t0 = time.perf_counter()
        cols, _ = rowhash.prep_batch(b, dev)
        t1 = time.perf_counter()
        held = rowhash._stage(cols, dev)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        prep_s += t1 - t0
        stage_s += t2 - t1
        del cols, held
    return {"prep_seconds": prep_s, "stage_seconds": stage_s}


def plain_digest(batches, dev) -> str:
    """The plain version on the card over the same batches."""
    agg = rowhash.FingerprintAggregate()
    for b in batches:
        agg.merge(rowhash.fingerprint_host(*staged(b, dev)))
    return agg.digest()


def plain_keys(batch: ColumnBatch, dev) -> np.ndarray:
    """The row keys by K10's plain version on the card."""
    r1, r2 = rowhash.rowhash_lanes_plain(*staged(batch, dev))
    return ((r1.cpu().numpy().astype(np.uint64) << np.uint64(32))
            | r2.cpu().numpy().astype(np.uint64))


def check_keys(batch: ColumnBatch, dev, what: str) -> None:
    got = rowhash.batch_row_keys(batch, backend="device", device=dev)
    if not np.array_equal(got, plain_keys(batch, dev)):
        raise AssertionError(f"batch_row_keys on the card differ from the "
                             f"plain version ({what})")


def fingerprint_flat(batches, schema, fixed, var, dev) -> dict:
    with PathLaunches("fingerprint_flat") as launches:
        digest, cold_s = device_digest(batches, dev)
    _, seconds = device_digest(batches, dev)
    plain = plain_digest(batches, dev)
    cut, _ = device_digest(clickbench_batches(schema, fixed, var, ROWS,
                                              FP_CUT_ROWS), dev)
    permuted = list(batches)
    perm = np.random.default_rng(1).permutation(permuted[3].n_rows)
    permuted[3] = permuted[3].take(perm)
    shuffled, _ = device_digest(permuted, dev)
    for name, other in (("plain", plain), ("cut", cut),
                        ("permuted", shuffled)):
        if other != digest:
            raise AssertionError(f"fingerprint_flat: {name} digest {other} "
                                 f"!= device digest {digest}")
    check_keys(batches[0], dev, "ClickBench batch")
    return dict(rows=ROWS, batch_rows=BATCH_ROWS, digest=digest,
                cold_seconds=cold_s, device_seconds=seconds,
                device_rows_per_s=ROWS / seconds,
                **breakdown(batches, dev), launches=launches.counts,
                equal_to=["plain", "cut", "permuted"])


def dict_batches(flat: bool) -> list[ColumnBatch]:
    """bench.py measure_checksum_dict's batches, uncut."""
    schema = new_table_schema(
        [("id", "int64", True)] + [(c, "utf8") for c in DICT_COLUMNS])
    rng = np.random.default_rng(13)
    pools = {}
    for ci, cname in enumerate(DICT_COLUMNS):
        vals = [f"https://bench{ci}-{i}.example/path/{i % 97}/{i}".encode()
                for i in range(DICT_UNIQUES)]
        pools[cname] = DictPool(*_flat_bytes(vals + [b""]),
                                null_code=DICT_UNIQUES)
    out = []
    for i in range(DICT_BATCHES):
        ids = np.arange(i * DICT_ROWS, (i + 1) * DICT_ROWS, dtype=np.int64)
        codes = {c: rng.integers(0, DICT_UNIQUES, DICT_ROWS).astype(np.int32)
                 for c in DICT_COLUMNS}
        cols = {"id": Column("id", schema.find("id").data_type, ids)}
        for c in DICT_COLUMNS:
            enc = DictEnc(codes[c], pool=pools[c])
            ct = schema.find(c).data_type
            cols[c] = (Column(c, ct, *enc.materialize()) if flat
                       else Column(c, ct, dict_enc=enc))
        out.append(ColumnBatch(TableID("bench", "checksum_dict"), schema,
                               cols))
    return out


def fingerprint_dict(dev) -> dict:
    rows = DICT_ROWS * DICT_BATCHES
    encoded = dict_batches(flat=False)
    flat = dict_batches(flat=True)
    reset_flat_materializations()
    with PathLaunches("fingerprint_dict") as launches:
        digest, dict_cold_s = device_digest(encoded, dev)
    _, dict_s = device_digest(encoded, dev)
    dict_parts = breakdown(encoded, dev)
    materialized = flat_materializations()
    if materialized:
        raise AssertionError(f"fingerprint_dict flattened {materialized} "
                             "dictionary columns")
    flat_digest, flat_cold_s = device_digest(flat, dev)
    _, flat_s = device_digest(flat, dev)
    flat_parts = breakdown(flat, dev)
    plain = plain_digest(flat, dev)
    if not digest == flat_digest == plain:
        raise AssertionError(f"fingerprint_dict: dict {digest}, flat "
                             f"{flat_digest}, plain {plain}")
    check_keys(encoded[0], dev, "dict batch")
    if flat_materializations():
        raise AssertionError("keys of a dict batch flattened it")
    return dict(rows=rows, batch_rows=DICT_ROWS, pool_values=DICT_UNIQUES,
                digest=digest, flat_materializations=materialized,
                dict_cold_seconds=dict_cold_s, dict_seconds=dict_s,
                dict_rows_per_s=rows / dict_s,
                dict_breakdown=dict_parts, flat_cold_seconds=flat_cold_s,
                flat_seconds=flat_s, flat_rows_per_s=rows / flat_s,
                flat_breakdown=flat_parts,
                launches=launches.counts,
                equal_to=["flat", "plain"])


def decode_inputs(dev):
    """bench.py measure_device_decode's words, pool and codes."""
    rng = np.random.default_rng(13)
    n_pool = 1 << DECODE_BITS
    pool = rng.integers(-10**9, 10**9, n_pool).astype(np.int32)
    codes = rng.integers(0, n_pool, DECODE_ROWS, dtype=np.uint64)
    return (packed_codes(codes, DECODE_BITS, dev),
            torch.from_numpy(pool).to(dev),
            torch.from_numpy(codes.astype(np.int32)).to(dev))


def decode_path(dev) -> dict:
    words, pool, codes = decode_inputs(dev)
    torch.cuda.synchronize(dev)
    with PathLaunches("decode") as launches:
        out = decode_dict_run(words, pool, DECODE_BITS, DECODE_ROWS)
        decode_dict_loop(words, pool, DECODE_BITS, DECODE_ROWS, 1)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        carry = decode_dict_loop(words, pool, DECODE_BITS, DECODE_ROWS,
                                 DECODE_ITERS)
        carry = int(carry)  # waits for the card
        seconds = time.perf_counter() - t0
    require_equal(out, pool[codes.to(torch.int64)], "decode vs pool[codes]")
    want = int(decode_dict_loop_plain(words, pool, DECODE_BITS, DECODE_ROWS,
                                      DECODE_ITERS))
    if carry != want:
        raise AssertionError(f"decode_dict_loop carry {carry} != plain "
                             f"{want}")
    return dict(rows=DECODE_ROWS, bit_width=DECODE_BITS,
                pool_entries=int(pool.numel()),
                staged=dict_staged_entries(pool.numel()),
                loop_iters=DECODE_ITERS,
                loop_seconds=seconds,
                sustained_rows_per_s=DECODE_ROWS * DECODE_ITERS / seconds,
                launches=launches.counts, equal_to=["pool[codes]", "plain"])


# -- the mesh paths -------------------------------------------------------------

def hex_word0(col: Column) -> np.ndarray:
    """Digest word 0 of every row of a hex-masked column (its first 8
    hex characters), from the column's bytes."""
    data, offsets, _ = column_arrays(col)
    if not np.all(np.diff(offsets) == 64):
        raise AssertionError("a masked row is not 64 hex characters")
    chars = data[offsets[:-1, None].astype(np.int64) + np.arange(8)]
    nib = np.where(chars >= ord("a"), chars - ord("a") + 10,
                   chars - ord("0")).astype(np.uint64)
    return (nib << (4 * (7 - np.arange(8, dtype=np.uint64)))).sum(axis=1)


def host_hist(word0: np.ndarray) -> np.ndarray:
    return np.bincount((word0 % TARGET_SHARDS).astype(np.int64),
                       minlength=TARGET_SHARDS)


def run_mesh_chain(config, batches, warm, dev):
    """Apply `config` to the batches under a MESH_SHARDS virtual mesh of
    the card with device placement (after one warm batch, if given).
    Returns (outputs, seconds, per batch (last_shard_hist, last_kept),
    the step)."""
    force_virtual_mesh(MESH_SHARDS)
    set_placement("device")
    try:
        chain = build_chain(config, device=dev)
        step = chain.plan_for(batches[0].table_id, batches[0].schema).steps[0]
        if not (isinstance(step, DeviceFusedStep)
                and step.sharded_program is not None
                and step.sharded_program.n_dev == MESH_SHARDS):
            raise AssertionError(f"no {MESH_SHARDS}-shard program: {step}")
        if warm is not None:
            chain.apply(warm)
            torch.cuda.synchronize(dev)
            reset_dispatch_bytes()
        outs, sums = [], []
        t0 = time.perf_counter()
        for b in batches:
            outs.append(chain.apply(b))
            sums.append((step.sharded_program.last_shard_hist,
                         step.sharded_program.last_kept))
        torch.cuda.synchronize(dev)
        return outs, time.perf_counter() - t0, sums, step
    finally:
        force_virtual_mesh(None)
        set_placement(None)


def check_mesh_sums(outs, sums, what: str) -> int:
    """Each batch's cross-shard sums against the host: last_kept is the
    output's rows, last_shard_hist a bincount of its URL digests' word 0
    mod 16.  Returns the kept rows."""
    kept = 0
    for i, (out, (hist, n_kept)) in enumerate(zip(outs, sums)):
        want = host_hist(hex_word0(out.column("URL")))
        if n_kept != out.n_rows or not np.array_equal(hist, want):
            raise AssertionError(f"{what} batch {i}: kept {n_kept} vs "
                                 f"{out.n_rows}, hist {hist} vs {want}")
        if np.count_nonzero(hist) < TARGET_SHARDS // 2:
            raise AssertionError(f"{what} batch {i}: trivial hist {hist}")
        kept += n_kept
    return kept


def main_path_mesh(batches, dev_outs, main_bytes: dict, dev) -> dict:
    """main_path's rows and config through the chain's mesh route: one
    sharded run per batch over MESH_SHARDS shards of the card."""
    reset_dispatch_bytes()
    with PathLaunches("main_path_mesh") as launches:
        outs, seconds, sums, _ = run_mesh_chain(CONFIG, batches, None, dev)
    staged = dispatch_bytes()
    runs = len(batches) * MESH_SHARDS
    for k in ("shard_hist", "sha256_hmac", "pred3vl_mask"):
        if launches.counts[k] != runs:
            raise AssertionError(f"main_path_mesh: {k} launched "
                                 f"{launches.counts[k]} times, not {runs}: "
                                 "a batch left the sharded program")
    for i, (a, b) in enumerate(zip(outs, dev_outs)):
        if not batches_identical(a, b):
            raise AssertionError(f"main_path_mesh batch {i} differs from "
                                 "main_path's")
    kept = check_mesh_sums(outs, sums, "main_path_mesh")
    pad_rows = sum(bucket_rows(-(-b.n_rows // MESH_SHARDS)) * MESH_SHARDS
                   - b.n_rows for b in batches)
    return dict(rows=ROWS, batch_rows=BATCH_ROWS, shards=MESH_SHARDS,
                kept=kept, device_seconds=seconds,
                device_rows_per_s=ROWS / seconds, h2d_bytes=staged,
                main_path_h2d_bytes=main_bytes, pad_rows=pad_rows,
                launches=launches.counts, identical_to="main_path",
                sums_equal_to="host bincount")


def dispatch_mesh(dev) -> dict:
    """The dispatch phase's dictionary batches through the mesh's dict
    route: the pool hashed once, each shard gathering its rows' digest
    words; the output equals the host strategy's, URL stays encoded."""
    values, batch_data = dispatch_data()
    _hmac_key_states(b"bench-salt", dev)  # the key's states, made once
    pool = DictPool(*_flat_bytes(values + [b""]), null_code=len(values))
    data = dispatch_batches(pool, batch_data)
    reset_flat_materializations()
    with PathLaunches("dispatch_mesh") as launches:
        outs, seconds, sums, _ = run_mesh_chain(DISPATCH_CONFIG, data,
                                                data[0], dev)
    staged = dispatch_bytes()
    materialized = flat_materializations()
    lazy = all(b.column("URL").is_lazy_dict for b in outs)
    runs = (DISPATCH_BATCHES + 1) * MESH_SHARDS
    want = {"sha256_hmac": 1, "digest_gather": runs, "shard_hist": runs,
            "pred_decode": runs, "pred3vl_mask": runs}
    got = {k: launches.counts[k] for k in want}
    if materialized or not lazy or got != want:
        raise AssertionError(f"dispatch_mesh: {materialized} flat "
                             f"materializations, URL encoded {lazy}, "
                             f"launches {got} (want {want})")
    host, host_s, _ = run_dispatch(values, batch_data, "auto", "host", dev)
    for i, (a, h) in enumerate(zip(outs, host)):
        if not batches_identical(a, h):
            raise AssertionError(f"dispatch_mesh batch {i} differs from the "
                                 "host strategy")
    kept = check_mesh_sums(outs, sums, "dispatch_mesh")
    rows = DISPATCH_ROWS * DISPATCH_BATCHES
    return dict(rows=rows, batch_rows=DISPATCH_ROWS, shards=MESH_SHARDS,
                pool_values=DISPATCH_UNIQUES, kept=kept,
                device_seconds=seconds, device_rows_per_s=rows / seconds,
                host_rows_per_s=rows / host_s, h2d_bytes=staged,
                flat_materializations=materialized, launches=launches.counts,
                equal_to="host", sums_equal_to="host bincount")


def step_inputs(mesh, dev):
    """example_step_args at the phase's size, with one row in 4,099 of
    each column a real HMAC message block (so hashlib can check it) and
    a few 1e300/inf scores and negative ages."""
    blocks, n_blocks, ages, scores = example_step_args(
        mesh, STEP_ROWS_PER_DEVICE, STEP_COLUMNS, STEP_MAX_BLOCKS)
    rows = np.arange(0, blocks.shape[1], 4099)
    msgs = [f"row-{r}-{'m' * (r % 100)}".encode() for r in rows]
    packed, counts = pack_hmac_blocks(*_flat_bytes(msgs), STEP_MAX_BLOCKS)
    for c in range(STEP_COLUMNS):
        blocks[c, rows] = packed
        n_blocks[c, rows] = counts
    scores[rows[1::3]] = 1e300
    scores[rows[2::3]] = np.inf
    ages[rows[::5]] = -1
    return (blocks, n_blocks, ages, scores), rows, msgs


def mesh_step(dev) -> dict:
    """sharded_transform_step on MESH_SHARDS shards of the card against
    a 1-shard mesh, hashlib and a host bincount."""
    force_virtual_mesh(MESH_SHARDS)
    try:
        mesh = make_mesh(device=dev)
    finally:
        force_virtual_mesh(None)
    if mesh.shape != {"data": 2, "model": 2}:
        raise AssertionError(f"mesh {mesh.shape}")
    t0 = time.perf_counter()
    args, rows, msgs = step_inputs(mesh, dev)
    gen_s = time.perf_counter() - t0
    step = sharded_transform_step(mesh, STEP_MAX_BLOCKS, TARGET_SHARDS)
    step(*args)  # warm: pinned buffers, the build
    torch.cuda.synchronize(dev)
    with PathLaunches("mesh_step") as launches:
        t0 = time.perf_counter()
        out = step(*args)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
    if launches.counts["shard_hist"] != MESH_SHARDS or \
            launches.counts["sha256_hmac"] != MESH_SHARDS:
        raise AssertionError(f"mesh_step launches {launches.counts}")
    one = sharded_transform_step(make_mesh(n_devices=1, device=dev),
                                 STEP_MAX_BLOCKS, TARGET_SHARDS)(*args)
    for name, a, b in zip(("digests", "keep", "scores_f32", "hist", "total"),
                          out, one):
        if not torch.equal(a.view(torch.int32) if a.is_floating_point()
                           else a, b.view(torch.int32)
                           if b.is_floating_point() else b):
            raise AssertionError(f"mesh_step {name}: 4 shards differ from "
                                 "1 shard")
    digests, keep, _, hist, total = (t.cpu().numpy() for t in out)
    words = digests.view(np.uint32)
    for c in range(STEP_COLUMNS):
        got = [bytes(r).hex() for r in
               _words_to_bytes(words[c, rows])]
        want = [hmac.new(b"mask-key", m, hashlib.sha256).hexdigest()
                for m in msgs]
        if got != want:
            raise AssertionError(f"mesh_step column {c} differs from hashlib")
    n_kept = int(keep.sum())
    want_hist = sum(host_hist(words[c, keep, 0].astype(np.uint64))
                    for c in range(STEP_COLUMNS))
    if int(total) != n_kept or int(hist.sum()) != n_kept * STEP_COLUMNS or \
            not np.array_equal(hist, want_hist) or keep[rows[1::3]].any():
        raise AssertionError(f"mesh_step sums: total {total}, kept {n_kept}, "
                             f"hist {hist} vs {want_hist}")
    n_rows = words.shape[1]
    return dict(shards=MESH_SHARDS, mesh=mesh.shape, columns=STEP_COLUMNS,
                rows=n_rows, max_blocks=STEP_MAX_BLOCKS,
                block_bytes=int(args[0].nbytes), kept=n_kept,
                data_gen_seconds=gen_s, step_seconds=seconds,
                rows_per_s=n_rows / seconds,
                hashed_rows_per_s=n_rows * STEP_COLUMNS / seconds,
                launches=launches.counts,
                equal_to=["1-shard mesh", "hashlib", "host bincount"])


def mesh1(dev) -> dict:
    """bench.py measure_mesh_1dev's shape: ShardedFusedProgram on a
    1-shard mesh against FusedMaskFilterProgram, interleaved, medians."""
    rng = np.random.default_rng(21)
    urls = np.char.add("https://example-",
                       rng.integers(0, 997, MESH1_ROWS).astype("U4"))
    data, offsets = flat_strings(urls)
    region = rng.integers(0, 500, MESH1_ROWS).astype(np.int32)
    node = parse("RegionID < 400")
    mask_cols = [(data, offsets)]
    pred_cols = {"RegionID": (region, None)}
    plain = FusedMaskFilterProgram([b"bench-salt"], node, dev)
    sharded = ShardedFusedProgram([b"bench-salt"], node,
                                  make_mesh(n_devices=1, device=dev))
    with PathLaunches("mesh1") as launches:
        want = plain.run(mask_cols, pred_cols, MESH1_ROWS)
        out = sharded.run(mask_cols, pred_cols, MESH1_ROWS)
        plain_ts, mesh_ts = [], []
        for _ in range(MESH1_ITERS):
            t0 = time.perf_counter()
            plain.run(mask_cols, pred_cols, MESH1_ROWS)
            plain_ts.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            out = sharded.run(mask_cols, pred_cols, MESH1_ROWS)
            mesh_ts.append(time.perf_counter() - t0)
    hexes, keep = out
    if not (np.array_equal(hexes[0], want[0][0])
            and np.array_equal(keep, want[1])):
        raise AssertionError("mesh1: the 1-shard mesh differs from the "
                             "fused program")
    kept = int(keep.sum())
    word0 = np.array([int(bytes(r[:8]), 16) for r in hexes[0][keep]],
                     dtype=np.uint64)
    if kept != int((region < 400).sum()) or sharded.last_kept != kept or \
            not np.array_equal(sharded.last_shard_hist, host_hist(word0)):
        raise AssertionError(f"mesh1: kept {sharded.last_kept} / {kept}, "
                             f"hist {sharded.last_shard_hist}")
    plain_s, mesh_s = statistics.median(plain_ts), statistics.median(mesh_ts)
    return dict(rows=MESH1_ROWS, iters=MESH1_ITERS, devices=sharded.n_dev,
                kept=kept, mesh_ms=mesh_s * 1e3, plain_device_ms=plain_s * 1e3,
                mesh_overhead_pct=100 * (mesh_s - plain_s) / plain_s,
                mesh_spread_pct=100 * (max(mesh_ts) - min(mesh_ts)) / mesh_s,
                launches=launches.counts, equal_to="FusedMaskFilterProgram")

# -- the lambda (config #5) and kafka2ch (config #1) paths ------------------

SR_SCHEMA = new_table_schema([("id", "int64"), ("url", "utf8"),
                              ("region", "int32")])
KAFKA2CH_SCHEMA = new_table_schema([  # examples/kafka2ch.yaml:9-15
    ("id", "int64", True), ("user_email", "utf8"), ("amount", "double"),
    ("ts", "timestamp")])


def sr_batches(per_partition: int) -> list[ColumnBatch]:
    """measure_kafka_sr2ch's rows (bench.py:1178-1186: id = p * m + i,
    url = https://e.test/{id % 997}, region = id % 500) as the Kafka
    source cuts them: each fetch cycle takes up to 1,024 messages from
    every partition in turn."""
    n = SR_PARTITIONS * per_partition
    ids = np.arange(n, dtype=np.int64)
    fixed = {"id": ids, "region": (ids % 500).astype(np.int32)}
    var = {"url": flat_strings(np.char.add("https://e.test/",
                                    (ids % 997).astype("U3")))}
    bounds = [(p * per_partition + lo,
               p * per_partition + min(lo + FETCH_MAX, per_partition))
              for lo in range(0, per_partition, FETCH_MAX)
              for p in range(SR_PARTITIONS)]
    return cut_batches(TableID("", "hits"), SR_SCHEMA, fixed, var, bounds)


def check_sign_flipped(batches, outs, what: str) -> None:
    """Each output against the plain reference: id is bench.py:1015's
    int32 column (INT32 in the schema, no validity), url and region are
    the input's, the table and column order unchanged."""
    if len(outs) != len(batches):
        raise AssertionError(f"{what}: {len(outs)} outputs for "
                             f"{len(batches)} batches")
    for i, (b, o) in enumerate(zip(batches, outs)):
        col = o.column("id")
        want = sign_flip_numpy(b.column("id").data, b.column("region").data)
        if (o.table_id != b.table_id or o.schema.names() != b.schema.names()
                or o.schema.find("id").data_type != CanonicalType.INT32
                or col.ctype != CanonicalType.INT32
                or col.data.dtype != np.int32 or col.validity is not None
                or not np.array_equal(col.data, want)):
            raise AssertionError(f"{what} batch {i}: id differs from the "
                                 "plain reference")
        for name in ("url", "region"):
            for x, y in zip(column_arrays(b.column(name)),
                            column_arrays(o.column(name))):
                if (x is None) != (y is None) or (
                        x is not None and not np.array_equal(x, y)):
                    raise AssertionError(f"{what} batch {i}: {name} "
                                         "changed")


def run_config(config, batches, placement: str, dev):
    """A fresh chain over the batches with one placement: (outputs,
    seconds, planned steps, output table and schema)."""
    set_placement(placement)
    try:
        chain = build_chain(config, device=dev)
        first = batches[0]
        steps = chain.plan_for(first.table_id, first.schema).steps
        table, schema = chain.output_schema(first.table_id, first.schema)
        t0 = time.perf_counter()
        outs = [chain.apply(b) for b in batches]
        torch.cuda.synchronize(dev)
        return outs, time.perf_counter() - t0, steps, table, schema
    finally:
        set_placement(None)


def lambda_path(path: str, per_partition: int, dev,
                auto: bool = False) -> dict:
    """Config #5's chain over the SR stream (or its backlog) with device
    placement (K15 once a batch) and host placement (no K15), both equal
    to the plain reference; with `auto`, once more under auto placement,
    reporting where its EWMA settled."""
    t0 = time.perf_counter()
    batches = sr_batches(per_partition)
    gen_s = time.perf_counter() - t0
    rows = sum(b.n_rows for b in batches)
    run_config(LAMBDA_CONFIG, batches[:1], "device", dev)  # warm
    with PathLaunches(path) as launches:
        dev_outs, dev_s, steps, _, _ = run_config(LAMBDA_CONFIG, batches,
                                                  "device", dev)
    if len(steps) != 1 or not isinstance(steps[0], LambdaTransformer):
        raise AssertionError(f"{path} planned {steps}")
    if launches.counts["region_sign_flip"] != len(batches):
        raise AssertionError(f"{path}: {launches.counts['region_sign_flip']}"
                             f" K15 launches for {len(batches)} batches")
    check_sign_flipped(batches, dev_outs, f"{path} device")
    del dev_outs
    _build.reset_launch_counts()
    host_outs, host_s, _, _, _ = run_config(LAMBDA_CONFIG, batches, "host",
                                            dev)
    if _build.launch_counts()["region_sign_flip"]:
        raise AssertionError(f"{path}: the host strategy launched K15")
    check_sign_flipped(batches, host_outs, f"{path} host")
    del host_outs
    sizes = sorted({b.n_rows for b in batches})
    result = dict(
        rows=rows, batches=len(batches), batch_rows=sizes,
        bucket_rows=sorted({max(256, 1 << (n - 1).bit_length())
                            for n in sizes}),
        launches=launches.counts, device_seconds=dev_s,
        device_rows_per_s=rows / dev_s, host_seconds=host_s,
        host_rows_per_s=rows / host_s, data_gen_seconds=gen_s,
        equal_to="plain reference (numpy int32), id INT32")
    if auto:
        _build.reset_launch_counts()
        auto_outs, auto_s, auto_steps, _, _ = run_config(
            LAMBDA_CONFIG, batches, "auto", dev)
        check_sign_flipped(batches, auto_outs, f"{path} auto")
        ns = dict(auto_steps[0]._ns_row)
        result["auto"] = dict(
            settled=("host" if ns["device"] < 0 or ns["host"] <= ns["device"]
                     else "device"),
            ns_row=ns, rows_per_s=rows / auto_s,
            k15_launches=_build.launch_counts()["region_sign_flip"])
    return result


def kafka2ch_batches() -> list[ColumnBatch]:
    """Config #1's schema over 1,048,576 rows (seed 7): id = i, user_email
    user{i}@example.test (bench.py measure_mysql2kafka), an amount and a
    timestamp in microseconds; 1,024-row batches of table .events."""
    rng = np.random.default_rng(7)
    n = KAFKA2CH_ROWS
    ids = np.arange(n, dtype=np.int64)
    fixed = {"id": ids, "amount": rng.random(n) * 1000.0,
             "ts": (1_700_000_000_000_000
                    + rng.integers(0, 86_400_000_000, n)).astype(np.int64)}
    var = {"user_email": flat_strings(np.char.add(
        np.char.add("user", ids.astype("U7")), "@example.test"))}
    bounds = [(lo, min(lo + KAFKA2CH_BATCH, n))
              for lo in range(0, n, KAFKA2CH_BATCH)]
    return cut_batches(TableID("", "events"), KAFKA2CH_SCHEMA, fixed, var,
                       bounds)


def kafka2ch_path(dev) -> dict:
    """Config #1's chain: the rename stays on the host, the mask after it
    fuses into a device step (one K-A launch a batch); device and host
    placement byte-identical, the output table .events_clean, sampled
    rows equal to hashlib's HMAC."""
    t0 = time.perf_counter()
    batches = kafka2ch_batches()
    gen_s = time.perf_counter() - t0
    run_config(KAFKA2CH_CONFIG, batches[:1], "device", dev)  # warm
    with PathLaunches("kafka2ch") as launches:
        dev_outs, dev_s, steps, table, schema = run_config(
            KAFKA2CH_CONFIG, batches, "device", dev)
    if [type(s) for s in steps] != [RenameTables, DeviceFusedStep] or \
            steps[1].describe() != "device[mask_field]":
        raise AssertionError(f"kafka2ch planned "
                             f"{[s.describe() for s in steps]}")
    if table != TableID("", "events_clean") or schema != KAFKA2CH_SCHEMA:
        raise AssertionError(f"kafka2ch emits {table} {schema}")
    others = {k: c for k, c in launches.counts.items()
              if c and k != "sha256_hmac"}
    if launches.counts["sha256_hmac"] != len(batches) or others:
        raise AssertionError(f"kafka2ch launches {launches.counts}")
    host_outs, host_s, _, _, _ = run_config(KAFKA2CH_CONFIG, batches, "host",
                                            dev)
    for i, (a, b) in enumerate(zip(dev_outs, host_outs)):
        if a.table_id != table or b.table_id != table or \
                not batches_identical(a, b):
            raise AssertionError(f"kafka2ch batch {i}: device output "
                                 "differs from the host strategy")
    sample = dev_outs[7].to_pydict()["user_email"]
    for j in (0, 1, 511, 1023):
        email = f"user{7 * KAFKA2CH_BATCH + j}@example.test".encode()
        if sample[j] != hmac.new(KAFKA2CH_SALT, email,
                                 hashlib.sha256).hexdigest():
            raise AssertionError(f"kafka2ch row {j} differs from hashlib")
    rows = sum(b.n_rows for b in batches)
    return dict(rows=rows, batches=len(batches), batch_rows=KAFKA2CH_BATCH,
                out_table=str(table), launches=launches.counts,
                device_seconds=dev_s, device_rows_per_s=rows / dev_s,
                host_seconds=host_s, host_rows_per_s=rows / host_s,
                data_gen_seconds=gen_s,
                identical_to_host=True, equal_to="hashlib HMAC (sampled)")


def snapshot_kept_ids(fused: bool) -> np.ndarray:
    """The user ids the chain keeps, from the generator's columns in
    numpy: each part's batches draw age, score and country from
    default_rng(seed + start) in that order (providers/sample.py)."""
    per = -(-SNAP_ROWS // SNAP_PARTS)
    kept = []
    for lo in range(0, SNAP_ROWS, per):
        hi = min(SNAP_ROWS, lo + per)
        for start in range(lo, hi, SNAP_BATCH):
            n = min(SNAP_BATCH, hi - start)
            rng = np.random.default_rng(SNAP_SEED + start)
            age = rng.integers(18, 90, n)
            rng.uniform(0, 1000, n)
            country = rng.integers(0, 6, n)
            keep = age >= 21
            if not fused:
                keep &= country < 2  # "de" and "us"
            kept.append(np.arange(start, start + n)[keep])
    return np.concatenate(kept)


class StrategyCount:
    """Counts the batches each fused step ran per strategy (what auto
    placement chose), by wrapping DeviceFusedStep._observe."""

    def __enter__(self):
        self.batches = {"host": 0, "device": 0}
        self._orig = DeviceFusedStep._observe
        counts, orig = self.batches, self._orig

        def observe(step, strategy, seconds, n_rows):
            counts[strategy] += 1
            return orig(step, strategy, seconds, n_rows)

        DeviceFusedStep._observe = observe
        return self

    def __exit__(self, *exc):
        DeviceFusedStep._observe = self._orig
        return False


class TapChoices:
    """Records each TableFingerprinter the fingerprint tap makes (one a
    part and table), to read auto's choices after the run."""

    def __enter__(self):
        self.fps = []
        self._orig = fingerprint_tap.TableFingerprinter
        fps, orig = self.fps, self._orig

        def make(*a, **kw):
            fps.append(orig(*a, **kw))
            return fps[-1]

        fingerprint_tap.TableFingerprinter = make
        return self

    def __exit__(self, *exc):
        fingerprint_tap.TableFingerprinter = self._orig
        return False

    def checked(self, name: str, dev) -> dict:
        """Auto is the reference's measured choice: each tap's first two
        batches time the host lanes, and on the card every batch after
        them goes to K10 (one launch each), so the tap's K10 launches are
        its "device" choices."""
        taps = [dict(choices=fp.choices, ns_per_row=fp.ns_per_row())
                for fp in self.fps]
        for t in taps:
            c = t["choices"]
            if any(x != "host" for x in c[:2]) or (
                    dev.type == "cuda" and any(x != "device"
                                               for x in c[2:])):
                raise AssertionError(f"snapshot {name}: the tap's auto "
                                     f"chose {c} ({t['ns_per_row']})")
        return dict(taps=taps, device_batches=sum(
            t["choices"].count("device") for t in taps))


def snapshot_run(name: str, config, placement: str, dev) -> dict:
    """One Quick-start transfer through SnapshotLoader on a memory
    coordinator, the placement pinned (or auto); its launches, seconds,
    parts, published digest and the sink's rows sorted by user_id."""
    sid = f"chip-snapshot-{name}"
    store = get_store(sid)
    store.clear()
    transfer = Transfer(
        id=sid,
        src=SampleSourceParams(preset="users", table=SNAP_TABLE.name,
                               rows=SNAP_ROWS, batch_rows=SNAP_BATCH,
                               seed=SNAP_SEED, shard_parts=SNAP_PARTS,
                               dict_encode=True),
        dst=MemoryTargetParams(sink_id=sid,
                               bufferer={"trigger_rows": SNAP_TRIGGER}),
        transformation=config,
        runtime=Runtime(sharding=ShardingUploadParams(
            process_count=SNAP_THREADS)),
        validation={"fingerprint": True})
    cp = MemoryCoordinator()
    set_placement(None if placement == "auto" else placement)
    try:
        with StrategyCount() as strategies, TapChoices() as taps:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            SnapshotLoader(transfer, cp, device=dev).upload_tables()
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = _build.launch_counts()
    finally:
        set_placement(None)
    tap = taps.checked(name, dev)
    if launches["rowhash_lanes"] < tap["device_batches"]:
        raise AssertionError(f"snapshot {name}: {tap['device_batches']} "
                             "tap batches on the card, K10 launched "
                             f"{launches['rowhash_lanes']} times")
    parts = cp.operation_parts(f"op-{sid}")
    if len(parts) != SNAP_PARTS or not all(
            p.completed and p.commit_epoch == p.assignment_epoch
            for p in parts):
        raise AssertionError(f"snapshot {placement}: parts not all "
                             f"completed and committed: {parts}")
    digests = cp.get_operation_state(f"op-{sid}")["table_fingerprints"]
    batches = [b for b in store.batches if hasattr(b, "columns")]
    rows = ColumnBatch.concat(batches)
    rows = rows.take(np.argsort(rows.column("user_id").data, kind="stable"))
    store.clear()
    return dict(launches=launches, seconds=seconds, digests=digests,
                batches=batches, rows=rows,
                strategy_batches=strategies.batches, tap=tap,
                completed_rows=sum(p.completed_rows for p in parts))


def snapshot_path(dev) -> dict:
    """The README's Quick-start transfer (2,000,000 sample users rows, 4
    parts on 4 upload threads, dictionary-encoded country, Bufferer
    flushes of 131,072 rows, staged commits, fingerprint validation)
    through the port's SnapshotLoader: its chain (mask on the card, the
    utf8 IN filter on the host) with device placement, and with the
    filter `age >= 21` fused onto the card with device, host and auto
    placement.  Per chain the sink's rows sorted by user_id are
    byte-identical across placements, the kept ids equal numpy's over
    the generator's columns, the published digest equals
    TableFingerprinter(backend="device") and the plain version on the
    card over the sink's rows, and every part is completed and
    committed; the launches of the runs, summed over the upload
    threads, hold every kernel of the path."""
    runs = {"readme_device": (SNAP_README, "device"),
            "fused_device": (SNAP_FUSED, "device"),
            "fused_host": (SNAP_FUSED, "host"),
            "fused_auto": (SNAP_FUSED, "auto")}
    launches = {k: 0 for k in _build.KERNELS}
    result, first = {}, {}
    for name, (config, placement) in runs.items():
        run = snapshot_run(name, config, placement, dev)
        for k, c in run["launches"].items():
            launches[k] += c
        fused = config is SNAP_FUSED
        want = snapshot_kept_ids(fused)
        got = run["rows"].column("user_id").data
        if not np.array_equal(got, want):
            raise AssertionError(f"snapshot {name}: kept {len(got)} rows, "
                                 f"numpy keeps {len(want)}")
        if fused in first:
            if not batches_identical(run["rows"], first[fused]["rows"]):
                raise AssertionError(f"snapshot {name}: rows differ from "
                                     "device placement's")
            if run["digests"] != first[fused]["digests"]:
                raise AssertionError(f"snapshot {name}: digest differs "
                                     "from device placement's")
        else:
            first[fused] = run
        (digest,) = run["digests"].values()
        if digest != device_digest(run["batches"], dev)[0] or \
                digest != plain_digest(run["batches"], dev):
            raise AssertionError(f"snapshot {name}: published digest "
                                 "differs from the sink's rows")
        if run["completed_rows"] != SNAP_ROWS:
            raise AssertionError(f"snapshot {name}: parts read "
                                 f"{run['completed_rows']} rows")
        result[name] = dict(
            kept=len(got), seconds=run["seconds"],
            rows_per_s=SNAP_ROWS / run["seconds"], digest=digest,
            launches={k: c for k, c in run["launches"].items() if c},
            fused_step_batches=run["strategy_batches"],
            tap=run["tap"])
        del run
    require_launched("snapshot", launches)
    return dict(rows=SNAP_ROWS, parts=SNAP_PARTS, threads=SNAP_THREADS,
                batch_rows=SNAP_BATCH, trigger_rows=SNAP_TRIGGER,
                launches=launches, runs=result,
                identical_across_placements=True,
                digest_equal_to="TableFingerprinter(backend='device') and "
                                "the plain version over the sink's rows")


class ReplicationProbe:
    """Wraps the Transformation middleware's push for one run: the row
    count of every batch the chain sees and when the first arrived."""

    def __enter__(self):
        self.sizes: dict[int, int] = {}
        self.first_push: Optional[float] = None
        self._lock = threading.Lock()
        self._push = sync_mw.Transformation.push
        probe, chain_push = self, self._push

        def push(mw, batch):
            with probe._lock:
                if probe.first_push is None:
                    probe.first_push = time.perf_counter()
                n = sync_mw.batch_len(batch)
                probe.sizes[n] = probe.sizes.get(n, 0) + 1
            return chain_push(mw, batch)

        sync_mw.Transformation.push = push
        return self

    def __exit__(self, *exc):
        sync_mw.Transformation.push = self._push
        return False


def produce(port: int, partitions: int, per: int, chunk: int, value) -> None:
    """Seed the fake broker over the wire: partition p holds messages
    value(p, i) for i < per, produced `chunk` records a request."""
    client = KafkaClient([f"127.0.0.1:{port}"])
    try:
        for p in range(partitions):
            for lo in range(0, per, chunk):
                client.produce("events", p, [
                    Record(key=b"", value=value(p, i),
                           timestamp_ms=1_700_000_000_000 + i)
                    for i in range(lo, min(per, lo + chunk))])
    finally:
        client.close()


def percentile(steady: list, q: float) -> float:
    return steady[max(0, -(-int(q * 100) * len(steady) // 100) - 1)]


def replication_run(name: str, broker: FakeKafka, src_schema, config,
                    bufferer, expected: int, placement: str, dev,
                    parser: Optional[dict] = None,
                    partitions: int = REPL_PARTITIONS) -> dict:
    """One INCREMENT_ONLY transfer through run_replication from the
    broker into a fresh fake ClickHouse, the placement pinned; waits for
    `expected` rows and for every partition's offset to commit, then
    stops.  The source parses JSON rows of `src_schema` unless `parser`
    names another parser.  Returns the readings and the rows sorted by
    id."""
    ch = FakeCH().start()
    tid = f"chip-repl-{name}-{placement}"
    # the CH target's default Bufferer (100,000 rows or 1 s), or none
    dst = CHTargetParams(host="127.0.0.1", port=ch.port) if bufferer \
        else CHTargetParams(host="127.0.0.1", port=ch.port, bufferer=None)
    transfer = Transfer(
        id=tid, type=TransferType.INCREMENT_ONLY,
        src=KafkaSourceParams(
            brokers=[f"127.0.0.1:{broker.port}"], topic="events",
            parallelism=4,
            parser=parser or {"json": {"schema": src_schema,
                                       "table": "events"}}),
        dst=dst, transformation=config)
    cp, metrics, stop = MemoryCoordinator(), Metrics(), threading.Event()
    last = {f"events:{p}": len(broker.topics["events"][p]) - 1
            for p in range(partitions)}
    stagetimer.enable(True)
    stagetimer.collect_samples("transform")
    stagetimer.reset()
    set_placement(placement)
    failure = []

    def run():
        try:
            run_replication(transfer, cp, metrics=metrics, stop_event=stop,
                            backoff=0.2, device=dev)
        except BaseException as e:  # surfaced below
            failure.append(e)

    th = threading.Thread(target=run, daemon=True)
    try:
        with ReplicationProbe() as seen:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            th.start()
            deadline = time.monotonic() + REPL_SETTLE_S
            t_first = None
            while ch.total_rows() < expected and not failure:
                if t_first is None and ch.total_rows():
                    t_first = time.perf_counter()
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"replication {name} {placement}: "
                        f"{ch.total_rows()} of {expected} rows")
                time.sleep(0.002)
            t_done = time.perf_counter()
            while cp.get_transfer_state(tid).get("kafka_offsets") != last \
                    and not failure:
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"replication {name} {placement}: offsets "
                        f"{cp.get_transfer_state(tid)}, want {last}")
                time.sleep(0.01)
            torch.cuda.synchronize(dev)
            launches = _build.launch_counts()
    finally:
        stop.set()
        th.join(30)
        set_placement(None)
        stagetimer.enable(False)
        ch.stop()
    if failure:
        raise AssertionError(f"replication {name} {placement} failed: "
                             f"{failure[0]!r}")
    if th.is_alive():
        raise AssertionError(f"replication {name} {placement}: the loop "
                             "did not stop")
    tables = {n: t for n, t in ch.tables.items()}
    if ch.total_rows() != expected or len(tables) != 1:
        raise AssertionError(f"replication {name} {placement}: "
                             f"{ch.total_rows()} rows in {list(tables)}, "
                             f"want {expected} in one table")
    unparsed = metrics.value("publisher_data_unparsed_rows")
    if unparsed:
        raise AssertionError(f"replication {name} {placement}: {unparsed} "
                             "unparsed rows")
    (ch_table, tb), = tables.items()
    columns = list(tb["rows"][0])
    by_id = columns.index("id")
    rows = sorted((tuple(r.values()) for r in tb["rows"]),
                  key=lambda r: r[by_id])
    lat = sorted(stagetimer.samples("transform"))
    # bench.py measure_kafka2ch: drop the largest (the first batch's
    # program build) when there are more than four
    steady = lat[:max(1, len(lat) - 1)] if len(lat) > 4 else lat
    return dict(
        rows_sorted=rows, columns=columns, table=ch_table, launches=launches,
        rows_per_s=expected / (t_done - t0),
        rows_per_s_from_first_push=expected / (t_done - seen.first_push),
        seconds=t_done - t0, first_push_s=seen.first_push - t0,
        first_rows_s=(t_first or t_done) - t0,
        transform_p50_ms=percentile(steady, 0.50) * 1000,
        transform_p99_ms=percentile(steady, 0.99) * 1000,
        transform_max_ms=lat[-1] * 1000 if lat else None,
        transform_batches=len(lat),
        chain_batch_rows={str(k): v for k, v in sorted(seen.sizes.items())},
        transform_seconds=sum(lat),
        offsets_committed=len(last), parsed_rows=metrics.value(
            "publisher_data_parsed_rows"),
        restarts=metrics.value("replication_restarts"))


def k2ch_message(p: int, i: int) -> bytes:
    """bench.py measure_kafka2ch's message: id p * 1,500 + i, a URL and
    region i % 500."""
    return json.dumps({"id": p * REPL_MESSAGES + i,
                       "url": f"https://bench.example/{i}",
                       "region": i % 500}).encode()


def backlog_columns() -> dict:
    """Config #1's rows, the kafka2ch phase's generator (seed 7) over the
    backlog's 16 x BACKLOG_MESSAGES ids."""
    n = REPL_PARTITIONS * BACKLOG_MESSAGES
    rng = np.random.default_rng(7)
    ids = np.arange(n, dtype=np.int64)
    return {"id": ids, "amount": rng.random(n) * 1000.0,
            "ts": (1_700_000_000_000_000
                   + rng.integers(0, 86_400_000_000, n)).astype(np.int64)}


def replication_path(dev) -> dict:
    """run_replication over the port's fake broker into its fake
    ClickHouse, device and host placement: (a) bench.py's
    measure_kafka2ch shape with mask + filter and no Bufferer, (b)
    config #1 (rename + mask, the default Bufferer) over a backlog.
    Exact row counts, rows sorted by id identical across placements,
    sampled masks equal to hashlib, kept ids equal to numpy's, no
    unparsed rows, every partition's last offset committed, and the
    device runs' launches."""
    t0 = time.perf_counter()
    bench_broker = FakeKafka(n_partitions=REPL_PARTITIONS).start()
    backlog_broker = FakeKafka(n_partitions=REPL_PARTITIONS).start()
    try:
        bench_broker.create_topic("events")
        backlog_broker.create_topic("events")
        # bench.py produces each partition's 1,500 messages at once
        produce(bench_broker.port, REPL_PARTITIONS, REPL_MESSAGES,
                REPL_MESSAGES, k2ch_message)
        cols = backlog_columns()

        def backlog_message(p: int, i: int) -> bytes:
            k = p * BACKLOG_MESSAGES + i
            return json.dumps({
                "id": int(cols["id"][k]),
                "user_email": f"user{k}@example.test",
                "amount": float(cols["amount"][k]),
                "ts": int(cols["ts"][k])}).encode()

        produce(backlog_broker.port, REPL_PARTITIONS, BACKLOG_MESSAGES,
                FETCH_MAX, backlog_message)
        gen_s = time.perf_counter() - t0
        bench_keep = np.array([p * REPL_MESSAGES + i
                               for p in range(REPL_PARTITIONS)
                               for i in range(REPL_MESSAGES)
                               if i % 500 < 400])
        runs = {}
        for shape, broker, schema, config, buf, expected in (
                ("bench", bench_broker, REPL_SCHEMA, REPL_CONFIG, False,
                 len(bench_keep)),
                ("backlog", backlog_broker, K2CH_SCHEMA, KAFKA2CH_CONFIG,
                 True, REPL_PARTITIONS * BACKLOG_MESSAGES)):
            for placement in ("device", "host"):
                runs[(shape, placement)] = replication_run(
                    shape, broker, schema, config, buf, expected,
                    placement, dev)
    finally:
        bench_broker.stop()
        backlog_broker.stop()
    want = {"bench": {"sha256_hmac", "pred_decode", "pred3vl_mask"},
            "backlog": {"sha256_hmac"}}
    launches = {k: 0 for k in _build.KERNELS}
    result = {}
    for shape in ("bench", "backlog"):
        dev_run, host_run = runs[(shape, "device")], runs[(shape, "host")]
        got = {k for k, c in dev_run["launches"].items() if c}
        host_launched = {k: c for k, c in host_run["launches"].items() if c}
        if got != want[shape] or host_launched:
            raise AssertionError(f"replication {shape}: device launched "
                                 f"{got} (want {want[shape]}), host "
                                 f"{host_launched}")
        for k, c in dev_run["launches"].items():
            launches[k] += c
        if dev_run["rows_sorted"] != host_run["rows_sorted"] or \
                dev_run["columns"] != host_run["columns"]:
            raise AssertionError(f"replication {shape}: device rows differ "
                                 "from the host placement's")
        rows = dev_run["rows_sorted"]
        by_id = dev_run["columns"].index("id")
        ids = np.array([r[by_id] for r in rows])
        if shape == "bench":
            if dev_run["table"] != "events" or not np.array_equal(
                    ids, bench_keep):
                raise AssertionError(f"replication bench: kept {len(ids)} "
                                     f"ids, numpy keeps {len(bench_keep)}")
            salt, col = REPL_SALT, dev_run["columns"].index("url")

            def message(k):
                return f"https://bench.example/{k % REPL_MESSAGES}"
        else:
            if dev_run["table"] != "events_clean" or not np.array_equal(
                    ids, cols["id"]):
                raise AssertionError(f"replication backlog: table "
                                     f"{dev_run['table']}, {len(ids)} ids")
            salt, col = KAFKA2CH_SALT, dev_run["columns"].index(
                "user_email")

            def message(k):
                return f"user{k}@example.test"
        for j in (0, 1, len(rows) // 2, len(rows) - 1):
            k = int(ids[j])
            want_hex = hmac.new(salt, message(k).encode(),
                                hashlib.sha256).hexdigest().encode()
            if rows[j][col] != want_hex:
                raise AssertionError(f"replication {shape}: row {k}'s mask "
                                     "differs from hashlib")
        if shape == "backlog":
            amount = dev_run["columns"].index("amount")
            if [r[amount] for r in rows[:3]] != cols["amount"][:3].tolist():
                raise AssertionError("replication backlog: amounts differ")
        result[shape] = {
            placement: {k: v for k, v in run.items() if k != "rows_sorted"}
            for placement, run in (("device", dev_run),
                                   ("host", host_run))}
        result[shape]["rows"] = len(rows)
    require_launched("replication", launches)
    return dict(partitions=REPL_PARTITIONS,
                bench_messages=REPL_MESSAGES,
                backlog_messages=BACKLOG_MESSAGES, data_gen_seconds=gen_s,
                launches=launches, runs=result,
                identical_across_placements=True,
                mask_equal_to="hashlib HMAC (sampled)",
                kept_equal_to="numpy region < 400")


# -- phases 15b, 15c: configs #5 and #2 --------------------------------------

class SRProbe:
    """Wraps the schema-registry parser's columnar Avro route for one
    run (every Avro run tries it first; None sends the run row by row):
    the records it was given and those it decoded."""

    def __enter__(self):
        self.records = 0
        self.native = 0
        self._lock = threading.Lock()
        self._decode = ConfluentSRParser._avro_batch_native
        probe, decode = self, self._decode

        def avro_batch_native(parser, avro, msgs):
            out = decode(parser, avro, msgs)
            with probe._lock:
                probe.records += len(msgs)
                probe.native += len(msgs) if out is not None else 0
            return out

        ConfluentSRParser._avro_batch_native = avro_batch_native
        return self

    def __exit__(self, *exc):
        ConfluentSRParser._avro_batch_native = self._decode
        return False


def register_schema(url: str, schema: dict) -> int:
    """POST a schema to the fake registry (localhost), its id back."""
    import urllib.request

    req = urllib.request.Request(
        url + "/subjects/hits-value/versions",
        data=json.dumps({"schema": json.dumps(schema)}).encode(),
        headers={"Content-Type": "application/vnd.schemaregistry.v1+json"})
    with urllib.request.urlopen(req, timeout=10) as resp:
        return json.loads(resp.read())["id"]


def sr2ch_path(dev) -> dict:
    """BASELINE config #5 end to end, bench.py measure_kafka_sr2ch's
    shape through run_replication: the port's fake broker and fake
    schema registry, the confluent_schema_registry parser (the host
    library's avro_decode_flat), the lambda (K15 on the card with device
    placement), the fake ClickHouse with no Bufferer; device and host
    placement.  Every row lands, ids equal numpy's sign flip truncated
    to int32, rows identical across placements, K15 at least once a
    chain batch on the card and never on the host."""
    t0 = time.perf_counter()
    broker = FakeKafka(n_partitions=SR_PARTITIONS).start()
    sr = FakeSchemaRegistry().start()
    expected = SR_PARTITIONS * SR_MESSAGES
    try:
        broker.create_topic("events")
        header = b"\x00" + register_schema(sr.url, SR_AVRO_SCHEMA).to_bytes(
            4, "big")

        def value(p: int, i: int) -> bytes:
            rid = p * SR_MESSAGES + i
            url = f"https://e.test/{rid % 997}".encode()
            return (header + zigzag_bytes(rid) + zigzag_bytes(len(url))
                    + url + zigzag_bytes(rid % 500))

        produce(broker.port, SR_PARTITIONS, SR_MESSAGES, SR_MESSAGES, value)
        gen_s = time.perf_counter() - t0
        parser = {"confluent_schema_registry": {"registry_url": sr.url,
                                                "table": "hits"}}
        runs = {}
        for placement in ("device", "host"):
            with SRProbe() as probe:
                run = replication_run(
                    "sr2ch", broker, None, LAMBDA_CONFIG, False, expected,
                    placement, dev, parser=parser, partitions=SR_PARTITIONS)
            run["avro_records"] = probe.records
            run["native_share"] = probe.native / max(1, probe.records)
            runs[placement] = run
    finally:
        sr.stop()
        broker.stop()
    dev_run, host_run = runs["device"], runs["host"]
    if dev_run["rows_sorted"] != host_run["rows_sorted"] or \
            dev_run["columns"] != host_run["columns"]:
        raise AssertionError("sr2ch: device rows differ from the host "
                             "placement's")
    rid = np.arange(expected, dtype=np.int64)
    want = np.sort(np.where(rid % 500 < REGION_THRESHOLD, rid, -rid)
                   .astype(np.int32))
    by_id = dev_run["columns"].index("id")
    ids = np.array([r[by_id] for r in dev_run["rows_sorted"]])
    if dev_run["table"] != "hits" or not np.array_equal(ids, want):
        raise AssertionError(f"sr2ch: {len(ids)} ids in "
                             f"{dev_run['table']}, not numpy's sign flip")
    for name, run in runs.items():
        if run["avro_records"] < expected:
            raise AssertionError(f"sr2ch {name}: {run['avro_records']} Avro "
                                 f"records decoded, want {expected}")
    batches = sum(dev_run["chain_batch_rows"].values())
    k15 = dev_run["launches"]["region_sign_flip"]
    got = {k for k, c in dev_run["launches"].items() if c}
    host_launched = {k: c for k, c in host_run["launches"].items() if c}
    if got != {"region_sign_flip"} or k15 < batches or host_launched:
        raise AssertionError(f"sr2ch: device launched "
                             f"{dev_run['launches']} over {batches} batches, "
                             f"host {host_launched}")
    launches = dict(dev_run["launches"])
    require_launched("sr2ch", launches)
    return dict(
        partitions=SR_PARTITIONS, messages=SR_MESSAGES, rows=expected,
        data_gen_seconds=gen_s, launches=launches, chain_batches=batches,
        runs={placement: {k: v for k, v in run.items()
                          if k != "rows_sorted"}
              for placement, run in runs.items()},
        identical_across_placements=True,
        ids_equal_to="numpy sign flip of id where region >= 400, int32")


def pg2ch_run(pg: FakePG, placement: str, dev) -> dict:
    """One activation of config #2 into a fresh fake ClickHouse on a
    fresh memory coordinator, the placement pinned."""
    ch = FakeCH().start()
    tid = "chip-pg2ch"
    transfer = Transfer(
        id=tid, src=PGSourceParams(host="127.0.0.1", port=pg.port,
                                   database="db", user="u"),
        dst=CHTargetParams(host="127.0.0.1", port=ch.port, bufferer=None),
        transformation=PG2CH_CONFIG)
    cp = MemoryCoordinator()
    # every staged push and the keys K10 gave it on the path (a clean run
    # never arms the dedup window, so nothing else reads them)
    keyed, row_keys = [], staging._row_keys

    def keep_keys(batch, device):
        keys = row_keys(batch, device)
        keyed.append((batch, keys))
        return keys

    staging._row_keys = keep_keys
    set_placement(placement)
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        activate_delivery(transfer, cp, device=dev)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = _build.launch_counts()
        rows = sorted(tuple(sorted(r.items()))
                      for r in ch.rows("public__hits"))
        fence = ch.rows("__trtpu_commits")
        staging_tables = sorted(n for n in ch.tables
                                if n.startswith("__trtpu_stg_"))
    finally:
        staging._row_keys = row_keys
        set_placement(None)
        ch.stop()
    # K10 against its plain version on this path's own batches (int64
    # key, utf8, int32, double; the filter's survivors), after the count
    checked = 0
    for batch, keys in keyed:
        if keys is None:
            continue
        if not is_columnar(batch):
            batch = ColumnBatch.from_rows(batch)
        if not np.array_equal(keys, plain_keys(batch, dev)):
            raise AssertionError(f"pg2ch {placement}: K10's keys of staged "
                                 f"push {checked} ({batch.n_rows} rows) "
                                 f"differ from the plain version")
        checked += 1
    parts = cp.operation_parts(f"op-{tid}")
    return dict(rows_sorted=rows, seconds=seconds, launches=launches,
                rows_per_s=PG2CH_ROWS / seconds, delivered=len(rows),
                parts=len(parts), fence_rows=len(fence),
                staging_tables=staging_tables,
                keys_checked=checked,
                committed=all(p.completed for p in parts),
                status=cp.get_status(tid).value,
                transfer_state=cp.get_transfer_state(tid))


def pg2ch_path(dev) -> dict:
    """BASELINE config #2 end to end, bench.py measure_pg2ch's shape
    through activate_delivery: the port's fake Postgres (300,000 rows,
    COPY CSV decoded by the port), filter_rows "region < 400 AND score
    >= 10" (on the host path: a run with no mask is not fused), the fake
    ClickHouse with no Bufferer and staged commits, whose dedup window
    keys each staged push with K10 on the card; device and host
    placement.  The delivered count equals bench.py's expected count,
    rows identical across placements, one __trtpu_commits row a part, no
    staging table left, K10 alone launched, as often in both runs, and
    each staged push's keys from K10 equal to the plain version's."""
    t0 = time.perf_counter()
    pg = FakePG().start()
    try:
        pg.add_table(FakeTable(
            "public", "hits", PG2CH_COLUMNS,
            [{"id": str(i), "url": f"https://e.test/{i % 997}",
              "region": str(i % 500), "score": f"{(i % 91) * 1.5}"}
             for i in range(PG2CH_ROWS)]))
        gen_s = time.perf_counter() - t0
        runs = {p: pg2ch_run(pg, p, dev) for p in ("device", "host")}
    finally:
        pg.stop()
    i = np.arange(PG2CH_ROWS)
    expected = int(((i % 500 < 400) & ((i % 91) * 1.5 >= 10)).sum())
    for name, run in runs.items():
        if run["delivered"] != expected or run["status"] != "activated" \
                or not run["committed"] or run["staging_tables"] \
                or run["fence_rows"] != run["parts"] or not run["parts"]:
            raise AssertionError(
                f"pg2ch {name}: {run['delivered']} of {expected} rows, "
                f"status {run['status']}, {run['parts']} parts, "
                f"{run['fence_rows']} fence rows, staging "
                f"{run['staging_tables']}")
        if run["transfer_state"].get("snapshot_position") is None:
            raise AssertionError(f"pg2ch {name}: no snapshot_position")
        if run["keys_checked"] != run["launches"].get("rowhash_lanes"):
            raise AssertionError(
                f"pg2ch {name}: {run['keys_checked']} staged pushes' keys "
                f"held against the plain version, "
                f"{run['launches'].get('rowhash_lanes')} K10 launches")
    dev_run, host_run = runs["device"], runs["host"]
    if dev_run["rows_sorted"] != host_run["rows_sorted"]:
        raise AssertionError("pg2ch: device rows differ from the host "
                             "placement's")
    # the same K10 launches in both placements (one a staged push), and
    # no other kernel: the filter runs on the host path
    for name, run in runs.items():
        got = {k: c for k, c in run["launches"].items() if c}
        if set(got) != set(PATH_KERNELS["pg2ch"]) or \
                got != {k: c for k, c in dev_run["launches"].items() if c}:
            raise AssertionError(f"pg2ch {name}: launched {got}, device "
                                 f"{dev_run['launches']}")
    launches = dict(dev_run["launches"])
    require_launched("pg2ch", launches)
    return dict(
        rows=PG2CH_ROWS, expected=expected, data_gen_seconds=gen_s,
        launches=launches,
        runs={placement: {k: v for k, v in run.items()
                          if k != "rows_sorted"}
              for placement, run in runs.items()},
        identical_across_placements=True,
        delivered_equal_to="bench.py measure_pg2ch's expected count")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class KeyLaunches:
    """Records every batch the port's `batch_row_keys` keys during a run
    (the MVCC store's PK and content keys, the staged sink's dedup keys)
    with the keys it got, to hold each K10 launch of the run against the
    plain version afterwards."""

    def __enter__(self):
        self.keyed = []
        self._store, self._staging = mvcc_store.batch_row_keys, \
            staging._row_keys
        keyed, keys_fn, stage_fn = self.keyed, self._store, self._staging

        def store_keys(batch, backend="auto", device=None):
            keys = keys_fn(batch, backend, device)
            keyed.append((batch, keys))
            return keys

        def stage_keys(batch, device):
            keys = stage_fn(batch, device)
            if keys is not None:
                keyed.append((batch if is_columnar(batch)
                              else ColumnBatch.from_rows(batch), keys))
            return keys

        mvcc_store.batch_row_keys = store_keys
        staging._row_keys = stage_keys
        return self

    def __exit__(self, *exc):
        mvcc_store.batch_row_keys = self._store
        staging._row_keys = self._staging
        return False

    def check(self, what: str, dev) -> int:
        """Each recorded launch's keys against the plain version on the
        same device; the number held."""
        for i, (batch, keys) in enumerate(self.keyed):
            if batch.n_rows and not np.array_equal(
                    keys, plain_keys(batch, dev)):
                raise AssertionError(f"{what}: K10's keys of batch {i} "
                                     f"({batch.n_rows} rows) differ from "
                                     "the plain version")
        return sum(1 for b, _ in self.keyed if b.n_rows)


def hits_table(rows: Optional[int] = None) -> FakeTable:
    """bench.py measure_pg2ch's Postgres table (PG2CH_ROWS rows)."""
    rows = PG2CH_ROWS if rows is None else rows
    return FakeTable(
        "public", "hits", PG2CH_COLUMNS,
        [{"id": str(i), "url": f"https://e.test/{i % 997}",
          "region": str(i % 500), "score": f"{(i % 91) * 1.5}"}
         for i in range(rows)])


def sai_feed() -> dict:
    """The pump's feed: {partition: [message dict, ...]} in produce
    order, and numpy's image of the table after it (id -> row)."""
    rng = np.random.default_rng(SAI_SEED)
    old = rng.choice(PG2CH_ROWS, SAI_UPDATED, replace=False)
    new = PG2CH_ROWS + rng.choice(10 * PG2CH_ROWS, SAI_NEW, replace=False)
    keys = np.concatenate([old, new])
    region = rng.integers(0, 500, (2, len(keys)))
    score = rng.integers(0, 91, (2, len(keys))) * 1.5
    parts: dict = {p: [] for p in range(SAI_PARTITIONS)}
    for ver in (0, 1):
        for j, k in enumerate(keys.tolist()):
            parts[k % SAI_PARTITIONS].append({
                "id": k, "url": f"https://e.test/v{ver}/{k % 997}",
                "region": int(region[ver, j]),
                "score": float(score[ver, j])})
    image = {i: (i, f"https://e.test/{i % 997}", i % 500, (i % 91) * 1.5)
             for i in range(PG2CH_ROWS)}
    for j, k in enumerate(keys.tolist()):   # the second version wins
        image[k] = (k, f"https://e.test/v1/{k % 997}", int(region[1, j]),
                    float(score[1, j]))
    return {"parts": parts, "image": image}


def kept_rows(image: dict) -> list:
    """numpy's filter over an image, as the fake ClickHouse keeps rows
    (a String column's bytes), sorted by id."""
    ids = np.fromiter(image, dtype=np.int64)
    rows = [image[i] for i in ids.tolist()]
    region = np.array([r[2] for r in rows])
    score = np.array([r[3] for r in rows])
    keep = (region < 400) & (score >= 10)
    return sorted((r[0], r[1].encode(), r[2], r[3])
                  for r, k in zip(rows, keep) if k)


def ch_hits(ch: FakeCH) -> list:
    return sorted((r["id"], r["url"], r["region"], r["score"])
                  for r in ch.rows("public__hits"))


def sai_run(pg: FakePG, feed: dict, placement: str, dev) -> dict:
    """One S&I activation through the MVCC store with a live pump on the
    port's Kafka client, keys on `dev`; traced."""
    kf = FakeKafka(n_partitions=SAI_PARTITIONS).start()
    ch = FakeCH().start()
    tid = f"chip-sai-{placement}"
    try:
        kf.create_topic("hits")
        client = KafkaClient([f"127.0.0.1:{kf.port}"])
        try:
            for p, msgs in feed["parts"].items():
                for lo in range(0, len(msgs), 4096):
                    client.produce("hits", p, [
                        Record(key=b"", value=json.dumps(m).encode(),
                               timestamp_ms=1_700_000_000_000 + lo + i)
                        for i, m in enumerate(msgs[lo:lo + 4096])])
        finally:
            client.close()
        transfer = Transfer(
            id=tid, type=TransferType.SNAPSHOT_AND_INCREMENT,
            src=PGSourceParams(host="127.0.0.1", port=pg.port,
                               database="db", user="u"),
            dst=CHTargetParams(host="127.0.0.1", port=ch.port,
                               bufferer=None),
            transformation=PG2CH_CONFIG)
        cp, metrics = MemoryCoordinator(), Metrics()
        src = KafkaSourceParams(brokers=[f"127.0.0.1:{kf.port}"],
                                topic="hits", parser=SAI_PARSER)
        store = mvcc_store.MvccStore(mvcc_runner.store_scope(tid), cp,
                                     metrics, device=dev)
        pump = MvccPump(store, KafkaQueueClient(src, tid, cp),
                        parser=make_parser(SAI_PARSER), metrics=metrics,
                        transfer_id=tid)
        trace_on()
        with KeyLaunches() as keyed:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            mvcc_runner.activate_snapshot_and_increment(
                transfer, cp, metrics, store=store, pump=pump)
            _sync(dev)
            seconds = time.perf_counter() - t0
            launches = _build.launch_counts()
        tables = trace_off(seconds)
        held = keyed.check(f"sai {placement}", dev)
        state = cp.get_transfer_state(tid)
        run = dict(
            seconds=seconds, launches=launches, k10_held_exact=held,
            rows_per_s=(PG2CH_ROWS + 2 * (SAI_UPDATED + SAI_NEW))
            / seconds,
            rows_sorted=ch_hits(ch),
            fence_rows=len(ch.rows("__trtpu_commits")),
            resume_state=mvcc_runner.resume_state(cp, tid),
            kafka_offsets=state.get("kafka_offsets"),
            layers=store.stats.m.value("mvcc_delta_layers"),
            pump_rows=store.stats.m.value("mvcc_pump_rows"),
            merged_rows=store.stats.m.value("mvcc_merged_rows"),
            cutovers=store.stats.m.value("mvcc_cutovers"),
            **tables)
        pump.close()
    finally:
        ch.stop()
        kf.stop()
    return run


def sai_tail_run(placement: str, dev) -> dict:
    """activate_delivery of the pg2ch table as SNAPSHOT_AND_INCREMENT with
    no pump (the Postgres source is not queue-shaped), then
    run_replication tails SAI_TAIL wal2json inserts of new ids fed after
    the activation.  Neither package's Postgres provider has an activate
    hook, so the slot is made when replication starts (recorded as
    slot_at_activation), and deactivate drops it."""
    pg, ch = FakePG().start(), FakeCH().start()
    tid = f"chip-sai-tail-{placement}"
    try:
        pg.add_table(hits_table())
        transfer = Transfer(
            id=tid, type=TransferType.SNAPSHOT_AND_INCREMENT,
            src=PGSourceParams(host="127.0.0.1", port=pg.port,
                               database="db", user="u"),
            dst=CHTargetParams(host="127.0.0.1", port=ch.port,
                               bufferer=None),
            transformation=PG2CH_CONFIG)
        cp = MemoryCoordinator()
        slot = f"transferia_{tid}".replace("-", "_")
        with KeyLaunches() as keyed:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            activate_delivery(transfer, cp, device=dev)
            _sync(dev)
            act_s = time.perf_counter() - t0
            launches = _build.launch_counts()
        held = keyed.check(f"sai tail {placement}", dev)
        slot_first = slot in pg.slots
        snap_rows = ch.total_rows()
        # the inserts that follow: hits rows PG2CH_ROWS .. + SAI_TAIL
        last = cdc.feed_hits_wal(pg, SAI_TAIL, txn_rows=1000,
                                 start=PG2CH_ROWS)
        i = np.arange(PG2CH_ROWS + SAI_TAIL)
        want_n = int(((i % 500 < 400) & ((i % 91) * 1.5 >= 10)).sum())
        run = cdc_run(
            "sai_tail", transfer, cp, placement, dev,
            landed=lambda: ch.total_rows() >= want_n,
            settled=lambda: cp.get_transfer_state(tid).get("pg_wal_lsn")
            == int_to_lsn(last))
        slot_created = slot in pg.slots
        get_provider("pg", transfer, device=dev).deactivate()
        run.update(activation_seconds=act_s, activation_launches=launches,
                   k10_held_exact=held, slot_at_activation=slot_first,
                   slot_created=slot_created,
                   slot_dropped=slot not in pg.slots,
                   snapshot_rows=snap_rows, rows_sorted=ch_hits(ch),
                   resume_state=mvcc_runner.resume_state(cp, tid),
                   tail_rows_per_s=SAI_TAIL / run["seconds"])
    finally:
        ch.stop()
        pg.stop()
    return run


def sai_path(dev) -> dict:
    """Config #2 as SNAPSHOT_AND_INCREMENT, on the card and with
    device="cpu": the pg2ch table snapshotted into the MVCC store while an
    MvccPump feeds sai_feed()'s 60,000 messages; the cutover seals the
    watermark, epoch and offsets, only the sealed offsets reach the
    client's commit (the coordinator's kafka_offsets), and the merged
    image publishes through the filter with the staged commit.
    ClickHouse equals numpy's latest-wins image after the filter with no
    duplicate key, resume_state equals numpy's watermark and offsets, and
    every K10 launch (store keys, content keys, staged dedup keys) equals
    its plain version.  Then the wal2json tail: activate_delivery S&I
    with no pump and run_replication of SAI_TAIL new inserts, ClickHouse
    equal to numpy's."""
    t0 = time.perf_counter()
    feed = sai_feed()
    pg = FakePG().start()
    try:
        pg.add_table(hits_table())
        gen_s = time.perf_counter() - t0
        runs = {"device": sai_run(pg, feed, "device", dev),
                "cpu": sai_run(pg, feed, "cpu", torch.device("cpu"))}
    finally:
        pg.stop()
    want = kept_rows(feed["image"])
    messages = 2 * (SAI_UPDATED + SAI_NEW)
    offsets = {f"hits:{p}": len(m) - 1 for p, m in feed["parts"].items()}
    for name, run in runs.items():
        ids = [r[0] for r in run["rows_sorted"]]
        rs = run["resume_state"]
        if run["rows_sorted"] != want or len(set(ids)) != len(ids):
            raise AssertionError(
                f"sai {name}: {len(ids)} ClickHouse rows "
                f"({len(set(ids))} keys), numpy keeps {len(want)}; equal "
                f"{run['rows_sorted'] == want}")
        if rs != {"watermark": messages - 1, "epoch": 1,
                  "offsets": offsets} or run["kafka_offsets"] != offsets:
            raise AssertionError(f"sai {name}: resume_state {rs}, "
                                 f"committed {run['kafka_offsets']}, "
                                 f"numpy {messages - 1} / {offsets}")
        if run["fence_rows"] != 1 or run["cutovers"] != 1 or \
                run["pump_rows"] != messages:
            raise AssertionError(f"sai {name}: {run['fence_rows']} fence "
                                 f"rows, {run['cutovers']} cutovers, "
                                 f"{run['pump_rows']} pumped rows")
    # every K10 launch on the card held; nothing launched with "cpu"
    card = runs["device"]
    if dev.type == "cuda" and \
            card["k10_held_exact"] != card["launches"]["rowhash_lanes"]:
        raise AssertionError(f"sai device: {card['k10_held_exact']} K10 "
                             f"launches held of "
                             f"{card['launches']['rowhash_lanes']}")
    if any(runs["cpu"]["launches"].values()):
        raise AssertionError(f"sai cpu: launched {runs['cpu']['launches']}")
    tail = {"device": sai_tail_run("device", dev),
            "cpu": sai_tail_run("cpu", torch.device("cpu"))}
    i = np.arange(PG2CH_ROWS + SAI_TAIL)
    keep = i[(i % 500 < 400) & ((i % 91) * 1.5 >= 10)]
    tail_want = [(k, url.encode(), region, score) for k, url, region, score
                 in map(cdc.hits_row, keep.tolist())]
    for name, run in tail.items():
        on_card = (run["k10_held_exact"]
                   == run["activation_launches"]["rowhash_lanes"]
                   if name == "device" and dev.type == "cuda"
                   else not any(run["activation_launches"].values()))
        if run["rows_sorted"] != tail_want or not run["slot_created"] \
                or not run["slot_dropped"] \
                or run["resume_state"] != {"watermark": -1, "epoch": 1} \
                or not on_card or run["restarts"]:
            raise AssertionError(
                f"sai tail {name}: {len(run['rows_sorted'])} rows of "
                f"{len(tail_want)}, slot {run['slot_created']} / dropped "
                f"{run['slot_dropped']}, "
                f"resume {run['resume_state']}, K10 held "
                f"{run['k10_held_exact']} of {run['activation_launches']}")
    launches = {k: runs["device"]["launches"][k]
                + tail["device"]["activation_launches"][k]
                for k in runs["device"]["launches"]}
    require_launched("sai", launches)
    return dict(
        rows=PG2CH_ROWS, messages=messages, partitions=SAI_PARTITIONS,
        kept=len(want), tail_inserts=SAI_TAIL, data_gen_seconds=gen_s,
        launches=launches,
        runs={name: {k: v for k, v in run.items() if k != "rows_sorted"}
              for name, run in runs.items()},
        tail_runs={name: {k: v for k, v in run.items()
                          if k != "rows_sorted"}
                   for name, run in tail.items()},
        identical_across_placements=True,
        rows_equal_to="numpy's latest-wins image after the filter")


# the checksum runs of each placement: on the card every backend and the
# compare; with device="cpu" what depends on the device (the fingerprint's
# "device" backend, K10's plain version there), since the host lanes,
# auto (the host without a card) and the compare run alike in both
CHECKSUM_RUNS = {
    "cuda": {"clean": (("fingerprint", "device"), ("fingerprint", "host"),
                       ("fingerprint", "auto"), ("compare", "auto")),
             "tampered": (("fingerprint", "device"), ("fingerprint", "host"),
                          ("compare", "auto")),
             "dict": (("fingerprint", "device"), ("fingerprint", "host"))},
    "cpu": {"clean": (("fingerprint", "device"),),
            "tampered": (("fingerprint", "device"),),
            "dict": (("fingerprint", "device"), ("fingerprint", "host"))},
}


class TimedLoads:
    """Times a storage's load_table calls and, inside them, the pusher (the
    checksum's fingerprint push or row collection): `read` is the load's
    wall less the pusher's, the storage's own read and decode."""

    def __init__(self, storage):
        self.storage, self.load, self.push = storage, 0.0, 0.0
        real = storage.load_table

        def load_table(td, pusher):
            def timed_push(batch):
                t = time.perf_counter()
                try:
                    return pusher(batch)
                finally:
                    self.push += time.perf_counter() - t
            t0 = time.perf_counter()
            try:
                return real(td, timed_push)
            finally:
                self.load += time.perf_counter() - t0

        storage.load_table = load_table

    def reset(self) -> dict:
        out = {"read_s": self.load - self.push, "push_s": self.push}
        self.load = self.push = 0.0
        return out


def checksum_runs(src, dst, dev, combos, traced: bool = False) -> dict:
    """The checksum of one storage pair by each (method, backend); each
    report, its seconds and rows/s (the table's rows over them), the
    launches, the fingerprinters' placements and the batches the device
    fingerprint dispatched; `traced`, each run's stage tables."""
    out = {}
    timed = {"source": TimedLoads(src), "target": TimedLoads(dst)}
    for method, backend in combos:
        name = method if method == "compare" else f"fingerprint_{backend}"
        fps, dispatched = [], []
        real_fp, real_dispatch = (checksum_mod.TableFingerprinter,
                                  rowhash.DeviceFingerprintProgram.dispatch)

        def make_fp(*a, **kw):
            fps.append(real_fp(*a, **kw))
            return fps[-1]

        def dispatch(self, cols, n):
            dispatched.append((cols, n))
            return real_dispatch(self, cols, n)

        checksum_mod.TableFingerprinter = make_fp
        rowhash.DeviceFingerprintProgram.dispatch = dispatch
        if traced:
            trace_on()
        try:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            rep = checksum_mod.checksum(
                src, dst, device=dev, params=checksum_mod.ChecksumParameters(
                    method=method, fingerprint_backend=backend))
            _sync(dev)
            seconds = time.perf_counter() - t0
            launches = _build.launch_counts()
        finally:
            checksum_mod.TableFingerprinter = real_fp
            rowhash.DeviceFingerprintProgram.dispatch = real_dispatch
            tables = trace_off(seconds) if traced else {}
        reports = [dict(table=t.table.fqtn(), ok=t.ok, strategy=t.strategy,
                        source_rows=t.source_rows,
                        target_rows=t.target_rows,
                        compared_rows=t.compared_rows,
                        mismatches=t.mismatches[:4], notes=t.notes[:2],
                        source_fingerprint=t.source_fingerprint,
                        target_fingerprint=t.target_fingerprint)
                   for t in rep.tables]
        out[name] = dict(ok=rep.ok, seconds=seconds,
                         rows_per_s=sum(t.source_rows for t in rep.tables)
                         / seconds,
                         launches=launches, tables=reports,
                         dispatched=dispatched,
                         choices=[fp.choices for fp in fps],
                         full_loads={side: t.reset()
                                     for side, t in timed.items()},
                         **tables)
    return out


def check_dispatched(runs: dict, dev) -> int:
    """Each batch the device fingerprint launched K10 on, keyed again on
    the card against the plain version (launches after the counts)."""
    held = 0
    for run in runs.values():
        for cols, n in run.pop("dispatched"):
            if dev.type != "cuda" or not n:
                continue
            r1, r2 = rowhash.rowhash_lanes(rowhash._stage(cols, dev), n)
            p1, p2 = rowhash.rowhash_lanes_plain(rowhash._stage(cols, dev),
                                                 n)
            if not (torch.equal(rowhash._to_u32(r1), p1)
                    and torch.equal(rowhash._to_u32(r2), p2)):
                raise AssertionError(f"checksum: K10's lanes of a {n}-row "
                                     "batch differ from the plain version")
            held += 1
    return held


def checksum_dict_source(batches: list) -> list:
    """The table's batches with url dictionary-encoded over one fresh
    pool (997 values)."""
    values = [f"https://e.test/{v}".encode() for v in range(997)]
    pool = DictPool(np.frombuffer(b"".join(values), np.uint8).copy(),
                    _offsets_from_lengths([len(v) for v in values]))
    out = []
    for b in batches:
        codes = b.column("id").data % 997
        cols = dict(b.columns)
        cols["url"] = Column("url", b.column("url").ctype,
                             dict_enc=DictEnc(codes.astype(np.int32),
                                              pool=pool))
        out.append(ColumnBatch(b.table_id, b.schema, cols))
    return out


def checksum_placement(pg: FakePG, ch: FakeCH, dev) -> dict:
    src = PGStorage(PGSourceParams(host="127.0.0.1", port=pg.port,
                                   database="db", user="u"))
    dst = CHStorage(CHSourceParams(host="127.0.0.1", port=ch.port))
    combos = CHECKSUM_RUNS[dev.type]
    try:
        clean = checksum_runs(src, dst, dev, combos["clean"],
                              traced=dev.type == "cuda")
        row = next(r for r in ch.tables["public__hits"]["rows"]
                   if r["id"] == CHECKSUM_TAMPERED_ID)
        original, row["url"] = row["url"], b"https://e.test/tampered"
        try:
            tampered = checksum_runs(src, dst, dev, combos["tampered"])
        finally:
            row["url"] = original
        # a dictionary-encoded copy against its flat rows
        flat = []
        src.load_table(TableDescription(id=TableID("public", "hits")),
                       flat.append)
        seed_source("chip-checksum-dict", checksum_dict_source(flat))
        seed_source("chip-checksum-flat", flat)
        dict_runs = checksum_runs(
            MemoryStorage(MemorySourceParams(source_id="chip-checksum-dict")),
            MemoryStorage(MemorySourceParams(source_id="chip-checksum-flat")),
            dev, combos["dict"])
    finally:
        src.close()
        dst.close()
    held = sum(check_dispatched(r, dev) for r in (clean, tampered,
                                                   dict_runs))
    return dict(clean=clean, tampered=tampered, dict=dict_runs,
                k10_held_exact=held)


def checksum_path(dev) -> dict:
    """The checksum task over config #2's table: the pg2ch rows
    transferred by activate_delivery without the filter (a checksum
    compares whole tables), then checksum(PGStorage, CHStorage) by
    fingerprint with fingerprint_backend "device" (K10 on the card),
    "host" (the host library's lanes) and "auto" (the measured choice,
    printed), and by compare, on the card; with device="cpu" the
    "device" backend (CHECKSUM_RUNS).  Each run reports ok and the
    device, host and auto digests are equal; with one
    ClickHouse value altered (id CHECKSUM_TAMPERED_ID, inside the
    top/bottom sample) every method reports the table failed and the
    row-level pass names the key.  A dictionary-encoded copy against its
    flat rows launches trt_var_accumulators for the pool."""
    t0 = time.perf_counter()
    pg, ch = FakePG().start(), FakeCH().start()
    try:
        pg.add_table(hits_table())
        gen_s = time.perf_counter() - t0
        transfer = Transfer(
            id="chip-checksum", src=PGSourceParams(
                host="127.0.0.1", port=pg.port, database="db", user="u"),
            dst=CHTargetParams(host="127.0.0.1", port=ch.port,
                               bufferer=None))
        t1 = time.perf_counter()
        activate_delivery(transfer, MemoryCoordinator(), device=dev)
        act_s = time.perf_counter() - t1
        runs = {"device": checksum_placement(pg, ch, dev),
                "cpu": checksum_placement(pg, ch, torch.device("cpu"))}
    finally:
        pg.stop()
        ch.stop()
    key = f"row ({CHECKSUM_TAMPERED_ID},)"
    for name, run in runs.items():
        for part in ("clean", "tampered", "dict"):
            for method, r in run[part].items():
                (t,) = r["tables"]
                if r["ok"] != (part != "tampered"):
                    raise AssertionError(f"checksum {name} {part} {method}: "
                                         f"ok {r['ok']}: {t}")
                # a fingerprint decides alone when the digests agree, and
                # differs (then the row-level pass) when a value does
                fp = method.startswith("fingerprint")
                digests = (t["source_fingerprint"], t["target_fingerprint"])
                if fp and (not all(digests) or (
                        part == "tampered") == (digests[0] == digests[1])
                        or t["strategy"].startswith("fingerprint+")
                        != (part == "tampered")):
                    raise AssertionError(f"checksum {name} {part} {method}: "
                                         f"strategy {t['strategy']}, "
                                         f"digests {digests}")
                if part == "tampered" and not any(
                        m.startswith(key) for m in t["mismatches"]):
                    raise AssertionError(f"checksum {name} {method}: the "
                                         f"row-level pass names no {key}: "
                                         f"{t['mismatches']}")
            fp = [r["tables"][0] for m, r in run[part].items()
                  if m.startswith("fingerprint")]
            if len({(t["source_fingerprint"], t["target_fingerprint"])
                    for t in fp}) != 1:
                raise AssertionError(f"checksum {name} {part}: device, host "
                                     f"and auto digests differ: {fp}")
        for part in ("clean", "tampered", "dict"):
            host = run[part].get("fingerprint_host", {}).get("launches", {})
            if any(host.values()):
                raise AssertionError(f"checksum {name} {part}: the host "
                                     f"lanes launched {host}")
    dev_runs = runs["device"]
    if dev_runs["clean"]["fingerprint_device"]["tables"][0][
            "source_fingerprint"] != runs["cpu"]["clean"][
            "fingerprint_device"]["tables"][0]["source_fingerprint"]:
        raise AssertionError("checksum: the card's digest differs from the "
                             "plain version's on the CPU")
    launches = {k: sum(r["launches"][k] for part in ("clean", "tampered",
                                                       "dict")
                       for r in dev_runs[part].values())
                for k in _build.KERNELS}
    dispatched_held = dev_runs["k10_held_exact"]
    k10_fp = sum(r["launches"]["rowhash_lanes"]
                 for part in ("clean", "tampered", "dict")
                 for m, r in dev_runs[part].items() if m.startswith("fing"))
    if dispatched_held != k10_fp:
        raise AssertionError(f"checksum: {dispatched_held} fingerprint "
                             f"launches held of {k10_fp}")
    require_launched("checksum", launches)
    return dict(
        rows=PG2CH_ROWS, data_gen_seconds=gen_s, activation_seconds=act_s,
        launches=launches, runs={
            name: {part: {m: {k: v for k, v in r.items()}
                          for m, r in run[part].items()}
                   for part in ("clean", "tampered", "dict")}
            | {"k10_held_exact": run["k10_held_exact"]}
            for name, run in runs.items()},
        fingerprints_equal="device, host and auto; the card and the CPU")


def my2kf_run(my: FakeMySQL, rows: int, placement: str, dev,
              traced: bool = False) -> dict:
    """One activation of config #4 into a fresh fake Kafka on a fresh
    memory coordinator, the placement pinned; the staged pushes' keys
    and the Kafka requests are recorded on the way.  `traced` turns the
    trace and the stage timer on for the activation and adds its stage
    tables to the result."""
    kf = FakeKafka(n_partitions=MY2KF_PARTITIONS).start()
    tid = "chip-my2kf"
    transfer = Transfer(
        id=tid, src=MySQLSourceParams(host="127.0.0.1", port=my.port,
                                      database="db", user="root"),
        dst=KafkaTargetParams(brokers=[f"127.0.0.1:{kf.port}"],
                              topic="cdc", serializer="debezium"),
        transformation=MY2KF_CONFIG)
    cp = MemoryCoordinator()
    keyed, row_keys = [], staging._row_keys
    requests, roundtrip = [], kafka_client.KafkaClient._roundtrip

    def keep_keys(batch, device):
        keys = row_keys(batch, device)
        keyed.append((batch, keys))
        return keys

    def count_request(self, api_key, api_version, body, *args, **kw):
        requests.append((api_key, len(body)))
        return roundtrip(self, api_key, api_version, body, *args, **kw)

    staging._row_keys = keep_keys
    kafka_client.KafkaClient._roundtrip = count_request
    set_placement(placement)
    if traced:
        trace_on()
    try:
        _build.reset_launch_counts()
        t0 = time.perf_counter()
        activate_delivery(transfer, cp, device=dev)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        launches = _build.launch_counts()
        tables = trace_off(seconds) if traced else {}
        offsets = sum(len(p) for p in kf.topics.get("cdc", []))
        live = kf.live_size("cdc")
        superseded = sum(1 for p in kf.topics.get("cdc", [])
                         for seg in p._segments
                         if seg[2] is None and seg[3] == [])
        records = [[(r.key, r.value) for r in kf.records("cdc", i)]
                   for i in range(MY2KF_PARTITIONS)]
        txns = {k: v["epoch"] for k, v in kf.txns.items()}
    finally:
        trace.enable(False)
        stagetimer.enable(False)
        staging._row_keys = row_keys
        kafka_client.KafkaClient._roundtrip = roundtrip
        set_placement(None)
        kf.stop()
    checked = 0
    for batch, keys in keyed:
        if keys is None:
            continue
        if not is_columnar(batch):
            batch = ColumnBatch.from_rows(batch)
        if not np.array_equal(keys, plain_keys(batch, dev)):
            raise AssertionError(f"my2kf {placement}: K10's keys of staged "
                                 f"push {checked} ({batch.n_rows} rows) "
                                 f"differ from the plain version")
        checked += 1
    parts = cp.operation_parts(f"op-{tid}")
    produce = [n for api, n in requests if api == kafka_client.API_PRODUCE]
    return dict(records=records, seconds=seconds, launches=launches,
                rows_per_s=rows / seconds, offsets=offsets,
                live_size=live, superseded_segments=superseded,
                parts=len(parts), part_keys=[p.key() for p in parts],
                committed=all(p.completed for p in parts),
                txns=txns, keys_checked=checked,
                init_producer_calls=sum(
                    1 for api, _ in requests
                    if api == kafka_client.API_INIT_PRODUCER_ID),
                txn_produce_calls=len(produce),
                txn_request_bytes=produce,
                status=cp.get_status(tid).value,
                snapshot_position=cp.get_transfer_state(tid)
                .get("snapshot_position"), **tables)


def my2kf_check_content(records: list, rows: int) -> dict:
    """Every record decoded by the debezium parser: ids and regions the
    generator's, each email the host mask route's HMAC of the
    generator's address, each record in crc32c(key) % 16 (the pure
    CRC32C)."""
    parser = make_parser({"debezium": {}})
    ids, emails, regions = [], [], []
    for p, recs in enumerate(records):
        for key, _ in recs:
            if protocol.crc32c_py(key) % MY2KF_PARTITIONS != p:
                raise AssertionError(f"my2kf: a record of partition {p} "
                                     f"hashes elsewhere: {key[:80]!r}")
        res = parser.do_batch([Message(value=v, key=k, topic="cdc",
                                       partition=p, offset=i)
                               for i, (k, v) in enumerate(recs)])
        if res.unparsed is not None:
            raise AssertionError(f"my2kf: {res.unparsed.n_rows} records "
                                 f"of partition {p} did not parse")
        for b in res.batches:
            ids.extend(b.column("id").to_pylist())
            emails.extend(b.column("email").to_pylist())
            regions.extend(b.column("region").to_pylist())
    order = np.argsort(np.asarray(ids, dtype=np.int64), kind="stable")
    ids = np.asarray(ids, dtype=np.int64)[order]
    if not np.array_equal(ids, np.arange(rows)):
        raise AssertionError(f"my2kf: {len(ids)} decoded ids are not "
                             f"0..{rows - 1}")
    if not np.array_equal(np.asarray(regions, dtype=np.int64)[order],
                          np.arange(rows) % 500):
        raise AssertionError("my2kf: decoded regions differ from i % 500")
    src = [f"user{i}@example.test".encode() for i in range(rows)]
    data = np.frombuffer(b"".join(src), dtype=np.uint8)
    offs = _offsets_from_lengths([len(b) for b in src])
    hex_data, hex_offs = mask_plugin._host_hmac_hex(MY2KF_SALT, data, offs,
                                                    None)
    want = bytes(hex_data).decode()
    got = [emails[i] for i in order]
    if any(e != want[64 * i:64 * i + 64] for i, e in enumerate(got)) or \
            len(hex_offs) != rows + 1:
        raise AssertionError("my2kf: decoded emails differ from the host "
                             "mask route's HMAC-SHA256 hex")
    return dict(decoded=len(ids), records_a_partition=[
        len(r) for r in records])


def my2kf_path(dev, rows: int = MY2KF_ROWS, traced: bool = False) -> dict:
    """BASELINE config #4 end to end, bench.py measure_mysql2kafka's
    shape through activate_delivery: the port's fake MySQL (`rows` rows,
    keyset paging), mask_field email (K-A on the card, one launch a fused
    chunk), Debezium envelopes, the port's fake Kafka with 16 partitions
    and staged commits (one InitProducerId and one transactional
    produce a part, the dedup window keying each staged push with K10);
    device and host placement.  Both runs land every row once, their
    records are identical once ts_ms is set aside, every record decodes
    to the generator's row with the host mask's HMAC, lands in
    crc32c(key) % 16, and K10's keys of each staged push equal the
    plain version's."""
    t0 = time.perf_counter()
    my = FakeMySQL().start()
    try:
        my.add_table(FakeMyTable(
            "db", "users", MY2KF_COLUMNS,
            [{"id": i, "email": f"user{i}@example.test", "region": i % 500}
             for i in range(rows)]))
        gen_s = time.perf_counter() - t0
        runs = {p: my2kf_run(my, rows, p, dev, traced)
                for p in ("device", "host")}
    finally:
        my.stop()
    for name, run in runs.items():
        want_txns = {f"trtpu.{staging.part_slug(k)}" for k in
                     run["part_keys"]}
        if run["offsets"] != rows or run["live_size"] != rows \
                or run["status"] != "activated" or not run["committed"] \
                or run["superseded_segments"] or not run["parts"] \
                or set(run["txns"]) != want_txns \
                or run["init_producer_calls"] != run["parts"] \
                or run["txn_produce_calls"] != run["parts"]:
            raise AssertionError(
                f"my2kf {name}: {run['offsets']} offsets, "
                f"{run['live_size']} live of {rows}, status "
                f"{run['status']}, {run['parts']} parts, txns "
                f"{run['txns']}, {run['init_producer_calls']} "
                f"InitProducerId, {run['txn_produce_calls']} produces, "
                f"{run['superseded_segments']} superseded")
        if run["snapshot_position"] is None:
            raise AssertionError(f"my2kf {name}: no snapshot_position")
        if run["keys_checked"] != run["launches"].get("rowhash_lanes"):
            raise AssertionError(
                f"my2kf {name}: {run['keys_checked']} staged pushes' keys "
                f"held against the plain version, "
                f"{run['launches'].get('rowhash_lanes')} K10 launches")
    dev_run, host_run = runs["device"], runs["host"]
    # K-A on the card only; K10 on both, as often
    dev_got = {k: c for k, c in dev_run["launches"].items() if c}
    host_got = {k: c for k, c in host_run["launches"].items() if c}
    if set(dev_got) != set(PATH_KERNELS["my2kf"]) or \
            host_got != {"rowhash_lanes": dev_got["rowhash_lanes"]}:
        raise AssertionError(f"my2kf: launched {dev_got} on the card, "
                             f"{host_got} on the host")
    for p in range(MY2KF_PARTITIONS):
        a, b = dev_run["records"][p], host_run["records"][p]
        if len(a) != len(b) or any(
                ka != kb or TS_MS.sub(b"", va) != TS_MS.sub(b"", vb)
                for (ka, va), (kb, vb) in zip(a, b)):
            raise AssertionError(f"my2kf: partition {p} differs between "
                                 f"the placements (ts_ms set aside)")
    t_check = time.perf_counter()
    content = my2kf_check_content(dev_run["records"], rows)
    check_s = time.perf_counter() - t_check
    launches = dict(dev_run["launches"])
    require_launched("my2kf", launches)
    return dict(
        rows=rows, partitions=MY2KF_PARTITIONS, data_gen_seconds=gen_s,
        content_check_seconds=check_s, launches=launches, **content,
        runs={placement: {k: v for k, v in run.items() if k != "records"}
              for placement, run in runs.items()},
        identical_across_placements="ts_ms set aside",
        emails_equal_to="the host mask route's HMAC-SHA256 hex")


# -- the CDC tails -------------------------------------------------------------

class KALaunches:
    """Records each K-A launch on the card (its inputs and output, cloned
    on the card) while a path runs, so that every launch can be held
    against K-A's plain version afterwards."""

    def __enter__(self):
        self.calls = []
        self._fn = fn = sha256_mod.sha256_hmac
        rec = self

        def recorded(blocks, n_blocks, init, outer, max_blocks):
            out = fn(blocks, n_blocks, init, outer, max_blocks)
            if blocks.is_cuda and blocks.shape[0]:
                rec.calls.append((
                    blocks.clone(), n_blocks.clone(), init.clone(),
                    None if outer is None else outer.clone(), max_blocks,
                    out.clone()))
            return out

        sha256_mod.sha256_hmac = recorded
        return self

    def __exit__(self, *exc):
        sha256_mod.sha256_hmac = self._fn
        return False

    def check(self, what: str, launches: int) -> int:
        """Every recorded launch exact against the plain version, and as
        many as the path counted.  Launches that share their states and
        block count go through one plain call over their rows together
        (rows are independent), and each launch's rows are compared."""
        if len(self.calls) != launches:
            raise AssertionError(f"{what}: {len(self.calls)} K-A launches "
                                 f"recorded, {launches} counted")
        groups: dict = {}
        for i, (_, _, init, outer, mb, _) in enumerate(self.calls):
            key = (mb, tuple(init.tolist()),
                   None if outer is None else tuple(outer.tolist()))
            groups.setdefault(key, []).append(i)
        for (mb, _, _), idx in groups.items():
            calls = [self.calls[i] for i in idx]
            want = sha256_hmac_plain(
                torch.cat([c[0] for c in calls]),
                torch.cat([c[1] for c in calls]), calls[0][2], calls[0][3],
                mb)
            lo = 0
            for i, c in zip(idx, calls):
                n = c[0].shape[0]
                require_equal(c[5], want[lo:lo + n],
                              f"{what}: K-A launch {i} ({n} rows)")
                lo += n
        self.calls = []
        return launches


def cdc_run(name: str, transfer, cp, placement: str, dev, landed,
            settled) -> dict:
    """One INCREMENT_ONLY transfer through run_replication on a thread,
    the placement pinned, traced with the stage timer on: timed from the
    start until `landed()`, then run on until `settled()` (the source's
    last checkpoint), then stopped through its stop event.  Returns the
    readings with the run's stage tables; each K-A launch on the card
    is recorded and held against the plain version after the run."""
    metrics, stop, failure = Metrics(), threading.Event(), []
    stagetimer.collect_samples("transform")
    trace_on()
    set_placement(placement)

    def run():
        try:
            run_replication(transfer, cp, metrics=metrics, stop_event=stop,
                            backoff=0.2, device=dev)
        except BaseException as e:  # surfaced below
            failure.append(e)

    def wait(cond, deadline, what):
        while not cond() and not failure:
            if time.monotonic() > deadline:
                raise AssertionError(f"{name} {placement}: {what}")
            time.sleep(0.01)

    th = threading.Thread(target=run, daemon=True)
    try:
        with KALaunches() as ka:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            th.start()
            deadline = time.monotonic() + CDC_SETTLE_S
            wait(landed, deadline, "the rows did not land")
            t_done = time.perf_counter()
            wait(settled, deadline, "the checkpoint did not settle")
            _sync(dev)
            launches = _build.launch_counts()
    finally:
        stop.set()
        th.join(30)
        wall = time.perf_counter() - t0
        set_placement(None)
        trace.enable(False)
        stagetimer.enable(False)
    if failure:
        raise AssertionError(f"{name} {placement} failed: {failure[0]!r}")
    if th.is_alive():
        raise AssertionError(f"{name} {placement}: the loop did not stop")
    tables = trace_off(wall)
    t_check = time.perf_counter()
    held = ka.check(f"{name} {placement}", launches["sha256_hmac"])
    lat = sorted(stagetimer.samples("transform"))
    steady = lat[:max(1, len(lat) - 1)] if len(lat) > 4 else lat
    return dict(
        seconds=t_done - t0, launches=launches,
        transform_p50_ms=percentile(steady, 0.50) * 1000 if lat else None,
        transform_p99_ms=percentile(steady, 0.99) * 1000 if lat else None,
        transform_batches=len(lat), transform_seconds=sum(lat),
        ka_launches_held_exact=held,
        ka_check_seconds=time.perf_counter() - t_check,
        restarts=metrics.value("replication_restarts"),
        transfer_state=cp.get_transfer_state(transfer.id), wall_seconds=wall,
        **tables)


def cdc_changes() -> list:
    """The binlog's 100,000 changes of seed 17."""
    return cdc.users_changes(CDC_INSERTS, CDC_UPDATES, CDC_DELETES,
                             seed=CDC_SEED)


def cdc_source(changes: list) -> tuple:
    """A fake MySQL whose binlog holds `changes` in GTID transactions of
    100, and the executed set they make."""
    if [c[:3] for c in MY2KF_COLUMNS] != [c[:3] for c in cdc.USERS_COLUMNS]:
        raise AssertionError("the CDC table is not bench.py's")
    my = FakeMySQL().start()
    my.add_table(FakeMyTable("db", "users", MY2KF_COLUMNS))
    last = cdc.feed_users_binlog(my, changes, txn_changes=CDC_TXN)
    return my, f"{cdc.USERS_SID}:1-{last}"


def binlog_state_ok(run: dict, my: FakeMySQL, fed: str) -> bool:
    state = run["transfer_state"].get("mysql_binlog", {})
    return state == {"file": "binlog.000001", "pos": my._next_log_pos,
                     "gtid_set": fed}


def masked_hex(email: Optional[str]) -> Optional[str]:
    if email is None:
        return None
    return hmac.new(MY2KF_SALT, email.encode(), hashlib.sha256).hexdigest()


def my2kf_cdc_run(my: FakeMySQL, fed: str, n: int, placement: str,
                  dev) -> dict:
    kf = FakeKafka(n_partitions=MY2KF_PARTITIONS).start()
    tid = f"chip-my2kf-cdc-{placement}"
    transfer = Transfer(
        id=tid, type=TransferType.INCREMENT_ONLY,
        src=MySQLSourceParams(host="127.0.0.1", port=my.port,
                              database="db", user="root"),
        dst=KafkaTargetParams(brokers=[f"127.0.0.1:{kf.port}"],
                              topic="cdc", serializer="debezium"),
        transformation=MY2KF_CONFIG)
    cp = MemoryCoordinator()
    try:
        run = cdc_run(
            "my2kf_cdc", transfer, cp, placement, dev,
            landed=lambda: kf.live_size("cdc") >= n,
            settled=lambda: cp.get_transfer_state(tid).get(
                "mysql_binlog", {}).get("gtid_set") == fed)
        run["live_size"] = kf.live_size("cdc")
        run["offsets"] = sum(len(p) for p in kf.topics.get("cdc", []))
        run["records"] = [[(r.key, r.value) for r in kf.records("cdc", i)]
                          for i in range(MY2KF_PARTITIONS)]
    finally:
        kf.stop()
    run["rows_per_s"] = n / run["seconds"]
    return run


def my2kf_cdc_check_content(records: list, changes: list) -> dict:
    """Every record decoded by the port's Debezium receiver: each key's
    records, in partition order, are its changes in binlog order (op,
    the after image with the mask's HMAC of the email, the before image's
    key), and each record lies in crc32c(key) % 16."""
    want: dict = {}
    for change in changes:
        want.setdefault(change[1], []).append(change)
    receiver, got, ops = DebeziumReceiver(), {}, {}
    for p, recs in enumerate(records):
        for key, value in recs:
            if protocol.crc32c_py(key) % MY2KF_PARTITIONS != p:
                raise AssertionError(f"my2kf_cdc: a record of partition {p} "
                                     f"hashes elsewhere: {key[:80]!r}")
            it = receiver.receive(value, key)
            got.setdefault(it.old_keys.as_dict().get("id")
                           if it.kind.value == "delete"
                           else it.value("id"), []).append(it)
    if sorted(got) != sorted(want):
        raise AssertionError(f"my2kf_cdc: {len(got)} keys decoded, "
                             f"{len(want)} changed")
    kinds = ("insert", "update", "delete")
    for i, items in got.items():
        if len(items) != len(want[i]):
            raise AssertionError(f"my2kf_cdc: id {i}: {len(items)} records "
                                 f"for {len(want[i])} changes")
        for it, (kind, _, region, _, after) in zip(items, want[i]):
            ops[kinds[kind]] = ops.get(kinds[kind], 0) + 1
            if it.kind.value != kinds[kind]:
                raise AssertionError(f"my2kf_cdc: id {i}: {it.kind.value} "
                                     f"for a {kinds[kind]}")
            if kind != cdc.DELETE and it.as_dict() != {
                    "id": i, "email": masked_hex(after), "region": region}:
                raise AssertionError(f"my2kf_cdc: id {i}: after image "
                                     f"{it.as_dict()}")
            if kind != cdc.INSERT and it.old_keys.as_dict() != {"id": i}:
                raise AssertionError(f"my2kf_cdc: id {i}: before image "
                                     f"{it.old_keys.as_dict()}")
    return dict(decoded=sum(ops.values()), ops=ops, keys=len(got))


def my2kf_cdc_path(dev) -> dict:
    """BASELINE config #4's CDC half: the binlog of 100,000 row changes
    tailed by the port's MySQLBinlogSource through run_replication
    (INCREMENT_ONLY), mask_field email (K-A on the card), Debezium
    envelopes, the 16-partition topic; device and host placement.  Each
    run lands every change once (100,000 records by offsets and
    live_size), checkpoints the fed executed set at the binlog's end,
    and the records are identical across the placements once ts_ms is
    set aside; every record decodes to its change (op, after, before)
    with the HMAC of the plain email, NULL staying NULL; each K-A launch
    equals the plain version on its inputs."""
    t0 = time.perf_counter()
    changes = cdc_changes()
    my, fed = cdc_source(changes)
    gen_s = time.perf_counter() - t0
    try:
        runs = {p: my2kf_cdc_run(my, fed, len(changes), p, dev)
                for p in ("device", "host")}
        for name, run in runs.items():
            if run["offsets"] != len(changes) or \
                    run["live_size"] != len(changes) or run["restarts"] \
                    or not binlog_state_ok(run, my, fed):
                raise AssertionError(
                    f"my2kf_cdc {name}: {run['offsets']} offsets, "
                    f"{run['live_size']} live of {len(changes)}, "
                    f"{run['restarts']} restarts, state "
                    f"{run['transfer_state']}, fed {fed}")
    finally:
        my.stop()
    dev_run, host_run = runs["device"], runs["host"]
    dev_got = {k: c for k, c in dev_run["launches"].items() if c}
    host_got = {k: c for k, c in host_run["launches"].items() if c}
    if set(dev_got) != set(PATH_KERNELS["my2kf_cdc"]) or host_got:
        raise AssertionError(f"my2kf_cdc: launched {dev_got} on the card, "
                             f"{host_got} on the host")
    for p in range(MY2KF_PARTITIONS):
        a, b = dev_run["records"][p], host_run["records"][p]
        if len(a) != len(b) or any(
                ka != kb or TS_MS.sub(b"", va) != TS_MS.sub(b"", vb)
                for (ka, va), (kb, vb) in zip(a, b)):
            raise AssertionError(f"my2kf_cdc: partition {p} differs "
                                 f"between the placements (ts_ms set aside)")
    t_check = time.perf_counter()
    content = my2kf_cdc_check_content(dev_run["records"], changes)
    check_s = time.perf_counter() - t_check
    launches = dict(dev_run["launches"])
    require_launched("my2kf_cdc", launches)
    return dict(
        changes=len(changes), inserts=CDC_INSERTS, updates=CDC_UPDATES,
        deletes=CDC_DELETES, transactions=len(changes) // CDC_TXN,
        binlog_events=len(my.binlog_events), fed_gtid_set=fed,
        partitions=MY2KF_PARTITIONS, data_gen_seconds=gen_s,
        content_check_seconds=check_s, launches=launches, **content,
        runs={placement: {k: v for k, v in run.items() if k != "records"}
              for placement, run in runs.items()},
        identical_across_placements="ts_ms set aside",
        emails_equal_to="hmac.new(salt, email, sha256).hexdigest()")


def pg2ch_cdc_run(pg: FakePG, last: int, expected: int, placement: str,
                  dev) -> dict:
    ch = FakeCH().start()
    tid = f"chip-pg2ch-cdc-{placement}"
    transfer = Transfer(
        id=tid, type=TransferType.INCREMENT_ONLY,
        src=PGSourceParams(host="127.0.0.1", port=pg.port, database="db",
                           user="u"),
        dst=CHTargetParams(host="127.0.0.1", port=ch.port, bufferer=None),
        transformation=PG2CH_CONFIG)
    cp = MemoryCoordinator()
    slot = f"transferia_{tid}".replace("-", "_")
    try:
        run = cdc_run(
            "pg2ch_cdc", transfer, cp, placement, dev,
            landed=lambda: ch.total_rows() >= expected,
            settled=lambda: cp.get_transfer_state(tid).get("pg_wal_lsn")
            == int_to_lsn(last))
        run["slot_created"] = slot in pg.slots
        get_provider("pg", transfer, device=dev).deactivate()
        run["slot_dropped"] = slot not in pg.slots
        run["rows_sorted"] = sorted(
            (r["id"], r["url"], r["region"], r["score"])
            for r in ch.rows("public__hits"))
    finally:
        ch.stop()
    run["rows_per_s"] = PG_CDC_ROWS / run["seconds"]
    return run


def pg2ch_cdc_path(dev) -> dict:
    """BASELINE config #2's CDC half: PG_CDC_ROWS wal2json v2 inserts of
    bench.py measure_pg2ch's rows, in transactions of 1,000, fed to the
    port's fake Postgres before the start and tailed by its
    PGReplicationSource through run_replication (INCREMENT_ONLY), the
    filter "region < 400 AND score >= 10" (on the host: a filter alone
    is not fused), the fake ClickHouse with no Bufferer; device and
    host placement.  The source creates its slot; ClickHouse's rows are
    numpy's kept rows, identical across placements; pg_wal_lsn is the
    last fed LSN; PostgresProvider.deactivate() drops the slot; nothing
    launches on the card."""
    t0 = time.perf_counter()
    pg = FakePG().start()
    try:
        last = cdc.feed_hits_wal(pg, PG_CDC_ROWS, txn_rows=PG_CDC_TXN)
        gen_s = time.perf_counter() - t0
        i = np.arange(PG_CDC_ROWS)
        keep = i[(i % 500 < 400) & ((i % 91) * 1.5 >= 10)]
        runs = {p: pg2ch_cdc_run(pg, last, len(keep), p, dev)
                for p in ("device", "host")}
    finally:
        pg.stop()
    # the fake ClickHouse keeps a String column's bytes
    want = [(i, url.encode(), region, score) for i, url, region, score
            in map(cdc.hits_row, keep.tolist())]
    for name, run in runs.items():
        if run["rows_sorted"] != want or not run["slot_created"] \
                or not run["slot_dropped"] or run["restarts"] or \
                run["transfer_state"] != {"pg_wal_lsn": int_to_lsn(last)}:
            raise AssertionError(
                f"pg2ch_cdc {name}: {len(run['rows_sorted'])} rows of "
                f"{len(want)} (equal: {run['rows_sorted'] == want}), slot "
                f"created {run['slot_created']} dropped "
                f"{run['slot_dropped']}, state {run['transfer_state']}, "
                f"last fed {int_to_lsn(last)}")
        if any(run["launches"].values()):
            raise AssertionError(f"pg2ch_cdc {name}: launched "
                                 f"{run['launches']}")
    launches = dict(runs["device"]["launches"])
    require_launched("pg2ch_cdc", launches)
    return dict(
        messages=PG_CDC_ROWS, transactions=PG_CDC_ROWS // PG_CDC_TXN,
        last_lsn=int_to_lsn(last), kept=len(want), data_gen_seconds=gen_s,
        launches=launches,
        runs={placement: {k: v for k, v in run.items()
                          if k != "rows_sorted"}
              for placement, run in runs.items()},
        identical_across_placements=True,
        rows_equal_to="numpy's kept ids, recipes.cdc.hits_row's values")


def my2my_cdc_run(my: FakeMySQL, fed: str, placement: str, dev) -> dict:
    dst = FakeMySQL().start()
    tid = f"chip-my2my-cdc-{placement}"
    transfer = Transfer(
        id=tid, type=TransferType.INCREMENT_ONLY,
        src=MySQLSourceParams(host="127.0.0.1", port=my.port,
                              database="db", user="root"),
        dst=MySQLTargetParams(host="127.0.0.1", port=dst.port,
                              database="db"),
        transformation=MY2KF_CONFIG)
    cp = MemoryCoordinator()

    def applied():
        return cp.get_transfer_state(tid).get(
            "mysql_binlog", {}).get("gtid_set") == fed

    try:
        run = cdc_run("my2my_cdc", transfer, cp, placement, dev,
                      landed=applied, settled=applied)
        with dst.lock:
            t = dst.tables.get(("db", "users"))
            run["table"] = {r["id"]: (r["email"], r["region"])
                            for r in (t.rows if t else [])}
            run["table_rows"] = len(t.rows) if t else 0
            run["statements"] = len(dst.queries)
    finally:
        dst.stop()
    run["rows_per_s"] = MY2MY_CHANGES / run["seconds"]
    return run


def my2my_cdc_path(dev) -> dict:
    """The MySQL target: the first 20,000 changes of my2kf_cdc's binlog
    tailed through run_replication, the same mask (K-A on the card), a
    MySQLSinker into a second fake MySQL (REPLACE, UPDATE and DELETE a
    row); device and host placement.  The target's db.users after each
    run is numpy's applied state (masked emails, updated rows, deleted
    ids gone), the checkpoint the fed executed set, and each K-A launch
    equals the plain version on its inputs."""
    t0 = time.perf_counter()
    changes = cdc_changes()[:MY2MY_CHANGES]
    my, fed = cdc_source(changes)
    gen_s = time.perf_counter() - t0
    try:
        runs = {p: my2my_cdc_run(my, fed, p, dev)
                for p in ("device", "host")}
        want = {str(i): (masked_hex(e), str(r))
                for i, (e, r) in cdc.users_final_state(changes).items()}
        for name, run in runs.items():
            if run["table"] != want or run["table_rows"] != len(want) \
                    or run["restarts"] or not binlog_state_ok(run, my, fed):
                raise AssertionError(
                    f"my2my_cdc {name}: {run['table_rows']} rows, "
                    f"{len(want)} wanted, equal {run['table'] == want}, "
                    f"state {run['transfer_state']}, fed {fed}")
    finally:
        my.stop()
    dev_got = {k: c for k, c in runs["device"]["launches"].items() if c}
    host_got = {k: c for k, c in runs["host"]["launches"].items() if c}
    if set(dev_got) != set(PATH_KERNELS["my2my_cdc"]) or host_got:
        raise AssertionError(f"my2my_cdc: launched {dev_got} on the card, "
                             f"{host_got} on the host")
    launches = dict(runs["device"]["launches"])
    require_launched("my2my_cdc", launches)
    kinds = [c[0] for c in changes]
    return dict(
        changes=len(changes), inserts=kinds.count(cdc.INSERT),
        updates=kinds.count(cdc.UPDATE), deletes=kinds.count(cdc.DELETE),
        target_rows=len(want), fed_gtid_set=fed, data_gen_seconds=gen_s,
        launches=launches,
        runs={placement: {k: v for k, v in run.items() if k != "table"}
              for placement, run in runs.items()},
        table_equal_to="the changes applied in numpy order, emails "
                       "hmac.new(salt, email, sha256).hexdigest()")


# -- phase 1b: the host library ----------------------------------------------

HOST_EDGE_LENS = (0, 1, 54, 55, 56, 57, 63, 64, 65, 119, 120, 300)


def cpu_flags() -> list:
    """The CPU features the host library dispatches on at run time
    (hostops.cpp: cpuid leaf 7 EBX bit 29, SHA-NI; leaf 1 ECX bit 20,
    SSE4.2), as /proc/cpuinfo names them; avx512f for the record."""
    with open("/proc/cpuinfo") as fh:
        for line in fh:
            if line.startswith("flags"):
                have = set(line.split(":", 1)[1].split())
                return sorted(have & {"sha_ni", "sse4_2", "avx512f"})
    return []


def snappy_route() -> str:
    """The snappy decoder parquetdec.cpp takes: it dlopens libsnappy.so.1
    and keeps its own decoder when that is absent."""
    try:
        ctypes.CDLL("libsnappy.so.1")
    except OSError:
        return "builtin"
    return "system libsnappy.so.1"


def mix32_np(x: np.ndarray) -> np.ndarray:
    """hostops.cpp mix32, in uint64 numpy masked to 32 bits."""
    x = x.astype(np.uint64)
    x ^= x >> np.uint64(16)
    x = (x * np.uint64(0x7FEB352D)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(15)
    x = (x * np.uint64(0x846CA68B)) & np.uint64(0xFFFFFFFF)
    x ^= x >> np.uint64(16)
    return x.astype(np.uint32)


def polyhash_py(values: list, pw: np.ndarray) -> list:
    """polyhash_varcol's spec: the row's SHA-padded block bytes (prefix
    0) against per-byte powers, mod 2**32."""
    out = []
    pw = [int(p) for p in pw]
    for v in values:
        nb = (len(v) + 9 + 63) // 64
        padded = bytearray(nb * 64)
        padded[:len(v)] = v
        padded[len(v)] = 0x80
        padded[-8:] = (len(v) * 8).to_bytes(8, "big")
        out.append(sum(b * pw[j] for j, b in enumerate(padded)) & 0xFFFFFFFF)
    return out


def zigzag_bytes(v: int) -> bytes:
    u = (v << 1) ^ (v >> 63)
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        out.append(b | (0x80 if u else 0))
        if not u:
            return bytes(out)


def require_same(got, want, what: str) -> None:
    if got != want:
        raise AssertionError(f"host library: {what} differs from its pure "
                             f"Python/numpy route")


def hostlib_path() -> dict:
    """Every bound entry point of the port's host library against the
    port's pure Python/numpy routes (or, where the port has no caller
    yet, a Python spec here), exactly, on the card's host CPU: its
    SHA-NI and SSE4.2 dispatch may take other branches than the CPU the
    tests run on."""
    t0 = time.perf_counter()
    lib = native.lib()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(61)
    values = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in HOST_EDGE_LENS] + [
        rng.integers(0, 256, int(rng.integers(0, 200)),
                     dtype=np.uint8).tobytes() for _ in range(2000)]
    data, offsets = _flat_bytes(values)
    n = len(values)
    checked = {}
    # Kafka wire: CRC32C, the record encoder and scanner
    for v in values[:200] + [b"123456789"]:
        require_same(protocol.crc32c(v), protocol.crc32c_py(v), "crc32c_buf")
    require_same(protocol.crc32c_batch(values).tolist(),
                 [protocol.crc32c_py(v) for v in values], "crc32c_batch")
    checked["crc32c_buf"] = checked["crc32c_batch"] = n
    recs = [Record(key=None if i % 7 == 3 else values[i][:20],
                   value=None if i % 11 == 5 else values[i],
                   timestamp_ms=1_700_000_000_000 + i % 9)
            for i in range(n)]
    now = 1_700_000_000_000
    require_same(protocol._encode_records_native(recs, now, now),
                 protocol.encode_records_py(recs, now, now),
                 "kafka_encode_records")
    blob = protocol.encode_record_batch(recs, base_offset=11)
    state = [(r.key, r.value, r.offset, r.timestamp_ms)
             for r in protocol.decode_record_batches(blob)]
    require_same(state, [(r.key, r.value, r.offset, r.timestamp_ms)
                         for r in protocol.decode_record_batches_py(blob)],
                 "kafka_scan_records")
    bad = bytearray(blob)
    bad[100] ^= 0x5A
    try:
        protocol.decode_record_batches(bytes(bad))
    except ValueError:
        pass
    else:
        raise AssertionError("kafka_scan_records: a corrupted batch passed")
    checked["kafka_encode_records"] = checked["kafka_scan_records"] = n
    # RowBinary: varints and the row scatter
    lens = np.diff(offsets).astype(np.uint64)
    got, plain = (rowbinary._encode_varints(lens),
                  rowbinary._encode_varints_plain(lens))
    require_same((got[0].tobytes(), got[1].tolist()),
                 (plain[0].tobytes(), plain[1].tolist()), "leb128_encode")
    src_off = offsets[:-1].astype(np.int64)
    row_lens = np.diff(offsets).astype(np.int64)
    dst_off = src_off + np.arange(n, dtype=np.int64) * 3
    out_native = np.zeros(int(dst_off[-1] + row_lens[-1]) + 1, np.uint8)
    out_plain = out_native.copy()
    lib.scatter_bytes(data, src_off, dst_off, row_lens, n, out_native)
    rowbinary._scatter_plain(data, src_off, dst_off, row_lens, out_plain)
    require_same(out_native.tobytes(), out_plain.tobytes(), "scatter_bytes")
    checked["leb128_encode"] = checked["scatter_bytes"] = n
    # the gathers under ColumnBatch.take/filter
    idx = rng.integers(0, n, 3 * n).astype(np.int64)
    got, plain = (_gather_varwidth(data, offsets, idx),
                  _gather_varwidth_plain(data, offsets, idx))
    require_same((got[0].tobytes(), got[1].tobytes()),
                 (plain[0].tobytes(), plain[1].tobytes()),
                 "gather_var_offsets/gather_var_bytes")
    one = (np.zeros(len(got[0]), np.uint8), np.zeros(len(idx) + 1, np.int32))
    lib.gather_varwidth(data, offsets, idx, len(idx), *one)
    require_same((one[0].tobytes(), one[1].tobytes()),
                 (plain[0].tobytes(), plain[1].tobytes()), "gather_varwidth")
    for dtype in (np.bool_, np.int8, np.int16, np.int32, np.int64,
                  np.float64):
        col = rng.integers(0, 100, n).astype(dtype)
        require_same(_gather_fixed(col, idx).tobytes(), col[idx].tobytes(),
                     f"gather_fixed {np.dtype(dtype).name}")
    for name in ("gather_var_offsets", "gather_var_bytes",
                 "gather_varwidth", "gather_fixed"):
        checked[name] = len(idx)
    # the fused step's pack and the host mask
    short = [v[:4 * 64 - 9] for v in values]
    sdata, soff = _flat_bytes(short)
    got, plain = (pack_hmac_blocks(sdata, soff, 4),
                  pack_hmac_blocks_plain(sdata, soff, 4))
    require_same((got[0].tobytes(), got[1].tobytes()),
                 (plain[0].tobytes(), plain[1].tobytes()), "pack_sha_blocks")
    checked["pack_sha_blocks"] = n
    validity = rng.random(n) < 0.9
    for key in (b"bench-salt", b"K" * 64, b"L" * 65, b""):
        for valid in (None, validity):
            got = mask_plugin._host_hmac_hex(key, data, offsets, valid)
            plain = mask_plugin._host_hmac_hex_py(key, data, offsets, valid)
            require_same((got[0].tobytes(), got[1].tobytes()),
                         (plain[0].tobytes(), plain[1].tobytes()),
                         "hmac_sha256_hex/sha256_block_state")
    checked["hmac_sha256_hex"] = checked["sha256_block_state"] = 8 * n
    # the fingerprint's host lanes (no caller in the port yet): Python specs
    width = 64 * ((300 + 9 + 63) // 64)
    pw1 = rng.integers(0, 2**32, width + 1, dtype=np.uint32)
    pw2 = rng.integers(0, 2**32, width + 1, dtype=np.uint32)
    a1, a2 = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
    lib.polyhash_varcol(data, offsets, n, pw1, pw2, a1, a2)
    require_same((a1.tolist(), a2.tolist()),
                 (polyhash_py(values, pw1), polyhash_py(values, pw2)),
                 "polyhash_varcol")
    lo, hi = (rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(2))
    s1, s2 = 0x9E3779B9, 0x7F4A7C15
    o1, o2 = np.zeros(n, np.uint32), np.zeros(n, np.uint32)
    lib.rowhash_mix_fixed(lo, hi, n, s1, s2, o1, o2)
    for out, s in ((o1, s1), (o2, s2)):
        want = mix32_np((mix32_np(lo ^ np.uint32(s)).astype(np.uint64)
                         + mix32_np(hi ^ np.uint32(~s & 0xFFFFFFFF)))
                        & np.uint64(0xFFFFFFFF))
        require_same(out.tolist(), want.tolist(), "rowhash_mix_fixed")
    lib.rowhash_mix_var(lo, hi, n, s1, s2, o1, o2)
    require_same((o1.tolist(), o2.tolist()),
                 (mix32_np(lo ^ np.uint32(s1)).tolist(),
                  mix32_np(hi ^ np.uint32(s2)).tolist()), "rowhash_mix_var")
    codes = rng.integers(0, n, n).astype(np.int32)
    lib.rowhash_dict_lanes(lo, hi, codes, n, s1, s2, o1, o2)
    require_same((o1.tolist(), o2.tolist()),
                 (mix32_np(lo[codes] ^ np.uint32(s1)).tolist(),
                  mix32_np(hi[codes] ^ np.uint32(s2)).tolist()),
                 "rowhash_dict_lanes")
    r1, r2 = o1.copy(), o2.copy()
    lib.rowhash_accum(lo, hi, n, r1, r2)
    require_same((r1.tolist(), r2.tolist()),
                 (((o1.astype(np.uint64) + mix32_np(lo))
                   & np.uint64(0xFFFFFFFF)).tolist(),
                  ((o2.astype(np.uint64) + mix32_np(hi))
                   & np.uint64(0xFFFFFFFF)).tolist()), "rowhash_accum")
    for name in ("polyhash_varcol", "rowhash_mix_fixed", "rowhash_mix_var",
                 "rowhash_dict_lanes", "rowhash_accum"):
        checked[name] = n
    # avro_decode_flat (its caller waits for the schema-registry slice):
    # long id, ["null", string] name, double score
    msgs, want = [], []
    for i in range(500):
        name = None if i % 4 == 0 else f"n-{i}".encode()
        body = zigzag_bytes(i * 1_000_003 - 7)
        body += zigzag_bytes(0) if name is None else (
            zigzag_bytes(1) + zigzag_bytes(len(name)) + name)
        msgs.append(body + struct.pack("<d", i * 1.5))
        want.append((i * 1_000_003 - 7, name, i * 1.5))
    mdata, moff = _flat_bytes(msgs)
    ids, score = np.zeros(500, np.int64), np.zeros(500, np.float64)
    sdata, soff = np.zeros(8192, np.uint8), np.zeros(501, np.int32)
    svalid = np.zeros(500, np.uint8)
    tasks = np.zeros((3, 6), dtype=np.int64)
    tasks[0, 0], tasks[2, 0] = ids.ctypes.data, score.ctypes.data
    tasks[1, 1:5] = [sdata.ctypes.data, soff.ctypes.data, 8192,
                     svalid.ctypes.data]
    rc = lib.avro_decode_flat(mdata, moff.astype(np.int64), 500,
                              np.array([2, 5, 4], np.uint8),
                              np.array([0, 1, 0], np.uint8),
                              np.array([0, 0, 0], np.uint8), 3, tasks)
    got = [(int(ids[i]), sdata[soff[i]:soff[i + 1]].tobytes()
            if svalid[i] else None, float(score[i])) for i in range(500)]
    require_same((rc, got), (500, want), "avro_decode_flat")
    checked["avro_decode_flat"] = 500
    codecs = {name: bool(lib.pq_codec_supported(code)) for name, code in
              (("UNCOMPRESSED", 0), ("SNAPPY", 1), ("GZIP", 2),
               ("ZSTD", 6))}
    if not (codecs["UNCOMPRESSED"] and codecs["SNAPPY"]):
        raise AssertionError(f"host library: codecs {codecs}")
    return dict(library=lib._name, build_or_load_seconds=build_s,
                cpu_flags=cpu_flags(), snappy=snappy_route(),
                pq_codec_supported=codecs, checked=checked,
                pq_entry_points="held in the clickbench phase's decode check",
                check="exact", phase_seconds=time.perf_counter() - t0)


# -- phase 15d: the ClickBench Parquet snapshot -------------------------------

def clickbench_predicted(fixed: dict, chunk: int) -> dict:
    """Launches of a device run: the scan keeps a row group's rows that
    pass the filter; the chain re-applies it to each kept batch in
    chunks of `chunk` rows, one K-A and K-C launch a chunk and one K-B
    launch for each of the two predicate columns."""
    keep = (fixed["RegionID"] < 400) & (fixed["ResolutionWidth"] >= 390)
    chunks = sum(-(-int(keep[lo:lo + BATCH_ROWS].sum()) // chunk)
                 for lo in range(0, len(keep), BATCH_ROWS))
    return {"sha256_hmac": chunks, "pred_decode": 2 * chunks,
            "pred3vl_mask": chunks}


def decoded_equals_generator(path: str, fixed: dict, var: dict) -> dict:
    """Row groups 0 and the last, as the port's reader decodes them,
    against the generator's columns, byte for byte."""
    meta = parquet_metadata(path)
    reader = NativeParquetReader(path, meta, meta.table_schema())
    out = {}
    for g in (0, meta.num_row_groups - 1):
        lo = g * BATCH_ROWS
        hi = lo + meta.row_groups[g].num_rows
        cols = reader.read_row_group(g)
        for name, arr in fixed.items():
            col = cols[name]
            if col.validity is not None and not col.validity.all():
                raise AssertionError(f"clickbench: {name} decoded nulls")
            if col.data.tobytes() != arr[lo:hi].tobytes():
                raise AssertionError(f"clickbench: row group {g} {name} "
                                     "differs from the generator")
        for name, (data, off) in var.items():
            col = cols[name]
            if col.data.tobytes() != data[off[lo]:off[hi]].tobytes() or \
                    col.offsets.tobytes() != (off[lo:hi + 1]
                                              - off[lo]).tobytes():
                raise AssertionError(f"clickbench: row group {g} {name} "
                                     "differs from the generator")
        out[g] = hi - lo
    return out


def clickbench_run(name: str, path: str, placement: str, workers: int,
                   dev, groups_per_part: int = 0) -> dict:
    """bench.py's run_pipeline: the fs Parquet source through the port's
    SnapshotLoader into the null sink, the placement pinned (or auto);
    `groups_per_part` > 0 overrides the source's row groups a part."""
    transfer = Transfer(
        id=f"chip-cb-{name}",
        src=FileSourceParams(path=path, format="parquet", table="hits",
                             batch_rows=BATCH_ROWS,
                             rowgroups_per_part=groups_per_part),
        dst=NullTargetParams(), transformation=CONFIG,
        runtime=Runtime(sharding=ShardingUploadParams(
            process_count=workers)))
    storages, storage = [], FileProvider.storage

    def capture(provider):
        st = storage(provider)
        storages.append(st)
        return st

    cp = MemoryCoordinator()
    op = f"op-chip-cb-{name}"
    FileProvider.storage = capture
    set_placement(None if placement == "auto" else placement)
    stagetimer.reset()
    stagetimer.enable(True)
    try:
        with StrategyCount() as strategies:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            SnapshotLoader(transfer, cp, operation_id=op,
                           device=dev).upload_tables()
            torch.cuda.synchronize(dev)
            seconds = time.perf_counter() - t0
            launches = _build.launch_counts()
    finally:
        stagetimer.enable(False)
        set_placement(None)
        FileProvider.storage = storage
    stages = stagetimer.snapshot()
    # the null sink stages nothing: a part commits when it completes
    parts = cp.operation_parts(op)
    if not parts or not all(p.completed and p.commit_epoch in (
            None, p.assignment_epoch) for p in parts):
        raise AssertionError(f"clickbench {name}: parts not all completed "
                             f"and committed: {parts}")
    return dict(seconds=seconds, rows_per_s=ROWS / seconds,
                completed_rows=cp.operation_progress(op).completed_rows,
                parts=len(parts), launches=launches,
                scan_rows_pruned=sum(s.scan_rows_pruned for s in storages),
                source_decode_seconds=stages.get(
                    "source_decode", {}).get("seconds", 0.0),
                pivot_seconds=stages.get("pivot", {}).get("seconds", 0.0),
                decode_wait_seconds=stages.get(
                    "decode_wait", {}).get("seconds", 0.0),
                fused_step_batches=strategies.batches)


def clickbench_path(schema, fixed, var, chunk: int, path: str,
                    dev) -> dict:
    """BASELINE config #3: bench.py's 2,000,000-row ClickBench file,
    written by the recipe writer, through bench.py's make_transfer shape
    (the fs source at 131,072-row batches, mask URL, the pushed-down
    filter, the null sink, min(4, effective CPUs) upload threads) in the
    device, host and auto placements after one warm-up run.  Each run
    must deliver exactly the rows numpy keeps (bench.py's completeness
    gate) and commit every part; the device run launches K-A, K-B and
    K-C, the host run nothing.  The file stays at `path` for the
    telemetry phase."""
    t0 = time.perf_counter()
    size, kept = write_clickbench(path, ROWS, (schema, fixed, var))
    write_s = time.perf_counter() - t0
    decoded = decoded_equals_generator(path, fixed, var)
    meta = parquet_metadata(path)
    workers = max(1, min(4, int(effective_cpus())))
    predicted = clickbench_predicted(fixed, chunk)
    emit({"phase": "clickbench_prediction", "device_launches": predicted,
          "kept": kept, "row_groups": meta.num_row_groups})
    runs = {}
    for name, placement in (("warmup", "device"), ("device", "device"),
                            ("host", "host"), ("auto", "auto")):
        run = clickbench_run(name, path, placement, workers, dev)
        if run["completed_rows"] != kept:
            raise AssertionError(
                f"clickbench {name}: row loss, the sink got "
                f"{run['completed_rows']} rows, the chain keeps {kept}")
        if run["completed_rows"] + run["scan_rows_pruned"] != ROWS:
            raise AssertionError(f"clickbench {name}: kept + pruned "
                                 f"!= {ROWS}")
        runs[name] = run
    launches = {k: c for k, c in runs["device"]["launches"].items()}
    require_launched("clickbench", launches)
    if any(runs["host"]["launches"].values()):
        raise AssertionError("clickbench host run launched "
                             f"{runs['host']['launches']}")
    for run in runs.values():
        run["launches"] = {k: c for k, c in run["launches"].items() if c}
    url_encodings = sorted({", ".join(rg.columns[7].encoding_names)
                            for rg in meta.row_groups})
    return dict(rows=ROWS, file_bytes=size, write_seconds=write_s,
                row_groups=meta.num_row_groups, batch_rows=BATCH_ROWS,
                upload_threads=workers, kept=kept,
                decoded_row_groups_equal_generator=decoded,
                dict_encoded_columns=dict_encoded_columns(
                    meta, ["URL", "Title", "SearchPhrase"]),
                url_chunk_encodings=url_encodings,
                predicted_device_launches=predicted,
                launches=launches, runs=runs, snappy=snappy_route(),
                cpu_flags=cpu_flags())


# -- phase 15f: the telemetry plane ------------------------------------------

TELEMETRY_DIR = Path(_build.BUILD_DIR) / "telemetry"
DEVICE_SPANS = ("fused_run", "pack", "device_decode", "device_dispatch",
                "device_wait")
WORKER_SPANS = ("decode_readahead", "source_decode",
                "native_rowgroup_decode")
REPL_SPANS = ("replication_attempt", "kafka_roundtrip", "source_decode",
              "transform", "sink_wait", "sink")


def trace_on() -> None:
    """Fresh trace, device counters, ledger, stage timer and staged-byte
    counts, then tracing and the stage timer on."""
    trace.reset()
    trace.TELEMETRY.reset()
    LEDGER.reset()
    stagetimer.reset()
    reset_dispatch_bytes()
    stagetimer.enable(True)
    trace.enable(True)


def trace_off(wall: float) -> dict:
    """Tracing and the stage timer off; the run's stage tables (the
    trace's per-span summary and the stage timer's breakdown, the text
    that bench.py prints) and the device counters."""
    trace.enable(False)
    stagetimer.enable(False)
    summary = trace.format_summary(wall)
    breakdown = stagetimer.format_breakdown(wall)
    print(summary, flush=True)
    print(breakdown, flush=True)
    return dict(stage_summary=trace.stage_summary(wall),
                stage_breakdown=breakdown,
                device_telemetry=trace.TELEMETRY.snapshot())


def span_index(spans) -> dict:
    """span id -> record, instants aside."""
    return {s[9]: s for s in spans if s[6] >= 0}


def ancestors(rec, by_id: dict) -> list:
    """Names of a span's ancestors, innermost first."""
    out, seen = [], set()
    while rec[10] in by_id and rec[10] not in seen:
        seen.add(rec[10])
        rec = by_id[rec[10]]
        out.append(rec[0])
    return out


def span_names(spans) -> dict:
    names: dict = {}
    for s in spans:
        if s[6] >= 0:
            names[s[0]] = names.get(s[0], 0) + 1
    return names


def check_card_nesting(spans, readahead: bool) -> dict:
    """part > batch > fused_run > {pack, device_dispatch, device_wait}
    on the card, and the decode spans under their part with parent links
    that resolve; with `readahead` (parts of several row groups) the
    decodes run on the readahead threads, under decode_readahead."""
    by_id = span_index(spans)
    names = span_names(spans)
    want = WORKER_SPANS if readahead else WORKER_SPANS[1:]
    for name in ("part", "batch", "fused_run", "pack", "device_dispatch",
                 "device_wait") + want:
        if not names.get(name):
            raise AssertionError(f"telemetry: no {name} span, {names}")
    for rec in by_id.values():
        up = ancestors(rec, by_id)
        if rec[0] == "fused_run" and not (
                "batch" in up and "part" in up
                and up.index("batch") < up.index("part")):
            raise AssertionError(f"telemetry: fused_run under {up}")
        if rec[0] in ("pack", "device_dispatch", "device_wait") and \
                up[:1] != ["fused_run"]:
            raise AssertionError(f"telemetry: {rec[0]} under {up}")
        if rec[0] in WORKER_SPANS and (rec[10] not in by_id
                                       or "part" not in up):
            raise AssertionError(f"telemetry: {rec[0]} on {rec[2]} with "
                                 f"an unresolved parent ({up})")
    threads = {s[2] for s in by_id.values() if s[0] in WORKER_SPANS}
    # a decode under decode_readahead ran on that part's readahead
    # thread, a hop from the part's upload thread
    hopped = [s for s in by_id.values() if s[0] == "native_rowgroup_decode"
              and "decode_readahead" in ancestors(s, by_id)]
    for s in hopped:
        part = s
        while part[0] != "part":
            part = by_id[part[10]]
        if s[2] != "decode-readahead" or s[1] == part[1]:
            raise AssertionError(f"telemetry: a readahead decode ran on "
                                 f"{s[2]}, its part on {part[2]}")
    if readahead and not hopped:
        raise AssertionError(f"telemetry: no decode ran on a readahead "
                             f"thread ({threads})")
    cross = sum(1 for s in by_id.values() if s[10] in by_id
                and by_id[s[10]][1] != s[1])
    return dict(spans=names, cross_thread_links=cross,
                decode_threads=sorted(threads), readahead_decodes=len(hopped))


def clickbench_traced(name: str, path: str, placement: str, workers: int,
                      kept: int, dev, spec: str = "",
                      groups_per_part: int = 0) -> dict:
    """clickbench_run with the trace, the stage timer and the ledger on
    (and `spec` armed); the rows it must deliver, the ledger's rows and
    conservation, the counters against the launches and staged bytes."""
    trace_on()
    if spec:
        failpoints.configure(spec, seed=0)
    try:
        run = clickbench_run(name, path, placement, workers, dev,
                             groups_per_part)
    finally:
        fires = failpoints.fire_counts()
        failpoints.reset()
        trace.enable(False)
    run.update(trace_off(run["seconds"]))
    spans = trace.spans()
    tel = run["device_telemetry"]
    staged = dispatch_bytes()
    ledger = LEDGER.snapshot()
    entry = ledger["transfers"][f"chip-cb-{name}"]
    # the scan pushes only the rows its filter keeps, which the chain's
    # filter keeps too: the rows in are the rows out (a retried part's
    # pruned rows count again in scan_rows_pruned, never in the ledger)
    source_rows = ROWS - run["scan_rows_pruned"]
    if run["completed_rows"] != kept or entry["rows_out"] != kept or \
            entry["rows_in"] != kept or (
                not entry["retries"] and source_rows != kept):
        raise AssertionError(
            f"telemetry {name}: delivered {run['completed_rows']}, ledger "
            f"rows in {entry['rows_in']} (source {source_rows}) out "
            f"{entry['rows_out']}, want {kept}")
    if not ledger["conservation"]["ok"]:
        raise AssertionError(f"telemetry {name}: ledger drift "
                             f"{ledger['conservation']}")
    ka = run["launches"].get("sha256_hmac", 0)
    if tel["device_launches"] != ka or entry["launches"] != ka:
        raise AssertionError(
            f"telemetry {name}: TELEMETRY launches "
            f"{tel['device_launches']}, ledger {entry['launches']}, K-A "
            f"launched {ka}")
    if tel["h2d_bytes"] != staged["encoded"]:
        raise AssertionError(f"telemetry {name}: h2d {tel['h2d_bytes']} "
                             f"bytes, staged {staged['encoded']}")
    names = span_names(spans)
    device_spans = {k: names[k] for k in DEVICE_SPANS if names.get(k)}
    if placement == "host":
        if device_spans or ka:
            raise AssertionError(f"telemetry host: device spans "
                                 f"{device_spans}, {ka} launches")
    else:
        if names.get("device_dispatch") != ka:
            raise AssertionError(f"telemetry {name}: "
                                 f"{names.get('device_dispatch')} "
                                 f"device_dispatch spans, {ka} launches")
        run["nesting"] = check_card_nesting(spans, groups_per_part > 1)
    run["ledger"] = {k: entry[k] for k in (
        "rows_in", "rows_out", "bytes_in", "launches", "h2d_bytes",
        "d2h_bytes", "kernel_seconds", "retries", "chaos_fires",
        "decode_wait_seconds")}
    run["staged_bytes"] = staged
    run["failpoint_fires"] = fires
    run["instants"] = sorted({s[0] for s in spans if s[6] < 0})
    return run


def transform_percentiles(spans) -> tuple:
    """The transform spans' p50/p99 in ms, over the samples the
    replication phase keeps (the largest dropped past four)."""
    lat = sorted(s[4] for s in spans if s[0] == "transform" and s[6] >= 0)
    steady = lat[:max(1, len(lat) - 1)] if len(lat) > 4 else lat
    return (percentile(steady, 0.50) * 1000,
            percentile(steady, 0.99) * 1000, len(lat))


def replication_traced(dev) -> dict:
    """Replication (a), bench.py's kafka2ch shape, on the card, traced."""
    broker = FakeKafka(n_partitions=REPL_PARTITIONS).start()
    try:
        broker.create_topic("events")
        produce(broker.port, REPL_PARTITIONS, REPL_MESSAGES, REPL_MESSAGES,
                k2ch_message)
        expected = sum(1 for _ in range(REPL_PARTITIONS)
                       for i in range(REPL_MESSAGES) if i % 500 < 400)
        trace_on()
        try:
            run = replication_run("bench", broker, REPL_SCHEMA,
                                  REPL_CONFIG, False, expected, "device",
                                  dev)
        finally:
            trace.enable(False)
    finally:
        broker.stop()
    run.pop("rows_sorted")
    run.update(trace_off(run["seconds"]))
    spans = trace.spans()
    names = span_names(spans)
    missing = [k for k in REPL_SPANS if not names.get(k)]
    if missing:
        raise AssertionError(f"telemetry replication: no {missing} span, "
                             f"{names}")
    by_id = span_index(spans)
    loose = [s[0] for s in by_id.values() if s[0] in (
        "source_decode", "sink_wait", "transform")
        and "replication_attempt" not in ancestors(s, by_id)]
    if loose:
        raise AssertionError(f"telemetry replication: {len(loose)} spans "
                             f"outside replication_attempt: {loose[:5]}")
    p50, p99, n = transform_percentiles(spans)
    if n != run["transform_batches"] or \
            abs(p50 - run["transform_p50_ms"]) > 0.05 * run[
                "transform_p50_ms"] or \
            abs(p99 - run["transform_p99_ms"]) > 0.05 * run[
                "transform_p99_ms"]:
        raise AssertionError(
            f"telemetry replication: transform spans p50/p99 {p50}/{p99} "
            f"ms over {n}, the stage timer {run['transform_p50_ms']}/"
            f"{run['transform_p99_ms']} over {run['transform_batches']}")
    run.update(span_transform_p50_ms=p50, span_transform_p99_ms=p99,
               spans=names)
    return run


def telemetry_path(path: str, kept: int, dev) -> dict:
    """Phase 15f: the telemetry plane over clickbench (device, host and
    the device run with device.dispatch armed once), replication (a) and
    my2kf, each traced; every check exact."""
    workers = max(1, min(4, int(effective_cpus())))
    launches = {k: 0 for k in _build.KERNELS}

    def add(counts):
        for k, c in counts.items():
            launches[k] += c

    device = clickbench_traced("tel-device", path, "device", workers,
                               kept, dev)
    TELEMETRY_DIR.mkdir(parents=True, exist_ok=True)
    trace_file = TELEMETRY_DIR / "clickbench_device.json"
    events = trace.write_chrome_trace(str(trace_file))
    with open(trace_file) as fh:
        loaded = len(json.load(fh)["traceEvents"])
    if loaded != events:
        raise AssertionError(f"telemetry: the Chrome trace holds {loaded} "
                             f"events, {events} written")
    add(device["launches"])
    # four parts of four row groups: each part's readahead thread
    # decodes, its spans parented across the thread hop
    readahead = clickbench_traced("tel-readahead", path, "device", workers,
                                  kept, dev, groups_per_part=4)
    add(readahead["launches"])
    host = clickbench_traced("tel-host", path, "host", workers, kept, dev)
    # the card's device.dispatch fires once, inside the chain, and the
    # snapshot stage's sink Retrier re-pushes the batch (both packages
    # compose the Retrier over the chain); snapshot.part.batch, armed
    # once too, fails a part before its first push: one part retry
    fault = clickbench_traced(
        "tel-fault", path, "device", workers, kept, dev,
        spec="device.dispatch=times:1;snapshot.part.batch=times:1")
    add(fault["launches"])
    if fault["failpoint_fires"] != {"device.dispatch": 1,
                                    "snapshot.part.batch": 1} or \
            fault["ledger"]["retries"] != 1 or \
            fault["ledger"]["chaos_fires"] != 2 or \
            fault["completed_rows"] != device["completed_rows"] or \
            fault["ledger"]["rows_out"] != device["ledger"]["rows_out"] \
            or fault["ledger"]["rows_in"] != device["ledger"]["rows_in"] \
            or "part_retry" not in fault["instants"]:
        raise AssertionError(
            f"telemetry fault: fires {fault['failpoint_fires']}, ledger "
            f"{fault['ledger']}, delivered {fault['completed_rows']} "
            f"(untraced-equal run {device['completed_rows']})")
    replication = replication_traced(dev)
    add(replication["launches"])
    my2kf = my2kf_path(dev, rows=TELEMETRY_MY2KF_ROWS, traced=True)
    add(my2kf["launches"])
    require_launched("telemetry", launches)
    return dict(kept=kept, upload_threads=workers, launches=launches,
                chrome_trace=str(trace_file.relative_to(
                    Path(__file__).resolve().parent)),
                chrome_trace_events=events,
                clickbench={"device": device, "host": host,
                            "device_readahead": readahead,
                            "device_fault_once": fault},
                replication_bench=replication, my2kf=my2kf)


# -- phase 7: timing ------------------------------------------------------------

def kernel_ms(fn, dev, iters: int = 20, reps: int = 5) -> float:
    """Median device time of one call: a sleep kernel holds the stream
    while the host enqueues `iters` calls, so the events bracket device
    work only."""
    fn()
    torch.cuda.synchronize(dev)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / iters)
    return statistics.median(samples)


def wall_ms(fn, dev, reps: int = 3) -> float:
    """Median event-timed wall of one call (plain versions: thousands of
    small launches, bound by the host's enqueue)."""
    fn()
    torch.cuda.synchronize(dev)
    samples = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end))
    return statistics.median(samples)


# Opcodes that do not issue on the ALU pipe (Nsight Compute's pipe
# descriptions: IMAD and IMUL run on the FMA pipe; loads, stores, atomics
# and shuffles on the LSU; branches and barriers elsewhere).  Whether IMAD
# does so on an H100 is not measured here, so each bound is also given
# with every instruction.
NOT_ALU = ("IMAD", "IMUL", "LDG", "LDS", "LDC", "STG", "STS", "ATOMS",
           "ATOMG", "ATOM", "RED", "SHFL", "BAR", "MEMBAR", "BRA", "BSSY",
           "BSYNC", "WARPSYNC", "EXIT", "NOP")
SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_text(lib_path) -> str:
    """`cuobjdump -sass` of one built library."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    return subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout


class Sass:
    """One kernel's SASS as (address, instruction) pairs, with its loops
    (backward branches) and counts of the instructions along paths."""

    def __init__(self, text: str, function: str):
        self.body, inside = [], False
        for line in text.splitlines():
            if "Function :" in line:
                inside = function in line
            elif inside:
                m = SASS_LINE.match(line)
                if m:
                    self.body.append((int(m.group(1), 16), m.group(2)))
        if not self.body:
            raise AssertionError(f"no SASS for {function}")
        self.index = {a: i for i, (a, _) in enumerate(self.body)}
        self.ops = [self.opcode(ins) for _, ins in self.body]
        # what runs when the warp stays converged: BRA.DIV's targets (the
        # compiler's slow paths for a diverged warp) are left out
        self.live, todo = set(), [0]
        while todo:
            i = todo.pop()
            if i in self.live or i >= len(self.body):
                continue
            self.live.add(i)
            todo.extend(self.successors(i, backward=True))

    @staticmethod
    def opcode(ins: str) -> str:
        return ins.split()[1] if ins.startswith("@") else ins.split()[0]

    def target(self, i: int) -> Optional[int]:
        m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", self.body[i][1])
        return None if m is None else self.index.get(int(m.group(1), 16))

    def successors(self, i: int, backward: bool = False) -> list[int]:
        """Where instruction i goes next (BRA.DIV falls through)."""
        op, ins = self.ops[i], self.body[i][1]
        cond = ins.startswith("@")
        base = op.split(".")[0]
        if base == "BRA" and not op.startswith("BRA.DIV"):
            t = self.target(i)
            jump = [t] if t is not None and (backward or t > i) else []
            return ([i + 1] if cond else []) + jump
        if base == "EXIT" and not cond:
            return []
        return [i + 1]

    def loops(self) -> list[tuple[int, int]]:
        """(first, last) instruction indices of every loop that runs
        while the warp stays converged."""
        out = []
        for i in sorted(self.live):
            t = self.target(i)
            if t is not None and t < i and \
                    not self.ops[i].startswith("BRA.DIV"):
                out.append((t, i))
        return out

    def innermost(self, *has, outside=None, inside=None,
                  without=()) -> tuple[int, int]:
        """The smallest loop holding, for each predicate of `has`, an
        instruction it accepts, none that a predicate of `without`
        accepts, and (if given) strictly the loop `outside`, or lying
        within the loop `inside`."""
        def holds(r, f):
            return any(f(self.body[i][1]) for i in range(r[0], r[1] + 1))

        def contains(big, small):
            return big[0] <= small[0] and small[1] <= big[1]
        found = [r for r in self.loops()
                 if all(holds(r, f) for f in has)
                 and not any(holds(r, f) for f in without)
                 and (outside is None or (contains(r, outside)
                                          and r != outside))
                 and (inside is None or contains(inside, r))]
        if not found:
            raise AssertionError("no such loop in the SASS")
        return min(found, key=lambda r: r[1] - r[0])

    def children(self, loop) -> list[tuple[int, int]]:
        inner = [r for r in self.loops() if loop[0] <= r[0] and
                 r[1] <= loop[1] and r != loop]
        return [r for r in inner if not any(
            o != r and o[0] <= r[0] and r[1] <= o[1] for o in inner)]

    def count(self, lo: int, hi: int, must=(), avoid=(), skip=(),
              alu_only: bool = False, best=min) -> int:
        """Instructions on the path from lo to hi (inclusive) with the
        fewest (best=max: the most), following forward edges only (each
        loop inside runs its body once), passing an instruction each
        `must` predicate accepts and none an `avoid` predicate accepts
        (predicates take the instruction's text); the loops in `skip`
        cost nothing and are passed over.  Predicated instructions count
        (they issue); NOPs do not, nor, with alu_only, NOT_ALU
        opcodes."""
        full = (1 << len(must)) - 1
        paths: dict[int, dict[int, int]] = {lo: {0: 0}}
        for i in range(lo, hi + 1):
            states = paths.pop(i, None)
            if not states:
                continue
            jump = next((b for a, b in skip if a <= i <= b), None)
            if jump is not None:
                nxt, cost, bits = [jump + 1], 0, 0
            else:
                ins = self.body[i][1]
                if any(f(ins) for f in avoid):
                    continue
                base = self.ops[i].split(".")[0]
                cost = 0 if base == "NOP" or (
                    alu_only and base in NOT_ALU) else 1
                bits = sum(1 << k for k, f in enumerate(must) if f(ins))
                nxt = self.successors(i)
            if i == hi:
                done = [c + cost for m, c in states.items()
                        if m | bits == full]
                if not done:
                    break
                return best(done)
            for j in nxt:
                if j > hi:
                    continue
                slot = paths.setdefault(j, {})
                for m, c in states.items():
                    key, val = m | bits, c + cost
                    slot[key] = best(slot.get(key, val), val)
        raise AssertionError(f"no path from {lo} to {hi} in the SASS")

    def alu(self, lo: int, hi: int, **kw) -> tuple[int, int]:
        """(ALU-pipe, every) instruction counts of `count`'s path."""
        return (self.count(lo, hi, alu_only=True, **kw),
                self.count(lo, hi, **kw))


def width_of(op: str) -> int:
    """A load's or store's width in bits from its opcode."""
    for w in ("128", "64"):
        if f".{w}" in op:
            return int(w)
    return 8 if (".U8" in op or ".S8" in op) else 32


def is_ldg(bits: int):
    """A global (LDG) or generic (LD) load of `bits` bits."""
    def has(ins: str) -> bool:
        op = Sass.opcode(ins)
        return op.startswith(("LDG", "LD.")) and width_of(op) == bits
    return has


def is_op(prefix: str):
    return lambda ins: Sass.opcode(ins).startswith(prefix)


def has_text(text: str):
    return lambda ins: text in ins


def has_imm(value: int):
    """An instruction with the 32-bit immediate `value` (SASS prints one
    at or past 2^31 as its negative)."""
    forms = (f"{value:#x}", f"-{(1 << 32) - value:#x}")
    return lambda ins: any(re.search(rf"{f}\b", ins) for f in forms)



def sass_per_compression(text: str) -> dict:
    """SASS instructions of one compression in K-A's block loop: the loop
    is the backward branch of sha256_hmac_kernel that spans the most
    instructions; each compression reads its 64-byte block as four
    16-byte loads, so the loop's instructions over its loads / 4 is one
    compression with its load, byte swap and loop control.  Raises where
    no such loop is found."""
    sass = Sass(text, "sha256_hmac_kernel")
    lo, hi = max(sass.loops(), key=lambda r: r[1] - r[0], default=(0, -1))
    loop = sass.ops[lo:hi + 1]
    loads = sum(1 for op in loop if op.startswith("LDG") and ".128" in op)
    if loads == 0 or loads % 4:
        raise AssertionError(
            f"no loop of 16-byte loads found in sha256_hmac_kernel's SASS "
            f"({len(sass.body)} instructions, {loads} loads)")
    ops = {}
    for op in loop:
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    alu = len(loop) - sum(ops.get(op, 0) for op in NOT_ALU)
    return dict(instructions_per_compression=len(loop) * 4 / loads,
                alu_per_compression=alu * 4 / loads,
                loop_instructions=len(loop), loop_loads_128=loads,
                kernel_instructions=len(sass.body), not_alu=list(NOT_ALU),
                by_opcode=dict(sorted(ops.items(), key=lambda x: -x[1])))


ROWHASH_SOURCE = (Path(_build.CSRC) / "rowhash.cu").read_text()
K10_BATCH = int(re.search(r"kBatch = (\d+);", ROWHASH_SOURCE).group(1))


def sass_rowhash(text: str) -> dict:
    """K10's lane instructions (ALU pipe, every instruction) from the
    kernels the wrapper launches (descriptors by value), each the fewest
    on its path, with global byte loads (null tests) left out:
    - per batch of K10_BATCH fixed or dict values: the longest path of
      its column loop (every slot live);
    - per row: the row loop, its inner loops passed over;
    - a var row: its var column loop's path through the length term of a
      row of at most 64 bytes (P^64 as an immediate), the inner loops
      passed over; per byte: the Horner loop's path over the byte loads
      it takes a pass;
    - var_accumulators alike, its entry loop (through the stores).
    A row over 64 bytes takes the same per-row count: its
    square-and-multiply is left out."""
    sass = Sass(text, "rowhash_lanes_kernelILb1E")
    mixed = has_text("0x7feb352d")
    bytes_ = (is_ldg(8),)
    fixed = sass.innermost(is_ldg(64), mixed)
    dict_loop = sass.innermost(mixed, is_ldg(32),
                               without=(is_ldg(64), has_text("0x1000193")))
    rows = max((r for r in sass.loops() if r[0] <= fixed[0] and
                fixed[1] <= r[1]), key=lambda r: r[1] - r[0])
    per = {
        "fixed_batch": sass.alu(*fixed, avoid=bytes_, best=max),
        "dict_batch": sass.alu(*dict_loop, avoid=bytes_, best=max),
        "row": sass.alu(*rows, skip=sass.children(rows)),
    }
    accs = Sass(text, "var_accumulators_kernel")
    length_term = has_imm(pow(rowhash._P1, 64, 1 << 32))
    for prefix, code in (("var", sass), ("entry", accs)):
        horner = code.innermost(is_ldg(8), has_text("0x1000193"))
        n_bytes = sum(is_ldg(8)(code.body[i][1])
                      for i in range(horner[0], horner[1] + 1))
        if prefix == "var":
            row_loop = code.innermost(mixed, outside=horner)
            must = (length_term,)
        else:
            row_loop = max(code.loops(), key=lambda r: r[1] - r[0])
            must = (length_term, is_op("STG"))
        per[f"{prefix}_row"] = code.alu(
            *row_loop, must=must, avoid=bytes_, skip=code.children(row_loop))
        per[f"{prefix}_byte"] = tuple(
            v / n_bytes for v in code.alu(*horner, must=(is_ldg(8),)))
    return {k: {"alu": a, "all": t} for k, (a, t) in per.items()}


def sass_ragged_pack(text: str) -> dict:
    """K12's instructions per 16 output bytes that hold row bytes: one
    thread's fewest on a path through a byte load and its 16-byte
    store."""
    sass = Sass(text, "ragged_pack_kernel")
    store = max(i for i, op in enumerate(sass.ops)
                if op.startswith("STG") and ".128" in op)
    end = next(i for i in range(store, len(sass.ops))
               if sass.ops[i].startswith("EXIT")
               and not sass.body[i][1].startswith("@"))
    alu, total = sass.alu(0, end, must=(is_ldg(8), is_op("STG.E.128")))
    return {"per_16_bytes": {"alu": alu, "all": total}}


MESH_UNROLL = int(re.search(
    r"kUnroll = (\d+);", (Path(_build.CSRC) / "mesh.cu").read_text()).group(1))


def sass_shard_hist(text: str, step_mode: bool,
                    unroll: int = MESH_UNROLL) -> dict:
    """The ballot-route histogram's warp instructions per 32-row step:
    the step loop's fewest (fused mode: on the packed path, through its
    shuffles), each inner loop run once (one digest column, one bin bit),
    over the `unroll` steps an iteration takes; and one more bin bit's
    (the smallest loop with a ballot)."""
    sass = Sass(text, f"shard_hist_kernelILb{int(step_mode)}ELb1E")
    bit = sass.innermost(is_op("VOTE"))
    step = max(sass.loops(), key=lambda r: r[1] - r[0])
    must = () if step_mode else (is_op("SHFL"),)
    alu, total = sass.alu(*step, must=must)
    b_alu, b_total = sass.alu(*bit)
    return {"per_step": {"alu": alu / unroll, "all": total / unroll},
            "per_extra_bin_bit": {"alu": b_alu, "all": b_total},
            "unroll": unroll}


def hist_ops(counts: dict, n: int, n_shards: int) -> dict:
    """Lane operations of one histogram launch over n rows and one digest
    column (32 lanes a warp instruction): each step's, with one more bin
    bit's for each bit of n_shards - 1 past the first."""
    steps = -(-n // 32)
    extra = max(max(n_shards - 1, 0).bit_length() - 1, 0)
    return {k: 32 * steps * (counts["per_step"][k]
                             + extra * counts["per_extra_bin_bit"][k])
            for k in ("alu", "all")}


def sass_pred3vl(text: str) -> dict:
    """K-C's thread instructions (ALU pipe, every instruction) in the
    kernel the main path launches (value tile, descriptors by value),
    each the fewest on its path:
    - entry: from the start through a 32-bit column load and the block
      barrier to the interpreter loop;
    - leaf: one pass of the interpreter loop through a load of the value
      tile (a comparison, IN or IS NULL), the IN scan passed over;
    - connective: one pass that loads nothing from the tile (AND, OR,
      NOT, TRUE);
    - in_literal: the IN literal scan's instructions over its literal
      loads;
    - exit: from the loop to the end through the store of the mask.
    Raises where no such loop or path is found."""
    sass = Sass(text, "pred3vl_mask_kernelILb1ELb1EE")
    bar = next(i for i, op in enumerate(sass.ops) if op.startswith("BAR"))
    loop = max((r for r in sass.loops() if r[0] > bar),
               key=lambda r: r[1] - r[0], default=None)
    if loop is None:
        raise AssertionError("no interpreter loop in K-C's SASS")
    kids = sass.children(loop)

    def loads(r):
        return sum(sass.ops[i].startswith("LD")
                   and width_of(sass.ops[i]) == 128
                   for i in range(r[0], r[1] + 1))
    # the scan reads whole 16-byte literals, four a pass
    scans = [r for r in kids if loads(r) > 1]
    if len(scans) != 1:
        raise AssertionError("K-C's IN scan not found in its SASS")
    tile = lambda ins: Sass.opcode(ins) == "LDS"  # noqa: E731
    end = max(i for i, op in enumerate(sass.ops) if op == "EXIT")
    per = {
        "entry": sass.alu(0, loop[0] - 1, must=(is_ldg(32), is_op("BAR"))),
        "leaf": sass.alu(*loop, must=(tile,), skip=kids),
        "connective": sass.alu(*loop, avoid=(tile, is_op("LDS.U8")),
                               skip=kids),
        "exit": sass.alu(loop[1] + 1, end, must=(is_op("STG"),)),
        "in_literal": tuple(v / loads(scans[0])
                            for v in sass.alu(*scans[0])),
    }
    return {k: {"alu": a, "all": t} for k, (a, t) in per.items()}


def program_words(program) -> list:
    """The program's instruction records as (word, y, z, w) of uint32."""
    return program.code[:program.n_instr].view(np.uint32).tolist()


def interpreter_ops(program, n: int, counts: dict) -> dict:
    """The lane instructions K-C's interpreter issues over n rows, a row a
    thread: every thread's entry and exit, a leaf or connective pass a
    program instruction and a scan step an IN literal (SASS counts from
    sass_pred3vl).  The cost of the design, reported beside the bound,
    not the bound: function_ops is what the predicate needs."""
    words = program_words(program)
    leaves = sum((w & 7) < OP_AND for w, *_ in words)
    in_lits = sum(z for w, _, z, _ in words if w & 7 == OP_IN)
    return {k: n * (counts["entry"][k] + counts["exit"][k]
                    + leaves * counts["leaf"][k]
                    + (len(words) - leaves) * counts["connective"][k]
                    + in_lits * counts["in_literal"][k])
            for k in ("alu", "all")}


def function_ops(program, slots: list, n: int) -> int:
    """The lane operations the predicate itself needs over n rows: a
    compare a comparison, one a literal of an IN list, one an IS NULL;
    two more a leaf whose column has validity (its TRUE and FALSE
    masks); a fold a connective or folded leaf, one where no row can be
    UNKNOWN (two-valued logic) and two on Kleene's (TRUE, FALSE) pairs
    (NOT a swap, free); a ballot a 32-row word.  No decode, dispatch,
    staging or address arithmetic."""
    words = program_words(program)
    kleene = any(
        (w & 7 in (OP_CMP, OP_IN, OP_ISNULL)
         and slots[w >> 12][1] is not None)
        or w & 7 == OP_CMP_NULL or (w & 7 == OP_IN and w & HAS_NULL)
        for w, *_ in words)
    per_row = 0
    for w, _, z, _ in words:
        op, fold = w & 7, (w >> 3) & 3
        if op in (OP_CMP, OP_ISNULL):
            per_row += 1
        elif op == OP_IN:
            per_row += z
        if op in (OP_CMP, OP_IN) and slots[w >> 12][1] is not None:
            per_row += 2
        if fold or op in (OP_AND, OP_OR):
            per_row += 2 if kleene else 1
        elif op == OP_NOT and not kleene:
            per_row += 1
    return n * per_row + n // 32


def sass_digest_gather(text: str) -> dict:
    """The gather's thread instructions on its longest path (every row of
    the warp's groups in range, every 16-byte store taken); a warp moves
    32 x kGatherGroups rows."""
    sass = Sass(text, "digest_gather_kernel")
    end = max(i for i, op in enumerate(sass.ops) if op == "EXIT")
    alu, total = sass.alu(0, end, must=(is_op("STG.E.128"),), best=max)
    groups = int(re.search(r"kGatherGroups = (\d+);", (
        Path(_build.CSRC) / "mesh.cu").read_text()).group(1))
    return {"per_thread": {"alu": alu, "all": total},
            "rows_per_warp": 32 * groups}


def sass_counts(builds: dict) -> dict:
    """Every SASS count the bounds use, from this run's build."""
    text = {name: sass_text(builds[name].path)
            for name in ("sha256_hmac", "rowhash", "raggedpack", "mesh",
                         "pred3vl_mask")}
    return {"sha256_hmac": sass_per_compression(text["sha256_hmac"]),
            "rowhash_lanes": sass_rowhash(text["rowhash"]),
            "ragged_pack": sass_ragged_pack(text["raggedpack"]),
            "shard_hist": sass_shard_hist(text["mesh"], False),
            "shard_hist_step": sass_shard_hist(text["mesh"], True),
            "pred3vl_mask": sass_pred3vl(text["pred3vl_mask"]),
            "digest_gather": sass_digest_gather(text["mesh"])}


def bound(n_bytes: float, n_ops: float = 0) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# the 70-literal OR of equalities (one IN list once lowered), and 70
# comparisons that no list can stand for (70 instructions)
OR70 = " OR ".join(f"RegionID = {i}" for i in range(70))
CMP70 = rare_cmps(("RegionID", "ResolutionWidth"), (0, 360), (499, 2560),
                  (1, 10))


def pred_call(text: str, cols: dict, n: int, counts: dict, dev) -> tuple:
    """K-C over n rows of `cols` (name -> (data, validity or None)),
    the keep mask packed, as the main path launches it, beside its plain
    version.  Bytes: each referenced column's data and validity read
    once, the program table read once, the packed mask written once.
    Operations: function_ops; the interpreter's SASS count
    (interpreter_ops) is reported beside them."""
    program = compile_mask_program(parse(text))
    slots = [cols[c] for c in program.columns]
    n_bytes = (sum(d[:n].numel() * d.element_size()
                   + (0 if v is None else n) for d, v in slots)
               + program.code.nbytes + n // 8)
    return (lambda: pred3vl_mask(program, slots, n, True, dev),
            lambda: pack_mask_words(eval3_torch(
                program.node, dict(zip(program.columns, slots)), n, dev), n),
            None, bound(n_bytes, function_ops(program, slots, n)),
            {"function_ops": function_ops(program, slots, n),
             "interpreter_ops": interpreter_ops(program, n, counts),
             "instructions": program.n_instr, "literals": program.n_lits})


def pred_timing(cols: dict, n: int, counts: dict, dev) -> dict:
    """K-C at the main path's bucket beside the main-path call: with a
    validity mask on both columns, with the 70-literal OR on RegionID
    and with 70 comparisons."""
    rng = np.random.default_rng(23)
    valid = {c: (d, torch.from_numpy(rng.random(d.numel()) > 0.1).to(dev))
             for c, (d, _) in cols.items()}
    text = "RegionID < 400 AND ResolutionWidth >= 390"
    return {
        "with_validity": timed(pred_call(text, valid, n, counts, dev), dev,
                               "pred3vl_mask with validity"),
        "or70": timed(pred_call(OR70, cols, n, counts, dev), dev,
                      "pred3vl_mask with the 70-literal OR"),
        "cmp70": timed(pred_call(CMP70, cols, n, counts, dev), dev,
                       "pred3vl_mask with 70 comparisons"),
    }


def hmac_call(col: Column, key: bytes, bucket: int, sass: dict,
              dev) -> tuple:
    """K-A over a flat column's rows padded to `bucket` rows, as
    ops/fused.py packs and pads a chunk (pad rows have no blocks).
    Bytes: the real rows' blocks, every row's count and digest, the key
    states; operations: every row compresses its own blocks and one
    outer block, at the ALU-pipe instructions a compression (every
    instruction: `bound_ms_all_instructions`)."""
    n = col.n_rows
    mb = pow2_blocks(int(np.diff(col.offsets).max()))
    blocks, nb = pack_hmac_blocks(col.data, col.offsets, mb)
    n_bytes = blocks.nbytes + 4 * bucket + 64 + 32 * bucket
    blocks = np.pad(blocks, ((0, bucket - n), (0, 0)))
    nb = np.pad(nb, (0, bucket - n))
    b_t = torch.from_numpy(blocks).to(dev)
    nb_t = torch.from_numpy(nb).to(dev)
    inner, outer = _hmac_key_states(key, dev)
    n_comp = int(np.minimum(nb, mb).sum()) + bucket
    return (lambda: sha256_hmac(b_t, nb_t, inner, outer, mb),
            lambda: sha256_hmac_plain(b_t, nb_t, inner, outer, mb),
            None, bound(n_bytes, sass["alu_per_compression"] * n_comp),
            {"bound_ms_all_instructions": bound(
                n_bytes, sass["instructions_per_compression"] * n_comp)[0]})


def time_kernels(batch: ColumnBatch, region: np.ndarray, chunk: int,
                 counts: dict, dev) -> dict:
    """Each kernel at the shapes the main path gives it: the first chunk
    of a ClickBench batch, padded to its row bucket as ops/fused.py pads
    it (K-A's pad rows have no blocks; K-B decodes and K-C evaluates
    every bucket row).  K-A's bound counts its ALU-pipe instructions
    (`counts`, from sass_counts); so do K10's, K12's and the
    histogram's; `bound_ms_all_instructions` counts every one of them."""
    sass = counts["sha256_hmac"]
    rows = batch.slice(0, chunk)
    bucket = bucket_rows(chunk)
    # name -> (kernel call, plain call, library call or None, bound)
    calls = {"sha256_hmac": hmac_call(rows.column("URL"), b"bench-salt",
                                      bucket, sass, dev)}

    calls["pred_decode"] = delta_calls(region[:chunk], bucket, dev)

    cols = {c: (torch.from_numpy(np.pad(rows.column(c).data,
                                        (0, bucket - chunk), mode="edge")
                                 ).to(dev), None)
            for c in ("RegionID", "ResolutionWidth")}
    calls["pred3vl_mask"] = pred_call(
        "RegionID < 400 AND ResolutionWidth >= 390", cols, bucket,
        counts["pred3vl_mask"], dev)

    out = {}
    calls.update(fingerprint_calls(batch, counts["rowhash_lanes"], dev))
    calls.update(decode_calls(dev))
    calls.update(pack_calls(batch, counts["ragged_pack"], dev))
    calls.update(mesh_calls(counts["shard_hist"], counts["digest_gather"],
                            dev))
    calls.update(sign_flip_calls(FETCH_MAX, dev))
    for name, call in calls.items():
        out[name] = timed(call, dev, f"{name} at the main path's shapes")
    kafka = kafka2ch_batches()[0].column("user_email")
    out["sha256_hmac"]["at_kafka2ch_batch"] = dict(
        rows=KAFKA2CH_BATCH, bucket=bucket_rows(KAFKA2CH_BATCH),
        **timed(hmac_call(kafka, KAFKA2CH_SALT, bucket_rows(KAFKA2CH_BATCH),
                          sass, dev), dev, "sha256_hmac at kafka2ch's batch"))
    email = make_batch("users", SNAP_TABLE, 0, chunk, SNAP_SEED).column(
        "email")
    out["sha256_hmac"]["at_snapshot_chunk"] = dict(
        rows=chunk, bucket=bucket,
        **timed(hmac_call(email, SNAP_SALT.encode(), bucket, sass, dev), dev,
                "sha256_hmac at the snapshot phase's chunk"))
    for name in ("sha256_hmac", "rowhash_lanes", "ragged_pack", "shard_hist",
                 "pred3vl_mask", "digest_gather"):
        out[name]["sass"] = counts[name]
    out["pred3vl_mask"].update(pred_timing(cols, bucket,
                                           counts["pred3vl_mask"], dev))
    out["sha256_hmac"]["at_pool_shape"] = pool_hmac_timing(
        sass["alu_per_compression"], dev)
    out["pred_decode"]["shape_values"] = bucket
    out["pred_decode"]["at_shapes"] = {
        str(n): timed(delta_calls(region[:n], n, dev), dev,
                      f"pred_decode at {n} values")
        for n in (BATCH_ROWS, 1 << 20)}
    out["dict_decode"].update(dict_timing(dev))
    out["shard_hist"]["at_step_shape"] = step_hist_timing(
        counts["shard_hist_step"], dev)
    out["shard_hist"]["at_step_shape"]["sass"] = counts["shard_hist_step"]
    out["rowhash_lanes"]["at_dict_shape"] = timed(dict_lane_call(
        counts["rowhash_lanes"], dev), dev, "rowhash_lanes at the dict shape")
    out["region_sign_flip"]["library_call"] = SIGN_FLIP_LIBRARY
    (kernel, plain, library, (bound_ms, bound_by)), = sign_flip_calls(
        SR_PARTITIONS * SR_BACKLOG, dev).values()
    out["region_sign_flip"]["at_1048576_rows"] = dict(
        rows=SR_PARTITIONS * SR_BACKLOG,
        max_abs_err=require_equal(kernel(), plain(),
                                  "region_sign_flip at 1,048,576 rows"),
        ms=kernel_ms(kernel, dev), plain_ms=wall_ms(plain, dev),
        library_ms=kernel_ms(library, dev), bound_ms=bound_ms,
        bound_by=bound_by)
    return out


SIGN_FLIP_LIBRARY = ("torch.where(region < 400, i32, -i32) on ids cast to "
                     "int32 beforehand: not one call (a compare, a "
                     "negation and a select)")


def sign_flip_calls(n: int, dev) -> dict:
    """K15 at n rows of the SR stream (ids and regions as sr_batches makes
    them): 8 bytes of ids and 4 of region read and 4 written a row, ~3
    operations (compare, negate, select)."""
    ids = torch.arange(n, dtype=torch.int64, device=dev)
    region = (ids % 500).to(torch.int32)
    i32 = ids.to(torch.int32)
    return {"region_sign_flip": (
        lambda: region_sign_flip(ids, region),
        lambda: region_sign_flip_plain(ids, region),
        lambda: torch.where(region < REGION_THRESHOLD, i32, -i32),
        bound(16 * n, 3 * n))}


def mesh_calls(counts: dict, gather_counts: dict, dev) -> dict:
    """K13/K14's histogram at main_path_mesh's shape (one shard of a
    131,072-row batch: 65,536 rows, keep and run validity packed, keep
    at main_path's ratio) and the digest gather at dispatch_mesh's (one
    shard's 65,536 codes into the 4,097-row pool digest matrix).
    Bytes: every row's keep and validity bits, one 32-byte sector of
    digest per kept row, the partial; the gather's codes read and rows
    written once, the table read once.  The histogram's operations: its
    SASS count (`counts`, hist_ops)."""
    rng = np.random.default_rng(17)
    n = bucket_rows(BATCH_ROWS // MESH_SHARDS)
    words = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 8)).astype(
        np.int32)).to(dev)
    pred = rng.random(n) < 0.8 * 6 / 7  # RegionID < 400, width >= 390
    valid = np.ones(n, dtype=bool)
    keep_w, valid_w = (mask_layout(b, "packed", dev) for b in (pred, valid))
    bins = (words[:, 0].to(torch.int64) & 0xFFFFFFFF) % TARGET_SHARDS
    weights = torch.from_numpy(pred.astype(np.float32)).to(dev)
    kept = int(pred.sum())
    n_bytes = 2 * n // 8 + 32 * kept + 4 * (TARGET_SHARDS + 1)
    ops = hist_ops(counts, n, TARGET_SHARDS)
    calls = {"shard_hist": (
        lambda: shard_hist_fused(words, TARGET_SHARDS, valid_w, keep_w),
        lambda: shard_hist_fused_plain(words, TARGET_SHARDS, valid_w, keep_w),
        lambda: torch.bincount(bins, weights=weights,
                               minlength=TARGET_SHARDS),
        bound(n_bytes, ops["alu"]),
        {"bound_ms_all_instructions": bound(n_bytes, ops["all"])[0],
         "lane_ops": ops})}

    values, batch_data = dispatch_data()
    pool = DictPool(*_flat_bytes(values + [b""]), null_code=len(values))
    blocks, nb = pack_hmac_blocks(pool.values_data, pool.values_offsets,
                                  pow2_blocks(int(np.diff(
                                      pool.values_offsets).max())))
    inner, outer = _hmac_key_states(b"bench-salt", dev)
    table = sha256_hmac(torch.from_numpy(blocks).to(dev),
                        torch.from_numpy(nb).to(dev), inner, outer,
                        blocks.shape[1] // 64)
    codes = torch.from_numpy(batch_data[0][0][:n].copy()).to(dev)
    k = table.shape[0]
    g = gather_counts
    warps = -(-n // g["rows_per_warp"])
    gops = {k: 32 * warps * g["per_thread"][k] for k in ("alu", "all")}
    g_bytes = 4 * n + 32 * n + 32 * k
    calls["digest_gather"] = (
        lambda: digest_gather(table, codes),
        lambda: digest_gather_plain(table, codes),
        lambda: torch.index_select(table, 0, codes),
        bound(g_bytes, gops["alu"]),
        {"bound_ms_all_instructions": bound(g_bytes, gops["all"])[0],
         "lane_ops": gops})
    return calls


def step_hist_timing(counts: dict, dev) -> dict:
    """K13's histogram in step mode at mesh_step's shape: one shard's
    262,144 rows of one column, float64 scores, beside torch.bincount.
    Bytes: ages and scores read, keep and scores_f32 written, one 32-byte
    sector per kept row."""
    rng = np.random.default_rng(18)
    n = STEP_ROWS_PER_DEVICE
    dig = torch.from_numpy(rng.integers(-2**31, 2**31, (1, n, 8)).astype(
        np.int32)).to(dev)
    ages = torch.from_numpy(rng.integers(0, 99, n).astype(np.int32)).to(dev)
    scores = torch.from_numpy(rng.uniform(0, 100, n)).to(dev)
    # the library call: torch.bincount over the bins, the keep mask as
    # weights, both computed beforehand
    bins = (dig[0, :, 0].to(torch.int64) & 0xFFFFFFFF) % TARGET_SHARDS
    weights = ((ages >= 0) & torch.isfinite(scores.float())).float()

    def kernel():
        return shard_hist_step(dig, ages, scores, TARGET_SHARDS)[0]

    def plain():
        return shard_hist_step_plain(dig, ages, scores, TARGET_SHARDS)[0]

    n_bytes = (4 + 8 + 1 + 4) * n + 32 * n + 4 * (TARGET_SHARDS + 1)
    ops = hist_ops(counts, n, TARGET_SHARDS)
    bound_ms, bound_by = bound(n_bytes, ops["alu"])
    return dict(rows=n, max_abs_err=require_equal(
        kernel(), plain(), "shard_hist at the step's shape"),
        ms=kernel_ms(kernel, dev), plain_ms=wall_ms(plain, dev),
        library_ms=kernel_ms(lambda: torch.bincount(
            bins, weights=weights, minlength=TARGET_SHARDS), dev),
        bound_ms=bound_ms, bound_by=bound_by,
        bound_ms_all_instructions=bound(n_bytes, ops["all"])[0],
        lane_ops=ops)


def pack_calls(batch: ColumnBatch, counts: dict, dev) -> dict:
    """K12 at the shape main_path_devpack gives it: one ClickBench
    batch's URL column into the batch's row bucket.  Bytes: the URL
    bytes and offsets read once, the blocks and counts written once.
    Operations: one thread's SASS count (`counts`) for each 16 output
    bytes that hold bytes of a row; the chunks of terminator, length,
    zeros and pad rows are charged as the bytes they write alone."""
    url = batch.column("URL")
    n = batch.n_rows
    bucket = bucket_rows(n)
    mb = pow2_blocks(int(np.diff(url.offsets).max()))
    data = torch.from_numpy(np.ascontiguousarray(url.data)).to(dev)
    offsets = torch.from_numpy(url.offsets.copy()).to(dev)
    require_equal(ragged_pack(data, offsets, bucket, mb)[1],
                  pack_blocks_plain(data, offsets, bucket, mb)[1],
                  "ragged_pack counts at the main path's shape")
    n_bytes = data.numel() + 4 * (n + 1) + bucket * (mb * 64 + 4)
    lens = np.diff(url.offsets.astype(np.int64))
    data_chunks = int((-(-lens // 16)).sum())
    ops = {k: data_chunks * counts["per_16_bytes"][k]
           for k in ("alu", "all")}
    return {"ragged_pack": (
        lambda: ragged_pack(data, offsets, bucket, mb)[0],
        lambda: pack_blocks_plain(data, offsets, bucket, mb)[0],
        None, bound(n_bytes, ops["alu"]),
        {"bound_ms_all_instructions": bound(n_bytes, ops["all"])[0],
         "lane_ops": ops, "data_chunks": data_chunks})}


def pool_hmac_timing(alu_per_compression: float, dev) -> dict:
    """K-A at the dispatch path's pool shape: the 4,096 values and the
    sentinel, one launch (the pool route's only kernel)."""
    values, _ = dispatch_data()
    data, offsets = _flat_bytes(values + [b""])
    mb = pow2_blocks(int(np.diff(offsets).max()))
    blocks, nb = pack_hmac_blocks(data, offsets, mb)
    n = len(nb)
    b_t = torch.from_numpy(blocks).to(dev)
    nb_t = torch.from_numpy(nb).to(dev)
    inner, outer = _hmac_key_states(b"bench-salt", dev)
    bound_ms, bound_by = bound(
        b_t.numel() + 4 * n + 64 + 32 * n,
        alu_per_compression * (int(np.minimum(nb, mb).sum()) + n))
    return dict(
        rows=n, max_abs_err=require_equal(
            sha256_hmac(b_t, nb_t, inner, outer, mb),
            sha256_hmac_plain(b_t, nb_t, inner, outer, mb),
            "sha256_hmac at the pool's shape"),
        ms=kernel_ms(lambda: sha256_hmac(b_t, nb_t, inner, outer, mb), dev),
        plain_ms=wall_ms(
            lambda: sha256_hmac_plain(b_t, nb_t, inner, outer, mb), dev),
        bound_ms=bound_ms, bound_by=bound_by)


def lane_bytes(batch: ColumnBatch, cols) -> int:
    """Bytes of one K10 reduce launch: each of the batch's column buffers
    read once at its own width (a fixed column's dtype, var bytes and
    offsets, dict codes and the pool's accumulators, validity), 16 bytes
    written; the 8-byte canonical fixed values that prep_batch makes are
    the port's choice, not work the function needs."""
    n_bytes = 16
    for c in cols:
        col = batch.column(c.name)
        if col.validity is not None:
            n_bytes += np.asarray(col.validity).nbytes
        if c.kind == "fixed":
            n_bytes += np.asarray(col.data).nbytes
        elif c.kind == "dict":
            n_bytes += 4 * batch.n_rows + 8 * c.acc1.numel()
        else:
            n_bytes += np.asarray(col.data).nbytes + 4 * (batch.n_rows + 1)
    return n_bytes


def var_ops(offsets, counts: dict, prefix: str, k: str) -> float:
    """Lane operations of a var column's (prefix "var") or a pool's
    ("entry") rows, one thread a row: each row's count and each byte's."""
    off = np.asarray(offsets, dtype=np.int64)
    return ((len(off) - 1) * counts[f"{prefix}_row"][k]
            + int(off[-1] - off[0]) * counts[f"{prefix}_byte"][k])


def lane_ops(batch: ColumnBatch, cols, counts: dict) -> dict:
    """Lane operations of one K10 launch over a batch, from its SASS
    counts (sass_rowhash): fixed and dict values, var columns by route."""
    n = batch.n_rows
    out = {}
    for k in ("alu", "all"):
        ops = n * counts["row"][k]
        for kind in ("fixed", "dict"):
            n_cols = sum(c.kind == kind for c in cols)
            ops += n * n_cols * counts[f"{kind}_batch"][k] / K10_BATCH
        for c in cols:
            if c.kind == "var":
                ops += var_ops(c.offsets.cpu().numpy(), counts, "var", k)
        out[k] = ops
    return out


def lane_call(batch: ColumnBatch, counts: dict, dev, what: str) -> tuple:
    """K10 in reduce mode over one batch, adding into one accumulator
    launch after launch as the fingerprint does (the timed call runs no
    fill); checked once against its plain version first."""
    cols, n = staged(batch, dev)
    acc = torch.zeros(4, dtype=torch.int32, device=dev)
    plain_acc = torch.zeros(4, dtype=torch.int32, device=dev)

    def plain():
        plain_acc.zero_()
        rowhash._reduce_into(plain_acc, *rowhash.rowhash_lanes_plain(cols, n))
        return plain_acc

    rowhash.rowhash_lanes(cols, n, acc)
    err = require_equal(acc, plain(), what)
    n_bytes = lane_bytes(batch, cols)
    ops = lane_ops(batch, cols, counts)
    return (lambda: rowhash.rowhash_lanes(cols, n, acc), plain, None,
            bound(n_bytes, ops["alu"]),
            {"max_abs_err": err, "rows": n,
             "bound_ms_all_instructions": bound(n_bytes, ops["all"])[0],
             "lane_ops": ops})


def dict_lane_call(counts: dict, dev) -> tuple:
    """K10 at fingerprint_dict's batch (262,144 rows: an int64 id and
    three dictionary columns)."""
    return lane_call(dict_batches(flat=False)[0], counts, dev,
                     "rowhash_lanes at the dict shape")


def fingerprint_calls(batch: ColumnBatch, counts: dict, dev) -> dict:
    """K10 at the fingerprint paths' shapes: one ClickBench batch in
    reduce mode, and one 4,096-value pool's accumulators."""
    pool = dict_batches(flat=False)[0].column("URL").dict_enc.pool
    data = torch.from_numpy(pool.values_data).to(dev)
    offsets = torch.from_numpy(pool.values_offsets).to(dev)
    k = offsets.numel() - 1
    n_bytes = data.numel() + 4 * (k + 1) + 8 * k
    ops = {m: var_ops(pool.values_offsets, counts, "entry", m)
           for m in ("alu", "all")}
    return {
        "rowhash_lanes": lane_call(batch, counts, dev,
                                   "rowhash_lanes at the batch shape"),
        "var_accumulators": (
            lambda: torch.stack(rowhash.var_accumulators(data, offsets)),
            lambda: torch.stack(rowhash._var_accs_host(data, offsets)),
            None, bound(n_bytes, ops["alu"]),
            {"bound_ms_all_instructions": bound(n_bytes, ops["all"])[0],
             "lane_ops": ops}),
    }


def timed(call, dev, what: str) -> dict:
    """A (kernel, plain, library, bound[, extra]) call: the kernel against
    its plain version (unless `extra` holds the check's max_abs_err
    already), then each timed; `extra`'s other keys join the result."""
    kernel, plain, library, (bound_ms, bound_by), *rest = call
    extra = dict(rest[0]) if rest else {}
    err = extra.pop("max_abs_err", None)
    if err is None:
        err = require_equal(kernel(), plain(), what)
    return dict(max_abs_err=err, ms=kernel_ms(kernel, dev),
                plain_ms=wall_ms(plain, dev),
                library_ms=kernel_ms(library, dev) if library else None,
                bound_ms=bound_ms, bound_by=bound_by, **extra)


def delta_calls(region: np.ndarray, bucket: int, dev) -> tuple:
    """K-B's delta scan over RegionID's delta wire as the dispatch encoder
    ships it (len(region) rows padded to `bucket`), and torch.cumsum over
    the same deltas, decoded beforehand."""
    spec, arrs = encode_pred_column("RegionID", region, None, len(region),
                                    bucket, True)
    if spec.kind != "delta":
        raise AssertionError(f"RegionID shipped as {spec}, not delta")
    w = torch.from_numpy(arrs[0].view(np.int32).copy()).to(dev)
    base, bw = int(arrs[1]), spec.bit_width
    zz = unpack_plain(w, bw, bucket)
    deltas = ((zz >> 1) ^ -(zz & 1)).to(torch.int32)
    return (
        lambda: pred_decode(MODE_DELTA, w, bucket, bw, base),
        lambda: pred_decode_plain(MODE_DELTA, w, bucket, bw, base),
        lambda: torch.cumsum(deltas, 0, dtype=torch.int32),
        # ~10 ops per value: unpack, zigzag, scan add
        bound(w.numel() * 4 + 4 * bucket, 10 * bucket))


def dict_call(words, pool, codes, bw: int, staged=None) -> tuple:
    """K11 over n codes into `pool` (the wrapper's split, or `staged`
    entries in shared memory), beside torch.index_select over the codes
    decoded beforehand."""
    n = codes.numel()

    def kernel():
        if staged is None:
            return decode_dict_run(words, pool, bw, n)
        out = torch.empty(n, dtype=torch.int32, device=words.device)
        _dict_decode_launch(words, pool, bw, n, None, None, out, staged)
        return out

    return (
        kernel,
        lambda: decode_dict_run_plain(words, pool, bw, n),
        lambda: torch.index_select(pool, 0, codes),
        # ~12 operations per value: unpack, clamp, gather address
        bound(words.numel() * 4 + pool.numel() * 4 + 4 * n, 12 * n))


def decode_calls(dev) -> dict:
    """K11 at the decode path's shape."""
    words, pool, codes = decode_inputs(dev)
    return {"dict_decode": dict_call(words, pool, codes, DECODE_BITS)}


def dict_timing(dev) -> dict:
    """K11 at the decode path's shape with every gather from L2, beside
    the wrapper's split that decode_calls times; and the split the
    wrapper picks at each checked pool size."""
    words, pool, codes = decode_inputs(dev)
    return {"staged": dict_staged_entries(pool.numel()),
            "l2_only": timed(dict_call(words, pool, codes, DECODE_BITS, 0),
                             dev, "dict_decode with every gather from L2"),
            "staged_by_pool": {str(k): dict_staged_entries(k)
                               for k in DICT_POOLS}}


# -- cli: the port's CLI on transfer.yaml, PG -> PG ----------------------------

CLI_ROWS = PG2CH_ROWS           # pg2ch's table in the source fake
CLI_EVENTS = 50_000             # the incremental table at the activation
CLI_EVENTS_NEW = 5_000          # its rows inserted after the activation
CLI_SEED = 29
CLI_INSERTS, CLI_UPDATES, CLI_DELETES = 12_000, 5_000, 3_000
CLI_SALT = "cli-salt"
# K-C reads int32 and narrower columns bit-exactly: the filter on region
# fuses with the mask (a double column's comparison stays on the host)
CLI_FILTER = "region < 400"
CLI_SETTLE_S = 600.0
# the source's DDL objects (the fake's pg_indexes / pg_views / pg_sequences)
CLI_INDEXES = [
    ("public", "hits", "hits_pkey",
     "CREATE UNIQUE INDEX hits_pkey ON public.hits USING btree (id)"),
    ("public", "hits", "hits_region_idx",
     "CREATE INDEX hits_region_idx ON public.hits USING btree (region)")]
CLI_VIEWS = [("public", "hits_kept",
              " SELECT id, url FROM public.hits WHERE region < 400;")]
CLI_SEQUENCES = [("public", "hits_id_seq", 1, 1, CLI_ROWS)]
# what transfer_ddl must apply on the target, in pg_dump.py's order (the
# primary key's index comes with the table)
CLI_DDL_APPLIED = [
    'CREATE SEQUENCE IF NOT EXISTS "public"."hits_id_seq" START WITH 1 '
    'INCREMENT BY 1',
    f"SELECT setval('\"public\".\"hits_id_seq\"', {CLI_ROWS})",
    "CREATE INDEX IF NOT EXISTS hits_region_idx ON public.hits USING btree "
    "(region)",
    'CREATE OR REPLACE VIEW "public"."hits_kept" AS  SELECT id, url FROM '
    'public.hits WHERE region < 400']
CLI_EXAMPLE_ENV = {"PG_PASSWORD": "x", "MASK_SALT": "s",
                   "MYSQL_PASSWORD": "x", "PII_SALT": "s"}
CLI_YAML = """\
# PG -> PG with the fused mask and filter: {what}
id: {tid}
type: {ttype}
src:
  type: pg
  params:
    host: 127.0.0.1
    port: {src}
    database: shop
    user: postgres
    password: "${{CLI_PG_PASSWORD:}}"
    schemas: [public]
    transfer_ddl: {ddl}
dst:
  type: pg
  params:
    host: 127.0.0.1
    port: {dst}
    database: shop
transformation:
  transformers:
    - mask_field: {{columns: [url], salt: "${{CLI_MASK_SALT:{salt}}}"}}
    - filter_rows: {{filter: "{filt}"}}
{extra}"""


def cli_yaml(path: str, what: str, tid: str, ttype: str, src: int,
             dst: int, ddl: bool = False, extra: str = "") -> str:
    with open(path, "w") as fh:
        fh.write(CLI_YAML.format(
            what=what, tid=tid, ttype=ttype, src=src, dst=dst,
            ddl="true" if ddl else "false", salt=CLI_SALT, filt=CLI_FILTER,
            extra=extra))
    return path


def cli_masked(url: str) -> str:
    return hmac.new(CLI_SALT.encode(), url.encode(),
                    hashlib.sha256).hexdigest()


def cli_events_row(i: int) -> tuple:
    return i, f"https://e.test/ev/{i % 613}", i % 450, (i % 77) * 1.5


def cli_kept_image(rows) -> dict:
    """numpy's mask and filter over (id, url, region, score) rows: id ->
    the row the target must hold."""
    rows = list(rows)
    keep = np.array([r[2] for r in rows]) < 400
    return {r[0]: (r[0], cli_masked(r[1]), r[2], r[3])
            for r, k in zip(rows, keep.tolist()) if k}


def cli_changes() -> list:
    """The tail: (kind, id, row or None), each key changed once: inserts
    of new ids, updates of snapshot ids (new url, region and score) and
    deletes of other snapshot ids, the kinds mixed as CDC traffic mixes
    them.  The source cuts a push at every change of a row's columns (a
    delete carries the key only), so the tail pushes a small batch or
    two a delete."""
    rng = np.random.default_rng(CLI_SEED)
    old = rng.choice(CLI_ROWS, CLI_UPDATES + CLI_DELETES, replace=False)
    new = CLI_ROWS + rng.choice(10 * CLI_ROWS, CLI_INSERTS, replace=False)
    out = []
    for k in new.tolist():
        out.append(("I", k, (k, f"https://e.test/new/{k % 997}",
                             int(rng.integers(0, 500)),
                             float(rng.integers(0, 91)) * 1.5)))
    for k in old[:CLI_UPDATES].tolist():
        out.append(("U", k, (k, f"https://e.test/upd/{k % 997}",
                             int(rng.integers(0, 500)),
                             float(rng.integers(0, 91)) * 1.5)))
    for k in old[CLI_UPDATES:].tolist():
        out.append(("D", k, None))
    return [out[i] for i in rng.permutation(len(out)).tolist()]


def cli_feed(pg: FakePG, changes: list, txn_rows: int = 1000) -> int:
    """The changes as wal2json v2 messages in transactions, appended to
    the fake's WAL in one go; the last LSN."""
    pk = [{"name": "id", "type": "bigint"}]
    msgs = []
    for lo in range(0, len(changes), txn_rows):
        msgs.append(json.dumps({"action": "B"}).encode())
        for kind, k, row in changes[lo:lo + txn_rows]:
            msg = {"action": kind, "schema": "public", "table": "hits",
                   "pk": pk}
            if row is not None:
                msg["columns"] = [{"name": c[0], "type": c[1], "value": v}
                                  for c, v in zip(PG2CH_COLUMNS, row)]
            if kind != "I":
                msg["identity"] = [{"name": "id", "type": "bigint",
                                    "value": k}]
            msgs.append(json.dumps(msg).encode())
        msgs.append(json.dumps({"action": "C"}).encode())
    pg.feed_wal_many(msgs)
    return pg.wal[-1][0]


def cli_expected_hits(changes: list) -> dict:
    """numpy's image of the target's hits after the tail: the snapshot's
    kept rows; an insert lands when the filter keeps it, an update only
    when the filter keeps it and the target holds the key (a statement
    UPDATE), a delete always."""
    image = cli_kept_image(cdc.hits_row(i) for i in range(CLI_ROWS))
    rows = [r for _, _, r in changes if r is not None]
    kept = cli_kept_image(rows)
    for kind, k, _ in changes:
        if kind == "D":
            image.pop(k, None)
        elif k in kept and (kind == "I" or k in image):
            image[k] = kept[k]
    return image


def cli_table(pg: FakePG, name: str) -> dict:
    """A fake's public.<name> as id -> (id, url, region, score)."""
    with pg.lock:
        t = pg.tables.get(("public", name))
        rows = list(t.rows) if t else []
    return {int(r["id"]): (int(r["id"]), r["url"], int(r["region"]),
                           float(r["score"])) for r in rows}


def cli_fake_rows(rows) -> list:
    return [{"id": str(r[0]), "url": r[1], "region": str(r[2]),
             "score": f"{r[3]}"} for r in rows]


class PredLaunches:
    """Records each K-B and K-C launch on the card (inputs and output,
    cloned) while a path runs, to hold every launch against the plain
    versions afterwards."""

    def __enter__(self):
        from transferia_tpu_torch.ops import decode as decode_mod
        from transferia_tpu_torch.predicate import device as pred_mod

        self.decodes, self.masks = [], []
        self._mods = (decode_mod, pred_mod)
        self._fns = (decode_mod.pred_decode, pred_mod.pred3vl_mask)
        dec_fn, mask_fn = self._fns
        rec = self

        def clone(t):
            return None if t is None else t.clone()

        def pred_decode(mode, words, n, bit_width, base=0, mins=None,
                        frame=0):
            out = dec_fn(mode, words, n, bit_width, base, mins, frame)
            if words.is_cuda:
                rec.decodes.append((mode, words.clone(), n, bit_width,
                                    base, clone(mins), frame, out.clone()))
            return out

        def pred3vl_mask(program, cols, n, pack_keep, device=None):
            out = mask_fn(program, cols, n, pack_keep, device)
            if out.is_cuda:
                rec.masks.append((program, [(d.clone(), clone(v))
                                            for d, v in cols],
                                  n, pack_keep, out.clone()))
            return out

        decode_mod.pred_decode = pred_decode
        pred_mod.pred3vl_mask = pred3vl_mask
        return self

    def __exit__(self, *exc):
        self._mods[0].pred_decode, self._mods[1].pred3vl_mask = self._fns
        return False

    def check(self, what: str, counts: dict) -> dict:
        """Every recorded launch exact against the plain version on the
        CPU, and as many as the path counted."""
        from transferia_tpu_torch.ops.decode import pred_decode_plain

        if len(self.decodes) != counts["pred_decode"] or \
                len(self.masks) != counts["pred3vl_mask"]:
            raise AssertionError(
                f"{what}: {len(self.decodes)} K-B / {len(self.masks)} K-C "
                f"launches recorded, {counts['pred_decode']} / "
                f"{counts['pred3vl_mask']} counted")
        for i, (mode, words, n, bw, base, mins, frame, out) in \
                enumerate(self.decodes):
            want = pred_decode_plain(
                mode, words.cpu(), n, bw, base,
                None if mins is None else mins.cpu(), frame)
            require_equal(out.cpu(), want, f"{what}: K-B launch {i}")
        for i, (program, cols, n, pack_keep, out) in enumerate(self.masks):
            want = self._fns[1](
                program, [(d.cpu(), None if v is None else v.cpu())
                          for d, v in cols], n, pack_keep)
            require_equal(out.cpu(), want, f"{what}: K-C launch {i}")
        held = {"pred_decode": len(self.decodes),
                "pred3vl_mask": len(self.masks)}
        self.decodes, self.masks = [], []
        return held


class FingerprintDispatches:
    """Records each batch the device fingerprint launches K10 on (the
    checksum command's), to key it again against the plain version."""

    def __enter__(self):
        self.dispatched = []
        self._real = real = rowhash.DeviceFingerprintProgram.dispatch
        rec = self

        def dispatch(program, cols, n):
            rec.dispatched.append((cols, n))
            return real(program, cols, n)

        rowhash.DeviceFingerprintProgram.dispatch = dispatch
        return self

    def __exit__(self, *exc):
        rowhash.DeviceFingerprintProgram.dispatch = self._real
        return False


def cli_main(argv: list, dev) -> tuple[int, str, str, float]:
    """The port's CLI in this process and thread: (exit code, stdout,
    stderr, seconds); each command's seconds also go to stderr as it
    ends."""
    import contextlib
    import io

    from transferia_tpu_torch.cli.main import main as cli_entry

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_entry(["--device", str(dev.type), "--log-level", "warning"]
                       + argv)
    _sync(dev)
    seconds = time.perf_counter() - t0
    print(f"cli: {argv[0]} rc {rc} in {seconds:.3f} s", file=sys.stderr,
          flush=True)
    return rc, out.getvalue(), err.getvalue(), seconds


def cli_validate(dev) -> dict:
    """validate on the examples and describe, as a user runs them."""
    saved = {k: os.environ.get(k) for k in CLI_EXAMPLE_ENV}
    os.environ.update(CLI_EXAMPLE_ENV)
    out = {}
    try:
        here = Path(__file__).resolve().parent / "examples"
        for name in ("pg2ch", "kafka2ch", "mysql2kafka", "kafka_sr2ch",
                     "clickbench_s3_parquet2ch"):
            rc, so, se, s = cli_main(
                ["validate", "--transfer", str(here / f"{name}.yaml")], dev)
            out[name] = {"rc": rc, "stdout": so.strip(),
                         "stderr": se.strip()[-300:], "seconds": s}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    for name in ("pg2ch", "kafka2ch", "mysql2kafka", "kafka_sr2ch",
                 "clickbench_s3_parquet2ch"):
        # kafka_sr2ch's lambda names a user module the chain resolves
        # only when a batch comes: 0 in both packages (the CPU tests)
        if out[name]["rc"] != 0 or not out[name]["stdout"].startswith("OK"):
            raise AssertionError(f"cli validate {name}: {out[name]}")
    rc, so, _, s = cli_main(["describe", "--provider", "pg"], dev)
    described = json.loads(so)
    if rc != 0 or sorted(described) != ["pg/source", "pg/target"] or \
            "transfer_ddl" not in described["pg/source"]:
        raise AssertionError(f"cli describe: rc {rc}, {sorted(described)}")
    out["describe"] = {"rc": rc, "endpoints": sorted(described),
                       "seconds": s}
    return out


class SourcePushes:
    """Counts the batches the Postgres source pushes through the chain
    and the sink (one a run of changes of one table and columns) while
    a path runs."""

    def __enter__(self):
        from transferia_tpu_torch.providers.postgres import replication

        self.pushes = 0
        self._mod, self._fn = replication, replication._split_homogeneous
        split_fn, rec = self._fn, self

        def split_homogeneous(items):
            runs = split_fn(items)
            rec.pushes += len(runs)
            return runs

        replication._split_homogeneous = split_homogeneous
        return self

    def __exit__(self, *exc):
        self._mod._split_homogeneous = self._fn
        return False


def cli_replicate(src: FakePG, dst: FakePG, path: str, changes: list,
                  dev) -> dict:
    """`replicate --transfer` in the main thread: the S&I activation (the
    snapshot through the fused chain into the target's staged parts, the
    DDL objects), then the wal2json tail, fed once the slot exists; a
    watcher sends SIGTERM once the source has the tail's last LSN
    confirmed."""
    import signal as signal_mod

    fed, failure, returned = {}, [], threading.Event()

    def watch():
        try:
            deadline = time.perf_counter() + CLI_SETTLE_S
            while not src.slots and not returned.is_set() and \
                    time.perf_counter() < deadline:
                time.sleep(0.05)
            if not src.slots:
                raise AssertionError("no replication slot appeared")
            fed["activated_s"] = time.perf_counter() - t0
            fed["target_rows_at_slot"] = len(cli_table(dst, "hits"))
            print(f"cli: activated in {fed['activated_s']:.3f} s",
                  file=sys.stderr, flush=True)
            fed["last"] = cli_feed(src, changes)
            fed["fed_s"] = time.perf_counter()
            while src.flushed_lsn < fed["last"] and \
                    time.perf_counter() < deadline:
                time.sleep(0.05)
            fed["tail_s"] = time.perf_counter() - fed["fed_s"]
            if src.flushed_lsn < fed["last"]:
                raise AssertionError("the tail's last LSN was never "
                                     "confirmed")
        except BaseException as e:   # reported after the command
            failure.append(e)
        finally:
            # the slot exists only inside the command's replication loop,
            # whose handler turns SIGTERM into its stop
            if src.slots and not returned.is_set():
                os.kill(os.getpid(), signal_mod.SIGTERM)

    t0 = time.perf_counter()
    watcher = threading.Thread(target=watch, name="cli-watch", daemon=True)
    watcher.start()
    try:
        # the snapshot's parts do not go through the source's runs: every
        # push counted is the tail's
        with SourcePushes() as pushes:
            rc, so, se, seconds = cli_main(["replicate", "--transfer",
                                            path], dev)
    finally:
        returned.set()
    watcher.join(60)
    if failure:
        raise failure[0]
    if rc != 0:
        raise AssertionError(f"cli replicate: rc {rc}: {se[-2000:]}")
    return {"rc": rc, "seconds": seconds,
            "activation_seconds": fed["activated_s"],
            "target_rows_at_slot": fed["target_rows_at_slot"],
            "tail_seconds": fed["tail_s"], "tail_pushes": pushes.pushes,
            "last_lsn": int_to_lsn(fed["last"])}


def cli_subprocess(src: FakePG, tmp: str, events: dict, dev) -> dict:
    """`python3 -m transferia_tpu_torch.cli.main activate` in a process of
    its own: the events table into a fresh target."""
    dst = FakePG().start()
    try:
        path = cli_yaml(
            os.path.join(tmp, "cli_sub.yaml"), "the module entry point",
            "cli-sub", "SNAPSHOT_ONLY", src.port, dst.port,
            extra='data_objects: ["public.events"]\n')
        env = dict(os.environ, TRANSFERIA_TPU_PLACEMENT="device",
                   PYTHONPATH=str(Path(__file__).resolve().parent))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "transferia_tpu_torch.cli.main",
             "--device", str(dev.type), "--log-level", "warning",
             "activate", "--transfer", path],
            capture_output=True, text=True, timeout=600, env=env)
        seconds = time.perf_counter() - t0
        got = cli_table(dst, "events")
        if proc.returncode != 0 or got != events or \
                "cli-sub: activated" not in proc.stdout:
            raise AssertionError(
                f"cli subprocess: rc {proc.returncode}, {len(got)} rows of "
                f"{len(events)} (equal {got == events}): "
                f"{proc.stderr[-2000:]}")
        return {"rc": proc.returncode, "seconds": seconds,
                "rows": len(got), "stdout": proc.stdout.strip()}
    finally:
        dst.stop()


def cli_path(dev) -> dict:
    """The port's CLI on transfer.yaml files, as a user runs it: a PG ->
    PG transfer with the fused mask and filter (K-A, K-B, K-C) and
    transfer_ddl, checked against numpy at every step; every launch of
    the in-process commands recorded and held against the plain
    versions."""
    import logging

    # the CLI's logging.basicConfig must not bind its handler to a
    # captured stderr
    logging.basicConfig(level=logging.WARNING)
    t0 = time.perf_counter()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli-", dir=str(_build.BUILD_DIR))
    src, dst, img = FakePG().start(), FakePG().start(), FakePG().start()
    set_placement("device")
    result: dict = {}
    try:
        src.add_table(hits_table(CLI_ROWS))
        events0 = [cli_events_row(i) for i in range(CLI_EVENTS)]
        src.add_table(FakeTable("public", "events", PG2CH_COLUMNS,
                                cli_fake_rows(events0)))
        src.indexes.extend(CLI_INDEXES)
        src.views.extend(CLI_VIEWS)
        src.sequences.extend(CLI_SEQUENCES)
        changes = cli_changes()
        want_hits = cli_expected_hits(changes)
        gen_s = time.perf_counter() - t0
        main_yaml = cli_yaml(os.path.join(tmp, "cli.yaml"),
                             "SNAPSHOT_AND_INCREMENT with transfer_ddl",
                             "cli-pg2pg", "SNAPSHOT_AND_INCREMENT",
                             src.port, dst.port, ddl=True)
        result["validate"] = cli_validate(dev)
        held = {}
        with KALaunches() as ka, PredLaunches() as preds, \
                KeyLaunches() as keyed, FingerprintDispatches() as fpd:
            _build.reset_launch_counts()
            # 1. replicate: the activation, then the tail
            rep = result["replicate"] = cli_replicate(
                src, dst, main_yaml, changes, dev)
            counts = {"replicate": _build.launch_counts()}
            got = cli_table(dst, "hits")
            fences = [r["part_key"] for r in
                      dst.tables[("public", "__trtpu_commits")].rows]
            staging_left = [n for _, n in dst.tables
                            if n.startswith("__trtpu_stg_")]
            want_events0 = cli_kept_image(events0)
            if got != want_hits or cli_table(dst, "events") \
                    != want_events0 or sorted(fences) != sorted(set(fences)) \
                    or len(fences) != 2 or staging_left \
                    or dst.executed_ddl != CLI_DDL_APPLIED:
                raise AssertionError(
                    f"cli replicate: hits {len(got)} rows of "
                    f"{len(want_hits)} (equal {got == want_hits}), fences "
                    f"{fences}, staging left {staging_left}, ddl "
                    f"{dst.executed_ddl}")
            rep.update(target_rows=len(got), fence_parts=sorted(fences),
                       ddl_applied=len(dst.executed_ddl),
                       snapshot_rows_per_s=(CLI_ROWS + CLI_EVENTS)
                       / rep["activation_seconds"],
                       tail_rows_per_s=len(changes) / rep["tail_seconds"])
            # 2. checksum: the target against numpy's image, by K10
            img.add_table(FakeTable("public", "hits", PG2CH_COLUMNS,
                                    cli_fake_rows(want_hits.values())))
            chk_yaml = cli_yaml(os.path.join(tmp, "cli_checksum.yaml"),
                                "the target against numpy's image",
                                "cli-checksum", "SNAPSHOT_ONLY", img.port,
                                dst.port)
            # the fingerprint decides; on a mismatch the sampled row
            # compare diagnoses (a full one is quadratic in the fake)
            argv = ["checksum", "--transfer", chk_yaml, "--table",
                    "public.hits", "--method", "fingerprint",
                    "--fingerprint-backend", "device", "--size-threshold",
                    "0"]
            rc_ok, so_ok, _, s_ok = cli_main(argv, dev)
            with dst.lock:
                t = dst.tables[("public", "hits")]
                r0 = min(t.rows, key=lambda r: int(r["id"]))
                r0["score"] = f"{float(r0['score']) + 0.5}"
            rc_bad, so_bad, _, s_bad = cli_main(argv, dev)
            if rc_ok != 0 or rc_bad != 1:
                raise AssertionError(f"cli checksum: clean rc {rc_ok} "
                                     f"({so_ok[-500:]}), altered rc "
                                     f"{rc_bad} ({so_bad[-500:]})")
            counts["checksum"] = _build.launch_counts()
            result["checksum"] = {"clean_rc": rc_ok, "altered_rc": rc_bad,
                                  "clean_seconds": s_ok,
                                  "altered_seconds": s_bad,
                                  "clean_report": so_ok.strip()[-400:],
                                  "altered_report": so_bad.strip()[-400:]}
            # 3. the incremental table's second snapshot: the rows past
            # the cursor only
            events_new = [cli_events_row(i) for i in
                          range(CLI_EVENTS, CLI_EVENTS + CLI_EVENTS_NEW)]
            with src.lock:
                src.tables[("public", "events")].rows.extend(
                    cli_fake_rows(events_new))
            inc_yaml = cli_yaml(
                os.path.join(tmp, "cli_inc.yaml"),
                "the incremental table's second snapshot", "cli-pg2pg",
                "SNAPSHOT_ONLY", src.port, dst.port,
                extra=("regular_snapshot:\n  enabled: true\n"
                       "  cron: \"* * * * *\"\n  incremental:\n"
                       "    - {namespace: public, name: events, "
                       f"cursor_field: id, initial_state: \"{CLI_EVENTS - 1}\""
                       "}\n"))
            before = cli_table(dst, "events")
            rc, so, se, s_up = cli_main(["upload", "--transfer", inc_yaml,
                                         "--table", "public.events"], dev)
            after = cli_table(dst, "events")
            want_new = cli_kept_image(events_new)
            moved = {k: v for k, v in after.items() if k not in before}
            if rc != 0 or moved != want_new or len(after) != \
                    len(before) + len(want_new):
                raise AssertionError(
                    f"cli upload: rc {rc}, {len(moved)} new rows of "
                    f"{len(want_new)} (equal {moved == want_new}), "
                    f"{len(after)} rows: {se[-2000:]}")
            counts["upload"] = _build.launch_counts()
            launches = counts["upload"]
            require_launched("cli", launches)
            result["upload"] = {"rc": rc, "seconds": s_up,
                                "source_new_rows": len(events_new),
                                "moved_rows": len(moved)}
            held["sha256_hmac"] = ka.check("cli", launches["sha256_hmac"])
            held.update(preds.check("cli", launches))
            held["rowhash_lanes_keys"] = keyed.check("cli", dev)
            held["rowhash_lanes_fingerprint"] = check_dispatched(
                {"cli": {"dispatched": fpd.dispatched}}, dev)
        # 4. the module entry point in a process of its own
        result["subprocess"] = cli_subprocess(
            src, tmp, cli_kept_image(events0 + events_new), dev)
        result.update(
            rows=CLI_ROWS, events=CLI_EVENTS, events_new=CLI_EVENTS_NEW,
            changes={"inserts": CLI_INSERTS, "updates": CLI_UPDATES,
                     "deletes": CLI_DELETES},
            data_gen_seconds=gen_s, launches=launches,
            launches_by_command={
                "replicate": counts["replicate"],
                "checksum": {k: counts["checksum"][k]
                             - counts["replicate"][k] for k in launches},
                "upload": {k: counts["upload"][k] - counts["checksum"][k]
                           for k in launches}},
            held_exact=held)
        return result
    finally:
        set_placement(None)
        for pg in (src, dst, img):
            pg.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase sharded: config #2 across processes on the filestore coordinator --
#
# (a) one transfer.yaml (pg2ch's 300,000 hits rows and cli's 50,000-row
# events table in the port's fake Postgres, now on heap pages, through the
# fused mask + filter into the fake ClickHouse, staged commits on, the
# fingerprint tap on) activated by three workers: job 0 in this process
# through the CLI, jobs 1 and 2 as `python3 -m transferia_tpu_torch.cli.main`
# processes started together, all on one filestore coordinator; then
# `checksum --against-operation`, clean and with one value altered; and
# the same YAML with --job-count 1 for comparison.  (b) (a) again into a
# fresh target with 3-s leases and 1-s heartbeats, job 2 slowed by a
# failpoint delay on every batch and SIGKILLed once it holds a lease on an
# unfinished part: the survivors steal its parts.  (c) Kafka -> fs (jsonl),
# 16 partitions x 4,096 messages of replication (a)'s schema through
# REPL_CONFIG, one pipeline a partition (PartitionedWorker).
SHARD_JOBS = 3
# the fake's pg_relation_size is 100 bytes a row: hits (30,000,000 bytes)
# splits into 15 ctid ranges, events (5,000,000) into 3
SHARD_PART_BYTES = 2_000_000
SHARD_ROWS, SHARD_EVENTS = PG2CH_ROWS, CLI_EVENTS
SHARD_SALT = CLI_SALT
SHARD_LEASE_S, SHARD_HEARTBEAT_S, SHARD_DELAY_MS = 3, 1, 2000
SHARD_SETTLE_S = 600.0
SHARD_YAML = """\
# config #2 sharded over processes: {what}
id: {tid}
type: SNAPSHOT_ONLY
src:
  type: pg
  params:
    host: 127.0.0.1
    port: {src}
    database: shop
    user: postgres
    schemas: [public]
    desired_part_size_bytes: {part_bytes}
dst:
  type: ch
  params:
    host: 127.0.0.1
    port: {dst}
    database: default
    bufferer: null
    # every worker runs the activation's cleanup: a secondary starting
    # after the main's first publish must not drop it
    cleanup_policy: disabled
transformation:
  transformers:
    - mask_field: {{columns: [url], salt: "{salt}"}}
    - filter_rows: {{filter: "{filt}"}}
validation: {{fingerprint: true}}
"""
K2FS_PARTITIONS, K2FS_MESSAGES = 16, 4096


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def shard_yaml(path: str, what: str, tid: str, src: int, dst: int) -> str:
    with open(path, "w") as fh:
        fh.write(SHARD_YAML.format(
            what=what, tid=tid, src=src, dst=dst,
            part_bytes=SHARD_PART_BYTES, salt=SHARD_SALT, filt=CLI_FILTER))
    return path


def shard_images() -> dict:
    """numpy's mask and filter over both tables: table -> id -> row."""
    return {"hits": cli_kept_image(cdc.hits_row(i)
                                   for i in range(SHARD_ROWS)),
            "events": cli_kept_image(cli_events_row(i)
                                     for i in range(SHARD_EVENTS))}


def shard_target(ch: FakeCH, table: str) -> list:
    """The target's rows of a table as (id, url, region, score)."""
    return [(int(r["id"]), r["url"].decode() if isinstance(r["url"], bytes)
             else r["url"], int(r["region"]), float(r["score"]))
            for r in ch.rows(f"public__{table}")]


def shard_worker(job: int, argv: list, path: str, port: int, dev,
                 extra: dict, log: str) -> subprocess.Popen:
    """One secondary: the module entry point in a process of its own,
    its health port on `port`, its output into the file `log` (a pipe
    nobody reads until it exits would stop it once full)."""
    env = dict(os.environ, TRANSFERIA_TPU_PLACEMENT="device",
               PYTHONPATH=str(Path(__file__).resolve().parent), **extra)
    with open(log, "w") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", "transferia_tpu_torch.cli.main",
             "--device", str(dev.type), "--log-level", "warning"] + argv
            + ["--job-index", str(job), "--health-port", str(port),
               "activate", "--transfer", path],
            stdout=fh, stderr=subprocess.STDOUT, env=env)


def log_tail(log: str, n: int = 2000) -> str:
    with open(log) as fh:
        return fh.read()[-n:]


def wait_up(port: int, proc: subprocess.Popen, log: str,
            deadline: float) -> None:
    """Until the worker's health port answers (the process is up, the
    card resolved), or fail."""
    import urllib.request

    while time.perf_counter() < deadline:
        if proc.poll() is not None:
            raise AssertionError(f"sharded worker exited early: rc "
                                 f"{proc.returncode}: {log_tail(log)}")
        try:
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{port}/health", timeout=1):
                return
        except OSError:
            time.sleep(0.1)
    raise AssertionError("a sharded worker never came up")


def shard_run(pg: FakePG, root: str, tmp: str, tid: str, dev,
              jobs: int = SHARD_JOBS, kill: bool = False) -> dict:
    """One activation of the YAML by `jobs` workers into a fresh fake
    ClickHouse: the secondaries started together and up before job 0
    runs here; with `kill`, job 2 is slowed and SIGKILLed once it holds a
    lease on an unfinished part.  What the target and the coordinator
    hold afterwards."""
    import signal as signal_mod

    from transferia_tpu_torch.coordinator import FileStoreCoordinator
    from transferia_tpu_torch.tasks import snapshot as snapshot_mod

    ch = FakeCH().start()
    lease_env = {"TRANSFERIA_TPU_LEASE_SECONDS": str(SHARD_LEASE_S),
                 "TRANSFERIA_TPU_HEARTBEAT_INTERVAL": str(SHARD_HEARTBEAT_S)
                 } if kill else {}
    saved_env = {k: os.environ.get(k) for k in lease_env}
    saved_tuning = snapshot_mod.TUNING
    procs, logs, out = {}, {}, {"jobs": jobs}
    try:
        path = shard_yaml(os.path.join(tmp, f"{tid}.yaml"),
                          f"{jobs} workers", tid, pg.port, ch.port)
        argv = ["--coordinator", "filestore", "--coordinator-dir", root,
                "--job-count", str(jobs)]
        t0 = time.perf_counter()
        ports = {}
        for job in range(1, jobs):
            extra = dict(lease_env)
            if kill and job == 2:
                extra["TRANSFERIA_TPU_FAILPOINTS"] = \
                    f"snapshot.part.batch=delay:{SHARD_DELAY_MS}"
            ports[job] = free_port()
            logs[job] = os.path.join(tmp, f"{tid}.job{job}.log")
            procs[job] = (shard_worker(job, argv, path, ports[job], dev,
                                       extra, logs[job]),
                          time.perf_counter())
        deadline = time.perf_counter() + SHARD_SETTLE_S
        for job, (proc, _) in procs.items():
            wait_up(ports[job], proc, logs[job], deadline)
        out["workers_up_seconds"] = time.perf_counter() - t0
        os.environ.update(lease_env)
        snapshot_mod.TUNING = snapshot_mod.SnapshotTuning.from_env()
        killer = None
        if kill:
            killer = threading.Thread(target=shard_kill, args=(
                root, f"op-{tid}", procs[2][0], deadline, out),
                daemon=True)
            killer.start()
        t_main = time.perf_counter()
        rc, _, se, main_s = cli_main(argv + ["--job-index", "0", "activate",
                                             "--transfer", path], dev)
        if rc != 0:
            raise AssertionError(f"sharded job 0: rc {rc}: {se[-2000:]}")
        seconds = {0: main_s}
        for job, (proc, started) in procs.items():
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            seconds[job] = time.perf_counter() - started
            want_rc = -signal_mod.SIGKILL if kill and job == 2 else 0
            if proc.returncode != want_rc:
                raise AssertionError(f"sharded job {job}: rc "
                                     f"{proc.returncode}: "
                                     f"{log_tail(logs[job])}")
        # what each secondary logged (warnings and up), for the record
        out["worker_logs"] = {j: log_tail(f, 600) for j, f in logs.items()}
        wall = time.perf_counter() - t0
        if killer is not None:
            killer.join(10)
            if "killed_at" not in out:
                raise AssertionError("job 2 was never seen holding a lease")
            out["recovery_seconds"] = time.perf_counter() - out.pop(
                "killed_at")
        cp = FileStoreCoordinator(root=root)
        parts = cp.operation_parts(f"op-{tid}")
        out.update(
            wall_seconds=wall, main_seconds=main_s,
            main_started_after=t_main - t0,
            rows_per_s=(SHARD_ROWS + SHARD_EVENTS) / wall,
            # from job 0's start, once every worker is up
            rows_per_s_after_up=(SHARD_ROWS + SHARD_EVENTS)
            / (wall - out["workers_up_seconds"]),
            parts=len(parts),
            parts_by_table={t: sum(1 for p in parts if p.table_id.name == t)
                            for t in ("hits", "events")},
            workers={j: {"parts": sum(1 for p in parts
                                      if p.worker_index == j),
                         "rows": sum(p.completed_rows for p in parts
                                     if p.worker_index == j),
                         "seconds": seconds[j]} for j in range(jobs)},
            steals=sum(1 for p in parts if p.stolen_from is not None),
            fingerprints=cp.get_operation_state(f"op-{tid}").get(
                "table_fingerprints", {}))
        if not parts or not all(p.completed for p in parts):
            raise AssertionError(f"sharded {tid}: parts not all completed: "
                                 f"{[p.key() for p in parts]}")
        out["target"] = {t: shard_target(ch, t) for t in ("hits", "events")}
        out["fences"] = [r["part_key"] for r in ch.rows("__trtpu_commits")]
        out["staging_left"] = sorted(n for n in ch.tables
                                     if n.startswith("__trtpu_stg_"))
        out["ch"] = ch
        return out
    except BaseException:
        ch.stop()
        raise
    finally:
        snapshot_mod.TUNING = saved_tuning
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)


def shard_kill(root: str, op: str, proc: subprocess.Popen,
               deadline: float, out: dict) -> None:
    """SIGKILL job 2 once the parts doc shows it holding a lease on a
    part it has not completed."""
    from transferia_tpu_torch.coordinator import FileStoreCoordinator

    cp = FileStoreCoordinator(root=root)
    while time.perf_counter() < deadline and proc.poll() is None:
        held = [p.key() for p in cp.operation_parts(op)
                if p.worker_index == 2 and not p.completed
                and p.lease_expires_at > time.time()]
        if held:
            proc.kill()
            out["killed_at"] = time.perf_counter()
            out["killed_unix"] = time.time()
            out["killed_holding"] = held
            return
        time.sleep(0.05)


def shard_check(run: dict, images: dict, want_fp: dict, what: str) -> None:
    """The target equal to numpy's image, each row once; a fence row a
    part; no staging table; the recorded fingerprints the plain K10
    digests of the image."""
    for t, image in images.items():
        got = run["target"][t]
        if len(got) != len(image) or dict((r[0], r) for r in got) != image:
            raise AssertionError(
                f"sharded {what}: {t} holds {len(got)} rows, numpy's image "
                f"{len(image)} (equal as a map "
                f"{dict((r[0], r) for r in got) == image})")
    fences = run["fences"]
    if len(fences) != run["parts"] or len(set(fences)) != len(fences) or \
            run["staging_left"]:
        raise AssertionError(f"sharded {what}: {len(fences)} fence rows "
                             f"for {run['parts']} parts, staging left "
                             f"{run['staging_left']}")
    if run["fingerprints"] != want_fp:
        raise AssertionError(f"sharded {what}: recorded fingerprints "
                             f"{run['fingerprints']}, plain K10 {want_fp}")


def shard_plain_fingerprints(pg: FakePG, images: dict, dev) -> dict:
    """K10's plain version on the card over numpy's image of each table,
    in the source's schema."""
    from transferia_tpu_torch.providers.postgres.provider import PGStorage

    st = PGStorage(PGSourceParams(host="127.0.0.1", port=pg.port,
                                  database="shop"))
    try:
        out = {}
        for t, image in images.items():
            tid = TableID("public", t)
            rows = [image[k] for k in sorted(image)]
            batch = ColumnBatch.from_pydict(
                tid, st.table_schema(tid),
                {c: [r[j] for r in rows] for j, c in
                 enumerate(("id", "url", "region", "score"))})
            out[tid.fqtn()] = plain_digest([batch], dev)
        return out
    finally:
        st.close()


def k2fs_message(p: int, i: int) -> bytes:
    k = p * K2FS_MESSAGES + i
    return json.dumps({"id": k, "url": f"https://bench.example/{i}",
                       "region": k % 500}).encode()


def k2fs_run(tmp: str, dev) -> dict:
    """Kafka -> fs (jsonl) through run_replication: PartitionedWorker,
    one pipeline a partition; stopped once every partition's last offset
    is committed; the files read back."""
    from transferia_tpu_torch.providers.file import FileTargetParams
    from transferia_tpu_torch.runtime import local as local_mod

    broker = FakeKafka(n_partitions=K2FS_PARTITIONS).start()
    workers = []
    real = local_mod.PartitionedWorker

    class Recorded(real):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            workers.append(self)

    try:
        broker.create_topic("events")
        produce(broker.port, K2FS_PARTITIONS, K2FS_MESSAGES, FETCH_MAX,
                k2fs_message)
        out_dir = os.path.join(tmp, "k2fs")
        t = Transfer(
            id="k2fs", type=TransferType.INCREMENT_ONLY,
            src=KafkaSourceParams(
                brokers=[f"127.0.0.1:{broker.port}"], topic="events",
                parser={"json": {"table": "events",
                                 "schema": REPL_SCHEMA}}),
            dst=FileTargetParams(path=out_dir, format="jsonl"),
            transformation=REPL_CONFIG)
        cp, stop = MemoryCoordinator(), threading.Event()
        want = {f"events:{p}": K2FS_MESSAGES - 1
                for p in range(K2FS_PARTITIONS)}
        failure = []

        def run():
            try:
                local_mod.run_replication(t, cp, stop_event=stop,
                                          device=dev)
            except BaseException as e:  # reported below
                failure.append(e)

        local_mod.PartitionedWorker = Recorded
        t0 = time.perf_counter()
        th = threading.Thread(target=run, name="k2fs", daemon=True)
        th.start()
        deadline = t0 + SHARD_SETTLE_S
        while cp.get_transfer_state("k2fs").get("kafka_offsets") != want \
                and not failure and time.perf_counter() < deadline:
            time.sleep(0.02)
        seconds = time.perf_counter() - t0
        stop.set()
        th.join(60)
        if failure or th.is_alive():
            raise AssertionError(f"k2fs: {failure or 'did not stop'}")
        if cp.get_transfer_state("k2fs").get("kafka_offsets") != want:
            raise AssertionError("k2fs: offsets never all committed")
    finally:
        local_mod.PartitionedWorker = real
        broker.stop()
    files = sorted(f for f in os.listdir(out_dir) if f.endswith(".jsonl"))
    rows = []
    for f in files:
        with open(os.path.join(out_dir, f)) as fh:
            rows.extend(json.loads(ln) for ln in fh)
    image = {}
    for p in range(K2FS_PARTITIONS):
        for i in range(K2FS_MESSAGES):
            k = p * K2FS_MESSAGES + i
            if k % 500 < 400:
                image[k] = {"id": k, "region": k % 500, "url": hmac.new(
                    REPL_SALT, f"https://bench.example/{i}".encode(),
                    hashlib.sha256).hexdigest(),
                    "_partition": f"events:{p}", "_offset": i}
    # each row with the parser's partition and offset columns
    got = {r["id"]: {c: r.get(c) for c in ("id", "region", "url",
                                           "_partition", "_offset")}
           for r in rows}
    if len(workers) != 1 or len(workers[0]._pipelines) != K2FS_PARTITIONS \
            or len(rows) != len(got) or got != image:
        raise AssertionError(
            f"k2fs: {len(workers)} partitioned workers, "
            f"{len(workers[0]._pipelines) if workers else 0} pipelines, "
            f"{len(rows)} rows ({len(got)} ids) of {len(image)} (equal "
            f"{got == image})")
    return {"messages": K2FS_PARTITIONS * K2FS_MESSAGES,
            "partitions": K2FS_PARTITIONS,
            "pipelines": len(workers[0]._pipelines), "files": len(files),
            "rows": len(rows), "seconds": seconds,
            "messages_per_s": K2FS_PARTITIONS * K2FS_MESSAGES / seconds}


def sharded_path(dev) -> dict:
    """Config #2 across processes on the filestore coordinator, a killed
    secondary, and Kafka -> fs partitioned replication; every launch of
    this process recorded and held against the plain versions."""
    import logging

    logging.basicConfig(level=logging.WARNING,
                        format="%(asctime)s %(levelname).1s %(name)s: "
                               "%(message)s")
    t0 = time.perf_counter()
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="sharded-", dir=str(_build.BUILD_DIR))
    pg = FakePG().start()
    set_placement("device")
    result: dict = {}
    runs = []
    try:
        pg.add_table(hits_table(SHARD_ROWS))
        pg.add_table(FakeTable("public", "events", PG2CH_COLUMNS,
                               cli_fake_rows(cli_events_row(i)
                                             for i in range(SHARD_EVENTS))))
        images = shard_images()
        want_fp = shard_plain_fingerprints(pg, images, dev)
        result["data_gen_seconds"] = time.perf_counter() - t0
        with KALaunches() as ka, PredLaunches() as preds, \
                KeyLaunches() as keyed, FingerprintDispatches() as fpd:
            _build.reset_launch_counts()
            # (a) three workers
            a = shard_run(pg, os.path.join(tmp, "cp-a"), tmp, "shard-a",
                          dev)
            runs.append(a)
            shard_check(a, images, want_fp, "(a)")
            idle = [j for j, w in a["workers"].items() if not w["parts"]]
            if idle:
                raise AssertionError(f"sharded (a): workers {idle} "
                                     f"committed no part: {a['workers']}")
            chk_yaml = os.path.join(tmp, "shard-a.yaml")
            argv = ["--coordinator", "filestore", "--coordinator-dir",
                    os.path.join(tmp, "cp-a"), "checksum", "--transfer",
                    chk_yaml, "--fingerprint-backend", "device",
                    "--against-operation", "op-shard-a"]
            rc_ok, so_ok, _, s_ok = cli_main(argv, dev)
            ch = a["ch"]
            with ch.lock:
                r0 = min(ch.tables["public__hits"]["rows"],
                         key=lambda r: r["id"])
                r0["score"] = r0["score"] + 0.5
            rc_bad, so_bad, _, s_bad = cli_main(argv, dev)
            if rc_ok != 0 or rc_bad != 1 or "MISMATCH" not in so_bad:
                raise AssertionError(
                    f"sharded checksum: clean rc {rc_ok} ({so_ok[-500:]}), "
                    f"altered rc {rc_bad} ({so_bad[-500:]})")
            a["checksum"] = {"clean_rc": rc_ok, "altered_rc": rc_bad,
                             "clean_seconds": s_ok,
                             "altered_seconds": s_bad,
                             "clean_report": so_ok.strip(),
                             "altered_report": so_bad.strip()}
            # the same YAML with one worker, for comparison
            one = shard_run(pg, os.path.join(tmp, "cp-1"), tmp, "shard-1",
                            dev, jobs=1)
            runs.append(one)
            shard_check(one, images, want_fp, "(a), one worker")
            # (b) job 2 killed holding a lease
            b = shard_run(pg, os.path.join(tmp, "cp-b"), tmp, "shard-b",
                          dev, kill=True)
            runs.append(b)
            shard_check(b, images, want_fp, "(b)")
            if not b["steals"]:
                raise AssertionError(f"sharded (b): no part stolen from "
                                     f"the killed worker: {b['workers']}")
            # (c) Kafka -> fs, one pipeline a partition
            result["k2fs"] = k2fs_run(tmp, dev)
            launches = _build.launch_counts()
            require_launched("sharded", launches)
            held = {"sha256_hmac": ka.check("sharded",
                                            launches["sha256_hmac"])}
            held.update(preds.check("sharded", launches))
            held["rowhash_lanes_keys"] = keyed.check("sharded", dev)
            held["rowhash_lanes_fingerprint"] = check_dispatched(
                {"sharded": {"dispatched": fpd.dispatched}}, dev)
        for name, run in (("a", a), ("one_worker", one), ("b", b)):
            run.pop("ch").stop()
            run.pop("target")
            run["fences"] = len(run["fences"])
            result[name] = run
        result.update(rows=SHARD_ROWS, events=SHARD_EVENTS,
                      part_bytes=SHARD_PART_BYTES, launches=launches,
                      held_exact=held,
                      speedup_3_over_1=a["rows_per_s"] / one["rows_per_s"])
        return result
    finally:
        set_placement(None)
        for run in runs:
            if "ch" in run:
                run.pop("ch").stop()
        pg.stop()
        shutil.rmtree(tmp, ignore_errors=True)


# -- phase 15l: s3 --------------------------------------------------------------

# ClickBench's partitioned release is 100 objects of about 1,000,000 rows;
# the 2,000,000 rows here are cut into 8 objects of 250,000 (131,072-row
# groups, SNAPPY), which gives (c)'s 3 jobs parts to share
S3_OBJECTS = 8
S3_BUCKET = "clickbench"
S3_URL = f"s3://{S3_BUCKET}/hits/*.parquet"
# (a) activates all 8 objects through the example, and checksums a
# transfer of the same YAML over the first 2 (500,000 rows): the
# checksum reads the fake ClickHouse's rows in Python, a minute and a
# half over all 2,000,000 on the H100 machine (PERF.md section 4)
S3_CHECKSUM_URL = f"s3://{S3_BUCKET}/hits/hits_0[01]*.parquet"
S3_CHECKSUM_OBJECTS = 2
S3_EXAMPLE = "clickbench_s3_parquet2ch.yaml"
S3_WORKERS = 8               # the example's runtime.process_count
S3_JOBS, S3_JOB_WORKERS = 3, 2
S3_AK, S3_SK = "chip-ak", "chip-sk"
S3_SETTLE_S = 300.0
S3_REPL_OBJECTS, S3_REPL_ROWS = 16, 4096
# (a)'s altered checksum runs over one object of the first 25,000 rows:
# on a keyless table the diagnostic after a digest mismatch loads both
# tables whole (ROADMAP.md C), about 40 s over 250,000 rows on the H100
# machine
S3_ALTERED_ROWS = 25_000
S3_SHARD_YAML = """\
# the headline sharded over processes through the bucket's coordinator
id: {tid}
type: SNAPSHOT_ONLY
src:
  type: s3
  params:
    url: "{url}"
    endpoint_url: "{endpoint}"
    format: parquet
    table: hits
    batch_rows: {batch_rows}
dst:
  type: ch
  params:
    host: 127.0.0.1
    port: {dst}
    database: default
    bufferer: null
    # every worker runs the activation's cleanup: a secondary starting
    # after the main's first publish must not drop it
    cleanup_policy: disabled
transformation:
  transformers:
    - mask_field: {{columns: [URL], salt: "{salt}"}}
    - filter_rows: {{filter: "{filt}"}}
runtime:
  job_count: {jobs}
  process_count: {workers}
"""


def s3_objects(rows, fake, tmp: str) -> dict:
    """bench.py's rows as S3_OBJECTS Parquet objects under hits/ (laid
    out as write_clickbench lays out its file)."""
    t0 = time.perf_counter()
    per = ROWS // S3_OBJECTS
    sizes, kept = [], 0
    path = os.path.join(tmp, "object.parquet")
    for i in range(S3_OBJECTS):
        size, k = write_clickbench(path, per, rows=slice_rows(
            rows, i * per, (i + 1) * per))
        with open(path, "rb") as fh:
            fake.put_object(f"hits/hits_{i:02d}.parquet", fh.read())
        sizes.append(size)
        kept += k
    write_clickbench(path, S3_ALTERED_ROWS,
                     rows=slice_rows(rows, 0, S3_ALTERED_ROWS))
    with open(path, "rb") as fh:
        fake.put_object("cut/hits.parquet", fh.read())
    os.unlink(path)
    return {"objects": S3_OBJECTS, "rows_per_object": per,
            "bytes": sum(sizes), "kept": kept,
            "write_seconds": time.perf_counter() - t0}


def ch_on_8123() -> FakeCH:
    """A fake ClickHouse on port 8123, which the example YAML names, on
    the first loopback address where that port is free."""
    for last in range(2, 255):
        try:
            return FakeCH().start(host=f"127.0.0.{last}", port=8123)
        except OSError:
            continue
    raise AssertionError("no loopback address has port 8123 free")


def cli_process(argv: list, env: dict, log: str, dev,
                timeout: float) -> tuple[int, float]:
    """The port's CLI as a user runs it, in a process of its own: (exit
    code, seconds); its output goes to the file `log`."""
    t0 = time.perf_counter()
    with open(log, "w") as fh:
        proc = subprocess.run(
            [sys.executable, "-m", "transferia_tpu_torch.cli.main",
             "--device", str(dev.type), "--log-level", "warning"] + argv,
            stdout=fh, stderr=subprocess.STDOUT, timeout=timeout,
            env=dict(os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parent), **env))
    return proc.returncode, time.perf_counter() - t0


def s3_yaml(tmp: str, name: str, endpoint: str) -> str:
    """A copy of examples/clickbench_s3_parquet2ch.yaml with one line
    added: the fake's endpoint_url."""
    text = (Path(__file__).resolve().parent / "examples"
            / S3_EXAMPLE).read_text()
    anchor = "    batch_rows: 131072\n"
    if text.count(anchor) != 1:
        raise AssertionError(f"{S3_EXAMPLE}: no single {anchor!r} line")
    path = os.path.join(tmp, name)
    with open(path, "w") as fh:
        fh.write(text.replace(anchor, anchor + f'    endpoint_url: '
                                               f'"{endpoint}"\n'))
    return path


def s3_example(fake, objects: dict, tmp: str, dev) -> dict:
    """(a) examples/clickbench_s3_parquet2ch.yaml as shipped, with only
    `endpoint_url` added: validate and activate of all the objects in
    processes of the CLI, reading the bucket anonymously, into a fake
    ClickHouse on CH_HOST:8123, which must hold every row.  Then, in this
    process, the same YAML over the first S3_CHECKSUM_OBJECTS objects
    into a second fake and checksum by K10 (exit 0: every row of the
    objects is in ClickHouse once, by the order-independent digest over
    every column), and over an object of S3_ALTERED_ROWS rows in a third
    with a value altered (exit 1)."""
    path = s3_yaml(tmp, S3_EXAMPLE, fake.endpoint)
    chs = [ch_on_8123()]
    env = {"HITS_URL": S3_URL, "CH_HOST": chs[0]._srv.server_address[0]}
    saved = {k: os.environ.get(k) for k in env}
    out = {"ch_host": env["CH_HOST"]}
    try:
        for cmd in ("validate", "activate"):
            log = os.path.join(tmp, f"a-{cmd}.log")
            rc, s = cli_process([cmd, "--transfer", path], env, log, dev,
                                S3_SETTLE_S)
            out[cmd] = {"rc": rc, "seconds": s, "log": log_tail(log, 600)}
            if rc != 0:
                raise AssertionError(f"s3 (a) {cmd}: rc {rc}: "
                                     f"{log_tail(log)}")
        rows = objects["objects"] * objects["rows_per_object"]
        out.update(url=S3_URL, rows=rows,
                   activate_rows_per_s=rows / out["activate"]["seconds"],
                   ch_rows=chs[0].total_rows(),
                   fences=len(chs[0].rows("__trtpu_commits")))
        if out["ch_rows"] != rows or out["fences"] != objects["objects"]:
            raise AssertionError(f"s3 (a): ClickHouse holds "
                                 f"{out['ch_rows']} rows in "
                                 f"{out['fences']} parts, the objects "
                                 f"{rows} in {objects['objects']}")
        chs.pop().stop()
        checks = {}
        for name, url, rows in (
                ("clean", S3_CHECKSUM_URL,
                 S3_CHECKSUM_OBJECTS * objects["rows_per_object"]),
                ("altered", f"s3://{S3_BUCKET}/cut/hits.parquet",
                 S3_ALTERED_ROWS)):
            chs.append(ch_on_8123())
            os.environ.update({"HITS_URL": url,
                               "CH_HOST": chs[-1]._srv.server_address[0]})
            rc, _, se, s_act = cli_main(["activate", "--transfer", path],
                                        dev)
            if rc != 0 or chs[-1].total_rows() != rows:
                raise AssertionError(f"s3 (a) {name} activation: rc {rc}, "
                                     f"{chs[-1].total_rows()} rows of "
                                     f"{rows}: {se[-500:]}")
            if name == "altered":
                ch = chs[-1]
                with ch.lock:
                    r0 = min(ch.tables["s3__hits"]["rows"],
                             key=lambda r: r["WatchID"])
                    r0["RegionID"] = r0["RegionID"] + 1
            rc, so, _, s_sum = cli_main(
                ["checksum", "--transfer", path, "--method", "fingerprint",
                 "--fingerprint-backend", "device"], dev)
            checks[name] = {"url": url, "rows": rows, "rc": rc,
                            "activate_seconds": s_act, "seconds": s_sum,
                            "report": so.strip()[-300:]}
        if checks["clean"]["rc"] != 0 or checks["altered"]["rc"] != 1 or \
                "MISMATCH" not in checks["altered"]["report"]:
            raise AssertionError(f"s3 (a) checksum: {checks}")
        out["checksum"] = checks
        return out
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for ch in chs:
            ch.stop()


class RowhashLaunches:
    """Records each launch of K10 (`rowhash.rowhash_lanes` on the card,
    in keys or reduce mode) and of `trt_var_accumulators` during a run,
    from any call site and thread, with its inputs and what it wrote, to
    hold every one against its plain version afterwards.  A launch in
    reduce mode is held by the accumulator it leaves against the one it
    found plus the plain version's sums and xors."""

    def __enter__(self):
        self.lanes, self.accs = [], []
        self._real = real_lanes, real_accs = (rowhash.rowhash_lanes,
                                              rowhash.var_accumulators)
        lanes, accs = self.lanes, self.accs

        def record_lanes(cols, n, acc=None):
            before = None if acc is None else acc.clone()
            out = real_lanes(cols, n, acc)
            if n and (out[0] if acc is None else acc).is_cuda:
                lanes.append((list(cols), n, before,
                              out if acc is None else acc.clone()))
            return out

        def record_accs(data, offsets):
            out = real_accs(data, offsets)
            if data.is_cuda and offsets.numel() > 1:
                accs.append((data, offsets, out))
            return out

        rowhash.rowhash_lanes = record_lanes
        rowhash.var_accumulators = record_accs
        return self

    def __exit__(self, *exc):
        rowhash.rowhash_lanes, rowhash.var_accumulators = self._real
        return False

    def check(self, what: str, launches: dict) -> dict:
        """Every recorded launch against its plain version on the card;
        fails unless as many launches were held as the run counted."""
        for i, (cols, n, before, got) in enumerate(self.lanes):
            p1, p2 = rowhash.rowhash_lanes_plain(cols, n)
            if before is None:
                same = torch.equal(rowhash._to_u32(got[0]), p1) and \
                    torch.equal(rowhash._to_u32(got[1]), p2)
            else:
                want = before.clone()
                rowhash._reduce_into(want, p1, p2)
                same = torch.equal(want, got)
            if not same:
                raise AssertionError(f"{what}: K10's launch {i} ({n} rows, "
                                     f"{'keys' if before is None else 'reduce'}"
                                     " mode) differs from the plain version")
        for i, (data, offsets, got) in enumerate(self.accs):
            want = rowhash._var_accs_host(data, offsets)
            if not (torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1])):
                raise AssertionError(f"{what}: trt_var_accumulators' launch "
                                     f"{i} ({offsets.numel() - 1} values) "
                                     "differs from the plain version")
        held = {"rowhash_lanes": len(self.lanes),
                "var_accumulators": len(self.accs)}
        for k, n in held.items():
            if n != launches[k]:
                raise AssertionError(f"{what}: {n} launches of {k} held, "
                                     f"{launches[k]} counted")
        return held


S3_STAGES = ("s3_request", "s3_range_get", "source_decode", "pivot",
             "pack", "device_dispatch", "device_wait", "sink", "sink_stage",
             "sink_publish")


def s3_headline_run(fake, placement: str, dev) -> dict:
    """(b) one run of the headline: the bucket's objects through bench.py's
    chain into a fresh fake ClickHouse, staged commits on, traced."""
    on_card = placement == "device"
    run_dev = dev if on_card else torch.device("cpu")
    ch = FakeCH().start()
    # one id for both placements and (c): equal part keys, so equal
    # tables land byte-identical inserts (FakeCH.insert_digests)
    tid = "s3-b"
    t = Transfer(id=tid, src=S3SourceParams(
        url=S3_URL, endpoint_url=fake.endpoint, table="hits",
        batch_rows=BATCH_ROWS),
        dst=CHTargetParams(host="127.0.0.1", port=ch.port, bufferer=None),
        transformation=CONFIG,
        runtime=Runtime(sharding=ShardingUploadParams(
            process_count=S3_WORKERS)))
    cp = MemoryCoordinator()
    gets0 = (fake.range_gets, fake.range_bytes)
    set_placement("device" if on_card else "host")
    trace_on()
    t0 = time.perf_counter()
    try:
        SnapshotLoader(t, cp, device=run_dev).upload_tables()
        _sync(dev)
    finally:
        seconds = time.perf_counter() - t0
        tables = trace_off(seconds)
        set_placement(None)
    parts = cp.operation_parts(f"op-{tid}")
    if len(parts) != S3_OBJECTS or not all(
            p.completed and p.commit_epoch == p.assignment_epoch
            for p in parts):
        ch.stop()
        raise AssertionError(f"s3 (b) {placement}: parts {parts}")
    summary = tables["stage_summary"]
    return {"ch": ch, "seconds": seconds, "rows_per_s": ROWS / seconds,
            "parts_discovered": len(parts),
            "range_gets": fake.range_gets - gets0[0],
            "range_bytes": fake.range_bytes - gets0[1],
            "fences": len(ch.rows("__trtpu_commits")),
            "stages": {k: {m: summary["stages"][k][m] for m in
                           ("calls", "total_s", "self_s", "bytes")}
                       for k in S3_STAGES if k in summary["stages"]},
            "overlap": summary.get("overlap"),
            "stage_breakdown": tables["stage_breakdown"]}


def s3_sharded(fake, tmp: str, inserts: list, dev) -> dict:
    """(c) (b)'s transfer with job_count 3 over --coordinator s3 on the
    same fake: job 0 here through cli.main, jobs 1 and 2 as CLI
    processes started first and polled on their health ports."""
    ch = FakeCH().start()
    tid, prefix = "s3-b", "s3-shard"
    path = os.path.join(tmp, f"{prefix}.yaml")
    with open(path, "w") as fh:
        fh.write(S3_SHARD_YAML.format(
            tid=tid, url=S3_URL, endpoint=fake.endpoint,
            batch_rows=BATCH_ROWS, dst=ch.port, salt=CONFIG["transformers"][
                0]["mask_field"]["salt"],
            filt=CONFIG["transformers"][1]["filter_rows"]["filter"],
            jobs=S3_JOBS, workers=S3_JOB_WORKERS))
    argv = ["--coordinator", "s3", "--coordinator-bucket", "coord",
            "--coordinator-endpoint", fake.endpoint,
            "--coordinator-prefix", prefix]
    env = {"AWS_ACCESS_KEY_ID": S3_AK, "AWS_SECRET_ACCESS_KEY": S3_SK}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    procs, logs, ports = {}, {}, {}
    try:
        t0 = time.perf_counter()
        for job in range(1, S3_JOBS):
            ports[job] = free_port()
            logs[job] = os.path.join(tmp, f"{prefix}.job{job}.log")
            procs[job] = shard_worker(job, argv, path, ports[job], dev, env,
                                      logs[job])
        deadline = time.perf_counter() + S3_SETTLE_S
        for job, proc in procs.items():
            wait_up(ports[job], proc, logs[job], deadline)
        up = time.perf_counter() - t0
        rc, _, se, main_s = cli_main(argv + ["--job-index", "0", "activate",
                                             "--transfer", path], dev)
        if rc != 0:
            raise AssertionError(f"s3 (c) job 0: rc {rc}: {se[-2000:]}")
        for job, proc in procs.items():
            proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
            if proc.returncode != 0:
                raise AssertionError(f"s3 (c) job {job}: rc "
                                     f"{proc.returncode}: "
                                     f"{log_tail(logs[job])}")
        wall = time.perf_counter() - t0
        cp = S3Coordinator(bucket="coord", endpoint=fake.endpoint,
                           prefix=prefix)
        parts = cp.operation_parts(f"op-{tid}")
        fences = [r["part_key"] for r in ch.rows("__trtpu_commits")]
        workers = {j: sum(1 for p in parts if p.worker_index == j)
                   for j in range(S3_JOBS)}
        if len(parts) != S3_OBJECTS or not all(
                p.completed and p.commit_epoch == p.assignment_epoch
                for p in parts) or len(set(fences)) != len(fences) or \
                len(fences) != len(parts):
            raise AssertionError(f"s3 (c): parts {parts}, fences {fences}")
        if sum(1 for n in workers.values() if n) < 2:
            raise AssertionError(f"s3 (c): parts not split: {workers}")
        got = ch.insert_digests("s3__hits")
        if got != inserts:
            raise AssertionError(f"s3 (c): {len(got)} inserts of "
                                 f"{sum(g[1] for g in got)} rows, (b) "
                                 f"{len(inserts)} of "
                                 f"{sum(g[1] for g in inserts)}")
        return {"jobs": S3_JOBS, "workers_a_job": S3_JOB_WORKERS,
                "workers_up_seconds": up, "main_seconds": main_s,
                "wall_seconds": wall, "rows_per_s": ROWS / wall,
                "rows_per_s_after_up": ROWS / (wall - up),
                "parts_by_worker": workers, "fences": len(fences),
                "rows": sum(g[1] for g in got), "inserts": len(got),
                "worker_logs": {j: log_tail(f, 400)
                                for j, f in logs.items()}}
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(30)
        ch.stop()


def s3_repl_object(o: int) -> bytes:
    """Object o of (d): S3_REPL_ROWS JSON lines."""
    return b"".join(json.dumps({
        "id": o * S3_REPL_ROWS + i, "url": f"https://bench.example/{i}",
        "region": (o * S3_REPL_ROWS + i) % 500}).encode() + b"\n"
        for i in range(S3_REPL_ROWS))


def s3_repl_image() -> dict:
    """REPL_CONFIG's mask and filter over the objects' rows, by id."""
    image = {}
    for o in range(S3_REPL_OBJECTS):
        for i in range(S3_REPL_ROWS):
            k = o * S3_REPL_ROWS + i
            if k % 500 < 400:
                image[k] = (k, hmac.new(
                    REPL_SALT, f"https://bench.example/{i}".encode(),
                    hashlib.sha256).hexdigest(), k % 500)
    return image


def s3_repl_run(fake, kind: str, dev) -> dict:
    """(d) one replication run: S3_REPL_OBJECTS jsonl objects land under
    in-<kind>/ while the source runs (poll: its listing; sqs: their
    creation events through the fake SQS) and go through REPL_CONFIG into
    a fresh fake ClickHouse; stopped once every object is committed."""
    from transferia_tpu_torch.recipes.fake_sqs import FakeSQS
    from transferia_tpu_torch.runtime import local as local_mod

    ch = FakeCH().start()
    sqs = FakeSQS(access_key=S3_AK).start() if kind == "sqs" else None
    prefix = f"in-{kind}"
    extra = dict(event_source="poll", poll_interval=0.05) if sqs is None \
        else dict(event_source="sqs", sqs_queue_url=sqs.queue_url,
                  sqs_access_key=S3_AK, sqs_secret_key=S3_SK,
                  sqs_wait_seconds=0)
    t = Transfer(id=f"s3-repl-{kind}", type=TransferType.INCREMENT_ONLY,
                 src=S3SourceParams(
                     url=f"s3://{S3_BUCKET}/{prefix}/*.jsonl",
                     endpoint_url=fake.endpoint, format="jsonl",
                     table="events", batch_rows=S3_REPL_ROWS, **extra),
                 dst=CHTargetParams(host="127.0.0.1", port=ch.port,
                                    bufferer=None),
                 transformation=REPL_CONFIG)
    cp, stop, failure = MemoryCoordinator(), threading.Event(), []

    def run():
        try:
            local_mod.run_replication(t, cp, stop_event=stop, device=dev)
        except BaseException as e:  # reported below
            failure.append(e)

    th = threading.Thread(target=run, name=f"s3-repl-{kind}", daemon=True)
    try:
        t0 = time.perf_counter()
        th.start()
        for o in range(S3_REPL_OBJECTS):
            key = f"{prefix}/o{o:02d}.jsonl"
            fake.put_object(key, s3_repl_object(o))
            if sqs is not None:
                sqs.send_s3_event(key, bucket=S3_BUCKET)
        last = f"{S3_BUCKET}/{prefix}/o{S3_REPL_OBJECTS - 1:02d}.jsonl"
        deadline = t0 + S3_SETTLE_S

        def settled() -> bool:
            if sqs is not None:
                return len(sqs.deleted) == S3_REPL_OBJECTS
            return last in cp.get_transfer_state(t.id).get(
                "s3_poll_watermark", {}).get("names", [])

        while not settled() and not failure and \
                time.perf_counter() < deadline:
            time.sleep(0.02)
        seconds = time.perf_counter() - t0
        stop.set()
        th.join(60)
        if failure or th.is_alive() or not settled():
            raise AssertionError(f"s3 (d) {kind}: "
                                 f"{failure or 'did not settle or stop'}")
        got = [(int(r["id"]), r["url"].decode() if isinstance(
            r["url"], bytes) else r["url"], int(r["region"]))
            for r in ch.rows("s3__events")]
        image = s3_repl_image()
        if len(got) != len(image) or {r[0]: r for r in got} != image:
            raise AssertionError(f"s3 (d) {kind}: {len(got)} rows, the "
                                 f"image {len(image)}")
        rows = S3_REPL_OBJECTS * S3_REPL_ROWS
        return {"objects": S3_REPL_OBJECTS, "rows": rows,
                "delivered": len(got), "seconds": seconds,
                "rows_per_s": rows / seconds,
                "sqs_left": len(sqs.queue) if sqs is not None else None}
    finally:
        stop.set()
        ch.stop()
        if sqs is not None:
            sqs.stop()


def s3_staged_snapshot(fake, dev) -> dict:
    """(d) the poll run's objects snapshotted through the staged jsonl sink
    into s3://clickbench/out, one sink push torn (half its rows land, then
    it fails and the Retrier pushes it again): the stage's dedup window
    (K10 keys) drops the landed half, so exactly one copy is published."""
    t = Transfer(id="s3-staged", src=S3SourceParams(
        url=f"s3://{S3_BUCKET}/in-poll/*.jsonl", endpoint_url=fake.endpoint,
        format="jsonl", table="events", batch_rows=S3_REPL_ROWS),
        dst=S3TargetParams(url=f"s3://{S3_BUCKET}/out", format="jsonl",
                           endpoint_url=fake.endpoint, access_key=S3_AK,
                           secret_key=S3_SK),
        transformation=REPL_CONFIG)
    cp = MemoryCoordinator()
    # fires on the first push of two rows or more: a data batch
    failpoints.configure("sink.push.torn=times:1,truncate:0.5")
    try:
        t0 = time.perf_counter()
        SnapshotLoader(t, cp, device=dev).upload_tables()
        seconds = time.perf_counter() - t0
        fired = failpoints.fire_log().get("sink.push.torn", [])
    finally:
        failpoints.reset()
    rows, staged = [], []
    for key, (body, _) in list(fake.objects.items()):
        if key.startswith("out/.staging/") and not key.startswith(
                "out/.staging/.published."):
            staged.append(key)
        elif key.startswith("out/") and not key.startswith("out/.staging/"):
            rows.extend(json.loads(ln) for ln in body.decode().splitlines())
    image = s3_repl_image()
    got = {r["id"]: (r["id"], r["url"], r["region"]) for r in rows}
    if len(fired) != 1 or staged or len(rows) != len(image) or \
            got != image:
        raise AssertionError(f"s3 (d) staged: fired {fired}, staged left "
                             f"{staged}, {len(rows)} rows ({len(got)} ids) "
                             f"of {len(image)}")
    parts = cp.operation_parts("op-s3-staged")
    return {"parts": len(parts), "rows": len(rows), "seconds": seconds,
            "torn_fired_at": fired,
            "markers": sum(1 for k in fake.objects
                           if k.startswith("out/.staging/.published."))}


def s3_path(rows, dev, keep: Optional[dict] = None) -> dict:
    """BASELINE config #3 from object storage: (a) its YAML through the
    CLI, (b) bench.py's chain on the card and on the CPU, (c) sharded
    through the S3 coordinator, (d) object replication by poll and SQS
    and a staged jsonl snapshot into a bucket; every launch of this
    process held against the plain versions.  With `keep`, the fake S3
    and its objects outlive the phase in keep["fake"] and
    keep["objects"] (the fleet phase reads them; it stops the fake)."""
    import logging

    logging.basicConfig(level=logging.WARNING,
                        format="%(asctime)s %(levelname).1s %(name)s: "
                               "%(message)s")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="s3-", dir=str(_build.BUILD_DIR))
    fake = FakeS3(access_key=S3_AK, public_read=True).start()
    result: dict = {}
    timings: dict = {}
    runs = []
    try:
        t0 = time.perf_counter()
        result["data"] = s3_objects(rows, fake, tmp)
        timings["data"] = time.perf_counter() - t0
        with KALaunches() as ka, PredLaunches() as preds, \
                RowhashLaunches() as k10:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            result["a"] = s3_example(fake, result["data"], tmp, dev)
            timings["a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            b = {}
            for placement in ("device", "cpu"):
                run = s3_headline_run(fake, placement, dev)
                runs.append(run)
                b[placement] = run
            inserts = {p: r["ch"].insert_digests("s3__hits")
                       for p, r in b.items()}
            kept = result["data"]["kept"]
            rows_in = {p: sum(g[1] for g in d) for p, d in inserts.items()}
            if rows_in["device"] != kept or \
                    inserts["device"] != inserts["cpu"]:
                raise AssertionError(
                    f"s3 (b): card {rows_in['device']} rows, cpu "
                    f"{rows_in['cpu']}, write_clickbench keeps {kept} "
                    f"(inserts equal {inserts['device'] == inserts['cpu']})")
            timings["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result["c"] = s3_sharded(fake, tmp, inserts["device"], dev)
            timings["c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result["d"] = {"poll": s3_repl_run(fake, "poll", dev),
                           "sqs": s3_repl_run(fake, "sqs", dev),
                           "staged": s3_staged_snapshot(fake, dev)}
            timings["d"] = time.perf_counter() - t0
            launches = _build.launch_counts()
            require_launched("s3", launches)
            t0 = time.perf_counter()
            held = {"sha256_hmac": ka.check("s3", launches["sha256_hmac"])}
            held.update(preds.check("s3", launches))
            held.update(k10.check("s3", launches))
            timings["held"] = time.perf_counter() - t0
        result["b"] = {}
        for placement, run in b.items():
            run.pop("ch").stop()
            run["kept"] = kept
            result["b"][placement] = run
        result.update(launches=launches, held_exact=held,
                      part_seconds=timings, rows=ROWS)
        return result
    finally:
        for run in runs:
            if "ch" in run:
                run.pop("ch").stop()
        if keep is not None and "data" in result:
            keep.update(fake=fake, objects=result["data"])
        else:
            fake.stop()
        shutil.rmtree(tmp, ignore_errors=True)


FLEET_QUEUE = "fleet"
FLEET_TENANTS = 4
FLEET_SUBPROCS = 2           # workers 1 and 2; worker 0 runs here
FLEET_LEASE_S = 3.0          # ticket and part leases (the kill's reclaim)
FLEET_HEARTBEAT_S = 0.5
FLEET_IDLE_EXIT_S = 6.0
FLEET_SETTLE_S = 300.0
FLEET_SALT = "bench-salt"    # bench.py's chain (CONFIG)
FLEET_YAML = """\
# one ClickBench object through bench.py's chain: a fleet ticket's transfer
id: {tid}
type: SNAPSHOT_ONLY
src:
  type: s3
  params:
    url: "{url}"
    endpoint_url: "{endpoint}"
    format: parquet
    table: hits
    batch_rows: {batch_rows}
dst:
  type: ch
  params:
    host: 127.0.0.1
    port: {dst}
    database: default
    bufferer: null
transformation:
  transformers:
    - mask_field: {{columns: [URL], salt: "{salt}"}}
    - filter_rows: {{filter: "RegionID < 400 AND ResolutionWidth >= 390"}}
runtime:
  process_count: 1
"""
# the compaction ticket's store: a base and FLEET_MVCC_LAYERS deltas of
# inserts, updates and deletes over it
FLEET_MVCC_BASE, FLEET_MVCC_LAYERS, FLEET_MVCC_DELTA = 200_000, 6, 20_000


def fleet_bench_part(dev) -> dict:
    """(a) `trtpu fleet bench` at its defaults (fleet/bench.py: 120
    transfers of 256 sample rows over 8 workers x 2 lanes, seed 7, the
    10:1 tenant skew) with the transfers on the card."""
    from transferia_tpu_torch.fleet.bench import run_fleet_bench

    report = run_fleet_bench(device=dev)
    if not report["ok"] or report["lost"] or report["row_mismatches"] \
            or report["double_admissions"] or report["jain_fairness"] < 0.9 \
            or report["completed"] != report["transfers"]:
        raise AssertionError(f"fleet (a): {report}")
    return {k: report[k] for k in (
        "transfers", "workers", "lanes_per_worker", "rows_per_transfer",
        "seed", "completed", "failed", "shed", "lost", "double_admissions",
        "jain_fairness", "dispatch_p50_ms", "dispatch_p99_ms",
        "dispatch_hdr_p99_ms", "pick_p99_us", "wall_seconds", "value",
        "desired_workers_final")}


def fleet_expected(rows, i: int, per: int) -> tuple[np.ndarray, dict]:
    """numpy's image of object i after the chain: the kept WatchIDs,
    sorted, and each kept row's URL by WatchID."""
    _, fixed, var = slice_rows(rows, i * per, (i + 1) * per)
    keep = (fixed["RegionID"] < 400) & (fixed["ResolutionWidth"] >= 390)
    data, offsets = var["URL"]
    urls = {int(w): bytes(data[offsets[j]:offsets[j + 1]])
            for j, w in zip(np.flatnonzero(keep), fixed["WatchID"][keep])}
    return np.sort(fixed["WatchID"][keep]), urls


def fleet_target_check(ch: FakeCH, rows, i: int, per: int,
                       full: bool) -> dict:
    """ClickHouse after a ticket: one fence row, no staging table left,
    numpy's count of rows; with `full`, numpy's WatchIDs each once and
    every URL the HMAC of the source's (hmac)."""
    want_ids, urls = fleet_expected(rows, i, per)
    fences = ch.rows("__trtpu_commits")
    staging = sorted(n for n in ch.tables
                     if n.startswith("__trtpu") and n != "__trtpu_commits")
    out = {"rows": ch.total_rows(), "kept": len(want_ids),
           "fences": len(fences), "staging_left": staging}
    if out["rows"] != len(want_ids) or len(fences) != 1 or staging:
        raise AssertionError(f"fleet (b) object {i}: {out}")
    if full:
        got = ch.rows("s3__hits")
        ids = np.sort(np.array([int(r["WatchID"]) for r in got],
                               dtype=np.int64))
        if not np.array_equal(ids, want_ids):
            raise AssertionError(f"fleet (b) object {i}: ClickHouse's "
                                 f"WatchIDs differ from numpy's")
        key = FLEET_SALT.encode()
        for r in got:
            url = r["URL"].decode() if isinstance(r["URL"], bytes) \
                else r["URL"]
            want = hmac.new(key, urls[int(r["WatchID"])],
                            hashlib.sha256).hexdigest()
            if url != want:
                raise AssertionError(f"fleet (b) object {i}: WatchID "
                                     f"{r['WatchID']} masked {url!r}, "
                                     f"hmac {want!r}")
        out["checked_rows"] = len(got)
    return out


def fleet_worker_proc(index: int, root: str, log: str, dev,
                      env: dict) -> subprocess.Popen:
    """`trtpu worker` as a user runs it, in a process of its own."""
    with open(log, "w") as fh:
        return subprocess.Popen(
            [sys.executable, "-m", "transferia_tpu_torch.cli.main",
             "--device", str(dev.type), "--log-level", "warning",
             "--coordinator", "filestore", "--coordinator-dir", root,
             "worker", "--queue", FLEET_QUEUE, "--worker-index", str(index),
             "--heartbeat", str(FLEET_HEARTBEAT_S),
             "--idle-exit", str(FLEET_IDLE_EXIT_S)],
            stdout=fh, stderr=subprocess.STDOUT, env=env)


def fleet_distributed(rows, fake, objects: dict, tmp: str, dev) -> dict:
    """(b) 8 transfer_yaml tickets (one ClickBench object each, 4 tenants,
    BATCH and SCAVENGER) on a filestore queue, drained by worker 0 here
    and workers 1-2 as `worker` processes; an INTERACTIVE ticket revokes
    worker 0's first BATCH ticket once its part is committed, and worker
    2 is SIGKILLed holding a ticket."""
    from transferia_tpu_torch.abstract.ticket import FleetTicket
    from transferia_tpu_torch.coordinator import FileStoreCoordinator
    from transferia_tpu_torch.fleet.distributed import (
        DistributedFleetScheduler,
    )
    from transferia_tpu_torch.fleet.worker import FleetWorker
    from transferia_tpu_torch.stats import fleetobs

    per = objects["rows_per_object"]
    root = os.path.join(tmp, "queue")
    cp = FileStoreCoordinator(root=root)
    sched = DistributedFleetScheduler(cp, queue=FLEET_QUEUE)
    chs, procs, out = {}, {}, {}
    env = dict(os.environ, TRANSFERIA_TPU_PLACEMENT="device",
               TRANSFERIA_TPU_TRACE="1",
               PYTHONPATH=str(Path(__file__).resolve().parent))

    def ticket(i: int, obj: int, tenant: str, qos: str) -> FleetTicket:
        ch = chs[i] = FakeCH().start()
        path = os.path.join(tmp, f"fleet-{i}.yaml")
        with open(path, "w") as fh:
            fh.write(FLEET_YAML.format(
                tid=f"fleet-{i}", url=f"s3://{S3_BUCKET}/hits/"
                f"hits_{obj:02d}.parquet", endpoint=fake.endpoint,
                batch_rows=BATCH_ROWS, dst=ch.port, salt=FLEET_SALT))
        return FleetTicket(ticket_id=f"fleet-{i}", transfer_id=f"fleet-{i}",
                           tenant=tenant, qos=qos,
                           payload={"kind": "transfer_yaml", "path": path})

    worker = None
    try:
        t0 = time.perf_counter()
        for index in range(1, 1 + FLEET_SUBPROCS):
            log = os.path.join(tmp, f"worker-{index}.log")
            procs[index] = (fleet_worker_proc(index, root, log, dev, env),
                            log)
        # both processes up (their idle heartbeats in the queue's health
        # scope) before a ticket exists, so all three workers race for
        # the tickets
        deadline = time.perf_counter() + FLEET_SETTLE_S
        while set(cp.get_operation_health(f"fleet:{FLEET_QUEUE}")) < \
                set(procs):
            for index, (proc, log) in procs.items():
                if proc.poll() is not None:
                    raise AssertionError(f"fleet worker {index} exited: "
                                         f"rc {proc.returncode}: "
                                         f"{log_tail(log)}")
            if time.perf_counter() > deadline:
                raise AssertionError("fleet workers never came up")
            time.sleep(0.1)
        out["workers_up_seconds"] = time.perf_counter() - t0
        for i in range(S3_OBJECTS):
            decision = sched.submit(ticket(
                i, i, f"tenant-{i % FLEET_TENANTS}",
                "batch" if i % 2 == 0 else "scavenger"))
            if decision != "admitted":
                raise AssertionError(f"fleet (b) ticket {i}: {decision}")
        inter = S3_OBJECTS
        preempt: dict = {}

        def hook(t: FleetTicket, boundary: int) -> None:
            """Worker 0's first BATCH ticket, at the first part boundary
            after its part committed: an INTERACTIVE arrival revokes
            it, and the boundary waits until the worker has seen the
            revoke (its heartbeat's renewal), so it yields there."""
            if preempt or t.qos != "batch":
                return
            parts = cp.operation_parts(f"op-{t.transfer_id}")
            if not parts or not all(p.completed for p in parts):
                return
            preempt.update(victim=t.ticket_id, boundary=boundary,
                           parts_committed=len(parts))
            arrival = ticket(inter, 0, "tenant-0", "interactive")
            if sched.submit(arrival) != "admitted":
                raise AssertionError("fleet (b): the INTERACTIVE ticket "
                                     "was not admitted")
            # the decision over the victim and the arrival as queued (a
            # peer may claim the arrival before this list is read)
            (held,) = [x for x in cp.list_tickets(FLEET_QUEUE)
                       if x.ticket_id == t.ticket_id]
            arrival.state, arrival.seq = "queued", S3_OBJECTS
            preempt["revoked"] = sched.preempt_if_needed([held, arrival])
            limit = time.perf_counter() + 30.0
            while not worker._revoked:
                if time.perf_counter() > limit:
                    raise AssertionError("fleet (b): the revoke never "
                                         "reached worker 0")
                time.sleep(0.01)

        set_placement("device")
        worker = FleetWorker(cp, queue=FLEET_QUEUE, worker_index=0,
                             heartbeat_interval=FLEET_HEARTBEAT_S,
                             part_boundary_hook=hook, device=dev)
        stop = threading.Event()
        th = threading.Thread(target=worker.run, args=(stop,),
                              name="fleet-w0", daemon=True)
        th.start()
        # worker 2 dies holding a ticket, after its first segment
        victim_proc, _ = procs[2]
        killed = None
        while killed is None and time.perf_counter() < deadline:
            held = [x for x in cp.list_tickets(FLEET_QUEUE)
                    if x.state == "claimed" and x.claimed_by == "w2"]
            segs = {sg["worker"].split(".")[1]
                    for sg in cp.list_obs_segments(fleetobs.default_scope())
                    if sg.get("worker", "").startswith("fleet.")}
            if held and "w2" in segs:
                victim_proc.kill()
                victim_proc.wait(timeout=60)
                killed = {"ticket": held[0].ticket_id,
                          "epoch": held[0].claim_epoch,
                          "at_seconds": time.perf_counter() - t0}
            elif victim_proc.poll() is not None:
                raise AssertionError("fleet worker 2 exited before it "
                                     "held a ticket")
            else:
                time.sleep(0.05)
        if killed is None:
            raise AssertionError("fleet worker 2 never held a ticket")
        out["killed"] = killed
        n = S3_OBJECTS + 1
        while time.perf_counter() < deadline:
            ts = cp.list_tickets(FLEET_QUEUE)
            if len(ts) == n and all(x.terminal for x in ts):
                break
            if not th.is_alive():
                raise AssertionError("fleet worker 0 stopped early")
            time.sleep(0.1)
        else:
            raise AssertionError(f"fleet (b): tickets not drained: "
                                 f"{[(x.ticket_id, x.state) for x in ts]}")
        out["drain_seconds"] = time.perf_counter() - t0
        worker.request_drain()
        stop.set()
        th.join(timeout=60)
        set_placement(None)
        rcs = {}
        for index, (proc, log) in procs.items():
            rcs[index] = proc.wait(timeout=FLEET_SETTLE_S)
            if index != 2 and rcs[index] != 0:
                raise AssertionError(f"fleet worker {index}: rc "
                                     f"{rcs[index]}: {log_tail(log)}")
        out["worker_rcs"] = rcs
        tickets = {x.ticket_id: x for x in cp.list_tickets(FLEET_QUEUE)}
        bad = [x.ticket_id for x in tickets.values()
               if x.state != "done" or x.error]
        if bad or not preempt.get("revoked"):
            raise AssertionError(f"fleet (b): tickets {bad} not done, "
                                 f"preemption {preempt}")
        victim = tickets[preempt["victim"]]
        reclaimed = tickets[killed["ticket"]]
        if victim.preemptions != 1 or reclaimed.stolen_from != "w2" \
                or reclaimed.attempts < 2:
            raise AssertionError(
                f"fleet (b): the preempted ticket {victim.to_json()}, the "
                f"killed worker's {reclaimed.to_json()}")
        targets = {}
        for i, ch in chs.items():
            targets[i] = fleet_target_check(
                ch, rows, 0 if i == inter else i, per,
                full=f"fleet-{i}" in (preempt["victim"], killed["ticket"]))
        out.update(
            tickets={tid: {k: getattr(x, k) for k in (
                "tenant", "qos", "claimed_by", "claim_epoch", "attempts",
                "preemptions", "stolen_from")}
                for tid, x in sorted(tickets.items())},
            preempt=preempt, preempt_log=sched.preempt_log,
            worker0_claims=[list(c) for c in worker.claim_log],
            worker0_tickets_run=worker.tickets_run, targets=targets,
            rows=sum(t["rows"] for t in targets.values()),
            queue_root=root)
        out["delivered"] = {f"fleet-{i}": t["rows"]
                            for i, t in targets.items()}
        return out
    finally:
        set_placement(None)
        if worker is not None:
            worker.request_drain()
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=60)
        for ch in chs.values():
            ch.stop()


def fleet_compaction(dev) -> dict:
    """(c) the MVCC compaction ticket: a store with a base and
    FLEET_MVCC_LAYERS deltas, its keys on the card; the ticket enqueued
    twice (one admission), run by a fleet worker; `read_at` the same
    before and after, the layers folded."""
    from transferia_tpu_torch.abstract.kinds import KIND_CODES, Kind
    from transferia_tpu_torch.fleet.worker import FleetWorker
    from transferia_tpu_torch.mvcc import compact as mvcc_compact

    schema = new_table_schema([("id", "int64", True), ("val", "utf8")])
    tid = TableID("s", "t")
    table = "s.t"
    cp = MemoryCoordinator()
    store = mvcc_store.register_store(mvcc_store.MvccStore(
        "fleet/mvcc", cp, device=dev))
    rng = np.random.default_rng(31)
    t0 = time.perf_counter()
    n = FLEET_MVCC_BASE
    store.put_base(table, "p0", 1, [ColumnBatch.from_pydict(
        tid, schema, {"id": list(range(n)),
                      "val": [f"v{i}" for i in range(n)]})])
    codes = [KIND_CODES[Kind.INSERT], KIND_CODES[Kind.UPDATE],
             KIND_CODES[Kind.DELETE]]
    lsn = 100
    for layer in range(FLEET_MVCC_LAYERS):
        ids = rng.choice(n + FLEET_MVCC_DELTA * FLEET_MVCC_LAYERS,
                         FLEET_MVCC_DELTA, replace=False)
        kinds = np.asarray([codes[k] for k in rng.integers(0, 3,
                                                           len(ids))],
                           dtype=np.int8)
        store.append_delta(table, "w0", layer, [ColumnBatch.from_pydict(
            tid, schema, {"id": [int(x) for x in ids],
                          "val": [f"l{layer}-{x}" for x in ids]},
            kinds=kinds, lsns=np.arange(lsn, lsn + len(ids),
                                        dtype=np.int64))])
        lsn += len(ids)
    build_s = time.perf_counter() - t0

    def image() -> list:
        """The merged read, source by source: columns, kinds, LSNs."""
        return [(b.to_pydict(),
                 None if b.kinds is None else b.kinds.tolist(),
                 None if b.lsns is None else b.lsns.tolist())
                for b in store.read_at(table)]

    before = image()
    layers = store.layer_count(table)
    t1 = mvcc_compact.enqueue_compaction(cp, "mvcc", store, table, "fleet")
    t2 = mvcc_compact.enqueue_compaction(cp, "mvcc", store, table, "fleet")
    if t1 is None or t2 is None or t1.ticket_id != t2.ticket_id or \
            len(cp.list_tickets("mvcc")) != 1:
        raise AssertionError(f"fleet (c): enqueued {t1}, {t2}")
    worker = FleetWorker(cp, queue="mvcc", worker_index=0, max_tickets=1,
                         heartbeat_interval=FLEET_HEARTBEAT_S,
                         idle_exit_seconds=60.0, device=dev)
    t0 = time.perf_counter()
    worker.run()
    run_s = time.perf_counter() - t0
    (done,) = cp.list_tickets("mvcc")
    after = image()
    mvcc_store.unregister_store(store.scope)
    if done.state != "done" or after != before or \
            store.layer_count(table) != 0:
        raise AssertionError(f"fleet (c): ticket {done.to_json()}, reads "
                             f"equal {after == before}, layers left "
                             f"{store.layer_count(table)}")
    return {"ticket": t1.ticket_id, "layers_folded": layers,
            "rows": sum(len(b[0]["id"]) for b in after),
            "build_seconds": build_s, "ticket_seconds": run_s,
            "read_at_equal": True}


def fleet_observability(b: dict, dev) -> dict:
    """(d) the panes over (b)'s segments, as a user runs them: every
    worker's segment present, and each ticket's merged ledger rows equal
    to the rows ClickHouse holds (the killed worker's ticket at least
    those: its dead attempt's rows stay billed)."""
    from transferia_tpu_torch.coordinator import FileStoreCoordinator
    from transferia_tpu_torch.stats import fleetobs

    coord = ["--coordinator", "filestore", "--coordinator-dir",
             b["queue_root"]]
    segs = FileStoreCoordinator(root=b["queue_root"]).list_obs_segments(
        fleetobs.default_scope())
    workers = sorted({sg["worker"].split(".")[1] for sg in segs
                      if sg.get("worker", "").startswith("fleet.")})
    if workers != ["w0", "w1", "w2"]:
        raise AssertionError(f"fleet (d): segments of workers {workers}")
    out = {"segments": len(segs), "workers": workers}
    rc, so, se, s = cli_main(coord + ["top", "--fleet", "--json"], dev)
    view = json.loads(so)
    billed = {tid: view["transfers"].get(tid, {}).get("rows_out", 0)
              for tid in b["delivered"]}
    killed = b["killed"]["ticket"]
    wrong = {tid: (billed[tid], rows) for tid, rows in b["delivered"].items()
             if billed[tid] < rows or (tid != killed and billed[tid] != rows)}
    if rc != 0 or wrong or not view["conservation"]["ok"]:
        raise AssertionError(f"fleet (d) top --fleet: rc {rc}, billed != "
                             f"delivered {wrong}, conservation "
                             f"{view['conservation']}")
    out["top"] = {"rc": rc, "seconds": s, "billed_rows_out": billed,
                  "processes": view["processes"]}
    rc, so, se, s = cli_main(coord + ["top", "--fleet", "--once"], dev)
    if rc != 0 or "fleet obs:" not in so:
        raise AssertionError(f"fleet (d) top --fleet --once: rc {rc}: "
                             f"{so[-500:]}{se[-500:]}")
    tid = b["preempt"]["victim"]
    trace_out = os.path.join(_build.BUILD_DIR, "fleet_trace.json")
    rc, so, se, s = cli_main(coord + ["trace", "--fleet", tid, "--out",
                                      trace_out], dev)
    doc = json.loads(Path(trace_out).read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    if rc != 0 or not {"fleet_ticket_run", "part"} <= names:
        raise AssertionError(f"fleet (d) trace --fleet: rc {rc}, spans "
                             f"{sorted(names)}: {se[-500:]}")
    out["trace"] = {"rc": rc, "seconds": s, "events": len(doc["traceEvents"]),
                    "processes": doc["otherData"]["processes"]}
    os.unlink(trace_out)
    rc, so, se, s = cli_main(coord + ["slo", "--fleet", "--json"], dev)
    verdicts = json.loads(so)
    if "objectives" not in verdicts or rc not in (0, 1):
        raise AssertionError(f"fleet (d) slo --fleet: rc {rc}: {se[-500:]}")
    out["slo"] = {"rc": rc, "ok": verdicts["ok"],
                  "burning": verdicts["burning"], "seconds": s}
    rc, so, se, s = cli_main(coord + ["explain", tid, "--json"], dev)
    report = json.loads(so)
    if rc != 0 or not report.get("levers"):
        raise AssertionError(f"fleet (d) explain {tid}: rc {rc}: "
                             f"{se[-500:]}")
    out["explain"] = {"rc": rc, "seconds": s,
                      "attributed_pct": report["attributed_pct"],
                      "levers": [lv.get("stage") for lv in report["levers"]],
                      "processes": report["processes"]}
    return out


def fleet_path(rows, keep: dict, dev) -> dict:
    """The fleet on the card: (a) the scheduler at `fleet bench`'s shape,
    (b) a distributed fleet over the s3 phase's objects with a
    preemption and a killed worker, (c) the MVCC compaction ticket, (d)
    the observability panes over (b)'s segments.  Every K-A, K-B, K-C
    and K10 launch of this process is held against its plain version.
    The fake S3 stays up for the delta phase, which stops it."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="fleet-", dir=str(_build.BUILD_DIR))
    fake = keep["fake"]
    # short leases for the kill's reclaim, and room for every segment of
    # the run (the default keeps a worker's last 8: the panes of (d)
    # read spans of the phase's first tickets)
    env = {"TRANSFERIA_TPU_LEASE_SECONDS": str(FLEET_LEASE_S),
           "TRANSFERIA_TPU_HEARTBEAT_INTERVAL": str(FLEET_HEARTBEAT_S),
           "TRANSFERIA_TPU_OBS_SEGMENTS_PER_WORKER": "256"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    result: dict = {}
    timings: dict = {}
    try:
        with KALaunches() as ka, PredLaunches() as preds, \
                RowhashLaunches() as k10:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            result["a"] = fleet_bench_part(dev)
            timings["a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            trace_on()
            try:
                result["b"] = fleet_distributed(rows, fake, keep["objects"],
                                                tmp, dev)
            finally:
                trace_off(time.perf_counter() - t0)
            timings["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result["c"] = fleet_compaction(dev)
            timings["c"] = time.perf_counter() - t0
            launches = _build.launch_counts()
            require_launched("fleet", launches)
            t0 = time.perf_counter()
            held = {"sha256_hmac": ka.check("fleet",
                                            launches["sha256_hmac"])}
            held.update(preds.check("fleet", launches))
            held.update(k10.check("fleet", launches))
            timings["held"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        result["d"] = fleet_observability(result["b"], dev)
        timings["d"] = time.perf_counter() - t0
        result["b"].pop("queue_root")
        result.update(launches=launches, held_exact=held,
                      part_seconds=timings)
        return result
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(tmp, ignore_errors=True)


DELTA_PREFIX = "delta"
DELTA_LIVE = (0, 1, 2, 3)    # (a)'s table after log version 1
DELTA_STALE = 7              # added in version 0, removed in version 1
DELTA_EXAMPLE = "delta2ch.yaml"
DELTA_SETTLE_S = 300.0
DELTA_FAMILIES = (
    "process_cpu_seconds_total", "process_max_fds", "process_open_fds",
    "process_resident_memory_bytes", "process_start_time_seconds",
    "process_virtual_memory_bytes", "python_gc_collections_total",
    "python_gc_objects_collected_total",
    "python_gc_objects_uncollectable_total", "python_info")
# (d): the new host transformers around bench.py's mask and filter
DELTA_D_CHAIN = {"transformers": [
    {"replace_primary_key": {"keys": ["WatchID"]}}] + CONFIG["transformers"]
    + [{"number_to_float": {}}]}
DELTA_STAGES = ("s3_range_get", "source_decode", "pivot", "pack",
                "device_dispatch", "device_wait", "sink", "sink_wait")


def delta_tables(fake, per: int) -> dict:
    """The s3 phase's objects copied under delta/ as three Delta tables:
    `hits` (version 0 adds objects 0, 1, 2 and 7; version 1 adds 3 and
    removes 7), `one` (object 0) and `cut` (the 25,000-row object);
    name -> its s3:// path."""
    def obj(i: int) -> bytes:
        return fake.objects[f"hits/hits_{i:02d}.parquet"][0]

    def log(table: str, version: int, actions: list) -> None:
        fake.put_object(f"{DELTA_PREFIX}/{table}/_delta_log/"
                        f"{version:020d}.json",
                        "\n".join(json.dumps(a) for a in actions).encode())

    def add(name):
        return {"add": {"path": name, "dataChange": True}}

    first = [i for i in DELTA_LIVE if i != DELTA_LIVE[-1]] + [DELTA_STALE]
    for i in first + [DELTA_LIVE[-1]]:
        fake.put_object(f"{DELTA_PREFIX}/hits/hits_{i:02d}.parquet", obj(i))
    log("hits", 0, [{"metaData": {"id": "hits"}}]
        + [add(f"hits_{i:02d}.parquet") for i in first])
    log("hits", 1, [add(f"hits_{DELTA_LIVE[-1]:02d}.parquet"),
                    {"remove": {"path": f"hits_{DELTA_STALE:02d}.parquet"}},
                    {"commitInfo": {"operation": "WRITE"}}])
    fake.put_object(f"{DELTA_PREFIX}/one/part-0.parquet", obj(0))
    log("one", 0, [add("part-0.parquet")])
    fake.put_object(f"{DELTA_PREFIX}/cut/part-0.parquet",
                    fake.objects["cut/hits.parquet"][0])
    log("cut", 0, [add("part-0.parquet")])
    return {t: f"s3://{S3_BUCKET}/{DELTA_PREFIX}/{t}"
            for t in ("hits", "one", "cut")}


def delta_yaml(tmp: str, name: str, endpoint: str,
               chain: bool = True) -> str:
    """examples/delta2ch.yaml with the fake's endpoint_url added (and,
    without `chain`, its transformation dropped)."""
    text = (Path(__file__).resolve().parent / "examples"
            / DELTA_EXAMPLE).read_text()
    anchor = "    batch_rows: 65536\n"
    if text.count(anchor) != 1 or text.count("transformation:") != 1:
        raise AssertionError(f"{DELTA_EXAMPLE}: no single {anchor!r} line "
                             "or transformation")
    text = text.replace(anchor, anchor + f'    endpoint_url: "{endpoint}"\n')
    if not chain:
        text = text.split("transformation:")[0]
    path = os.path.join(tmp, name)
    with open(path, "w") as fh:
        fh.write(text)
    return path


def delta_kept(rows, objs, per: int) -> np.ndarray:
    """numpy's kept WatchIDs of the objects after bench.py's filter,
    sorted."""
    ids = []
    for i in objs:
        _, fixed, _ = slice_rows(rows, i * per, (i + 1) * per)
        keep = (fixed["RegionID"] < 400) & (fixed["ResolutionWidth"] >= 390)
        ids.append(fixed["WatchID"][keep])
    return np.sort(np.concatenate(ids))


class DeltaEnv:
    """The example's variables for a run, restored afterwards."""

    def __init__(self, **env):
        self.env = env

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.env}
        os.environ.update(self.env)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def delta_activate(yaml: str, table: str, placement: str, dev,
                   traced: bool = False) -> dict:
    """`activate` of the YAML through cli.main in this process, into a
    fresh fake ClickHouse on port 8123, on the card (device placement)
    or with --device cpu (host placement): the fake, rc, seconds and, on
    a CPU run, the launches it made (none may be)."""
    on_card = placement == "device"
    run_dev = dev if on_card else torch.device("cpu")
    ch = ch_on_8123()
    before = _build.launch_counts()
    set_placement("device" if on_card else "host")
    if traced:
        trace_on()
    seconds = 0.0
    try:
        with DeltaEnv(DELTA_PATH=table, MASK_SALT=FLEET_SALT,
                      CH_HOST=ch._srv.server_address[0]):
            rc, _, se, seconds = cli_main(["activate", "--transfer", yaml],
                                          run_dev)
    finally:
        tables = trace_off(seconds) if traced else None
        set_placement(None)
    after = _build.launch_counts()
    out = {"ch": ch, "rc": rc, "seconds": seconds, "stderr": se[-500:],
           "launched": {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}}
    if tables is not None:
        summary = tables["stage_summary"]
        out["stages"] = {k: {m: summary["stages"][k][m] for m in
                             ("calls", "total_s", "self_s")}
                         for k in DELTA_STAGES if k in summary["stages"]}
        out["stage_breakdown"] = tables["stage_breakdown"]
    if rc != 0:
        ch.stop()
        raise AssertionError(f"delta: activate of {table} ({placement}): "
                             f"rc {rc}: {se[-1500:]}")
    if not on_card and out["launched"]:
        ch.stop()
        raise AssertionError(f"delta: the --device cpu run of {table} "
                             f"launched {out['launched']}")
    return out


def delta_cli(yaml: str, tables: dict, rows, per: int, dev) -> dict:
    """(a) the example on (a)'s table with bench.py's chain, on the card
    (traced) and with --device cpu: numpy's kept count, object 7's rows
    absent, both tables landed byte-identical inserts."""
    runs = {}
    try:
        for placement in ("device", "cpu"):
            runs[placement] = delta_activate(yaml, tables["hits"],
                                             placement, dev,
                                             traced=placement == "device")
        want = delta_kept(rows, DELTA_LIVE, per)
        with_stale = delta_kept(rows, [i for i in DELTA_LIVE
                                       if i != DELTA_LIVE[-1]]
                                + [DELTA_STALE], per)
        if len(want) == len(with_stale):
            raise AssertionError("delta (a): the stale object's kept "
                                 "count does not tell it apart")
        live = len(DELTA_LIVE) * per
        out = {"objects": list(DELTA_LIVE), "removed": DELTA_STALE,
               "rows": live, "kept": int(len(want))}
        digests = {}
        for placement, run in runs.items():
            ch = run["ch"]
            digests[placement] = ch.insert_digests("hits")
            out[placement] = {
                "seconds": run["seconds"],
                "rows_per_s": live / run["seconds"],
                "ch_rows": ch.total_rows(), "inserts": len(digests[
                    placement]),
                "ddl_first": ch.queries[0].split("(")[0][:60],
                **({"stages": run["stages"],
                    "stage_breakdown": run["stage_breakdown"]}
                   if "stages" in run else {})}
            if out[placement]["ch_rows"] != len(want):
                raise AssertionError(
                    f"delta (a) {placement}: ClickHouse holds "
                    f"{out[placement]['ch_rows']} rows, numpy keeps "
                    f"{len(want)} of objects {DELTA_LIVE}")
        if digests["device"] != digests["cpu"]:
            raise AssertionError("delta (a): the card's and the CPU's "
                                 "tables differ")
        out["identical_across_placements"] = True
        return out
    finally:
        for run in runs.values():
            run["ch"].stop()


def parse_metrics(text: str) -> dict:
    """family -> (HELP, TYPE, samples) of a text-format scrape; raises on
    a line the format does not allow."""
    fams: dict = {}
    sample = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{.*\})? (\S+)$")
    for line in text.splitlines():
        if line.startswith(("# HELP ", "# TYPE ")):
            name, _, rest = line[7:].partition(" ")
            fams.setdefault(name, {"samples": 0})[line[2:6]] = rest
            continue
        m = sample.match(line)
        if not m:
            raise AssertionError(f"delta (a): not a metrics line {line!r}")
        float(m.group(3))
        fams[m.group(1)]["samples"] += 1
    return fams


def delta_metrics_run(yaml: str, tables: dict, rows, per: int, tmp: str,
                      dev) -> dict:
    """(a) again in a `python3 -m transferia_tpu_torch.cli.main
    --metrics-port P activate` process over the one-object table: /metrics
    scraped once while the run lasts, its ClickHouse numpy's kept count."""
    import urllib.request

    ch = ch_on_8123()
    port = free_port()
    log = os.path.join(tmp, "metrics-activate.log")
    env = dict(os.environ, TRANSFERIA_TPU_PLACEMENT="device",
               PYTHONPATH=str(Path(__file__).resolve().parent),
               DELTA_PATH=tables["one"], MASK_SALT=FLEET_SALT,
               CH_HOST=ch._srv.server_address[0])
    t0 = time.perf_counter()
    try:
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [sys.executable, "-m", "transferia_tpu_torch.cli.main",
                 "--device", str(dev.type), "--log-level", "warning",
                 "--metrics-port", str(port), "activate", "--transfer",
                 yaml], stdout=fh, stderr=subprocess.STDOUT, env=env)
        try:
            text = None
            while text is None:
                if proc.poll() is not None:
                    raise AssertionError(
                        f"delta (a): the --metrics-port run exited (rc "
                        f"{proc.returncode}) before its scrape: "
                        f"{log_tail(log)}")
                if time.perf_counter() - t0 > DELTA_SETTLE_S:
                    raise AssertionError("delta (a): /metrics never "
                                         "answered")
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{port}/metrics",
                            timeout=2) as r:
                        text = r.read().decode()
                        ctype = r.headers["Content-Type"]
                except OSError:
                    time.sleep(0.02)
            scraped_at = time.perf_counter() - t0
            rc = proc.wait(timeout=DELTA_SETTLE_S)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        seconds = time.perf_counter() - t0
        fams = parse_metrics(text)
        want = len(delta_kept(rows, [0], per))
        out = {"rc": rc, "seconds": seconds,
               "scraped_after_seconds": scraped_at, "content_type": ctype,
               "families": sorted(fams), "ch_rows": ch.total_rows(),
               "kept": want, "log": log_tail(log, 400)}
        if rc != 0 or set(fams) != set(DELTA_FAMILIES) or \
                out["ch_rows"] != want or not all(
                    "HELP" in f and "TYPE" in f and f["samples"]
                    for f in fams.values()):
            raise AssertionError(f"delta (a) --metrics-port: {out}")
        return out
    finally:
        ch.stop()


def delta_native(yaml_plain: str, tables: dict, rows, per: int,
                 dev) -> dict:
    """(b) the one-object table with no transformation: ClickHouse's
    native target creates the table before the first insert, the rows
    equal the object's row for row against numpy, nothing launches."""
    run = delta_activate(yaml_plain, tables["one"], "device", dev)
    ch = run["ch"]
    try:
        verbs = [q.split()[0].upper() for q in ch.queries
                 if q.split()[0].upper() in ("CREATE", "INSERT")]
        if not verbs or verbs[0] != "CREATE" or "CREATE" in verbs[1:]:
            raise AssertionError(f"delta (b): statements {verbs[:5]}")
        if run["launched"]:
            raise AssertionError(f"delta (b): launched {run['launched']}")
        t0 = time.perf_counter()
        got = ch.rows("hits")
        _, fixed, var = slice_rows(rows, 0, per)
        if len(got) != per:
            raise AssertionError(f"delta (b): {len(got)} rows of {per}")
        for name, want in fixed.items():
            col = np.array([int(r[name].timestamp())
                            if hasattr(r[name], "timestamp")
                            else r[name] for r in got])
            if not np.array_equal(col, want.astype(np.int64)):
                raise AssertionError(f"delta (b): column {name} differs "
                                     "from numpy's")
        for name, (data, offsets) in var.items():
            for j, r in enumerate(got):
                v = r[name].encode() if isinstance(r[name], str) \
                    else r[name]
                if v != bytes(data[offsets[j]:offsets[j + 1]]):
                    raise AssertionError(f"delta (b): row {j} {name} "
                                         "differs from numpy's")
        return {"rows": per, "seconds": run["seconds"],
                "rows_per_s": per / run["seconds"],
                "statements": {"create": verbs.count("CREATE"),
                               "insert": verbs.count("INSERT")},
                "create_before_insert": True,
                "checked_seconds": time.perf_counter() - t0,
                "launched": run["launched"]}
    finally:
        ch.stop()


def delta_checksum(yaml_plain: str, tables: dict, endpoint: str, tmp: str,
                   dev) -> dict:
    """(c) checksum by K10 on the card of the 25,000-row table: against
    the ClickHouse table its native activation made, the reference's
    verdict (the Delta source counts no rows, so "row counts differ:
    src=0" decides and no fingerprint runs; exit 1), and against a
    memory target of the same rows, where the fingerprints decide: exit
    0 with every K10 launch held."""
    out = {}
    run = delta_activate(yaml_plain, tables["cut"], "device", dev)
    ch = run["ch"]
    before = _build.launch_counts()["rowhash_lanes"]
    try:
        with DeltaEnv(DELTA_PATH=tables["cut"],
                      CH_HOST=ch._srv.server_address[0]):
            rc, so, _, s = cli_main(
                ["checksum", "--transfer", yaml_plain, "--method",
                 "fingerprint", "--fingerprint-backend", "device"], dev)
    finally:
        ch.stop()
    out["clickhouse"] = {"rc": rc, "seconds": s, "report": so.strip()[-300:],
                         "k10_launches": _build.launch_counts()[
                             "rowhash_lanes"] - before}
    if rc != 1 or f"row counts differ: src=0 dst={S3_ALTERED_ROWS}" \
            not in so or "diffs=1)" not in so:
        raise AssertionError(f"delta (c) against ClickHouse: {out}")
    mem = os.path.join(tmp, "delta-mem.yaml")
    with open(mem, "w") as fh:
        fh.write(f"id: delta-mem\nsrc:\n  type: delta\n  params:\n"
                 f'    path: "{tables["cut"]}"\n    table: hits\n'
                 f'    endpoint_url: "{endpoint}"\n'
                 "dst:\n  type: memory\n  params:\n    sink_id: delta_mem\n")
    before = _build.launch_counts()["rowhash_lanes"]
    rc_a, _, se, _ = cli_main(["activate", "--transfer", mem], dev)
    rc, so, _, s = cli_main(["checksum", "--transfer", mem, "--method",
                             "fingerprint", "--fingerprint-backend",
                             "device"], dev)
    get_store("delta_mem").clear()
    out["memory"] = {"rc": rc, "activate_rc": rc_a, "seconds": s,
                     "report": so.strip()[-300:],
                     "k10_launches": _build.launch_counts()[
                         "rowhash_lanes"] - before}
    if rc_a != 0 or rc != 0 or "OK" not in so or \
            not out["memory"]["k10_launches"]:
        raise AssertionError(f"delta (c) against memory: {out} {se[-500:]}")
    return out


def delta_transformers(tables: dict, endpoint: str, dev) -> dict:
    """(d) the one-object table through replace_primary_key, bench.py's
    mask and filter, and number_to_float, on the card and on the CPU:
    the two ClickHouse tables landed byte-identical inserts."""
    runs, out = {}, {}
    try:
        for placement in ("device", "cpu"):
            on_card = placement == "device"
            ch = FakeCH().start()
            runs[placement] = ch
            t = Transfer(id="delta-d", src=DeltaSourceParams(
                path=tables["one"], table="hits",
                endpoint_url=endpoint),
                dst=CHTargetParams(host="127.0.0.1", port=ch.port,
                                   bufferer=None),
                transformation=DELTA_D_CHAIN)
            before = _build.launch_counts()
            set_placement("device" if on_card else "host")
            t0 = time.perf_counter()
            try:
                activate_delivery(t, MemoryCoordinator(),
                                  device=dev if on_card else "cpu")
                _sync(dev)
            finally:
                set_placement(None)
            after = _build.launch_counts()
            launched = {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
            if not on_card and launched:
                raise AssertionError(f"delta (d) cpu: launched {launched}")
            out[placement] = {"seconds": time.perf_counter() - t0,
                              "ch_rows": ch.total_rows(),
                              "launched": launched}
        ddl = [q for q in runs["device"].queries if q.startswith("CREATE")]
        if runs["device"].insert_digests("hits") != \
                runs["cpu"].insert_digests("hits") or \
                "Float64" not in ddl[0]:
            raise AssertionError(f"delta (d): the placements' tables "
                                 f"differ ({out}) or no Float64 in {ddl}")
        out["identical_across_placements"] = True
        out["ddl"] = ddl[0][:300]
        return out
    finally:
        for ch in runs.values():
            ch.stop()


def delta_path(rows, keep: dict, dev) -> dict:
    """The event model on the card: a Delta Lake table on the s3 phase's
    fake S3 -> ClickHouse.  (a) examples/delta2ch.yaml through cli.main
    on the card and on the CPU, and in a --metrics-port process; (b) the
    native a2 target; (c) checksum; (d) the new host transformers around
    the fused run.  Every K-A, K-B, K-C and K10 launch of this process is
    held against its plain version; the CPU runs launch nothing."""
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="delta-", dir=str(_build.BUILD_DIR))
    fake = keep["fake"]
    per = keep["objects"]["rows_per_object"]
    result: dict = {}
    timings: dict = {}
    try:
        t0 = time.perf_counter()
        tables = delta_tables(fake, per)
        yaml = delta_yaml(tmp, "delta2ch.yaml", fake.endpoint)
        yaml_plain = delta_yaml(tmp, "delta2ch-plain.yaml", fake.endpoint,
                                chain=False)
        timings["data"] = time.perf_counter() - t0
        with KALaunches() as ka, PredLaunches() as preds, \
                RowhashLaunches() as k10:
            _build.reset_launch_counts()
            t0 = time.perf_counter()
            result["a"] = delta_cli(yaml, tables, rows, per, dev)
            timings["a"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result["a"]["metrics_port"] = delta_metrics_run(
                yaml, tables, rows, per, tmp, dev)
            timings["a_metrics"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result["b"] = delta_native(yaml_plain, tables, rows, per, dev)
            timings["b"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result["c"] = delta_checksum(yaml_plain, tables, fake.endpoint,
                                         tmp, dev)
            timings["c"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            result["d"] = delta_transformers(tables, fake.endpoint, dev)
            timings["d"] = time.perf_counter() - t0
            launches = _build.launch_counts()
            require_launched("delta", launches)
            t0 = time.perf_counter()
            held = {"sha256_hmac": ka.check("delta",
                                            launches["sha256_hmac"])}
            held.update(preds.check("delta", launches))
            held.update(k10.check("delta", launches))
            timings["held"] = time.perf_counter() - t0
        result.update(launches=launches, held_exact=held,
                      part_seconds=timings)
        return result
    finally:
        fake.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def chaos_cli(argv: list, dev) -> tuple[dict, float]:
    """`chaos` through the port's CLI in this process on `dev`: its JSON
    report and seconds.  The runner's warnings (every injected fault
    and retry) stay out of the log while it runs."""
    import contextlib
    import io
    import logging

    from transferia_tpu_torch.cli.main import main as cli_entry

    root = logging.getLogger()
    level = root.level
    root.setLevel(logging.ERROR)
    out = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = cli_entry(["--device", dev.type, "--log-level", "error",
                            "chaos"] + argv)
    finally:
        root.setLevel(level)
    _sync(dev)
    seconds = time.perf_counter() - t0
    report = json.loads(out.getvalue())
    if rc != 0 or not report["passed"]:
        raise AssertionError(f"chaos {' '.join(argv)}: exit {rc}, failed "
                             f"trials {report['failed_trials']}: "
                             f"{[r['violations'] for r in report['results']]}")
    return report, seconds


def chaos_modes(report: dict) -> dict:
    """Per mode (exactly_once per backend): trials, restarts, kills,
    fenced publishes or updates, duplicates absorbed, seconds."""
    out: dict = {}
    for r in report["results"]:
        key = r["mode"] + (f"[{r['backend']}]" if r["backend"] else "")
        m = out.setdefault(key, {"trials": 0, "passed": 0, "restarts": 0,
                                 "kills": 0, "fenced": 0,
                                 "duplicates_absorbed": 0, "seconds": 0.0})
        m["trials"] += 1
        m["passed"] += int(r["passed"])
        m["restarts"] += r["restarts"]
        m["kills"] += r["kills"]
        m["fenced"] += r["fence_rejected"]
        m["duplicates_absorbed"] += r["duplicate_rows"]
        m["seconds"] += r["seconds"]
    return out


def chaos_negative_control(dev) -> dict:
    """The auditor on the card must fail a delivery that lost a batch: a
    clean snapshot (the chaos runner's transfer, no fault armed) into a
    memory store passes its audit, and the same delivery with its first
    batch dropped fails on at-least-once."""
    from transferia_tpu_torch.chaos import runner as chaos_runner
    from transferia_tpu_torch.chaos.invariants import audit_delivery

    rows, sink = chaos_runner.SNAPSHOT_ROWS, "chip-chaos-negative"
    store = get_store(sink)
    store.clear()
    with chaos_runner._fast_retries(), \
            chaos_runner._forced_device_placement():
        ref = chaos_runner._snapshot_reference(rows, dev)
        chaos_runner._run_snapshot_once(
            chaos_runner._snapshot_transfer(rows, sink),
            MemoryCoordinator(), dev)
    delivered = list(store.batches)
    store.clear()
    # the first batch that holds rows (a staged part may publish control
    # items or an empty batch ahead of its rows)
    drop = next(i for i, b in enumerate(delivered)
                if getattr(b, "n_rows", 0))
    clean = audit_delivery(ref, delivered, 1, device=dev)
    lost = audit_delivery(ref, delivered[:drop] + delivered[drop + 1:], 1,
                          device=dev)
    lost_rows = [v for v in lost.violations
                 if v.invariant == "at-least-once"]
    if not clean.passed or lost.passed or not lost_rows:
        raise AssertionError(f"negative control: clean {clean.summary()}; "
                             f"a batch dropped {lost.summary()}")
    return {"reference_rows": ref.rows, "batches": len(delivered),
            "dropped_batch": drop, "dropped_rows": delivered[drop].n_rows,
            "clean": clean.summary(),
            "dropped": [str(v) for v in lost.violations]}


def chaos_path(dev) -> dict:
    """The chaos runner on the card: (a) `chaos --mode all --trials 1
    --seed 7 --json` through cli.main here, every mode passing and the
    port's skips (ROADMAP.md A7) exactly CHAOS_SKIPPED; (b) `--mode
    snapshot --trials 2` twice, the two reports' fire logs
    byte-identical; (c) the negative control.  Every K-A and K10 launch
    of this process (and any of K-B and K-C) is held against its plain
    version."""
    result: dict = {}
    timings: dict = {}
    with KALaunches() as ka, PredLaunches() as preds, \
            RowhashLaunches() as k10:
        _build.reset_launch_counts()
        report, timings["all"] = chaos_cli(CHAOS_ARGV, dev)
        skipped = {s["what"]: s["reason"] for s in report["skipped"]}
        modes = {r["mode"] for r in report["results"]}
        backends = {r["backend"] for r in report["results"]
                    if r["backend"]}
        if set(skipped) != CHAOS_SKIPPED or \
                not all("ROADMAP.md A7" in v for v in skipped.values()):
            raise AssertionError(f"chaos skipped {skipped}")
        if modes != CHAOS_MODES or backends != CHAOS_BACKENDS:
            raise AssertionError(f"chaos ran {modes} over {backends}")
        fired = report["sites_fired"]
        if not fired.get("device.dispatch"):
            raise AssertionError(f"device.dispatch never fired: {fired}")
        result["a"] = {"trials": report["trials"],
                       "modes": chaos_modes(report),
                       "sites_fired": fired, "skipped": skipped}
        replays = []
        for i in range(2):
            rep, timings[f"replay_{i}"] = chaos_cli(CHAOS_REPLAY_ARGV, dev)
            replays.append(json.dumps(
                [(r["spec"], r["fire_log"]) for r in rep["results"]],
                sort_keys=True))
        if replays[0] != replays[1]:
            raise AssertionError(f"seed 7's fire logs differ between two "
                                 f"runs: {replays}")
        result["b"] = {"fire_logs_identical": True,
                       "fire_logs": json.loads(replays[0])}
        t0 = time.perf_counter()
        result["c"] = chaos_negative_control(dev)
        timings["negative_control"] = time.perf_counter() - t0
        launches = _build.launch_counts()
        require_launched("chaos", launches)
        t0 = time.perf_counter()
        held = {"sha256_hmac": ka.check("chaos", launches["sha256_hmac"])}
        held.update(preds.check("chaos", launches))
        held.update(k10.check("chaos", launches))
        timings["held"] = time.perf_counter() - t0
    result.update(launches=launches, held_exact=held, part_seconds=timings)
    return result


def check_path(dev) -> dict:
    """`check --strict` over transferia_tpu_torch on this host, through
    cli.main here: exit 0 with no finding, and nothing launched."""
    import contextlib
    import io

    from transferia_tpu_torch.analysis.rules import default_rules
    from transferia_tpu_torch.cli.main import main as cli_entry

    _build.reset_launch_counts()
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli_entry(["--log-level", "error", "check", "--strict"])
    seconds = time.perf_counter() - t0
    launches = _build.launch_counts()
    summary = out.getvalue().strip().splitlines()[-1]
    if rc != 0 or "0 new finding(s)" not in summary:
        raise AssertionError(f"check --strict: exit {rc}\n{out.getvalue()}")
    if any(launches.values()):
        raise AssertionError(f"the lint launched kernels: {launches}")
    return {"rc": rc, "seconds": seconds, "rules": len(default_rules()),
            "summary": summary, "launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test needs a card",
              file=sys.stderr)
        return 2
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    card = f"{torch.cuda.get_device_name(dev)} ({smi})"
    global INT32_OPS_PER_S
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.split()[0])
    INT32_OPS_PER_S = (INT32_LANES_PER_SM
                       * torch.cuda.get_device_properties(dev)
                       .multi_processor_count * max_sm_mhz * 1e6)

    t_start = t0 = time.perf_counter()
    builds = _build.build_all()
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "card": smi, "libraries": {
              name: {"seconds": round(b.seconds, 3),
                     "ptxas": [ln.strip() for ln in b.log.splitlines()
                               if "registers" in ln or "spill" in ln]}
              for name, b in builds.items()}})

    errs = {"sha256_hmac": check_sha256_hmac(dev),
            "pred_decode": check_pred_decode(dev),
            "pred3vl_mask": check_pred3vl_mask(dev),
            "rowhash_lanes": max(check_rowhash_lanes(dev),
                                 check_rowhash_edges(dev)),
            "var_accumulators": check_var_accumulators(dev),
            "dict_decode": check_dict_decode(dev),
            "ragged_pack": check_ragged_pack(dev),
            "shard_hist": max(check_shard_hist(dev),
                              check_shard_hist_edges(dev)),
            "digest_gather": check_digest_gather(dev),
            "region_sign_flip": check_region_sign_flip(dev)}
    torch.cuda.synchronize(dev)
    emit({"phase": "kernels", "check": "exact", "max_abs_err": errs})
    emit({"phase": "hostlib", **hostlib_path()})

    t0 = time.perf_counter()
    schema, fixed, var = clickbench_rows(ROWS)
    batches = clickbench_batches(schema, fixed, var, ROWS)
    gen_s = time.perf_counter() - t0
    link = probe_link(dev)
    chunk = _chunk_rows(dev)
    phase_s = {}
    t_phase = time.perf_counter()
    reset_dispatch_bytes()
    with PathLaunches("main_path") as main_launches:
        dev_outs, dev_s, steps = run_chain(batches, "device", dev)
    main_bytes = dispatch_bytes()
    launches = {"main_path": main_launches.counts}
    if len(steps) != 1 or not isinstance(steps[0], DeviceFusedStep):
        raise AssertionError(f"main path planned {steps}, not one "
                             "DeviceFusedStep")
    host_outs, host_s, _ = run_chain(batches, "host", dev)
    kept = sum(b.n_rows for b in dev_outs)
    want = int(((fixed["RegionID"] < 400)
                & (fixed["ResolutionWidth"] >= 390)).sum())
    if kept != want:
        raise AssertionError(f"kept {kept} rows, expected {want}")
    for i, (a, b) in enumerate(zip(dev_outs, host_outs)):
        if not batches_identical(a, b):
            raise AssertionError(f"batch {i}: device output differs from "
                                 "the host strategy")
    emit({"phase": "main_path", "card": card, "rows": ROWS,
          "batch_rows": BATCH_ROWS, "chunk_rows": chunk,
          "kept": kept, "launches": launches["main_path"],
          "device_seconds": dev_s, "device_rows_per_s": ROWS / dev_s,
          "host_seconds": host_s, "host_rows_per_s": ROWS / host_s,
          "data_gen_seconds": gen_s, "link": link.describe(),
          "h2d_bytes": main_bytes, "identical_to_host": True})
    phase_s["main_path"] = time.perf_counter() - t_phase
    del host_outs
    # clickbench's file, which the telemetry phase reads again
    cb_dir = tempfile.TemporaryDirectory()
    cb_file = os.path.join(cb_dir.name, f"hits_{ROWS}.parquet")
    results = {}
    # the s3 phase's fake S3 and objects, which the fleet and delta phases
    # read (delta stops the fake)
    s3_keep: dict = {}

    for path, run in (
            ("main_path_devpack",
             lambda: main_path_devpack(batches, dev_outs, main_bytes, dev)),
            ("dispatch", lambda: dispatch_path(dev)),
            ("fingerprint_flat",
             lambda: fingerprint_flat(batches, schema, fixed, var, dev)),
            ("fingerprint_dict", lambda: fingerprint_dict(dev)),
            ("decode", lambda: decode_path(dev)),
            ("main_path_mesh",
             lambda: main_path_mesh(batches, dev_outs, main_bytes, dev)),
            ("dispatch_mesh", lambda: dispatch_mesh(dev)),
            ("mesh_step", lambda: mesh_step(dev)),
            ("mesh1", lambda: mesh1(dev)),
            ("lambda_stream",
             lambda: lambda_path("lambda_stream", SR_MESSAGES, dev)),
            ("lambda_backlog",
             lambda: lambda_path("lambda_backlog", SR_BACKLOG, dev,
                                 auto=True)),
            ("kafka2ch", lambda: kafka2ch_path(dev)),
            ("snapshot", lambda: snapshot_path(dev)),
            ("replication", lambda: replication_path(dev)),
            ("sr2ch", lambda: sr2ch_path(dev)),
            ("pg2ch", lambda: pg2ch_path(dev)),
            ("checksum", lambda: checksum_path(dev)),
            ("sai", lambda: sai_path(dev)),
            ("my2kf", lambda: my2kf_path(dev, rows=MY2KF_CUT_ROWS)),
            ("my2kf_cdc", lambda: my2kf_cdc_path(dev)),
            ("pg2ch_cdc", lambda: pg2ch_cdc_path(dev)),
            ("my2my_cdc", lambda: my2my_cdc_path(dev)),
            ("clickbench",
             lambda: clickbench_path(schema, fixed, var, chunk or 32768,
                                     cb_file, dev)),
            ("telemetry", lambda: telemetry_path(
                cb_file,
                results["clickbench"]["runs"]["device"]["completed_rows"],
                dev)),
            ("cli", lambda: cli_path(dev)),
            ("sharded", lambda: sharded_path(dev)),
            ("s3", lambda: s3_path((schema, fixed, var), dev, keep=s3_keep)),
            ("fleet", lambda: fleet_path((schema, fixed, var), s3_keep,
                                         dev)),
            ("delta", lambda: delta_path((schema, fixed, var), s3_keep,
                                         dev)),
            ("chaos", lambda: chaos_path(dev)),
            ("check", lambda: check_path(dev))):
        t_phase = time.perf_counter()
        result = results[path] = run()
        phase_s[path] = time.perf_counter() - t_phase
        launches[path] = result["launches"]
        emit({"phase": path, "card": card, **result,
              "phase_seconds": phase_s[path]})
    cb_dir.cleanup()

    t_phase = time.perf_counter()
    timing = time_kernels(batches[0], fixed["RegionID"], chunk or 32768,
                          sass_counts(builds), dev)
    # the launch floor: probe.cu's empty kernel, timed as the kernels are
    floor_ms = kernel_ms(lambda: _empty_launch(dev), dev)
    phase_s["timing"] = time.perf_counter() - t_phase
    kernels = []
    for name, t in timing.items():
        source, replaces = KERNEL_META[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches[KERNEL_PATH[name]][name],
            "path": KERNEL_PATH[name],
            "launches_by_path": {p: c[name] for p, c in launches.items()
                                 if c[name]},
            **t, "max_abs_err": max(errs[name], t["max_abs_err"]),
            "check": "exact",
        })
        if name in ALSO_REPLACES:
            kernels[-1]["also_replaces"] = ALSO_REPLACES[name]
    emit({"phase": "timing", "card": card, "chunk_rows": chunk or 32768,
          "launch_floor_ms": floor_ms,
          "region_sign_flip_over_floor": timing["region_sign_flip"]["ms"]
          / floor_ms,
          "shape_rows": bucket_rows(chunk or 32768),
          "int32_ops_per_s": INT32_OPS_PER_S,
          "phase_seconds": phase_s,
          "total_seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
