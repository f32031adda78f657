"""Plan-time fusion of device-able transformer runs into one device step.

The port of transferia_tpu/transform/fused.py.  At plan time this pass
scans the chosen steps for maximal runs of device-able transformers —
HMAC mask (mask_field) and row-filter predicates (filter_rows) — and
replaces each run with a single DeviceFusedStep whose apply() does one
device round-trip per batch (ops/fused.py).

Fusion preconditions (checked against the schema at that chain position):
- mask_field targets only variable-width columns (fixed-width masking
  stringifies per value on the host; that step stays unfused);
- a column is masked at most once per run;
- filter_rows predicates are device-compatible (predicate/device.py) and
  never reference a column masked EARLIER in the run (the fused predicate
  evaluates on the run's input batch).

Default: ON; kill switch TRANSFERIA_TPU_DEVICE=0 or set_device_fusion(False).
The fused output is byte-identical to the host step-by-step path.  A
dictionary-encoded masked column takes the pool route when the dispatch
encoding is on: its value pool is hashed once on the card (or on the
host, in the host strategy) and the output column stays
dictionary-encoded over the hexed pool.

When the default mesh of the step's device spans more than one shard
(runtime/device.py `mesh_devices`: several cards, or a virtual mesh),
the step also builds the mesh-sharded program (parallel/fusedmesh.py)
and runs batches of at least 1024 rows per shard through it.  There a
dictionary column stays in the program (its codes shard, each shard
gathers its rows' digests from the pool's digest matrix) and its output
is still rebound to the hexed pool, so it stays dictionary-encoded.
"""

from __future__ import annotations

import logging
import time
from typing import Optional, Sequence

from transferia_tpu_torch.abstract.schema import (
    CanonicalType,
    TableID,
    TableSchema,
)
from transferia_tpu_torch.columnar.batch import Column, ColumnBatch
from transferia_tpu_torch.columnar.hexcol import hex_to_varwidth
from transferia_tpu_torch.predicate.ast import And, TrueNode
from transferia_tpu_torch.runtime import knobs
from transferia_tpu_torch.runtime.device import DeviceLike, mesh_devices
from transferia_tpu_torch.stats import stagetimer, trace
from transferia_tpu_torch.transform.base import TransformResult, Transformer
from transferia_tpu_torch.transform.plugins.filter import FilterRows
from transferia_tpu_torch.transform.plugins.mask import (
    MaskField,
    _host_hmac_hex,
    dict_hex_column,
    mask_dict_column,
)

logger = logging.getLogger(__name__)

_enabled: Optional[bool] = None


def device_fusion_enabled() -> bool:
    global _enabled
    if _enabled is None:
        _enabled = knobs.env_str("TRANSFERIA_TPU_DEVICE", "").lower() not in (
            "0", "off", "false")
    return _enabled


def set_device_fusion(on: Optional[bool]) -> None:
    """Force fusion on/off (None = re-read the env)."""
    global _enabled
    _enabled = on


_placement: Optional[str] = None


def placement_mode() -> str:
    """Execution strategy for fused steps: auto | device | host.

    auto (default) measures both strategies on real batches and keeps the
    winner (re-probing the loser periodically); both strategies produce
    byte-identical output (pinned by tests).
    """
    global _placement
    if _placement is None:
        mode = knobs.env_str("TRANSFERIA_TPU_PLACEMENT", "auto").lower()
        _placement = mode if mode in ("auto", "device", "host") else "auto"
    return _placement


def set_placement(mode: Optional[str]) -> None:
    """Force the placement mode (None = re-read the env)."""
    global _placement
    _placement = mode


class DeviceFusedStep(Transformer):
    """A fused run of mask_field/filter_rows steps, one device round-trip
    per batch."""

    TYPE = "device_fused"

    # auto placement: re-probe the losing strategy every this many batches
    REPROBE_EVERY = 256
    # only probe the device strategy when the link model says it could
    # plausibly win
    PROBE_HEADROOM = 4.0

    def __init__(self, members: Sequence[Transformer],
                 mask_entries: Sequence[tuple[str, bytes]],
                 pred_node, device: DeviceLike = None):
        from transferia_tpu_torch.ops.fused import FusedMaskFilterProgram
        from transferia_tpu_torch.predicate import compile_mask

        self.members = list(members)
        self.mask_entries = list(mask_entries)
        self.pred_node = pred_node
        self.pred_cols = sorted(pred_node.columns()) if pred_node else []
        keys = [key for _, key in mask_entries]
        self.program = FusedMaskFilterProgram(keys, pred_node, device)
        # a mesh of more than one shard: also build the mesh-sharded
        # program and route large batches through it
        self.sharded_program = None
        self._sharded_min_rows = 0
        n_dev = mesh_devices(self.program.device)
        if n_dev > 1:
            from transferia_tpu_torch.parallel.fusedmesh import (
                ShardedFusedProgram,
            )

            self.sharded_program = ShardedFusedProgram(
                keys, pred_node, device=self.program.device)
            # below ~1k rows a shard, the launches and the cross-shard
            # sums cost more than the shards save
            self._sharded_min_rows = 1024 * n_dev
        # host strategy: vectorized predicate pushed down before the mask
        self._host_pred_fn = (compile_mask(pred_node)
                              if pred_node is not None else None)
        # auto-placement state (ns/row EMAs; -1 = not yet measured)
        self._ns_row = {"host": -1.0, "device": -1.0}
        self._batch_no = 0
        self._dev_samples = 0

    def suitable(self, table: TableID, schema: TableSchema) -> bool:
        # constructed at plan time from already-suitable members
        return True

    def result_schema(self, schema: TableSchema) -> TableSchema:
        for m in self.members:
            schema = m.result_schema(schema)
        return schema

    def describe(self) -> str:
        inner = "+".join(m.describe() for m in self.members)
        return f"device[{inner}]"

    def apply(self, batch: ColumnBatch) -> TransformResult:
        if batch.n_rows == 0:
            # keep schema transformation without a device launch
            out = batch
            for m in self.members:
                out = m.apply(out).transformed
            return TransformResult(out)
        if self._pick_strategy(batch.n_rows, batch) == "host":
            return self._apply_host(batch)
        return self._apply_device(batch)

    def _use_mesh(self, n_rows: int) -> bool:
        return (self.sharded_program is not None
                and n_rows >= self._sharded_min_rows)

    def _estimate_link_bytes(self, n_rows: int, batch=None
                             ) -> tuple[float, float]:
        """(h2d, d2h) bytes the device strategy would move for a batch,
        with the dispatch encoding folded in: a dict-encoded masked
        column whose hexed pool is memoized costs no link bytes, an
        unhashed pool one pool upload (not per-row blocks), and a pool
        too large for the batch none (it hashes on the host).  On the
        mesh a dict column ships its codes (4 bytes/row) and the pool's
        digest matrix with every batch, and gets its rows' digest words
        back; a pool too large for the batch ships flat there.
        Otherwise ~128 SHA-block bytes/row in and 32 digest bytes/row
        out per masked column; predicate columns ship their dtype bytes
        plus a bitmap (n/8 encoded, n raw) and the keep mask returns the
        same way."""
        from transferia_tpu_torch.ops.dispatch import encoding_enabled

        enc = encoding_enabled()
        mesh_route = self._use_mesh(n_rows)
        h2d = 0.0
        d2h = 0.0
        for name, key in self.mask_entries:
            col = None
            if batch is not None and name in batch.columns:
                col = batch.column(name)
            if enc and col is not None and col.is_lazy_dict:
                pool = col.dict_enc.pool
                if mesh_route:
                    hashed = pool.memo_get(("hmac_digest_rows",
                                            bytes(key))) is not None
                    if not hashed and pool.n_values > 2 * max(n_rows, 1):
                        h2d += 128.0 * n_rows  # rejected pool: flat wire
                        d2h += 32.0 * n_rows
                        continue
                    if not hashed:
                        h2d += 128.0 * pool.n_values  # one pool upload
                        d2h += 32.0 * pool.n_values
                    # the memo spares the pool's hash, not its digest
                    # matrix, which ships with every batch
                    h2d += 32.0 * pool.n_values
                    h2d += 4.0 * n_rows   # the sharded codes
                    d2h += 32.0 * n_rows  # the gathered digest words
                    continue
                if pool.memo_get(("hmac_hex", bytes(key))) is not None:
                    continue  # hexed pool already memoized: free
                if pool.n_values <= 2 * max(n_rows, 1):
                    # one pool upload (~2 SHA blocks/value) and its
                    # digests back, charged to this batch
                    h2d += 128.0 * pool.n_values
                    d2h += 32.0 * pool.n_values
                continue  # a rejected pool subset-hashes on the host
            h2d += 128.0 * n_rows
            d2h += 32.0 * n_rows
        if self.pred_node is not None:
            for name in self.pred_cols:
                itemsize = 8
                if (batch is not None and name in batch.columns
                        and not batch.column(name).is_lazy_dict):
                    itemsize = batch.column(name).data.dtype.itemsize
                h2d += n_rows * itemsize
                h2d += n_rows / 8 if enc else n_rows
            d2h += n_rows / 8 if enc else n_rows  # the keep mask
        return h2d, d2h

    def _predict_device_ns_row(self, n_rows: int, batch=None) -> float:
        """Link-model estimate of the device strategy's cost per row: two
        syncs' launch overhead, the bytes over the measured link
        (`_estimate_link_bytes`, so auto placement judges the encoded
        wire) and compute at ~10M rows/s."""
        from transferia_tpu_torch.ops.linkprobe import probe_link

        link = probe_link(self.program.device)
        h2d_bytes, d2h_bytes = self._estimate_link_bytes(n_rows, batch)
        s = (2 * link.launch_overhead_s
             + h2d_bytes / link.h2d_bytes_per_s
             + d2h_bytes / link.d2h_bytes_per_s
             + n_rows / 10e6)
        return s * 1e9 / max(n_rows, 1)

    def _pick_strategy(self, n_rows: int, batch=None) -> str:
        mode = placement_mode()
        if mode in ("device", "host"):
            return mode
        # auto: measure each strategy once, keep the winner, re-probe the
        # loser every REPROBE_EVERY batches
        host_ns, dev_ns = self._ns_row["host"], self._ns_row["device"]
        if host_ns < 0:
            return "host"
        if dev_ns < 0:
            predicted = self._predict_device_ns_row(max(n_rows, 1), batch)
            return ("host" if predicted > host_ns * self.PROBE_HEADROOM
                    else "device")
        winner = "host" if host_ns <= dev_ns else "device"
        if self._batch_no % self.REPROBE_EVERY == self.REPROBE_EVERY - 1:
            loser = "device" if winner == "host" else "host"
            if loser == "device" and self._predict_device_ns_row(
                    max(n_rows, 1), batch) > host_ns * self.PROBE_HEADROOM:
                return winner
            return loser
        return winner

    def _observe(self, strategy: str, seconds: float, n_rows: int) -> None:
        self._batch_no += 1
        if strategy == "device":
            self._dev_samples += 1
            if self._dev_samples == 1:
                # the first device batch carries the kernel build and
                # the link probe — recording it would pin auto to host
                return
        ns = seconds * 1e9 / max(n_rows, 1)
        prev = self._ns_row[strategy]
        self._ns_row[strategy] = ns if prev < 0 else 0.7 * prev + 0.3 * ns

    def _apply_device(self, batch: ColumnBatch) -> TransformResult:
        from transferia_tpu_torch.ops.dispatch import (
            device_hmac_dict_pool,
            encoding_enabled,
        )

        t0 = time.perf_counter()
        device = self.program.device
        mesh = self._use_mesh(batch.n_rows)
        # the pool route (one device): a dict column's pool hashes on the
        # card once per (pool, key) and the codes rebind to the hexed
        # pool on the host, so the batch's row bytes never cross the
        # link; a pool too large for the batch hashes its referenced
        # subset on the host, still encoded.  On the mesh a dict column
        # stays in the program (its codes shard; digests gather by code)
        # and its output still rebinds to the hexed pool.
        dict_cols: dict[str, Column] = {}
        mask_inputs, out_names, flat_states = [], [], []
        encoded = encoding_enabled()
        for (name, key), states in zip(self.mask_entries,
                                       self.program._states):
            col = batch.column(name)
            if encoded and col.is_lazy_dict and not mesh:
                hexed = device_hmac_dict_pool(bytes(key), col.dict_enc.pool,
                                              col.n_rows, device)
                dict_cols[name] = (
                    dict_hex_column(col, hexed) if hexed is not None
                    else mask_dict_column(bytes(key), col))
                continue
            if encoded and col.is_lazy_dict:
                from transferia_tpu_torch.parallel.fusedmesh import (
                    dict_mask_input,
                )

                dmi = dict_mask_input(bytes(key), col, device)
                if dmi is not None:
                    # the digest rows just memoized make the hexed pool
                    # a conversion, not a second hash
                    mask_inputs.append(dmi)
                    hexed = device_hmac_dict_pool(
                        bytes(key), col.dict_enc.pool, col.n_rows, device)
                    if hexed is not None:
                        dict_cols[name] = dict_hex_column(col, hexed)
                        out_names.append(None)
                    else:
                        out_names.append(name)
                    continue
                # a pool too large for the batch: the flat block wire
            mask_inputs.append((col.data, col.offsets))
            out_names.append(name)
            flat_states.append(states)
        pred_inputs = {name: (batch.column(name).data,
                              batch.column(name).validity)
                       for name in self.pred_cols}
        hexes, keep = [], None  # everything rode the pool route
        if mesh:
            hexes, keep = self.sharded_program.run(
                mask_inputs, pred_inputs, batch.n_rows)
        elif mask_inputs or self.pred_node is not None:
            hexes, keep = self.program.run(mask_inputs, pred_inputs,
                                           batch.n_rows, states=flat_states)
        with stagetimer.stage("host_post"), trace.span("host_post"):
            cols = dict(batch.columns)
            for name, hx in zip(out_names, hexes):
                if name is None:
                    continue  # dict_cols holds the rebound column
                validity = batch.column(name).validity
                data, offsets = hex_to_varwidth(hx, validity)
                cols[name] = Column(name, CanonicalType.UTF8, data,
                                    offsets, validity)
            cols.update(dict_cols)
            out = batch.with_columns(cols,
                                     self.result_schema(batch.schema))
            if keep is not None and not keep.all():
                out = out.filter(keep)
        self._observe("device", time.perf_counter() - t0, batch.n_rows)
        return TransformResult(out)

    def _apply_host(self, batch: ColumnBatch) -> TransformResult:
        """Host strategy with predicate pushdown: the fusion preconditions
        guarantee the predicate never reads a column masked in this run,
        so filtering FIRST and hashing only the surviving rows is
        byte-equivalent to the device program (which hashes every row,
        then compacts)."""
        t0 = time.perf_counter()
        cur = batch
        if self._host_pred_fn is not None:
            keep = self._host_pred_fn(batch)
            if not keep.all():
                cur = batch.filter(keep)
        with stagetimer.stage("host_mask"), trace.span("host_mask"):
            cols = dict(cur.columns)
            for name, key in self.mask_entries:
                col = cur.column(name)
                if col.is_lazy_dict:
                    # O(unique) hashes: the pool once (or the referenced
                    # subset when the pool dwarfs the batch), codes stay
                    cols[name] = mask_dict_column(key, col)
                    continue
                data, offsets = _host_hmac_hex(key, col.data, col.offsets,
                                               col.validity)
                cols[name] = Column(name, CanonicalType.UTF8, data,
                                    offsets, col.validity)
            out = cur.with_columns(cols, self.result_schema(batch.schema))
        self._observe("host", time.perf_counter() - t0, batch.n_rows)
        return TransformResult(out)


def _mask_target_cols(step: MaskField, schema: TableSchema) -> list[str]:
    return [c for c in step.columns if schema.find(c) is not None]


def maybe_fuse_steps(steps: Sequence[Transformer], in_table: TableID,
                     in_schema: TableSchema,
                     device: DeviceLike = None) -> list[Transformer]:
    """Replace device-able runs with DeviceFusedSteps (plan-time)."""
    if not device_fusion_enabled() or not steps:
        return list(steps)
    from transferia_tpu_torch.predicate.device import device_compatible

    out: list[Transformer] = []
    schema = in_schema
    i = 0
    n = len(steps)
    while i < n:
        # try to grow a fusable run starting at i
        group: list[Transformer] = []
        mask_entries: list[tuple[str, bytes]] = []
        pred_parts = []
        masked: set[str] = set()
        run_schema = schema
        j = i
        while j < n:
            st = steps[j]
            if isinstance(st, MaskField):
                targets = _mask_target_cols(st, run_schema)
                if (not targets
                        or any(c in masked for c in targets)
                        or any(not run_schema.find(c)
                               .data_type.is_variable_width
                               for c in targets)):
                    break
                for c in targets:
                    mask_entries.append((c, st.key))
                masked.update(targets)
            elif isinstance(st, FilterRows):
                if (not device_compatible(st.node, run_schema)
                        or (st.node.columns() & masked)):
                    break
                if not isinstance(st.node, TrueNode):
                    # an always-true filter joins the run as a no-op
                    pred_parts.append(st.node)
            else:
                break
            group.append(st)
            run_schema = st.result_schema(run_schema)
            j += 1
        if mask_entries and group:
            # a run with at least one device mask pays for the launch;
            # pure-filter runs stay on the (already vectorized) host path
            pred_node = None
            if pred_parts:
                pred_node = (pred_parts[0] if len(pred_parts) == 1
                             else And(tuple(pred_parts)))
            fused = DeviceFusedStep(group, mask_entries, pred_node, device)
            logger.info("fused %d transformer steps onto %s: %s",
                        len(group), fused.program.device, fused.describe())
            out.append(fused)
            schema = run_schema
            i = j
        else:
            out.append(steps[i])
            schema = steps[i].result_schema(schema)
            i += 1
    return out
