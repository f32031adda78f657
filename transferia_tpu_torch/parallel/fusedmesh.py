"""Mesh-sharded fused mask+filter program (kernel K14).

The port of transferia_tpu/parallel/fusedmesh.py: the multi-shard form
of ops/fused.py `FusedMaskFilterProgram`, which transform/fused.py
`DeviceFusedStep` runs instead of the single-device program when the
mesh has more than one shard and the batch is large enough.

Layout, as the reference's: the batch pads to `per_shard * n_shards`
rows with `per_shard = bucket_rows(ceil(n_rows / n_shards))`, and shard
s holds rows `s*per_shard ..` (so the last shards may hold only
padding).  The host packs each flat masked column's SHA blocks and
encodes the predicate columns and the run validity per shard
(ops/dispatch.py `encode_pred_column_sharded`); a dictionary column
ships its int32 codes per shard and its pool's digest matrix whole
(`DictMaskInput`).  The batch stages once per physical device.  Then,
per shard, on its own stream:
  - kernel K-B decodes the predicate columns;
  - kernel K-A hashes each flat column's blocks;
  - kernel K14 `digest_gather` (csrc/mesh.cu `trt_digest_gather`)
    gathers each dict column's per-row digest words by code;
  - kernel K-C evaluates the predicate (keep mask packed when encoded);
  - kernel K13/K14 `shard_hist_fused` counts the kept, valid rows per
    target shard over the first masked column's digests.
The shards' partials sum on the mesh's first device (the reference's
two psums), and the digest words and keep mask come back to pinned host
buffers.  `digest_gather` runs its plain PyTorch version on a CPU
tensor.
"""

from __future__ import annotations

import time as _time
from typing import Optional, Sequence

import numpy as np
import torch

from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import bucket_rows
from transferia_tpu_torch.columnar.hexcol import digests_to_hex
from transferia_tpu_torch.ops import _build
from transferia_tpu_torch.ops.dispatch import (
    _pool_max_blocks,
    decode_pred_device_sharded,
    device_hmac_pool_digests,
    encode_pred_column_sharded,
    encode_validity_sharded,
    encoding_enabled,
    unpack_mask_host,
)
from transferia_tpu_torch.ops.fused import (
    FusedMaskFilterProgram,
    pack_hmac_blocks,
    pow2_blocks,
)
from transferia_tpu_torch.ops.sha256 import _hmac_key_states, hmac_device_core
from transferia_tpu_torch.parallel.mesh import (
    Mesh,
    check_shards,
    make_mesh,
    on_stream,
    shard_hist_fused,
    shard_streams,
    stage_sharded,
    sum_partials,
    wait_for_caller,
)
from transferia_tpu_torch.runtime.device import DeviceLike
from transferia_tpu_torch.stats import stagetimer, trace
from transferia_tpu_torch.stats.trace import TELEMETRY
from transferia_tpu_torch.weights import as_key_state


class DictMaskInput:
    """A dictionary-encoded masked column on the mesh wire: its row
    codes shard with the rows (4 bytes a row) and the pool's memoized
    HMAC digest matrix (ops/dispatch.py `device_hmac_pool_digests`)
    goes to every device whole; each shard gathers its rows' digest
    words by code.  Equal bytes hash equal, and a null row carries the
    pool's empty-bytes sentinel code, so the digests equal the flat
    route's.  `raw_block_bytes_per_row` is what the flat route would
    have shipped for the column (the raw-wire accounting)."""

    __slots__ = ("codes", "digests", "raw_block_bytes_per_row")

    def __init__(self, codes: np.ndarray, digests: np.ndarray,
                 raw_block_bytes_per_row: int):
        self.codes = np.ascontiguousarray(codes, dtype=np.int32)
        self.digests = np.ascontiguousarray(digests, dtype=np.uint32)
        self.raw_block_bytes_per_row = int(raw_block_bytes_per_row)


def dict_mask_input(key: bytes, col,
                    device: DeviceLike = None) -> Optional[DictMaskInput]:
    """The mesh wire form of a lazy dictionary masked column (its pool
    hashed on `device` by one K-A launch, memoized), or None when the
    pool is too large to pay for itself on this batch (the caller then
    ships the flat blocks)."""
    pool = col.dict_enc.pool
    digests = device_hmac_pool_digests(bytes(key), pool, col.n_rows, device)
    if digests is None:
        return None
    return DictMaskInput(col.dict_enc.indices, digests,
                         _pool_max_blocks(pool) * 64 + 4)


# -- kernel K14's digest gather and its plain version ----------------------------

def digest_gather(table: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """out[r] = table[clip(codes[r], 0, k - 1)]: (n, 8) int32 digest
    words gathered by code from a (k, 8) int32 table (jnp.take with
    mode="clip": an out-of-range code clips, it does not raise).  A
    CUDA tensor runs kernel K14 (`trt_digest_gather`); a CPU tensor the
    plain version."""
    dev = codes.device
    _build.require(table.dtype == torch.int32 and table.dim() == 2
                   and table.shape[1] == 8 and table.is_contiguous()
                   and table.device == dev,
                   "table must be a contiguous (k, 8) int32 on the codes' "
                   "device")
    _build.require(codes.dtype == torch.int32 and codes.dim() == 1
                   and codes.is_contiguous(),
                   "codes must be a contiguous 1-D int32")
    n = codes.numel()
    _build.require(n == 0 or table.shape[0] > 0,
                   "an empty table cannot serve codes")
    if dev.type == "cpu":
        return digest_gather_plain(table, codes)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    _build.require(table.data_ptr() % 16 == 0,
                   "the kernel reads the table in 16-byte rows: it must be "
                   "16-byte aligned")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.library("mesh")
    rc = lib.trt_digest_gather(table.data_ptr(), table.shape[0],
                               codes.data_ptr(), n, out.data_ptr(),
                               _build.stream_of(codes))
    _build.check(lib, rc, "digest_gather")
    _build.count_launch("digest_gather")
    return out


def digest_gather_plain(table: torch.Tensor,
                        codes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of `digest_gather`."""
    if codes.numel() == 0:
        return torch.empty((0, 8), dtype=torch.int32, device=codes.device)
    return table[codes.to(torch.int64).clamp(0, table.shape[0] - 1)]


# -- the program -------------------------------------------------------------------

def _host_buffer(shape, dtype, pin: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=pin)


class ShardedFusedProgram:
    """Row-sharded HMAC mask + predicate over a mesh.

    The same run() contract as FusedMaskFilterProgram.run(), and two
    side results of the cross-shard sums: `last_kept` (kept rows of the
    batch) and `last_shard_hist` ((n_shards,) int32 kept rows per
    `digest word 0 % n_shards` of the first masked column).  The mesh
    defaults to `make_mesh(device=device)`."""

    def __init__(self, mask_keys: Sequence[bytes], pred_node,
                 mesh: Optional[Mesh] = None, n_shards: int = 16,
                 device: DeviceLike = None):
        check_shards(n_shards)
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.n_dev = self.mesh.size
        self.device = self.mesh.flat_devices()[0]
        self.n_shards = n_shards
        physical = list(self.mesh.shards_by_device())
        self._states = [{d: _hmac_key_states(bytes(k), d) for d in physical}
                        for k in mask_keys]
        self._pred = (FusedMaskFilterProgram._lowered(pred_node, physical)
                      if pred_node is not None else None)
        self.last_kept: int = 0
        self.last_shard_hist: Optional[np.ndarray] = None
        self._compute, self._copy = shard_streams(self.mesh)

    def run(self, mask_cols: Sequence,
            pred_cols: dict[str, tuple[np.ndarray, Optional[np.ndarray]]],
            n_rows: int, states: Optional[list] = None
            ) -> tuple[list[np.ndarray], Optional[np.ndarray]]:
        """mask_cols: per masked column a (flat uint8 data, int32
        offsets) pair or a DictMaskInput; pred_cols: name -> (data,
        validity or None).  states: HMAC key states parallel to
        mask_cols (the port's tensors or the JAX package's numpy arrays,
        weights.py); defaults to the constructor's keys.
        Returns ([hex (n_rows, 64) per masked column], keep or None)."""
        if not mask_cols:
            raise ValueError("the mesh program needs a masked column")
        failpoint("device.mesh_dispatch")
        pack_t0 = _time.perf_counter()
        n_dev = self.n_dev
        per = bucket_rows(max(1, -(-n_rows // n_dev)))
        total = per * n_dev
        encoded = encoding_enabled()
        physical = list(self.mesh.shards_by_device())
        if states is None:
            states = self._states
        else:
            states = [{d: as_key_state(st, d) for d in physical}
                      for st in states]
        entries: list = []
        plan: list = []   # per masked column: (route, max_blocks, states)
        raw_equiv = 0
        for entry, st in zip(mask_cols, states):
            if isinstance(entry, DictMaskInput):
                codes = entry.codes
                if total != n_rows:
                    codes = np.pad(codes, (0, total - n_rows))
                entries += [(codes.reshape(n_dev, per), "shard"),
                            (entry.digests, "rep")]
                plan.append(("dict", 0, None))
                raw_equiv += entry.raw_block_bytes_per_row * total
                continue
            data, offsets = entry
            lens = offsets[1:] - offsets[:-1]
            mb = pow2_blocks(int(lens.max()) if n_rows else 0)
            blocks, n_blocks = pack_hmac_blocks(data, offsets, mb)
            if total != n_rows:
                blocks = np.pad(blocks, ((0, total - n_rows), (0, 0)))
                n_blocks = np.pad(n_blocks, (0, total - n_rows))
            entries += [(blocks.reshape(n_dev, per, mb * 64), "shard"),
                        (n_blocks.reshape(n_dev, per), "shard")]
            plan.append(("flat", mb, st))
            raw_equiv += blocks.nbytes + n_blocks.nbytes
        pred_specs = []
        for name in sorted(pred_cols):
            data, validity = pred_cols[name]
            spec, arrays, req = encode_pred_column_sharded(
                name, data, validity, n_rows, n_dev, per, encoded)
            if spec.kind == "delta":
                # a shard's base is a kernel argument, not a device array
                arrays = ((arrays[0], tuple(int(b) for b in arrays[1]))
                          + arrays[2:])
            entries += [(a, "shard") for a in arrays]
            pred_specs.append((name, spec, len(arrays)))
            raw_equiv += req
        valid = np.zeros(total, dtype=np.bool_)
        valid[:n_rows] = True
        valid = valid.reshape(n_dev, per)
        entries.append((encode_validity_sharded(valid) if encoded else valid,
                        "shard"))
        raw_equiv += total  # the flat bool run-validity mask
        stagetimer.add("pack", _time.perf_counter() - pack_t0)

        wait_for_caller(self.mesh, self._compute, self._copy)
        views, events, h2d = stage_sharded(self.mesh, entries, self._copy,
                                           raw_equiv)
        pin = self.device.type == "cuda"
        host_digests = [_host_buffer((total, 8), torch.int32, pin)
                        for _ in plan]
        host_keep = None
        if self._pred is not None:
            host_keep = (_host_buffer((n_dev, per // 32), torch.int32, pin)
                         if encoded else
                         _host_buffer((n_dev, per), torch.bool, pin))
        partials, done = [], []
        TELEMETRY.record_launch()
        # times the enqueue only: nothing here waits on the card
        with stagetimer.stage("device_dispatch"), \
                trace.span("device_dispatch", bytes=h2d, rows=n_rows,
                           mesh=n_dev):
            for s, dev in enumerate(self.mesh.flat_devices()):
                partials.append(self._run_shard(
                    s, dev, views[s], events[s], plan, pred_specs, per,
                    encoded, host_digests, host_keep, done))
            reduce_stream = self._compute[0]
            sums = sum_partials(partials, self.device, reduce_stream, done)
        t_wait0 = _time.perf_counter()
        with stagetimer.stage("device_wait"), \
                trace.span("device_wait") as sp:
            with on_stream(reduce_stream):
                # waits for every shard: the reduce stream waited on
                # each shard's last event before the sum
                sums = sums.cpu().numpy()
            self.last_shard_hist = sums[:self.n_shards].copy()
            self.last_kept = int(sums[self.n_shards])
            hexes = [digests_to_hex(h.numpy().view(np.uint32)[:n_rows])
                     for h in host_digests]
            keep = None
            if host_keep is not None:
                if encoded:
                    keep = unpack_mask_host(
                        host_keep.numpy().view(np.uint32).reshape(-1),
                        n_rows)
                else:
                    keep = host_keep.numpy().reshape(-1)[:n_rows].copy()
            d2h = (sum(int(h.nbytes) for h in host_digests)
                   + int(sums.nbytes))
            if host_keep is not None:
                d2h += int(host_keep.nbytes)
            if sp:  # args must attach before the span ends
                sp.add(bytes=d2h, rows=n_rows)
        TELEMETRY.record_d2h(d2h)
        TELEMETRY.record_kernel(_time.perf_counter() - t_wait0)
        return hexes, keep

    def _run_shard(self, s, dev, local, event, plan, pred_specs, per,
                   encoded, host_digests, host_keep, done) -> torch.Tensor:
        """Launch shard s's kernels on its stream and enqueue its D2H
        copies; returns its (n_shards + 1,) int32 partial."""
        from transferia_tpu_torch.predicate.device import pred3vl_mask

        stream = self._compute[s]
        with on_stream(stream):
            if stream is not None:
                stream.wait_event(event)
                for t in local:
                    if isinstance(t, torch.Tensor):
                        t.record_stream(stream)
            it = iter(local)
            digests = []
            for route, mb, st in plan:
                if route == "dict":
                    codes, table = next(it), next(it)
                    digests.append(digest_gather(table, codes[0]))
                else:
                    blocks, n_blocks = next(it), next(it)
                    inner, outer = st[dev]
                    digests.append(hmac_device_core(blocks[0], n_blocks[0],
                                                    inner, outer, mb))
            cols = {name: decode_pred_device_sharded(
                        spec, tuple(next(it) for _ in range(n_arr)), per)
                    for name, spec, n_arr in pred_specs}
            valid = next(it)[0]
            keep = None
            if self._pred is not None:
                keep = pred3vl_mask(self._pred,
                                    [cols[c] for c in self._pred.columns],
                                    per, encoded, dev)
            partial = shard_hist_fused(digests[0], self.n_shards, valid, keep)
            rows = slice(s * per, (s + 1) * per)
            for host, d in zip(host_digests, digests):
                host[rows].copy_(d, non_blocking=True)
            if keep is not None:
                host_keep[s].copy_(keep, non_blocking=True)
            if stream is not None:
                ev = torch.cuda.Event()
                ev.record(stream)
                done.append(ev)
        return partial
