"""Fused device transform program: HMAC mask + row predicate per batch.

The port of transferia_tpu/ops/fused.py `FusedMaskFilterProgram`.  One
run of a batch (or of each chunk of it) stages the host-packed SHA
blocks and the encoded predicate columns on the card, then launches, on
one compute stream:
  - kernel K-A (HMAC-SHA256) once per masked column;
  - kernel K-B once per encoded predicate array (data and validity);
  - kernel K-C once: the three-valued predicate, keep mask bit-packed
    when the dispatch encoding is on.
Raw (N, 8) digest words and the keep mask come back to pinned host
buffers; the host expands digests to hex (columnar/hexcol.py).  Fusing
the three kernels into one launch is later work (ROADMAP.md).

Batches larger than the chunk size (32768 rows on a CUDA device) run as
a double-buffered pipeline: chunk k+1's host pack and H2D (on a copy
stream) overlap chunk k's kernels and chunk k-1's D2H (on the compute
stream), ordered by CUDA events.

With TRANSFERIA_TPU_PALLAS_PACK=1 on a CUDA device (`_pallas_pack_enabled`)
a masked column ships its flat bytes and offsets instead of host-packed
blocks, and kernel K12 (ops/raggedpack.py) packs them on the compute
stream just before K-A; the batch then runs as one launch, unchunked.
A program may run with no masked column at all (every masked column of
the step took the dictionary-pool route, transform/fused.py).
"""

from __future__ import annotations

import contextlib
import threading
import time as _time
from collections import deque
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from transferia_tpu_torch import native
from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.columnar.batch import bucket_rows
from transferia_tpu_torch.columnar.hexcol import digests_to_hex
from transferia_tpu_torch.ops.dispatch import (
    decode_pred_device,
    encode_pred_column,
    encoding_enabled,
    stage_h2d_counted,
    unpack_mask_host,
)
from transferia_tpu_torch.ops.raggedpack import check_rows_fit, ragged_pack
from transferia_tpu_torch.ops.sha256 import (
    _hmac_key_states,
    hmac_device_core,
    prepare_padded_blocks,
)
from transferia_tpu_torch.runtime import knobs
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats import stagetimer, trace
from transferia_tpu_torch.stats.trace import TELEMETRY
from transferia_tpu_torch.weights import as_key_state

_chunk_rows_forced: Optional[int] = None


def _chunk_rows(device: torch.device) -> int:
    """Chunk size for pipelined dispatch; 0 disables chunking.

    32768 rows on a CUDA device (enough work per launch to amortize it,
    small enough for 4 chunks per 131k batch); 0 on the CPU, where
    pipelining only adds overhead, and through a link whose launch
    overhead exceeds 5 ms.  TRANSFERIA_TPU_CHUNK_ROWS overrides (0 = off);
    set_chunk_rows forces it.
    """
    if _chunk_rows_forced is not None:
        return _chunk_rows_forced
    env = knobs.env_raw("TRANSFERIA_TPU_CHUNK_ROWS")
    if env is not None:
        return max(0, int(env))
    if device.type == "cpu":
        return 0
    from transferia_tpu_torch.ops.linkprobe import probe_link

    return 0 if probe_link(device).launch_overhead_s > 0.005 else 32768


def set_chunk_rows(n: Optional[int]) -> None:
    """Force the pipelined-dispatch chunk size (None = re-detect)."""
    global _chunk_rows_forced
    _chunk_rows_forced = n


def _dispatch_depth() -> int:
    """Launches kept in flight by the pipelined path.
    TRANSFERIA_TPU_DISPATCH_DEPTH overrides; floor 1."""
    return max(1, knobs.env_int("TRANSFERIA_TPU_DISPATCH_DEPTH", 2))


def _pallas_pack_enabled(device: torch.device) -> bool:
    """Opt-in device-side ragged pack (kernel K12, ops/raggedpack.py),
    under the reference's knob name TRANSFERIA_TPU_PALLAS_PACK=1, and
    only on a CUDA device.  It ships the flat bytes (about half the
    padded blocks' bytes for short strings) at the cost of one more
    launch and of the chunked pipeline's overlap."""
    return (knobs.env_str("TRANSFERIA_TPU_PALLAS_PACK", "") == "1"
            and device.type == "cuda")


def pow2_blocks(max_len: int) -> int:
    """Block count bucket for a max row length (bytes, before padding)."""
    nb = (max_len + 9 + 63) // 64
    return 1 << (nb - 1).bit_length() if nb > 1 else 1


def pack_hmac_blocks(data: np.ndarray, offsets: np.ndarray,
                     max_blocks: int) -> tuple[np.ndarray, np.ndarray]:
    """Flat bytes+offsets -> ((N, max_blocks*64) padded HMAC message
    blocks, (N,) block counts) on the host, in one host-library call
    (`pack_sha_blocks`, GIL released, so part threads overlap the pack
    with the card).  The 64-byte ipad block is virtual (compressed
    separately from the cached key state), so the lengths in the padding
    include it."""
    n = len(offsets) - 1
    off = np.ascontiguousarray(offsets, dtype=np.int32)
    width = max_blocks * 64
    if n:
        # the C loop writes each row into its width unchecked
        needed = (int((off[1:] - off[:-1]).max()) + 9 + 63) // 64
        if needed > max_blocks:
            raise ValueError(f"rows need {needed} SHA blocks > forced "
                             f"bucket {max_blocks}")
    out = np.empty((n, width), dtype=np.uint8)
    n_blocks = np.empty(n, dtype=np.int32)
    native.lib().pack_sha_blocks(np.ascontiguousarray(data), off, n, width,
                                 64, out, n_blocks)
    return out, n_blocks


def pack_hmac_blocks_plain(data: np.ndarray, offsets: np.ndarray,
                           max_blocks: int
                           ) -> tuple[np.ndarray, np.ndarray]:
    """pack_hmac_blocks through numpy (`prepare_padded_blocks`)."""
    blocks, n_blocks, _ = prepare_padded_blocks(
        data, offsets, prefix_len=64, max_blocks=max_blocks)
    return blocks, n_blocks


class _Staged(NamedTuple):
    # per masked column: (blocks (bucket, mb*64) uint8, n_blocks
    # (bucket,) int32) packed on the host, or, when `devpack`, the
    # column's (flat uint8 bytes, (n+1,) int32 offsets) for K12
    mask: tuple
    devpack: bool
    pred: tuple            # per predicate column: its staged arrays
    max_blocks: tuple
    pred_specs: tuple
    bucket: int
    n_rows: int
    pack_keep: bool
    h2d_done: Optional[torch.cuda.Event]
    h2d: int               # bytes staged


class _InFlight(NamedTuple):
    digests: list          # host (or CPU) (bucket, 8) int32 tensors
    keep: Optional[torch.Tensor]
    n_rows: int
    pack_keep: bool
    done: Optional[torch.cuda.Event]
    staged: _Staged        # keeps device inputs alive until done


def _to_host(t: torch.Tensor) -> torch.Tensor:
    """Enqueue a D2H copy into a pinned buffer on the current stream."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


class FusedMaskFilterProgram:
    """HMAC every masked column and evaluate the keep predicate, on one
    device.

    mask_keys: HMAC key per masked column (parallel to the columns the
    caller passes); pred_node: predicate AST or None; the caller supplies
    the predicate columns as (data, validity) arrays.
    """

    # lowered predicate programs shared across instances, keyed by the
    # predicate AST repr (frozen dataclasses — the repr is the full
    # content), each with its table on the cards that run it.  Bounded
    # FIFO: a long-lived worker cycling through transfers with distinct
    # predicate constants must not pin a program per constant forever.
    _program_cache: dict = {}
    _PROGRAM_CACHE_MAX = 64
    _cache_lock = threading.Lock()

    def __init__(self, mask_keys: Sequence[bytes], pred_node=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._states = [_hmac_key_states(bytes(k), self.device)
                        for k in mask_keys]
        self._pred = None
        if pred_node is not None:
            self._pred = self._lowered(pred_node, (self.device,))
        self._copy_stream = self._compute_stream = None
        if self.device.type == "cuda":
            self._copy_stream = torch.cuda.Stream(self.device)
            self._compute_stream = torch.cuda.Stream(self.device)

    @classmethod
    def _lowered(cls, pred_node, devices):
        """The cached program of `pred_node`, its table uploaded to
        each CUDA device of `devices` (once per program and device)."""
        from transferia_tpu_torch.predicate.device import (
            compile_mask_program,
        )

        key = repr(pred_node)
        with cls._cache_lock:
            program = cls._program_cache.get(key)
            if program is None:
                program = compile_mask_program(pred_node)
                while len(cls._program_cache) >= cls._PROGRAM_CACHE_MAX:
                    cls._program_cache.pop(next(iter(cls._program_cache)))
                cls._program_cache[key] = program
        for dev in devices:
            if dev.type == "cuda":
                program.on_device(dev)
        return program

    def run(self, mask_cols: Sequence[tuple[np.ndarray, np.ndarray]],
            pred_cols: dict[str, tuple[np.ndarray, Optional[np.ndarray]]],
            n_rows: int, states: Optional[list] = None
            ) -> tuple[list[np.ndarray], Optional[np.ndarray]]:
        """mask_cols: per masked column (flat uint8 data, int32 offsets).
        pred_cols: name -> (fixed-width data, validity or None).
        states: HMAC key states parallel to mask_cols, the port's tensors
        or the JAX package's numpy arrays (weights.py); defaults to the
        constructor's.
        Returns ([hex (n_rows, 64) per masked column], keep mask or None).
        """
        failpoint("device.dispatch")
        # one parent span per batch run: pack / device_dispatch /
        # device_wait nest under it, so a chunked pipelined run reads
        # as one causally-grouped unit in the timeline
        with trace.span("fused_run", rows=n_rows):
            states = (self._states if states is None else
                      [as_key_state(s, self.device) for s in states])
            if self.device.type == "cuda":
                # work the caller enqueued before this run (key states,
                # inputs) is visible to both of the program's streams
                current = torch.cuda.current_stream(self.device)
                self._copy_stream.wait_stream(current)
                self._compute_stream.wait_stream(current)
            chunk = _chunk_rows(self.device)
            if chunk and n_rows > chunk and not _pallas_pack_enabled(
                    self.device):
                return self._run_pipelined(mask_cols, pred_cols, n_rows,
                                           chunk, states)
            return self._run_single(mask_cols, pred_cols, n_rows, states)

    def _stage(self, mask_cols, pred_cols, n_rows, bucket) -> _Staged:
        """Pack + encode on the host and enqueue the (async) H2D of one
        chunk — compute does NOT launch here, so a pipelined caller can
        overlap this chunk's transfer with the previous chunk's
        kernels."""
        devpack = _pallas_pack_enabled(self.device)
        enc = encoding_enabled()
        specs, arrays = [], []
        pack_t0 = _time.perf_counter()
        with trace.span("pack"):
            mask_t, mb_t = self._pack_inputs(mask_cols, n_rows, bucket,
                                             devpack)
            # what the raw wire ships: padded blocks and counts per
            # masked column, each predicate column's dtype bytes and a
            # bool map
            raw = sum((mb * 64 + 4) * bucket for mb in mb_t)
            for name, (data, validity) in pred_cols.items():
                spec, arrs = encode_pred_column(
                    name, data, validity, n_rows, bucket, enc)
                specs.append(spec)
                arrays.append(arrs)
                raw += bucket * data.dtype.itemsize + bucket
        stagetimer.add("pack", _time.perf_counter() - pack_t0)
        (mask, pred), event, h2d = stage_h2d_counted(
            (tuple(mask_t), tuple(arrays)), self.device, self._copy_stream,
            raw_equiv_bytes=raw)
        pack_keep = self._pred is not None and enc
        return _Staged(mask, devpack, pred, tuple(mb_t), tuple(specs),
                       bucket, n_rows, pack_keep, event, h2d)

    @staticmethod
    def _pack_inputs(mask_cols, n_rows, bucket, devpack):
        """Per masked column, what crosses the link: host-packed blocks
        (pad rows carry n_blocks = 0 and never update state), or for K12
        the flat bytes the offsets cover, rebased to start at 0."""
        mask_t, mb_t = [], []
        for data, offsets in mask_cols:
            lens = offsets[1:] - offsets[:-1]
            max_len = int(lens.max()) if n_rows else 0
            mb = pow2_blocks(max_len)
            if devpack:
                offsets = np.ascontiguousarray(offsets, dtype=np.int32)
                check_rows_fit(offsets, mb)
                lo = int(offsets[0])
                mask_t.append((np.ascontiguousarray(
                    data[lo:int(offsets[-1])]),
                    (offsets - lo).astype(np.int32, copy=False)))
            else:
                blocks, n_blocks = pack_hmac_blocks(data, offsets, mb)
                if bucket != n_rows:
                    blocks = np.pad(blocks, ((0, bucket - n_rows), (0, 0)))
                    n_blocks = np.pad(n_blocks, (0, bucket - n_rows))
                mask_t.append((blocks, n_blocks))
            mb_t.append(mb)
        return mask_t, mb_t

    def _stream(self):
        if self._compute_stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._compute_stream)

    def _launch(self, staged: _Staged, states) -> _InFlight:
        """Launch the kernels over a staged chunk (async) and enqueue
        the D2H of its results; does not wait for them."""
        from transferia_tpu_torch.predicate.device import pred3vl_mask

        TELEMETRY.record_launch()
        # times the enqueue only: nothing here waits on the card
        with stagetimer.stage("device_dispatch"), \
                trace.span("device_dispatch", bytes=staged.h2d,
                           rows=staged.n_rows), \
                self._stream():
            stream = self._compute_stream
            if stream is not None:
                stream.wait_event(staged.h2d_done)
                for t in _tensors(staged):
                    t.record_stream(stream)
            packed = staged.mask
            if staged.devpack:
                packed = [ragged_pack(data, offsets, staged.bucket, mb)
                          for (data, offsets), mb in zip(staged.mask,
                                                         staged.max_blocks)]
            digests = [
                hmac_device_core(b, nb, st[0], st[1], mb)
                for (b, nb), st, mb in zip(packed, states,
                                           staged.max_blocks)
            ]
            keep = None
            if self._pred is not None:
                cols = [decode_pred_device(spec, arrs, staged.bucket)
                        for spec, arrs in zip(staged.pred_specs,
                                              staged.pred)]
                keep = pred3vl_mask(self._pred, cols, staged.bucket,
                                    staged.pack_keep, self.device)
            done = None
            if stream is not None:
                digests = [_to_host(d) for d in digests]
                keep = _to_host(keep) if keep is not None else None
                done = torch.cuda.Event()
                done.record(stream)
        return _InFlight(digests, keep, staged.n_rows, staged.pack_keep,
                         done, staged)

    def _collect(self, inflight: _InFlight
                 ) -> tuple[list[np.ndarray], Optional[np.ndarray]]:
        """Wait for a launch's D2H, trim bucket padding, hex-expand."""
        n_rows = inflight.n_rows
        t0 = _time.perf_counter()
        with stagetimer.stage("device_wait"), \
                trace.span("device_wait") as sp:
            if inflight.done is not None:
                inflight.done.synchronize()
            # digests_to_hex and unpack_mask_host allocate fresh arrays,
            # so nothing returned aliases a (reusable) pinned buffer
            hexes = [digests_to_hex(d.numpy().view(np.uint32)[:n_rows])
                     for d in inflight.digests]
            keep = None
            if inflight.keep is not None:
                if inflight.pack_keep:
                    keep = unpack_mask_host(
                        inflight.keep.numpy().view(np.uint32), n_rows)
                else:
                    keep = inflight.keep.numpy()[:n_rows].copy()
            d2h = sum(int(d.nbytes) for d in inflight.digests)
            if inflight.keep is not None:
                d2h += int(inflight.keep.nbytes)
            if sp:  # args must attach before the span ends
                sp.add(bytes=d2h, rows=n_rows)
        TELEMETRY.record_d2h(d2h)
        TELEMETRY.record_kernel(_time.perf_counter() - t0)
        return hexes, keep

    def _run_single(self, mask_cols, pred_cols, n_rows, states):
        staged = self._stage(mask_cols, pred_cols, n_rows,
                             bucket_rows(n_rows))
        return self._collect(self._launch(staged, states))

    def _run_pipelined(self, mask_cols, pred_cols, n_rows, chunk, states,
                       depth: Optional[int] = None):
        """Split the batch into fixed-size chunks and keep `depth` launches
        in flight, with one chunk's H2D always staged AHEAD of the
        compute launches: stage(k+1) overlaps compute(k) and D2H(k-1)."""
        if depth is None:
            depth = _dispatch_depth()
        staged_q: deque = deque()
        inflight: deque = deque()
        hex_parts: list[list[np.ndarray]] = []
        keep_parts: list[np.ndarray] = []

        def drain_one():
            hexes, keep = self._collect(inflight.popleft())
            hex_parts.append(hexes)
            if keep is not None:
                keep_parts.append(keep)

        for lo in range(0, n_rows, chunk):
            hi = min(lo + chunk, n_rows)
            rows = hi - lo
            sub_mask = []
            for data, offsets in mask_cols:
                base = int(offsets[lo])
                sub_off = (offsets[lo:hi + 1] - base).astype(
                    offsets.dtype, copy=False)
                sub_mask.append((data[base:int(offsets[hi])], sub_off))
            sub_pred = {
                name: (data[lo:hi],
                       validity[lo:hi] if validity is not None else None)
                for name, (data, validity) in pred_cols.items()
            }
            staged_q.append(self._stage(sub_mask, sub_pred, rows,
                                        bucket_rows(rows)))
            # launch all but the freshest chunk: its H2D streams while
            # the previous chunk's kernels run (double-buffered H2D)
            while len(staged_q) > 1:
                inflight.append(self._launch(staged_q.popleft(), states))
            while len(inflight) > depth:
                drain_one()
        while staged_q:
            inflight.append(self._launch(staged_q.popleft(), states))
        while inflight:
            drain_one()
        hexes = [np.concatenate([p[i] for p in hex_parts])
                 for i in range(len(mask_cols))]
        keep = (np.concatenate(keep_parts) if self._pred is not None
                else None)
        return hexes, keep


def _tensors(staged: _Staged):
    """Every device tensor of a staged chunk."""
    def walk(x):
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, tuple):
            for a in x:
                yield from walk(a)

    yield from walk((staged.mask, staged.pred))
