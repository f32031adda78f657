"""Compressed device dispatch: ship encoded columns, decode on device.

The host half of transferia_tpu/ops/dispatch.py, copied: predicate
columns cross the host-to-device link in their compact encodings
(bit-packed validity and bool data, delta+bit-pack or frame-of-reference
integers) and kernel K-B (ops/decode.py) reconstructs them on the card.
The keep mask returns bit-packed (kernel K-C packs it).

`TRANSFERIA_TPU_DISPATCH_ENCODING` picks the mode: `auto` (default —
encode whenever it shrinks) or `raw`.  In `auto`, a dictionary-encoded
masked column takes the pool route (`device_hmac_dict_pool`): its value
pool is hashed once on the card (kernel K-A over the pool's values) and
the row codes never cross the link.  The mesh (parallel/fusedmesh.py)
ships the same encodings per shard (`encode_pred_column_sharded`): each
shard's rows encode alone, with one bit width shared across shards.

`stage_h2d_counted` is the single host-to-device point: it copies host
arrays into pinned buffers and enqueues non-blocking copies on a copy
stream, and counts the bytes staged beside what the uncompressed wire
would have shipped (`dispatch_bytes`, and `TELEMETRY.record_h2d` and
`record_dispatch` from the same numbers).  The `dispatch.h2d` failpoint
and the `device_decode` span live there, as in the reference.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from transferia_tpu_torch.chaos.failpoints import failpoint
from transferia_tpu_torch.runtime import knobs
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device
from transferia_tpu_torch.stats import trace
from transferia_tpu_torch.stats.trace import TELEMETRY

_mode_cached: Optional[str] = None

# zigzag'd deltas wider than this fall back to raw: the device prefix
# sum runs in int32 and must never wrap (30 bits of |delta| keeps every
# partial sum an exact int32), and past ~30 bits the shrink is gone
_DELTA_MAX_BITS = 30
# below this many rows the encode/decode round trip costs more than the
# handful of saved bytes
_DELTA_MIN_ROWS = 256

_for_frame_cached: Optional[int] = None


def for_frame() -> int:
    """Frame size of the frame-of-reference integer encoding
    (TRANSFERIA_TPU_FOR_FRAME; default 256 — every row bucket is a
    multiple; 0 disables FOR)."""
    global _for_frame_cached
    if _for_frame_cached is None:
        _for_frame_cached = max(
            0, knobs.env_int("TRANSFERIA_TPU_FOR_FRAME", 256))
    return _for_frame_cached


def set_for_frame(n: Optional[int]) -> None:
    """Force the FOR frame size (None = re-read the env)."""
    global _for_frame_cached
    _for_frame_cached = n


def dispatch_encoding() -> str:
    """auto (encode whenever it shrinks, default) | raw."""
    global _mode_cached
    if _mode_cached is None:
        mode = knobs.env_str(
            "TRANSFERIA_TPU_DISPATCH_ENCODING", "auto").lower()
        _mode_cached = mode if mode in ("auto", "raw") else "auto"
    return _mode_cached


def set_dispatch_encoding(mode: Optional[str]) -> None:
    """Force the dispatch encoding mode (None = re-read the env)."""
    global _mode_cached
    _mode_cached = mode


def encoding_enabled() -> bool:
    return dispatch_encoding() != "raw"


# -- host-side packers -------------------------------------------------------

def pack_bits_host(values: np.ndarray, bit_width: int) -> np.ndarray:
    """Non-negative values -> the little-endian packed uint32 word
    stream K-B consumes (value i occupies bits [i*bw, (i+1)*bw))."""
    n = len(values)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    shifts = np.arange(bit_width, dtype=np.uint64)
    bits = ((values.astype(np.uint64)[:, None] >> shifts) & 1).astype(
        np.uint8)
    packed = np.packbits(bits.reshape(-1), bitorder="little")
    pad = (-len(packed)) % 4
    if pad:
        packed = np.pad(packed, (0, pad))
    return packed.view(np.uint32)


def encode_validity(validity: np.ndarray) -> np.ndarray:
    """(n,) bool -> packed little-endian uint32 bitmap words."""
    packed = np.packbits(np.ascontiguousarray(validity, dtype=np.uint8),
                         bitorder="little")
    pad = (-len(packed)) % 4
    if pad:
        packed = np.pad(packed, (0, pad))
    return packed.view(np.uint32)


def unpack_mask_host(words: np.ndarray, n: int) -> np.ndarray:
    """Packed uint32 keep-mask words (D2H) -> (n,) bool, host side."""
    bits = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                         bitorder="little")
    return bits[:n].astype(np.bool_)


def _delta_plan(values: np.ndarray
                ) -> Optional[tuple[np.ndarray, np.ndarray, int]]:
    """The delta-encoding guard chain (values: (n_shards, per)).
    Returns (bases int32 (n_shards,), zigzag'd deltas uint64 (n_shards,
    per), bit_width) or None when any guard rejects: every value must
    fit int32 exactly, zigzag widths past _DELTA_MAX_BITS could wrap a
    partial sum, and the packed form must shrink the raw dtype."""
    n_shards, per = values.shape
    if values.dtype.kind not in "iu" or per < _DELTA_MIN_ROWS:
        return None
    v = values.astype(np.int64)
    if int(v.min()) < -2**31 or int(v.max()) > 2**31 - 1:
        return None
    bases = v[:, :1]
    deltas = np.diff(v, axis=1, prepend=bases)
    zz = ((deltas << 1) ^ (deltas >> 63)).astype(np.uint64)
    bw = max(1, int(zz.max()).bit_length())
    if bw > _DELTA_MAX_BITS:
        return None
    if bw * per >= values.dtype.itemsize * 8 * per:
        return None  # no shrink over the raw dtype
    return bases[:, 0].astype(np.int32), zz, bw


def encode_delta(data: np.ndarray
                 ) -> Optional[tuple[int, np.ndarray, int]]:
    """Delta+bit-pack an integer array: (base, packed words, bit_width),
    or None when the encoding would not shrink the transfer."""
    if data.ndim != 1:
        return None
    plan = _delta_plan(data.reshape(1, -1))
    if plan is None:
        return None
    bases, zz, bw = plan
    return int(bases[0]), pack_bits_host(zz[0], bw), bw


def _for_plan(values: np.ndarray
              ) -> Optional[tuple[np.ndarray, np.ndarray, int, int]]:
    """The frame-of-reference guard chain (values: (n_shards, per)).
    Returns (mins int32 (n_shards, n_frames), rel uint64 (n_shards,
    per), bit_width, frame) or None when any guard rejects: every value
    must fit int32 exactly, the frame must divide the padded row count,
    and packed remainders + per-frame mins must shrink the raw dtype."""
    frame = for_frame()
    n_shards, per = values.shape
    if (frame <= 0 or values.dtype.kind not in "iu"
            or per < _DELTA_MIN_ROWS or per % frame):
        return None
    v = values.astype(np.int64)
    if int(v.min()) < -2**31 or int(v.max()) > 2**31 - 1:
        return None
    framed = v.reshape(n_shards, per // frame, frame)
    mins = framed.min(axis=2)
    rel = (framed - mins[:, :, None]).reshape(n_shards, per) \
        .astype(np.uint64)
    bw = max(1, int(rel.max()).bit_length())
    if bw > 32:
        return None
    n_frames = per // frame
    if bw * per + n_frames * 32 >= values.dtype.itemsize * 8 * per:
        return None  # no shrink over the raw dtype
    return mins.astype(np.int32), rel, bw, frame


# -- per-column dispatch encodings ------------------------------------------

@dataclass(frozen=True)
class PredEnc:
    """Static half of one predicate column's dispatch encoding.

    kind: raw (dtype bytes as-is) | delta (base + packed zigzag deltas)
    | for (per-frame mins + packed remainders) | bits (bit-packed bool
    data).
    valid_mode: none (all-valid) | bits (bit-packed bitmap) | raw (bool
    bytes, the uncompressed wire).
    frame: FOR frame size (0 for every other kind).
    """

    name: str
    dtype: str
    kind: str
    bit_width: int
    valid_mode: str
    frame: int = 0


def encode_pred_column(name: str, data: np.ndarray,
                       validity: Optional[np.ndarray], n_rows: int,
                       bucket: int, encoded: bool
                       ) -> tuple[PredEnc, tuple]:
    """Encode one predicate column for dispatch: the mesh encoder over
    one shard (`encode_pred_column_sharded`), its shard axis stripped.

    Returns (spec, host arrays ready for H2D; a delta base as a numpy
    scalar).  Data pads to the bucket with its edge value (keeps delta
    widths narrow); validity pads False, so padded rows never pass the
    predicate regardless of data padding.
    """
    spec, arrays, _ = encode_pred_column_sharded(
        name, data, validity, n_rows, 1, bucket, encoded)
    return spec, tuple(a[0] for a in arrays)


def decode_pred_device(spec: PredEnc, arrays, bucket: int
                       ) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Decode one staged predicate column: (data, validity or None when
    every row is valid) — the column form kernel K-C reads.  Encoded
    kinds run kernel K-B; delta/FOR data stays int32."""
    from transferia_tpu_torch.ops.decode import (
        delta_prefix_sum,
        for_frame_decode,
        unpack_validity,
    )

    if spec.kind == "raw":
        data = arrays[0]
    elif spec.kind == "bits":
        data = unpack_validity(arrays[0], bucket)
    elif spec.kind == "for":
        data = for_frame_decode(arrays[0], arrays[1], spec.bit_width,
                                spec.frame, bucket)
    else:  # delta
        data = delta_prefix_sum(arrays[0], int(arrays[1]), spec.bit_width,
                                bucket)
    if spec.valid_mode == "none":
        valid = None
    elif spec.valid_mode == "bits":
        valid = unpack_validity(arrays[-1], bucket)
    else:
        valid = arrays[-1]
    return data, valid


# -- per-shard (mesh) dispatch encodings -------------------------------------
#
# The mesh wire ships every array with a leading shard axis: each shard's
# contiguous row chunk encodes on its own (a delta prefix sum or a packed
# bitmap cannot span a shard boundary: each shard decodes alone), with
# one bit width shared across shards.  parallel/fusedmesh.py is the only
# consumer.

def encode_validity_sharded(valid2d: np.ndarray) -> np.ndarray:
    """(n_shards, per) bool -> (n_shards, W) packed little-endian uint32
    bitmap words, each shard packed on its own."""
    packed = np.packbits(np.ascontiguousarray(valid2d, dtype=np.uint8),
                         axis=1, bitorder="little")
    pad = (-packed.shape[1]) % 4
    if pad:
        packed = np.pad(packed, ((0, 0), (0, pad)))
    return np.ascontiguousarray(packed).view(np.uint32)


def _encode_delta_sharded(d2: np.ndarray
                          ) -> Optional[tuple[np.ndarray, np.ndarray,
                                              int]]:
    """Per-shard delta+bit-pack: (bases (n_shards,) int32, words
    (n_shards, W), bit_width) or None when the `_delta_plan` guards
    reject."""
    plan = _delta_plan(d2)
    if plan is None:
        return None
    bases, zz, bw = plan
    words = np.stack([pack_bits_host(row, bw) for row in zz])
    return bases, words, bw


def _encode_for_sharded(d2: np.ndarray
                        ) -> Optional[tuple[np.ndarray, np.ndarray,
                                            int, int]]:
    """Per-shard frame-of-reference pack: (mins (n_shards, n_frames)
    int32, words (n_shards, W), bit_width, frame) or None when the
    `_for_plan` guards reject.  A frame never spans a shard boundary
    (the rows per shard are a bucket, a multiple of the frame)."""
    plan = _for_plan(d2)
    if plan is None:
        return None
    mins, rel, bw, frame = plan
    words = np.stack([pack_bits_host(row, bw) for row in rel])
    return mins, words, bw, frame


def encode_pred_column_sharded(name: str, data: np.ndarray,
                               validity: Optional[np.ndarray],
                               n_rows: int, n_shards: int, per_shard: int,
                               encoded: bool
                               ) -> tuple[PredEnc, tuple, int]:
    """Encode one predicate column for the mesh wire.

    Returns (spec, arrays each with a leading (n_shards, ...) axis,
    raw_equiv_bytes).  Padding as in encode_pred_column: data pads with
    its edge value, validity pads False, so pad rows never pass the
    predicate through their data."""
    total = n_shards * per_shard
    raw_equiv = total * data.dtype.itemsize + total  # data + bool map
    if total != n_rows:
        data = np.pad(data, (0, total - n_rows),
                      mode="edge" if n_rows else "constant")
        if validity is not None:
            validity = np.pad(validity, (0, total - n_rows))
    d2 = data.reshape(n_shards, per_shard)
    v2 = (validity.reshape(n_shards, per_shard)
          if validity is not None else None)
    if not encoded:
        if v2 is None:
            v2 = np.ones((n_shards, per_shard), dtype=np.bool_)
        return (PredEnc(name, str(data.dtype), "raw", 0, "raw"),
                (d2, v2), raw_equiv)
    if v2 is None:
        valid_mode, val_arrays = "none", ()
    else:
        valid_mode, val_arrays = "bits", (encode_validity_sharded(v2),)
    if data.dtype == np.bool_:
        spec = PredEnc(name, str(data.dtype), "bits", 1, valid_mode)
        return spec, (encode_validity_sharded(d2),) + val_arrays, \
            raw_equiv
    delta = _encode_delta_sharded(d2)
    if delta is not None:
        bases, words, bw = delta
        spec = PredEnc(name, str(data.dtype), "delta", bw, valid_mode)
        return spec, (words, bases) + val_arrays, raw_equiv
    forenc = _encode_for_sharded(d2)
    if forenc is not None:
        mins, words, bw, frame = forenc
        spec = PredEnc(name, str(data.dtype), "for", bw, valid_mode,
                       frame)
        return spec, (words, mins) + val_arrays, raw_equiv
    spec = PredEnc(name, str(data.dtype), "raw", 0, valid_mode)
    return spec, (d2,) + val_arrays, raw_equiv


def decode_pred_device_sharded(spec: PredEnc, arrays, bucket: int
                               ) -> tuple[torch.Tensor,
                                          Optional[torch.Tensor]]:
    """Decode one shard's rows of a mesh-encoded predicate column: every
    array arrives as the shard's local (1, ...) block (a delta base as a
    1-tuple of ints); strip the shard axis and run `decode_pred_device`
    (kernel K-B)."""
    return decode_pred_device(spec, tuple(a[0] for a in arrays), bucket)


# -- staged-bytes accounting --------------------------------------------------

_bytes_lock = threading.Lock()
_bytes = {"encoded": 0, "raw_equiv": 0}


def record_dispatch(encoded_bytes: int, raw_equiv_bytes: int) -> None:
    """One staging: the bytes that crossed the link, and what the
    uncompressed wire (padded SHA blocks, raw predicate columns) would
    have shipped for the same work."""
    TELEMETRY.record_dispatch(int(encoded_bytes), int(raw_equiv_bytes))
    with _bytes_lock:
        _bytes["encoded"] += int(encoded_bytes)
        _bytes["raw_equiv"] += int(raw_equiv_bytes)


def dispatch_bytes() -> dict[str, int]:
    """{"encoded": bytes staged, "raw_equiv": raw-wire equivalent} since
    the last reset."""
    with _bytes_lock:
        return dict(_bytes)


def reset_dispatch_bytes() -> None:
    with _bytes_lock:
        for k in _bytes:
            _bytes[k] = 0


# -- H2D staging -------------------------------------------------------------

def host_tensor(a: np.ndarray, pin: bool) -> torch.Tensor:
    """A numpy array as a CPU tensor (uint32 words become int32 with the
    same bits); `pin` copies it into page-locked memory."""
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    if not pin:
        if not a.flags.writeable or not a.flags.c_contiguous:
            a = np.array(a)
        return torch.from_numpy(a)
    t = torch.empty(a.shape,
                    dtype=torch.from_numpy(np.empty(0, a.dtype)).dtype,
                    pin_memory=True)
    t.numpy()[...] = a
    return t


def stage_h2d(arrays, device: torch.device,
              stream: Optional["torch.cuda.Stream"],
              raw_equiv_bytes: Optional[int] = None, what: str = "batch"):
    """`stage_h2d_counted` without the byte count: (tensors, event)."""
    staged, event, _ = stage_h2d_counted(arrays, device, stream,
                                         raw_equiv_bytes, what)
    return staged, event


def stage_h2d_counted(arrays, device: torch.device,
                      stream: Optional["torch.cuda.Stream"],
                      raw_equiv_bytes: Optional[int] = None,
                      what: str = "batch"):
    """Stage a nested tuple of host arrays on `device`.

    numpy arrays become tensors (on a CUDA device: pinned, copied with
    non_blocking on `stream`, or on the current stream when it is None);
    numpy scalars become Python ints (they travel as kernel arguments).
    Counts the arrays' bytes against `raw_equiv_bytes` (the arrays' own
    bytes when None), as one `TELEMETRY` transfer.  Returns (the same
    structure of tensors, an event recorded after the copies or None on
    the CPU, the bytes staged)."""
    failpoint("dispatch.h2d")
    cuda = device.type == "cuda"
    encoded = 0

    def put(x):
        nonlocal encoded
        if isinstance(x, tuple):
            return tuple(put(a) for a in x)
        if isinstance(x, np.ndarray):
            encoded += x.nbytes
            t = host_tensor(x, pin=cuda)
            return t.to(device, non_blocking=True) if cuda else t
        return int(x)

    with trace.span("device_decode", what=what) as sp:
        if not cuda:
            staged, event = put(arrays), None
        else:
            with torch.cuda.stream(stream):
                staged = put(arrays)
                event = torch.cuda.Event()
                event.record(stream)
        raw = encoded if raw_equiv_bytes is None else raw_equiv_bytes
        if sp:
            sp.add(encoded_bytes=encoded, raw_equiv_bytes=int(raw))
    TELEMETRY.record_h2d(encoded)
    record_dispatch(encoded, raw)
    return staged, event, encoded


# -- device-resident dict-pool masking ------------------------------------------

# serializes pool hashing, so threads racing on one pool upload it once
_pool_hash_lock = threading.Lock()


def device_hmac_dict_pool(key: bytes, pool, n_rows: int,
                          device: DeviceLike = None):
    """HMAC a DictPool's values on the card, once per (pool, key).

    Returns the hexed pool (a DictPool of 64-char hex digests with the
    null sentinel emptied), memoized on the shared pool under the same
    key as the host path (transform/plugins/mask.mask_dict_column):
    whichever strategy touches a pool first pays, the other rides the
    memo.  Row codes never cross the link: the caller rebinds them to
    the hexed pool.

    Returns None when the pool is too large to pay for itself on this
    batch (more than twice its rows): the caller then hashes the
    referenced subset on the host, still dict-encoded."""
    memo_key = ("hmac_hex", key)
    hexed = pool.memo_get(memo_key)
    if hexed is not None:
        TELEMETRY.record_pool_hit()
        _record_avoided_batch_bytes(pool, n_rows)
        return hexed
    if pool.n_values > 2 * max(n_rows, 1):
        return None
    with _pool_hash_lock:
        return _hash_pool_locked(key, pool, n_rows, memo_key,
                                 resolve_device(device))


def _hash_pool_locked(key: bytes, pool, n_rows: int, memo_key,
                      device: torch.device):
    # double-checked: a racing thread may have hashed this pool while
    # this one waited on the lock
    hexed = pool.memo_get(memo_key)
    if hexed is not None:
        TELEMETRY.record_pool_hit()
        _record_avoided_batch_bytes(pool, n_rows)
        return hexed
    from transferia_tpu_torch.columnar.hexcol import (
        digests_to_hex,
        hex_to_varwidth,
    )
    from transferia_tpu_torch.transform.plugins.mask import (
        hexed_pool_from_flat,
    )

    digest_rows = _pool_digest_rows_locked(key, pool, device)
    flat, flat_off = hex_to_varwidth(digests_to_hex(digest_rows), None)
    hexed = hexed_pool_from_flat(pool, flat, flat_off)
    pool.memo_set(memo_key, hexed)
    _record_avoided_batch_bytes(pool, n_rows)
    return hexed


def _pool_digest_rows_locked(key: bytes, pool,
                             device: torch.device) -> np.ndarray:
    """The (n_values, 8) uint32 HMAC digest matrix of a pool's values:
    one K-A launch over the pool (no bucket padding), memoized on the
    pool.  The common substrate of the hexed pool and the mesh dict
    route's digest gather.  Caller holds `_pool_hash_lock`."""
    memo_key = ("hmac_digest_rows", bytes(key))
    rows = pool.memo_get(memo_key)
    if rows is not None:
        return rows
    from transferia_tpu_torch.ops.fused import pack_hmac_blocks
    from transferia_tpu_torch.ops.sha256 import (
        _hmac_key_states,
        hmac_device_core,
    )

    mb = _pool_max_blocks(pool)
    blocks, n_blocks = pack_hmac_blocks(pool.values_data,
                                        pool.values_offsets, mb)
    inner, outer = _hmac_key_states(bytes(key), device)
    with trace.span("pool_upload", values=pool.n_values,
                    bytes=int(blocks.nbytes)):
        (dev_blocks, dev_nblocks), _ = stage_h2d(
            (blocks, n_blocks), device, None, what="dict_pool")
        digests = hmac_device_core(dev_blocks, dev_nblocks, inner, outer,
                                   mb)
        TELEMETRY.record_launch()
        digest_rows = np.ascontiguousarray(
            digests.cpu().numpy().view(np.uint32))
    TELEMETRY.record_d2h(int(digest_rows.nbytes))
    TELEMETRY.record_pool_upload()
    pool.memo_set(memo_key, digest_rows)
    return digest_rows


def device_hmac_pool_digests(key: bytes, pool, n_rows: int,
                             device: DeviceLike = None
                             ) -> Optional[np.ndarray]:
    """The memoized (n_values, 8) uint32 digest matrix for the mesh dict
    route (parallel/fusedmesh.py `dict_mask_input`), from which each
    shard gathers its rows' digest words by code.  None when the pool is
    too large to pay for itself on this batch."""
    memo_key = ("hmac_digest_rows", bytes(key))
    rows = pool.memo_get(memo_key)
    if rows is not None:
        TELEMETRY.record_pool_hit()
        return rows
    if pool.n_values > 2 * max(n_rows, 1):
        return None
    with _pool_hash_lock:
        return _pool_digest_rows_locked(bytes(key), pool,
                                        resolve_device(device))


def _pool_max_blocks(pool) -> int:
    """The SHA block bucket of a pool's longest value."""
    from transferia_tpu_torch.ops.fused import pow2_blocks

    lens = pool.values_offsets[1:] - pool.values_offsets[:-1]
    return pow2_blocks(int(lens.max()) if pool.n_values else 0)


def _record_avoided_batch_bytes(pool, n_rows: int) -> None:
    """Credit the accounting with the per-batch bytes the raw wire would
    have shipped for a pool-routed column: the bucket-padded SHA block
    matrix plus per-row block counts (block width from the pool's
    longest value)."""
    from transferia_tpu_torch.columnar.batch import bucket_rows

    record_dispatch(0, (_pool_max_blocks(pool) * 64 + 4)
                    * bucket_rows(max(n_rows, 1)))
