"""Device-side ragged pack: var-width rows -> padded HMAC message blocks.

The port of transferia_tpu/ops/raggedpack.py.  The fused mask program
(ops/fused.py) hashes (N, max_blocks*64) padded message matrices.  By
default the host packs them (`prepare_padded_blocks`) and ships the
padded matrix; with TRANSFERIA_TPU_PALLAS_PACK=1 the host ships the
column's flat bytes and offsets instead and kernel K12
(csrc/raggedpack.cu) builds the matrix on the card: row gather, the 0x80
terminator and the big-endian bit length with the virtual HMAC ipad
block counted.  For short strings that is about half the link bytes.

`ragged_pack` runs K12 on CUDA tensors and `pack_blocks_plain`, its plain
PyTorch version (the arithmetic of the reference's `_pack_xla`), on CPU
tensors.  `pack_blocks_device` is the reference's entry point: host
arrays in, device matrices out, with the host-side contract kept (a row
that needs more than `max_blocks` blocks raises before any launch).

Two differences from the reference: a row is read only below its
length, so the flat buffer needs no slack past the last row; and bucket
pad rows come out all zero with a block count of 0 (the reference's
caller zeroed the counts after the pack).
"""

from __future__ import annotations

import numpy as np
import torch

from transferia_tpu_torch.ops import _build
from transferia_tpu_torch.runtime.device import DeviceLike, resolve_device


def check_rows_fit(offsets: np.ndarray, max_blocks: int) -> None:
    """The host pack's contract: raise ValueError when a row needs more
    than `max_blocks` SHA blocks (the padding arithmetic would cut it)
    or when the offsets leave int32."""
    if int(offsets[-1]) >= 2**31:
        raise ValueError("ragged pack: offsets must stay below 2^31")
    lens = offsets[1:] - offsets[:-1]
    if len(lens) and int(lens.max()) + 9 > max_blocks * 64:
        raise ValueError(
            f"row of {int(lens.max())} bytes needs more than "
            f"{max_blocks} SHA blocks")


def ragged_pack(data: torch.Tensor, offsets: torch.Tensor,
                n_rows_bucket: int, max_blocks: int
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack the rows of (data, offsets) into (bucket, max_blocks*64)
    uint8 blocks and (bucket,) int32 block counts.

    data: (n_data,) uint8; offsets: (n+1,) int32, both on one device.
    A CUDA tensor runs kernel K12; a CPU tensor runs `pack_blocks_plain`.
    Callers check `check_rows_fit` on the host first."""
    dev = data.device
    _build.require(data.dtype == torch.uint8 and data.dim() == 1
                   and data.is_contiguous(),
                   "data must be a contiguous 1-D uint8")
    _build.require(offsets.dtype == torch.int32 and offsets.dim() == 1
                   and offsets.numel() >= 1 and offsets.is_contiguous()
                   and offsets.device == dev,
                   "offsets must be a contiguous (n+1,) int32 on data's "
                   "device")
    n = offsets.numel() - 1
    _build.require(max_blocks > 0 and n_rows_bucket >= max(n, 1),
                   f"bad pack shape: n={n} bucket={n_rows_bucket} "
                   f"max_blocks={max_blocks}")
    if dev.type == "cpu":
        return pack_blocks_plain(data, offsets, n_rows_bucket, max_blocks)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    blocks = torch.empty((n_rows_bucket, max_blocks * 64), dtype=torch.uint8,
                         device=dev)
    n_blocks = torch.empty(n_rows_bucket, dtype=torch.int32, device=dev)
    lib = _build.library("raggedpack")
    rc = lib.trt_ragged_pack(data.data_ptr(), data.numel(),
                             offsets.data_ptr(), n, n_rows_bucket,
                             max_blocks, blocks.data_ptr(),
                             n_blocks.data_ptr(), _build.stream_of(data))
    _build.check(lib, rc, "ragged_pack")
    _build.count_launch("ragged_pack")
    return blocks, n_blocks


def pack_blocks_plain(data: torch.Tensor, offsets: torch.Tensor,
                      n_rows_bucket: int, max_blocks: int
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K12 (the reference's `_pack_xla`
    arithmetic; pad rows zeroed)."""
    dev = data.device
    width = max_blocks * 64
    n = offsets.numel() - 1
    off = offsets.to(torch.int64)
    starts = torch.zeros(n_rows_bucket, dtype=torch.int64, device=dev)
    lens = torch.zeros(n_rows_bucket, dtype=torch.int64, device=dev)
    starts[:n] = off[:-1]
    lens[:n] = off[1:] - off[:-1]
    col = torch.arange(width, dtype=torch.int64, device=dev)[None, :]
    lens2 = lens[:, None]
    idx = starts[:, None] + col
    inside = (col < lens2) & (idx >= 0) & (idx < data.numel())
    if data.numel():
        raw = data[idx.clamp(0, data.numel() - 1)].to(torch.int64)
        msg = torch.where(inside, raw, 0)
    else:
        msg = torch.zeros_like(idx)
    msg = torch.where(col == lens2, 0x80, msg)
    nb = (lens + 9 + 63) // 64
    k = col - (nb * 64 - 8)[:, None]             # length field position
    bits = ((lens + 64) * 8)[:, None]            # +64: HMAC ipad prefix
    shift = 8 * (7 - k)
    lenbyte = torch.where((k >= 0) & (k < 8) & (shift < 32),
                          (bits >> shift.clamp(0, 31)) & 0xFF, 0)
    msg = torch.where((k >= 0) & (k < 8), lenbyte, msg)
    real = torch.arange(n_rows_bucket, device=dev) < n
    msg = torch.where(real[:, None], msg, 0)
    nb = torch.where(real, nb, 0)
    return msg.to(torch.uint8), nb.to(torch.int32)


def pack_blocks_device(data: np.ndarray, offsets: np.ndarray,
                       n_rows_bucket: int, max_blocks: int,
                       device: DeviceLike = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Pack ragged host rows into padded SHA blocks on `device`.

    data: the flat uint8 bytes (no slack needed); offsets: (n+1,) int32
    for the true rows.  Returns (blocks (bucket, max_blocks*64) uint8,
    n_blocks (bucket,) int32) on the device; pad rows are zero with a
    block count of 0.  A row needing more than `max_blocks` blocks
    raises ValueError before anything is uploaded."""
    dev = resolve_device(device)
    offsets = np.ascontiguousarray(offsets, dtype=np.int32)
    check_rows_fit(offsets, max_blocks)
    d = torch.from_numpy(np.array(data, dtype=np.uint8, copy=True))
    o = torch.from_numpy(offsets.copy())
    return ragged_pack(d.to(dev), o.to(dev), n_rows_bucket, max_blocks)
