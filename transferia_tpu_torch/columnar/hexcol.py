"""Numpy-only helpers shared by the host and device mask paths."""

from __future__ import annotations

from typing import Optional

import numpy as np


_HEX_LUT = np.frombuffer(b"0123456789abcdef", dtype=np.uint8)


def digests_to_hex(words: np.ndarray) -> np.ndarray:
    """(N, 8) uint32 big-endian digest words -> (N, 64) ascii-hex uint8.

    Host-side hex encoding for the device mask path: the device returns raw
    digest words (32 bytes/row) instead of hex (64 bytes/row), halving the
    D2H volume; this LUT expansion is a table lookup over 32 bytes/row —
    microseconds per 131k-row batch, nothing vs the transfer it saves.
    """
    n = words.shape[0]
    b = np.ascontiguousarray(words.astype(">u4")).view(np.uint8)
    b = b.reshape(n, 32)
    out = np.empty((n, 64), dtype=np.uint8)
    out[:, 0::2] = _HEX_LUT[b >> 4]
    out[:, 1::2] = _HEX_LUT[b & 0xF]
    return out


def hex_to_varwidth(hexes: np.ndarray, validity: Optional[np.ndarray]
                    ) -> tuple[np.ndarray, np.ndarray]:
    """(N, 64) hex digest matrix -> flat var-width column bytes+offsets.

    Invalid rows become empty strings (validity is preserved separately by
    the caller's output Column).  Caller contract: hexes is freshly owned
    (device transfer / kernel output) — the all-valid fast path returns a
    reshape VIEW instead of copying 64 bytes/row again.
    """
    n = hexes.shape[0]
    if validity is None:
        out_offsets = np.arange(n + 1, dtype=np.int64) * 64
        if out_offsets[-1] > 2**31 - 1:
            raise ValueError("hashed column exceeds 2GiB")
        flat = np.ascontiguousarray(hexes).reshape(-1)
        return flat, out_offsets.astype(np.int32)
    if validity.all():
        return hex_to_varwidth(hexes, None)
    lens = np.where(validity, 64, 0).astype(np.int64)
    out_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lens, out=out_offsets[1:])
    if out_offsets[-1] > 2**31 - 1:
        raise ValueError("hashed column exceeds 2GiB")
    # invalid rows are zero-length, so the flat output is exactly the
    # valid rows' digests in row order — one contiguous gather, no
    # per-byte scatter
    valid_rows = np.nonzero(validity)[0]
    if len(valid_rows):
        out = np.ascontiguousarray(hexes[valid_rows]).reshape(-1)
    else:
        out = np.zeros(0, dtype=np.uint8)
    return out, out_offsets.astype(np.int32)
