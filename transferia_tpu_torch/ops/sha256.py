"""Batched SHA-256 / HMAC-SHA256: host packing, kernel K-A and its plain twin.

The PII mask transformer's device backend.  The host packs each row into
pre-padded SHA blocks (`prepare_padded_blocks`, copied from
transferia_tpu/ops/sha256.py:148); `sha256_hmac` runs kernel K-A
(csrc/sha256_hmac.cu) over them on a CUDA tensor and its plain PyTorch
version, `sha256_hmac_plain`, on a CPU tensor.  Digests are (N, 8) int32
tensors holding the big-endian uint32 digest words bit for bit (numpy
views them as uint32).

The plain version computes in int64 masked to 32 bits: on the CPU build
of torch, uint32 add, shifts, `~` and compares are not implemented.
"""

from __future__ import annotations

import functools
import hashlib
from typing import Optional

import numpy as np
import torch

from transferia_tpu_torch.ops import _build

_K = np.array([
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5,
    0x3956c25b, 0x59f111f1, 0x923f82a4, 0xab1c5ed5,
    0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174,
    0xe49b69c1, 0xefbe4786, 0x0fc19dc6, 0x240ca1cc,
    0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7,
    0xc6e00bf3, 0xd5a79147, 0x06ca6351, 0x14292967,
    0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85,
    0xa2bfe8a1, 0xa81a664b, 0xc24b8b70, 0xc76c51a3,
    0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5,
    0x391c0cb3, 0x4ed8aa4a, 0x5b9cca4f, 0x682e6ff3,
    0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
], dtype=np.uint32)

_H0 = np.array([
    0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
    0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19,
], dtype=np.uint32)

_M32 = 0xFFFFFFFF

def words_to_tensor(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """uint32 words (numpy) -> int32 tensor with the same bits."""
    arr = np.ascontiguousarray(words, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(arr.copy()).to(device)


@functools.lru_cache(maxsize=8)
def _h0(device: torch.device) -> torch.Tensor:
    return words_to_tensor(_H0, device)


# -- kernel K-A and its plain version ----------------------------------------

def sha256_hmac(blocks: torch.Tensor, n_blocks: torch.Tensor,
                init: torch.Tensor, outer: Optional[torch.Tensor],
                max_blocks: int) -> torch.Tensor:
    """SHA-256 (outer=None) or HMAC-SHA256 over pre-padded blocks.

    blocks: (N, max_blocks*64) uint8; n_blocks: (N,) int32; init/outer:
    (8,) int32 states.  Returns (N, 8) int32 digest words.  A CUDA tensor
    runs kernel K-A; a CPU tensor runs `sha256_hmac_plain`."""
    n = blocks.shape[0] if blocks.dim() == 2 else -1
    dev = blocks.device
    _build.require(blocks.dtype == torch.uint8 and blocks.dim() == 2
                   and blocks.shape[1] == max_blocks * 64 and max_blocks > 0
                   and blocks.is_contiguous(),
                   "blocks must be a contiguous (N, max_blocks*64) uint8")
    _build.require(n_blocks.dtype == torch.int32
                   and tuple(n_blocks.shape) == (n,)
                   and n_blocks.is_contiguous() and n_blocks.device == dev,
                   "n_blocks must be a contiguous (N,) int32 on blocks' "
                   "device")
    for name, st in (("init", init), ("outer", outer)):
        _build.require(
            (st is None and name == "outer")
            or (st is not None and st.dtype == torch.int32
                and tuple(st.shape) == (8,) and st.is_contiguous()
                and st.device == dev),
            f"{name} must be a contiguous (8,) int32 on blocks' device")
    if dev.type == "cpu":
        return sha256_hmac_plain(blocks, n_blocks, init, outer, max_blocks)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    _build.require(blocks.data_ptr() % 16 == 0,
                   "blocks must be 16-byte aligned")
    out = torch.empty((n, 8), dtype=torch.int32, device=dev)
    if n == 0:
        return out
    lib = _build.library("sha256_hmac")
    rc = lib.trt_sha256_hmac(blocks.data_ptr(), n_blocks.data_ptr(), n,
                             max_blocks, init.data_ptr(), _build.ptr(outer),
                             out.data_ptr(), _build.stream_of(blocks))
    _build.check(lib, rc, "sha256_hmac")
    _build.count_launch("sha256_hmac")
    return out


def _rotr(x: torch.Tensor, n: int) -> torch.Tensor:
    return ((x >> n) | (x << (32 - n))) & _M32


def _compress_plain(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """One compression; h (N, 8) and w (N, 16) int64 holding uint32."""
    ws = list(w.unbind(1))
    for i in range(16, 64):
        x15, x2 = ws[i - 15], ws[i - 2]
        s0 = _rotr(x15, 7) ^ _rotr(x15, 18) ^ (x15 >> 3)
        s1 = _rotr(x2, 17) ^ _rotr(x2, 19) ^ (x2 >> 10)
        ws.append((ws[i - 16] + s0 + ws[i - 7] + s1) & _M32)
    a, b, c, d, e, f, g, hh = h.unbind(1)
    for i in range(64):
        big_s1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
        ch = (e & f) ^ (~e & g)
        t1 = (hh + big_s1 + ch + int(_K[i]) + ws[i]) & _M32
        big_s0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
        maj = (a & b) ^ (a & c) ^ (b & c)
        t2 = (big_s0 + maj) & _M32
        hh, g, f, e, d, c, b, a = (g, f, e, (d + t1) & _M32, c, b, a,
                                   (t1 + t2) & _M32)
    return (h + torch.stack([a, b, c, d, e, f, g, hh], dim=1)) & _M32


def _u32_to_i32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def sha256_hmac_plain(blocks: torch.Tensor, n_blocks: torch.Tensor,
                      init: torch.Tensor, outer: Optional[torch.Tensor],
                      max_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of K-A (same arguments, same result)."""
    n = blocks.shape[0]
    b = blocks.reshape(n, max_blocks, 16, 4).to(torch.int64)
    words = ((b[..., 0] << 24) | (b[..., 1] << 16) | (b[..., 2] << 8)
             | b[..., 3])
    h = (init.to(torch.int64) & _M32).expand(n, 8)
    nb = n_blocks.to(torch.int64)[:, None]
    for blk in range(max_blocks):
        h = torch.where(blk < nb, _compress_plain(h, words[:, blk]), h)
    if outer is not None:
        pad = torch.tensor([0x80000000, 0, 0, 0, 0, 0, 0, (64 + 32) * 8],
                           dtype=torch.int64, device=blocks.device)
        h = _compress_plain((outer.to(torch.int64) & _M32).expand(n, 8),
                            torch.cat([h, pad.expand(n, 8)], dim=1))
    return _u32_to_i32(h)


def hmac_device_core(blocks: torch.Tensor, n_blocks: torch.Tensor,
                     inner_state: torch.Tensor, outer_state: torch.Tensor,
                     max_blocks: int) -> torch.Tensor:
    """HMAC-SHA256 from cached key states (K-A in HMAC mode)."""
    return sha256_hmac(blocks, n_blocks, inner_state, outer_state,
                       max_blocks)


def sha256_padded(blocks: torch.Tensor, n_blocks: torch.Tensor,
                  max_blocks: int) -> torch.Tensor:
    """SHA-256 of pre-padded messages (K-A in SHA mode, from H0)."""
    return sha256_hmac(blocks, n_blocks, _h0(blocks.device), None,
                       max_blocks)


# -- host halves ---------------------------------------------------------------

def prepare_padded_blocks(data: np.ndarray, offsets: np.ndarray,
                          prefix_len: int = 0,
                          max_blocks: Optional[int] = None,
                          ) -> tuple[np.ndarray, np.ndarray, int]:
    """Host-side: flat bytes+offsets -> padded SHA-256 block matrix.

    prefix_len: bytes of a (virtual) prefix already fed to the state — used
    by HMAC where the 64-byte ipad block is compressed separately; lengths
    in the padding must include it.  max_blocks: force the block bucket
    (callers sharing one shape across batches); None = derive.

    Returns (blocks (N, max_blocks*64) uint8, n_blocks (N,) int32,
    max_blocks).  Vectorized with numpy gathers — no per-row Python.
    """
    n = len(offsets) - 1
    lens = (offsets[1:] - offsets[:-1]).astype(np.int64)
    total_lens = lens + prefix_len
    # message + 0x80 + 8-byte length, rounded up to 64
    n_blocks = ((lens + 9 + 63) // 64).astype(np.int32)
    needed = int(n_blocks.max()) if n else 1
    if max_blocks is None:
        # power-of-two buckets: one shape per (rows, block bucket), not
        # one per batch-specific max length
        max_blocks = 1 << (needed - 1).bit_length() if needed > 1 else 1
    elif needed > max_blocks:
        raise ValueError(
            f"rows need {needed} SHA blocks > forced bucket {max_blocks}"
        )
    width = max_blocks * 64
    out = np.zeros((n, width), dtype=np.uint8)
    total = int(lens.sum())
    if total:
        # one flat scatter: rows are contiguous in the flat buffer, so
        # source bytes in order are one slice; the destination index of
        # byte k of row i is i*width + k
        row_of = np.repeat(np.arange(n, dtype=np.int64), lens)
        cum = (offsets[:-1] - offsets[0]).astype(np.int64)
        intra = np.arange(total, dtype=np.int64) - np.repeat(cum, lens)
        out.reshape(-1)[row_of * width + intra] = \
            data[offsets[0]:offsets[0] + total]

    # 0x80 terminator
    rows = np.arange(n)
    out[rows, lens] = 0x80
    # 8-byte big-endian bit length at the end of the last block
    bit_lens = (total_lens * 8).astype(np.uint64)
    last = (n_blocks.astype(np.int64) * 64) - 8
    for k in range(8):
        out[rows, last + k] = ((bit_lens >> (8 * (7 - k))) & 0xFF
                               ).astype(np.uint8)
    return out, n_blocks, max_blocks


def _words_to_bytes(h: np.ndarray) -> np.ndarray:
    out = np.zeros((h.shape[0], 32), dtype=np.uint8)
    for i in range(8):
        out[:, 4 * i + 0] = (h[:, i] >> 24) & 0xFF
        out[:, 4 * i + 1] = (h[:, i] >> 16) & 0xFF
        out[:, 4 * i + 2] = (h[:, i] >> 8) & 0xFF
        out[:, 4 * i + 3] = h[:, i] & 0xFF
    return out


@functools.lru_cache(maxsize=64)
def _hmac_key_states(key: bytes, device: torch.device
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """The per-key inner/outer states: one compression each of key^ipad
    and key^opad from H0 (K-A in SHA mode over two one-block rows)."""
    if len(key) > 64:
        key = hashlib.sha256(key).digest()
    k = np.zeros(64, dtype=np.uint8)
    k[:len(key)] = np.frombuffer(key, dtype=np.uint8)
    blocks = torch.from_numpy(np.stack([k ^ 0x36, k ^ 0x5C])).to(device)
    ones = torch.ones(2, dtype=torch.int32, device=device)
    states = sha256_padded(blocks, ones, 1)
    return states[0].contiguous(), states[1].contiguous()
