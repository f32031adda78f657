"""On-device columnar decode: kernels K-B (predicate columns) and K11 (dict).

`pred_decode` runs kernel K-B (csrc/pred_decode.cu) on a CUDA tensor and
its plain PyTorch version, `pred_decode_plain`, on a CPU tensor.  The
named entry points mirror transferia_tpu/ops/decode.py: `unpack_bits`
(line 34), `unpack_validity` (line 64), `delta_prefix_sum` (line 73) and
`for_frame_decode` (line 91).

`decode_dict_run` (line 44) and `decode_dict_loop` (line 126) run kernel
K11 (`trt_dict_decode` in the same source): bit-unpack of dictionary
codes and a clamped gather from a 4-byte pool; their plain versions are
`decode_dict_run_plain` and `decode_dict_loop_plain`.
`gather_pool_accumulators` (line 52) is the plain version of the gather
that kernel K10 (ops/rowhash.py) fuses.

Packed words are int32 tensors holding the little-endian uint32 word
stream bit for bit.  Decoded integers come back as int32 (the reference
decodes in int32 and casts to the column dtype; every decoded value fits
that dtype, and the predicate kernel compares integer columns in integer
whatever their width, so the port keeps int32).

`pack_mask_words` (line 114) has no kernel of its own here: on a card
the keep mask is packed inside the predicate kernel K-C; this module
keeps its plain version, which K-C's plain path uses.

Two choices the kernels leave to their wrappers live here, where the CPU
tests reach them: the delta scan's per-stream scratch (`ScanScratch`)
and how much of a dictionary pool K11 stages (`dict_staged_entries`).
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Iterator, Optional

import torch

from transferia_tpu_torch.ops import _build

MODE_BITS, MODE_DELTA, MODE_FOR, MODE_UNPACK = 0, 1, 2, 3
_MODES = {MODE_BITS: "bits", MODE_DELTA: "delta", MODE_FOR: "for",
          MODE_UNPACK: "unpack"}
_M32 = 0xFFFFFFFF

# values one block of the delta scan decodes (kScanTile in the source)
DELTA_TILE = 2048


def delta_tiles(n: int) -> int:
    """Tiles, and so blocks and status words, of a delta scan of n values."""
    return -(-n // DELTA_TILE)


@dataclass
class _ScanSlot:
    buf: torch.Tensor   # int64: [0] the tile ticket counter, [1:] statuses
    epoch: int = 0      # of the last launch on this slot
    tickets: int = 0    # tiles handed out so far: the counter's value


class ScanScratch:
    """The delta scan's status words and tile counter, one buffer per
    (device, stream).

    A buffer is made once, zeroed, on the stream that uses it; every
    launch on it takes the next epoch (a status word of an older epoch
    reads as not ready, so no launch clears the buffer) and passes the
    counter's value, which launches on one stream leave in order.  Two
    streams never share a buffer, so two scans can be in flight at once.
    A launch that raises advances nothing."""

    EPOCH_MAX = 2**31 - 1   # the epoch field's 31 bits
    MIN_TILES = 512         # the largest row bucket, 1,048,576 values

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._slots: dict[tuple[torch.device, int], _ScanSlot] = {}

    @contextlib.contextmanager
    def launch(self, device: torch.device, stream: int, tiles: int
               ) -> Iterator[tuple[torch.Tensor, int, int]]:
        """(buffer, epoch, ticket base) for one launch of `tiles` tiles
        on `stream`; held under a lock until the launch is enqueued, and
        committed only if the body returns."""
        with self._lock:
            key = (device, stream)
            slot = self._slots.get(key)
            if slot is None or slot.buf.numel() - 1 < tiles \
                    or slot.epoch >= self.EPOCH_MAX:
                cap = max(tiles, self.MIN_TILES,
                          slot.buf.numel() - 1 if slot else 0)
                slot = _ScanSlot(torch.zeros(cap + 1, dtype=torch.int64,
                                             device=device))
                self._slots[key] = slot
            yield slot.buf, slot.epoch + 1, slot.tickets
            slot.epoch += 1
            slot.tickets += tiles


_SCAN_SCRATCH = ScanScratch()


def pred_decode(mode: int, words: torch.Tensor, n: int, bit_width: int,
                base: int = 0, mins: Optional[torch.Tensor] = None,
                frame: int = 0) -> torch.Tensor:
    """Decode n values of `bit_width` bits from a packed word stream.

    mode bits: width 1 -> (n,) bool.  delta: zigzag deltas -> base +
    inclusive int32 prefix sum.  for: mins[i // frame] + rel[i] (mins
    (n // frame,) int32).  unpack: the values as int32.  Int32 arithmetic
    wraps two's-complement."""
    dev = words.device
    _build.require(mode in _MODES, f"unknown decode mode {mode}")
    _build.require(words.dtype == torch.int32 and words.dim() == 1
                   and words.is_contiguous() and words.numel() > 0,
                   "words must be a non-empty contiguous 1-D int32")
    _build.require(n > 0 and 1 <= bit_width <= 32
                   and (mode != MODE_BITS or bit_width == 1),
                   f"bad decode shape n={n} bit_width={bit_width}")
    _build.require(words.numel() * 32 >= n * bit_width,
                   "word stream shorter than n values")
    if mode == MODE_FOR:
        _build.require(frame > 0 and n % frame == 0, "n must be a multiple "
                       "of a positive frame")
        _build.require(mins is not None and mins.dtype == torch.int32
                       and tuple(mins.shape) == (n // frame,)
                       and mins.is_contiguous() and mins.device == dev,
                       "mins must be a contiguous (n // frame,) int32 on "
                       "words' device")
    _build.require(-2**31 <= base < 2**31, "base must fit int32")
    if dev.type == "cpu":
        return pred_decode_plain(mode, words, n, bit_width, base, mins,
                                 frame)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    out = torch.empty(n, dtype=torch.bool if mode == MODE_BITS
                      else torch.int32, device=dev)
    lib = _build.library("pred_decode")
    stream = _build.stream_of(words)
    scan = (_SCAN_SCRATCH.launch(dev, stream, delta_tiles(n))
            if mode == MODE_DELTA else contextlib.nullcontext((None, 0, 0)))
    with scan as (scratch, epoch, ticket_base):
        rc = lib.trt_pred_decode(
            mode, words.data_ptr(), words.numel(), n, bit_width, int(base),
            _build.ptr(mins), frame, _build.ptr(scratch),
            0 if scratch is None else scratch.numel() - 1, ticket_base,
            epoch, out.data_ptr(), stream)
        _build.check(lib, rc, f"pred_decode[{_MODES[mode]}]")
    _build.count_launch("pred_decode")
    return out


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap."""
    x = x & _M32
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def unpack_plain(words: torch.Tensor, bit_width: int, n: int
                 ) -> torch.Tensor:
    """values[i] = bits [i*bw, (i+1)*bw) of the stream, as int64 in
    [0, 2^32); word reads past the stream clamp to its last word."""
    w = words.to(torch.int64) & _M32
    last = w.numel() - 1
    start = torch.arange(n, dtype=torch.int64, device=words.device) \
        * bit_width
    wi = start >> 5
    off = start & 31
    lo = w[wi.clamp(max=last)] >> off
    hi = (w[(wi + 1).clamp(max=last)] << (32 - off)) & _M32
    v = lo | torch.where(off > 0, hi, torch.zeros_like(hi))
    if bit_width < 32:
        v = v & ((1 << bit_width) - 1)
    return v


def pred_decode_plain(mode: int, words: torch.Tensor, n: int,
                      bit_width: int, base: int = 0,
                      mins: Optional[torch.Tensor] = None,
                      frame: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K-B (same arguments, same result)."""
    v = unpack_plain(words, bit_width, n)
    if mode == MODE_BITS:
        return v.to(torch.bool)
    if mode == MODE_UNPACK:
        return _wrap_i32(v)
    if mode == MODE_FOR:
        rel = v
        frames = mins.to(torch.int64).repeat_interleave(frame)
        return _wrap_i32(frames + rel)
    zz = _wrap_i32(v).to(torch.int64)  # the int32 code, sign included
    deltas = (zz >> 1) ^ -(zz & 1)
    return _wrap_i32(base + torch.cumsum(deltas, dim=0))


def unpack_bits(words: torch.Tensor, bit_width: int, n: int
                ) -> torch.Tensor:
    """values[i] = bits [i*bw, (i+1)*bw) of the packed stream, as int32
    (a value of 32 bits >= 2^31 comes back negative)."""
    if not 0 < bit_width <= 32:
        raise ValueError(f"bit_width {bit_width} outside (0, 32]")
    return pred_decode(MODE_UNPACK, words, n, bit_width)


def unpack_validity(words: torch.Tensor, n: int) -> torch.Tensor:
    """Packed little-endian validity bitmap -> (n,) bool."""
    return pred_decode(MODE_BITS, words, n, 1)


def delta_prefix_sum(words: torch.Tensor, base: int, bit_width: int,
                     n: int) -> torch.Tensor:
    """Zigzag-delta decode: values[i] = base + sum(deltas[0..i]), int32."""
    return pred_decode(MODE_DELTA, words, n, bit_width, base=base)


def for_frame_decode(words: torch.Tensor, mins: torch.Tensor,
                     bit_width: int, frame: int, n: int) -> torch.Tensor:
    """Frame-of-reference decode: values[i] = mins[i // frame] + rel[i]."""
    return pred_decode(MODE_FOR, words, n, bit_width, mins=mins,
                       frame=frame)


def pack_mask_words(bits: torch.Tensor, n: int) -> torch.Tensor:
    """(n,) bool -> n/32 little-endian uint32 words as int32 (bit j of
    word k = row 32k+j); n must be a multiple of 32.  Plain version of
    the pack that kernel K-C fuses."""
    if n % 32:
        raise ValueError(f"n={n} is not a multiple of 32")
    b = bits.reshape(n // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, dtype=torch.int64, device=bits.device)
    return _wrap_i32((b * weights).sum(dim=1))


# -- kernel K11: dictionary decode -------------------------------------------

def gather_pool_accumulators(accs: torch.Tensor, codes: torch.Tensor
                             ) -> torch.Tensor:
    """accs[clamp(codes, 0, k - 1)] (jnp.take(mode="clip")): per-row
    values from per-pool-entry values by int32 code.  Plain version of
    the gather that kernels K10 and K11 fuse."""
    return accs[codes.to(torch.int64).clamp(0, accs.numel() - 1)]


def _check_dict_args(words: torch.Tensor, pool: torch.Tensor,
                     bit_width: int, n: int) -> None:
    if not 0 < bit_width <= 32:
        raise ValueError(f"bit_width {bit_width} outside (0, 32]")
    _build.require(words.dtype == torch.int32 and words.dim() == 1
                   and words.is_contiguous() and words.numel() > 0,
                   "words must be a non-empty contiguous 1-D int32")
    _build.require(pool.dtype == torch.int32 and pool.dim() == 1
                   and pool.is_contiguous() and 0 < pool.numel() < 2**31
                   and pool.device == words.device,
                   "pool must be a non-empty contiguous 1-D int32 on "
                   "words' device")
    _build.require(n > 0 and words.numel() * 32 >= n * bit_width,
                   f"need n > 0 and {n} values of {bit_width} bits in "
                   f"{words.numel()} words")


# How much of the pool K11's blocks keep in shared memory
# (csrc/pred_decode.cu): the pool's first 40,960 entries (160 KB: one
# block an SM, ~90 KB of L1 left for the rest), or the whole pool where
# it is smaller.  The prefix's size was measured at the decode path's
# shape (4,194,304 codes into 131,072 entries).
POOL_PREFIX_ENTRIES = 40_960


def dict_staged_entries(k: int) -> int:
    """How many of a k-entry pool's first entries K11 stages in each
    block's shared memory."""
    return min(k, POOL_PREFIX_ENTRIES)


def _dict_decode_launch(words: torch.Tensor, pool: torch.Tensor,
                        bit_width: int, n: int,
                        carry_in: Optional[torch.Tensor],
                        carry_out: Optional[torch.Tensor],
                        out: Optional[torch.Tensor],
                        staged: Optional[int] = None) -> None:
    """One K11 launch; `staged` defaults to `dict_staged_entries(k)`
    (given only to time or check another split)."""
    if staged is None:
        staged = dict_staged_entries(pool.numel())
    lib = _build.library("pred_decode")
    rc = lib.trt_dict_decode(words.data_ptr(), words.numel(), n, bit_width,
                             pool.data_ptr(), pool.numel(), staged,
                             _build.ptr(carry_in), _build.ptr(carry_out),
                             _build.ptr(out), _build.stream_of(words))
    _build.check(lib, rc, "dict_decode")
    _build.count_launch("dict_decode")


def decode_dict_run(words: torch.Tensor, pool: torch.Tensor,
                    bit_width: int, n: int) -> torch.Tensor:
    """Bit-unpack n dictionary codes and gather their pool values:
    (n,) int32 pool[clamp(code, 0, k - 1)].  A CUDA tensor runs kernel
    K11; a CPU tensor runs `decode_dict_run_plain`."""
    _check_dict_args(words, pool, bit_width, n)
    dev = words.device
    if dev.type == "cpu":
        return decode_dict_run_plain(words, pool, bit_width, n)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    out = torch.empty(n, dtype=torch.int32, device=dev)
    _dict_decode_launch(words, pool, bit_width, n, None, None, out)
    return out


def decode_dict_run_plain(words: torch.Tensor, pool: torch.Tensor,
                          bit_width: int, n: int) -> torch.Tensor:
    """Plain PyTorch version of K11's decode."""
    codes = _wrap_i32(unpack_plain(words, bit_width, n))
    return gather_pool_accumulators(pool, codes)


def decode_dict_loop(words: torch.Tensor, pool: torch.Tensor,
                     bit_width: int, n: int, iters: int) -> torch.Tensor:
    """`iters` back-to-back decodes carrying a uint32 sum: each XORs the
    input words with (carry & 1) and adds the sum of its values to the
    carry.  Returns the final carry as a 0-dim int32 tensor holding the
    uint32 bits, on the card without a host sync (one K11 launch per
    iteration on one stream, the carry in device memory)."""
    _check_dict_args(words, pool, bit_width, n)
    _build.require(iters >= 0, f"iters must be >= 0, got {iters}")
    dev = words.device
    if dev.type == "cpu":
        return decode_dict_loop_plain(words, pool, bit_width, n, iters)
    _build.require(dev.type == "cuda", f"unsupported device {dev}")
    carries = torch.zeros(iters + 1, dtype=torch.int32, device=dev)
    for i in range(iters):
        _dict_decode_launch(words, pool, bit_width, n, carries[i],
                            carries[i + 1], None)
    return carries[iters]


def decode_dict_loop_plain(words: torch.Tensor, pool: torch.Tensor,
                           bit_width: int, n: int, iters: int
                           ) -> torch.Tensor:
    """Plain PyTorch version of `decode_dict_loop`."""
    acc = torch.zeros((), dtype=torch.int64, device=words.device)
    for _ in range(iters):
        flipped = words ^ (acc & 1).to(torch.int32)
        vals = decode_dict_run_plain(flipped, pool, bit_width, n)
        acc = (acc + vals.to(torch.int64).sum()) & _M32
    return _wrap_i32(acc)
