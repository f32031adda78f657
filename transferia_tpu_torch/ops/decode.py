"""On-device decode of dispatch-encoded predicate columns: kernel K-B.

`pred_decode` runs kernel K-B (csrc/pred_decode.cu) on a CUDA tensor and
its plain PyTorch version, `pred_decode_plain`, on a CPU tensor.  The
named entry points mirror transferia_tpu/ops/decode.py: `unpack_validity`
(line 64), `delta_prefix_sum` (line 73) and `for_frame_decode` (line 91).

Packed words are int32 tensors holding the little-endian uint32 word
stream bit for bit.  Decoded integers come back as int32 (the reference
decodes in int32 and casts to the column dtype; every decoded value fits
that dtype, and the predicate kernel compares integer columns in integer
whatever their width, so the port keeps int32).

`pack_mask_words` (line 114) has no kernel of its own here: on a card
the keep mask is packed inside the predicate kernel K-C; this module
keeps its plain version, which K-C's plain path uses.
"""

from __future__ import annotations

from typing import Optional

import torch

from transferia_tpu_torch.ops import _build

MODE_BITS, MODE_DELTA, MODE_FOR = 0, 1, 2
_MODES = {MODE_BITS: "bits", MODE_DELTA: "delta", MODE_FOR: "for"}
_M32 = 0xFFFFFFFF


def pred_decode(mode: int, words: torch.Tensor, n: int, bit_width: int,
                base: int = 0, mins: Optional[torch.Tensor] = None,
                frame: int = 0) -> torch.Tensor:
    """Decode n values of `bit_width` bits from a packed word stream.

    mode bits: width 1 -> (n,) bool.  delta: zigzag deltas -> base +
    inclusive int32 prefix sum.  for: mins[i // frame] + rel[i] (mins
    (n // frame,) int32).  Int32 arithmetic wraps two's-complement."""
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
    rc = lib.trt_pred_decode(mode, words.data_ptr(), words.numel(), n,
                             bit_width, int(base), _build.ptr(mins),
                             frame, out.data_ptr(), _build.stream_of(words))
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
    if mode == MODE_FOR:
        rel = v
        frames = mins.to(torch.int64).repeat_interleave(frame)
        return _wrap_i32(frames + rel)
    zz = _wrap_i32(v).to(torch.int64)  # the int32 code, sign included
    deltas = (zz >> 1) ^ -(zz & 1)
    return _wrap_i32(base + torch.cumsum(deltas, dim=0))


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
